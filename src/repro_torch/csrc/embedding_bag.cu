// embedding_bag: out[b, :] = sum_l w[b, l] * table[ids[b, l], :], divided by
// max(sum_l w[b, l], 1e-9) under the mean combiner. Ids < 0 are pads and
// weigh 0; no weights means unit weights.
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/embedding_bag.py,
// embedding_bag_pallas (body _bag_kernel), which walks a (B, L) grid with the
// bag member innermost, streams one table row per grid step through a
// scalar-prefetch BlockSpec and accumulates it into the (1, D) output block.
//
// The arithmetic contract is the reference's on the CPU: per column, acc
// starts at +0 and takes acc = fma(w_l, f32(row_l), acc) for l = 0..L-1 in
// order; the mean divides by max(sum_l w_l, 1e-9), the sum taken in l order
// in f32. __fmaf_rn, __fadd_rn and __fdiv_rn spell every rounding out, so no
// compiler contraction question arises. A pad contributes fma(0, 0, acc) ==
// acc (acc is never -0: it starts at +0, and an exact-zero fma result is +0
// unless both addends are -0), which equals the reference's 0 * row for any
// finite row. Ids >= V are outside the contract; they read row V - 1, as
// XLA's gather clamps, so a bad id never reads outside the table.
//
// Bound on an H100: the bytes of the distinct rows, read once. Serving a
// 512-request batch of 32-item histories at D = 256 reads 16,318 distinct
// 1 KB rows: 5.2 us at 3.35 TB/s; 1024 bags 10.3 us; the 262,144-bag bulk
// batch 0.69 ms (1.97M distinct of 8.39M rows read). The FMAs (2 flops per
// element read) are far below the card's rate.
//
// At small batches the kernel is bound by memory latency, not bandwidth: a
// warp that loads a bag id and only then its row makes two dependent trips
// per member. The design cuts the dependent trips and spreads a bag over
// more warps:
//   - One warp per (bag, slice of 32 * VEC columns): VEC = 4 gives one
//     16-byte float4 (8 bytes for bf16) per lane, so D = 256 f32 takes two
//     warps per bag and B = 512 puts 1024 warps on the card. VEC = 1 (D % 4
//     != 0, e.g. 18, or a misaligned table) reads one element per lane.
//   - Ids once per warp: lane l loads ids[bag, l0 + l] and its weight, one
//     coalesced load per 32 members; each member's id then comes from a
//     __shfl_sync, so no row load waits behind an id load.
//   - The l loop is unrolled by kUnroll = 16: all 16 row loads of a step are
//     issued before its FMAs, which then run in l order. A bag of L = 32
//     makes 3 dependent trips to memory (ids, then two steps of rows).
//   - Blocks of 2 warps while the grid is small (every SM gets several
//     blocks at B = 512), of 8 at bulk sizes.
// A bf16 table is widened to f32 on load (exact).
//
// embedding_bag_backward, below, is the gradient with respect to the table.
#include <cuda_bf16.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kUnroll = 16;        // divides 32: a step never crosses an id load

template <typename T, int VEC>
__device__ __forceinline__ void load_chunk(const T* __restrict__ p,
                                           float (&out)[VEC]);

template <>
__device__ __forceinline__ void load_chunk<float, 4>(
    const float* __restrict__ p, float (&out)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

template <>
__device__ __forceinline__ void load_chunk<float, 1>(
    const float* __restrict__ p, float (&out)[1]) {
  out[0] = __ldg(p);
}

template <>
__device__ __forceinline__ void load_chunk<__nv_bfloat16, 4>(
    const __nv_bfloat16* __restrict__ p, float (&out)[4]) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  out[0] = __low2float(lo); out[1] = __high2float(lo);
  out[2] = __low2float(hi); out[3] = __high2float(hi);
}

template <>
__device__ __forceinline__ void load_chunk<__nv_bfloat16, 1>(
    const __nv_bfloat16* __restrict__ p, float (&out)[1]) {
  out[0] = __bfloat162float(p[0]);
}

// Warp w of the grid takes bag w / slices, columns [32 * VEC * s, +32 * VEC)
// with s = w % slices.
template <typename T, int VEC>
__global__ void embedding_bag_kernel(const T* __restrict__ table,
                                     const int* __restrict__ ids,
                                     const float* __restrict__ weights,
                                     float* __restrict__ out, int b,
                                     int bag_len, int v, int d, int slices,
                                     bool mean) {
  const long long warp =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (warp >= (long long)b * slices) return;          // whole warps only
  const long long bag = warp / slices;
  const int lane = threadIdx.x & 31;
  const int c = (int)(warp - bag * slices) * 32 + lane;  // this lane's chunk
  const bool live = c < d / VEC;
  const int* bag_ids = ids + bag * bag_len;
  const float* bag_w = weights == nullptr ? nullptr : weights + bag * bag_len;
  const T* col = table + (long long)c * VEC;

  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  float denom = 0.f;

  for (int l0 = 0; l0 < bag_len; l0 += 32) {
    const int l = l0 + lane;
    const int my_id = l < bag_len ? __ldg(bag_ids + l) : -1;
    const float my_w =
        my_id < 0 ? 0.f : (bag_w == nullptr ? 1.f : __ldg(bag_w + l));
    const int members = min(32, bag_len - l0);
    for (int j = 0; j < members; j += kUnroll) {
      float val[kUnroll][VEC];
      float wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int id = __shfl_sync(kFullMask, my_id, j + u);
        wv[u] = __shfl_sync(kFullMask, my_w, j + u);
        if (id >= 0 && live) {
          load_chunk<T, VEC>(col + (long long)min(id, v - 1) * d, val[u]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) val[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j + u >= members) break;                  // uniform across the warp
        denom = __fadd_rn(denom, wv[u]);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[e] = __fmaf_rn(wv[u], val[u][e], acc[e]);
      }
    }
  }
  if (!live) return;

  const float div = fmaxf(denom, 1e-9f);
  float r[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) r[e] = mean ? __fdiv_rn(acc[e], div) : acc[e];
  float* dst = out + bag * d + (long long)c * VEC;
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    dst[0] = r[0];
  }
}

static int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

template <typename T, int VEC>
void launch_bag(const void* table, const void* ids, const void* weights,
                void* out, int b, int bag_len, int v, int d, bool mean,
                cudaStream_t stream) {
  const int slices = (d / VEC + 31) / 32;
  const long long warps = (long long)b * slices;
  // 8-warp blocks once the grid holds 4 of them per SM, 2-warp blocks below
  const int per_block = warps >= 32LL * sm_count() ? 8 : 2;
  const unsigned grid = (unsigned)((warps + per_block - 1) / per_block);
  embedding_bag_kernel<T, VEC><<<grid, per_block * 32, 0, stream>>>(
      (const T*)table, (const int*)ids, (const float*)weights, (float*)out, b,
      bag_len, v, d, slices, mean);
}

}  // namespace repro_torch

// table (v, d) f32 or bf16 (bf16 != 0), ids (b, bag_len) int32, weights
// (b, bag_len) f32 or null, out (b, d) f32. vec4: d % 4 == 0 and the table
// aligned to 4 elements.
extern "C" int embedding_bag(const void* table, const void* ids,
                             const void* weights, void* out, int b,
                             int bag_len, int v, int d, int mean, int vec4,
                             int bf16, void* stream) {
  using namespace repro_torch;
  if (b > 0 && d > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16) {
      if (vec4)
        launch_bag<__nv_bfloat16, 4>(table, ids, weights, out, b, bag_len, v,
                                     d, mean != 0, s);
      else
        launch_bag<__nv_bfloat16, 1>(table, ids, weights, out, b, bag_len, v,
                                     d, mean != 0, s);
    } else {
      if (vec4)
        launch_bag<float, 4>(table, ids, weights, out, b, bag_len, v, d,
                             mean != 0, s);
      else
        launch_bag<float, 1>(table, ids, weights, out, b, bag_len, v, d,
                             mean != 0, s);
    }
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// embedding_bag_backward: out[ids[b, l], :] += (g[b, :] / denom_b) * w[b, l]
// for every member with ids[b, l] >= 0, where denom_b = max(sum_l w[b, l],
// 1e-9) under the mean combiner and the division is left out under sum; no
// weights means unit weights, and the multiply by 1 is left out. Ids >= V
// add into row V - 1, as the forward reads it.
//
// Replaces no TPU kernel: the reference trains through _bag
// (src/repro/models/recsys.py:44), a take and a masked sum, which XLA
// differentiates into a scatter-add of those terms in (b, l) order. The
// kernel is that scatter-add.
//
// Design: the wrapper folds ids >= V onto V - 1 and stable-sorts the flat
// ids (torch.sort(stable=True): the grouping step), so each row's members
// lie together in ascending (b, l) order, pads (< 0) first. One warp per
// sorted position; the warp at the head of a run of one id sums the run's
// terms in that order, lanes across D (VEC = 4 floats per lane per step,
// D = 256 is two steps), and adds the sum into the row once. No float
// atomics: two runs give the same bits, and the plain version
// (kernels/embedding_bag/ref.py) repeats the order: each row gets
// ((0 + t_0) + t_1) + ... . Every rounding is spelled out (__fdiv_rn,
// __fmul_rn, __fadd_rn), so nvcc contracts nothing into an fma. The
// denominators come from a first small kernel, summed in l order as the
// forward sums them.
//
// Bound on an H100: the bytes of the rows it writes. The two-tower
// training step (B = 65,536 bags of 32 over a 2M-row history table) touches
// ~1.3M distinct 1 KB rows: 1.33 GB written, ~0.4 ms at 3.35 TB/s, beside
// 67 MB of g and 8.4 MB of ids. Warps that are not at a run's head leave
// after two id loads.

namespace repro_torch {

__global__ void bag_denoms_kernel(const int* __restrict__ ids,
                                  const float* __restrict__ weights,
                                  float* __restrict__ denom, int b,
                                  int bag_len) {
  const long long bag = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (bag >= b) return;
  float s = 0.f;
  for (int l = 0; l < bag_len; ++l) {
    const long long i = bag * bag_len + l;
    const float w = __ldg(ids + i) < 0
                        ? 0.f
                        : (weights == nullptr ? 1.f : __ldg(weights + i));
    s = __fadd_rn(s, w);
  }
  denom[bag] = fmaxf(s, 1e-9f);
}

template <int VEC>
__device__ __forceinline__ void load_f32(const float* __restrict__ p,
                                         float (&out)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else {
    out[0] = __ldg(p);
  }
}

// The row of sorted position k: its id, folded onto v - 1 again so that no
// id can write past the table.
__device__ __forceinline__ int run_key(const int* __restrict__ sorted_ids,
                                       long long k, int v) {
  return min(__ldg(sorted_ids + k), v - 1);
}

template <int VEC>
__global__ void bag_grad_rows_kernel(const float* __restrict__ g,
                                     const int* __restrict__ sorted_ids,
                                     const long long* __restrict__ perm,
                                     const float* __restrict__ weights,
                                     const float* __restrict__ denom,
                                     float* __restrict__ out, long long n,
                                     int bag_len, int v, int d) {
  const long long j =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (j >= n) return;                                 // whole warps only
  const int key = run_key(sorted_ids, j, v);
  if (key < 0) return;                                // a pad
  if (j > 0 && run_key(sorted_ids, j - 1, v) == key) return;  // not a head
  const int lane = threadIdx.x & 31;
  float* row = out + (long long)key * d;
  for (int c = lane * VEC; c < d; c += 32 * VEC) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (long long k = j; k < n && run_key(sorted_ids, k, v) == key; ++k) {
      const long long p = __ldg(perm + k);
      const long long bag = p / bag_len;
      float t[VEC];
      load_f32<VEC>(g + bag * d + c, t);
      if (denom != nullptr) {
        const float s = __ldg(denom + bag);
#pragma unroll
        for (int e = 0; e < VEC; ++e) t[e] = __fdiv_rn(t[e], s);
      }
      if (weights != nullptr) {
        const float w = __ldg(weights + p);
#pragma unroll
        for (int e = 0; e < VEC; ++e) t[e] = __fmul_rn(t[e], w);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], t[e]);
    }
    if constexpr (VEC == 4) {
      float4* dst = reinterpret_cast<float4*>(row + c);
      const float4 o = *dst;
      *dst = make_float4(__fadd_rn(o.x, acc[0]), __fadd_rn(o.y, acc[1]),
                         __fadd_rn(o.z, acc[2]), __fadd_rn(o.w, acc[3]));
    } else {
      row[c] = __fadd_rn(row[c], acc[0]);
    }
  }
}

}  // namespace repro_torch

// g (b, d) f32; ids (b, bag_len) int32; sorted_ids (b * bag_len) int32, the
// flat ids stably sorted, and perm (b * bag_len) int64 their flat positions;
// weights (b, bag_len) f32 or null; denom (b) f32 scratch (read only under
// mean); out (v, d) f32, added into. vec4: d % 4 == 0 and g, out aligned
// to 16 bytes.
extern "C" int embedding_bag_backward(const void* g, const void* ids,
                                      const void* sorted_ids,
                                      const void* perm, const void* weights,
                                      void* denom, void* out, int b,
                                      int bag_len, int v, int d, int mean,
                                      int vec4, void* stream) {
  using namespace repro_torch;
  const long long n = (long long)b * bag_len;
  if (n > 0 && d > 0 && v > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (mean)
      bag_denoms_kernel<<<(b + 255) / 256, 256, 0, s>>>(
          (const int*)ids, (const float*)weights, (float*)denom, b, bag_len);
    const float* dn = mean ? (const float*)denom : nullptr;
    const unsigned grid = (unsigned)((n + 7) / 8);     // 8 warps a block
    if (vec4)
      bag_grad_rows_kernel<4><<<grid, 256, 0, s>>>(
          (const float*)g, (const int*)sorted_ids, (const long long*)perm,
          (const float*)weights, dn, (float*)out, n, bag_len, v, d);
    else
      bag_grad_rows_kernel<1><<<grid, 256, 0, s>>>(
          (const float*)g, (const int*)sorted_ids, (const long long*)perm,
          (const float*)weights, dn, (float*)out, n, bag_len, v, d);
  }
  return (int)cudaGetLastError();
}
