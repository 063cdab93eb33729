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
// Bound on an H100: the bytes of the gathered rows. Serving a 512-request
// batch of 32-item histories at D = 256 reads 512 * 32 * 1 KB = 16.8 MB of
// rows, about 5 us at 3.35 TB/s; the FMAs (2 flops per element read) are far
// below the card's rate, and such small batches are launch-bound.
//
// Design: one warp per bag, kBagWarps warps per block. A lane owns the
// VEC-element chunks c = lane, lane + 32, ... of a row (VEC = 4: one 16-byte
// float4 load for f32, 8 bytes for bf16, when D % 4 == 0 and the table is
// aligned; VEC = 1 otherwise, e.g. D = 18), so each load instruction of the
// warp reads a contiguous 512 B (f32) of the row. Chunks go in groups of
// kChunks per lane (256 f32 columns); wider rows loop over groups. The l loop
// is unrolled by kUnroll: all kUnroll x kChunks loads of a step are issued
// before its FMAs, which then run in l order. A bf16 table is widened to f32
// on load (exact).
#include <cuda_bf16.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kBagWarps = 4;
constexpr int kChunks = 2;
constexpr int kUnroll = 4;

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

template <typename T, int VEC>
__global__ void __launch_bounds__(kBagWarps * 32)
embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                     const float* __restrict__ weights,
                     float* __restrict__ out, int b, int bag_len, int v,
                     int d, bool mean) {
  const long long bag = (long long)blockIdx.x * kBagWarps + (threadIdx.x >> 5);
  if (bag >= b) return;
  const int lane = threadIdx.x & 31;
  const int* bag_ids = ids + bag * bag_len;
  const float* bag_w = weights == nullptr ? nullptr : weights + bag * bag_len;
  const int n_chunks = d / VEC;
  float* out_row = out + bag * d;

  for (int c0 = lane; c0 < n_chunks; c0 += 32 * kChunks) {
    float acc[kChunks][VEC];
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[ch][e] = 0.f;
    float denom = 0.f;

    for (int l0 = 0; l0 < bag_len; l0 += kUnroll) {
      float val[kUnroll][kChunks][VEC];
      float wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int l = l0 + u;
        const int id = l < bag_len ? __ldg(bag_ids + l) : -1;
        wv[u] = id < 0 ? 0.f : (bag_w == nullptr ? 1.f : __ldg(bag_w + l));
        const T* row = table + (long long)min(id, v - 1) * d;
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch) {
          const int c = c0 + 32 * ch;
          if (id >= 0 && c < n_chunks) {
            load_chunk<T, VEC>(row + (long long)c * VEC, val[u][ch]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) val[u][ch][e] = 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (l0 + u < bag_len) denom = __fadd_rn(denom, wv[u]);
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[ch][e] = __fmaf_rn(wv[u], val[u][ch][e], acc[ch][e]);
      }
    }

    const float div = fmaxf(denom, 1e-9f);
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const int c = c0 + 32 * ch;
      if (c >= n_chunks) continue;
      float r[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        r[e] = mean ? __fdiv_rn(acc[ch][e], div) : acc[ch][e];
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(out_row + 4 * c) =
            make_float4(r[0], r[1], r[2], r[3]);
      } else {
        out_row[c] = r[0];
      }
    }
  }
}

template <typename T>
void launch_bag(const void* table, const void* ids, const void* weights,
                void* out, int b, int bag_len, int v, int d, bool mean,
                bool vec4, cudaStream_t stream) {
  const unsigned grid = (unsigned)((b + kBagWarps - 1) / kBagWarps);
  if (vec4) {
    embedding_bag_kernel<T, 4><<<grid, kBagWarps * 32, 0, stream>>>(
        (const T*)table, (const int*)ids, (const float*)weights, (float*)out,
        b, bag_len, v, d, mean);
  } else {
    embedding_bag_kernel<T, 1><<<grid, kBagWarps * 32, 0, stream>>>(
        (const T*)table, (const int*)ids, (const float*)weights, (float*)out,
        b, bag_len, v, d, mean);
  }
}

}  // namespace repro_torch

// table (v, d) f32 or bf16 (bf16 != 0), ids (b, bag_len) int32, weights
// (b, bag_len) f32 or null, out (b, d) f32. vec4: d % 4 == 0 and the table
// aligned to 4 elements.
extern "C" int embedding_bag(const void* table, const void* ids,
                             const void* weights, void* out, int b,
                             int bag_len, int v, int d, int mean, int vec4,
                             int bf16, void* stream) {
  if (b > 0 && d > 0) {
    if (bf16) {
      repro_torch::launch_bag<__nv_bfloat16>(
          table, ids, weights, out, b, bag_len, v, d, mean != 0, vec4 != 0,
          (cudaStream_t)stream);
    } else {
      repro_torch::launch_bag<float>(table, ids, weights, out, b, bag_len, v,
                                     d, mean != 0, vec4 != 0,
                                     (cudaStream_t)stream);
    }
  }
  return (int)cudaGetLastError();
}
