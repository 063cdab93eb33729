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
// kernel is that scatter-add, in two parts: a grouping of the ids (a
// "plan") and a sum over the plan. The plan depends on the ids alone, so a
// caller that scatters by the same ids several times (DimeNet's segment
// sums and gathered gradients) builds it once and passes it to each call.
//
// The grouping (bag_grouping) drops the pads (< 0), folds ids >= V onto V - 1
// and groups the flat positions stably by id: order (the n_valid positions,
// ascending within each id), rows (the U distinct ids, ascending), starts (U +
// 1 run starts, the last n_valid) and count = {U, n_valid}, which stays on the
// device (no host sync). It is a stable LSD radix sort over only the
// ceil(log2 V) bits an id can have, 8 bits a pass (3 passes at V = 171,008 or
// 14,010,368, where torch.sort sorts the whole 32-bit key): each 2048-id tile
// counts its digits, a scan per digit turns the counts into places, and each
// tile ranks its ids stably (__match_any_sync within a warp, warps in index
// order), stages them in shared memory in digit order and writes them out in
// that order, so neighbouring threads write neighbouring places. The first pass
// drops the pads. Then one pass counts each tile's run heads and one writes the
// runs (ballots, staged the same way). The only atomics are shared-memory
// integer counts, so the plan is the same on every run. Bound: the ids read
// once and the plan written once, a few microseconds at any path shape; the
// launches (3 a pass, then 2: 11 at 3 passes, 5 at one) and the passes'
// re-reads of the keys dominate. At molecule's 3,840 ids one pass of 2 tiles
// beat a one-block bitonic sort in registers (PERF.md §6), so there is no
// second path for small inputs.
//
// The sum (bag_grad_runs_kernel) puts a warp on each run, each warp
// striding over the runs (the grid fills the card; U is read on the
// device): lanes across D (float4 where D % 4 == 0, all of D = 256 in one
// pass), the run's positions, bags, denominators and weights loaded 32 at
// a time by the lanes and passed round by __shfl_sync, 4 rows of g (2 at D
// = 256) loaded before their terms are added, and the next runs' bounds
// and positions loaded while this one sums. The terms are added in order
// into an accumulator that starts at +0.0, and every rounding is spelled
// out (__fdiv_rn, __fmul_rn, __fadd_rn), so each row gets ((0 + t_0) +
// t_1) + ..., the plain version's order (kernels/embedding_bag/ref.py),
// with no float atomics. Store mode writes the sum into the row once (the
// caller's out is fresh zeros: 0 + acc has the bits of acc, -0.0
// included, since acc starts at +0.0); add mode adds it once. A long run
// (a hub) stays in one warp: splitting it would change the order of the
// sum.
//
// Bound on an H100: the bytes of the rows it writes and of g's rows it
// reads. The two-tower training step (B = 65,536 bags of 32 over a
// 14,010,368-row table) touches ~1.3M distinct 1 KB rows: 1.33 GB written,
// ~0.4 ms at 3.35 TB/s, beside 67 MB of g and 8.4 MB of ids. Each member
// reads its bag's row of g again (2.1 GB through the L2, which does not
// hold all 67 MB), which keeps the sum well above that bound (PERF.md
// §6); the stores stream past the L2 (evict first) to leave it to g.
// DimeNet's scatters read each row of g once.

namespace repro_torch {

constexpr int kRadixThreads = 256;   // == kRadixBins: one digit a thread
constexpr int kRadixBins = 256;
constexpr int kRadixItems = 8;
constexpr int kRadixTile = kRadixThreads * kRadixItems;      // 2048 ids
constexpr int kRadixWarps = kRadixThreads / 32;
constexpr int kSumWarps = 8;         // warps a block of the sum
constexpr int kSumUnroll = 4;        // row chunks in flight a lane

// Exclusive prefix sum of x over the block in thread order; *total gets
// the block's sum. Every thread calls it; it ends with a barrier.
__device__ __forceinline__ int block_exclusive_scan(int x, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFullMask, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int s = lane < warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFullMask, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = (warp == 0 ? 0 : warp_sums[warp - 1]) + inc - x;
  *total = warp_sums[warps - 1];
  __syncthreads();
  return before;
}

// --- the grouping: radix passes ---------------------------------------------

// Item i of a pass: the first pass (vals_in null) reads the caller's ids,
// drops the pads, folds ids >= v onto v - 1 and takes the flat position as
// the value; the later passes read the previous pass's keys and values.
__device__ __forceinline__ bool radix_item(const int* __restrict__ keys_in,
                                           const int* __restrict__ vals_in,
                                           long long i, int limit, int v,
                                           int& key, int& val) {
  if (i >= limit) return false;
  if (vals_in == nullptr) {
    const int id = __ldg(keys_in + i);
    if (id < 0) return false;
    key = min(id, v - 1);
    val = (int)i;
    return true;
  }
  key = __ldg(keys_in + i);
  val = __ldg(vals_in + i);
  return true;
}

// The ids a pass reads: n in the first, n_valid (count[1]) after it.
__device__ __forceinline__ int radix_limit(const int* count, int n,
                                           bool first) {
  return first ? n : *(volatile const int*)(count + 1);
}

// digit_counts[digit * tiles + tile]: the tile's ids with that digit.
__global__ void __launch_bounds__(kRadixThreads)
    radix_count_kernel(const int* __restrict__ keys_in,
                       const int* __restrict__ vals_in, const int* count,
                       int n, int v, int shift, int tiles,
                       int* __restrict__ digit_counts) {
  __shared__ int hist[kRadixBins];
  hist[threadIdx.x] = 0;
  __syncthreads();
  const int limit = radix_limit(count, n, vals_in == nullptr);
  const long long base = (long long)blockIdx.x * kRadixTile;
#pragma unroll 4
  for (int j = 0; j < kRadixItems; ++j) {
    int key, val;
    if (radix_item(keys_in, vals_in, base + j * kRadixThreads + threadIdx.x,
                   limit, v, key, val))
      atomicAdd(&hist[(key >> shift) & 0xff], 1);
  }
  __syncthreads();
  digit_counts[threadIdx.x * tiles + blockIdx.x] = hist[threadIdx.x];
}

// Block d: row d of digit_counts to its exclusive prefix over the tiles;
// digit_total[d] gets the row's sum.
__global__ void __launch_bounds__(kRadixThreads)
    radix_scan_kernel(int* __restrict__ digit_counts,
                      int* __restrict__ digit_total, int tiles) {
  int* row = digit_counts + (long long)blockIdx.x * tiles;
  int carry = 0;
  for (int t0 = 0; t0 < tiles; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    const int c = t < tiles ? row[t] : 0;
    int total;
    const int before = block_exclusive_scan(c, &total);
    if (t < tiles) row[t] = carry + before;
    carry += total;
  }
  if (threadIdx.x == 0) digit_total[blockIdx.x] = carry;
}

// Each tile's ids to their place, stably: ranked within a warp by round
// and lane (__match_any_sync), warps in index order, staged in shared
// memory in the tile's digit order and written out in that order, so
// neighbouring threads write neighbouring places. The first pass's block 0
// writes n_valid (count[1]).
__global__ void __launch_bounds__(kRadixThreads)
    radix_scatter_kernel(const int* __restrict__ keys_in,
                         const int* __restrict__ vals_in, int* count, int n,
                         int v, int shift, int tiles,
                         const int* __restrict__ digit_counts,
                         const int* __restrict__ digit_total,
                         int* __restrict__ keys_out,
                         int* __restrict__ vals_out) {
  __shared__ int warp_hist[kRadixWarps][kRadixBins];
  __shared__ int tile_start[kRadixBins];     // a digit's first staged slot
  __shared__ int tile_shift[kRadixBins];     // its place minus that slot
  __shared__ int stage_keys[kRadixTile];
  __shared__ int stage_vals[kRadixTile];
  const bool first = vals_in == nullptr;
  const int limit = radix_limit(count, n, first);
  const long long base = (long long)blockIdx.x * kRadixTile;
  if (base >= limit) return;                     // uniform across the block
  int total;
  const int before = block_exclusive_scan(__ldg(digit_total + threadIdx.x),
                                          &total);
  const int place =
      before + __ldg(digit_counts + threadIdx.x * tiles + blockIdx.x);
  if (first && blockIdx.x == 0 && threadIdx.x == 0) count[1] = total;
#pragma unroll
  for (int w = 0; w < kRadixWarps; ++w) warp_hist[w][threadIdx.x] = 0;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const long long wbase = base + (long long)warp * (kRadixTile / kRadixWarps);
  int key[kRadixItems], val[kRadixItems], rank[kRadixItems];
#pragma unroll
  for (int j = 0; j < kRadixItems; ++j) {
    const bool ok = radix_item(keys_in, vals_in, wbase + j * 32 + lane,
                               limit, v, key[j], val[j]);
    const int dg = ok ? (key[j] >> shift) & 0xff : kRadixBins;
    const unsigned peers = __match_any_sync(kFullMask, dg);
    const int r = ok ? warp_hist[warp][dg] : 0;
    __syncwarp();
    if (ok && (peers & below) == 0) warp_hist[warp][dg] = r + __popc(peers);
    __syncwarp();
    rank[j] = ok ? r + __popc(peers & below) : -1;
  }
  __syncthreads();
  int in_digit = 0;                              // digit threadIdx.x
#pragma unroll
  for (int w = 0; w < kRadixWarps; ++w) {
    const int c = warp_hist[w][threadIdx.x];
    warp_hist[w][threadIdx.x] = in_digit;
    in_digit += c;
  }
  int staged;
  const int slot = block_exclusive_scan(in_digit, &staged);
  tile_start[threadIdx.x] = slot;
  tile_shift[threadIdx.x] = place - slot;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kRadixItems; ++j) {
    if (rank[j] < 0) continue;
    const int dg = (key[j] >> shift) & 0xff;
    const int at = tile_start[dg] + warp_hist[warp][dg] + rank[j];
    stage_keys[at] = key[j];
    stage_vals[at] = val[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < staged; i += kRadixThreads) {
    const int k = stage_keys[i];
    const int at = tile_shift[(k >> shift) & 0xff] + i;
    keys_out[at] = k;
    vals_out[at] = stage_vals[i];
  }
}

__device__ __forceinline__ bool run_head(const int* __restrict__ keys,
                                         long long k, int n_valid) {
  return k < n_valid && (k == 0 || __ldg(keys + k - 1) != __ldg(keys + k));
}

// tile_heads[tile]: the run heads among the tile's sorted ids.
__global__ void __launch_bounds__(kRadixThreads)
    run_count_kernel(const int* __restrict__ keys, const int* count,
                     int* __restrict__ tile_heads) {
  const int n_valid = *(volatile const int*)(count + 1);
  const long long base = (long long)blockIdx.x * kRadixTile;
  int h = 0;
#pragma unroll 4
  for (int j = 0; j < kRadixItems; ++j)
    h += run_head(keys, base + j * kRadixThreads + threadIdx.x, n_valid);
  int total;
  block_exclusive_scan(h, &total);
  if (threadIdx.x == 0) tile_heads[blockIdx.x] = total;
}

// rows[run], starts[run] for each head, in order: heads found a warp's 32
// places at a time (ballots), staged in shared memory, written out by
// neighbouring threads; the last tile with ids writes U (count[0]) and
// starts[U] = n_valid.
__global__ void __launch_bounds__(kRadixThreads)
    run_write_kernel(const int* __restrict__ keys, int* count,
                     const int* __restrict__ tile_heads,
                     int* __restrict__ rows, int* __restrict__ starts) {
  __shared__ int head_at[kRadixTile];
  const int n_valid = *(volatile const int*)(count + 1);
  const long long base = (long long)blockIdx.x * kRadixTile;
  int earlier = 0;
  for (int t = threadIdx.x; t < (int)blockIdx.x; t += blockDim.x)
    earlier += __ldg(tile_heads + t);
  int first_run;
  block_exclusive_scan(earlier, &first_run);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const int wbase = warp * (kRadixTile / kRadixWarps);
  unsigned heads[kRadixItems];
  int mine = 0;
#pragma unroll
  for (int j = 0; j < kRadixItems; ++j) {
    heads[j] = __ballot_sync(kFullMask,
                             run_head(keys, base + wbase + j * 32 + lane,
                                      n_valid));
    mine += __popc(heads[j]);
  }
  int tile_runs;
  int at = block_exclusive_scan(lane == 0 ? mine : 0, &tile_runs);
  at = __shfl_sync(kFullMask, at, 0);            // this warp's first slot
#pragma unroll
  for (int j = 0; j < kRadixItems; ++j) {
    if (heads[j] >> lane & 1u)
      head_at[at + __popc(heads[j] & below)] = wbase + j * 32 + lane;
    at += __popc(heads[j]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tile_runs; i += kRadixThreads) {
    const long long k = base + head_at[i];
    rows[first_run + i] = __ldg(keys + k);
    starts[first_run + i] = (int)k;
  }
  const int last = max((n_valid + kRadixTile - 1) / kRadixTile, 1) - 1;
  if (threadIdx.x == 0 && (int)blockIdx.x == last) {
    const int u = first_run + tile_runs;
    count[0] = u;
    starts[u] = n_valid;
  }
}

__host__ __device__ constexpr int radix_tiles(int n) {
  return (n + kRadixTile - 1) / kRadixTile;
}

// Radix passes for ids of up to bits(v - 1) bits, at least one (it drops
// the pads).
static int radix_passes(int v) {
  int bits = 0;
  while (bits < 31 && ((v - 1) >> bits) != 0) ++bits;
  return bits == 0 ? 1 : (bits + 7) / 8;
}

// --- the sum ----------------------------------------------------------------

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

// Each warp takes runs r, r + (the grid's warps), ... < U: rows[r]'s
// terms over order[starts[r] .. starts[r+1]), CH chunks of 32 * VEC
// columns a pass (all of D = 256 in one pass at CH = 2, VEC = 4). Loads
// run ahead of the sum: the row and bounds of the run after next, and the
// first 32 positions of the next run, whose bounds are then in hand; the
// rows of g are loaded before the denominators and weights are passed.
template <int VEC, int CH, bool STORE>
__global__ void __launch_bounds__(kSumWarps * 32, 4)
    bag_grad_runs_kernel(const float* __restrict__ g,
                         const int* __restrict__ order,
                         const int* __restrict__ rows,
                         const int* __restrict__ starts,
                         const int* __restrict__ count,
                         const float* __restrict__ weights,
                         const float* __restrict__ denom,
                         float* __restrict__ out, int cap, int bag_len,
                         int v, int d) {
  constexpr int kU = kSumUnroll / CH;            // members in flight
  const int lane = threadIdx.x & 31;
  const int runs = min(cap, __ldg(count));
  const int stride = gridDim.x * kSumWarps;
  int r = blockIdx.x * kSumWarps + (threadIdx.x >> 5);
  if (r >= runs) return;
  // this run's row, bounds and first positions; the next run's row and
  // bounds
  int row = __ldg(rows + r), s = __ldg(starts + r), e = __ldg(starts + r + 1);
  int first = s + lane < e ? __ldg(order + s + lane) : 0;
  int row1 = 0, s1 = 0, e1 = 0;
  if (r + stride < runs) {
    row1 = __ldg(rows + r + stride);
    s1 = __ldg(starts + r + stride);
    e1 = __ldg(starts + r + stride + 1);
  }
  for (; r < runs; r += stride) {
    int first1 = 0, row2 = 0, s2 = 0, e2 = 0;
    if (r + stride < runs && s1 + lane < e1) first1 = __ldg(order + s1 + lane);
    if (r + 2 * stride < runs) {
      row2 = __ldg(rows + r + 2 * stride);
      s2 = __ldg(starts + r + 2 * stride);
      e2 = __ldg(starts + r + 2 * stride + 1);
    }
    float* dst_row = out + (long long)min(row, v - 1) * d;   // in the table
    for (int c0 = 0; c0 < d; c0 += 32 * VEC * CH) {
      float acc[CH][VEC];
#pragma unroll
      for (int h = 0; h < CH; ++h)
#pragma unroll
        for (int x = 0; x < VEC; ++x) acc[h][x] = 0.f;
      for (int k0 = s; k0 < e; k0 += 32) {
        const bool mine = k0 + lane < e;
        const int p = k0 == s ? first : (mine ? __ldg(order + k0 + lane) : 0);
        const int my_bag = p / bag_len;
        float my_den = 1.f, my_w = 1.f;
        if (mine && denom != nullptr) my_den = __ldg(denom + my_bag);
        if (mine && weights != nullptr) my_w = __ldg(weights + p);
        const int m = min(32, e - k0);
        for (int j = 0; j < m; j += kU) {
          float t[kU][CH][VEC];
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const int bag = __shfl_sync(kFullMask, my_bag, j + u);
#pragma unroll
            for (int h = 0; h < CH; ++h) {
              const int c = c0 + (h * 32 + lane) * VEC;
              if (j + u < m && c < d) {
                load_f32<VEC>(g + (long long)bag * d + c, t[u][h]);
              } else {
#pragma unroll
                for (int x = 0; x < VEC; ++x) t[u][h][x] = 0.f;
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            if (j + u >= m) break;                      // uniform
            const float den = __shfl_sync(kFullMask, my_den, j + u);
            const float w = __shfl_sync(kFullMask, my_w, j + u);
#pragma unroll
            for (int h = 0; h < CH; ++h)
#pragma unroll
              for (int x = 0; x < VEC; ++x) {
                float term = t[u][h][x];
                if (denom != nullptr) term = __fdiv_rn(term, den);
                if (weights != nullptr) term = __fmul_rn(term, w);
                acc[h][x] = __fadd_rn(acc[h][x], term);
              }
          }
        }
      }
#pragma unroll
      for (int h = 0; h < CH; ++h) {
        const int c = c0 + (h * 32 + lane) * VEC;
        if (c >= d) continue;
        float* dst = dst_row + c;
        // streaming stores (evict first): the rows of g, read again by
        // other runs, keep the L2
        if constexpr (VEC == 4) {
          float4 o = make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
          if constexpr (!STORE) {
            const float4 was = __ldcs(reinterpret_cast<float4*>(dst));
            o = make_float4(__fadd_rn(was.x, o.x), __fadd_rn(was.y, o.y),
                            __fadd_rn(was.z, o.z), __fadd_rn(was.w, o.w));
          }
          __stcs(reinterpret_cast<float4*>(dst), o);
        } else {
          __stcs(dst, STORE ? acc[h][0] : __fadd_rn(__ldcs(dst), acc[h][0]));
        }
      }
    }
    row = row1, s = s1, e = e1, first = first1;
    row1 = row2, s1 = s2, e1 = e2;
  }
}

template <int VEC, int CH, bool STORE>
void launch_runs(const void* g, const void* order, const void* rows,
                 const void* starts, const void* count, const void* weights,
                 const float* denom, void* out, int cap, int bag_len, int v,
                 int d, cudaStream_t s) {
  // enough blocks to fill the card; each warp then strides over the runs
  const long long want = (cap + kSumWarps - 1) / kSumWarps;
  const long long fill = 16LL * sm_count();
  const unsigned grid = (unsigned)(want < fill ? want : fill);
  bag_grad_runs_kernel<VEC, CH, STORE><<<grid, kSumWarps * 32, 0, s>>>(
      (const float*)g, (const int*)order, (const int*)rows,
      (const int*)starts, (const int*)count, (const float*)weights, denom,
      (float*)out, cap, bag_len, v, d);
}

template <int VEC, bool STORE>
void launch_runs_ch(const void* g, const void* order, const void* rows,
                    const void* starts, const void* count,
                    const void* weights, const float* denom, void* out,
                    int cap, int bag_len, int v, int d, cudaStream_t s) {
  if (d > 32 * VEC)
    launch_runs<VEC, 2, STORE>(g, order, rows, starts, count, weights, denom,
                               out, cap, bag_len, v, d, s);
  else
    launch_runs<VEC, 1, STORE>(g, order, rows, starts, count, weights, denom,
                               out, cap, bag_len, v, d, s);
}

}  // namespace repro_torch

// int32 words of scratch bag_grouping needs for n ids.
extern "C" long long bag_grouping_scratch_words(int n) {
  using namespace repro_torch;
  const long long tiles = radix_tiles(n);
  return 4LL * n + kRadixBins * tiles + kRadixBins + tiles;
}

// ids (n) int32, any values (< 0 pads); v >= 1 rows. Writes order (n; the
// first n_valid used), rows (min(n, v); the first U), starts (min(n, v) +
// 1; the first U + 1) and count = {U, n_valid}, all int32 on the device.
// scratch: bag_grouping_scratch_words(n) int32 words. No ids launches no
// kernel, only two memsets.
extern "C" int bag_grouping(const void* ids, void* order, void* rows,
                            void* starts, void* count, void* scratch, int n,
                            int v, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) {                     // no runs: count = {0, 0}, starts[0] = 0
    cudaMemsetAsync(count, 0, 2 * sizeof(int), s);
    cudaMemsetAsync(starts, 0, sizeof(int), s);
    return (int)cudaGetLastError();
  }
  const int tiles = radix_tiles(n);
  int* keys_buf[2] = {(int*)scratch, (int*)scratch + n};
  int* vals_buf[2] = {(int*)scratch + 2LL * n, (int*)scratch + 3LL * n};
  int* digit_counts = (int*)scratch + 4LL * n;
  int* digit_total = digit_counts + (long long)kRadixBins * tiles;
  int* tile_heads = digit_total + kRadixBins;
  const int passes = radix_passes(v);
  const int* keys_in = (const int*)ids;
  const int* vals_in = nullptr;
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = 8 * pass;
    int* keys_out = keys_buf[pass & 1];
    int* vals_out = pass == passes - 1 ? (int*)order : vals_buf[pass & 1];
    radix_count_kernel<<<tiles, kRadixThreads, 0, s>>>(
        keys_in, vals_in, (const int*)count, n, v, shift, tiles,
        digit_counts);
    radix_scan_kernel<<<kRadixBins, kRadixThreads, 0, s>>>(
        digit_counts, digit_total, tiles);
    radix_scatter_kernel<<<tiles, kRadixThreads, 0, s>>>(
        keys_in, vals_in, (int*)count, n, v, shift, tiles, digit_counts,
        digit_total, keys_out, vals_out);
    keys_in = keys_out;
    vals_in = vals_out;
  }
  run_count_kernel<<<tiles, kRadixThreads, 0, s>>>(keys_in, (const int*)count,
                                                    tile_heads);
  run_write_kernel<<<tiles, kRadixThreads, 0, s>>>(
      keys_in, (int*)count, tile_heads, (int*)rows, (int*)starts);
  return (int)cudaGetLastError();
}

// g (b, d) f32; ids (b, bag_len) int32 (read under mean only); the plan of
// the flat ids over v rows (bag_grouping: order, rows, starts, count; cap =
// min(b * bag_len, v)); weights (b, bag_len) f32 or null; denom (b) f32
// scratch (read only under mean); out (v, d) f32: store mode writes each
// touched row's sum, add mode adds it. vec4: d % 4 == 0 and g, out aligned
// to 16 bytes.
extern "C" int embedding_bag_backward(const void* g, const void* ids,
                                      const void* order, const void* rows,
                                      const void* starts, const void* count,
                                      const void* weights, void* denom,
                                      void* out, int b, int bag_len, int v,
                                      int d, int cap, int mean, int vec4,
                                      int store, void* stream) {
  using namespace repro_torch;
  if (cap > 0 && d > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (mean)
      bag_denoms_kernel<<<(b + 255) / 256, 256, 0, s>>>(
          (const int*)ids, (const float*)weights, (float*)denom, b, bag_len);
    const float* dn = mean ? (const float*)denom : nullptr;
    if (vec4 && store)
      launch_runs_ch<4, true>(g, order, rows, starts, count, weights, dn,
                              out, cap, bag_len, v, d, s);
    else if (vec4)
      launch_runs_ch<4, false>(g, order, rows, starts, count, weights, dn,
                               out, cap, bag_len, v, d, s);
    else if (store)
      launch_runs_ch<1, true>(g, order, rows, starts, count, weights, dn,
                              out, cap, bag_len, v, d, s);
    else
      launch_runs_ch<1, false>(g, order, rows, starts, count, weights, dn,
                               out, cap, bag_len, v, d, s);
  }
  return (int)cudaGetLastError();
}
