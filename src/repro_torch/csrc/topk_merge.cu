// topk_merge: per row of (B, M) candidates (ids, dists[, fresh]) drop
// duplicate ids and keep the k nearest, padded with (-1, +inf, false).
//
// Replaces the TPU kernel src/repro/kernels/topk_merge/topk_merge.py,
// topk_merge_pallas (body _topk_merge_kernel, keys _dedup_gt/_dist_gt),
// behind both entry points of ops.py. Unlike the Pallas kernel it matches
// src/repro/kernels/topk_merge/ref.py exactly, ties included:
//   pool mode  (topk_pool_ref):  the kept copy of an id is its least
//     (dist, position); survivors come out by (dist, position); ids < 0 and
//     non-finite dists come out as (-1, inf).
//   merge mode (topk_merge_ref): the kept copy is the first by
//     (fresh, position); the output is ordered by (dist, id, fresh,
//     position), the order the reference's last stable argsort leaves;
//     fresh is cleared where the id is -1.
//
// Bound on an H100: bytes, and they are few. The NSG pool assembly
// (B=2048, M=96, k=64) moves about 2.6 MB per launch, under 1 us at
// 3.35 TB/s, so what sets the time is each row's chain of sort stages:
// 28 stages of dependent compare-and-select on 64-bit keys per sort of 128
// keys, issued by the row's own warp.
//
// M is padded to a power of two p >= 32 (96 -> 128). Every sort is one
// bitonic network over unique 64-bit keys whose low bits hold a rank or a
// position, which makes it equal to the reference's stable argsorts. Two
// variants (kernels/topk_merge/topk_merge.py: route):
//
// block (p <= 2048): one block of 128 threads per row, everything in
//   shared memory, each sort stage ended by a barrier (2 x 28 at p = 128).
//   pool:  sort A by (dist, position); sort B by (id, rank in A); an entry
//          is a duplicate if its id equals its predecessor's in B; warp 0
//          then compacts the survivors in A order with ballots.
//   merge: sort A by (id, fresh, position); duplicates are adjacent in A;
//          sort B by (dist with duplicates at +inf, rank in A).
//
// warp (p <= 256): one warp per row, p / 32 keys per lane in registers,
//   lane l holding the sorted ranks l * E .. l * E + E - 1 (E = p / 32), so
//   a stage of stride below E is a compare-exchange inside a lane and a
//   larger one a __shfl_xor_sync of the 64-bit key; a stage's direction
//   comes from the lane's bits alone; no barrier but the warp's own.
//   Several rows per block, each warp on its own.
//   merge: the block variant's two sorts, predecessors by __shfl_up_sync.
//   pool:  each valid entry takes the least A key (dist, position) of its
//          id in a per-warp open-addressing table in shared memory; an entry
//          that is not its id's least, an id < 0 or a non-finite dist gets
//          the key (+inf marker, position); then ONE sort, whose first k
//          ranks are the output in the reference's order. (The block
//          variant's two-sort dedup, run by one warp, was 2-9% slower at
//          the path's shapes, whose padding and -1 ids skip the table;
//          PERF.md §6.)
#include "common.cuh"

namespace repro_torch {

constexpr int kTopkThreads = 128;

__global__ void __launch_bounds__(kTopkThreads)
topk_merge_kernel(const int* __restrict__ ids, const float* __restrict__ ds,
                  const uint8_t* __restrict__ fresh, int* __restrict__ out_i,
                  float* __restrict__ out_d, uint8_t* __restrict__ out_f,
                  int m, int k, int p, bool merge) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* key_a = smem;       // p
  unsigned long long* key_b = smem + p;   // p
  int* s_id = reinterpret_cast<int*>(smem + 2 * p);     // p, by position
  float* s_d = reinterpret_cast<float*>(s_id + p);      // p, by position
  int* s_keep = reinterpret_cast<int*>(s_d + p);        // p, by rank in A

  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const float inf = __int_as_float(0x7f800000);

  for (int e = tid; e < p; e += blockDim.x) {
    int id = -1;
    float dist = inf;
    unsigned f = 0;
    if (e < m) {
      id = ids[row * m + e];
      dist = ds[row * m + e];
      if (merge) f = fresh[row * m + e] ? 1u : 0u;
    }
    s_id[e] = id;
    if (merge) {
      s_d[e] = dist;
      // signed id order (-1 first, as the reference's argsort of ids)
      const unsigned id_key = (unsigned)id ^ 0x80000000u;
      key_a[e] = ((unsigned long long)id_key << 32) | (f << 31) | (unsigned)e;
    } else {
      if (id < 0) dist = inf;
      s_d[e] = dist;
      key_a[e] = ((unsigned long long)float_key(dist) << 32) | (unsigned)e;
    }
  }
  block_sort(key_a, p);

  if (merge) {
    for (int t = tid; t < p; t += blockDim.x) {
      const int src = (int)(key_a[t] & 0x7fffffffu);
      const int id = s_id[src];
      const bool dup = t > 0 && s_id[(int)(key_a[t - 1] & 0x7fffffffu)] == id;
      const float dist = (dup || id < 0) ? inf : s_d[src];
      key_b[t] = ((unsigned long long)float_key(dist) << 32) | (unsigned)t;
    }
    block_sort(key_b, p);
    for (int u = tid; u < k; u += blockDim.x) {
      const int t = (int)(key_b[u] & 0xffffffffu);
      const unsigned long long a = key_a[t];
      const int src = (int)(a & 0x7fffffffu);
      const int prev = t > 0 ? s_id[(int)(key_a[t - 1] & 0x7fffffffu)] : 0;
      const int id = s_id[src];
      const bool dup = t > 0 && prev == id;
      const bool keep = !dup && id >= 0 && isfinite(s_d[src]);
      out_i[row * k + u] = keep ? id : -1;
      out_d[row * k + u] = (dup || id < 0) ? inf : s_d[src];
      out_f[row * k + u] = (keep && ((a >> 31) & 1u)) ? 1 : 0;
    }
    return;
  }

  for (int t = tid; t < p; t += blockDim.x) {
    const int id = s_id[(int)(key_a[t] & 0xffffffffu)];
    // ids < 0 sort last, as the reference's duplicate mask marks them
    const unsigned id_key = id < 0 ? 0xffffffffu : (unsigned)id;
    key_b[t] = ((unsigned long long)id_key << 32) | (unsigned)t;
  }
  block_sort(key_b, p);
  for (int u = tid; u < p; u += blockDim.x) {
    const unsigned long long b = key_b[u];
    const int t = (int)(b & 0xffffffffu);
    const bool first = u == 0 || (key_b[u - 1] >> 32) != (b >> 32);
    const int src = (int)(key_a[t] & 0xffffffffu);
    s_keep[t] = first && s_id[src] >= 0 && isfinite(s_d[src]);
  }
  __syncthreads();
  if (tid < 32) {
    const int lane = tid;
    int base = 0;
    for (int c = 0; c < p; c += 32) {
      const int t = c + lane;
      const bool keep = s_keep[t] != 0;
      const unsigned mask = __ballot_sync(kFullMask, keep);
      const int slot = base + __popc(mask & ((1u << lane) - 1u));
      if (keep && slot < k) {
        const int src = (int)(key_a[t] & 0xffffffffu);
        out_i[row * k + slot] = s_id[src];
        out_d[row * k + slot] = s_d[src];
      }
      base += __popc(mask);
    }
    for (int slot = base + lane; slot < k; slot += 32) {
      out_i[row * k + slot] = -1;
      out_d[row * k + slot] = inf;
    }
  }
}


constexpr int kTopkWarps = 8;          // rows (warps) per block, warp variant
constexpr int kWarpMaxSort = 256;      // the warp variant's largest p
constexpr unsigned long long kEmptyKey = ~0ull;
constexpr unsigned kDropHigh = 0xffffffffu;   // above every float_key

// Ascending bitonic sort of the warp's 32 * E unique keys; lane l holds
// ranks l * E + e in key[e] (blocked layout), before and after.
template <int E>
__device__ __forceinline__ void warp_sort(unsigned long long (&key)[E]) {
  const int lane = threadIdx.x & 31;
  constexpr int P = 32 * E;
#pragma unroll
  for (int k = 2; k <= P; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      // rank i = lane * E + e: its bits at or above E are the lane's, so
      // a bit j or k >= E of i is bit j / E or k / E of the lane
      if (j >= E) {              // the partner sits in lane ^ (j / E)
        // the lower index of a pair keeps the min in an ascending run
        const bool take_min =
            ((lane & (j / E)) == 0) == ((lane & (k / E)) == 0);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const unsigned long long other =
              __shfl_xor_sync(kFullMask, key[e], j / E);
          key[e] = (key[e] < other) == take_min ? key[e] : other;
        }
      } else {                   // both in this lane
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if ((e & j) == 0) {
            const int f = (e | j) & (E - 1);   // e | j: j < E here
            const bool up = k < E ? (e & k) == 0 : (lane & (k / E)) == 0;
            const unsigned long long a = key[e], b = key[f];
            const bool swap = (a > b) == up;
            key[e] = swap ? b : a;
            key[f] = swap ? a : b;
          }
        }
      }
    }
  }
}

// pred[e] = the key of rank lane * E + e - 1 (meaningless at rank 0).
template <int E>
__device__ __forceinline__ void warp_preds(const unsigned long long (&key)[E],
                                           unsigned long long (&pred)[E]) {
  pred[0] = __shfl_up_sync(kFullMask, key[E - 1], 1);
#pragma unroll
  for (int e = 1; e < E; ++e) pred[e] = key[e - 1];
}

// Per-warp shared memory of the warp variant, in 4-byte words: ids and
// dists by position (2p), and in pool mode the dedup table of 2p 64-bit
// keys and 2p ids (6p).
__host__ __device__ __forceinline__ int warp_smem_words(int p, bool merge) {
  return 2 * p + (merge ? 0 : 6 * p);
}

__host__ __device__ constexpr int log2_of(int x) {
  return x <= 1 ? 0 : 1 + log2_of(x >> 1);
}

template <int E, bool kMerge>
__global__ void __launch_bounds__(kTopkWarps * 32)
topk_merge_warp_kernel(const int* __restrict__ ids,
                       const float* __restrict__ ds,
                       const uint8_t* __restrict__ fresh,
                       int* __restrict__ out_i, float* __restrict__ out_d,
                       uint8_t* __restrict__ out_f, int b, int m, int k) {
  constexpr int P = 32 * E;
  extern __shared__ unsigned long long smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kTopkWarps + warp;
  if (row >= b) return;                  // the whole warp: no block barrier
  // 2P words (even), so the table's 64-bit keys stay 8-byte aligned
  int* s_id = reinterpret_cast<int*>(smem) +
              (size_t)warp * warp_smem_words(P, kMerge);  // P
  float* s_d = reinterpret_cast<float*>(s_id + P);        // P
  unsigned long long* tab_key =
      reinterpret_cast<unsigned long long*>(s_d + P);     // 2P (pool)
  int* tab_id = reinterpret_cast<int*>(tab_key + 2 * P);  // 2P (pool)
  const float inf = __int_as_float(0x7f800000);
  const int* row_i = ids + row * m;
  const float* row_d = ds + row * m;

  // load: lane l takes positions l, l + 32, ... (coalesced); the sorts do
  // not care where a key starts
  unsigned long long key[E];
  int my_id[E];
  bool ok[E];                            // pool: a valid id, a finite dist
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int pos = e * 32 + lane;
    int id = -1;
    float dist = inf;
    unsigned f = 0;
    if (pos < m) {
      id = row_i[pos];
      dist = row_d[pos];
      if (kMerge) f = fresh[row * m + pos] ? 1u : 0u;
    }
    if (!kMerge && id < 0) dist = inf;
    s_id[pos] = id;
    s_d[pos] = dist;
    my_id[e] = id;
    ok[e] = id >= 0 && isfinite(dist);
    if (kMerge) {
      const unsigned id_key = (unsigned)id ^ 0x80000000u;  // signed order
      key[e] = ((unsigned long long)id_key << 32) | (f << 31) | (unsigned)pos;
    } else {
      key[e] = ((unsigned long long)float_key(dist) << 32) | (unsigned)pos;
    }
  }

  if constexpr (kMerge) {
    __syncwarp();
    warp_sort<E>(key);
    // dup: same id as the predecessor in A; B by (dist, rank in A) with
    // the rank, the dup and fresh bits and the position below it
    unsigned long long pred[E], kb[E];
    warp_preds<E>(key, pred);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int t = lane * E + e;
      const bool dup = t > 0 && (pred[e] >> 32) == (key[e] >> 32);
      const int id = (int)((unsigned)(key[e] >> 32) ^ 0x80000000u);
      const unsigned src = (unsigned)(key[e] & 0x7fffffffu);
      const unsigned f = (unsigned)(key[e] >> 31) & 1u;
      const float dist = (dup || id < 0) ? inf : s_d[src];
      kb[e] = ((unsigned long long)float_key(dist) << 32) |
              ((unsigned)t << 16) | ((unsigned)dup << 9) | (f << 8) | src;
    }
    warp_sort<E>(kb);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int u = lane * E + e;
      if (u < k) {
        const unsigned lo = (unsigned)kb[e];
        const int src = (int)(lo & 0xffu);
        const bool dup = (lo >> 9) & 1u;
        const int id = s_id[src];
        const bool keep = !dup && id >= 0 && isfinite(s_d[src]);
        out_i[row * k + u] = keep ? id : -1;
        out_d[row * k + u] = (dup || id < 0) ? inf : s_d[src];
        out_f[row * k + u] = (keep && ((lo >> 8) & 1u)) ? 1 : 0;
      }
    }
    return;
  }

  // pool: each id's least A key, in a table of 2P slots (load <= 1/2)
  constexpr int H = 2 * P;
  constexpr int kShift = 32 - log2_of(H);
#pragma unroll
  for (int h = lane; h < H; h += 32) {
    tab_id[h] = -1;
    tab_key[h] = kEmptyKey;
  }
  __syncwarp();
  int slot[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    slot[e] = -1;
    const int id = my_id[e];
    if (ok[e]) {
      int h = (int)(((unsigned)id * 2654435761u) >> kShift);
      while (true) {
        const int old = atomicCAS(&tab_id[h], -1, id);
        if (old == -1 || old == id) break;
        h = (h + 1) & (H - 1);
      }
      atomicMin(&tab_key[h], key[e]);
      slot[e] = h;
    }
  }
  __syncwarp();
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (slot[e] < 0 || tab_key[slot[e]] != key[e])
      key[e] = ((unsigned long long)kDropHigh << 32) | (key[e] & 0xffffu);
  }
  warp_sort<E>(key);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int u = lane * E + e;
    if (u < k) {
      const bool keep = (unsigned)(key[e] >> 32) != kDropHigh;
      const int src = (int)(key[e] & 0xffffu);
      out_i[row * k + u] = keep ? s_id[src] : -1;
      out_d[row * k + u] = keep ? s_d[src] : inf;
    }
  }
}

}  // namespace repro_torch

namespace {

// Launch the warp variant at E = p / 32 keys per lane.
template <bool kMerge>
int launch_warp(const void* ids, const void* ds, const void* fresh,
                void* out_i, void* out_d, void* out_f, int b, int m, int k,
                int p, cudaStream_t stream) {
  using namespace repro_torch;
  const int smem = kTopkWarps * warp_smem_words(p, kMerge) * 4;
  const unsigned grid = (unsigned)((b + kTopkWarps - 1) / kTopkWarps);
  auto go = [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
    }
    if (b > 0)
      kernel<<<grid, kTopkWarps * 32, smem, stream>>>(
          (const int*)ids, (const float*)ds, (const uint8_t*)fresh,
          (int*)out_i, (float*)out_d, (uint8_t*)out_f, b, m, k);
    return (int)cudaGetLastError();
  };
  switch (p) {
    case 32: return go(topk_merge_warp_kernel<1, kMerge>);
    case 64: return go(topk_merge_warp_kernel<2, kMerge>);
    case 128: return go(topk_merge_warp_kernel<4, kMerge>);
    case 256: return go(topk_merge_warp_kernel<8, kMerge>);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int topk_merge_smem_bytes(int p) {
  return (int)(2 * p * sizeof(unsigned long long) + 3 * p * 4);
}

// variant: 0 block, 1 warp.
extern "C" int topk_merge_rows(const void* ids, const void* ds,
                               const void* fresh, void* out_i, void* out_d,
                               void* out_f, int b, int m, int k, int p,
                               int merge, int variant, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (variant != 0) {
    if (p > repro_torch::kWarpMaxSort) return (int)cudaErrorInvalidValue;
    return merge ? launch_warp<true>(ids, ds, fresh, out_i, out_d, out_f, b,
                                     m, k, p, st)
                 : launch_warp<false>(ids, ds, fresh, out_i, out_d, out_f, b,
                                      m, k, p, st);
  }
  const int smem = topk_merge_smem_bytes(p);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        repro_torch::topk_merge_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (b > 0) {
    repro_torch::topk_merge_kernel<<<b, repro_torch::kTopkThreads, smem,
                                     st>>>(
        (const int*)ids, (const float*)ds, (const uint8_t*)fresh, (int*)out_i,
        (float*)out_d, (uint8_t*)out_f, m, k, p, merge != 0);
  }
  return (int)cudaGetLastError();
}
