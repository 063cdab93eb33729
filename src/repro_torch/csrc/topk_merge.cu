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
// 3.35 TB/s, so a launch's fixed cost matters more than bandwidth. What
// sets this version's time is each block's serial chain of
// barrier-separated sort stages (2 x 28 at p = 128); warp-level sorts
// would shorten it.
//
// Design: one block of 128 threads per row, everything in shared memory.
// M is padded to a power of two p >= 32 (96 -> 128). Each sort is one
// bitonic network over unique 64-bit keys whose low bits hold a rank or a
// position, which makes it equal to the reference's stable argsorts.
//   pool:  sort A by (dist, position); sort B by (id, rank in A); an entry
//          is a duplicate if its id equals its predecessor's in B; warp 0
//          then compacts the survivors in A order with ballots.
//   merge: sort A by (id, fresh, position); duplicates are adjacent in A;
//          sort B by (dist with duplicates at +inf, rank in A).
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

}  // namespace repro_torch

extern "C" int topk_merge_smem_bytes(int p) {
  return (int)(2 * p * sizeof(unsigned long long) + 3 * p * 4);
}

extern "C" int topk_merge_rows(const void* ids, const void* ds,
                               const void* fresh, void* out_i, void* out_d,
                               void* out_f, int b, int m, int k, int p,
                               int merge, void* stream) {
  const int smem = topk_merge_smem_bytes(p);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        repro_torch::topk_merge_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (b > 0) {
    repro_torch::topk_merge_kernel<<<b, repro_torch::kTopkThreads, smem,
                                     (cudaStream_t)stream>>>(
        (const int*)ids, (const float*)ds, (const uint8_t*)fresh, (int*)out_i,
        (float*)out_d, (uint8_t*)out_f, m, k, p, merge != 0);
  }
  return (int)cudaGetLastError();
}
