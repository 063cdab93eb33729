// beam_hop (f32): one beam-search hop for every query in one launch.
//
// Replaces the TPU kernel src/repro/kernels/beam_hop/beam_hop.py,
// beam_hop_pallas (body _beam_hop_kernel, comparator _stable_gt), in its
// f32 mode. Per query q: read the graph row of sel[q] (sel < 0: the lane is
// inactive and every candidate is invalid), score the R candidate rows
// against the query, drop candidates whose id is already in the pool (no
// dedup among the candidates themselves), merge them into the ef pool in
// the order of a stable argsort by distance, and write the first ef
// entries plus [valid candidates, duplicate candidates].
//
// Bound on an H100: the bytes of the gathered rows, as for gather_dist. At
// Q=1024, R=32, D=600 a hop reads 1024*32*600*4 B = 78.6 MB of rows, about
// 23 us at 3.35 TB/s; the pool state (Q*ef*9 B in and out) and the graph
// rows (Q*R*4 B) add under 2 MB.
//
// Design: one block of 4 warps per query. Warp w scores candidates w, w+4,
// ... with row_sqdist, the reduction gather_dist.cu shares, so this hop
// equals the staged hop bit for bit. The merge never leaves shared memory:
// the ef + R entries (padded to a power of two p) get the key
// (float_key(dist) << 32) | position, where position orders
// [pool, candidates, padding]; one bitonic sort of these unique keys is
// exactly the stable argsort of the reference's merge_one. The (Q, R)
// candidate block never touches device memory.
#include "common.cuh"

namespace repro_torch {

constexpr int kHopThreads = 128;

__global__ void __launch_bounds__(kHopThreads)
beam_hop_kernel(const int* __restrict__ sel, const int* __restrict__ nbrs,
                const int* __restrict__ pool_i, const float* __restrict__ pool_d,
                const uint8_t* __restrict__ pool_v, const float* __restrict__ q,
                const float* __restrict__ db, int* __restrict__ out_i,
                float* __restrict__ out_d, uint8_t* __restrict__ out_v,
                int* __restrict__ stats, int n, int r, int d, int ef, int p,
                bool vec4) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* keys = smem;                      // p
  int* s_pool_i = reinterpret_cast<int*>(keys + p);     // ef
  float* s_pool_d = reinterpret_cast<float*>(s_pool_i + ef);
  int* s_pool_v = reinterpret_cast<int*>(s_pool_d + ef);
  int* s_cand_i = s_pool_v + ef;                        // r
  float* s_cand_d = reinterpret_cast<float*>(s_cand_i + r);
  int* s_count = reinterpret_cast<int*>(s_cand_d + r);  // 2

  const int qi = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float inf = __int_as_float(0x7f800000);
  const long long pool_off = (long long)qi * ef;

  const int s = sel[qi];
  const bool active = s >= 0;
  const int* row = nbrs + (long long)min(max(s, 0), n - 1) * r;
  for (int e = tid; e < ef; e += blockDim.x) {
    s_pool_i[e] = pool_i[pool_off + e];
    s_pool_d[e] = pool_d[pool_off + e];
    s_pool_v[e] = pool_v[pool_off + e];
  }
  for (int j = tid; j < r; j += blockDim.x) {
    const int id = row[j];
    s_cand_i[j] = (active && id >= 0) ? id : -1;
  }
  if (tid < 2) s_count[tid] = 0;
  __syncthreads();

  // distances: one warp per candidate
  const float* qrow = q + (long long)qi * d;
  for (int j = warp; j < r; j += blockDim.x >> 5) {
    const int id = s_cand_i[j];
    float dist = inf;
    if (id >= 0)
      dist = row_sqdist(qrow, db + (long long)min(id, n - 1) * d, d, vec4);
    if (lane == 0) s_cand_d[j] = dist;
  }
  __syncthreads();

  // drop candidates already in the pool; count valid and duplicate ones
  for (int j = tid; j < r; j += blockDim.x) {
    const int id = s_cand_i[j];
    if (id >= 0) {
      bool dup = false;
      for (int e = 0; e < ef; ++e) dup |= s_pool_i[e] == id;
      atomicAdd(&s_count[0], 1);
      if (dup) {
        atomicAdd(&s_count[1], 1);
        s_cand_i[j] = -1;
        s_cand_d[j] = inf;
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < p; e += blockDim.x) {
    const float dist = e < ef ? s_pool_d[e] : (e < ef + r ? s_cand_d[e - ef] : inf);
    keys[e] = ((unsigned long long)float_key(dist) << 32) | (unsigned)e;
  }
  block_sort(keys, p);

  for (int e = tid; e < ef; e += blockDim.x) {
    const int src = (int)(keys[e] & 0xffffffffu);
    int id = -1;
    float dist = inf;
    uint8_t vis = 0;
    if (src < ef) {
      id = s_pool_i[src];
      dist = s_pool_d[src];
      vis = (uint8_t)s_pool_v[src];
    } else if (src < ef + r) {
      id = s_cand_i[src - ef];
      dist = s_cand_d[src - ef];
    }
    out_i[pool_off + e] = id;
    out_d[pool_off + e] = dist;
    out_v[pool_off + e] = vis;
  }
  if (tid < 2) stats[2 * qi + tid] = s_count[tid];
}

}  // namespace repro_torch

extern "C" int beam_hop_smem_bytes(int ef, int r, int p) {
  return (int)(p * sizeof(unsigned long long) + (3 * ef + 2 * r + 2) * 4);
}

extern "C" int beam_hop_f32(const void* sel, const void* nbrs, const void* pool_i,
                            const void* pool_d, const void* pool_v,
                            const void* q, const void* db, void* out_i,
                            void* out_d, void* out_v, void* stats, int nq,
                            int n, int r, int d, int ef, int p, int vec4,
                            void* stream) {
  const int smem = beam_hop_smem_bytes(ef, r, p);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        repro_torch::beam_hop_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (nq > 0) {
    repro_torch::beam_hop_kernel<<<nq, repro_torch::kHopThreads, smem,
                                   (cudaStream_t)stream>>>(
        (const int*)sel, (const int*)nbrs, (const int*)pool_i,
        (const float*)pool_d, (const uint8_t*)pool_v, (const float*)q,
        (const float*)db, (int*)out_i, (float*)out_d, (uint8_t*)out_v,
        (int*)stats, n, r, d, ef, p, vec4 != 0);
  }
  return (int)cudaGetLastError();
}
