// beam_hop: beam-search hops in f32 mode (rows of the f32 base) or LUT mode
// (uint8 code rows scored with a per-query lookup table, for the pq and int8
// backends), as two entries over one hop body:
//
//   * beam_hop_f32 / beam_hop_lut: one hop for every query, with the
//     frontier already selected by the caller (sel) and any pool;
//   * beam_hops_f32 / beam_hops_lut: the whole guarded hop loop of the
//     batched search, up to max_steps hops per query in one launch: the
//     live test, the frontier select, the hop and the counters, each lane
//     until it stops being live.
//
// Replaces the TPU kernel src/repro/kernels/beam_hop/beam_hop.py,
// beam_hop_pallas (body _beam_hop_kernel, comparator _stable_gt), in both
// modes; the loop entry also carries the reference's loop around it
// (src/repro/core/beam_search.py, _run_hops with max_steps: a
// lax.while_loop on the device). Per query and hop: read the graph row of
// sel (sel < 0: the lane is inactive and every candidate is invalid), drop
// candidates whose id is already in the pool (no dedup among the candidates
// themselves), score the others against the query, merge them into the ef
// pool in the order of a stable argsort by distance, and keep the first ef
// entries; count [valid candidates, duplicate candidates].
//
// Bound on an H100: the bytes of the gathered rows. f32 mode: at Q=1024,
// R=32, D=600 one hop reads at most 1024*32*600*4 B = 78.6 MB of rows,
// about 23 us at 3.35 TB/s. LUT mode: Q*R*M code bytes plus at most 4 B of
// LUT per lookup, ~49 MB (~15 us) at M=300; each lookup touches a 32 B
// sector, so the traffic the card moves is several times that. The pool
// state (Q*ef*9 B in and out) and the graph rows (Q*R*4 B) add under 2 MB.
//
// Design: one block of 4 warps per query, its pool in shared memory.
//   A. the graph row of sel (one coalesced read), each candidate checked
//      against the pool; valid new ones go on a list, so no row is loaded
//      for an invalid or duplicate candidate;
//   B. f32: each warp scores the list kHopGroup rows at a time with
//      rows_sqdist_vec4 (the reduction gather_dist.cu shares: 20 float4
//      per lane in flight at D=600), the query staged once in shared
//      memory; LUT: one thread per listed candidate, lut_row_sum (the
//      serial left-to-right sum lut_dist.cu shares). Either way the hop
//      equals the staged hop bit for bit;
//   C. the merge: the ef + R entries get the unique key
//      (float_key(dist) << 32) | position, position ordering [pool,
//      candidates]; each entry's rank is the number of keys below its own
//      (a counting sort: one pass, one barrier), which is exactly the stable
//      argsort of the reference's merge_one, for any pool.
// The loop entry keeps the pool in two shared buffers (the pool going into
// a hop and the merged one), the counters in warp 0's registers, and runs
// the frontier select (first minimum of the unvisited valid distances) in
// warp 0. The (Q, R) candidate block never touches device memory, and the
// loop never returns to the host.
#include "common.cuh"

namespace repro_torch {

constexpr int kHopThreads = 128;
constexpr int kHopWarps = kHopThreads / 32;
constexpr int kHopGroup = 4;      // rows whose loads are in flight together
constexpr int kCtl = 8;           // control words in shared memory

// Control words: counts of the hop being run, and the loop's decisions.
enum { kValid = 0, kDup = 1, kListed = 2, kGo = 3, kSel = 4, kLive = 5 };

// One lane's shared memory: the staged query (f32 mode, float4 rows), the
// sort keys, two pool buffers, the candidates and the control words.
// The pool buffers are found by arithmetic, not by an array of pointers
// indexed at run time (which would put the struct in local memory).
struct HopShared {
  float* query;
  unsigned long long* keys;      // ef + r
  int* pools;                    // 2 x (ids, dists, visited), ef each
  int ef;
  int* cand_i;                   // r
  float* cand_d;                 // r
  int* list;                     // r
  int* ctl;                      // kCtl
  __device__ int* pool_i(int b) const { return pools + 3 * ef * b; }
  __device__ float* pool_d(int b) const {
    return reinterpret_cast<float*>(pools + 3 * ef * b + ef);
  }
  __device__ int* pool_v(int b) const { return pools + 3 * ef * b + 2 * ef; }
};

__host__ __device__ inline int staged_query_floats(int d, int kk) {
  return kk > 0 ? (d + 3) / 4 * 4 : 0;
}

__device__ inline HopShared carve(unsigned char* smem, int ef, int r,
                                  int q_floats) {
  HopShared sh;
  sh.query = reinterpret_cast<float*>(smem);
  sh.keys = reinterpret_cast<unsigned long long*>(sh.query + q_floats);
  sh.pools = reinterpret_cast<int*>(sh.keys + ef + r);
  sh.ef = ef;
  int* w = sh.pools + 6 * ef;
  sh.cand_i = w;
  sh.cand_d = reinterpret_cast<float*>(w + r);
  sh.list = w + 2 * r;
  sh.ctl = w + 3 * r;
  return sh;
}

__device__ __forceinline__ unsigned long long sort_key(float dist, int pos) {
  return ((unsigned long long)float_key(dist) << 32) | (unsigned)pos;
}

// One hop of one lane, by the whole block: pool buffer `cur` in, the merged
// pool into buffer cur ^ 1; n_valid / n_dup get the hop's counts. The pool
// must be in shared memory and visible to every thread before the call;
// the call ends with a barrier. ctl[kValid..kListed] are 0 on entry and on
// return.
template <bool kLut, int kK>
__device__ __forceinline__ void hop_body(
    const HopShared& sh, int cur, int sel, const int* __restrict__ nbrs,
    const float* __restrict__ q_or_lut, const void* __restrict__ table,
    int n, int r, int d, int c, int ef, bool vec4, int& n_valid,
    int& n_dup) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float inf = __int_as_float(0x7f800000);
  const int* pi = sh.pool_i(cur);
  const float* pd = sh.pool_d(cur);
  const int* pv = sh.pool_v(cur);

  // A. candidates: valid ones counted, pool duplicates dropped, the rest
  // listed for scoring (the list's order does not change any result)
  const int* row = nbrs + (long long)min(max(sel, 0), n - 1) * r;
  for (int j = tid; j < r; j += blockDim.x) {
    const int id = sel >= 0 ? row[j] : -1;
    int keep = -1;
    if (id >= 0) {
      bool dup = false;
      for (int e = 0; e < ef; ++e) dup |= pi[e] == id;
      atomicAdd(&sh.ctl[kValid], 1);
      if (dup) {
        atomicAdd(&sh.ctl[kDup], 1);
      } else {
        keep = id;
        sh.list[atomicAdd(&sh.ctl[kListed], 1)] = j;
      }
    }
    sh.cand_i[j] = keep;
    sh.cand_d[j] = inf;
    sh.keys[ef + j] = sort_key(inf, ef + j);
  }
  for (int e = tid; e < ef; e += blockDim.x) sh.keys[e] = sort_key(pd[e], e);
  __syncthreads();
  n_valid = sh.ctl[kValid];
  n_dup = sh.ctl[kDup];
  const int listed = sh.ctl[kListed];

  // B. distances of the listed candidates
  if constexpr (kLut) {
    const uint8_t* codes = static_cast<const uint8_t*>(table);
    for (int t = tid; t < listed; t += blockDim.x) {
      const int j = sh.list[t];
      const float dist = lut_row_sum(
          codes + (long long)min(sh.cand_i[j], n - 1) * d, q_or_lut, d, c,
          vec4);
      sh.cand_d[j] = dist;
      sh.keys[ef + j] = sort_key(dist, ef + j);
    }
  } else if constexpr (kK == 0) {
    const float* db = static_cast<const float*>(table);
    for (int t = warp; t < listed; t += kHopWarps) {
      const int j = sh.list[t];
      const float dist = row_sqdist(
          q_or_lut, db + (long long)min(sh.cand_i[j], n - 1) * d, d, vec4);
      if (lane == 0) {
        sh.cand_d[j] = dist;
        sh.keys[ef + j] = sort_key(dist, ef + j);
      }
    }
  } else {
    const float* db = static_cast<const float*>(table);
    const float4* q4 = reinterpret_cast<const float4*>(sh.query);
    const int n_chunks = d >> 2;
    for (int t0 = warp * kHopGroup; t0 < listed;
         t0 += kHopWarps * kHopGroup) {
      const int cnt = min(kHopGroup, listed - t0);
      const float* rows[kHopGroup];
      int js[kHopGroup];
#pragma unroll
      for (int g = 0; g < kHopGroup; ++g) {
        js[g] = g < cnt ? sh.list[t0 + g] : 0;
        rows[g] = g < cnt ? db + (long long)min(sh.cand_i[js[g]], n - 1) * d
                          : db;
      }
      float dist[kHopGroup];
      rows_sqdist_vec4<kK, kHopGroup>(
          [&](int k) { return q4[lane + 32 * k]; }, rows, cnt, n_chunks,
          dist);
      if (lane == 0) {
#pragma unroll
        for (int g = 0; g < kHopGroup; ++g) {
          if (g < cnt) {
            sh.cand_d[js[g]] = dist[g];
            sh.keys[ef + js[g]] = sort_key(dist[g], ef + js[g]);
          }
        }
      }
    }
  }
  __syncthreads();
  if (tid == 0) sh.ctl[kValid] = sh.ctl[kDup] = sh.ctl[kListed] = 0;

  // C. the merge: rank = number of smaller keys; the first ef ranks stay
  const int p = ef + r;
  int* oi = sh.pool_i(cur ^ 1);
  float* od = sh.pool_d(cur ^ 1);
  int* ov = sh.pool_v(cur ^ 1);
  for (int e = tid; e < p; e += blockDim.x) {
    const unsigned long long key = sh.keys[e];
    int rank = 0;
    for (int f = 0; f < p; ++f) rank += sh.keys[f] < key;
    if (rank < ef) {
      if (e < ef) {
        oi[rank] = pi[e];
        od[rank] = pd[e];
        ov[rank] = pv[e];
      } else {
        oi[rank] = sh.cand_i[e - ef];
        od[rank] = sh.cand_d[e - ef];
        ov[rank] = 0;
      }
    }
  }
  __syncthreads();
}

// The block's common start: carve shared memory, load pool buffer 0 and
// (f32, kK > 0) stage the query; zero the control words. Ends with a
// barrier.
template <bool kLut, int kK>
__device__ __forceinline__ HopShared hop_start(
    const int* __restrict__ pool_i, const float* __restrict__ pool_d,
    const uint8_t* __restrict__ pool_v, const float* __restrict__ q_or_lut,
    int d, int ef, int r) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int qf = kLut ? 0 : staged_query_floats(d, kK);
  const HopShared sh = carve(smem, ef, r, qf);
  const long long off = (long long)blockIdx.x * ef;
  for (int e = threadIdx.x; e < ef; e += blockDim.x) {
    sh.pool_i(0)[e] = pool_i[off + e];
    sh.pool_d(0)[e] = pool_d[off + e];
    sh.pool_v(0)[e] = pool_v[off + e];
  }
  if (!kLut && kK > 0) {
    const float* q = q_or_lut + (long long)blockIdx.x * d;
    for (int e = threadIdx.x; e < d; e += blockDim.x) sh.query[e] = q[e];
  }
  if (threadIdx.x < kCtl) sh.ctl[threadIdx.x] = 0;
  __syncthreads();
  return sh;
}

// This lane's operand: its query row (f32) or its (M, C) LUT.
template <bool kLut>
__device__ __forceinline__ const float* lane_operand(const float* q_or_lut,
                                                     int d, int c) {
  return q_or_lut + (long long)blockIdx.x * d * (kLut ? c : 1);
}

// kLut = false: q_or_lut is the (Q, d) queries and table the (N, d) f32
// base. kLut = true: q_or_lut is the (Q, d, c) LUT and table the (N, d)
// uint8 codes (d = M sub-spaces). kK: lane_chunks(d) for float4 rows of at
// most 1024 floats, else 0 (row_sqdist, one row at a time).
template <bool kLut, int kK>
__global__ void __launch_bounds__(kHopThreads)
beam_hop_kernel(const int* __restrict__ sel, const int* __restrict__ nbrs,
                const int* __restrict__ pool_i,
                const float* __restrict__ pool_d,
                const uint8_t* __restrict__ pool_v,
                const float* __restrict__ q_or_lut,
                const void* __restrict__ table, int* __restrict__ out_i,
                float* __restrict__ out_d, uint8_t* __restrict__ out_v,
                int* __restrict__ stats, int n, int r, int d, int c, int ef,
                bool vec4) {
  const HopShared sh =
      hop_start<kLut, kK>(pool_i, pool_d, pool_v, q_or_lut, d, ef, r);
  const int qi = blockIdx.x;
  int n_valid, n_dup;
  hop_body<kLut, kK>(sh, 0, sel[qi], nbrs, lane_operand<kLut>(q_or_lut, d, c),
                     table, n, r, d, c, ef, vec4, n_valid, n_dup);
  const long long off = (long long)qi * ef;
  for (int e = threadIdx.x; e < ef; e += blockDim.x) {
    out_i[off + e] = sh.pool_i(1)[e];
    out_d[off + e] = sh.pool_d(1)[e];
    out_v[off + e] = (uint8_t)sh.pool_v(1)[e];
  }
  if (threadIdx.x == 0) {
    stats[2 * qi] = n_valid;
    stats[2 * qi + 1] = n_dup;
  }
}

// The loop: per lane, while it is live and fewer than max_steps hops have
// run in this launch — live: an unvisited valid pool entry exists, hops <
// max_iters and, when patience >= 0, stale < patience — select the
// frontier (the first minimum of where(unvisited & valid, dist, +inf); that
// slot is marked visited even when it is not an unvisited valid entry, and
// then sel = -1), run the hop, and update hops (+1 when sel >= 0), gathered,
// dup_gathered and, when patience >= 0, stale (0 when some of the first
// min(k, ef) distances fell by more than eps, else + 1). Writes the state
// back with iters (the hops this launch ran for the lane) and live (the
// live test at exit).
template <bool kLut, int kK>
__global__ void __launch_bounds__(kHopThreads)
beam_hops_kernel(const int* __restrict__ nbrs, const int* __restrict__ pool_i,
                 const float* __restrict__ pool_d,
                 const uint8_t* __restrict__ pool_v,
                 const int* __restrict__ hops_in,
                 const int* __restrict__ gath_in,
                 const int* __restrict__ dup_in,
                 const int* __restrict__ stale_in,
                 const float* __restrict__ q_or_lut,
                 const void* __restrict__ table, int* __restrict__ out_i,
                 float* __restrict__ out_d, uint8_t* __restrict__ out_v,
                 int* __restrict__ hops_out, int* __restrict__ gath_out,
                 int* __restrict__ dup_out, int* __restrict__ stale_out,
                 int* __restrict__ iters_out, uint8_t* __restrict__ live_out,
                 int n, int r, int d, int c, int ef, int k, int max_iters,
                 int max_steps, int patience, float eps, bool vec4) {
  const HopShared sh =
      hop_start<kLut, kK>(pool_i, pool_d, pool_v, q_or_lut, d, ef, r);
  const int qi = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const bool lead = threadIdx.x < 32;          // warp 0 runs the control
  const float inf = __int_as_float(0x7f800000);
  const float* operand = lane_operand<kLut>(q_or_lut, d, c);
  const int kk = min(k, ef);
  // warp 0's copies of the counters (the same in each of its lanes)
  int hops = hops_in[qi], gath = gath_in[qi], dup = dup_in[qi];
  int stale = stale_in[qi], iters = 0;
  int cur = 0;
  for (;;) {
    if (lead) {
      const int* pi = sh.pool_i(cur);
      const float* pd = sh.pool_d(cur);
      int* pv = sh.pool_v(cur);
      unsigned long long best = ~0ull;
      bool open = false;
      for (int e = lane; e < ef; e += 32) {
        const bool uv = !pv[e] && pi[e] >= 0;
        open |= uv;
        const unsigned long long key = sort_key(uv ? pd[e] : inf, e);
        best = key < best ? key : best;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(kFullMask, best, off);
        best = o < best ? o : best;
      }
      open = __any_sync(kFullMask, open);
      const bool live = open && hops < max_iters &&
                        (patience < 0 || stale < patience);
      const bool go = live && iters < max_steps;
      if (lane == 0) {
        sh.ctl[kLive] = live;
        sh.ctl[kGo] = go;
        if (go) {
          const int slot = (int)(best & 0xffffffffu);
          const bool active = !pv[slot] && pi[slot] >= 0;
          pv[slot] = 1;
          sh.ctl[kSel] = active ? pi[slot] : -1;
        }
      }
    }
    __syncthreads();
    if (!sh.ctl[kGo]) break;
    const int sel = sh.ctl[kSel];
    int n_valid, n_dup;
    hop_body<kLut, kK>(sh, cur, sel, nbrs, operand, table, n, r, d, c, ef,
                       vec4, n_valid, n_dup);
    if (lead) {
      hops += sel >= 0;
      gath += n_valid;
      dup += n_dup;
      ++iters;
      if (patience >= 0) {
        bool progress = false;
        for (int j = lane; j < kk; j += 32)
          progress |= __fsub_rn(sh.pool_d(cur)[j], sh.pool_d(cur ^ 1)[j]) >
                      eps;
        stale = __any_sync(kFullMask, progress) ? 0 : stale + 1;
      }
    }
    cur ^= 1;
  }
  const long long off = (long long)qi * ef;
  for (int e = threadIdx.x; e < ef; e += blockDim.x) {
    out_i[off + e] = sh.pool_i(cur)[e];
    out_d[off + e] = sh.pool_d(cur)[e];
    out_v[off + e] = (uint8_t)sh.pool_v(cur)[e];
  }
  if (threadIdx.x == 0) {
    hops_out[qi] = hops;
    gath_out[qi] = gath;
    dup_out[qi] = dup;
    stale_out[qi] = stale;
    iters_out[qi] = iters;
    live_out[qi] = (uint8_t)sh.ctl[kLive];
  }
}

int hop_smem_bytes(int ef, int r, int q_floats) {
  return q_floats * 4 + (ef + r) * 8 + (6 * ef + 3 * r + kCtl) * 4;
}

template <class Kernel>
int prepare(Kernel kernel, int smem) {
  if (smem > 48 * 1024) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  return 0;
}

// The f32 entries' lane-chunk choice (0: row_sqdist, one row at a time).
inline int f32_lane_chunks(int d, int vec4) {
  return vec4 ? lane_chunks(d) : 0;
}

}  // namespace repro_torch

namespace {

using namespace repro_torch;

template <bool kLut>
int launch_hop(const void* sel, const void* nbrs, const void* pool_i,
               const void* pool_d, const void* pool_v, const void* q_or_lut,
               const void* table, void* out_i, void* out_d, void* out_v,
               void* stats, int nq, int n, int r, int d, int c, int ef,
               int vec4, void* stream) {
  const int kk = kLut ? 0 : f32_lane_chunks(d, vec4);
  return by_lane_chunks(kk, [&](auto kc) {
    constexpr int kK = kLut ? 0 : decltype(kc)::value;
    const int smem = hop_smem_bytes(ef, r, staged_query_floats(d, kK));
    const int err = prepare(beam_hop_kernel<kLut, kK>, smem);
    if (err) return err;
    if (nq > 0) {
      beam_hop_kernel<kLut, kK>
          <<<nq, kHopThreads, smem, (cudaStream_t)stream>>>(
              (const int*)sel, (const int*)nbrs, (const int*)pool_i,
              (const float*)pool_d, (const uint8_t*)pool_v,
              (const float*)q_or_lut, table, (int*)out_i, (float*)out_d,
              (uint8_t*)out_v, (int*)stats, n, r, d, c, ef, vec4 != 0);
    }
    return (int)cudaGetLastError();
  });
}

template <bool kLut>
int launch_hops(void* const* in, void* const* out, const void* q_or_lut,
                const void* table, int nq, int n, int r, int d, int c, int ef,
                int k, int max_iters, int max_steps, int patience, float eps,
                int vec4, void* stream) {
  const int kk = kLut ? 0 : f32_lane_chunks(d, vec4);
  return by_lane_chunks(kk, [&](auto kc) {
    constexpr int kK = kLut ? 0 : decltype(kc)::value;
    const int smem = hop_smem_bytes(ef, r, staged_query_floats(d, kK));
    const int err = prepare(beam_hops_kernel<kLut, kK>, smem);
    if (err) return err;
    if (nq > 0) {
      beam_hops_kernel<kLut, kK>
          <<<nq, kHopThreads, smem, (cudaStream_t)stream>>>(
              (const int*)in[0], (const int*)in[1], (const float*)in[2],
              (const uint8_t*)in[3], (const int*)in[4], (const int*)in[5],
              (const int*)in[6], (const int*)in[7], (const float*)q_or_lut,
              table, (int*)out[0], (float*)out[1], (uint8_t*)out[2],
              (int*)out[3], (int*)out[4], (int*)out[5], (int*)out[6],
              (int*)out[7], (uint8_t*)out[8], n, r, d, c, ef, k, max_iters,
              max_steps, patience, eps, vec4 != 0);
    }
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" int beam_hop_f32(const void* sel, const void* nbrs, const void* pool_i,
                            const void* pool_d, const void* pool_v,
                            const void* q, const void* db, void* out_i,
                            void* out_d, void* out_v, void* stats, int nq,
                            int n, int r, int d, int ef, int vec4,
                            void* stream) {
  return launch_hop<false>(sel, nbrs, pool_i, pool_d, pool_v, q, db, out_i,
                           out_d, out_v, stats, nq, n, r, d, 0, ef, vec4,
                           stream);
}

extern "C" int beam_hop_lut(const void* sel, const void* nbrs, const void* pool_i,
                            const void* pool_d, const void* pool_v,
                            const void* lut, const void* codes, void* out_i,
                            void* out_d, void* out_v, void* stats, int nq,
                            int n, int r, int m, int c, int ef, int vec4,
                            void* stream) {
  return launch_hop<true>(sel, nbrs, pool_i, pool_d, pool_v, lut, codes, out_i,
                          out_d, out_v, stats, nq, n, r, m, c, ef, vec4,
                          stream);
}

// in: neighbors, pool_i, pool_d, pool_v, hops, gathered, dup_gathered,
// stale; out: pool_i, pool_d, pool_v, hops, gathered, dup_gathered, stale,
// iters, live (each out array distinct from every in array).
extern "C" int beam_hops_f32(void* const* in, void* const* out, const void* q,
                             const void* db, int nq, int n, int r, int d,
                             int ef, int k, int max_iters, int max_steps,
                             int patience, float eps, int vec4,
                             void* stream) {
  return launch_hops<false>(in, out, q, db, nq, n, r, d, 0, ef, k, max_iters,
                            max_steps, patience, eps, vec4, stream);
}

extern "C" int beam_hops_lut(void* const* in, void* const* out,
                             const void* lut, const void* codes, int nq,
                             int n, int r, int m, int c, int ef, int k,
                             int max_iters, int max_steps, int patience,
                             float eps, int vec4, void* stream) {
  return launch_hops<true>(in, out, lut, codes, nq, n, r, m, c, ef, k,
                           max_iters, max_steps, patience, eps, vec4, stream);
}
