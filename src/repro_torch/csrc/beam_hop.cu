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
// The f32 loop (beam_hops_f32) has the sharded tier's two modes, either or
// both (the reference's ANN_BF16_BASE and ANN_PRENORM,
// src/repro/core/distributed.py _local_beam): bf16 rows, widened to f32 on
// load (exact), and the prenorm distance max((|q|^2 + norms[id]) - 2 q.x,
// 0) over (N,) norms kept at build time, |q|^2 summed once per query. Both
// go through common.cuh's reductions (row_chunk, kDot), as gather_dist's
// modes do, so a pool seeded by gather_dist in a mode carries the bits the
// loop reproduces. The one-hop entries, the LUT loop and its persistent
// variant have no such modes (nor has the reference's LUT path).
//
// Bound on an H100: the bytes of the gathered rows. f32 mode: at Q=1024,
// R=32, D=600 one hop reads at most 1024*32*600*4 B = 78.6 MB of rows,
// about 23 us at 3.35 TB/s; bf16 rows half of that, prenorm 4 B more per
// row. LUT mode: Q*R*M code bytes plus at most 4 B of
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
//
// The LUT loop has two variants (kernels/beam_hop/beam_hop.py:route picks
// one by shape). per_query: the design above, one block per query, one
// thread per listed candidate running lut_row_sum against the LUT in device
// memory. With every query resident at once, the live LUTs (1024 x 300 KB
// at M = 300) are six times the 50 MB L2, so each lookup's 32 B sector comes
// from HBM, and 3 of 4 warps idle while a block scores.
// persistent: `grid` blocks of 16 warps, one per SM, each walking its
// queries blockIdx.x + grid*t one after another, so at most `grid` LUTs are
// live. The first `resident` sub-tables of the lane's LUT (all the shared
// memory the block has left) are copied in once per query; the other
// entries are read with an L2 evict_last policy (code rows evict_first, so
// they do not push LUT lines out). Per hop:
//   B1. the listed candidates' code rows, one coalesced async copy;
//   B2. all 512 threads gather the L2 part's lookups into a staging buffer,
//       m-major (one warp instruction reads one or two sub-tables), as
//       asynchronous copies;
//   B3. meanwhile one thread per candidate sums the shared-memory part,
//       m = 0 .. resident - 1, then (B5) the staged part in m order, each
//       chain with its loads a batch ahead of its adds;
//   C.  the merge's ranks counted by 4 threads each.
// With one query per SM, nothing hides a hop's latency but the other warps
// of its block: 16 warps issue the gathers and copies that 4 warps left
// stalled on their own dependences. A grid cut so that the live LUTs fit
// the L2, and the L2-only design (nothing resident), were slower (PERF.md
// section 6).
// The sum is lut_row_sum's: __fadd_rn from -0.0 over m = 0 .. M - 1 with
// codes clamped to C - 1, so both variants, the one-hop entry, lut_dist
// and the plain versions agree bit for bit.
#include "common.cuh"

namespace repro_torch {

constexpr int kHopThreads = 128;
constexpr int kHopWarps = kHopThreads / 32;
constexpr int kPersistentThreads = 512;   // the persistent LUT loop's block
constexpr int kRankParts = 4;     // persistent merge: threads per entry's rank
constexpr int kChainBatch = 16;   // sum chains: loads issued a batch ahead
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
  // the persistent LUT loop only (carve_persistent):
  uint32_t* codes;               // r code rows of code_words words
  float* stage;                  // (M - resident) x r looked-up entries
  float* lut;                    // resident x C: the LUT's first sub-tables
  int code_words, resident;
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

int hop_smem_bytes(int ef, int r, int q_floats) {
  return q_floats * 4 + (ef + r) * 8 + (6 * ef + 3 * r + kCtl) * 4;
}

__host__ __device__ inline int align16(int b) { return (b + 15) & ~15; }

// Words of one staged code row: odd, so that the rows of 32 candidates read
// at one code position fall in 32 different banks.
__host__ __device__ inline int persistent_code_words(int m) {
  return ((m + 3) / 4) | 1;
}

// Byte offsets of the persistent loop's shared regions, after the hop's own
// (hop_smem_bytes without a staged query): the code rows, the staging
// buffer, the LUT's resident sub-tables, and the end (the block's dynamic
// shared memory). kernels/beam_hop/beam_hop.py:persistent_smem_bytes
// mirrors it.
struct PersistentLayout {
  int codes, stage, lut, end;
  __host__ __device__ PersistentLayout(int ef, int r, int m, int c,
                                       int resident) {
    codes = align16((ef + r) * 8 + (6 * ef + 3 * r + kCtl) * 4);
    stage = align16(codes + r * persistent_code_words(m) * 4);
    lut = align16(stage + (m - resident) * r * 4);
    end = lut + resident * c * 4;
  }
};

__device__ inline HopShared carve_persistent(unsigned char* smem, int ef,
                                             int r, int m, int c,
                                             int resident) {
  HopShared sh = carve(smem, ef, r, 0);
  const PersistentLayout lay(ef, r, m, c, resident);
  sh.codes = reinterpret_cast<uint32_t*>(smem + lay.codes);
  sh.stage = reinterpret_cast<float*>(smem + lay.stage);
  sh.lut = reinterpret_cast<float*>(smem + lay.lut);
  sh.code_words = persistent_code_words(m);
  sh.resident = resident;
  return sh;
}

// Asynchronous global -> shared copies (cp.async) with an L2 eviction
// policy; cp_async_wait_all waits for the calling thread's copies only, so
// a barrier must follow before other threads read them.
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, %1;"
               : "=l"(p) : "f"(1.0f));
  return p;
}

__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, %1;"
               : "=l"(p) : "f"(1.0f));
  return p;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;" ::"r"(
          (unsigned)__cvta_generic_to_shared(dst)),
      "l"(src), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;" ::"r"(
          (unsigned)__cvta_generic_to_shared(dst)),
      "l"(src), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// (row, col) of the flat items tid, tid + blockDim.x, ... over rows of
// `cols` columns, stepped without a division per item (cols >= 1).
struct Walk {
  int row, col, cols, step_row, step_col;
  __device__ Walk(int start, int cols_) : cols(cols_) {
    row = start / cols;
    col = start - row * cols;
    step_row = blockDim.x / cols;
    step_col = blockDim.x - step_row * cols;
  }
  __device__ void next() {
    row += step_row;
    col += step_col;
    if (col >= cols) {
      col -= cols;
      ++row;
    }
  }
};

// acc + the LUT entries of code-word groups [0, groups) of one staged code
// row (4 sub-tables a word, lut: the resident sub-tables), added in m
// order. Full batches of kChainBatch entries are loaded without guards, the
// next batch before the current one is added, so the chain waits on its
// adds and not on shared-memory latency; the last groups go one by one.
__device__ __forceinline__ float add_resident(float acc,
                                              const uint32_t* __restrict__ row,
                                              const float* __restrict__ lut,
                                              int c, int top, int groups) {
  constexpr int kG = kChainBatch / 4;
  float cur[kChainBatch], nxt[kChainBatch];
  const auto load = [&](float (&x)[kChainBatch], int g0) {
#pragma unroll
    for (int b = 0; b < kG; ++b) {
      const uint32_t word = row[g0 + b];
      const float* t = lut + 4 * (g0 + b) * c;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[4 * b + i] = t[i * c + min((int)((word >> (8 * i)) & 0xffu), top)];
    }
  };
  int g0 = 0;
  if (groups >= kG) {
    load(cur, 0);
    for (; g0 + 2 * kG <= groups; g0 += kG) {
      load(nxt, g0 + kG);
#pragma unroll
      for (int i = 0; i < kChainBatch; ++i) acc = __fadd_rn(acc, cur[i]);
#pragma unroll
      for (int i = 0; i < kChainBatch; ++i) cur[i] = nxt[i];
    }
#pragma unroll
    for (int i = 0; i < kChainBatch; ++i) acc = __fadd_rn(acc, cur[i]);
    g0 += kG;
  }
  for (; g0 < groups; ++g0) {
    const uint32_t word = row[g0];
    const float* t = lut + 4 * g0 * c;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc = __fadd_rn(
          acc, t[i * c + min((int)((word >> (8 * i)) & 0xffu), top)]);
  }
  return acc;
}

// acc + st[0], st[stride], ..., st[(n - 1) * stride], in order, full
// batches a batch ahead of the adds as in add_resident.
__device__ __forceinline__ float add_staged(float acc,
                                            const float* __restrict__ st,
                                            int stride, int n) {
  float cur[kChainBatch], nxt[kChainBatch];
  const auto load = [&](float (&x)[kChainBatch], int e0) {
#pragma unroll
    for (int i = 0; i < kChainBatch; ++i) x[i] = st[(e0 + i) * stride];
  };
  int e0 = 0;
  if (n >= kChainBatch) {
    load(cur, 0);
    for (; e0 + 2 * kChainBatch <= n; e0 += kChainBatch) {
      load(nxt, e0 + kChainBatch);
#pragma unroll
      for (int i = 0; i < kChainBatch; ++i) acc = __fadd_rn(acc, cur[i]);
#pragma unroll
      for (int i = 0; i < kChainBatch; ++i) cur[i] = nxt[i];
    }
#pragma unroll
    for (int i = 0; i < kChainBatch; ++i) acc = __fadd_rn(acc, cur[i]);
    e0 += kChainBatch;
  }
#pragma unroll 4
  for (; e0 < n; ++e0) acc = __fadd_rn(acc, st[e0 * stride]);
  return acc;
}

// The persistent loop's scoring of the `listed` candidates (B1-B5 of the
// header): lut is this lane's (M, C) LUT in device memory, its first
// sh.resident sub-tables also in sh.lut. Every thread calls it; it ends
// after the scored distances are in sh.cand_d / sh.keys (no barrier after).
__device__ __forceinline__ void score_lut_persistent(
    const HopShared& sh, int listed, const float* __restrict__ lut,
    const uint8_t* __restrict__ codes, int n, int m, int c, int r, int ef,
    bool vec4) {
  if (listed == 0) return;
  const int tid = threadIdx.x;
  const int top = c - 1;
  const int cw = sh.code_words;
  const int s = sh.resident;
  uint8_t* code_bytes = reinterpret_cast<uint8_t*>(sh.codes);

  // B1. the listed candidates' code rows (vec4: 4-byte async copies)
  if (vec4) {
    const uint64_t first = l2_evict_first();
    const int words = m >> 2;
    for (Walk w(tid, words); w.row < listed; w.next()) {
      const int id = min(sh.cand_i[sh.list[w.row]], n - 1);
      cp_async4(sh.codes + w.row * cw + w.col,
                codes + (long long)id * m + 4 * w.col, first);
    }
    cp_async_wait_all();
  } else {
    for (Walk w(tid, m); w.row < listed; w.next()) {
      const int id = min(sh.cand_i[sh.list[w.row]], n - 1);
      code_bytes[w.row * cw * 4 + w.col] =
          __ldcs(codes + (long long)id * m + w.col);
    }
  }
  __syncthreads();

  // B2. the lookups of m >= s into stage[(m - s) * r + t], four code
  // positions per shared-memory word (s % 4 == 0 whenever s < m)
  if (s < m) {
    const uint64_t last = l2_evict_last();
    const int g0 = s >> 2;
    const int groups = ((m + 3) >> 2) - g0;
    for (Walk w(tid, listed); w.row < groups; w.next()) {
      const uint32_t word = sh.codes[w.col * cw + g0 + w.row];
      const int m0 = 4 * (g0 + w.row);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (m0 + i < m) {
          const int code = min((int)((word >> (8 * i)) & 0xffu), top);
          cp_async4(sh.stage + (m0 + i - s) * r + w.col,
                    lut + (long long)(m0 + i) * c + code, last);
        }
      }
    }
  }

  // B3. meanwhile, one thread per candidate: m < s from shared memory
  float acc = -0.0f;
  if (tid < listed) {
    const int full = s >> 2;
    acc = add_resident(acc, sh.codes + tid * cw, sh.lut, c, top, full);
    for (int e = 4 * full; e < s; ++e)       // s == m, m % 4 != 0
      acc = __fadd_rn(acc, sh.lut[e * c + min((int)code_bytes[tid * cw * 4 +
                                                              e], top)]);
  }
  // B4. the staged lookups have landed
  cp_async_wait_all();
  __syncthreads();
  // B5. m >= s from the staging buffer, in order
  if (tid < listed) {
    acc = add_staged(acc, sh.stage + tid, r, m - s);
    const int j = sh.list[tid];
    sh.cand_d[j] = acc;
    sh.keys[ef + j] = sort_key(acc, ef + j);
  }
}

// One hop of one lane, by the whole block: pool buffer `cur` in, the merged
// pool into buffer cur ^ 1; n_valid / n_dup get the hop's counts. The pool
// must be in shared memory and visible to every thread before the call;
// the call ends with a barrier. ctl[kValid..kListed] are 0 on entry and on
// return.
//
// f32 mode: T is the row type (float, or uint16_t for bf16 rows); kNorm
// scores by prenorm_dist from norms and the query's qn.
template <bool kLut, int kK, bool kPersistent = false, class T = float,
          bool kNorm = false>
__device__ __forceinline__ void hop_body(
    const HopShared& sh, int cur, int sel, const int* __restrict__ nbrs,
    const float* __restrict__ q_or_lut, const void* __restrict__ table,
    const float* __restrict__ norms, float qn, int n, int r, int d, int c,
    int ef, bool vec4, int& n_valid, int& n_dup) {
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
  if constexpr (kLut && kPersistent) {
    score_lut_persistent(sh, listed, q_or_lut,
                         static_cast<const uint8_t*>(table), n, d, c, r, ef,
                         vec4);
  } else if constexpr (kLut) {
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
    const T* db = static_cast<const T*>(table);
    for (int t = warp; t < listed; t += kHopWarps) {
      const int j = sh.list[t];
      const int id = min(sh.cand_i[j], n - 1);
      float dist = row_sqdist<kNorm>(q_or_lut, db + (long long)id * d, d,
                                     vec4);
      if constexpr (kNorm) dist = prenorm_dist(qn, __ldg(norms + id), dist);
      if (lane == 0) {
        sh.cand_d[j] = dist;
        sh.keys[ef + j] = sort_key(dist, ef + j);
      }
    }
  } else {
    const T* db = static_cast<const T*>(table);
    const float4* q4 = reinterpret_cast<const float4*>(sh.query);
    const int n_chunks = d >> 2;
    for (int t0 = warp * kHopGroup; t0 < listed;
         t0 += kHopWarps * kHopGroup) {
      const int cnt = min(kHopGroup, listed - t0);
      const T* rows[kHopGroup];
      int js[kHopGroup], ids[kHopGroup];
#pragma unroll
      for (int g = 0; g < kHopGroup; ++g) {
        js[g] = g < cnt ? sh.list[t0 + g] : 0;
        ids[g] = g < cnt ? min(sh.cand_i[js[g]], n - 1) : 0;
        rows[g] = db + (long long)ids[g] * d;
      }
      float dist[kHopGroup];
      rows_sqdist_vec4<kK, kHopGroup, kNorm>(
          [&](int k) { return q4[lane + 32 * k]; }, rows, cnt, n_chunks,
          dist);
      if constexpr (kNorm) {
#pragma unroll
        for (int g = 0; g < kHopGroup; ++g)
          if (g < cnt)
            dist[g] = prenorm_dist(qn, __ldg(norms + ids[g]), dist[g]);
      }
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
  const auto place = [&](int e, int rank) {
    if (e < ef) {
      oi[rank] = pi[e];
      od[rank] = pd[e];
      ov[rank] = pv[e];
    } else {
      oi[rank] = sh.cand_i[e - ef];
      od[rank] = sh.cand_d[e - ef];
      ov[rank] = 0;
    }
  };
  if constexpr (kPersistent) {
    // kRankParts threads of one warp count a strided share of the keys
    // each and add their counts
    const int part = tid & (kRankParts - 1);
    for (int e0 = 0; e0 < p; e0 += blockDim.x / kRankParts) {
      const int e = e0 + tid / kRankParts;
      const unsigned long long key = e < p ? sh.keys[e] : 0ull;
      int rank = 0;
      for (int f = part; f < p; f += kRankParts) rank += sh.keys[f] < key;
#pragma unroll
      for (int off = 1; off < kRankParts; off <<= 1)
        rank += __shfl_xor_sync(kFullMask, rank, off);
      if (e < p && part == 0 && rank < ef) place(e, rank);
    }
  } else {
    for (int e = tid; e < p; e += blockDim.x) {
      const unsigned long long key = sh.keys[e];
      int rank = 0;
      for (int f = 0; f < p; ++f) rank += sh.keys[f] < key;
      if (rank < ef) place(e, rank);
    }
  }
  __syncthreads();
}

// Load lane qi's pool into buffer 0 and (f32, kK > 0) stage its query; zero
// the control words. No barrier.
template <bool kLut, int kK>
__device__ __forceinline__ void load_lane(
    const HopShared& sh, int qi, const int* __restrict__ pool_i,
    const float* __restrict__ pool_d, const uint8_t* __restrict__ pool_v,
    const float* __restrict__ q_or_lut, int d, int ef) {
  const long long off = (long long)qi * ef;
  for (int e = threadIdx.x; e < ef; e += blockDim.x) {
    sh.pool_i(0)[e] = pool_i[off + e];
    sh.pool_d(0)[e] = pool_d[off + e];
    sh.pool_v(0)[e] = pool_v[off + e];
  }
  if (!kLut && kK > 0) {
    const float* q = q_or_lut + (long long)qi * d;
    for (int e = threadIdx.x; e < d; e += blockDim.x) sh.query[e] = q[e];
  }
  if (threadIdx.x < kCtl) sh.ctl[threadIdx.x] = 0;
}

// The block-per-query start: carve shared memory and load lane blockIdx.x.
// Ends with a barrier.
template <bool kLut, int kK>
__device__ __forceinline__ HopShared hop_start(
    const int* __restrict__ pool_i, const float* __restrict__ pool_d,
    const uint8_t* __restrict__ pool_v, const float* __restrict__ q_or_lut,
    int d, int ef, int r) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int qf = kLut ? 0 : staged_query_floats(d, kK);
  const HopShared sh = carve(smem, ef, r, qf);
  load_lane<kLut, kK>(sh, blockIdx.x, pool_i, pool_d, pool_v, q_or_lut, d,
                      ef);
  __syncthreads();
  return sh;
}

// Lane qi's operand: its query row (f32) or its (M, C) LUT.
template <bool kLut>
__device__ __forceinline__ const float* lane_operand(const float* q_or_lut,
                                                     int qi, int d, int c) {
  return q_or_lut + (long long)qi * d * (kLut ? c : 1);
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
  hop_body<kLut, kK>(sh, 0, sel[qi], nbrs,
                     lane_operand<kLut>(q_or_lut, qi, d, c), table, nullptr,
                     0.f, n, r, d, c, ef, vec4, n_valid, n_dup);
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
//
// T and kNorm (f32 mode only): the row type and the prenorm distance over
// norms, as in hop_body; the query's qn is summed once per lane, by each
// warp (the same bits in every warp).
//
// kPersistent (LUT mode only): the grid walks the lanes, block b taking
// lanes b, b + gridDim.x, ... one after another, each with the first
// `resident` sub-tables of its LUT copied into shared memory (lut_vec4: the
// LUT's rows start 16-byte aligned); else lane blockIdx.x, resident and
// lut_vec4 unused.
template <bool kLut, int kK, bool kPersistent = false, class T = float,
          bool kNorm = false>
__global__ void __launch_bounds__(kPersistent ? kPersistentThreads
                                              : kHopThreads)
beam_hops_kernel(const int* __restrict__ nbrs, const int* __restrict__ pool_i,
                 const float* __restrict__ pool_d,
                 const uint8_t* __restrict__ pool_v,
                 const int* __restrict__ hops_in,
                 const int* __restrict__ gath_in,
                 const int* __restrict__ dup_in,
                 const int* __restrict__ stale_in,
                 const float* __restrict__ q_or_lut,
                 const void* __restrict__ table,
                 const float* __restrict__ norms, int* __restrict__ out_i,
                 float* __restrict__ out_d, uint8_t* __restrict__ out_v,
                 int* __restrict__ hops_out, int* __restrict__ gath_out,
                 int* __restrict__ dup_out, int* __restrict__ stale_out,
                 int* __restrict__ iters_out, uint8_t* __restrict__ live_out,
                 int nq, int n, int r, int d, int c, int ef, int k,
                 int max_iters, int max_steps, int patience, float eps,
                 bool vec4, int resident, bool lut_vec4) {
  const int lane = threadIdx.x & 31;
  const bool lead = threadIdx.x < 32;          // warp 0 runs the control
  const float inf = __int_as_float(0x7f800000);
  const int kk = min(k, ef);
  // lane qi from its loaded pool to its outputs
  const auto run = [&](const HopShared& sh, int qi) {
    const float* operand = lane_operand<kLut>(q_or_lut, qi, d, c);
    float qn = 0.f;
    if constexpr (!kLut && kNorm) {
      if constexpr (kK == 0) {
        qn = row_sqdist<true>(operand, operand, d, vec4);
      } else {
        const float4* q4 = reinterpret_cast<const float4*>(sh.query);
        float self[1];
        sqdist_chunks<kK, 1, true>(
            [&](int kc) { return q4[lane + 32 * kc]; },
            [&](int, int kc) { return q4[lane + 32 * kc]; }, d >> 2, self);
        qn = self[0];
      }
    }
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
      hop_body<kLut, kK, kPersistent, T, kNorm>(sh, cur, sel, nbrs, operand,
                                                table, norms, qn, n, r, d, c,
                                                ef, vec4, n_valid, n_dup);
      if (lead) {
        hops += sel >= 0;
        gath += n_valid;
        dup += n_dup;
        ++iters;
        if (patience >= 0) {
          bool progress = false;
          for (int j = lane; j < kk; j += 32)
            progress |=
                __fsub_rn(sh.pool_d(cur)[j], sh.pool_d(cur ^ 1)[j]) > eps;
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
  };
  if constexpr (kPersistent) {
    extern __shared__ __align__(16) unsigned char smem[];
    const HopShared sh = carve_persistent(smem, ef, r, d, c, resident);
    const uint64_t first = l2_evict_first();
    const int nf = resident * c;
    const int n4 = lut_vec4 ? nf >> 2 : 0;
    for (int qi = blockIdx.x; qi < nq; qi += gridDim.x) {
      const float* lut = q_or_lut + (long long)qi * d * c;
      for (int e = threadIdx.x; e < n4; e += blockDim.x)
        cp_async16(sh.lut + 4 * e, lut + 4 * e, first);
      for (int e = 4 * n4 + threadIdx.x; e < nf; e += blockDim.x)
        cp_async4(sh.lut + e, lut + e, first);
      load_lane<kLut, kK>(sh, qi, pool_i, pool_d, pool_v, q_or_lut, d, ef);
      cp_async_wait_all();
      __syncthreads();
      run(sh, qi);
      __syncthreads();       // done with lane qi before the next overwrites it
    }
  } else {
    run(hop_start<kLut, kK>(pool_i, pool_d, pool_v, q_or_lut, d, ef, r),
        blockIdx.x);
  }
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

// f32 mode: bf16 != 0 reads bf16 rows, norms != null scores by the prenorm
// distance (LUT mode: both unused).
template <bool kLut>
int launch_hops(void* const* in, void* const* out, const void* q_or_lut,
                const void* table, const void* norms, int bf16, int nq,
                int n, int r, int d, int c, int ef, int k, int max_iters,
                int max_steps, int patience, float eps, int vec4, int grid,
                int resident, int lut_vec4, void* stream) {
  const auto launch = [&](auto kernel, int blocks, int threads, int smem) {
    kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        (const int*)in[0], (const int*)in[1], (const float*)in[2],
        (const uint8_t*)in[3], (const int*)in[4], (const int*)in[5],
        (const int*)in[6], (const int*)in[7], (const float*)q_or_lut, table,
        (const float*)norms, (int*)out[0], (float*)out[1], (uint8_t*)out[2], (int*)out[3],
        (int*)out[4], (int*)out[5], (int*)out[6], (int*)out[7],
        (uint8_t*)out[8], nq, n, r, d, c, ef, k, max_iters, max_steps,
        patience, eps, vec4 != 0, resident, lut_vec4 != 0);
  };
  if (kLut && grid > 0) {                    // the persistent LUT loop
    const auto kernel = beam_hops_kernel<true, 0, true>;
    const int smem = PersistentLayout(ef, r, d, c, resident).end;
    int err = prepare(kernel, smem);
    if (!err)
      err = (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err) return err;
    if (nq > 0)
      launch(kernel, grid < nq ? grid : nq, kPersistentThreads, smem);
    return (int)cudaGetLastError();
  }
  const int kk = kLut ? 0 : f32_lane_chunks(d, vec4);
  const auto by_mode = [&](auto row, auto norm) {
    using T = decltype(row);
    constexpr bool kNorm = decltype(norm)::value;
    return by_lane_chunks(kk, [&](auto kc) {
      constexpr int kK = kLut ? 0 : decltype(kc)::value;
      const auto kernel = beam_hops_kernel<kLut, kK, false, T, kNorm>;
      const int smem = hop_smem_bytes(ef, r, staged_query_floats(d, kK));
      const int err = prepare(kernel, smem);
      if (err) return err;
      if (nq > 0) launch(kernel, nq, kHopThreads, smem);
      return (int)cudaGetLastError();
    });
  };
  if constexpr (kLut) {
    return by_mode(0.f, std::false_type{});
  } else {
    if (bf16)
      return norms ? by_mode(uint16_t{}, std::true_type{})
                   : by_mode(uint16_t{}, std::false_type{});
    return norms ? by_mode(0.f, std::true_type{})
                 : by_mode(0.f, std::false_type{});
  }
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
// iters, live (each out array distinct from every in array). db: f32 rows,
// or bf16 rows (bf16 != 0; their bits); norms: the (N,) |x|^2 of the
// prenorm distance, or null for the diff-square form.
extern "C" int beam_hops_f32(void* const* in, void* const* out, const void* q,
                             const void* db, const void* norms, int nq, int n,
                             int r, int d, int ef, int k, int max_iters,
                             int max_steps, int patience, float eps, int vec4,
                             int bf16, void* stream) {
  return launch_hops<false>(in, out, q, db, norms, bf16, nq, n, r, d, 0, ef,
                            k, max_iters, max_steps, patience, eps, vec4, 0,
                            0, 0, stream);
}

// grid 0: the per_query variant (one block per lane); grid > 0: the
// persistent variant on min(grid, nq) blocks with `resident` sub-tables of
// each LUT in shared memory (resident % 4 == 0 or resident == m; the
// caller has checked beam_hops_lut_smem_bytes against the card).
extern "C" int beam_hops_lut(void* const* in, void* const* out,
                             const void* lut, const void* codes, int nq,
                             int n, int r, int m, int c, int ef, int k,
                             int max_iters, int max_steps, int patience,
                             float eps, int vec4, int grid, int resident,
                             int lut_vec4, void* stream) {
  return launch_hops<true>(in, out, lut, codes, nullptr, 0, nq, n, r, m, c,
                           ef, k, max_iters, max_steps, patience, eps, vec4,
                           grid, resident, lut_vec4, stream);
}

// Shared memory of one persistent-loop block.
extern "C" int beam_hops_lut_smem_bytes(int ef, int r, int m, int c,
                                        int resident) {
  return repro_torch::PersistentLayout(ef, r, m, c, resident).end;
}
