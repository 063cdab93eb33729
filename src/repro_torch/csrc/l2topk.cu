// l2topk: for each query, the k smallest squared L2 distances over a
// database and their row ids, as (dists (Q, k) f32 ascending, ids (Q, k)
// int32). The (Q, N) distance matrix is never written.
//
// Replaces the TPU kernel src/repro/kernels/l2topk/l2topk.py, l2_topk_pallas
// (body _l2topk_kernel, helper _insert_sorted), which streams database
// blocks through VMEM on a sequential grid axis, forms each distance tile
// on the MXU and keeps a running top-k in VMEM scratch.
//
// The function: each distance is (|q|^2 + |x|^2) - 2 q.x with the plain
// version's association (core/distances.py), clamped at 0, -0.0 written as
// +0.0. Candidates are ordered by the packed key (f32 bits of the distance
// << 32) | id, so among equal distances the lower id comes first -- the
// rule of the reference's oracle (lax.top_k), not the Pallas kernel's,
// whose _insert_sorted puts each later equal candidate in front. Keys are
// unique, so the result does not depend on the order in which candidates
// are offered, nor on the tiling or the split. The norms are one lane-strided
// FMA chain per lane and a fixed xor-shuffle tree (l2topk_norms_kernel).
//
// Four variants, picked by shape in the wrapper (kernels/l2topk/l2topk.py,
// route), each launched and counted on its own:
//
// tile (SIMT, f32): the dot product of one (query, row) pair is one
//   sequential chain of fused multiply-adds over d = 0..D-1.
//   l2topk_kernel: block (query tile of 64) x (split of the database); the
//   block walks its split in tiles of 128 rows; the 64 x 128 product runs
//   over D in stages of 16 (query and row stages in shared memory,
//   transposed and padded, the next stage prefetched into registers, a
//   4 x 8 register micro-tile of FMAs per thread); the distances go to a
//   shared tile, then each warp offers its rows' candidates to their running
//   lists (a threshold test by ballot, a warp-wide sorted insertion for the
//   few that pass). Bound: operations, 2 Q N D at 67 TFLOP/s.
//   Takes the shapes the others do not: the medoid (Q = 1, split over the
//   database), k-means and entry-point assignment (N = 64 centroids), and
//   64 < k <= 128.
//
// wide (SIMT, f32): any k <= N, for k past the tile variant's 128-entry
//   shared lists (FlatIndex.search and the exact kNN table at wide k). The
//   tile variant's distance tiles (tile_distances, the same bits), but each
//   query's running top-k is a sorted list of k keys in global memory; the
//   candidates below its k-th key collect in a 128-key buffer per query in
//   shared memory, and a full buffer is sorted (bitonic, one warp) and
//   merged into the list (each key to its rank in the union; l2topk_wide_
//   kernel). Split-N as for tile, with its own merge (l2topk_wide_merge_
//   kernel). Bound: as tile, operations, 2 Q N D at 67 TFLOP/s; the merges
//   add O(k) list traffic per buffer, which the L2 holds at the widths
//   callers ask for.
//
// small (SIMT, f32): the whole database (N <= 256 rows of D <= 8) sits in
//   shared memory. For k = 1 a thread owns four queries (each row read from
//   shared memory serves all four) and keeps, per query, the least distance
//   and its first row in registers; for k <= 16 a thread owns one query and
//   keeps its 16 smallest packed keys sorted in registers. The distances use
//   the tile variant's arithmetic (the same FMA chain, the same norm tree),
//   so they are the same bits. One launch: the norms are folded in. PQ's
//   codec calls it with Q = 270k, N = 256, D = 2, k = 1, 3,000 times a fit;
//   there the tile variant ran 64 x 128 tiles 16 deep for a 2-deep product
//   and kept shared lists for k = 1. Bound: operations, 2 Q N D + the norms
//   at 67 TFLOP/s (4.1 us; the 2 MB of queries are 0.7 us of bytes); the
//   clamp, compare and select add ~5 operations per distance that the bound
//   does not count.
//
// tc (tensor cores, 3xTF32): the dot products run on wgmma. Each input v is
//   split once, by the norms pass, into hi = tf32(v) (round to nearest) and
//   lo = tf32(v - hi), written to scratch with rows padded to a multiple of
//   16 columns (zeros). q.x is then summed as hi_q.hi_x + hi_q.lo_x +
//   lo_q.hi_x over k8 steps in f32 on the tensor cores. The dropped lo.lo
//   term and the rounding of lo leave each product within ~2^-21 relative of
//   the exact one (one f32 rounding is 2^-24), far below the f32 error of a
//   sum of D such products, so the distances keep f32-level accuracy. TF32
//   alone (hi.hi, ~2^-11 relative per product) moves them past the plain
//   version's rtol of 1e-5 and would change the kNN graph (tests/
//   test_torch_l2topk.py emulates both). The sum order is the tensor
//   cores', not a sequential chain. On integer-valued inputs with
//   |v| <= 2048 (hi = v, lo = 0) and partial sums below 2^24 every step is
//   exact, and the result equals the plain version bit for bit.
//   l2topk_tc_kernel: block (128 queries) x (split of the database), 288
//   threads. Warp 8 is the producer: TMA loads of the query (128 x 16) and
//   row (256 x 16) hi and lo stages (48 KB), 64-byte swizzled, into a ring
//   of shared-memory stages, each guarded by a full and an empty mbarrier:
//   4 stages where the per-row lists leave room (k <= 33), else 3.
//   Warps 0-7 are two consumer warpgroups of 64 queries each; for every
//   tile of 256 rows each issues m64n256k8 wgmmas from shared memory into
//   128 f32 accumulators per thread, releasing a stage as soon as the
//   wgmmas that read it have retired. A tile's epilogue (distances from the
//   accumulators, then the ballot offer into per-row sorted key lists in
//   shared memory) runs on one warpgroup while the other's wgmmas keep the
//   tensor cores busy, as far as the ring lets one warpgroup run ahead of
//   the other (both read every stage; there is no ordered ping-pong). Bound: operations, 3 x 2 Q N D at 495 TFLOP/s (TF32,
//   dense): 11.4 ms at the AntiHub shape (Q = 4096, N = 300,000, D = 768)
//   against 28.2 ms for the f32 SIMT route at 67 TFLOP/s. The hi/lo scratch
//   (2 (Q + N) D' floats, 1.87 GB at AntiHub) costs one extra write pass.
//   Takes AntiHub, the structural kNN, the ground truth, and recsys_ann's
//   kNN.
//
// Split-N: when there are few query tiles, the tile and tc variants split
// the database over blockIdx.y so the grid fills the 132 SMs, and
// l2topk_merge_kernel takes the k smallest of the splits' sorted lists.
#include <cuda.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kL2Threads = 256;
constexpr int kBQ = 64;        // queries per block tile
constexpr int kBN = 128;       // database rows per block tile
constexpr int kBK = 16;        // depth of one shared-memory stage
constexpr int kTM = 4;         // queries per thread
constexpr int kTN = 8;         // rows per thread: two groups of 4
constexpr int kQS = kBQ + 4;   // padded strides (floats); multiples of 4
constexpr int kNS = kBN + 4;
constexpr int kMaxK = 128;
constexpr int kQLoads = kBQ * kBK / kL2Threads;   // 4
constexpr int kXLoads = kBN * kBK / kL2Threads;   // 8
constexpr int kMergeWarps = kL2Threads / 32;
constexpr unsigned long long kEmptyKey = ~0ull;

// Insert cand (below list[k - 1]) into the ascending list[0..k) in shared
// memory. Called by the whole warp with the same cand.
__device__ __forceinline__ void warp_insert(unsigned long long* list, int k,
                                            unsigned long long cand) {
  const int lane = threadIdx.x & 31;
  int pos = 0;  // entries below cand: a prefix, the list being sorted
#pragma unroll
  for (int e = 0; e < kMaxK / 32; ++e) {
    if (e * 32 >= k) break;                       // uniform across the warp
    const int i = e * 32 + lane;
    pos += __popc(__ballot_sync(kFullMask, i < k && list[i] < cand));
  }
  unsigned long long moved[kMaxK / 32];
#pragma unroll
  for (int e = 0; e < kMaxK / 32; ++e) {
    const int i = e * 32 + lane;
    moved[e] = (i < k && i > pos) ? list[i - 1] : cand;
  }
  __syncwarp();
#pragma unroll
  for (int e = 0; e < kMaxK / 32; ++e) {
    const int i = e * 32 + lane;
    if (i < k && i >= pos) list[i] = moved[e];
  }
  __syncwarp();
}

// Offer one key per lane to the list; returns the new threshold (the
// list's k-th key). thr must be list[k - 1] on entry, on every lane.
__device__ __forceinline__ unsigned long long warp_offer(
    unsigned long long* list, int k, unsigned long long key,
    unsigned long long thr) {
  unsigned mask = __ballot_sync(kFullMask, key < thr);
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const unsigned long long cand = __shfl_sync(kFullMask, key, src);
    if (cand < thr) {                             // uniform across the warp
      warp_insert(list, k, cand);
      thr = list[k - 1];
    }
  }
  return thr;
}

// k <= N, so every key written out is a real candidate's.
__device__ __forceinline__ void write_key(unsigned long long key, float* d,
                                          int* id) {
  *d = __uint_as_float((unsigned)(key >> 32));
  *id = (int)(unsigned)(key & 0xffffffffu);
}

// tf32(v), rounded to nearest (ties away from zero): the low 13 mantissa
// bits cleared, so the tensor cores read the value exactly.
__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// out[r] = sum_e a_r[e]^2 for the nq query rows, then the n database rows.
// With split (the tc variant), each row is also written as hi = tf32(v)
// and lo = tf32(v - hi), dp >= d columns (zeros past d): the queries' hi
// rows at split[0, nq dp), their lo rows after them, then the database's
// hi rows and lo rows.
__global__ void __launch_bounds__(kL2Threads)
l2topk_norms_kernel(const float* __restrict__ q, int nq,
                    const float* __restrict__ x, int n, int d,
                    float* __restrict__ out, float* __restrict__ split,
                    int dp) {
  const long long row = (long long)blockIdx.x * (kL2Threads / 32) +
                        (threadIdx.x >> 5);
  if (row >= (long long)nq + n) return;
  const float* src = row < nq ? q + row * d : x + (row - nq) * d;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int e = lane; e < d; e += 32) {
    const float v = __ldg(src + e);
    acc = __fmaf_rn(v, v, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(kFullMask, acc, off));
  if (lane == 0) out[row] = acc;
  if (split == nullptr) return;
  float* hi = row < nq ? split + row * dp
                       : split + (2LL * nq + row - nq) * dp;
  float* lo = hi + (long long)(row < nq ? nq : n) * dp;
  for (int e = lane; e < dp; e += 32) {
    const float v = e < d ? __ldg(src + e) : 0.f;
    const float h = tf32_rna(v);
    hi[e] = h;
    lo[e] = tf32_rna(__fsub_rn(v, h));
  }
}

// The distance (qn + xn) - 2 dot with the plain version's association,
// clamped at 0 (fmaxf may keep a -0.0, which compares equal to +0.0).
__device__ __forceinline__ float clamped_dist(float qn, float xn, float dot) {
  return fmaxf(__fsub_rn(__fadd_rn(qn, xn), __fmul_rn(2.f, dot)), 0.f);
}

// The packed key of one candidate: its clamped distance, -0.0 as +0.0.
__device__ __forceinline__ unsigned long long dist_key(float qn, float xn,
                                                       float dot, int id) {
  const float dist = __fadd_rn(clamped_dist(qn, xn, dot), 0.f);
  return ((unsigned long long)__float_as_uint(dist) << 32) | (unsigned)id;
}

// The (kBQ x kBN) distance tile of queries q0.. against database rows
// t0.. (rows at or past n_end read as zeros) into s_tile, as the tile and
// wide variants both compute it: each dot product one sequential FMA chain
// over d = 0..D-1, in stages of kBK columns (query and row stages in shared
// memory, transposed and padded, the next stage prefetched into registers,
// a 4 x 8 register micro-tile per thread), then (qn + xn) - 2 dot clamped
// at 0, -0.0 as +0.0. Starts and ends with a barrier: the previous tile's
// readers of s_tile are done before its first stage is stored.
__device__ __forceinline__ void tile_distances(
    const float* __restrict__ q, const float* __restrict__ x,
    const float* __restrict__ xn, const float (&qn_r)[kTM], int nq,
    int n_end, int d, int q0, int t0, float* s_q, float* s_x,
    float* s_tile) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  // this thread's share of a stage: element e = tid + 256 * i of a
  // (rows x kBK) stage is row e / kBK, column e % kBK, so 16 neighbouring
  // threads read 16 neighbouring floats of one row
  const int ld_col = tid % kBK;
  const int ld_row = tid / kBK;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  float rq[kQLoads], rx[kXLoads];
  auto load_stage = [&](int k0) {
    const int col = k0 + ld_col;
#pragma unroll
    for (int i = 0; i < kQLoads; ++i) {
      const int qi = q0 + ld_row + i * (kL2Threads / kBK);
      rq[i] = (qi < nq && col < d) ? __ldg(q + (long long)qi * d + col)
                                   : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int xi = t0 + ld_row + i * (kL2Threads / kBK);
      rx[i] = (xi < n_end && col < d) ? __ldg(x + (long long)xi * d + col)
                                      : 0.f;
    }
  };
  load_stage(0);
  for (int k0 = 0; k0 < d; k0 += kBK) {
    __syncthreads();                 // the last stage's readers are done
#pragma unroll
    for (int i = 0; i < kQLoads; ++i)
      s_q[ld_col * kQS + ld_row + i * (kL2Threads / kBK)] = rq[i];
#pragma unroll
    for (int i = 0; i < kXLoads; ++i)
      s_x[ld_col * kNS + ld_row + i * (kL2Threads / kBK)] = rx[i];
    __syncthreads();
    if (k0 + kBK < d) load_stage(k0 + kBK);   // in flight while we compute
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a =
          *reinterpret_cast<const float4*>(s_q + kk * kQS + ty * kTM);
      const float4 b0 =
          *reinterpret_cast<const float4*>(s_x + kk * kNS + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(s_x + kk * kNS + 64 + tx * 4);
      const float av[kTM] = {a.x, a.y, a.z, a.w};
      const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w,
                             b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
  }

  // distances into the shared tile (its previous readers finished before
  // the stage barriers above)
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int col = (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
    const int xi = t0 + col;
    const float xnj = xi < n_end ? __ldg(xn + xi) : 0.f;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      float dist = __fsub_rn(__fadd_rn(qn_r[i], xnj),
                             __fmul_rn(2.f, acc[i][j]));
      dist = __fadd_rn(fmaxf(dist, 0.f), 0.f);    // clamp; -0.0 -> +0.0
      s_tile[(ty * kTM + i) * kNS + col] = dist;
    }
  }
  __syncthreads();
}

// The packed key of column c of row r of the distance tile (kEmptyKey
// past the split's last row).
__device__ __forceinline__ unsigned long long tile_key(const float* s_tile,
                                                       int r, int c, int cols,
                                                       int t0) {
  return c < cols ? ((unsigned long long)__float_as_uint(s_tile[r * kNS + c])
                     << 32) | (unsigned)(t0 + c)
                  : kEmptyKey;
}

// The query's norms for this thread's kTM rows of the query tile.
__device__ __forceinline__ void tile_query_norms(const float* __restrict__ qn,
                                                 int nq, int q0,
                                                 float (&qn_r)[kTM]) {
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int qi = q0 + ty * kTM + i;
    qn_r[i] = qi < nq ? qn[qi] : 0.f;
  }
}

__global__ void __launch_bounds__(kL2Threads, 2)
l2topk_kernel(const float* __restrict__ q, const float* __restrict__ x,
              const float* __restrict__ qn, const float* __restrict__ xn,
              int nq, int n, int d, int k, int tiles_per_split,
              unsigned long long* __restrict__ partial,
              float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char l2_smem[];
  float* s_q = reinterpret_cast<float*>(l2_smem);        // [kBK][kQS]
  float* s_x = s_q + kBK * kQS;                           // [kBK][kNS]
  float* s_tile = s_x + kBK * kNS;                        // [kBQ][kNS]
  unsigned long long* s_list =
      reinterpret_cast<unsigned long long*>(s_tile + kBQ * kNS);  // [kBQ][k]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int n_begin = blockIdx.y * tiles_per_split * kBN;
  const int n_end = min(n, n_begin + tiles_per_split * kBN);

  for (int e = tid; e < kBQ * k; e += kL2Threads) s_list[e] = kEmptyKey;
  float qn_r[kTM];
  tile_query_norms(qn, nq, q0, qn_r);

  for (int t0 = n_begin; t0 < n_end; t0 += kBN) {
    tile_distances(q, x, xn, qn_r, nq, n_end, d, q0, t0, s_q, s_x, s_tile);
    // selection: warp w offers rows w, w + 8, ... of the tile
    const int cols = min(kBN, n_end - t0);
    for (int r = warp; r < kBQ; r += kL2Threads / 32) {
      if (q0 + r >= nq) break;
      unsigned long long* list = s_list + r * k;
      unsigned long long thr = list[k - 1];
      for (int c = lane; c < kBN; c += 32)
        thr = warp_offer(list, k, tile_key(s_tile, r, c, cols, t0), thr);
    }
  }
  __syncthreads();

  for (int r = warp; r < kBQ; r += kL2Threads / 32) {
    const int qi = q0 + r;
    if (qi >= nq) break;
    for (int i = lane; i < k; i += 32) {
      const unsigned long long key = s_list[r * k + i];
      if (partial != nullptr) {
        partial[((long long)blockIdx.y * nq + qi) * k + i] = key;
      } else {
        write_key(key, out_d + (long long)qi * k + i,
                  out_i + (long long)qi * k + i);
      }
    }
  }
}

// ----------------------------------------------------------------- wide
// k above the tile variant's lists: each query's running list of k sorted
// keys lives in global memory (lists: (splits, nq, k) keys, one list per
// query and database split), and the candidates of each distance tile that
// fall below the list's k-th key wait in a per-query buffer of kWideBuf
// keys in shared memory. A full buffer (and, at the end, a non-empty one)
// is sorted and merged into the list by its warp: every buffered key and
// every list entry moves to its rank in the union, and what falls past k
// drops out -- the reference's chunked algorithm (running best U chunk ->
// top-k), with only the candidates below the running k-th key taking part.
// The distances are the tile variant's (tile_distances), so the keys and
// the result are the same; keys are unique, so the order in which they are
// merged cannot change the result.
constexpr int kWideBuf = 128;

// Ascending bitonic sort of buf[0, kWideBuf) by one warp, after filling
// buf[n, kWideBuf) with kEmptyKey.
__device__ __forceinline__ void warp_sort_buf(unsigned long long* buf,
                                              int n) {
  const int lane = threadIdx.x & 31;
  for (int i = n + lane; i < kWideBuf; i += 32) buf[i] = kEmptyKey;
  __syncwarp();
  for (int size = 2; size <= kWideBuf; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = lane; p < kWideBuf / 2; p += 32) {
        const int i = 2 * (p & ~(stride - 1)) + (p & (stride - 1));
        const unsigned long long a = buf[i], b = buf[i + stride];
        if ((a > b) == ((i & size) == 0)) {
          buf[i] = b;
          buf[i + stride] = a;
        }
      }
      __syncwarp();
    }
  }
}

// Entries of the ascending a[0, len) below key.
__device__ __forceinline__ int rank_below(const unsigned long long* a,
                                          int len, unsigned long long key) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// list (k ascending keys, global memory) <- the k smallest of list and
// buf[0, m) (ascending, 1 <= m <= kWideBuf, shared memory), by one warp.
// A list entry moves up by the number of buffered keys below it; the
// chunks of 32 go from the top down, each read before any is written, so no
// entry is overwritten before it is read (destinations rise with the
// index), and the buffered keys are written last, at their ranks in the
// old list plus their own index.
__device__ void warp_merge_list(unsigned long long* list, int k,
                                const unsigned long long* buf, int m) {
  const int lane = threadIdx.x & 31;
  unsigned long long val[kWideBuf / 32];
  int dst[kWideBuf / 32];
#pragma unroll
  for (int e = 0; e < kWideBuf / 32; ++e) {
    const int i = lane + 32 * e;
    val[e] = i < m ? buf[i] : kEmptyKey;
    dst[e] = i < m ? i + rank_below(list, k, val[e]) : k;
  }
  const unsigned long long first = buf[0];
  for (int c0 = (k - 1) & ~31; c0 >= 0; c0 -= 32) {
    const int j = c0 + lane;
    const unsigned long long v = j < k ? list[j] : 0ull;
    const bool stays = j >= k || v < first;
    if (__all_sync(kFullMask, stays)) break;   // and every lower entry
    const int to = stays ? j : j + rank_below(buf, m, v);
    __syncwarp();
    if (!stays && to < k) list[to] = v;
  }
  __syncwarp();
#pragma unroll
  for (int e = 0; e < kWideBuf / 32; ++e)
    if (dst[e] < k) list[dst[e]] = val[e];
  __syncwarp();
}

__global__ void __launch_bounds__(kL2Threads, 2)
l2topk_wide_kernel(const float* __restrict__ q, const float* __restrict__ x,
                   const float* __restrict__ qn,
                   const float* __restrict__ xn, int nq, int n, int d, int k,
                   int tiles_per_split, unsigned long long* __restrict__ lists,
                   float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char l2_smem[];
  float* s_q = reinterpret_cast<float*>(l2_smem);        // [kBK][kQS]
  float* s_x = s_q + kBK * kQS;                           // [kBK][kNS]
  float* s_tile = s_x + kBK * kNS;                        // [kBQ][kNS]
  unsigned long long* s_buf = reinterpret_cast<unsigned long long*>(
      s_tile + kBQ * kNS);                                // [kBQ][kWideBuf]
  unsigned long long* s_thr = s_buf + kBQ * kWideBuf;     // [kBQ]
  int* s_cnt = reinterpret_cast<int*>(s_thr + kBQ);       // [kBQ]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int n_begin = blockIdx.y * tiles_per_split * kBN;
  const int n_end = min(n, n_begin + tiles_per_split * kBN);
  auto list_of = [&](int r) {
    return lists + ((long long)blockIdx.y * nq + q0 + r) * k;
  };
  auto flush = [&](int r, int cnt) {
    warp_sort_buf(s_buf + r * kWideBuf, cnt);
    warp_merge_list(list_of(r), k, s_buf + r * kWideBuf, cnt);
  };

  // warp w owns rows w, w + 8, ...: their lists, buffers and thresholds
  for (int r = warp; r < kBQ; r += kL2Threads / 32) {
    if (q0 + r >= nq) break;
    unsigned long long* list = list_of(r);
    for (int i = lane; i < k; i += 32) list[i] = kEmptyKey;
    if (lane == 0) {
      s_thr[r] = kEmptyKey;
      s_cnt[r] = 0;
    }
  }
  float qn_r[kTM];
  tile_query_norms(qn, nq, q0, qn_r);

  for (int t0 = n_begin; t0 < n_end; t0 += kBN) {
    tile_distances(q, x, xn, qn_r, nq, n_end, d, q0, t0, s_q, s_x, s_tile);
    const int cols = min(kBN, n_end - t0);
    for (int r = warp; r < kBQ; r += kL2Threads / 32) {
      if (q0 + r >= nq) break;
      unsigned long long* buf = s_buf + r * kWideBuf;
      unsigned long long thr = s_thr[r];
      int cnt = s_cnt[r];
      for (int c = lane; c < kBN; c += 32) {
        const unsigned long long key = tile_key(s_tile, r, c, cols, t0);
        unsigned pass = __ballot_sync(kFullMask, key < thr);
        if (cnt + __popc(pass) > kWideBuf) {      // uniform across the warp
          flush(r, cnt);
          cnt = 0;
          thr = list_of(r)[k - 1];
          pass = __ballot_sync(kFullMask, key < thr);
        }
        if (key < thr)
          buf[cnt + __popc(pass & ((1u << lane) - 1u))] = key;
        cnt += __popc(pass);
      }
      __syncwarp();
      if (lane == 0) {
        s_thr[r] = thr;
        s_cnt[r] = cnt;
      }
      __syncwarp();
    }
  }

  for (int r = warp; r < kBQ; r += kL2Threads / 32) {
    const int qi = q0 + r;
    if (qi >= nq) break;
    const int cnt = s_cnt[r];
    if (cnt > 0) flush(r, cnt);
    if (gridDim.y == 1) {
      const unsigned long long* list = list_of(r);
      for (int i = lane; i < k; i += 32)
        write_key(list[i], out_d + (long long)qi * k + i,
                  out_i + (long long)qi * k + i);
    }
  }
}

// The k smallest of the splits' sorted (splits, nq, k) wide lists, per
// query, by one warp: split 0's list is the running list, and each other
// split's keys below its k-th key (a prefix, the lists being sorted) are
// merged into it kWideBuf at a time.
__global__ void __launch_bounds__(kL2Threads)
l2topk_wide_merge_kernel(unsigned long long* __restrict__ lists, int splits,
                         int nq, int k, float* __restrict__ out_d,
                         int* __restrict__ out_i) {
  __shared__ unsigned long long bufs[kMergeWarps][kWideBuf];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qi = blockIdx.x * kMergeWarps + warp;
  if (qi >= nq) return;
  unsigned long long* buf = bufs[warp];
  unsigned long long* list = lists + (long long)qi * k;
  unsigned long long thr = list[k - 1];
  for (int s = 1; s < splits; ++s) {
    const unsigned long long* src = lists + ((long long)s * nq + qi) * k;
    for (int c0 = 0; c0 < k; c0 += kWideBuf) {
      int m = 0;
#pragma unroll
      for (int e = 0; e < kWideBuf / 32; ++e) {
        const int i = c0 + lane + 32 * e;
        const unsigned long long v = i < k ? src[i] : kEmptyKey;
        buf[lane + 32 * e] = v;
        m += __popc(__ballot_sync(kFullMask, v < thr));
      }
      __syncwarp();
      if (m == 0) break;
      warp_merge_list(list, k, buf, m);
      thr = list[k - 1];
      if (m < kWideBuf) break;        // the rest of this split is above
    }
  }
  for (int i = lane; i < k; i += 32)
    write_key(list[i], out_d + (long long)qi * k + i,
              out_i + (long long)qi * k + i);
}

// The k smallest of the splits' sorted (splits, nq, k) key lists, per query.
__global__ void __launch_bounds__(kL2Threads)
l2topk_merge_kernel(const unsigned long long* __restrict__ partial,
                    int splits, int nq, int k, float* __restrict__ out_d,
                    int* __restrict__ out_i) {
  extern __shared__ unsigned long long merge_lists[];     // [8][k]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long* list = merge_lists + warp * k;
  for (int i = lane; i < k; i += 32) list[i] = kEmptyKey;
  __syncwarp();
  const int qi = blockIdx.x * kMergeWarps + warp;
  if (qi >= nq) return;
  unsigned long long thr = list[k - 1];
  const int total = splits * k;
  for (int base = 0; base < total; base += 32) {
    const int e = base + lane;
    unsigned long long key = kEmptyKey;
    if (e < total) {
      const int s = e / k;
      key = partial[((long long)s * nq + qi) * k + (e - s * k)];
    }
    thr = warp_offer(list, k, key, thr);
  }
  for (int i = lane; i < k; i += 32)
    write_key(list[i], out_d + (long long)qi * k + i,
              out_i + (long long)qi * k + i);
}

// ---------------------------------------------------------------- small
constexpr int kSmallThreads = 256;
constexpr int kSmallMaxN = 256;
constexpr int kSmallMaxD = 8;
constexpr int kSmallMaxK = 16;
constexpr int kSmallQpt = 4;          // queries per thread when k == 1

// The norms pass's value for a row of d <= 8 elements: lane e of its warp
// holds fl(v_e^2) and the xor tree (16, 8, 4, 2, 1) leaves lane 0 with
// ((s0 + s4) + (s2 + s6)) + ((s1 + s5) + (s3 + s7)); the zeros of the other
// lanes add exactly.
template <int DMAX>
__device__ __forceinline__ float small_norm(const float (&v)[DMAX]) {
  float s[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = e < DMAX ? __fmul_rn(v[e], v[e]) : 0.f;
  return __fadd_rn(__fadd_rn(__fadd_rn(s[0], s[4]), __fadd_rn(s[2], s[6])),
                   __fadd_rn(__fadd_rn(s[1], s[5]), __fadd_rn(s[3], s[7])));
}

// The whole database in shared memory (rows padded to DMAX with zeros:
// fma(0, 0, acc) == acc, and acc is never -0). A block of kSmallThreads
// threads takes kSmallQpt * kSmallThreads queries: thread t the queries
// t, t + kSmallThreads, ..., so each shared-memory row read serves
// kSmallQpt queries. k == 1 (KMAX == 1) keeps, per query, the first row of
// the least distance: rows come in id order, so a strict < keeps the lower
// id of a tie, which is the packed-key order. Else one query per thread
// keeps the KMAX smallest keys sorted in registers and writes k of them.
template <int DMAX, int KMAX>
__global__ void __launch_bounds__(kSmallThreads)
l2topk_small_kernel(const float* __restrict__ q, const float* __restrict__ x,
                    int nq, int n, int d, int k, float* __restrict__ out_d,
                    int* __restrict__ out_i) {
  constexpr int kQpt = KMAX == 1 ? kSmallQpt : 1;
  __shared__ float xs[kSmallMaxN * DMAX];
  __shared__ float xn[kSmallMaxN];
  for (int i = threadIdx.x; i < n * DMAX; i += kSmallThreads) {
    const int r = i / DMAX, e = i % DMAX;
    xs[i] = e < d ? __ldg(x + (long long)r * d + e) : 0.f;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < n; r += kSmallThreads) {
    float v[DMAX];
#pragma unroll
    for (int e = 0; e < DMAX; ++e) v[e] = xs[r * DMAX + e];
    xn[r] = small_norm<DMAX>(v);
  }
  __syncthreads();
  const long long q0 = (long long)blockIdx.x * kQpt * kSmallThreads +
                       threadIdx.x;
  if (q0 >= nq) return;
  float qv[kQpt][DMAX], qn[kQpt];
#pragma unroll
  for (int j = 0; j < kQpt; ++j) {
    const long long qi = min(q0 + (long long)j * kSmallThreads, nq - 1LL);
#pragma unroll
    for (int e = 0; e < DMAX; ++e)
      qv[j][e] = e < d ? __ldg(q + qi * d + e) : 0.f;
    qn[j] = small_norm<DMAX>(qv[j]);
  }

  if constexpr (KMAX == 1) {
    float best[kQpt];
    int best_i[kQpt];
#pragma unroll
    for (int j = 0; j < kQpt; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < DMAX; ++e) dot = __fmaf_rn(qv[j][e], xs[e], dot);
      best[j] = clamped_dist(qn[j], xn[0], dot);
      best_i[j] = 0;
    }
#pragma unroll 4
    for (int r = 1; r < n; ++r) {
      float xr[DMAX];
#pragma unroll
      for (int e = 0; e < DMAX; ++e) xr[e] = xs[r * DMAX + e];
      const float xnr = xn[r];
#pragma unroll
      for (int j = 0; j < kQpt; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < DMAX; ++e) dot = __fmaf_rn(qv[j][e], xr[e], dot);
        const float dist = clamped_dist(qn[j], xnr, dot);
        if (dist < best[j]) {
          best[j] = dist;
          best_i[j] = r;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kQpt; ++j) {
      const long long qi = q0 + (long long)j * kSmallThreads;
      if (qi < nq) {
        out_d[qi] = __fadd_rn(best[j], 0.f);          // -0.0 -> +0.0
        out_i[qi] = best_i[j];
      }
    }
  } else {
    unsigned long long top[KMAX];
#pragma unroll
    for (int i = 0; i < KMAX; ++i) top[i] = kEmptyKey;
    for (int r = 0; r < n; ++r) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < DMAX; ++e)
        dot = __fmaf_rn(qv[0][e], xs[r * DMAX + e], dot);
      const unsigned long long key = dist_key(qn[0], xn[r], dot, r);
      if (key < top[KMAX - 1]) {
        unsigned long long c = key;           // insertion into the sorted run
#pragma unroll
        for (int i = 0; i < KMAX; ++i) {
          const unsigned long long lo = min(top[i], c);
          c = max(top[i], c);
          top[i] = lo;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      if (i < k) write_key(top[i], out_d + q0 * k + i, out_i + q0 * k + i);
  }
}

// ------------------------------------------------------------------- tc
constexpr int kTcThreads = 288;          // 2 consumer warpgroups + 1 producer warp
constexpr int kTcM = 128;                // queries per block: 2 x 64
constexpr int kTcN = 256;                // database rows per tile
constexpr int kTcK = 16;                 // columns per stage: one 64-byte row
constexpr int kTcMaxK = 64;
constexpr int kTcConsumerWarps = 8;
constexpr int kQTileBytes = kTcM * kTcK * 4;                 // 8 KB
constexpr int kXTileBytes = kTcN * kTcK * 4;                 // 16 KB
constexpr int kTcStageBytes = 2 * kQTileBytes + 2 * kXTileBytes;   // 48 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Spin until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at (column c0, row c1) of the map into dst; completion is
// counted in bytes on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a K-major tile written by TMA with the 64-byte swizzle:
// rows of 64 bytes, 8-row groups 512 bytes apart (stride byte offset),
// leading byte offset unused; layout type 2 = 64-byte swizzle.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) |
         (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d (64 x 256 per warpgroup, f32) = [d +] a (64 x 8, tf32) . b (256 x 8,
// tf32)^T, both from shared memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[128], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Keep the compiler from moving reads of the accumulators across the
// wgmma wait.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Offer the lanes' keys whose bit is set in mask: each goes, in lane
// order, into the sorted list of its row (block-local) if it still beats
// the list's k-th key.
__device__ __forceinline__ void offer_rows(unsigned long long* lists, int k,
                                           unsigned mask,
                                           unsigned long long key, int row) {
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const unsigned long long cand = __shfl_sync(kFullMask, key, src);
    unsigned long long* list = lists + __shfl_sync(kFullMask, row, src) * k;
    if (cand < list[k - 1]) warp_insert(list, k, cand);   // uniform
  }
}

// STAGES: the depth of the ring, 4 where the lists leave room, else 3.
template <int STAGES>
__global__ void __launch_bounds__(kTcThreads, 1)
l2topk_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap xmap,
                 const float* __restrict__ qn, const float* __restrict__ xn,
                 int nq, int n, int stages_per_tile, int k,
                 int tiles_per_split, unsigned long long* __restrict__ partial,
                 float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ unsigned char tc_smem[];
  const uint32_t raw = smem_u32(tc_smem);
  unsigned char* ring = tc_smem + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * kTcStageBytes);
  uint64_t* empty = full + STAGES;
  unsigned long long* lists =
      reinterpret_cast<unsigned long long*>(empty + STAGES);   // [128][k]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kTcM;
  const int n_begin = blockIdx.y * tiles_per_split * kTcN;
  const int n_end = min(n, n_begin + tiles_per_split * kTcN);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTcConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kTcConsumerWarps) {       // the producer: one thread issues TMA
    if (lane == 0) {
      int it = 0;
      for (int t0 = n_begin; t0 < n_end; t0 += kTcN) {
        for (int ks = 0; ks < stages_per_tile; ++ks, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          unsigned char* st = ring + s * kTcStageBytes;
          mbar_expect_tx(&full[s], kTcStageBytes);
          const int c0 = ks * kTcK;
          tma_load_2d(st, &qmap, c0, q0, &full[s]);                 // q hi
          tma_load_2d(st + kQTileBytes, &qmap, c0, nq + q0, &full[s]);  // q lo
          tma_load_2d(st + 2 * kQTileBytes, &xmap, c0, t0, &full[s]);   // x hi
          tma_load_2d(st + 2 * kQTileBytes + kXTileBytes, &xmap, c0, n + t0,
                      &full[s]);                                   // x lo
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns queries q0 + 64 wg ..; warp wq of it the
  // 16 rows 16 wq .. of those, lane the rows g and g + 8 of its warp's 16
  // and, in each 8-column group j of a tile, the columns 2t and 2t + 1
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int row_a = 64 * wg + 16 * wq + g, row_b = row_a + 8;
  unsigned long long* own = lists + (64 * wg + 16 * wq) * k;
  for (int e = lane; e < 16 * k; e += 32) own[e] = kEmptyKey;
  __syncwarp();
  const bool va = q0 + row_a < nq, vb = q0 + row_b < nq;
  const float qa = va ? __ldg(qn + q0 + row_a) : 0.f;
  const float qb = vb ? __ldg(qn + q0 + row_b) : 0.f;
  unsigned long long thr_a = kEmptyKey, thr_b = kEmptyKey;

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int it = 0;
  for (int t0 = n_begin; t0 < n_end; t0 += kTcN) {
    for (int ks = 0; ks < stages_per_tile; ++ks, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* st = ring + s * kTcStageBytes;
      const uint64_t a_hi = smem_desc(st + wg * (kQTileBytes / 2));
      const uint64_t a_lo = smem_desc(st + kQTileBytes + wg * (kQTileBytes / 2));
      const uint64_t b_hi = smem_desc(st + 2 * kQTileBytes);
      const uint64_t b_lo = smem_desc(st + 2 * kQTileBytes + kXTileBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcK / 8; ++kk) {
        const uint64_t step = 2 * kk;            // 32 bytes, in 16-byte units
        wgmma_tf32(acc, a_hi + step, b_hi + step, (ks > 0 || kk > 0) ? 1 : 0);
        wgmma_tf32(acc, a_hi + step, b_lo + step, 1);
        wgmma_tf32(acc, a_lo + step, b_hi + step, 1);
      }
      wgmma_commit();
      if (ks > 0) {                 // the previous stage's wgmmas have retired
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);

    // epilogue: distances and the offer, straight from the accumulators
#pragma unroll
    for (int j = 0; j < kTcN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = t0 + 8 * j + 2 * t + h;
        const bool vc = col < n_end;
        const float xv = vc ? __ldg(xn + col) : 0.f;
        const unsigned long long ka =
            vc && va ? dist_key(qa, xv, acc[4 * j + h], col) : kEmptyKey;
        const unsigned long long kb =
            vc && vb ? dist_key(qb, xv, acc[4 * j + 2 + h], col) : kEmptyKey;
        const unsigned ma = __ballot_sync(kFullMask, ka < thr_a);
        const unsigned mb = __ballot_sync(kFullMask, kb < thr_b);
        if (ma | mb) {                                  // uniform
          offer_rows(lists, k, ma, ka, row_a);
          offer_rows(lists, k, mb, kb, row_b);
          thr_a = lists[row_a * k + k - 1];
          thr_b = lists[row_b * k + k - 1];
        }
      }
    }
  }

  for (int r = 0; r < 16; ++r) {
    const int row = 64 * wg + 16 * wq + r;
    const int qi = q0 + row;
    if (qi >= nq) break;
    for (int i = lane; i < k; i += 32) {
      const unsigned long long key = lists[row * k + i];
      if (partial != nullptr) {
        partial[((long long)blockIdx.y * nq + qi) * k + i] = key;
      } else {
        write_key(key, out_d + (long long)qi * k + i,
                  out_i + (long long)qi * k + i);
      }
    }
  }
}

}  // namespace repro_torch

namespace {

using namespace repro_torch;

int l2topk_smem_bytes(int k) {
  return (int)((kBK * kQS + kBK * kNS + kBQ * kNS) * sizeof(float) +
               (size_t)kBQ * k * sizeof(unsigned long long));
}

int wide_smem_bytes() {
  return (int)((kBK * kQS + kBK * kNS + kBQ * kNS) * sizeof(float) +
               (size_t)kBQ * (kWideBuf + 1) * sizeof(unsigned long long) +
               (size_t)kBQ * sizeof(int));
}

// Lets kernel take more than 48 KB of dynamic shared memory when it needs.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

int tc_smem_bytes(int stages, int k) {
  return 1024 + stages * kTcStageBytes + 2 * stages * 8 +
         kTcM * k * (int)sizeof(unsigned long long);
}

template <int STAGES>
int launch_tc(const CUtensorMap& qmap, const CUtensorMap& xmap,
              const float* qn, int nq, int n, int stages_per_tile, int k,
              int splits, int tiles_per_split, unsigned long long* part,
              float* out_d, int* out_i, cudaStream_t s) {
  const int smem = tc_smem_bytes(STAGES, k);
  cudaError_t err = cudaFuncSetAttribute(
      l2topk_tc_kernel<STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((nq + kTcM - 1) / kTcM), (unsigned)splits);
  l2topk_tc_kernel<STAGES><<<grid, kTcThreads, smem, s>>>(
      qmap, xmap, qn, qn + nq, nq, n, stages_per_tile, k, tiles_per_split,
      part, out_d, out_i);
  return (int)cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda entry point, looked up through the
// runtime's entry-point query (the library does not link libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// A map over rows (hi rows, then lo rows) of dp floats, boxes of kTcK
// columns x box_rows rows, 64-byte swizzle; rows past the end read zeros.
bool make_map(CUtensorMap* map, const float* base, long long rows, int dp,
              int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)dp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)dp * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)kTcK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)base, dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DMAX>
void launch_small(const float* q, const float* x, int nq, int n, int d, int k,
                  float* out_d, int* out_i, cudaStream_t s) {
  const int per_block = (k == 1 ? kSmallQpt : 1) * kSmallThreads;
  const unsigned grid = (unsigned)((nq + per_block - 1) / per_block);
  if (k == 1)
    l2topk_small_kernel<DMAX, 1><<<grid, kSmallThreads, 0, s>>>(
        q, x, nq, n, d, k, out_d, out_i);
  else
    l2topk_small_kernel<DMAX, kSmallMaxK><<<grid, kSmallThreads, 0, s>>>(
        q, x, nq, n, d, k, out_d, out_i);
}

}  // namespace

// Variants (kernels/l2topk/l2topk.py names them): 0 tile, 1 small, 2 tc,
// 3 wide. queries (nq, d) and database (n, d) f32, contiguous; norms: nq + n
// floats of scratch (tile, tc, wide); split: 2 (nq + n) dp floats of
// scratch with dp = d rounded up to 16 (tc); partial: (splits, nq, k) keys
// of scratch when splits > 1, and always for wide (its running lists).
// Launches 1 kernel (small), 2 (splits == 1) or 3; returns the first CUDA
// error, -1 for arguments the variant does not take.
extern "C" int l2topk_f32(const void* q, const void* x, void* norms,
                          void* split, void* partial, void* out_d,
                          void* out_i, int nq, int n, int d, int k,
                          int variant, int splits, int tiles_per_split,
                          void* stream) {
  using namespace repro_torch;
  if (k < 1 || k > n || nq < 1 || n < 1 || d < 1 || splits < 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const float* qf = (const float*)q;
  const float* xf = (const float*)x;
  if (variant == 1) {
    if (n > kSmallMaxN || d > kSmallMaxD || k > kSmallMaxK) return -1;
    if (d <= 2)
      launch_small<2>(qf, xf, nq, n, d, k, (float*)out_d, (int*)out_i, s);
    else if (d <= 4)
      launch_small<4>(qf, xf, nq, n, d, k, (float*)out_d, (int*)out_i, s);
    else
      launch_small<8>(qf, xf, nq, n, d, k, (float*)out_d, (int*)out_i, s);
    return (int)cudaGetLastError();
  }
  if (variant < 0 || variant > 3) return -1;
  const bool tc = variant == 2, wide = variant == 3;
  if (variant == 0 && k > kMaxK) return -1;
  if (tc && (k > kTcMaxK || split == nullptr)) return -1;
  if ((wide || splits > 1) && partial == nullptr) return -1;
  const int dp = (d + kTcK - 1) / kTcK * kTcK;
  const int warps = kL2Threads / 32;
  const long long rows = (long long)nq + n;
  l2topk_norms_kernel<<<(unsigned)((rows + warps - 1) / warps), kL2Threads,
                        0, s>>>(qf, nq, xf, n, d, (float*)norms,
                                tc ? (float*)split : nullptr, dp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const float* qn = (const float*)norms;
  unsigned long long* part =
      splits > 1 || wide ? (unsigned long long*)partial : nullptr;
  const dim3 grid((unsigned)((nq + kBQ - 1) / kBQ), (unsigned)splits);
  if (tc) {
    CUtensorMap qmap, xmap;
    const float* qs = (const float*)split;
    if (!make_map(&qmap, qs, 2LL * nq, dp, kTcM) ||
        !make_map(&xmap, qs + 2LL * nq * dp, 2LL * n, dp, kTcN))
      return -2;
    int dev = 0, optin = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    const int code =
        tc_smem_bytes(4, k) <= optin
            ? launch_tc<4>(qmap, xmap, qn, nq, n, dp / kTcK, k, splits,
                           tiles_per_split, part, (float*)out_d, (int*)out_i,
                           s)
            : launch_tc<3>(qmap, xmap, qn, nq, n, dp / kTcK, k, splits,
                           tiles_per_split, part, (float*)out_d, (int*)out_i,
                           s);
    if (code != 0 || splits == 1) return code;
  } else if (wide) {
    const int smem = wide_smem_bytes();
    err = allow_smem(l2topk_wide_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    l2topk_wide_kernel<<<grid, kL2Threads, smem, s>>>(
        qf, xf, qn, qn + nq, nq, n, d, k, tiles_per_split, part,
        (float*)out_d, (int*)out_i);
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return (int)err;
    l2topk_wide_merge_kernel<<<(unsigned)((nq + kMergeWarps - 1) /
                                          kMergeWarps),
                               kL2Threads, 0, s>>>(part, splits, nq, k,
                                                   (float*)out_d,
                                                   (int*)out_i);
    return (int)cudaGetLastError();
  } else {
    const int smem = l2topk_smem_bytes(k);
    err = allow_smem(l2topk_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    l2topk_kernel<<<grid, kL2Threads, smem, s>>>(
        qf, xf, qn, qn + nq, nq, n, d, k, tiles_per_split, part,
        (float*)out_d, (int*)out_i);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;

  l2topk_merge_kernel<<<(unsigned)((nq + kMergeWarps - 1) / kMergeWarps),
                        kL2Threads,
                        kMergeWarps * k * sizeof(unsigned long long), s>>>(
      part, splits, nq, k, (float*)out_d, (int*)out_i);
  return (int)cudaGetLastError();
}
