// l2topk: for each query, the k smallest squared L2 distances over a
// database and their row ids, as (dists (Q, k) f32 ascending, ids (Q, k)
// int32). The (Q, N) distance matrix is never written.
//
// Replaces the TPU kernel src/repro/kernels/l2topk/l2topk.py, l2_topk_pallas
// (body _l2topk_kernel, helper _insert_sorted), which streams database
// blocks through VMEM on a sequential grid axis, forms each distance tile
// on the MXU and keeps a running top-k in VMEM scratch.
//
// The function, exactly: each distance is (|q|^2 + |x|^2) - 2 q.x with the
// plain version's association (core/distances.py), clamped at 0, -0.0
// written as +0.0. Candidates are ordered by the packed key
// (f32 bits of the distance << 32) | id, so among equal distances the lower
// id comes first -- the rule of the reference's oracle (lax.top_k), not the
// Pallas kernel's, whose _insert_sorted puts each later equal candidate in
// front. Keys are unique, so the result does not depend on the order in
// which candidates are offered, and the dot product of one (query, row)
// pair is one sequential chain of fused multiply-adds over d = 0..D-1, so
// it does not depend on the tiling or the split either. On integer-valued
// inputs every step is exact and the result equals the plain version's bit
// for bit.
//
// Bound on an H100: operations. At the AntiHub shape (Q = 4096 queries of a
// chunk, N = 300,000, D = 768) one call is 2 Q N D = 1.89e12 flops, 28.2 ms
// at 67 TFLOP/s (f32 outside the tensor cores), against 0.28 ms for the
// 922 MB of database bytes. Full f32 only: TF32 would change the kNN graph.
//
// Design (three launches, the first and last small):
//   1. l2topk_norms_kernel: |q|^2 and |x|^2 once per call, one warp per row.
//   2. l2topk_kernel: block (query tile of 64) x (split of the database).
//      The block walks its split in tiles of 128 rows. For each tile the
//      64 x 128 product runs over D in stages of 16: query and row stages
//      in shared memory (transposed, padded against bank conflicts), the
//      next stage prefetched into registers while this one is used, and a
//      4 x 8 register micro-tile of FMAs per thread (256 threads). The
//      distances go to a shared tile; then each warp offers its rows'
//      candidates to their running lists: a threshold test against the
//      row's current k-th key by ballot, and a warp-wide sorted insertion
//      into the list in shared memory for the few that pass.
//   3. l2topk_merge_kernel (only when the database is split): one warp per
//      query takes the k smallest keys of the splits' sorted lists with the
//      same offer/insert routine. Splits make the grid fill the 132 SMs
//      when Q is small (ground truth: Q = 1024; the medoid: Q = 1).
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

// out[r] = sum_e a_r[e]^2 for the nq query rows, then the n database rows.
__global__ void __launch_bounds__(kL2Threads)
l2topk_norms_kernel(const float* __restrict__ q, int nq,
                    const float* __restrict__ x, int n, int d,
                    float* __restrict__ out) {
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
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int n_begin = blockIdx.y * tiles_per_split * kBN;
  const int n_end = min(n, n_begin + tiles_per_split * kBN);

  for (int e = tid; e < kBQ * k; e += kL2Threads) s_list[e] = kEmptyKey;

  float qn_r[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int qi = q0 + ty * kTM + i;
    qn_r[i] = qi < nq ? qn[qi] : 0.f;
  }
  // this thread's share of a stage: element e = tid + 256 * i of a
  // (rows x kBK) stage is row e / kBK, column e % kBK, so 16 neighbouring
  // threads read 16 neighbouring floats of one row
  const int ld_col = tid % kBK;
  const int ld_row = tid / kBK;

  for (int t0 = n_begin; t0 < n_end; t0 += kBN) {
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

    // distances into the shared tile (the selection of the previous tile
    // finished before the stage barriers above)
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

    // selection: warp w offers rows w, w + 8, ... of the tile
    const int cols = min(kBN, n_end - t0);
    for (int r = warp; r < kBQ; r += kL2Threads / 32) {
      if (q0 + r >= nq) break;
      unsigned long long* list = s_list + r * k;
      unsigned long long thr = list[k - 1];
      for (int c = lane; c < kBN; c += 32) {
        unsigned long long key = kEmptyKey;
        if (c < cols)
          key = ((unsigned long long)__float_as_uint(s_tile[r * kNS + c])
                 << 32) | (unsigned)(t0 + c);
        thr = warp_offer(list, k, key, thr);
      }
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

}  // namespace repro_torch

namespace {

int l2topk_smem_bytes(int k) {
  using namespace repro_torch;
  return (int)((kBK * kQS + kBK * kNS + kBQ * kNS) * sizeof(float) +
               (size_t)kBQ * k * sizeof(unsigned long long));
}

}  // namespace

// queries (nq, d) and database (n, d) f32, contiguous; norms: nq + n floats
// of scratch; partial: (splits, nq, k) keys of scratch when splits > 1.
// Launches 2 kernels (splits == 1) or 3; returns the first CUDA error.
extern "C" int l2topk_f32(const void* q, const void* x, void* norms,
                          void* partial, void* out_d, void* out_i, int nq,
                          int n, int d, int k, int splits,
                          int tiles_per_split, void* stream) {
  using namespace repro_torch;
  if (k < 1 || k > kMaxK || nq < 1 || n < 1 || splits < 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const int warps = kL2Threads / 32;
  const long long rows = (long long)nq + n;
  l2topk_norms_kernel<<<(unsigned)((rows + warps - 1) / warps), kL2Threads,
                        0, s>>>((const float*)q, nq, (const float*)x, n, d,
                                (float*)norms);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int smem = l2topk_smem_bytes(k);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(l2topk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  const float* qn = (const float*)norms;
  const dim3 grid((unsigned)((nq + kBQ - 1) / kBQ), (unsigned)splits);
  l2topk_kernel<<<grid, kL2Threads, smem, s>>>(
      (const float*)q, (const float*)x, qn, qn + nq, nq, n, d, k,
      tiles_per_split,
      splits > 1 ? (unsigned long long*)partial : nullptr, (float*)out_d,
      (int*)out_i);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;

  l2topk_merge_kernel<<<(unsigned)((nq + kMergeWarps - 1) / kMergeWarps),
                        kL2Threads,
                        kMergeWarps * k * sizeof(unsigned long long), s>>>(
      (const unsigned long long*)partial, splits, nq, k, (float*)out_d,
      (int*)out_i);
  return (int)cudaGetLastError();
}
