// alpha_scan: the greedy α-RNG occlusion scan of one chunk of nodes.
//
// For each row b (a node p = node_ids[b] and its distance-ascending
// candidate pool cand_ids[b, :L], cand_dists[b, :L]), candidate q at
// position j is kept unless it is -1, p itself, already kept, past `degree`
// kept, or occluded: some kept r has d(q, r) < alpha * d(p, q). keep[b]
// gets the kept ids in order (-1 after them), mask[b, j] whether position j
// was kept.
//
// Replaces the reference's _alpha_scan (src/repro/core/build/prune.py:66),
// which runs outside Pallas: a lax.fori_loop over the L positions under
// vmap and jit, so one compiled device program per chunk. The port's plain
// version (kernels/alpha_scan/ref.py) steps the L positions from the host,
// about 15 launches each; this kernel takes the whole chunk in one launch.
//
// Same bits as the plain version on the card, in both variants: each
// d(q, r) is row_sqdist's reduction (common.cuh, through sqdist_chunks on
// float4 rows) with the candidate row as the query operand and the kept row
// as the database row, which is the plain version's gather_dist(data[q],
// data, keep) call; the threshold is one f32 product __fmul_rn(alpha, dq)
// (torch rounds a Python float alpha to f32 first, as the wrapper passes
// it) and the test a strict <. Where a row is read from (device memory,
// the L2, shared memory) cannot change its bits, and neither the tests'
// order nor which warp runs them can change the result (ok is their
// conjunction), so the kernels exit early where they may: -1, self and
// duplicate candidates cost no distance, a test stops at its first
// occluding group of kept rows, and once `degree` ids are kept every later
// position is false without work.
//
// Bound on an H100: the bytes of the candidate rows a chunk touches. At the
// prune stage (B = 2048, L = 64, D = 600) the distinct valid candidates are
// ~10^5 rows, ~0.25 GB, ~0.07 ms at 3.35 TB/s; the distances (3 flops per
// element, ~10^6 of them) take ~0.03 ms at the f32 rate.
//
// Two variants, picked by kernels/alpha_scan/alpha_scan.py (route) and
// counted on their own:
//
// warp (simple first): one warp per row, kScanWarps rows per
//   block. The warp reads its row's candidates 32 at a time (one id and one
//   distance per lane, shuffled to the warp in order) and writes 32 mask
//   bytes at once; its kept ids stay in shared memory, its kept rows are
//   read through the L2, kScanGroup at a time with their loads in flight
//   together, against the candidate row held in registers. Rows that are
//   not float4-aligned or longer than 1024 floats take row_sqdist one kept
//   row at a time (kK = 0). Every row is a chain of dependent global-memory
//   round trips (the candidate's row, then each group's verdict before the
//   next group's loads), with 143 registers at D = 600: 12 warps per SM.
//   Takes any degree up to MAX_DEGREE and any D.
//
// staged (what the reference keeps on the chip; alpha_scan_staged_kernel):
//   one warp per row as well, but no test waits on device memory. The
//   live candidates (valid, not the node) are listed once with their
//   thresholds; each candidate's row is loaded into registers while the
//   one before it is tested, after an L2 prefetch a few candidates
//   earlier; a kept candidate's row is stored from those registers into
//   the warp's shared memory (the first `slots` kept rows: 7 at D = 600,
//   sized for 12 warps per SM; the path keeps ~6-9 per row), so it is
//   never read from device memory again, and the tests read the kept rows
//   from there, 4 at a time with their loads in flight together, up to the
//   first occluding group. Kept rows past the slots are read through the
//   L2, as the warp variant reads them all. Splitting one candidate's
//   tests across a block's warps, with one row's kept rows per block, was
//   tried first: at 77 KB of kept rows per row only two rows share an SM,
//   and the barrier rounds per candidate made it slower than the warp
//   variant. Takes float4 rows of D <= 1024 whose lists leave room for one
//   slot per warp at 12 warps per SM (route).
#include "common.cuh"

namespace repro_torch {

constexpr int kScanWarps = 4;
constexpr int kScanGroup = 4;     // kept rows whose loads are in flight

// True when some kept[s], s < cnt, has d(qrow, data[kept[s]]) < thr; tests
// the kept rows in order and stops at the first group that holds one.
// Warp-uniform: every lane gets the same distances.
template <int kK>
__device__ __forceinline__ bool occluded(const float* __restrict__ qrow,
                                         const float* __restrict__ data,
                                         const int* kept, int cnt, float thr,
                                         int n, int d, bool vec4) {
  if constexpr (kK == 0) {
    for (int s = 0; s < cnt; ++s) {
      const float dr = row_sqdist(
          qrow, data + (long long)min(kept[s], n - 1) * d, d, vec4);
      if (dr < thr) return true;
    }
    return false;
  } else {
    const int lane = threadIdx.x & 31;
    const int n_chunks = d >> 2;
    const float4* q4 = reinterpret_cast<const float4*>(qrow);
    float4 qv[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int c = lane + 32 * k;
      qv[k] = c < n_chunks ? __ldg(q4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int s0 = 0; s0 < cnt; s0 += kScanGroup) {
      const int g_cnt = min(kScanGroup, cnt - s0);
      const float* rows[kScanGroup];
#pragma unroll
      for (int g = 0; g < kScanGroup; ++g)
        rows[g] = data +
                  (long long)min(kept[s0 + min(g, g_cnt - 1)], n - 1) * d;
      float dist[kScanGroup];
      rows_sqdist_vec4<kK, kScanGroup>([&](int k) { return qv[k]; }, rows,
                                       g_cnt, n_chunks, dist);
#pragma unroll
      for (int g = 0; g < kScanGroup; ++g)
        if (g < g_cnt && dist[g] < thr) return true;
    }
    return false;
  }
}

template <int kK>
__global__ void __launch_bounds__(kScanWarps * 32)
alpha_scan_kernel(const float* __restrict__ data,
                  const int* __restrict__ node_ids,
                  const int* __restrict__ cand_ids,
                  const float* __restrict__ cand_dists,
                  const float* __restrict__ alpha_rows, float alpha,
                  int* __restrict__ keep, uint8_t* __restrict__ mask, int b,
                  int l, int degree, int n, int d, bool vec4) {
  extern __shared__ int kept_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kScanWarps + warp;
  if (row >= b) return;
  int* kept = kept_smem + warp * degree;
  const int node = node_ids[row];
  const float a = alpha_rows != nullptr ? alpha_rows[row] : alpha;
  const int* ids = cand_ids + row * l;
  const float* dists = cand_dists + row * l;
  uint8_t* mrow = mask + row * l;
  int cnt = 0;
  for (int j0 = 0; j0 < l; j0 += 32) {
    const int j = j0 + lane;
    const int my_id = j < l ? ids[j] : -1;
    const float my_d = j < l ? dists[j] : 0.f;
    const int m = min(32, l - j0);
    unsigned ok_bits = 0;
    for (int i = 0; i < m; ++i) {
      const int q = __shfl_sync(kFullMask, my_id, i);
      const float dq = __shfl_sync(kFullMask, my_d, i);
      bool ok = cnt < degree && q >= 0 && q != node;
      if (ok) {
        bool dup = false;
        for (int s = lane; s < cnt; s += 32) dup |= kept[s] == q;
        ok = !__any_sync(kFullMask, dup);
      }
      if (ok && cnt > 0) {
        const float* qrow = data + (long long)min(q, n - 1) * d;
        ok = !occluded<kK>(qrow, data, kept, cnt, __fmul_rn(a, dq), n, d,
                           vec4);
      }
      if (ok) {
        if (lane == 0) kept[cnt] = q;
        __syncwarp();
        ++cnt;
        ok_bits |= 1u << i;
      }
    }
    if (j < l) mrow[j] = (uint8_t)((ok_bits >> lane) & 1u);
  }
  for (int s = lane; s < degree; s += 32)
    keep[row * degree + s] = s < cnt ? kept[s] : -1;
}

// ---------------------------------------------------------------- staged
constexpr int kStagedWarps = 4;   // rows per block, one warp each
constexpr int kStagedAhead = 4;   // candidates ahead that are pulled to L2
constexpr int kStagedWarpsPerSm = 12;   // the occupancy the slots are sized
                                        // for (the registers allow 12)

// Shared memory of one warp of a staged block with `slots` kept-row slots:
// the slots (float4), the live candidates' ids, positions and thresholds,
// the kept ids and their candidate indices; a block holds kStagedWarps of
// them. kernels/alpha_scan/alpha_scan.py (staged_warp_bytes) repeats it.
__host__ __device__ __forceinline__ size_t staged_warp_bytes(int degree,
                                                             int l, int d,
                                                             int slots) {
  const size_t bytes = (size_t)slots * d * sizeof(float) +
                       3 * (size_t)l * sizeof(int) +
                       2 * (size_t)degree * sizeof(int);
  return (bytes + 15) / 16 * 16;
}

// One warp per row, as the warp variant, but nothing it tests waits on
// device memory: the live candidates (valid, not the node) are listed once
// with their thresholds; each candidate's row is loaded into registers
// while the candidate before it is tested, after an L2 prefetch
// kStagedAhead candidates earlier; the first `slots` kept rows live in the
// warp's shared memory, stored there from the registers that held the
// candidate (no second read), and the tests read them from there, kG at a
// time with their loads in flight together. Kept rows past the slots are
// read through the L2, as the warp variant reads them all. Tests stop at
// the first occluding group.
template <int kK, int kG>
__global__ void __launch_bounds__(kStagedWarps * 32)
alpha_scan_staged_kernel(const float* __restrict__ data,
                         const int* __restrict__ node_ids,
                         const int* __restrict__ cand_ids,
                         const float* __restrict__ cand_dists,
                         const float* __restrict__ alpha_rows, float alpha,
                         int* __restrict__ keep, uint8_t* __restrict__ mask,
                         int b, int l, int degree, int n, int d, int slots) {
  extern __shared__ __align__(16) unsigned char scan_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kStagedWarps + warp;
  if (row >= b) return;
  const int d4 = d >> 2;
  float4* s_kept = reinterpret_cast<float4*>(
      scan_smem + warp * staged_warp_bytes(degree, l, d, slots));
  int* s_id = reinterpret_cast<int*>(s_kept + (size_t)slots * d4);  // [l]
  int* s_pos = s_id + l;                                   // [l] positions
  float* s_thr = reinterpret_cast<float*>(s_pos + l);      // [l] thresholds
  int* s_kept_id = reinterpret_cast<int*>(s_thr + l);      // [degree]
  int* s_kept_t = s_kept_id + degree;                      // [degree]
  const int node = node_ids[row];
  const float a = alpha_rows != nullptr ? alpha_rows[row] : alpha;
  const int* ids = cand_ids + row * l;
  const float* dists = cand_dists + row * l;

  // the live candidates in order, each with its threshold alpha * d(p, q)
  int n_live = 0;
  for (int j0 = 0; j0 < l; j0 += 32) {
    const int j = j0 + lane;
    const int id = j < l ? ids[j] : -1;
    const float dq = j < l ? dists[j] : 0.f;
    const bool live = id >= 0 && id != node;
    const unsigned bits = __ballot_sync(kFullMask, live);
    if (live) {
      const int at = n_live + __popc(bits & ((1u << lane) - 1u));
      s_id[at] = id;
      s_pos[at] = j;
      s_thr[at] = __fmul_rn(a, dq);
    }
    n_live += __popc(bits);
  }
  __syncwarp();

  auto src = [&](int id) {
    return reinterpret_cast<const float4*>(data +
                                           (long long)min(id, n - 1) * d);
  };
  auto load_row = [&](int t, float4 (&v)[kK]) {
    const float4* r = src(s_id[t]);
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int c = lane + 32 * k;
      v[k] = c < d4 ? __ldg(r + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto prefetch_l2 = [&](int t) {       // one 128-byte line per lane
    if (t < n_live && lane * 128 < d * (int)sizeof(float))
      asm volatile("prefetch.global.L2 [%0];" ::"l"(
          reinterpret_cast<const char*>(src(s_id[t])) + lane * 128));
  };

  float4 qv[kK], nv[kK];
  for (int t = 0; t < kStagedAhead; ++t) prefetch_l2(t);
  if (n_live > 0) load_row(0, qv);
  int cnt = 0;     // the same on every lane: every verdict is uniform
  for (int t = 0; t < n_live && cnt < degree; ++t) {
    if (t + 1 < n_live) load_row(t + 1, nv);     // in flight meanwhile
    prefetch_l2(t + kStagedAhead);
    const int q = s_id[t];
    bool dup = false;
    for (int s = lane; s < cnt; s += 32) dup |= s_kept_id[s] == q;
    bool ok = !__any_sync(kFullMask, dup);
    if (ok && cnt > 0) {
      const float thr = s_thr[t];
      // kept rows s0 .. s0 + kG - 1 of [s0, s1) (a short last group reads
      // its last row again): does one occlude candidate t?
      auto occludes = [&](int s0, int s1, auto in_slots) {
        float4 xv[kG][kK];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const int s = min(s0 + g, s1 - 1);
#pragma unroll
          for (int k = 0; k < kK; ++k) {
            const int c = min(lane + 32 * k, d4 - 1);
            if constexpr (decltype(in_slots)::value)
              xv[g][k] = s_kept[(size_t)s * d4 + c];
            else
              xv[g][k] = __ldg(src(s_kept_id[s]) + c);
          }
        }
        float dist[kG];
        sqdist_chunks<kK, kG>([&](int k) { return qv[k]; },
                              [&](int g, int k) { return xv[g][k]; }, d4,
                              dist);
        bool occ = false;
#pragma unroll
        for (int g = 0; g < kG; ++g) occ |= s0 + g < s1 && dist[g] < thr;
        return occ;                        // every lane the same
      };
      // the kept rows in the slots from shared memory, then the rest
      // through the L2
      const int in = min(cnt, slots);
      for (int s0 = 0; s0 < in && ok; s0 += kG)
        ok = !occludes(s0, in, std::true_type{});
      for (int s0 = in; s0 < cnt && ok; s0 += kG)
        ok = !occludes(s0, cnt, std::false_type{});
    }
    if (ok) {
      if (cnt < slots) {
        float4* dst = s_kept + (size_t)cnt * d4;
#pragma unroll
        for (int k = 0; k < kK; ++k)
          if (lane + 32 * k < d4) dst[lane + 32 * k] = qv[k];
      }
      if (lane == 0) {
        s_kept_id[cnt] = q;
        s_kept_t[cnt] = t;
      }
      __syncwarp();
      ++cnt;
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) qv[k] = nv[k];
  }
  uint8_t* mrow = mask + row * l;
  for (int j = lane; j < l; j += 32) mrow[j] = 0;
  for (int s = lane; s < degree; s += 32)
    keep[row * degree + s] = s < cnt ? s_kept_id[s] : -1;
  __syncwarp();
  for (int s = lane; s < cnt; s += 32) mrow[s_pos[s_kept_t[s]]] = 1;
}

// The staged kept-row slots per warp: the most (at most degree) that let
// `warps_per_sm` warps share an SM; 0 if not even one fits beside the
// warp's lists.
int staged_slots(int degree, int l, int d, int per_sm, int reserved,
                 int warps_per_sm) {
  const int blocks = warps_per_sm / kStagedWarps;
  const size_t per_block = (size_t)per_sm / blocks - reserved;
  for (int s = degree; s > 0; --s)
    if (kStagedWarps * staged_warp_bytes(degree, l, d, s) <= per_block)
      return s;
  return 0;
}

}  // namespace repro_torch

// Variants (kernels/alpha_scan/alpha_scan.py names them): 0 warp, 1
// staged. Returns the first CUDA error, -1 for a shape the variant does not
// take (staged: vec4 rows of d <= 1024 whose lists leave room for a
// kept-row slot per warp).
extern "C" int alpha_scan_f32(const void* data, const void* node_ids,
                              const void* cand_ids, const void* cand_dists,
                              const void* alpha_rows, float alpha, void* keep,
                              void* mask, int b, int l, int degree, int n,
                              int d, int vec4, int variant, void* stream) {
  using namespace repro_torch;
  if (variant != 0 && variant != 1) return -1;
  if (b <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0) {
    const unsigned grid = (unsigned)((b + kScanWarps - 1) / kScanWarps);
    const size_t smem = (size_t)kScanWarps * degree * sizeof(int);
    by_lane_chunks(vec4 ? lane_chunks(d) : 0, [&](auto kk) {
      alpha_scan_kernel<decltype(kk)::value>
          <<<grid, kScanWarps * 32, smem, s>>>(
              (const float*)data, (const int*)node_ids,
              (const int*)cand_ids, (const float*)cand_dists,
              (const float*)alpha_rows, alpha, (int*)keep, (uint8_t*)mask,
              b, l, degree, n, d, vec4 != 0);
      return 0;
    });
    return (int)cudaGetLastError();
  }
  const int kk = lane_chunks(d);
  if (!vec4 || kk > kMaxLaneChunks) return -1;
  int dev = 0, per_sm = 0, reserved = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return (int)err;
  const int slots = staged_slots(degree, l, d, per_sm, reserved,
                                 kStagedWarpsPerSm);
  if (slots == 0) return -1;
  const size_t smem = kStagedWarps * staged_warp_bytes(degree, l, d, slots);
  const unsigned grid = (unsigned)((b + kStagedWarps - 1) / kStagedWarps);
  return by_lane_chunks(kk, [&](auto k_) {
    constexpr int kK = decltype(k_)::value;
    if constexpr (kK == 0) {
      return -1;
    } else {
      constexpr int kG = kK <= 5 ? 4 : 2;   // registers: kG + 2 rows
      auto kernel = alpha_scan_staged_kernel<kK, kG>;
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      kernel<<<grid, kStagedWarps * 32, smem, s>>>(
          (const float*)data, (const int*)node_ids, (const int*)cand_ids,
          (const float*)cand_dists, (const float*)alpha_rows, alpha,
          (int*)keep, (uint8_t*)mask, b, l, degree, n, d, slots);
      return (int)cudaGetLastError();
    }
  });
}
