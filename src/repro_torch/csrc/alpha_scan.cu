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
// Same bits as the plain version on the card: each d(q, r) is row_sqdist's
// reduction (common.cuh, through rows_sqdist_vec4 on float4 rows) with the
// candidate row as the query operand and the kept row as the database row,
// which is the plain version's gather_dist(data[q], data, keep) call; the
// threshold is one f32 product __fmul_rn(alpha, dq) (torch rounds a Python
// float alpha to f32 first, as the wrapper passes it) and the test a strict
// <. The tests' order cannot change the result (ok is their conjunction),
// so the kernel exits early where it may: -1, self and duplicate candidates
// cost no distance, the kept rows are tested in order until the first that
// occludes, and once `degree` ids are kept every later position is false
// without work.
//
// Bound on an H100: the bytes of the candidate rows a chunk touches. At the
// prune stage (B = 2048, L = 64, D = 600) the distinct valid candidates are
// ~10^5 rows, ~0.25 GB, ~0.07 ms at 3.35 TB/s; the distances (3 flops per
// element, ~10^6 of them) take ~0.03 ms at the f32 rate.
//
// Design (simple first): one warp per row, kScanWarps rows per block. The
// warp reads its row's candidates 32 at a time (one id and one distance per
// lane, shuffled to the warp in order) and writes 32 mask bytes at once;
// its kept ids stay in shared memory, its kept rows are read through the
// L2, kScanGroup at a time with their loads in flight together, against the
// candidate row held in registers. Rows that are not float4-aligned or
// longer than 1024 floats take row_sqdist one kept row at a time (kK = 0).
// Ids are clamped to the last row, as gather_dist clamps them.
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

}  // namespace repro_torch

extern "C" int alpha_scan_f32(const void* data, const void* node_ids,
                              const void* cand_ids, const void* cand_dists,
                              const void* alpha_rows, float alpha, void* keep,
                              void* mask, int b, int l, int degree, int n,
                              int d, int vec4, void* stream) {
  using namespace repro_torch;
  if (b > 0) {
    const unsigned grid = (unsigned)((b + kScanWarps - 1) / kScanWarps);
    const size_t smem = (size_t)kScanWarps * degree * sizeof(int);
    by_lane_chunks(vec4 ? lane_chunks(d) : 0, [&](auto kk) {
      alpha_scan_kernel<decltype(kk)::value>
          <<<grid, kScanWarps * 32, smem, (cudaStream_t)stream>>>(
              (const float*)data, (const int*)node_ids,
              (const int*)cand_ids, (const float*)cand_dists,
              (const float*)alpha_rows, alpha, (int*)keep, (uint8_t*)mask,
              b, l, degree, n, d, vec4 != 0);
      return 0;
    });
  }
  return (int)cudaGetLastError();
}
