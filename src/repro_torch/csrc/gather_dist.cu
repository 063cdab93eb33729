// gather_dist: out[b, r] = sum_d (q[b, d] - db[ids[b, r], d])^2, +inf for
// ids < 0.
//
// Replaces the TPU kernel src/repro/kernels/gather_dist/gather_dist.py,
// gather_dist_pallas (body _gather_dist_kernel), which pipelines one
// gathered row per grid step through a scalar-prefetch BlockSpec.
//
// Two modes of the sharded tier, either or both (the reference's
// ANN_BF16_BASE and ANN_PRENORM, src/repro/core/distributed.py): bf16 rows
// (db holds the bf16 bits, widened to f32 on load, exactly), and prenorm,
// out = max((|q|^2 + norms[id]) - 2 q.x, 0) with the (N,) norms kept at
// build time, the dot and |q|^2 summed in row_sqdist's lane order
// (common.cuh, kDot). The beam_hops loop scores rows the same way, so the
// pool it is seeded from here carries the bits its hops reproduce.
//
// Bound on an H100: the bytes of the gathered rows. At the staged hop
// (B=1024, R=32, D=600) that is 1024*32*600*4 B = 78.6 MB, about 23 us at
// 3.35 TB/s (bf16 rows: half); the arithmetic (3 flops per element) is far
// below the card's rate.
//
// Design: one warp per (b, slice of kGatherIds ids), 8 warps per block. The
// warp reads its ids with one load, writes +inf for the ids < 0 and loads
// no row for them, and scores the valid ones kGatherGroup at a time with
// rows_sqdist_vec4: the query's chunks stay in registers for the whole
// slice, and each lane has kGatherGroup rows' chunk loads in flight (20 at
// D=600) before it reduces any of them. The reduction is row_sqdist's, the
// one beam_hop.cu shares, so the staged and fused hops agree bit for bit.
// Rows that are not chunk-aligned or longer than 1024 elements go through
// row_sqdist one at a time (kK = 0). Ids are clamped to the last row (as
// XLA clamps an out-of-range gather), so a bad id never reads outside db.
#include "common.cuh"

namespace repro_torch {

constexpr int kGatherWarps = 8;
constexpr int kGatherIds = 8;     // ids per warp
constexpr int kGatherGroup = 4;   // rows whose loads are in flight together

// T: float or uint16_t (bf16 rows); kNorm: the prenorm distance over norms.
template <int kK, class T, bool kNorm>
__global__ void __launch_bounds__(kGatherWarps * 32)
gather_dist_kernel(const float* __restrict__ q, const T* __restrict__ db,
                   const int* __restrict__ ids,
                   const float* __restrict__ norms, float* __restrict__ out,
                   int b, int r, int n, int d, bool vec4) {
  const int lane = threadIdx.x & 31;
  const int slices = (r + kGatherIds - 1) / kGatherIds;
  const long long task =
      (long long)blockIdx.x * kGatherWarps + (threadIdx.x >> 5);
  if (task >= (long long)b * slices) return;
  const int row = (int)(task / slices);
  const int j0 = (int)(task % slices) * kGatherIds;
  const int cnt_all = min(kGatherIds, r - j0);
  const long long at = (long long)row * r + j0;
  const int id = lane < cnt_all ? ids[at + lane] : -1;
  if (lane < cnt_all && id < 0) out[at + lane] = __int_as_float(0x7f800000);
  unsigned valid = __ballot_sync(kFullMask, id >= 0);   // warp-uniform
  const float* qrow = q + (long long)row * d;

  if constexpr (kK == 0) {
    const float qn = kNorm ? row_sqdist<true>(qrow, qrow, d, vec4) : 0.f;
    while (valid) {
      const int j = __ffs(valid) - 1;
      valid &= valid - 1;
      const int idj = min(__shfl_sync(kFullMask, id, j), n - 1);
      float dist = row_sqdist<kNorm>(qrow, db + (long long)idj * d, d, vec4);
      if constexpr (kNorm) dist = prenorm_dist(qn, __ldg(norms + idj), dist);
      if (lane == 0) out[at + j] = dist;
    }
  } else {
    const int n_chunks = d >> 2;
    const float4* q4 = reinterpret_cast<const float4*>(qrow);
    float4 qv[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int c = lane + 32 * k;
      qv[k] = c < n_chunks ? __ldg(q4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float qn = 0.f;
    if constexpr (kNorm) {
      float self[1];
      sqdist_chunks<kK, 1, true>([&](int k) { return qv[k]; },
                                 [&](int, int k) { return qv[k]; }, n_chunks,
                                 self);
      qn = self[0];
    }
    while (valid) {
      const T* rows[kGatherGroup];
      int ids_g[kGatherGroup];
      int js[kGatherGroup];
      int cnt = 0;
#pragma unroll
      for (int g = 0; g < kGatherGroup; ++g) {
        js[g] = 0;
        ids_g[g] = 0;
        rows[g] = db;
        if (valid) {
          const int j = __ffs(valid) - 1;
          valid &= valid - 1;
          const int idj = min(__shfl_sync(kFullMask, id, j), n - 1);
          js[g] = j;
          ids_g[g] = idj;
          rows[g] = db + (long long)idj * d;
          cnt = g + 1;
        }
      }
      float dist[kGatherGroup];
      rows_sqdist_vec4<kK, kGatherGroup, kNorm>([&](int k) { return qv[k]; },
                                                rows, cnt, n_chunks, dist);
      if (lane == 0) {
#pragma unroll
        for (int g = 0; g < kGatherGroup; ++g) {
          if (g < cnt) {
            out[at + js[g]] =
                kNorm ? prenorm_dist(qn, __ldg(norms + ids_g[g]), dist[g])
                      : dist[g];
          }
        }
      }
    }
  }
}

}  // namespace repro_torch

// db: f32 rows, or bf16 rows (bf16 != 0; their bits). norms: the (N,)
// |x|^2 of the prenorm distance, or null for the diff-square form.
extern "C" int gather_dist_rows(const void* q, const void* db,
                                const void* ids, const void* norms,
                                void* out, int b, int r, int n, int d,
                                int vec4, int bf16, void* stream) {
  using namespace repro_torch;
  const long long warps = (long long)b * ((r + kGatherIds - 1) / kGatherIds);
  if (warps <= 0) return (int)cudaGetLastError();
  const unsigned grid = (unsigned)((warps + kGatherWarps - 1) / kGatherWarps);
  const auto launch = [&](auto row, auto norm) {
    using T = decltype(row);
    constexpr bool kNorm = decltype(norm)::value;
    return by_lane_chunks(vec4 ? lane_chunks(d) : 0, [&](auto kk) {
      gather_dist_kernel<decltype(kk)::value, T, kNorm>
          <<<grid, kGatherWarps * 32, 0, (cudaStream_t)stream>>>(
              (const float*)q, (const T*)db, (const int*)ids,
              (const float*)norms, (float*)out, b, r, n, d, vec4 != 0);
      return 0;
    });
  };
  using Plain = std::false_type;
  using Norm = std::true_type;
  if (bf16)
    norms ? launch(uint16_t{}, Norm{}) : launch(uint16_t{}, Plain{});
  else
    norms ? launch(0.f, Norm{}) : launch(0.f, Plain{});
  return (int)cudaGetLastError();
}
