// gather_dist: out[b, r] = sum_d (q[b, d] - db[ids[b, r], d])^2, +inf for
// ids < 0.
//
// Replaces the TPU kernel src/repro/kernels/gather_dist/gather_dist.py,
// gather_dist_pallas (body _gather_dist_kernel), which pipelines one
// gathered row per grid step through a scalar-prefetch BlockSpec.
//
// Bound on an H100: the bytes of the gathered rows. At the staged hop
// (B=1024, R=32, D=600) that is 1024*32*600*4 B = 78.6 MB, about 23 us at
// 3.35 TB/s; the arithmetic (3 flops per element) is far below the card's
// rate.
//
// Design: one warp per (b, slice of kGatherIds ids), 8 warps per block. The
// warp reads its ids with one load, writes +inf for the ids < 0 and loads
// no row for them, and scores the valid ones kGatherGroup at a time with
// rows_sqdist_vec4: the query's chunks stay in registers for the whole
// slice, and each lane has kGatherGroup rows' float4 loads in flight (20 at
// D=600) before it reduces any of them. The reduction is row_sqdist's, the
// one beam_hop.cu shares, so the staged and fused hops agree bit for bit.
// Rows that are not float4-aligned or longer than 1024 floats go through
// row_sqdist one at a time (kK = 0). Ids are clamped to the last row (as
// XLA clamps an out-of-range gather), so a bad id never reads outside db.
#include "common.cuh"

namespace repro_torch {

constexpr int kGatherWarps = 8;
constexpr int kGatherIds = 8;     // ids per warp
constexpr int kGatherGroup = 4;   // rows whose loads are in flight together

template <int kK>
__global__ void __launch_bounds__(kGatherWarps * 32)
gather_dist_kernel(const float* __restrict__ q, const float* __restrict__ db,
                   const int* __restrict__ ids, float* __restrict__ out,
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
    while (valid) {
      const int j = __ffs(valid) - 1;
      valid &= valid - 1;
      const int idj = __shfl_sync(kFullMask, id, j);
      const float dist =
          row_sqdist(qrow, db + (long long)min(idj, n - 1) * d, d, vec4);
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
    while (valid) {
      const float* rows[kGatherGroup];
      int js[kGatherGroup];
      int cnt = 0;
#pragma unroll
      for (int g = 0; g < kGatherGroup; ++g) {
        js[g] = 0;
        rows[g] = db;
        if (valid) {
          const int j = __ffs(valid) - 1;
          valid &= valid - 1;
          const int idj = __shfl_sync(kFullMask, id, j);
          js[g] = j;
          rows[g] = db + (long long)min(idj, n - 1) * d;
          cnt = g + 1;
        }
      }
      float dist[kGatherGroup];
      rows_sqdist_vec4<kK, kGatherGroup>([&](int k) { return qv[k]; }, rows,
                                         cnt, n_chunks, dist);
      if (lane == 0) {
#pragma unroll
        for (int g = 0; g < kGatherGroup; ++g)
          if (g < cnt) out[at + js[g]] = dist[g];
      }
    }
  }
}

}  // namespace repro_torch

extern "C" int gather_dist_f32(const void* q, const void* db, const void* ids,
                               void* out, int b, int r, int n, int d,
                               int vec4, void* stream) {
  using namespace repro_torch;
  const long long warps = (long long)b * ((r + kGatherIds - 1) / kGatherIds);
  if (warps > 0) {
    const unsigned grid =
        (unsigned)((warps + kGatherWarps - 1) / kGatherWarps);
    by_lane_chunks(vec4 ? lane_chunks(d) : 0, [&](auto kk) {
      gather_dist_kernel<decltype(kk)::value>
          <<<grid, kGatherWarps * 32, 0, (cudaStream_t)stream>>>(
              (const float*)q, (const float*)db, (const int*)ids,
              (float*)out, b, r, n, d, vec4 != 0);
      return 0;
    });
  }
  return (int)cudaGetLastError();
}
