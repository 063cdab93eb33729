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
// Design: one warp per (b, r) pair, 8 warps per block. A warp reads its row
// with coalesced float4 loads (600 floats = 150 float4, 5 per lane) through
// row_sqdist, the reduction beam_hop.cu shares, so the staged and fused hops
// agree bit for bit. Many independent warps in flight hide the latency of
// the random row gathers. Ids are clamped to the last row (as XLA clamps an
// out-of-range gather), so a bad id never reads outside db.
#include "common.cuh"

namespace repro_torch {

constexpr int kGatherWarps = 8;

__global__ void __launch_bounds__(kGatherWarps * 32)
gather_dist_kernel(const float* __restrict__ q, const float* __restrict__ db,
                   const int* __restrict__ ids, float* __restrict__ out,
                   int b, int r, int n, int d, bool vec4) {
  const long long pair =
      (long long)blockIdx.x * kGatherWarps + (threadIdx.x >> 5);
  if (pair >= (long long)b * r) return;
  const int row = (int)(pair / r);
  const int id = ids[pair];
  float dist = __int_as_float(0x7f800000);  // +inf
  if (id >= 0) {
    const long long x = (long long)min(id, n - 1) * d;
    dist = row_sqdist(q + (long long)row * d, db + x, d, vec4);
  }
  if ((threadIdx.x & 31) == 0) out[pair] = dist;
}

}  // namespace repro_torch

extern "C" int gather_dist_f32(const void* q, const void* db, const void* ids,
                               void* out, int b, int r, int n, int d,
                               int vec4, void* stream) {
  const long long pairs = (long long)b * r;
  if (pairs > 0) {
    const unsigned grid =
        (unsigned)((pairs + repro_torch::kGatherWarps - 1) /
                   repro_torch::kGatherWarps);
    repro_torch::gather_dist_kernel<<<grid, repro_torch::kGatherWarps * 32, 0,
                                      (cudaStream_t)stream>>>(
        (const float*)q, (const float*)db, (const int*)ids, (float*)out, b, r,
        n, d, vec4 != 0);
  }
  return (int)cudaGetLastError();
}
