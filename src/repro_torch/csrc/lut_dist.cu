// lut_dist: out[q, r] = sum_m lut[q, m, codes[ids[q, r], m]], added left to
// right over m; +inf for ids < 0.
//
// Replaces the TPU kernel src/repro/kernels/lut_dist/lut_dist.py,
// lut_dist_pallas (body _lut_dist_kernel), which keeps one query's LUT
// block in VMEM across the R gathered code rows and picks entries with a
// one-hot select.
//
// Bound on an H100: bytes. At the staged hop (Q=1024, R=32, M=300, C=256)
// the code rows are Q*R*M = 9.8 MB and the LUT entries looked up at most
// 4 B each, 39.3 MB: ~49 MB, ~15 us at 3.35 TB/s (M=600, int8: ~29 us).
// A lookup touches a 32 B sector, so the sector traffic is several times
// that. The adds (Q*R*M) are far below the card's rate.
//
// Design: one thread per (q, r), 128 threads per block, so a warp holds 32
// candidates of one query and its lookups of sub-space m fall in one 1 KB
// sub-table. Each thread runs lut_row_sum (the routine beam_hop.cu's LUT
// mode shares): the serial left-to-right sum is the exactness contract, so
// there is no reduction across threads. A query's whole LUT (300-600 KB)
// exceeds a block's 227 KB of shared memory, so entries are read from
// device memory through the read-only path; the loop is unrolled four
// times, so up to 16 independent lookups can be in flight per thread. Ids
// are clamped to the last row, so a bad id never reads outside codes.
#include "common.cuh"

namespace repro_torch {

constexpr int kLutThreads = 128;

__global__ void __launch_bounds__(kLutThreads)
lut_dist_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
                const int* __restrict__ ids, float* __restrict__ out, int q,
                int r, int n, int m, int c, bool vec4) {
  const long long pair = (long long)blockIdx.x * kLutThreads + threadIdx.x;
  if (pair >= (long long)q * r) return;
  const int row = (int)(pair / r);
  const int id = ids[pair];
  float dist = __int_as_float(0x7f800000);  // +inf
  if (id >= 0)
    dist = lut_row_sum(codes + (long long)min(id, n - 1) * m,
                       lut + (long long)row * m * c, m, c, vec4);
  out[pair] = dist;
}

}  // namespace repro_torch

extern "C" int lut_dist_f32(const void* lut, const void* codes, const void* ids,
                            void* out, int q, int r, int n, int m, int c,
                            int vec4, void* stream) {
  const long long pairs = (long long)q * r;
  if (pairs > 0) {
    const unsigned grid = (unsigned)((pairs + repro_torch::kLutThreads - 1) /
                                     repro_torch::kLutThreads);
    repro_torch::lut_dist_kernel<<<grid, repro_torch::kLutThreads, 0,
                                   (cudaStream_t)stream>>>(
        (const float*)lut, (const uint8_t*)codes, (const int*)ids, (float*)out,
        q, r, n, m, c, vec4 != 0);
  }
  return (int)cudaGetLastError();
}
