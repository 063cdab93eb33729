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
// that. The adds (Q*R*M) are far below the card's rate. At the pool seed
// (R=1) the entries are 1.2 / 2.5 MB (bound 0.46 / 0.92 us) and the
// sectors 9.8 / 19.7 MB (~3 / ~6 us).
//
// The sum is one left-to-right chain of round-to-nearest adds from -0.0
// (common.cuh, lut_row_sum): the exactness contract beam_hop.cu's LUT
// mode shares, so there is no reduction across threads. A query's whole
// LUT (300-600 KB) exceeds a block's 227 KB of shared memory, so entries
// are read from device memory through the read-only path. Ids are clamped
// to the last row, so a bad id never reads outside codes. Two variants
// (kernels/lut_dist/lut_dist.py: route, by the number of pairs Q*R):
//
// thread (many pairs): one thread per (q, r), 128 threads per block, so a
//   warp holds 32 candidates of one query and its lookups of sub-space m
//   fall in one 1 KB sub-table. Each thread runs lut_row_sum, unrolled four
//   times, so up to 16 independent lookups are in flight per thread.
// warp (few pairs, the pool seed's Q x 1): one warp per (q, r), so 1,024
//   pairs are 1,024 warps over every SM instead of 8 blocks. Lane l reads
//   the codes of m = l, l + 32, ... (uchar4 groups where the rows allow)
//   and issues all of its lookups of a chunk of kLutChunk sub-spaces before
//   using any; they land in a per-warp staging buffer in shared memory,
//   and lane 0 then adds the chunk in m order onto the running sum. The
//   loads are independent; the adds are the only dependent chain.
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

constexpr int kLutWarps = 8;             // pairs (warps) per block
constexpr int kLutGather = 32;           // lookups per lane per chunk
constexpr int kLutChunk = 32 * kLutGather;   // sub-spaces per chunk

__global__ void __launch_bounds__(kLutWarps * 32)
lut_dist_warp_kernel(const float* __restrict__ lut,
                     const uint8_t* __restrict__ codes,
                     const int* __restrict__ ids, float* __restrict__ out,
                     int q, int r, int n, int m, int c, bool vec4) {
  __shared__ __align__(16) float stage[kLutWarps][kLutChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long pair = (long long)blockIdx.x * kLutWarps + warp;
  if (pair >= (long long)q * r) return;  // the whole warp
  const int id = ids[pair];
  if (id < 0) {
    if (lane == 0) out[pair] = __int_as_float(0x7f800000);   // +inf
    return;
  }
  const uint8_t* code = codes + (long long)min(id, n - 1) * m;
  const float* t = lut + (long long)(pair / r) * m * c;
  const int top = c - 1;
  float* s = stage[warp];
  float acc = -0.0f;
  for (int base = 0; base < m; base += kLutChunk) {
    const int len = min(kLutChunk, m - base);
    float v[kLutGather];
    if (vec4) {                          // M % 4 == 0: whole uchar4 groups
      const uchar4* code4 = reinterpret_cast<const uchar4*>(code + base);
#pragma unroll
      for (int g = 0; g < kLutGather / 4; ++g) {
        const int i = 4 * (lane + 32 * g);           // within the chunk
        if (i < len) {
          const uchar4 cv = __ldg(code4 + lane + 32 * g);
          const float* e = t + (long long)(base + i) * c;
          v[4 * g] = __ldg(e + min((int)cv.x, top));
          v[4 * g + 1] = __ldg(e + c + min((int)cv.y, top));
          v[4 * g + 2] = __ldg(e + 2 * c + min((int)cv.z, top));
          v[4 * g + 3] = __ldg(e + 3 * c + min((int)cv.w, top));
        }
      }
#pragma unroll
      for (int g = 0; g < kLutGather / 4; ++g) {
        const int i = 4 * (lane + 32 * g);
        if (i < len)
          *reinterpret_cast<float4*>(s + i) = make_float4(
              v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]);
      }
    } else {
#pragma unroll
      for (int g = 0; g < kLutGather; ++g) {
        const int i = lane + 32 * g;
        if (i < len)
          v[g] = __ldg(t + (long long)(base + i) * c +
                       min((int)__ldg(code + base + i), top));
      }
#pragma unroll
      for (int g = 0; g < kLutGather; ++g) {
        const int i = lane + 32 * g;
        if (i < len) s[i] = v[g];
      }
    }
    __syncwarp();
    if (lane == 0) {
      const float4* s4 = reinterpret_cast<const float4*>(s);
      const int n4 = len >> 2;
#pragma unroll 8
      for (int i = 0; i < n4; ++i) {
        const float4 x = s4[i];
        acc = __fadd_rn(acc, x.x);
        acc = __fadd_rn(acc, x.y);
        acc = __fadd_rn(acc, x.z);
        acc = __fadd_rn(acc, x.w);
      }
      for (int i = 4 * n4; i < len; ++i) acc = __fadd_rn(acc, s[i]);
    }
    __syncwarp();
  }
  if (lane == 0) out[pair] = acc;
}

}  // namespace repro_torch

// variant: 0 thread, 1 warp.
extern "C" int lut_dist_f32(const void* lut, const void* codes, const void* ids,
                            void* out, int q, int r, int n, int m, int c,
                            int vec4, int variant, void* stream) {
  using namespace repro_torch;
  const long long pairs = (long long)q * r;
  if (pairs > 0) {
    const int per_block = variant == 1 ? kLutWarps : kLutThreads;
    const unsigned grid = (unsigned)((pairs + per_block - 1) / per_block);
    if (variant == 1)
      lut_dist_warp_kernel<<<grid, kLutWarps * 32, 0, (cudaStream_t)stream>>>(
          (const float*)lut, (const uint8_t*)codes, (const int*)ids,
          (float*)out, q, r, n, m, c, vec4 != 0);
    else
      lut_dist_kernel<<<grid, kLutThreads, 0, (cudaStream_t)stream>>>(
          (const float*)lut, (const uint8_t*)codes, (const int*)ids,
          (float*)out, q, r, n, m, c, vec4 != 0);
  }
  return (int)cudaGetLastError();
}
