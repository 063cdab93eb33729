// Device routines shared by the port's hand-written Hopper kernels.
//
// row_sqdist, and rows_sqdist_vec4 and sqdist_chunks which reduce several
// rows the same way (with their loads in flight together, or from chunks
// the caller holds), are the one squared-L2 reduction that gather_dist.cu,
// beam_hop.cu and alpha_scan.cu call, so the fused hop (beam_hop) and the
// staged hop (gather_dist + a PyTorch merge) produce the same bits on the
// card, and the α-scan's kernels those of its plain loop over gather_dist;
// lut_row_sum is its counterpart for quantized codes, shared by lut_dist.cu
// and beam_hop.cu's LUT mode in the same way. The
// sort helpers give the kernels that merge pools (beam_hop, topk_merge) an
// exact stable order: every key is unique because its low bits hold the
// element's position.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro_torch {

constexpr unsigned kFullMask = 0xffffffffu;

// Sum over e < d of (q[e] - x[e])^2, reduced by one warp; every lane
// returns the same bits.
//
// Lane l takes the 4-element chunks c = l, l + 32, l + 64, ... in order and
// accumulates (q - x)^2 with explicit round-to-nearest subtract and fused
// multiply-add, so the compiler cannot reassociate or contract differently
// in different kernels. The lanes are then combined by a fixed xor-shuffle
// tree. With vec4 (d % 4 == 0 and both rows 16-byte aligned) a chunk is one
// float4 load; otherwise it is read element by element, in the same order,
// so the result does not depend on alignment.
__device__ __forceinline__ float row_sqdist(const float* __restrict__ q,
                                            const float* __restrict__ x,
                                            int d, bool vec4) {
  const int lane = threadIdx.x & 31;
  const int n_chunks = (d + 3) >> 2;
  float acc = 0.f;
  if (vec4) {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int c = lane; c < n_chunks; c += 32) {
      const float4 a = __ldg(q4 + c);
      const float4 b = __ldg(x4 + c);
      float t;
      t = __fsub_rn(a.x, b.x); acc = __fmaf_rn(t, t, acc);
      t = __fsub_rn(a.y, b.y); acc = __fmaf_rn(t, t, acc);
      t = __fsub_rn(a.z, b.z); acc = __fmaf_rn(t, t, acc);
      t = __fsub_rn(a.w, b.w); acc = __fmaf_rn(t, t, acc);
    }
  } else {
    for (int c = lane; c < n_chunks; c += 32) {
      const int end = min(4 * c + 4, d);
      for (int e = 4 * c; e < end; ++e) {
        const float t = __fsub_rn(__ldg(q + e), __ldg(x + e));
        acc = __fmaf_rn(t, t, acc);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(kFullMask, acc, off));
  return acc;
}

// Largest per-lane chunk count rows_sqdist_vec4 is instantiated for: rows
// of d <= 4 * 32 * kMaxLaneChunks floats (1024) take it; longer rows, and
// rows that are not float4-aligned, go through row_sqdist one at a time.
constexpr int kMaxLaneChunks = 8;

// Lane chunk count of a float4 row of d floats: ceil(ceil(d / 4) / 32).
__host__ __device__ __forceinline__ int lane_chunks(int d) {
  return ((d + 3) / 4 + 31) / 32;
}

// The arithmetic of row_sqdist on float4 chunks the caller already has at
// hand, for kG rows of one query at once, by one warp: lane l adds its
// chunks c = l, l + 32, ... of each row in order with the same
// round-to-nearest subtract and fused multiply-add, and the lanes combine
// by the same xor tree, so out[g] has row_sqdist's bits. qchunk(k) returns
// the query's chunk lane + 32 k and xchunk(g, k) row g's (from registers or
// shared memory, as the caller keeps them); neither is called for a chunk
// at or past n_chunks. kK is the caller's lane_chunks(d) or more.
template <int kK, int kG, class QChunk, class XChunk>
__device__ __forceinline__ void sqdist_chunks(QChunk qchunk, XChunk xchunk,
                                              int n_chunks,
                                              float (&out)[kG]) {
  const int lane = threadIdx.x & 31;
  float acc[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) acc[g] = 0.f;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    if (lane + 32 * k < n_chunks) {
      const float4 a = qchunk(k);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float4 b = xchunk(g, k);
        float t;
        t = __fsub_rn(a.x, b.x); acc[g] = __fmaf_rn(t, t, acc[g]);
        t = __fsub_rn(a.y, b.y); acc[g] = __fmaf_rn(t, t, acc[g]);
        t = __fsub_rn(a.z, b.z); acc[g] = __fmaf_rn(t, t, acc[g]);
        t = __fsub_rn(a.w, b.w); acc[g] = __fmaf_rn(t, t, acc[g]);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int g = 0; g < kG; ++g)
      acc[g] = __fadd_rn(acc[g], __shfl_xor_sync(kFullMask, acc[g], off));
  }
#pragma unroll
  for (int g = 0; g < kG; ++g) out[g] = acc[g];
}

// row_sqdist over up to kG rows of one query at once, by one warp, float4
// rows only (d % 4 == 0, 16-byte aligned). All cnt rows' loads are issued
// before any row is reduced, kG * kK float4 per lane in flight instead of
// row_sqdist's one; then sqdist_chunks reduces them. So out[g] has
// row_sqdist's bits, and every kernel that scores rows through either
// function agrees with every other.
//
// kK is the caller's lane_chunks(d) or more; qchunk(k) returns the query's
// chunk lane + 32 k (from registers or shared memory, as the caller keeps
// it). Rows g >= cnt are not read and out[g] is then meaningless.
template <int kK, int kG, class QChunk>
__device__ __forceinline__ void rows_sqdist_vec4(QChunk qchunk,
                                                 const float* const (&rows)[kG],
                                                 int cnt, int n_chunks,
                                                 float (&out)[kG]) {
  const int lane = threadIdx.x & 31;
  float4 x[kG][kK];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const float4* r4 = reinterpret_cast<const float4*>(rows[g]);
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int c = lane + 32 * k;
      x[g][k] = (g < cnt && c < n_chunks) ? __ldg(r4 + c)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  sqdist_chunks<kK, kG>(qchunk, [&](int g, int k) { return x[g][k]; },
                        n_chunks, out);
}

// Calls fn(std::integral_constant<int, kK>) with kK = kk for 1 <= kk <=
// kMaxLaneChunks and kK = 0 otherwise: the host's choice of a
// rows_sqdist_vec4 instantiation (0: the row_sqdist path).
template <class Fn>
int by_lane_chunks(int kk, Fn&& fn) {
  switch (kk) {
    case 1: return fn(std::integral_constant<int, 1>{});
    case 2: return fn(std::integral_constant<int, 2>{});
    case 3: return fn(std::integral_constant<int, 3>{});
    case 4: return fn(std::integral_constant<int, 4>{});
    case 5: return fn(std::integral_constant<int, 5>{});
    case 6: return fn(std::integral_constant<int, 6>{});
    case 7: return fn(std::integral_constant<int, 7>{});
    case 8: return fn(std::integral_constant<int, 8>{});
    default: return fn(std::integral_constant<int, 0>{});
  }
}

// Asymmetric (LUT) distance of one code row: sum over m < M of
// lut[m * C + code[m]], added strictly from m = 0 upwards with
// round-to-nearest adds — the reference's left-to-right order, so every
// kernel that calls this equals the plain version bit for bit. One thread
// computes the whole sum (a warp reduction would reassociate it).
//
// The sum starts from -0.0, which x + -0.0 leaves unchanged for every x
// (+0.0 included), so the result is lut[code[0]] + lut[C + code[1]] + ...
// exactly. Codes above C - 1 read entry C - 1. With vec4 (M % 4 == 0 and
// the row 4-byte aligned) the code row is read as uchar4, four codes per
// load, in the same order. LUT entries go through the read-only path; they
// are gathered from device memory (one query's table, M * C * 4 bytes, is
// 300 KB at M = 300 and does not fit in shared memory).
__device__ __forceinline__ float lut_row_sum(const uint8_t* __restrict__ code,
                                             const float* __restrict__ lut,
                                             int m, int c, bool vec4) {
  const int top = c - 1;
  float acc = -0.0f;
  if (vec4) {
    const uchar4* code4 = reinterpret_cast<const uchar4*>(code);
    const int n4 = m >> 2;
#pragma unroll 4
    for (int i = 0; i < n4; ++i) {
      const uchar4 v = __ldg(code4 + i);
      const float* t = lut + (long long)(4 * i) * c;
      const float a = __ldg(t + min((int)v.x, top));
      const float b = __ldg(t + c + min((int)v.y, top));
      const float e = __ldg(t + 2 * c + min((int)v.z, top));
      const float f = __ldg(t + 3 * c + min((int)v.w, top));
      acc = __fadd_rn(acc, a);
      acc = __fadd_rn(acc, b);
      acc = __fadd_rn(acc, e);
      acc = __fadd_rn(acc, f);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < m; ++i)
      acc = __fadd_rn(acc, __ldg(lut + (long long)i * c +
                                 min((int)__ldg(code + i), top)));
  }
  return acc;
}

// Order-preserving map of a float onto uint32 (-0.0 counts as +0.0, so
// ties between the two zeros fall to the position bits, as in a stable
// argsort). NaN is not expected.
__device__ __forceinline__ uint32_t float_key(float f) {
  const uint32_t b = __float_as_uint(__fadd_rn(f, 0.0f));
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Ascending bitonic sort of p (a power of two) unique 64-bit keys in
// shared memory by the whole block. Starts and ends with a barrier.
__device__ __forceinline__ void block_sort(unsigned long long* keys, int p) {
  __syncthreads();
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p; i += blockDim.x) {
        const int partner = i ^ j;
        if (partner > i) {
          const unsigned long long a = keys[i];
          const unsigned long long b = keys[partner];
          const bool ascending = (i & k) == 0;
          if ((a > b) == ascending) {
            keys[i] = b;
            keys[partner] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace repro_torch
