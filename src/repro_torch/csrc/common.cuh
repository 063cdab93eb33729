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
//
// The row reductions take two options, for the sharded tier's modes:
// rows of bf16 (T = uint16_t, the bf16 bits), widened to f32 on load, which
// is exact; and kDot, which sums q[e] * x[e] instead of (q[e] - x[e])^2 in
// the same lane-chunk order and xor tree, for the prenorm distance
// max(|q|^2 + |x|^2 - 2 q.x, 0) (prenorm_dist). The plain versions
// (kernels/gather_dist/ref.py, lanes_reduce) follow that order step by
// step, so kernel and plain version agree bit for bit in every mode.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro_torch {

constexpr unsigned kFullMask = 0xffffffffu;

// One element of a row as f32: a float as is, a bf16 (its bits in a
// uint16_t) widened exactly.
__device__ __forceinline__ float row_elem(const float* __restrict__ x,
                                          int e) {
  return __ldg(x + e);
}

__device__ __forceinline__ float row_elem(const uint16_t* __restrict__ x,
                                          int e) {
  return __uint_as_float((uint32_t)__ldg(x + e) << 16);
}

// Chunk c (elements 4c .. 4c + 3) of a row as it is stored: one 16-byte
// float4 of f32, one 8-byte uint2 of bf16 (RawChunk<T>); widen() makes
// the float4 of either (bf16: exactly). row_chunk does both. The row must
// be aligned to the chunk's size (16 or 8 bytes).
template <class T> struct RawChunk;
template <> struct RawChunk<float> { using type = float4; };
template <> struct RawChunk<uint16_t> { using type = uint2; };

__device__ __forceinline__ float4 load_chunk_raw(const float* __restrict__ x,
                                                 int c) {
  return __ldg(reinterpret_cast<const float4*>(x) + c);
}

__device__ __forceinline__ uint2 load_chunk_raw(
    const uint16_t* __restrict__ x, int c) {
  return __ldg(reinterpret_cast<const uint2*>(x) + c);
}

__device__ __forceinline__ float4 widen(float4 v) { return v; }

__device__ __forceinline__ float4 widen(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

template <class T>
__device__ __forceinline__ float4 row_chunk(const T* __restrict__ x, int c) {
  return widen(load_chunk_raw(x, c));
}

// acc + (a - b)^2 (kDot: acc + a * b), the subtract and the fused
// multiply-add each rounded to nearest.
template <bool kDot>
__device__ __forceinline__ float lane_step(float acc, float a, float b) {
  if constexpr (kDot) {
    return __fmaf_rn(a, b, acc);
  } else {
    const float t = __fsub_rn(a, b);
    return __fmaf_rn(t, t, acc);
  }
}

template <bool kDot>
__device__ __forceinline__ float lane_step4(float acc, float4 a, float4 b) {
  acc = lane_step<kDot>(acc, a.x, b.x);
  acc = lane_step<kDot>(acc, a.y, b.y);
  acc = lane_step<kDot>(acc, a.z, b.z);
  return lane_step<kDot>(acc, a.w, b.w);
}

// Sum over e < d of (q[e] - x[e])^2 (kDot: of q[e] * x[e]), reduced by one
// warp; every lane returns the same bits.
//
// Lane l takes the 4-element chunks c = l, l + 32, l + 64, ... in order and
// accumulates with explicit round-to-nearest subtract and fused
// multiply-add (lane_step), so the compiler cannot reassociate or contract
// differently in different kernels. The lanes are then combined by a fixed
// xor-shuffle tree. With vec4 (d % 4 == 0 and both rows aligned to their
// chunks) a chunk is one load; otherwise it is read element by element, in
// the same order, so the result does not depend on alignment. x holds f32
// or bf16 (T = uint16_t) elements.
template <bool kDot = false, class T>
__device__ __forceinline__ float row_sqdist(const float* __restrict__ q,
                                            const T* __restrict__ x,
                                            int d, bool vec4) {
  const int lane = threadIdx.x & 31;
  const int n_chunks = (d + 3) >> 2;
  float acc = 0.f;
  if (vec4) {
    for (int c = lane; c < n_chunks; c += 32)
      acc = lane_step4<kDot>(acc, row_chunk(q, c), row_chunk(x, c));
  } else {
    for (int c = lane; c < n_chunks; c += 32) {
      const int end = min(4 * c + 4, d);
      for (int e = 4 * c; e < end; ++e)
        acc = lane_step<kDot>(acc, __ldg(q + e), row_elem(x, e));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(kFullMask, acc, off));
  return acc;
}

// The prenorm distance of a row from its dot with the query, the query's
// |q|^2 (qn: row_sqdist<true> of q with itself) and the row's |x|^2 kept
// at build time: max((qn + norm) - 2 * dot, 0), as the reference writes it
// (2 * dot is exact).
__device__ __forceinline__ float prenorm_dist(float qn, float norm,
                                              float dot) {
  return fmaxf(__fsub_rn(__fadd_rn(qn, norm), __fmul_rn(2.f, dot)), 0.f);
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
template <int kK, int kG, bool kDot = false, class QChunk, class XChunk>
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
      for (int g = 0; g < kG; ++g)
        acc[g] = lane_step4<kDot>(acc[g], a, xchunk(g, k));
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

// row_sqdist over up to kG rows of one query at once, by one warp, chunked
// rows only (d % 4 == 0, each row aligned to its chunks). All cnt rows'
// loads are issued before any row is reduced, kG * kK chunks per lane in
// flight instead of row_sqdist's one; then sqdist_chunks reduces them. So
// out[g] has row_sqdist's bits, and every kernel that scores rows through
// either function agrees with every other. Rows are f32 or bf16 (T =
// uint16_t: held as loaded, 8 bytes a chunk, and widened as each chunk is
// reduced); kDot as in row_sqdist.
//
// kK is the caller's lane_chunks(d) or more; qchunk(k) returns the query's
// chunk lane + 32 k (from registers or shared memory, as the caller keeps
// it). Rows g >= cnt are not read and out[g] is then meaningless.
template <int kK, int kG, bool kDot = false, class QChunk, class T>
__device__ __forceinline__ void rows_sqdist_vec4(QChunk qchunk,
                                                 const T* const (&rows)[kG],
                                                 int cnt, int n_chunks,
                                                 float (&out)[kG]) {
  const int lane = threadIdx.x & 31;
  // the chunks as stored (bf16: half the registers), widened as reduced
  using Raw = typename RawChunk<T>::type;
  Raw x[kG][kK];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int c = lane + 32 * k;
      x[g][k] = (g < cnt && c < n_chunks) ? load_chunk_raw(rows[g], c)
                                          : Raw{};
    }
  }
  sqdist_chunks<kK, kG, kDot>(
      qchunk, [&](int g, int k) { return widen(x[g][k]); }, n_chunks, out);
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
