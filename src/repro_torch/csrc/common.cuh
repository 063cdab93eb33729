// Device routines shared by the port's hand-written Hopper kernels.
//
// row_sqdist is the one squared-L2 reduction that gather_dist.cu and
// beam_hop.cu both call, so the fused hop (beam_hop) and the staged hop
// (gather_dist + a PyTorch merge) produce the same bits on the card. The
// sort helpers give the kernels that merge pools (beam_hop, topk_merge) an
// exact stable order: every key is unique because its low bits hold the
// element's position.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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
