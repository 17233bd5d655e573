// Shared unpack + dequant core of the dequant-matmul kernels.
//
// Storage (as in the JAX package): codes are uint8 [K/cpb, N] with code t of
// byte row r at logical row r*cpb + t; scale and zero are [K/g, N].  The
// weight is w = code * scale + zero, computed in f32 and rounded to the
// activation dtype (bf16) before it is multiplied, as the Pallas kernels'
// _dequant_block does (src/repro/kernels/qmatmul.py:44).  Products of two
// bf16 values are exact in f32, so only the order of the f32 sums differs
// from the plain PyTorch version.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace qdq {

typedef __nv_bfloat16 bf16;

template <int BITS>
struct Pack {
  static constexpr int CPB = BITS == 2 ? 4 : (BITS == 4 ? 2 : 1);
  static constexpr unsigned MASK = (1u << BITS) - 1u;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// Round an f32 value to bf16 and back (the cast to the activation dtype).
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int BITS>
__device__ __forceinline__ unsigned code_of(unsigned byte, int t) {
  return (byte >> (BITS * t)) & Pack<BITS>::MASK;
}

// w = code * scale + zero in f32, rounded once per step (no FMA
// contraction, like the two separate ops of the plain version), then
// rounded to bf16.
__device__ __forceinline__ float dequant_bf16(unsigned code, float scale,
                                              float zero) {
  return round_bf16(__fadd_rn(__fmul_rn((float)code, scale), zero));
}

// y = acc + s * adapter in f32, rounded once per step.
__device__ __forceinline__ float add_scaled(float acc, float s, float adapter) {
  return __fadd_rn(acc, __fmul_rn(s, adapter));
}

}  // namespace qdq
