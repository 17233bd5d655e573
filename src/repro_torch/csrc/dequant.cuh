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

// The float value of a small code: exact, one logic op and one add.
__device__ __forceinline__ float code_f32(unsigned code) {
  return __uint_as_float(0x4B000000u | code) - 8388608.f;
}

// 16-byte asynchronous copy to shared memory, zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
// 8-byte asynchronous copy to shared memory (through L1).
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

inline bool x_vectorizable(const void* x, int K) {
  return K % 8 == 0 && aligned16(x);
}

}  // namespace qdq
