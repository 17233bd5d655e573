// Fused QA-LoRA matmul y = x @ dequant(Wq) + s * (pool_g(x) @ A) @ B for
// M > 8 (kernel 3).
//
// Replaces qalora_matmul_pallas (src/repro/kernels/qalora_fused.py:62).
//
// Bound: operations at prefill, as kernel 1; the adapter adds
// 2 * M * (L * r + r * N) operations, a few percent of the base product.
// Design: the tiled kernel of tiled.cuh with the adapter riding along:
// the x tile already in shared memory is pooled over groups and
// contracted with A's K-slice into a [64, r] f32 accumulator inside the K
// loop, so x is read once; B is applied once per output tile, on the
// tensor cores.

#include "tiled.cuh"

using namespace qdq;

extern "C" int qalora_matmul_bf16(const void* x, const void* qw,
                                  const void* scale, const void* zero,
                                  const void* A, const void* B, void* y,
                                  int M, int K, int N, int g, int rank,
                                  int bk, float s, int bits, int scale_is_f32,
                                  void* stream) {
  (void)cudaGetLastError();
  const TiledArgs a{static_cast<const bf16*>(x), static_cast<const uint8_t*>(qw),
                    scale, zero, static_cast<const bf16*>(A),
                    static_cast<const bf16*>(B), static_cast<bf16*>(y),
                    M, K, N, g, rank, bk, s, x_vectorizable(x, K),
                    b_wmma_ok(B, N, rank)};
  if (!tiled_args_ok(a) || rank < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return scale_is_f32 ? tiled_by_bits<float, true>(a, bits, st)
                      : tiled_by_bits<bf16, true>(a, bits, st);
}
