// Fused QA-LoRA matmul y = x @ dequant(Wq) + s * (pool_g(x) @ A) @ B for
// M > 8 (kernel 3).
//
// Replaces qalora_matmul_pallas (src/repro/kernels/qalora_fused.py:62).
//
// Bound: operations at prefill, as kernel 1; the adapter adds
// 2 * M * (L * r + r * N) operations, a few percent of the base product.
// Design: two launches on the caller's stream.  The Pallas kernel carries
// its [rows, r] rank accumulator across its sequential K grid; blocks on
// Hopper run in parallel, so doing the same inside the tiled kernel would
// repeat the [64, r] projection once per output tile (N / 64 times over).
// Instead rank_proj_kernel (rank_proj.cuh, 4 rows of x a block) computes
// t[M, r] = bf16(bf16(pool_sum_g(x)) @ A) once per call (f32 sums), and
// the tiled kernel of tiled.cuh (the same pipelined main loop as kernel 1)
// copies the tile's rows of t and B's tile columns into shared memory in
// its epilogue and applies them on the tensor cores.

#include "rank_proj.cuh"
#include "tiled.cuh"

using namespace qdq;

// t = bf16(bf16(pool_sum_g(x)) @ A): the projection alone.
extern "C" int qalora_rank_proj_bf16(const void* x, const void* A, void* t,
                                     int M, int K, int g, int rank,
                                     void* stream) {
  (void)cudaGetLastError();
  return launch_rank_proj<4, false>(x, A, nullptr, t, M, K, g, rank, 1,
                                   false, static_cast<cudaStream_t>(stream));
}

// y = x @ dequant(Wq) + s * t @ B, given t from qalora_rank_proj_bf16.
extern "C" int qalora_matmul_bf16(const void* x, const void* qw,
                                  const void* scale, const void* zero,
                                  const void* t, const void* B, void* y,
                                  int M, int K, int N, int g, int rank,
                                  int bk, float s, int bits, int scale_is_f32,
                                  void* stream) {
  (void)cudaGetLastError();
  const TiledArgs a{static_cast<const bf16*>(x), static_cast<const uint8_t*>(qw),
                    scale, zero, static_cast<const bf16*>(t),
                    static_cast<const bf16*>(B), static_cast<bf16*>(y),
                    M, K, N, g, rank, bk, s, x_vectorizable(x, K),
                    b_wmma_ok(B, N, rank), scale_is_f32 ? 4 : 2,
                    w_vectorizable(qw, scale, zero, N)};
  if (!tiled_args_ok(a) || rank < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return scale_is_f32 ? tiled_by_bits<float, true>(a, bits, st)
                      : tiled_by_bits<bf16, true>(a, bits, st);
}
