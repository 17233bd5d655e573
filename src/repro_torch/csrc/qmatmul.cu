// Tiled dequant matmul y = x @ dequant(Wq) for M > 8 (kernel 1).
//
// Replaces qmatmul_pallas (src/repro/kernels/qmatmul.py:76).
//
// Bound: operations at prefill (M = 512 gives each packed weight byte
// 2 * 512 * cpb operations, well above the ~295 per byte where the bf16
// tensor cores become the limit).  Design: 64 x 64 output tiles on the
// tensor cores (WMMA bf16, f32 accumulators) with the weight tile
// dequantised into shared memory once per K step and shared by all 64
// rows; see tiled.cuh.  Unpipelined, so far from the tensor-core peak.

#include "tiled.cuh"

using namespace qdq;

extern "C" int qmatmul_bf16(const void* x, const void* qw, const void* scale,
                            const void* zero, void* y, int M, int K, int N,
                            int g, int bk, int bits, int scale_is_f32,
                            void* stream) {
  (void)cudaGetLastError();
  const TiledArgs a{static_cast<const bf16*>(x), static_cast<const uint8_t*>(qw),
                    scale, zero, nullptr, nullptr, static_cast<bf16*>(y),
                    M, K, N, g, 0, bk, 0.f, x_vectorizable(x, K), false};
  if (!tiled_args_ok(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return scale_is_f32 ? tiled_by_bits<float, false>(a, bits, st)
                      : tiled_by_bits<bf16, false>(a, bits, st);
}
