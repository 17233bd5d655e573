// Tiled dequant matmul y = x @ dequant(Wq) for M > 8 (kernel 1).
//
// Replaces qmatmul_pallas (src/repro/kernels/qmatmul.py:76).
//
// Bound: operations at prefill (M = 512 gives each packed weight byte
// 2 * 512 * cpb operations, well above the ~295 per byte where the bf16
// tensor cores become the limit).  Design (tiled.cuh): 128 x 64 output
// tiles, 8 warps of WMMA bf16 with f32 accumulators; a 4-stage cp.async
// ring of raw operands (x tile, code bytes, scales, zeros) in shared
// memory, each step's codes dequantised into a double-buffered bf16 w
// tile shared by all 128 rows; one __syncthreads a K step.  At g = 32,
// int4, bf16 scales: 102,400 bytes of shared memory, 121 registers, no
// spills, two blocks an SM.  Still WMMA (mma.sync underneath), no TMA or
// wgmma.

#include "tiled.cuh"

using namespace qdq;

extern "C" int qmatmul_bf16(const void* x, const void* qw, const void* scale,
                            const void* zero, void* y, int M, int K, int N,
                            int g, int bk, int bits, int scale_is_f32,
                            void* stream) {
  (void)cudaGetLastError();
  const TiledArgs a{static_cast<const bf16*>(x), static_cast<const uint8_t*>(qw),
                    scale, zero, nullptr, nullptr, static_cast<bf16*>(y),
                    M, K, N, g, 0, bk, 0.f, x_vectorizable(x, K), false,
                    scale_is_f32 ? 4 : 2, w_vectorizable(qw, scale, zero, N)};
  if (!tiled_args_ok(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return scale_is_f32 ? tiled_by_bits<float, false>(a, bits, st)
                      : tiled_by_bits<bf16, false>(a, bits, st);
}

// The tiled kernel's design: {TM, TN, threads, stages, dynamic shared
// memory bytes at these operands} into out[0..4] (read by chip_smoke.py).
extern "C" int tiled_design(int bk, int g, int rank, int bits,
                            int scale_is_f32, int* out) {
  TiledArgs a{};
  a.bk = bk;
  a.g = g;
  a.rank = rank;
  a.scale_bytes = scale_is_f32 ? 4 : 2;
  out[0] = kTM;
  out[1] = kTN;
  out[2] = kThreads;
  out[3] = kStages;
  out[4] = (int)tiled_smem_bytes(a, bits == 2 ? 4 : (bits == 4 ? 2 : 1));
  return 0;
}
