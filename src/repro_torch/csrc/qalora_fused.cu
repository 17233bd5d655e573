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
// Instead rank_proj_kernel computes t[M, r] = bf16(bf16(pool_sum_g(x)) @ A)
// once per call (f32 sums), and the tiled kernel of tiled.cuh (the same
// pipelined main loop as kernel 1) copies the tile's rows of t and B's
// tile columns into shared memory in its epilogue and applies them on the
// tensor cores.  The projection is bound by the bytes of x (2 M K): each block
// copies A into shared memory with cp.async while it pools 4 rows of x,
// then its 256 threads split the L groups into 256 / r interleaved parts
// per rank column and add the parts in a fixed order.

#include "tiled.cuh"

using namespace qdq;

namespace {

constexpr int kProjRows = 4, kProjThreads = 256;

// pooled [rows][L] f32, A [L][r] bf16, parts [threads / r][rows][r] f32
inline size_t proj_smem_bytes(int L, int rank) {
  const size_t a_off = ((size_t)kProjRows * L * 4 + 15) / 16 * 16;
  const size_t p_off = (a_off + (size_t)L * rank * 2 + 15) / 16 * 16;
  return p_off + (size_t)kProjThreads * kProjRows * 4;
}

// t[M, rank] = bf16(sum_l bf16(pool_sum_g(x))[m, l] * A[l, :]), f32 sums.
// Each group's sum runs in element order whether x is read 16 bytes at a
// time (xvec, g % 8 == 0) or one element at a time, so both give the same
// bits.
__global__ void __launch_bounds__(kProjThreads)
rank_proj_kernel(const bf16* __restrict__ x, const bf16* __restrict__ A,
                 bf16* __restrict__ t, int M, int K, int g, int rank,
                 bool xvec, bool avec) {
  extern __shared__ __align__(16) unsigned char psmem[];
  const int L = K / g, m0 = blockIdx.x * kProjRows, tid = threadIdx.x;
  const int rows = min(kProjRows, M - m0);
  const size_t a_off = ((size_t)kProjRows * L * 4 + 15) / 16 * 16;
  const size_t p_off = (a_off + (size_t)L * rank * 2 + 15) / 16 * 16;
  float* pooled = reinterpret_cast<float*>(psmem);        // [rows][L]
  bf16* as = reinterpret_cast<bf16*>(psmem + a_off);      // [L][rank]
  float* parts = reinterpret_cast<float*>(psmem + p_off);  // [P][rows][rank]
  if (avec) {
    for (int e = tid; e < L * rank / 8; e += kProjThreads)
      cp_async16(as + 8 * e, A + 8 * e, true);
    cp_async_commit();
  } else {
    for (int e = tid; e < L * rank; e += kProjThreads) as[e] = A[e];
  }
  for (int e = tid; e < kProjRows * L; e += kProjThreads) {
    const int r = e / L, l = e - r * L;
    float v = 0.f;
    if (r < rows) {
      const bf16* xp = x + (size_t)(m0 + r) * K + (size_t)l * g;
      if (xvec) {
#pragma unroll 4
        for (int i = 0; i < g; i += 8) {
          const uint4 u = *reinterpret_cast<const uint4*>(xp + i);
          const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
          for (int q = 0; q < 8; ++q) v += __bfloat162float(h[q]);
        }
      } else {
        for (int i = 0; i < g; ++i) v += __bfloat162float(xp[i]);
      }
    }
    pooled[e] = round_bf16(v);
  }
  if (avec) cp_async_wait<0>();
  __syncthreads();
  // thread (part, j) sums groups l = part, part + P, ... of column j
  const int P = kProjThreads / rank, part = tid / rank, j = tid - part * rank;
  if (part < P) {
    float acc[kProjRows] = {};
    for (int l = part; l < L; l += P) {
      const float a = __bfloat162float(as[l * rank + j]);
#pragma unroll
      for (int r = 0; r < kProjRows; ++r)
        acc[r] = fmaf(pooled[r * L + l], a, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kProjRows; ++r)
      parts[(part * kProjRows + r) * rank + j] = acc[r];
  }
  __syncthreads();
  for (int e = tid; e < rows * rank; e += kProjThreads) {
    const int r = e / rank, jj = e - r * rank;
    float v = 0.f;
    for (int q = 0; q < P; ++q) v += parts[(q * kProjRows + r) * rank + jj];
    t[(size_t)(m0 + r) * rank + jj] = __float2bfloat16_rn(v);
  }
}

int launch_rank_proj(const void* x, const void* A, void* t, int M, int K,
                     int g, int rank, cudaStream_t st) {
  if (M < 1 || g < 1 || K % g != 0 || rank < 1 || rank > kProjThreads)
    return (int)cudaErrorInvalidValue;
  const size_t smem = proj_smem_bytes(K / g, rank);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rank_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const bool xvec = g % 8 == 0 && x_vectorizable(x, K);
  const bool avec = rank % 8 == 0 && aligned16(A);
  rank_proj_kernel<<<(M + kProjRows - 1) / kProjRows, kProjThreads, smem,
                     st>>>(static_cast<const bf16*>(x),
                           static_cast<const bf16*>(A), static_cast<bf16*>(t),
                           M, K, g, rank, xvec, avec);
  return (int)cudaGetLastError();
}

}  // namespace

// t = bf16(bf16(pool_sum_g(x)) @ A): the projection alone.
extern "C" int qalora_rank_proj_bf16(const void* x, const void* A, void* t,
                                     int M, int K, int g, int rank,
                                     void* stream) {
  (void)cudaGetLastError();
  return launch_rank_proj(x, A, t, M, K, g, rank,
                          static_cast<cudaStream_t>(stream));
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
