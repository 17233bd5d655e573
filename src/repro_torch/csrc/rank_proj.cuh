// QA-LoRA's rank projection, shared by the fused products of
// qalora_fused.cu (kernel 3, M > 8) and qmatvec.cu (kernels 4 and 5,
// M <= 8):
//   t[M, r] = bf16(sum_l bf16(pool_sum_g(x))[m, l] * A[l, :]), f32 sums,
// and its slot variant, where row m takes bank row ids[m] of A [n_ad, L, r]
// (rows of id 0, the null adapter, give zeros; an id outside the bank
// traps).
//
// Bound by bytes: x (2 M K) and A (2 L r per distinct adapter).  A block
// takes ROWS rows of x and rc of the r columns: it copies A's columns into
// shared memory with cp.async while it pools its rows, then its threads
// split the L groups into threads / rc interleaved parts per column and
// add the parts in a fixed order.  Kernel 3 takes 4 rows and all r columns
// a block (256 threads); the GEMV's M <= 8 rows take one row and 8
// columns a block (64 threads), so 8 M blocks share the work at r = 64.
// Each group's sum runs in element order whether x is read 16 bytes at a
// time (xvec, g % 8 == 0) or one element at a time, so both give the same
// bits.
//
// Hopper's programmatic dependent launch, where the caller asks for it:
// the projection is launched as the dependent of the kernel before it on
// the stream, so its launch overlaps that kernel's end; each block waits
// for that kernel's results (griddepcontrol.wait), then lets its own
// dependent launch (griddepcontrol.launch_dependents): the GEMV, which
// streams its weights while the projection runs and waits for t only
// before its epilogue.  Without such launches both instructions do
// nothing.
#pragma once

#include "dequant.cuh"

namespace qdq {

// Threads a block: kernel 3's projection takes 256; the GEMV's takes 64,
// so that an SM running one of its blocks still holds two GEMV blocks (the
// GEMV streams its weights meanwhile, as its programmatic dependent).
template <int ROWS>
__host__ __device__ constexpr int proj_threads() {
  return ROWS == 1 ? 64 : 256;
}

// pooled [rows][L] f32, A [L][rc] bf16, parts [threads / rc][rows][rc] f32
__host__ __device__ inline size_t proj_a_off(int rows, int L) {
  return ((size_t)rows * L * 4 + 15) / 16 * 16;
}
__host__ __device__ inline size_t proj_p_off(int rows, int L, int rc) {
  return (proj_a_off(rows, L) + (size_t)L * rc * 2 + 15) / 16 * 16;
}
inline size_t proj_smem_bytes(int rows, int L, int rc, int threads) {
  return proj_p_off(rows, L, rc) + (size_t)threads * rows * 4;
}

template <int ROWS, bool SLOT>
__global__ void __launch_bounds__(proj_threads<ROWS>())
rank_proj_kernel(const bf16* __restrict__ x, const bf16* __restrict__ A,
                 const int* __restrict__ ids, bf16* __restrict__ t, int M,
                 int K, int g, int rank, int rc, int n_ad, bool xvec,
                 bool avec) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  constexpr int kProjThreads = proj_threads<ROWS>();
  extern __shared__ __align__(16) unsigned char psmem[];
  const int L = K / g, m0 = blockIdx.x * ROWS, tid = threadIdx.x;
  const int rows = min(ROWS, M - m0), c0 = blockIdx.y * rc;
  t += c0;
  if (SLOT) {  // one row a block: its adapter's A, or zeros for id 0
    const int id = ids[m0];
    if (id < 0 || id >= n_ad) __trap();
    if (id == 0) {
      for (int j = tid; j < rc; j += kProjThreads)
        t[(size_t)m0 * rank + j] = __float2bfloat16_rn(0.f);
      return;
    }
    A += (size_t)id * L * rank;
  }
  A += c0;
  float* pooled = reinterpret_cast<float*>(psmem);                  // [rows][L]
  bf16* as = reinterpret_cast<bf16*>(psmem + proj_a_off(ROWS, L));  // [L][rc]
  float* parts = reinterpret_cast<float*>(            // [P][rows][rc]
      psmem + proj_p_off(ROWS, L, rc));
  const int cq = rc / 8;  // 16-byte copies a row of A's columns
  if (avec) {
    for (int e = tid; e < L * cq; e += kProjThreads) {
      const int l = e / cq, c = e - l * cq;
      cp_async16(as + l * rc + 8 * c, A + (size_t)l * rank + 8 * c, true);
    }
    cp_async_commit();
  } else {
    for (int e = tid; e < L * rc; e += kProjThreads) {
      const int l = e / rc, c = e - l * rc;
      as[e] = A[(size_t)l * rank + c];
    }
  }
  for (int e = tid; e < ROWS * L; e += kProjThreads) {
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
  const int P = kProjThreads / rc, part = tid / rc, j = tid - part * rc;
  if (part < P) {
    float acc[ROWS] = {};
    for (int l = part; l < L; l += P) {
      const float a = __bfloat162float(as[l * rc + j]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        acc[r] = fmaf(pooled[r * L + l], a, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      parts[(part * ROWS + r) * rc + j] = acc[r];
  }
  __syncthreads();
  for (int e = tid; e < rows * rc; e += kProjThreads) {
    const int r = e / rc, jj = e - r * rc;
    float v = 0.f;
    for (int q = 0; q < P; ++q) v += parts[(q * ROWS + r) * rc + jj];
    t[(size_t)(m0 + r) * rank + jj] = __float2bfloat16_rn(v);
  }
}

// t = bf16(bf16(pool_sum_g(x)) @ A) on `stream`, ROWS rows of x and rc of
// the rank columns a block (rc = rank, or up to 8 where ROWS is 1); with
// ids (slot variant, ROWS 1) row m takes A's bank row ids[m].
template <int ROWS, bool SLOT>
int launch_rank_proj(const void* x, const void* A, const int* ids, void* t,
                     int M, int K, int g, int rank, int n_ad, bool pdl,
                     cudaStream_t st) {
  static_assert(!SLOT || ROWS == 1, "the slot variant takes a row a block");
  constexpr int threads = proj_threads<ROWS>();
  int rc = rank;  // ROWS 1: the largest of 8, 4, 2, 1 that divides r
  if (ROWS == 1)
    for (rc = 8; rank % rc; rc /= 2) {
    }
  if (M < 1 || g < 1 || K % g != 0 || rank < 1 || rc > threads)
    return (int)cudaErrorInvalidValue;
  auto kern = rank_proj_kernel<ROWS, SLOT>;
  const size_t smem = proj_smem_bytes(ROWS, K / g, rc, threads);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // the slot variant's bank rows are L * r apart: aligned when L * r % 8 == 0
  const bool xvec = g % 8 == 0 && x_vectorizable(x, K);
  const bool avec = rc % 8 == 0 && rank % 8 == 0 && aligned16(A) &&
                    (!SLOT || (size_t)(K / g) * rank % 8 == 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + ROWS - 1) / ROWS, rank / rc, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const bf16*>(x), static_cast<const bf16*>(A),
      ids, static_cast<bf16*>(t), M, K, g, rank, rc, n_ad, xvec, avec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace qdq
