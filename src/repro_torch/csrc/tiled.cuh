// Tiled dequant matmul for Hopper (sm_90a), shared by qmatmul.cu (kernel 1)
// and qalora_fused.cu (kernel 3):
//   y = x @ dequant(Wq)  [+ s * (pool_g(x) @ A) @ B]   for M > 8.
//
// One block computes a 64 x 64 output tile with 4 warps (2 x 2, each
// 32 x 32 as 2 x 2 WMMA bf16 16x16x16 fragments with f32 accumulators).
// The K loop steps by bk (a multiple of g and of 16, 64 to 128).  Each
// step first issues all of its global loads at once (the x tile into
// registers, 16 bytes at a time; the thread's packed bytes of each group
// with the group's scale and zero), so a step waits for memory about once,
// then stores x and the dequantised w tile to shared memory and runs the
// tensor-core products.  The adapter variant (A and B in bf16) also
// stages A's K-slice, pools the x tile over groups (f32 sums rounded to
// bf16) and adds pooled @ A into a [64, r] f32 accumulator in shared
// memory inside the same K loop (as qalora_fused.py:48-59 does).  Its
// epilogue casts that accumulator to bf16 (B's dtype) and multiplies it by
// the tile's B columns on the tensor cores too, into a second set of f32
// fragments (full tiles with r % 16 == 0; other tiles take a scalar
// loop).  No cp.async/TMA pipelining across steps and no wgmma yet.
#pragma once

#include <mma.h>

#include "dequant.cuh"

namespace qdq {

constexpr int kTM = 64, kTN = 64, kThreads = 128;
constexpr int kLDC = kTN + 4;  // f32 epilogue staging stride
constexpr int kMaxBK = 128;
constexpr int kMaxXv = kTM * kMaxBK / 8 / kThreads;  // x loads per thread
constexpr int kBatch = 8;      // packed bytes loaded together per thread

struct TiledArgs {
  const bf16* x;      // [M, K]
  const uint8_t* qw;  // [K / cpb, N]
  const void* scale;  // [K / g, N]
  const void* zero;   // [K / g, N]
  const bf16* a;      // [K / g, rank] or null
  const bf16* b;      // [rank, N] or null
  bf16* y;            // [M, N]
  int M, K, N, g, rank, bk;
  float s;
  bool xvec;          // x 16-byte aligned and K % 8 == 0: vector loads
  bool bwmma;         // B 32-byte aligned, N % 16 == 0, r % 16 == 0
};

inline size_t tiled_smem_bytes(const TiledArgs& a, bool adapter) {
  size_t bytes = (size_t)kTM * (a.bk + 8) * 2 + (size_t)a.bk * (kTN + 8) * 2 +
                 (size_t)kTM * kLDC * 4;
  if (adapter)
    bytes += (size_t)kTM * a.rank * 4 +             // lacc
             (size_t)kTM * (a.bk / a.g) * 4 +       // pooled
             (size_t)(a.bk / a.g) * a.rank * 4;     // A slice
  return bytes;
}

template <int BITS, typename S, bool ADAPTER>
__global__ void __launch_bounds__(kThreads)
tiled_kernel(TiledArgs p) {
  using namespace nvcuda;
  constexpr int CPB = Pack<BITS>::CPB;
  extern __shared__ __align__(128) unsigned char smem[];
  const int BK = p.bk, LDX = BK + 8, LDW = kTN + 8;
  const int M = p.M, K = p.K, N = p.N, g = p.g, rank = p.rank;
  const int L = K / g, gpt = BK / g;
  bf16* xs = reinterpret_cast<bf16*>(smem);                  // [TM][LDX]
  bf16* ws = xs + kTM * LDX;                                 // [BK][LDW]
  float* cs = reinterpret_cast<float*>(ws + BK * LDW);       // [TM][LDC]
  float* lacc = cs + kTM * kLDC;                             // [TM][rank]
  float* pooled = lacc + kTM * rank;                         // [TM][gpt]
  float* as = pooled + kTM * gpt;                            // [gpt][rank]

  const S* scale = static_cast<const S*>(p.scale);
  const S* zero = static_cast<const S*>(p.zero);
  const bf16* A = p.a;
  const bf16* B = p.b;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  // this thread's column of the w tile, and which half of its byte rows
  const int wc = tid % kTN, half = tid / kTN, w_n = n0 + wc;
  const int rows_per_group = g / CPB;
  const int nxv = kTM * BK / 8 / kThreads;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);
  if (ADAPTER) {
    for (int e = tid; e < kTM * rank; e += kThreads) lacc[e] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile [TM][BK] into registers (16 bytes a load), zero outside M, K
    uint4 xr[kMaxXv];
    if (p.xvec) {
#pragma unroll
      for (int q = 0; q < kMaxXv; ++q) {
        if (q < nxv) {
          const int e = tid + q * kThreads;
          const int r = e / (BK / 8), kk = (e - r * (BK / 8)) * 8;
          const int gm = m0 + r, gk = k0 + kk;
          xr[q] = (gm < M && gk < K)
                      ? *reinterpret_cast<const uint4*>(p.x + (size_t)gm * K + gk)
                      : make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    __syncthreads();  // the previous step's readers of xs / ws are done
    if (p.xvec) {
#pragma unroll
      for (int q = 0; q < kMaxXv; ++q) {
        if (q < nxv) {
          const int e = tid + q * kThreads;
          const int r = e / (BK / 8), kk = (e - r * (BK / 8)) * 8;
          *reinterpret_cast<uint4*>(xs + r * LDX + kk) = xr[q];
        }
      }
    } else {
      for (int e = tid; e < kTM * BK; e += kThreads) {
        const int r = e / BK, kk = e - r * BK;
        const int gm = m0 + r, gk = k0 + kk;
        xs[r * LDX + kk] = (gm < M && gk < K) ? p.x[(size_t)gm * K + gk]
                                               : __float2bfloat16_rn(0.f);
      }
    }
    if (ADAPTER) {
      for (int e = tid; e < gpt * rank; e += kThreads) {
        const int gl = e / rank, grp = k0 / g + gl;
        as[e] = grp < L
                    ? __bfloat162float(A[(size_t)grp * rank + (e - gl * rank)])
                    : 0.f;
      }
    }
    // w tile [BK][TN]: per group, the thread's packed bytes (every other
    // byte row) are loaded together, then dequantised
    for (int gl = 0; gl < gpt; ++gl) {
      const int grp = k0 / g + gl;
      const bool ok = w_n < N && grp < L;
      float sc = 0.f, zr = 0.f;
      if (ok) {
        sc = to_f32(scale[(size_t)grp * N + w_n]);
        zr = to_f32(zero[(size_t)grp * N + w_n]);
      }
      const int rb0 = gl * rows_per_group + half;   // tile-local byte row
      const int rpt = (rows_per_group - half + 1) / 2;
      for (int j0 = 0; j0 < rpt; j0 += kBatch) {
        unsigned bytes[kBatch];
#pragma unroll
        for (int jj = 0; jj < kBatch; ++jj) {
          const int rb = rb0 + 2 * (j0 + jj);
          bytes[jj] = (ok && j0 + jj < rpt)
                          ? (unsigned)__ldg(p.qw + (size_t)(k0 / CPB + rb) * N + w_n)
                          : 0u;
        }
#pragma unroll
        for (int jj = 0; jj < kBatch; ++jj) {
          if (j0 + jj < rpt) {
            const int rb = rb0 + 2 * (j0 + jj);
#pragma unroll
            for (int t = 0; t < CPB; ++t)
              ws[(rb * CPB + t) * LDW + wc] = __float2bfloat16_rn(
                  ok ? dequant_bf16(code_of<BITS>(bytes[jj], t), sc, zr) : 0.f);
          }
        }
      }
    }
    __syncthreads();

    if (ADAPTER) {
      // pooled = pool_sum_g(x tile) in f32, rounded to the activation dtype
      for (int e = tid; e < kTM * gpt; e += kThreads) {
        const int r = e / gpt, gl = e - r * gpt;
        float v = 0.f;
        for (int t = 0; t < g; ++t) v += __bfloat162float(xs[r * LDX + gl * g + t]);
        pooled[e] = round_bf16(v);
      }
      __syncthreads();
      // lacc[TM, r] += pooled @ A[k-slice]; each thread owns its entries
      for (int e = tid; e < kTM * rank; e += kThreads) {
        const int r = e / rank, j = e - r * rank;
        float v = lacc[e];
        for (int gl = 0; gl < gpt; ++gl)
          v = fmaf(pooled[r * gpt + gl], as[gl * rank + j], v);
        lacc[e] = v;
      }
    }

    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], xs + (wm * 32 + i * 16) * LDX + kk, LDX);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], ws + kk * LDW + wn * 32 + j * 16, LDW);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], fa[i], fb[j], c[i][j]);
    }
  }

  __syncthreads();
  // adapter on the tensor cores: y = acc + s * (bf16(lacc) @ B[:, tile])
  bool adapter_done = false;
  if constexpr (ADAPTER) {
    const int ldl = rank + 8;
    if (p.bwmma && n0 + kTN <= N && kTM * ldl <= kTM * LDX + BK * LDW) {
      bf16* ls = xs;  // [TM][ldl], over the free x / w tiles
      for (int e = tid; e < kTM * rank; e += kThreads) {
        const int r = e / rank;
        ls[r * ldl + (e - r * rank)] = __float2bfloat16_rn(lacc[e]);
      }
      __syncthreads();
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> ad[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(ad[i][j], 0.f);
      for (int kk = 0; kk < rank; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], ls + (wm * 32 + i * 16) * ldl + kk, ldl);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], B + (size_t)kk * N + n0 + wn * 32 + j * 16, N);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(ad[i][j], fa[i], fb[j], ad[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int t = 0; t < c[i][j].num_elements; ++t)
            c[i][j].x[t] = add_scaled(c[i][j].x[t], p.s, ad[i][j].x[t]);
      adapter_done = true;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * kLDC + wn * 32 + j * 16,
                              c[i][j], kLDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < kTM * kTN; e += kThreads) {
    const int r = e / kTN, cc = e - r * kTN;
    const int gm = m0 + r, n = n0 + cc;
    if (gm < M && n < N) {
      float v = cs[r * kLDC + cc];
      if (ADAPTER && !adapter_done) {
        float ad = 0.f;
        for (int j = 0; j < rank; ++j)
          ad = fmaf(round_bf16(lacc[r * rank + j]),
                    __bfloat162float(B[(size_t)j * N + n]), ad);
        v = add_scaled(v, p.s, ad);
      }
      p.y[(size_t)gm * N + n] = __float2bfloat16_rn(v);
    }
  }
}

template <int BITS, typename S, bool ADAPTER>
int launch_tiled_t(const TiledArgs& a, cudaStream_t stream) {
  auto kern = tiled_kernel<BITS, S, ADAPTER>;
  const size_t smem = tiled_smem_bytes(a, ADAPTER);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.N + kTN - 1) / kTN, (a.M + kTM - 1) / kTM);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename S, bool ADAPTER>
int tiled_by_bits(const TiledArgs& a, int bits, cudaStream_t stream) {
  switch (bits) {
    case 2: return launch_tiled_t<2, S, ADAPTER>(a, stream);
    case 3: return launch_tiled_t<3, S, ADAPTER>(a, stream);
    case 4: return launch_tiled_t<4, S, ADAPTER>(a, stream);
    case 8: return launch_tiled_t<8, S, ADAPTER>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

inline bool tiled_args_ok(const TiledArgs& a) {
  return a.M >= 1 && a.g >= 1 && a.K % a.g == 0 && a.bk >= 32 &&
         a.bk <= kMaxBK && a.bk % 16 == 0 && a.bk % a.g == 0 &&
         tiled_smem_bytes(a, a.rank > 0) <= 227 * 1024;
}

inline bool x_vectorizable(const void* x, int K) {
  return K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// B can feed the tensor-core epilogue straight from global memory
inline bool b_wmma_ok(const void* B, int N, int rank) {
  return N % 16 == 0 && rank % 16 == 0 &&
         reinterpret_cast<uintptr_t>(B) % 32 == 0;
}

}  // namespace qdq
