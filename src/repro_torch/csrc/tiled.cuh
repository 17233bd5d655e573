// Tiled dequant matmul for Hopper (sm_90a), shared by qmatmul.cu (kernel 1)
// and qalora_fused.cu (kernel 3):
//   y = x @ dequant(Wq)  [+ s * t @ B,  t = bf16(pool_g(x) @ A)]   for M > 8.
//
// One block computes a 128 x 64 output tile with 8 warps (4 x 2, each
// 32 x 32 as 2 x 2 WMMA bf16 16x16x16 fragments with f32 accumulators), so
// each dequantised weight tile serves 128 rows of x.  Blocks at the served
// shapes: M = 512 gives 256 (N = 4096) and 688 (N = 11008), M = 256 gives
// 128 and 344, against 132 SMs with two blocks an SM.
//
// The K loop steps by bk (a multiple of g and of 16, 64 to 128).  A ring of
// kStages = 4 stages in shared memory holds each step's raw operands: the
// x tile (bf16), the packed code bytes of the tile's 64 columns, and the
// scale and zero rows of the step's groups.  cp.async 16-byte copies fill
// it (zero-filled past M, N and K through the copy's source size), one
// commit group per step.  Step k + 1's codes are dequantised, 16 bytes
// read at a time from the ring, into one of two bf16 w tiles while step k
// is multiplied from the other and steps k + 2 and k + 3 are in flight,
// so a step costs one __syncthreads.  x that is not 16-byte aligned (or
// K % 8 != 0), and N % 16 != 0 or unaligned weights, take element-wise
// loads into the same ring instead (xvec / wvec, chosen by the C entry);
// the arithmetic is the same, so the bits are too.
//
// The adapter variant takes the rank projection t [M, r] (bf16), computed
// once per call by qalora_fused.cu.  Its epilogue copies the tile's rows
// of t and B's tile columns into the free ring and multiplies them on the
// tensor cores, into a second set of f32 fragments (full tiles with
// r % 16 == 0; other tiles take a scalar loop).
//
// The WMMA fragments are loaded with the shared state space written out
// (load_a / load_b): through a generic pointer the compiler loaded them
// with generic loads and movmatrix instead of ldmatrix, which cost a
// third of the kernel's time at M = 512.
//
// Shared memory at bk = 64, int4, bf16 scales: 4 x 20,992 (ring) + 2 x
// 9,216 (w tiles) = 102,400 bytes, two blocks an SM.  No TMA, no wgmma and
// no register-level dequant yet.
#pragma once

#include <mma.h>

#include "dequant.cuh"

namespace qdq {

constexpr int kTM = 128, kTN = 64, kThreads = 256;
constexpr int kWarpsN = 2, kWarpsM = kThreads / 32 / kWarpsN;
constexpr int kFM = kTM / kWarpsM / 16, kFN = kTN / kWarpsN / 16;  // fragments
constexpr int kCQ = kTN / 16;  // 16-byte code chunks (and dequant items) a row
constexpr int kStages = 4;     // K steps held in shared memory at once
constexpr int kLDC = kTN + 4;  // f32 epilogue staging stride
constexpr int kLDW = kTN + 8;  // bf16 w tile stride
constexpr int kMaxBK = 128;
constexpr int kMaxXv = kTM * kMaxBK / 8 / kThreads;  // x copies per thread
constexpr int kMaxIt = kMaxBK * kCQ / kThreads;      // dequant items per thread

struct TiledArgs {
  const bf16* x;      // [M, K]
  const uint8_t* qw;  // [K / cpb, N]
  const void* scale;  // [K / g, N]
  const void* zero;   // [K / g, N]
  const bf16* t;      // [M, rank]: bf16(pool_g(x) @ A), or null
  const bf16* b;      // [rank, N] or null
  bf16* y;            // [M, N]
  int M, K, N, g, rank, bk;
  float s;
  bool xvec;          // x 16-byte aligned and K % 8 == 0: cp.async
  bool bwmma;         // B 32-byte aligned, N % 16 == 0, r % 16 == 0
  int scale_bytes;    // 2 (bf16) or 4 (f32)
  bool wvec;          // N % 16 == 0, codes/scale/zero 16-byte aligned
};

// Bytes of one ring stage: x tile, code bytes, scale and zero rows.
__host__ __device__ inline size_t stage_bytes(int bk, int g, int cpb,
                                                int scale_bytes) {
  return (size_t)kTM * (bk + 8) * 2 + (size_t)(bk / cpb) * kTN +
         2 * (size_t)(bk / g) * kTN * scale_bytes;
}

inline size_t tiled_smem_bytes(const TiledArgs& a, int cpb) {
  const size_t main = kStages * stage_bytes(a.bk, a.g, cpb, a.scale_bytes) +
                      2 * (size_t)a.bk * kLDW * 2;
  const size_t epi = (size_t)kTM * kLDC * 4 +
                     ((size_t)kTM * (a.rank + 8) + (size_t)a.rank * kLDW) * 2;
  return main > epi ? main : epi;
}

// WMMA bf16 16x16x16 fragment loads with the shared state space spelled
// out: through a generic pointer the compiler emits generic loads and
// movmatrix for these fragments instead of ldmatrix.
typedef nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, bf16,
                               nvcuda::wmma::row_major> FragA;
typedef nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, bf16,
                               nvcuda::wmma::row_major> FragB;
static_assert(sizeof(FragA::x) == 16 && sizeof(FragB::x) == 16,
              "a bf16 16x16x16 fragment holds four 32-bit registers");

__device__ __forceinline__ void load_a(FragA& f, const bf16* p, int ldm) {
  unsigned* r = reinterpret_cast<unsigned*>(f.x);
  asm volatile(
      "wmma.load.a.sync.aligned.row.m16n16k16.shared.bf16 {%0, %1, %2, %3}, "
      "[%4], %5;\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))), "r"(ldm)
      : "memory");
}
__device__ __forceinline__ void load_b(FragB& f, const bf16* p, int ldm) {
  unsigned* r = reinterpret_cast<unsigned*>(f.x);
  asm volatile(
      "wmma.load.b.sync.aligned.row.m16n16k16.shared.bf16 {%0, %1, %2, %3}, "
      "[%4], %5;\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))), "r"(ldm)
      : "memory");
}

// 16 consecutive scale or zero values from shared memory, as f32
__device__ __forceinline__ void load16_f32(const bf16* p, float* out) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[h];
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[h * 8 + 2 * i] = __uint_as_float(w[i] << 16);
      out[h * 8 + 2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}
__device__ __forceinline__ void load16_f32(const float* p, float* out) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const float4 f = reinterpret_cast<const float4*>(p)[h];
    out[4 * h] = f.x;
    out[4 * h + 1] = f.y;
    out[4 * h + 2] = f.z;
    out[4 * h + 3] = f.w;
  }
}

template <int BITS, typename S, bool ADAPTER>
__global__ void __launch_bounds__(kThreads, 2)
tiled_kernel(TiledArgs p) {
  using namespace nvcuda;
  constexpr int CPB = Pack<BITS>::CPB;
  constexpr unsigned MASK = Pack<BITS>::MASK;
  constexpr int SCPR = kTN * (int)sizeof(S) / 16;  // 16-byte copies a row
  extern __shared__ __align__(128) unsigned char smem[];
  const int BK = p.bk, LDX = BK + 8;
  const int M = p.M, K = p.K, N = p.N, g = p.g, rank = p.rank;
  const int L = K / g, gpt = BK / g, QR = BK / CPB, KQ = K / CPB;
  const int nk = (K + BK - 1) / BK;
  const int SB = (int)stage_bytes(BK, g, CPB, sizeof(S));
  // stage st: xs [TM][LDX] bf16, qs [QR][TN] bytes, ss and zs [gpt][TN] S
  auto xs_of = [&](int st) { return reinterpret_cast<bf16*>(smem + st * SB); };
  auto qs_of = [&](int st) {
    return reinterpret_cast<uint8_t*>(xs_of(st) + kTM * LDX);
  };
  auto ss_of = [&](int st) {
    return reinterpret_cast<S*>(qs_of(st) + QR * kTN);
  };
  bf16* ws0 = reinterpret_cast<bf16*>(smem + kStages * SB);  // 2 x [BK][LDW]

  const S* scale = static_cast<const S*>(p.scale);
  const S* zero = static_cast<const S*>(p.zero);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;

  // Each thread's copies and dequant items are the same at every K step:
  // their offsets are computed once here.  x copies: shared offset, global
  // offset (or -1 past M) and column within the step.
  const int xcpr = BK / 8, nxv = kTM * BK / 8 / kThreads;
  int xso[kMaxXv], xgo[kMaxXv], xcol[kMaxXv];
#pragma unroll
  for (int q = 0; q < kMaxXv; ++q) {
    const int e = tid + q * kThreads;
    const int r = e / xcpr, kc = (e - r * xcpr) * 8;
    xso[q] = r * LDX + kc;
    xgo[q] = m0 + r < M ? (m0 + r) * K + kc : -1;
    xcol[q] = kc;
  }
  // dequant items (16 columns of one of the BK rows): code, scale and w
  // tile offsets, and the code's shift within its byte
  const int nit = BK * kCQ;
  int dqo[kMaxIt], dso[kMaxIt], dwo[kMaxIt], dsh[kMaxIt];
#pragma unroll
  for (int q = 0; q < kMaxIt; ++q) {
    const int it = tid + q * kThreads;
    const int kr = it / kCQ, cc = (it % kCQ) * 16, rb = kr / CPB;
    dqo[q] = rb * kTN + cc;
    dso[q] = (kr / g) * kTN + cc;
    dwo[q] = kr * kLDW + cc;
    dsh[q] = BITS * (kr - rb * CPB);
  }

  // step kt's operands into stage st
  auto load_stage = [&](int st, int kt) {
    const int k0 = kt * BK;
    bf16* xs = xs_of(st);
    if (p.xvec) {
#pragma unroll
      for (int q = 0; q < kMaxXv; ++q) {
        if (q < nxv) {
          const bool ok = xgo[q] >= 0 && k0 + xcol[q] < K;
          cp_async16(xs + xso[q], p.x + (ok ? xgo[q] + k0 : 0), ok);
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
    uint8_t* qs = qs_of(st);
    S* ss = ss_of(st);
    S* zs = ss + gpt * kTN;
    const int q0 = k0 / CPB, g0 = k0 / g;
    if (p.wvec) {
      for (int e = tid; e < QR * kCQ; e += kThreads) {
        const int rb = e / kCQ, cc = (e % kCQ) * 16;
        const bool ok = q0 + rb < KQ && n0 + cc < N;
        cp_async16(qs + rb * kTN + cc,
                   p.qw + (ok ? (q0 + rb) * N + n0 + cc : 0), ok);
      }
      for (int e = tid; e < gpt * SCPR; e += kThreads) {
        const int gl = e / SCPR, cc = (e % SCPR) * (16 / (int)sizeof(S));
        const bool ok = g0 + gl < L && n0 + cc < N;
        const int o = ok ? (g0 + gl) * N + n0 + cc : 0;
        cp_async16(ss + gl * kTN + cc, scale + o, ok);
        cp_async16(zs + gl * kTN + cc, zero + o, ok);
      }
    } else {
      for (int e = tid; e < QR * kTN; e += kThreads) {
        const int rb = e / kTN, cc = e - rb * kTN;
        const bool ok = q0 + rb < KQ && n0 + cc < N;
        qs[e] = ok ? p.qw[(size_t)(q0 + rb) * N + n0 + cc] : (uint8_t)0;
      }
      for (int e = tid; e < gpt * kTN; e += kThreads) {
        const int gl = e / kTN, cc = e - gl * kTN;
        const bool ok = g0 + gl < L && n0 + cc < N;
        const size_t i = (size_t)(g0 + gl) * N + n0 + cc;
        ss[e] = ok ? scale[i] : S(0.f);
        zs[e] = ok ? zero[i] : S(0.f);
      }
    }
  };

  // stage st's codes -> bf16 w tile: w = code * scale + zero in f32 (no
  // FMA contraction), rounded to bf16; an item is 16 columns of one row,
  // its 16 code bytes read from the ring at once
  auto dequant_stage = [&](int st, bf16* ws) {
    const uint8_t* qs = qs_of(st);
    const S* ss = ss_of(st);
    const S* zs = ss + gpt * kTN;
#pragma unroll
    for (int q = 0; q < kMaxIt; ++q) {
      if (tid + q * kThreads >= nit) break;
      const uint4 raw = *reinterpret_cast<const uint4*>(qs + dqo[q]);
      const unsigned wd[4] = {raw.x, raw.y, raw.z, raw.w};
      const int sh = dsh[q];
      float sc[16], zr[16];
      load16_f32(ss + dso[q], sc);
      load16_f32(zs + dso[q], zr);
      unsigned out[8];
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        const unsigned c0 = (wd[j >> 2] >> (8 * (j & 3) + sh)) & MASK;
        const unsigned c1 = (wd[j >> 2] >> (8 * ((j + 1) & 3) + sh)) & MASK;
        const float v0 = __fadd_rn(__fmul_rn(code_f32(c0), sc[j]), zr[j]);
        const float v1 = __fadd_rn(__fmul_rn(code_f32(c1), sc[j + 1]), zr[j + 1]);
        const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
        out[j >> 1] = *reinterpret_cast<const unsigned*>(&h);
      }
      uint4* dst = reinterpret_cast<uint4*>(ws + dwo[q]);
      dst[0] = make_uint4(out[0], out[1], out[2], out[3]);
      dst[1] = make_uint4(out[4], out[5], out[6], out[7]);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(c[i][j], 0.f);

  // prologue: steps 0 .. kStages-2 in flight, step 0 dequantised
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();
  dequant_stage(0, ws0);

  for (int kt = 0; kt < nk; ++kt) {
    // step kt + 1 has landed; every thread is done with step kt - 1's
    // stage and w tile, and has written step kt's w tile
    cp_async_wait<kStages - 3>();
    __syncthreads();
    const int nx = kt + kStages - 1;
    if (nx < nk) load_stage(nx % kStages, nx);
    cp_async_commit();
    if (kt + 1 < nk)
      dequant_stage((kt + 1) % kStages, ws0 + ((kt + 1) & 1) * BK * kLDW);

    const bf16* xs = xs_of(kt % kStages);
    const bf16* ws = ws0 + (kt & 1) * BK * kLDW;
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 16) {
      FragA fa[kFM];
      FragB fb[kFN];
#pragma unroll
      for (int i = 0; i < kFM; ++i)
        load_a(fa[i], xs + (wm * kFM + i) * 16 * LDX + kk, LDX);
#pragma unroll
      for (int j = 0; j < kFN; ++j)
        load_b(fb[j], ws + kk * kLDW + (wn * kFN + j) * 16, kLDW);
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j) wmma::mma_sync(c[i][j], fa[i], fb[j], c[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue, over the free ring: cs [TM][LDC] f32, then ls [TM][r + 8]
  // (the tile's rows of t, 0 past M) and bs [r][LDW] (B's tile columns)
  float* cs = reinterpret_cast<float*>(smem);
  const bf16* T = p.t;
  const bf16* B = p.b;
  // adapter on the tensor cores: y = acc + s * (t[tile rows] @ B[:, tile])
  bool adapter_done = false;
  if constexpr (ADAPTER) {
    const int ldl = rank + 8;
    if (p.bwmma && n0 + kTN <= N) {
      bf16* ls = reinterpret_cast<bf16*>(cs + kTM * kLDC);
      bf16* bs = ls + kTM * ldl;
      const int rc = rank / 8;  // 16-byte copies a row of t
      for (int e = tid; e < kTM * rc; e += kThreads) {
        const int r = e / rc, c8 = (e - r * rc) * 8;
        const bool ok = m0 + r < M;
        cp_async16(ls + r * ldl + c8, T + (ok ? (m0 + r) * rank + c8 : 0), ok);
      }
      for (int e = tid; e < rank * (kTN / 8); e += kThreads) {
        const int j = e / (kTN / 8), c8 = (e % (kTN / 8)) * 8;
        cp_async16(bs + j * kLDW + c8, B + j * N + n0 + c8, true);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> ad[kFM][kFN];
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j) wmma::fill_fragment(ad[i][j], 0.f);
      for (int kk = 0; kk < rank; kk += 16) {
        FragA fa[kFM];
        FragB fb[kFN];
#pragma unroll
        for (int i = 0; i < kFM; ++i)
          load_a(fa[i], ls + (wm * kFM + i) * 16 * ldl + kk, ldl);
#pragma unroll
        for (int j = 0; j < kFN; ++j)
          load_b(fb[j], bs + kk * kLDW + (wn * kFN + j) * 16, kLDW);
#pragma unroll
        for (int i = 0; i < kFM; ++i)
#pragma unroll
          for (int j = 0; j < kFN; ++j) wmma::mma_sync(ad[i][j], fa[i], fb[j], ad[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j)
#pragma unroll
          for (int u = 0; u < c[i][j].num_elements; ++u)
            c[i][j].x[u] = add_scaled(c[i][j].x[u], p.s, ad[i][j].x[u]);
      adapter_done = true;
    }
  }
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j)
      wmma::store_matrix_sync(cs + (wm * kFM + i) * 16 * kLDC + (wn * kFN + j) * 16,
                              c[i][j], kLDC, wmma::mem_row_major);
  __syncthreads();
  auto out_val = [&](int r, int cc) {
    float v = cs[r * kLDC + cc];
    if (ADAPTER && !adapter_done) {
      const int gm = m0 + r, n = n0 + cc;
      float ad = 0.f;
      for (int j = 0; j < rank; ++j)
        ad = fmaf(__bfloat162float(T[(size_t)gm * rank + j]),
                  __bfloat162float(B[(size_t)j * N + n]), ad);
      v = add_scaled(v, p.s, ad);
    }
    return v;
  };
  if (N % 8 == 0) {  // 8 outputs (16 bytes) a store
    for (int e = tid; e < kTM * kTN / 8; e += kThreads) {
      const int r = e / (kTN / 8), cc = (e % (kTN / 8)) * 8;
      const int gm = m0 + r, n = n0 + cc;
      if (gm < M && n < N) {
        unsigned out[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              out_val(r, cc + 2 * h), out_val(r, cc + 2 * h + 1));
          out[h] = *reinterpret_cast<const unsigned*>(&v);
        }
        *reinterpret_cast<uint4*>(p.y + (size_t)gm * N + n) =
            make_uint4(out[0], out[1], out[2], out[3]);
      }
    }
  } else {
    for (int e = tid; e < kTM * kTN; e += kThreads) {
      const int r = e / kTN, cc = e - r * kTN;
      const int gm = m0 + r, n = n0 + cc;
      if (gm < M && n < N)
        p.y[(size_t)gm * N + n] = __float2bfloat16_rn(out_val(r, cc));
    }
  }
}

template <int BITS, typename S, bool ADAPTER>
int launch_tiled_t(const TiledArgs& a, cudaStream_t stream) {
  auto kern = tiled_kernel<BITS, S, ADAPTER>;
  const size_t smem = tiled_smem_bytes(a, Pack<BITS>::CPB);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
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

// Offsets into x, the codes and the scales are 32-bit ints.
inline bool tiled_args_ok(const TiledArgs& a) {
  return a.M >= 1 && a.g >= 1 && a.K % a.g == 0 && a.bk >= 16 &&
         (long long)a.M * a.K < (1LL << 31) &&
         (long long)a.K * a.N < (1LL << 31) &&
         a.bk <= kMaxBK && a.bk % 16 == 0 && a.bk % a.g == 0 &&
         (a.scale_bytes == 2 || a.scale_bytes == 4);
}

// codes, scale and zero rows can be copied 16 bytes at a time
inline bool w_vectorizable(const void* qw, const void* scale,
                           const void* zero, int N) {
  return N % 16 == 0 && aligned16(qw) && aligned16(scale) && aligned16(zero);
}

// B can feed the tensor-core epilogue straight from global memory
inline bool b_wmma_ok(const void* B, int N, int rank) {
  return N % 16 == 0 && rank % 16 == 0 &&
         reinterpret_cast<uintptr_t>(B) % 32 == 0;
}

}  // namespace qdq
