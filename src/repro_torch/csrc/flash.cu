// Flash attention forward for Hopper (sm_90a): kernel 6, the counterpart of
// flash_mha_pallas (src/repro/kernels/flash.py:73), on [BH, S, d] tensors:
//
//   o[b, i] = sum_j softmax_j(scale * q[b, i] . k[b, j], masked) v[b, j]
//
// with the Pallas kernel's arithmetic: scores accumulated in f32 from the
// inputs in their own dtype and scaled after the dot; causal keeps key
// j <= query i (top-left aligned when Sq != Sk), a window > 0 also keeps
// j > i - window; masked scores are -1e30 (not -inf); the running max, l
// (a sum of the f32 p) and the output accumulator are f32; P is rounded to
// v's dtype before P @ V; the output is acc / max(l, 1e-30) in q's dtype.
// A row that sees no key gets the mean of V over all Sk keys, as there,
// where every score is -1e30 and p = exp(0) = 1.
//
// Bound: operations at the models' sequence lengths (4 d flops per visible
// (query, key) pair against q, k, v and o moved once).
//
// Design (simple and right first; no wgmma or TMA yet): one block of 4
// warps per (bh, 64-row query tile), 16 query rows a warp.  K and V tiles
// of BK rows (64; 32 at d = 256, where the accumulator takes 128 registers
// a thread) are copied to shared memory with cp.async: V's copy runs
// during Q K^T and the next K's during P V.  bf16: both products on the
// tensor cores (mma.sync m16n8k16, operands by ldmatrix, f32 accumulators);
// P goes from the score accumulators to the A operand in registers; Q stays
// in registers at d <= 128.  f32: the same fragment layout, each product
// summed with f32 FMAs on the CUDA cores (no TF32).  Key tiles masked for
// every row of the block are skipped, which is exact: before the band the
// first visible tile's corr = exp(-1e30 - m) = 0 wipes what they added,
// after it p = 0.  A block holding a row that sees no key visits every tile.
// Keys past Sk score -inf (p = 0 exactly), so any Sq, Sk >= 1 works.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64, kWarps = 4, kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;  // [BH, Sq, D]
  const void* k;  // [BH, Sk, D]
  const void* v;  // [BH, Sk, D]
  void* o;        // [BH, Sq, D]
  int bh, sq, sk, causal, window;
  float scale;
};

template <typename T, int D, int BK>
struct Layout {
  static constexpr int LD = D + 16 / (int)sizeof(T);  // 16 bytes of padding
  static constexpr int LDP = BK + 4;                  // f32 P rows (f32 only)
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr size_t bytes = (size_t)(kBQ + 2 * BK) * LD * sizeof(T) +
                                  (kF32 ? (size_t)kBQ * LDP * 4 : 0);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [row0, row0 + ROWS) of one [S, D] matrix into shared memory (row
// stride LD); rows at or past S are zeros
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int S) {
  constexpr int kVec = 16 / (int)sizeof(T), kChunks = D / kVec;
  constexpr int LD = D + kVec;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, e = (c - r * kChunks) * kVec;
    const int gr = row0 + r;
    const bool ok = gr < S;
    cp_async16(dst + r * LD + e, src + (size_t)(ok ? gr : 0) * D + e, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c[16x8] += a[16x16] b[16x8], bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Fragment layout (mma m16n8k16, also used by the f32 path): lane
// (gid = lane / 4, tig = lane % 4) holds, of each 16 x 8 tile of scores or
// outputs, rows gid (elements 0, 1) and gid + 8 (elements 2, 3) at columns
// 2 tig and 2 tig + 1.
template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads) flash_fwd(Args p) {
  using L = Layout<T, D, BK>;
  constexpr bool kF32 = L::kF32;
  constexpr int LD = L::LD, LDP = L::LDP;
  constexpr int NT = BK / 8;  // score tiles of a warp, per key tile
  constexpr int DT = D / 8;   // output tiles of a warp
  constexpr bool kQReg = !kF32 && D <= 128;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // [kBQ][LD]
  T* Ks = Qs + kBQ * LD;               // [BK][LD]
  T* Vs = Ks + BK * LD;                // [BK][LD]
  float* Ps = reinterpret_cast<float*>(Vs + BK * LD);  // [kBQ][LDP], f32 only

  const int nq = (p.sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % p.bh;
  const int q0 = (nq - 1 - (int)(blockIdx.x / p.bh)) * kBQ;  // long rows first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int mat = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
  const T* q = static_cast<const T*>(p.q) + (size_t)bh * p.sq * D;
  const T* k = static_cast<const T*>(p.k) + (size_t)bh * p.sk * D;
  const T* v = static_cast<const T*>(p.v) + (size_t)bh * p.sk * D;
  T* o = static_cast<T*>(p.o) + (size_t)bh * p.sq * D;

  // the key tiles this block visits: those any of its rows sees, or all
  // of them when one of its rows sees none (i >= Sk + window - 1)
  const bool win = p.window > 0;
  const int qlast = min(q0 + kBQ, p.sq) - 1;
  int kbeg = 0, kend = p.sk;
  if (!(win && qlast >= p.sk + p.window - 1)) {
    if (win) kbeg = max(0, q0 - p.window + 1);
    if (p.causal) kend = min(p.sk, qlast + 1);
  }
  const int t0 = kbeg / BK, t1 = (kend + BK - 1) / BK;

  const int r0 = warp * 16 + gid;  // block rows r0 and r0 + 8
  const int qr0 = q0 + r0, qr1 = qr0 + 8;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  uint32_t qf[kQReg ? D / 16 : 1][4];

  load_tile<T, D, kBQ>(Qs, q, q0, p.sq);
  load_tile<T, D, BK>(Ks, k, t0 * BK, p.sk);
  cp_async_commit();

  for (int t = t0; t < t1; ++t) {
    const int kt0 = t * BK;
    cp_async_wait_all();
    __syncthreads();  // K (and Q) in; every warp done with the last V
    if constexpr (kQReg) {
      if (t == t0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                              (lane >> 4) * 8);
      }
    }
    load_tile<T, D, BK>(Vs, v, kt0, p.sk);
    cp_async_commit();

    // s = q k^T over this key tile, f32
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    if constexpr (kF32) {
      const float* qa_row = Qs + r0 * LD;
      const float* qb_row = qa_row + 8 * LD;
#pragma unroll 4
      for (int e = 0; e < D; ++e) {
        const float qa = qa_row[e], qb = qb_row[e];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* kr = Ks + (nt * 8 + 2 * tig) * LD + e;
          const float ka = kr[0], kb = kr[LD];
          s[nt][0] = fmaf(qa, ka, s[nt][0]);
          s[nt][1] = fmaf(qa, kb, s[nt][1]);
          s[nt][2] = fmaf(qb, ka, s[nt][2]);
          s[nt][3] = fmaf(qb, kb, s[nt][3]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        if constexpr (kQReg) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
        } else {
          ldsm_x4(a, Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                         (lane >> 4) * 8);
        }
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          uint32_t b[4];
          ldsm_x4(b, Ks + (np * 16 + (mat >> 1) * 8 + mr) * LD + kk * 16 +
                         (mat & 1) * 8);
          mma_bf16(s[2 * np], a, b[0], b[1]);
          mma_bf16(s[2 * np + 1], a, b[2], b[3]);
        }
      }
    }

    // scale after the dot, then the mask (tiles every row sees whole skip it)
    const bool whole = kt0 + BK <= p.sk &&
                       (!p.causal || kt0 + BK - 1 <= q0) &&
                       (!win || kt0 > q0 + kBQ - 1 - p.window);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale;
        if (!whole) {
          const int qi = e < 2 ? qr0 : qr1;
          const int kj = kt0 + nt * 8 + 2 * tig + (e & 1);
          const bool vis = (!p.causal || kj <= qi) && (!win || kj > qi - p.window);
          x = kj >= p.sk ? -INFINITY : (vis ? x : kNegInf);
        }
        s[nt][e] = x;
      }

    // online softmax: m_new = max(m, rowmax s), p = exp(s - m_new),
    // corr = exp(m - m_new), l = l corr + rowsum p (this lane's columns;
    // the four lanes of a row add up at the end)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = exp2f((m[i] - mx) * kLog2e);
      m[i] = mx;
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe = exp2f((s[nt][2 * i + e] - mx) * kLog2e);
          s[nt][2 * i + e] = pe;
          rs += pe;
        }
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[dt][2 * i] *= corr;
        acc[dt][2 * i + 1] *= corr;
      }
    }

    cp_async_wait_all();
    __syncthreads();  // V in; every warp done with K
    if (t + 1 < t1) {
      load_tile<T, D, BK>(Ks, k, kt0 + BK, p.sk);
      cp_async_commit();
    }

    // acc += p @ v (p rounded to v's dtype first)
    if constexpr (kF32) {
      float* pw = Ps + warp * 16 * LDP;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = nt * 8 + 2 * tig;
        pw[gid * LDP + c] = s[nt][0];
        pw[gid * LDP + c + 1] = s[nt][1];
        pw[(gid + 8) * LDP + c] = s[nt][2];
        pw[(gid + 8) * LDP + c + 1] = s[nt][3];
      }
      __syncwarp();
#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        const float pa = pw[gid * LDP + j], pb = pw[(gid + 8) * LDP + j];
        const float* vr = Vs + j * LD + 2 * tig;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          const float va = vr[dt * 8], vb = vr[dt * 8 + 1];
          acc[dt][0] = fmaf(pa, va, acc[dt][0]);
          acc[dt][1] = fmaf(pa, vb, acc[dt][1]);
          acc[dt][2] = fmaf(pb, va, acc[dt][2]);
          acc[dt][3] = fmaf(pb, vb, acc[dt][3]);
        }
      }
      __syncwarp();  // P read before the next tile writes it
    } else {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t b[4];
          ldsm_x4_t(b, Vs + (kk * 16 + (mat & 1) * 8 + mr) * LD + dp * 16 +
                           (mat >> 1) * 8);
          mma_bf16(acc[2 * dp], a, b[0], b[1]);
          mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
        }
      }
    }
  }

  // o = acc / max(l, 1e-30), staged in the warp's own Q rows (no other
  // warp reads them) for 16-byte stores
  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    den[i] = fmaxf(lt, 1e-30f);
  }
  __syncwarp();
  T* ow = Qs + warp * 16 * LD;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * tig;
    store2(ow + gid * LD + c, acc[dt][0] / den[0], acc[dt][1] / den[0]);
    store2(ow + (gid + 8) * LD + c, acc[dt][2] / den[1], acc[dt][3] / den[1]);
  }
  __syncwarp();
  constexpr int kVec = 16 / (int)sizeof(T), kChunks = D / kVec;
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks, e = (c - r * kChunks) * kVec;
    const int gr = q0 + warp * 16 + r;
    if (gr < p.sq)
      *reinterpret_cast<uint4*>(o + (size_t)gr * D + e) =
          *reinterpret_cast<const uint4*>(ow + r * LD + e);
  }
}

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int BK = D == 256 ? 32 : 64;
  auto kern = flash_fwd<T, D, BK>;
  const size_t smem = Layout<T, D, BK>::bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (long long)((a.sq + kBQ - 1) / kBQ) * a.bh;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int by_d(const Args& a, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o contiguous [bh, sq | sk, d], 16-byte aligned, all bf16 or all
// f32 (is_f32); window <= 0 means none.  Returns cudaGetLastError().
extern "C" int flash_mha_fwd(const void* q, const void* k, const void* v,
                             void* o, int bh, int sq, int sk, int d,
                             int causal, int window, float scale, int is_f32,
                             void* stream) {
  (void)cudaGetLastError();
  if (bh < 1 || sq < 1 || sk < 1) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, bh, sq, sk, causal != 0, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f32 ? by_d<float>(a, d, st) : by_d<bf16>(a, d, st);
}
