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
// Two designs, chosen by (dtype, d) in the C entry, which reports the one
// it launched:
//
// 1. bf16 at d in {64, 128, 256} (the served head dims): flash_wgmma.  One
//    block of three warpgroups per (bh, 128-row query tile).  A producer
//    warp (its warpgroup's registers cut to 24 by setmaxnreg) loads Q once
//    and K and V tiles of BK keys (128; 64 at d = 256) by TMA into a ring of
//    kRing stages in 128-byte-swizzled shared memory, each stage with its
//    own full and empty mbarriers, K one tile ahead of V; no block-wide
//    barrier inside the key loop.  Two consumer warpgroups (240 registers
//    each) own 64 query rows apiece: S = Q K^T is wgmma m64nBKk16 with both
//    operands K-major in shared memory, O += P V is wgmma m64n(d)k16 with P
//    from registers (the S accumulator rounded to bf16 pairs, which is the
//    register A layout) and V transposed from shared memory.  Inside a
//    warpgroup the next tile's Q K^T is issued before this tile's P V and
//    softmax runs while P V is in flight; between the two warpgroups named
//    barriers order the issue of their products (ping-pong), so one's
//    softmax runs under the other's products.  Only tiles that cross the
//    diagonal, the band's edge or Sk evaluate the mask.  O leaves through
//    the warpgroup's Q rows in shared memory by a TMA store.  Blocks walk
//    groups of batch-heads so that blocks running together share K and V
//    in L2 (launch_wgmma).  What ptxas needs to keep the wgmma pipeline
//    (it reports "wgmma.mma_async instructions are serialized" otherwise):
//    no call (an IEEE division is one) and no trap in the kernel, and one
//    shape of commit groups through the key loop (the first tile peeled).
// 2. f32 at every d and bf16 at d in {16, 32}: flash_fwd, the first design
//    (simple and right first; no wgmma or TMA): one block of 4 warps per
//    (bh, 64-row query tile), 16 query rows a warp.  K and V tiles of BK
//    rows (64; 32 at d = 256, where the accumulator takes 128 registers a
//    thread) are copied to shared memory with cp.async: V's copy runs
//    during Q K^T and the next K's during P V.  bf16: both products on the
//    tensor cores (mma.sync m16n8k16, operands by ldmatrix, f32
//    accumulators); P goes from the score accumulators to the A operand in
//    registers; Q stays in registers at d <= 128.  f32: the same fragment
//    layout, each product summed with f32 FMAs on the CUDA cores (no TF32).
//
// Both skip key tiles masked for every row of the block, which is exact:
// before the band the first visible tile's corr = exp(-1e30 - m) = 0 wipes
// what they added, after it p = 0.  A block holding a row that sees no key
// visits every tile.  Keys past Sk score -inf (p = 0 exactly), so any
// Sq, Sk >= 1 works.  Long query rows go first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cuda_runtime_api.h>
#include <math.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "sm90.cuh"

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
  int group;  // flash_wgmma: batch-heads a block group walks together
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


// ---------------------------------------------------------------------------
// design 1: flash_wgmma (bf16, d in {64, 128, 256})
// ---------------------------------------------------------------------------

// ring depth, ping-pong between the consumer warpgroups, and the smallest
// bf16 head dim that takes this design
constexpr int kRing = 2;
constexpr bool kPingPong = true;
constexpr int kWgmmaMinD = 64;
// the producer loads K one tile ahead of V (K_n before V_n-1), and O
// leaves through shared memory by a TMA store
constexpr bool kKAhead = true;
constexpr bool kTmaStore = true;
constexpr int kWgThreads = 384;  // producer warpgroup + 2 consumers
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

template <int D>
struct WgTile {
  static constexpr int BQ = 128;                  // query rows a block
  static constexpr int BK = D == 256 ? 64 : 128;  // keys a ring stage
  static constexpr int kAtoms = D / 64;           // 64-column TMA boxes
  static constexpr uint32_t kQBytes = BQ * D * 2, kKVBytes = BK * D * 2;
  // ring stages: at d = 256 two fill the shared memory
  static constexpr int kStages = D == 256 && kRing > 2 ? 2 : kRing;
  // 1024 bytes of slack to align the tiles for the 128-byte swizzle; then
  // Q, K stages, V stages, and 1 + 4 kStages mbarriers
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * (size_t)kStages * kKVBytes + 8 * (1 + 4 * kStages);
};

// S = Q K^T for this warpgroup's 64 rows over one key tile: d / 16 wgmma
// m64nBKk16, both operands K-major; a 64-column atom holds 4 k-steps of 32
// bytes, the next atom is a whole box further
template <int D, int BK>
__device__ __forceinline__ void qk_issue(float (&s)[BK / 2], uint32_t q,
                                         uint32_t k) {
  sm90::fence_regs(s);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32, atom = kk >> 2;
    sm90::wgmma_ss(s, sm90::desc_sw128(q + atom * 128 * 128 + off, 16, 1024),
                   sm90::desc_sw128(k + atom * BK * 128 + off, 16, 1024),
                   kk > 0);
  }
  sm90::wgmma_commit();
  sm90::fence_regs(s);
}

// O += P V over one key tile: BK / 16 wgmma m64n(D)k16, P from registers,
// V MN-major (d contiguous): 8-key groups 1024 bytes apart, 64-column
// blocks a box (BK rows of 128 bytes) apart
template <int D, int BK>
__device__ __forceinline__ void pv_issue(float (&o)[D / 2],
                                         uint32_t (&pf)[BK / 4],
                                         uint32_t v) {
  sm90::fence_regs(o);
  sm90::fence_regs(pf);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t a[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2],
                           pf[4 * kk + 3]};
    sm90::wgmma_rs(o, a, sm90::desc_sw128(v + kk * 16 * 128, BK * 128, 1024),
                   1);
  }
  sm90::wgmma_commit();
  sm90::fence_regs(o);
  sm90::fence_regs(pf);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, -inf -> 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a masked score, -1e30, in log2 units (kept exact, so p = 2^(x - m) is 1
// or 0 for it as exp(-1e30 - m) is in the Pallas kernel)
constexpr float kMasked2 = kNegInf * kLog2e;

// The online softmax of the Pallas kernel on this thread's two rows, in
// log2 units (c = scale * log2 e, applied after the dot): s becomes p
// (f32), m the running max, l the running sum of p, corr the factor for
// what O holds.  A tile every row of the warpgroup sees whole needs no
// mask: its max is taken on the raw dots (c > 0) and p = 2^(s c - m) is
// one FFMA.  Other tiles mask to -1e30 (keys past Sk to -inf) first.
template <int BK>
__device__ __forceinline__ void wg_softmax(float (&s)[BK / 2], float (&m)[2],
                                           float (&l)[2], float (&corr)[2],
                                           const Args& p, float c, int kt0,
                                           bool whole, int qr0, int qr1,
                                           int tig) {
  if (!whole) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int qi = (i & 2) ? qr1 : qr0;
      const int kj = kt0 + (i >> 2) * 8 + 2 * tig + (i & 1);
      const bool vis = (!p.causal || kj <= qi) &&
                       (p.window <= 0 || kj > qi - p.window);
      s[i] = kj >= p.sk ? -INFINITY : (vis ? s[i] * c : kMasked2);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(m[h], whole ? mx * c : mx);
    corr[h] = ex2(m[h] - mx);
    m[h] = mx;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        x = ex2(whole ? fmaf(x, c, -mx) : x - mx);
        rs += x;
      }
    l[h] = l[h] * corr[h] + rs;
  }
}

// O *= corr, per row
template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
}

// p (f32, in the S accumulator layout) rounded to bf16 pairs: the A
// fragments of P V, 4 registers a 16-key step
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pf)[BK / 4],
                                       const float (&s)[BK / 2]) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    pf[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
    pf[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

template <int D, int kStages, bool kPP>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap to, Args p) {
  using W = WgTile<D>;
  constexpr int BQ = W::BQ, BK = W::BK;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  const uint32_t s_q = (sm90::smem_addr(wg_smem) + 1023u) & ~1023u;
  const uint32_t s_k = s_q + W::kQBytes;
  const uint32_t s_v = s_k + kStages * W::kKVBytes;
  // mbarriers: Q full; per stage K full, V full, K empty, V empty
  const uint32_t bq = s_v + kStages * W::kKVBytes;
  const uint32_t bkf = bq + 8, bvf = bkf + 8 * kStages;
  const uint32_t bke = bvf + 8 * kStages, bve = bke + 8 * kStages;

  // Blocks walk groups of p.group batch-heads (launch_wgmma says why);
  // inside a group the longest query tiles go first, one per batch-head.
  const int nq = (p.sq + BQ - 1) / BQ;
  const int g = (int)blockIdx.x / (nq * p.group);
  const int rem = (int)blockIdx.x - g * nq * p.group;
  const int gs = min(p.group, p.bh - g * p.group);  // the last may be short
  const int bh = g * p.group + rem % gs;
  const int q0 = (nq - 1 - rem / gs) * BQ;
  // the key tiles this block visits: those any of its rows sees, or all of
  // them when one of its rows sees none (i >= Sk + window - 1)
  const bool win = p.window > 0;
  const int qlast = min(q0 + BQ, p.sq) - 1;
  int kbeg = 0, kend = p.sk;
  if (!(win && qlast >= p.sk + p.window - 1)) {
    if (win) kbeg = max(0, q0 - p.window + 1);
    if (p.causal) kend = min(p.sk, qlast + 1);
  }
  const int t0 = kbeg / BK, nt = (kend + BK - 1) / BK - t0;  // nt >= 1

  if (threadIdx.x == 0) {
    sm90::mbar_init(bq, 1);
    for (int st = 0; st < kStages; ++st) {
      sm90::mbar_init(bkf + 8 * st, 1);
      sm90::mbar_init(bvf + 8 * st, 1);
      sm90::mbar_init(bke + 8 * st, 8);  // one arrival per consumer warp
      sm90::mbar_init(bve + 8 * st, 8);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup, broadcast so the compiler knows it is warp-uniform (its
  // addresses and descriptors then live in uniform registers)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  if (wg == 0) {  // producer: one thread issues every copy
    sm90::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::tma_prefetch_desc(&tq);
      sm90::tma_prefetch_desc(&tk);
      sm90::tma_prefetch_desc(&tv);
      if (kTmaStore) sm90::tma_prefetch_desc(&to);
      sm90::mbar_expect_tx(bq, W::kQBytes);
#pragma unroll
      for (int a = 0; a < W::kAtoms; ++a)
        sm90::tma_load_3d(s_q + a * BQ * 128, &tq, bq, a * 64, q0, bh);
      // tile n's K (or V) into stage n % kStages once both consumers
      // released what that stage held
      const auto load = [&](const CUtensorMap* map, uint32_t tiles,
                            uint32_t full, uint32_t empty, int n) {
        const int st = n % kStages;
        sm90::mbar_wait(empty + 8 * st, ((n / kStages) & 1) ^ 1);
        sm90::mbar_expect_tx(full + 8 * st, W::kKVBytes);
#pragma unroll
        for (int a = 0; a < W::kAtoms; ++a)
          sm90::tma_load_3d(tiles + st * W::kKVBytes + a * BK * 128, map,
                            full + 8 * st, a * 64, (t0 + n) * BK, bh);
      };
      for (int n = 0; n < nt; ++n) {
        load(&tk, s_k, bkf, bke, n);
        if (!kKAhead)
          load(&tv, s_v, bvf, bve, n);
        else if (n > 0)
          load(&tv, s_v, bvf, bve, n - 1);
      }
      if (kKAhead) load(&tv, s_v, bvf, bve, nt - 1);
    }
  } else {  // consumers: 64 query rows a warpgroup
    sm90::regs_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int tig = lane & 3;
    const int wq0 = q0 + 64 * cw;  // this warpgroup's first row
    const int qr0 = wq0 + warp * 16 + (lane >> 2), qr1 = qr0 + 8;
    const int bar_me = 1 + cw, bar_other = 2 - cw;  // named barriers
    const uint32_t qa = s_q + cw * 64 * 128;  // its Q rows in each atom
    // every row of this warpgroup sees all of the key tile at kt0
    const auto whole_tile = [&](int kt0) {
      return kt0 + BK <= p.sk && (!p.causal || kt0 + BK - 1 <= wq0) &&
             (!win || kt0 > wq0 + 63 - p.window);
    };
    const float c = p.scale * kLog2e;
    float o[D / 2], s[BK / 2], m[2] = {kMasked2, kMasked2}, l[2] = {0.f, 0.f},
        corr[2];
    uint32_t pf[BK / 4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

    // ping-pong: the first consumer issues first
    if (kPP && cw == 0) sm90::bar_arrive(bar_me, 256);
    sm90::mbar_wait(bq, 0);
    // the first tile, peeled so the loop below has one shape of wgmma
    // pipeline (ptxas tracks commit groups through straight-line code)
    sm90::mbar_wait(bkf, 0);
    if (kPP) sm90::bar_sync(bar_me, 256);
    qk_issue<D, BK>(s, qa, s_k);
    if (kPP && !(cw == 1 && nt == 1)) sm90::bar_arrive(bar_other, 256);
    sm90::wgmma_wait<0>();
    if (lane == 0) sm90::mbar_arrive(bke);
    wg_softmax<BK>(s, m, l, corr, p, c, t0 * BK, whole_tile(t0 * BK), qr0,
                   qr1, tig);
    pack_p<BK>(pf, s);
    for (int n = 1; n < nt; ++n) {
      const int st = n % kStages, sp = (n - 1) % kStages;
      const uint32_t ph = (n / kStages) & 1, php = ((n - 1) / kStages) & 1;
      sm90::mbar_wait(bkf + 8 * st, ph);
      if (kPP) sm90::bar_sync(bar_me, 256);
      qk_issue<D, BK>(s, qa, s_k + st * W::kKVBytes);
      // the previous tile's P V, behind this tile's Q K^T
      rescale<D>(o, corr);
      sm90::mbar_wait(bvf + 8 * sp, php);
      pv_issue<D, BK>(o, pf, s_v + sp * W::kKVBytes);
      // the second consumer's last issue has no turn to hand on
      if (kPP && !(cw == 1 && n == nt - 1)) sm90::bar_arrive(bar_other, 256);
      sm90::wgmma_wait<1>();  // Q K^T done, P V in flight
      if (lane == 0) sm90::mbar_arrive(bke + 8 * st);
      wg_softmax<BK>(s, m, l, corr, p, c, (t0 + n) * BK,
                     whole_tile((t0 + n) * BK), qr0, qr1, tig);
      sm90::wgmma_wait<0>();
      if (lane == 0) sm90::mbar_arrive(bve + 8 * sp);
      pack_p<BK>(pf, s);
    }
    // the last tile's P V
    rescale<D>(o, corr);
    const int sl = (nt - 1) % kStages;
    sm90::mbar_wait(bvf + 8 * sl, ((nt - 1) / kStages) & 1);
    pv_issue<D, BK>(o, pf, s_v + sl * W::kKVBytes);
    sm90::wgmma_wait<0>();

    // o = acc / max(l, 1e-30), rows past Sq not stored.  Times the
    // reciprocal (within an f32 ulp of the quotient): an IEEE division
    // compiles to a called subroutine, and a call in the kernel makes
    // ptxas serialise every wgmma.
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(inv[h]) : "f"(fmaxf(lt, 1e-30f)));
    }
    if (kTmaStore) {
      // into this warpgroup's Q rows (its last Q K^T is done), in the
      // swizzled layout of the Q box, then one TMA store a 64-column box
      // (rows past Sq are clipped)
      const int r0 = warp * 16 + (lane >> 2);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          const uint32_t at = qa + (j >> 3) * BQ * 128 + r * 128 +
                              (((j & 7) ^ (r & 7)) << 4) + 4 * tig;
          __nv_bfloat162 v2 = __floats2bfloat162_rn(o[4 * j + 2 * h] * inv[h],
                                                    o[4 * j + 2 * h + 1] *
                                                        inv[h]);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                       "r"(*reinterpret_cast<uint32_t*>(&v2))
                       : "memory");
        }
      }
      sm90::fence_async_shared();
      sm90::bar_sync(3 + cw, 128);
      if (tid == 0) {
#pragma unroll
        for (int a = 0; a < W::kAtoms; ++a)
          sm90::tma_store_3d(&to, qa + a * BQ * 128, a * 64, wq0, bh);
        sm90::tma_store_wait();
      }
    } else {
      bf16* out = static_cast<bf16*>(p.o) + (size_t)bh * p.sq * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = j * 8 + 2 * tig;
        if (qr0 < p.sq)
          store2(out + (size_t)qr0 * D + c, o[4 * j] * inv[0],
                 o[4 * j + 1] * inv[0]);
        if (qr1 < p.sq)
          store2(out + (size_t)qr1 * D + c, o[4 * j + 2] * inv[1],
                 o[4 * j + 3] * inv[1]);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time so the library links no
// -lcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult got{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &got);
#endif
    return e == cudaSuccess && got == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// [bh, s, d] bf16 as a 3-d tensor map with boxes of 64 columns x `rows`,
// 128-byte swizzled; rows past s read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int bh, int s, int d,
              int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Block order.  A causal call walks groups of batch-heads, longest query
// tiles first inside a group: with about kWaveBlocksPerHead blocks of a
// batch-head in each wave of one block per SM, those blocks stream the same
// K and V tiles through L2 at about the same time, while a group as large
// as that allows keeps the longest tiles early (the tail of the last wave
// short).  A sliding window gives every tile about the same work, so a
// windowed call walks one batch-head at a time: neighbouring query tiles
// share most of their window.
constexpr int kWaveBlocksPerHead = 6;

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 132;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      count = 132;
    return count;
  }();
  return n;
}

template <int D>
int launch_wgmma(Args a, cudaStream_t stream) {
  using W = WgTile<D>;
  a.group = a.window > 0 ? 1
                         : max(1, min(a.bh, sm_count() / kWaveBlocksPerHead));
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, a.q, a.bh, a.sq, D, W::BQ) ||
      !make_map(&tk, a.k, a.bh, a.sk, D, W::BK) ||
      !make_map(&tv, a.v, a.bh, a.sk, D, W::BK) ||
      !make_map(&to, a.o, a.bh, a.sq, D, W::BQ / 2))
    return (int)cudaErrorNotSupported;
  auto kern = flash_wgmma<D, W::kStages, kPingPong>;
  const size_t smem = W::kSmem;
  static bool sized = false;  // raise the shared-memory cap once
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const long long blocks = (long long)((a.sq + W::BQ - 1) / W::BQ) * a.bh;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, kWgThreads, smem, stream>>>(tq, tk, tv, to, a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o contiguous [bh, sq | sk, d], 16-byte aligned, all bf16 or all
// f32 (is_f32); window <= 0 means none.  *design is set to the design
// launched: 1 flash_wgmma (bf16, d >= kWgmmaMinD), 0 flash_fwd (f32, and
// bf16 below that).  Returns cudaGetLastError() (cudaErrorNotSupported if
// a tensor map could not be built).
extern "C" int flash_mha_fwd(const void* q, const void* k, const void* v,
                             void* o, int bh, int sq, int sk, int d,
                             int causal, int window, float scale, int is_f32,
                             int* design, void* stream) {
  (void)cudaGetLastError();
  *design = -1;
  if (bh < 1 || sq < 1 || sk < 1) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, bh, sq, sk, causal != 0, window, scale, 1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_f32 && d >= kWgmmaMinD) {
    *design = 1;
    switch (d) {
      case 64: return launch_wgmma<64>(a, st);
      case 128: return launch_wgmma<128>(a, st);
      case 256: return launch_wgmma<256>(a, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  *design = 0;
  return is_f32 ? by_d<float>(a, d, st) : by_d<bf16>(a, d, st);
}
