// Decode-shape dequant GEMV for Hopper (sm_90a):
//   qmatvec:        y = x @ dequant(Wq)                            (kernel 2)
//   qalora_matvec:  y = x @ dequant(Wq) + s * (pool_g(x) @ A) @ B  (kernel 4)
//   qalora_slot_matvec: row i takes its own adapter from stacked banks,
//     y[i] = x[i] @ dequant(Wq) + s * (pool_g(x[i]) @ A[ids[i]]) @ B[ids[i]]
//                                                                  (kernel 5)
// for M <= 8 rows of x.
//
// Replaces qmatvec_pallas, qalora_matvec_pallas and
// qalora_slot_matvec_pallas (src/repro/kernels/qmatvec.py:68, :133, :212).
//
// Bound: bytes.  At M <= 8 each weight byte feeds at most 8 * cpb
// multiply-adds, far below the ~295 operations per byte where the H100's
// tensor cores become the limit.  But streaming at 3.35 TB/s leaves an SM
// about 5 lane-instructions per int4 code, all included, and a loop that
// dequantises on the CUDA cores and multiplies there spends M of them on
// the products alone.  So the products go to the tensor cores and the
// CUDA cores only dequantise.
//
// Design: y^T = W^T x^T on mma.sync m16n8k16 (bf16 in, f32 sums): W^T's
// 16 columns x 16 K-rows are the m16 operand, dequantised in registers
// straight from the packed code bytes into the fragment, and x^T, M
// padded to 8 with zeros, is the n8 operand, so M from 1 to 8 costs about
// the same.  A block takes 128 output columns (8 tiles of 16) with 8 warps
// that split its K-slice into runs of 16-row steps; K is also split
// across the blocks of a thread-block cluster (1 to 8, chosen so the grid
// fills the card once).  Within a step a thread takes the 16 neighbouring
// code bytes of each of its 4 / cpb byte rows (a warp reads 4 whole
// 128-byte rows), so its 4 K-rows of 16 columns land in the fragment
// slots of all 8 tiles: the K order inside a step is permuted the same
// way for W and x, which a sum does not see.  Each thread copies its own
// code bytes with 16-byte cp.async into its slots of a ring in shared
// memory, steps ahead of their use (registers would hold them only as
// long as the compiler left the loads in place).  Per code the dequant
// costs one lop3 (the code masked into the mantissa of 2^23), one add
// (its exact float value) and one FMA: w = code * scale + zero is
// computed in f32 and rounded to bf16 where the Pallas kernel rounds
// (csrc/dequant.cuh), two codes per conversion (cvt.rn.bf16x2.f32);
// code * scale is exact for bf16 scales, so one FMA gives the two rounded
// steps' result.  An int4 byte's high code is masked in place (16 * code)
// and multiplied by scale / 16, which saves its shift and is exact.  A
// block copies its K-slice of x and its groups' scale and zero rows (as
// stored, converted where they are read) into shared memory with the
// first copies.  The warps' f32 tiles are added in shared memory, and the
// cluster's blocks add the ranks' partials through distributed shared
// memory, each finishing 128 / split columns, in a fixed order (so the
// result does not depend on scheduling).
//
// The adapter modes take t = bf16(pool_g(x) @ A) [m, r] from the rank
// projection (rank_proj.cuh), launched just before the GEMV by the same C
// entry; both are launched as programmatic dependents, so the GEMV
// streams the weights while the projection runs.  B's slice for the
// block's epilogue columns goes into shared memory with the first step's
// copies and t with each warp's last step's, and the epilogue takes one
// rank-long dot product per output.
//
// Slot mode (kernel 5) reads row i's B at bank row ids[i]: every block
// reads ids[] once into shared memory (and traps on an id outside the
// bank, so a bad id never serves another tenant's weights), and rows of
// the null adapter (id 0, all zeros) skip the adapter, so a batch of null
// rows gives qmatvec's output bit for bit.  Bytes: the base's plus, per
// distinct non-null id, one adapter's A and B rows.

#include <algorithm>
#include <atomic>
#include <mutex>

#include <cooperative_groups.h>

#include "dequant.cuh"
#include "rank_proj.cuh"

using namespace qdq;
namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;       // warps a block, splitting its K-slice
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 128;      // output columns a block
constexpr int kTiles = kCols / 16;  // m16 tiles a warp, 16 columns each
constexpr int kMaxSplit = 8;    // most blocks a cluster (portable size)
constexpr int kMaxM = 8;        // GEMV_MAX_M: the mma's n8
constexpr int kBlocksWanted = 132 * 2;  // SMs x resident blocks
constexpr int kMinSteps = 4;    // 16-row steps a warp keeps at least
constexpr int kMaxRank = 128;   // as the wrappers check (MAX_RANK)
constexpr size_t kMaxSmem = 200 * 1024;
constexpr int kMaxDevices = 16;  // devices whose smem cap is remembered
// The adapter modes' projection and GEMV are launched as programmatic
// dependents (Hopper), so the GEMV streams its weights while the
// projection runs; false gives plain stream order (gemv_variants'
// `serial` variant times it).
constexpr bool kPdl = true;
static_assert(kTiles * 16 == kCols && kCols % 16 == 0, "whole tiles");

// what the GEMV adds to the base product
enum Mode { kBase = 0, kAdapter = 1, kSlot = 2 };

struct GemvArgs {
  const bf16* x;          // [m, K]
  const uint8_t* qw;      // [K / cpb, N]
  const void* scale;      // [K / g, N]
  const void* zero;       // [K / g, N]
  const bf16* t;          // [m, rank]: bf16(pool_g(x) @ A) per row, or null
  const bf16* b;          // [rank, N], a bank [n_ad, rank, N], or null
  const int* ids;         // slot mode: [m] bank rows, else null
  bf16* y;                // [m, N]
  int m, K, N, g, rank, n_ad;
  float s;
  int lg;                 // log2(g) when g is a power of two, else -1
  bool wvec;              // N % 16 == 0 and qw 16-byte aligned
  bool xvec;              // x 8-byte aligned
  bool svec;              // scale and zero 16-byte aligned
  int bs_off;             // adapter modes: B's epilogue slice in shared
                          // memory at this offset, or 0: read from global
};

// Blocks a cluster along K: double while the grid stays below what the
// card holds at once and every warp keeps kMinSteps steps.
inline int choose_split(const GemvArgs& p) {
  const int bx = (p.N + kCols - 1) / kCols, steps = (p.K + 15) / 16;
  int split = 1;
  while (split < kMaxSplit && bx * split < kBlocksWanted &&
         steps / (split * 2 * kWarps) >= kMinSteps)
    split *= 2;
  return split;
}

// a rank's steps, and the groups (scale rows) its K-slice may touch
__host__ __device__ inline int steps_per_rank(int K, int split) {
  return ((K + 15) / 16 + split - 1) / split;
}
__host__ __device__ inline int groups_per_rank(int spr, int g) {
  return (spr * 16 + g - 1) / g + 1;
}

// The code ring: kRingSteps steps of 16 code bytes a thread (BR rows of 16
// bytes a step, so 4 / BR steps), whatever the bits.
constexpr int kRingSteps = 4;
constexpr size_t kRingBytes = (size_t)kThreads * 16 * kRingSteps;

// the ring, x [m][spr * 16] bf16, then scale and zero [gmax][kCols] as
// stored; after the main loop the warps' tiles [kWarps][m][kCols] f32
// reuse it
inline size_t gemv_smem_bytes(const GemvArgs& p, int split, int scale_bytes) {
  const int spr = steps_per_rank(p.K, split);
  const size_t stage = kRingBytes + (size_t)p.m * spr * 16 * 2 +
                       2 * (size_t)groups_per_rank(spr, p.g) * kCols *
                           scale_bytes;
  const size_t red = (size_t)kWarps * p.m * kCols * 4;
  return stage > red ? stage : red;
}

// B's epilogue slice [rows][r][kCols / split] bf16, staged past the rest
// (the warps' tiles must not overwrite it) where it is small enough and
// its rows are 16-byte aligned; 0 bytes otherwise.
constexpr size_t kMaxBStage = 48 * 1024;
inline size_t b_stage_bytes(const GemvArgs& p, int split, bool slot) {
  const size_t bytes = (size_t)(slot ? p.m : 1) * p.rank * (kCols / split) * 2;
  const bool ok = p.b != nullptr && p.N % 8 == 0 && aligned16(p.b);
  return ok && bytes <= kMaxBStage ? bytes : 0;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bits `mask` of v as the exact float value of a small code (a code
// masked in place is that multiple of it): one lop3 (v & mask | the bits
// of 2^23), then one add.
__device__ __forceinline__ float masked_code_f32(unsigned v,
                                                 unsigned mask) {
  unsigned r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;"
      : "=r"(r) : "r"(v), "r"(mask), "r"(0x4B000000u));
  return __uint_as_float(r) - 8388608.f;
}

// Two rounded weights packed as a bf16x2 register (lo in the low half).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// w = code * scale + zero in f32 (c the code's exact float value): for bf16
// scales the product is exact, so one FMA rounds the sum once, as the
// separate multiply and add do; f32 scales take the two rounded steps.
template <typename S>
__device__ __forceinline__ float dq(float c, float sc, float zr) {
  if constexpr (sizeof(S) == 2) return fmaf(c, sc, zr);
  else return __fadd_rn(__fmul_rn(c, sc), zr);
}

// Copy the BR = 4 / cpb code rows of step s for this thread's 16 columns
// from nc (rows (16 s + 4 tig) / cpb + r) into its ring slot (BR uint4,
// kThreads apart): 16-byte cp.async copies, zero-filled past K or N, or
// byte loads where the row is not 16-byte aligned or runs past N.
template <int CPB, int BR>
__device__ __forceinline__ void issue_codes(const GemvArgs& p, int s, int tig,
                                            int nc, bool vec, uint4* slot) {
  const int kq = 16 * s + 4 * tig;
  const bool ok = kq < p.K && nc < p.N;
  const uint8_t* src = p.qw + (ok ? (size_t)(kq / CPB) * p.N + nc : 0);
#pragma unroll
  for (int r = 0; r < BR; ++r) {
    const uint8_t* row = src + (ok ? (size_t)r * p.N : 0);
    if (vec || !ok) {
      cp_async16(slot + r * kThreads, row, ok);
    } else {
      unsigned w[4] = {0, 0, 0, 0};
      const int lim = min(16, p.N - nc);
#pragma unroll
      for (int c = 0; c < 16; ++c)
        if (c < lim) w[c >> 2] |= (unsigned)row[c] << (8 * (c & 3));
      slot[r * kThreads] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// 4 consecutive scale or zero values from shared memory, as f32.
__device__ __forceinline__ void load4_f32(const bf16* p, float (&out)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  out[0] = __uint_as_float(u.x << 16);
  out[1] = __uint_as_float(u.x & 0xffff0000u);
  out[2] = __uint_as_float(u.y << 16);
  out[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void load4_f32(const float* p, float (&out)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}

__device__ __forceinline__ unsigned word(const uint4& u, int q) {
  return q == 0 ? u.x : q == 1 ? u.y : q == 2 ? u.z : u.w;
}

// One 16-row step: dequantise this thread's 16 columns x 4 K-rows into the
// m16 fragments of the warp's 8 tiles and multiply each by x's n8 fragment.
// Column c = 4q + b of the thread (byte b of word q) is row gq (b even) or
// gq + 8 (b odd) of tile 2q + b / 2; K-rows kq, kq + 1 fill the fragment's
// low K pair and kq + 2, kq + 3 its high pair.
template <int BITS, typename S, int BR>
__device__ __forceinline__ void mma_step(const uint4 (&cur)[BR], const S* ss,
                                         const S* zs, unsigned b0, unsigned b1,
                                         float (&acc)[kTiles][4]) {
  constexpr unsigned MASK = Pack<BITS>::MASK;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float sc[4], zr[4];
    load4_f32(ss + 4 * q, sc);
    load4_f32(zs + 4 * q, zr);
    float sh[4];  // int4: the high code is taken as 16 * code
#pragma unroll
    for (int b = 0; b < 4; ++b) sh[b] = sc[b] * 0.0625f;
    unsigned a[2][4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int jt = b >> 1, hr = b & 1;
      if constexpr (BITS == 4) {  // 2 rows: k pairs (kq, kq+1), (kq+2, kq+3)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const unsigned v = word(cur[r], q) >> (8 * b);
          const float lo = masked_code_f32(v, 0xFu);
          const float hi = masked_code_f32(v, 0xF0u);
          a[jt][hr + 2 * r] = pack_bf16(dq<S>(lo, sc[b], zr[b]),
                                        dq<S>(hi, sh[b], zr[b]));
        }
      } else if constexpr (BITS == 2) {  // 1 row: 4 codes a byte
        const unsigned v = word(cur[0], q) >> (8 * b);
        float w[4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          w[t] = dq<S>(masked_code_f32(v >> (2 * t), MASK), sc[b], zr[b]);
        a[jt][hr] = pack_bf16(w[0], w[1]);
        a[jt][hr + 2] = pack_bf16(w[2], w[3]);
      } else {  // 4 rows: one code a byte
        float w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          w[r] = dq<S>(masked_code_f32(word(cur[r], q) >> (8 * b), MASK),
                       sc[b], zr[b]);
        a[jt][hr] = pack_bf16(w[0], w[1]);
        a[jt][hr + 2] = pack_bf16(w[2], w[3]);
      }
    }
    mma_bf16(acc[2 * q], a[0], b0, b1);
    mma_bf16(acc[2 * q + 1], a[1], b0, b1);
  }
}

// t[i] @ B[:, n] in f32 over the rank, in four interleaved sums added in
// a fixed order (independent chains for the FMA pipeline); B's column n
// is read with stride `ld`.
__device__ __forceinline__ float rank_dot(const bf16* t, const bf16* b,
                                          size_t ld, int rank) {
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  int r = 0;
#pragma unroll 4
  for (; r + 4 <= rank; r += 4)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      a[u] = fmaf(__bfloat162float(t[r + u]),
                  __bfloat162float(b[(r + u) * ld]), a[u]);
  for (; r < rank; ++r)
    a[0] = fmaf(__bfloat162float(t[r]), __bfloat162float(b[r * ld]), a[0]);
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// The cluster's blocks finish the block's kCols columns together: rank ks
// takes columns [ks, ks + 1) * kCols / split.  Output (i, n) is the sum of
// the ranks' partials in rank order, plus s * t[i] @ B[:, n] for rows with
// an adapter, from t and B's slice in shared memory (or B from global
// memory where its slice was not staged).
template <bool SLOT, bool ADAPTER>
__device__ __forceinline__ void gemv_epilogue(const GemvArgs& p,
                                              const float* part,
                                              const bf16* bs, const bf16* ts,
                                              const int* sid,
                                              cg::cluster_group& cluster,
                                              int ks, int split, int n0) {
  const int m = p.m, N = p.N, rank = p.rank;
  const int cps = kCols / split, c0 = ks * cps, outs = m * cps;
  for (int o = threadIdx.x; o < outs; o += blockDim.x) {
    const int i = o / cps, c = c0 + o - i * cps, n = n0 + c;
    if (n >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int r2 = 0; r2 < kMaxSplit; ++r2)
      if (r2 < split) v += cluster.map_shared_rank(part, r2)[i * kCols + c];
    if (ADAPTER && (!SLOT || sid[i] != 0)) {
      const float ad =
          p.bs_off  // B's slice [rows][r][cps] in shared memory
              ? rank_dot(ts + i * rank,
                         bs + (SLOT ? i : 0) * rank * cps + (c - c0), cps,
                         rank)
              : rank_dot(ts + i * rank,
                         p.b + (SLOT ? (size_t)sid[i] * rank * N : 0) + n, N,
                         rank);
      v = add_scaled(v, p.s, ad);
    }
    p.y[(size_t)i * N + n] = __float2bfloat16_rn(v);
  }
}

// Staging: each thread keeps kStageU loads in flight before it stores
// any, so a block's staging costs about one memory latency.
constexpr int kStageU = 4;

// x's K-slice [m][kw] into xs [m][xw]: 8-byte cp.async copies in the
// current commit group where x is 8-byte aligned, else element loads.
__device__ __forceinline__ void stage_x(const GemvArgs& p, bf16* xs, int xw,
                                        int k_lo, int kw) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (p.xvec) {
    const int per = kw / 4;
    for (int e = tid; e < p.m * per; e += nt) {
      const int i = e / per, kk = 4 * (e - i * per);
      cp_async8(xs + i * xw + kk, p.x + (size_t)i * p.K + k_lo + kk);
    }
  } else {
    for (int e0 = tid; e0 < p.m * kw; e0 += kStageU * nt) {
      bf16 v[kStageU];
#pragma unroll
      for (int u = 0; u < kStageU; ++u) {
        const int e = e0 + u * nt, i = e / kw, kk = e - i * kw;
        if (e < p.m * kw) v[u] = p.x[(size_t)i * p.K + k_lo + kk];
      }
#pragma unroll
      for (int u = 0; u < kStageU; ++u) {
        const int e = e0 + u * nt, i = e / kw, kk = e - i * kw;
        if (e < p.m * kw) xs[i * xw + kk] = v[u];
      }
    }
  }
}

// The groups [grp_lo, grp_lo + ngrp) of scale and zero for the block's
// columns from n0, as stored, into ss and zs [ngrp][kCols] (zeros past N):
// 16-byte cp.async copies in the current commit group where the rows
// allow, else element loads.
template <typename S>
__device__ __forceinline__ void stage_scales(const GemvArgs& p, const S* scale,
                                             const S* zero, S* ss, S* zs,
                                             int grp_lo, int ngrp, int n0) {
  constexpr int V = 16 / sizeof(S);  // values a 16-byte copy
  const int tid = threadIdx.x, nt = blockDim.x, N = p.N;
  if (p.svec && (N * (int)sizeof(S)) % 16 == 0) {
    constexpr int per = kCols / V;
    for (int e = tid; e < ngrp * per; e += nt) {
      const int gl = e / per, c = (e - gl * per) * V;
      const bool ok = n0 + c < N;
      const size_t o = ok ? (size_t)(grp_lo + gl) * N + n0 + c : 0;
      cp_async16(ss + gl * kCols + c, scale + o, ok);
      cp_async16(zs + gl * kCols + c, zero + o, ok);
    }
  } else {
    for (int e = tid; e < ngrp * kCols; e += nt) {
      const int gl = e / kCols, c = e - gl * kCols;
      const size_t o = (size_t)(grp_lo + gl) * N + n0 + c;
      const bool ok = n0 + c < N;
      ss[e] = ok ? scale[o] : S(0.f);
      zs[e] = ok ? zero[o] : S(0.f);
    }
  }
}

// t [m][r] into ts: 16-byte cp.async copies where t's rows allow, else
// element loads.
__device__ __forceinline__ void stage_t(const GemvArgs& p, bf16* ts) {
  const int n = p.m * p.rank;
  if (p.rank % 8 == 0 && reinterpret_cast<uintptr_t>(p.t) % 16 == 0) {
    for (int e = threadIdx.x; e < n / 8; e += blockDim.x)
      cp_async16(ts + 8 * e, p.t + 8 * e, true);
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x) ts[e] = p.t[e];
  }
}

// B's rows for this rank's epilogue columns [n, n + cols) (each row's
// adapter's, bank row sid[i], in slot mode), copied with 16-byte cp.async
// into bs [rows][r][cols] (zeros past N).
template <bool SLOT>
__device__ __forceinline__ void stage_b(const GemvArgs& p, const int* sid,
                                        bf16* bs, int n, int cols) {
  const int rows = SLOT ? p.m : 1, rank = p.rank, per = cols / 8;
  for (int e = threadIdx.x; e < rows * rank * per; e += blockDim.x) {
    const int i = e / (rank * per), rr = e - i * rank * per;
    const int r = rr / per, c = 8 * (rr - r * per);
    const int id = SLOT ? sid[i] : 0;
    if (SLOT && id == 0) continue;  // null rows skip B
    const bool ok = n + c < p.N;
    const bf16* src = p.b + ((size_t)id * rank + r) * p.N + n + c;
    cp_async16(bs + (i * rank + r) * cols + c, ok ? src : p.b, ok);
  }
}

template <int BITS, typename S, int MODE>
__global__ void __launch_bounds__(kWarps * 32, 2)
gemv_kernel(GemvArgs p) {
  constexpr int CPB = Pack<BITS>::CPB;
  constexpr int BR = 4 / CPB;  // code rows a thread reads a step
  constexpr int D = kRingSteps / BR;  // ring slots: D - 1 steps in flight
  constexpr bool ADAPTER = MODE != kBase, SLOT = MODE == kSlot;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float part[kMaxM * kCols];                 // this block's sums
  __shared__ __align__(16) bf16 ts[ADAPTER ? kMaxM * kMaxRank : 1];  // t
  __shared__ int sid[kMaxM];                            // slot: bank rows

  cg::cluster_group cluster = cg::this_cluster();
  const S* scale = static_cast<const S*>(p.scale);
  const S* zero = static_cast<const S*>(p.zero);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tig = lane & 3;
  const int m = p.m, K = p.K, N = p.N, g = p.g;
  const int n0 = blockIdx.x * kCols, split = gridDim.y;
  const int ks = blockIdx.y;  // == cluster.block_rank()
  const int steps = (K + 15) / 16, spr = steps_per_rank(K, split);
  const int s_lo = min(steps, ks * spr), s_hi = min(steps, s_lo + spr);
  const int k_lo = s_lo * 16, k_hi = min(K, s_hi * 16), kw = k_hi - k_lo;
  const int grp_lo = k_lo / g;
  const int ngrp = kw > 0 ? (k_hi - 1) / g - grp_lo + 1 : 0;
  const int gmax = groups_per_rank(spr, g), xw = spr * 16;
  // ring [D][BR][kThreads] uint4: each thread reads only what it copied
  uint4* ring = reinterpret_cast<uint4*>(smem) + threadIdx.x;
  bf16* xs = reinterpret_cast<bf16*>(smem + kRingBytes);       // [m][xw]
  S* ss = reinterpret_cast<S*>(smem + kRingBytes + (size_t)m * xw * 2);
  S* zs = ss + gmax * kCols;                                   // [gmax][kCols]

  // this warp's run of steps, and this thread's 16 columns
  const int nsb = s_hi - s_lo, spw = (nsb + kWarps - 1) / kWarps;
  const int w_lo = s_lo + min(nsb, warp * spw);
  const int w_hi = s_lo + min(nsb, (warp + 1) * spw);
  const int lc0 = 16 * gq, nc = n0 + lc0;
  const bool vec = p.wvec && nc + 16 <= N;

  // x's K-slice and the slice's scale and zero go out in one commit group,
  // then the first D - 1 steps' codes, one group a step.  The epilogue's
  // operands go out with the main loop's copies, so they arrive under its
  // waits: B's slice with the first step, t with each warp's last step.
  // t is the projection's output, so the thread first waits for the
  // projection (launched before this grid with programmatic dependent
  // launch; long done by then) to complete.
  bf16* bs = reinterpret_cast<bf16*>(smem + p.bs_off);
  auto issue_b = [&]() {
    if (ADAPTER && p.bs_off)
      stage_b<SLOT>(p, sid, bs, n0 + ks * (kCols / split), kCols / split);
  };
  auto issue_t = [&]() {
    if (!ADAPTER) return;
    asm volatile("griddepcontrol.wait;" ::: "memory");
    stage_t(p, ts);
  };
  stage_x(p, xs, xw, k_lo, kw);
  stage_scales<S>(p, scale, zero, ss, zs, grp_lo, ngrp, n0);
  cp_async_commit();
#pragma unroll
  for (int d = 0; d < D - 1; ++d) {
    if (w_lo + d < w_hi) {
      issue_codes<CPB, BR>(p, w_lo + d, tig, nc, vec, ring + d * BR * kThreads);
      if (w_lo + d == w_hi - 1) issue_t();
    }
    cp_async_commit();
  }

  if (SLOT && tid < m) {  // ids[] once, off the codes' critical path
    const int id = p.ids[tid];
    if (id < 0 || id >= p.n_ad) __trap();
    sid[tid] = id;
  }
  cp_async_wait<D - 1>();
  __syncthreads();
  if (w_lo == w_hi) {  // a warp without steps
    issue_b();
    issue_t();
    cp_async_commit();
  }

  float acc[kTiles][4];
#pragma unroll
  for (int j = 0; j < kTiles; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = 0.f;
  const bf16* xrow = xs + gq * xw;  // this lane's row of x (gq < m)
  for (int s = w_lo; s < w_hi; ++s) {
    const int i = s - w_lo;
    // step s + D - 1 into the slot step s - 1 left, then wait for step s
    if (s + D - 1 < w_hi) {
      issue_codes<CPB, BR>(p, s + D - 1, tig, nc, vec,
                           ring + ((i + D - 1) & (D - 1)) * BR * kThreads);
      if (s + D - 1 == w_hi - 1) issue_t();
    }
    if (s == w_lo) issue_b();
    cp_async_commit();
    cp_async_wait<D - 1>();
    uint4 cur[BR];
#pragma unroll
    for (int r = 0; r < BR; ++r)
      cur[r] = ring[((i & (D - 1)) * BR + r) * kThreads];
    const int kq = 16 * s + 4 * tig;
    unsigned b0 = 0, b1 = 0;  // x rows past m, and K-rows past K: zeros
    int gl = 0;
    if (kq < K) {
      gl = (p.lg >= 0 ? kq >> p.lg : kq / g) - grp_lo;
      if (gq < m) {
        const uint2 v = *reinterpret_cast<const uint2*>(xrow + (kq - k_lo));
        b0 = v.x;
        b1 = v.y;
      }
    }
    const int so = gl * kCols + lc0;
    mma_step<BITS, S, BR>(cur, ss + so, zs + so, b0, b1, acc);
  }

  // the warps' tiles, then this block's sums, then the cluster's
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring and staged operands
  float* red = reinterpret_cast<float*>(smem);  // [kWarps][m][kCols]
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const int c = lc0 + 2 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 2 * tig + h;
      if (i < m) {
        red[(warp * m + i) * kCols + c] = acc[j][h];
        red[(warp * m + i) * kCols + c + 1] = acc[j][2 + h];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < m * kCols; e += blockDim.x) {
    float v = 0.f;
    for (int w2 = 0; w2 < kWarps; ++w2) v += red[w2 * m * kCols + e];
    part[e] = v;
  }
  cluster.sync();
  gemv_epilogue<SLOT, ADAPTER>(p, part, bs, ts, sid, cluster, ks, split, n0);
  cluster.sync();  // the other blocks' shared memory stays until all are done
}

// pdl: launch as the programmatic dependent of the kernel before it on the
// stream (the projection), which lets this grid start before it ends.
template <int BITS, typename S, int MODE>
int launch(GemvArgs a, bool pdl, cudaStream_t stream) {
  auto kern = gemv_kernel<BITS, S, MODE>;
  const int split = choose_split(a);
  size_t smem = gemv_smem_bytes(a, split, sizeof(S));
  const size_t bstage = MODE == kBase ? 0 : b_stage_bytes(a, split,
                                                          MODE == kSlot);
  smem = (smem + 15) / 16 * 16;
  a.bs_off = bstage ? (int)smem : 0;
  smem += bstage;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  // + ~8 KB static: past the 48 KB default.  The cap only grows, to the
  // largest size launched so far on the device, and is set when it must
  // grow, not on every launch: decode issues this launch 224 times a step
  // from a host that sets the step's time.
  static std::atomic<int> cap[kMaxDevices];
  static std::mutex cap_mu;
  if (smem > 32 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= kMaxDevices || cap[dev].load() < (int)smem) {
      std::lock_guard<std::mutex> lock(cap_mu);
      const int want = dev < kMaxDevices
                           ? std::max(cap[dev].load(), (int)smem) : (int)smem;
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, want);
      if (e != cudaSuccess) return (int)e;
      if (dev < kMaxDevices) cap[dev].store(want);
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + kCols - 1) / kCols, split, 1);
  cfg.blockDim = dim3(kWarps * 32, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 2 : 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename S, int MODE>
int by_bits(const GemvArgs& a, int bits, bool pdl, cudaStream_t stream) {
  switch (bits) {
    case 2: return launch<2, S, MODE>(a, pdl, stream);
    case 3: return launch<3, S, MODE>(a, pdl, stream);
    case 4: return launch<4, S, MODE>(a, pdl, stream);
    case 8: return launch<8, S, MODE>(a, pdl, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int MODE>
int by_scale(const GemvArgs& a, int bits, int scale_is_f32, bool pdl,
             cudaStream_t st) {
  return scale_is_f32 ? by_bits<float, MODE>(a, bits, pdl, st)
                      : by_bits<bf16, MODE>(a, bits, pdl, st);
}

bool args_ok(const GemvArgs& a) {
  return a.m >= 1 && a.m <= kMaxM && a.g >= 1 && a.K % a.g == 0 &&
         a.g % 4 == 0 && a.rank >= 0 && a.rank <= kMaxRank;
}

// The operands' layout facts the kernel takes from the host.
GemvArgs gemv_args(const void* x, const void* qw, const void* scale,
                   const void* zero, const void* t, const void* B,
                   const void* ids, void* y, int m, int K, int N, int g,
                   int rank, int n_ad, float s) {
  int lg = -1;
  for (int v = 0; v < 31; ++v)
    if (g == 1 << v) lg = v;
  return GemvArgs{static_cast<const bf16*>(x),
                  static_cast<const uint8_t*>(qw), scale, zero,
                  static_cast<const bf16*>(t), static_cast<const bf16*>(B),
                  static_cast<const int*>(ids), static_cast<bf16*>(y),
                  m, K, N, g, rank, n_ad, s, lg,
                  N % 16 == 0 && aligned16(qw),
                  reinterpret_cast<uintptr_t>(x) % 8 == 0,
                  aligned16(scale) && aligned16(zero), 0};
}

}  // namespace

extern "C" int qmatvec_bf16(const void* x, const void* qw, const void* scale,
                            const void* zero, void* y, int m, int K, int N,
                            int g, int bits, int scale_is_f32, void* stream) {
  (void)cudaGetLastError();
  const GemvArgs a = gemv_args(x, qw, scale, zero, nullptr, nullptr, nullptr,
                               y, m, K, N, g, 0, 0, 0.f);
  if (!args_ok(a)) return (int)cudaErrorInvalidValue;
  return by_scale<kBase>(a, bits, scale_is_f32, false,
                         static_cast<cudaStream_t>(stream));
}

// The fused product in two launches on `stream`: the projection into the
// caller's scratch t [m, rank] (bf16), then the GEMV.  launched[0] and
// launched[1] say which of the two were launched.
extern "C" int qalora_matvec_bf16(const void* x, const void* qw,
                                  const void* scale, const void* zero,
                                  const void* A, const void* B, void* t,
                                  void* y, int m, int K, int N, int g,
                                  int rank, float s, int bits,
                                  int scale_is_f32, int* launched,
                                  void* stream) {
  (void)cudaGetLastError();
  launched[0] = launched[1] = 0;
  const GemvArgs a = gemv_args(x, qw, scale, zero, t, B, nullptr, y, m, K,
                               N, g, rank, 1, s);
  if (!args_ok(a) || rank < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = launch_rank_proj<1, false>(x, A, nullptr, t, m, K, g, rank, 1,
                                      kPdl, st);
  if (rc != 0) return rc;
  launched[0] = 1;
  rc = by_scale<kAdapter>(a, bits, scale_is_f32, kPdl, st);
  launched[1] = rc == 0;
  return rc;
}

// The projection alone, as the adapter GEMV launches it (one row of x a
// block): t = bf16(bf16(pool_sum_g(x)) @ A).
extern "C" int qalora_gemv_rank_proj_bf16(const void* x, const void* A,
                                          void* t, int m, int K, int g,
                                          int rank, void* stream) {
  (void)cudaGetLastError();
  return launch_rank_proj<1, false>(x, A, nullptr, t, m, K, g, rank, 1, false,
                                    static_cast<cudaStream_t>(stream));
}

// Slot projection alone: t[i] = bf16(bf16(pool_sum_g(x[i])) @ A[ids[i]]),
// A a bank [n_ad, K / g, rank]; rows of id 0 give zeros.
extern "C" int qalora_slot_rank_proj_bf16(const void* x, const void* A,
                                          const void* ids, void* t, int m,
                                          int K, int g, int rank, int n_ad,
                                          void* stream) {
  (void)cudaGetLastError();
  if (m < 1 || n_ad < 1) return (int)cudaErrorInvalidValue;
  return launch_rank_proj<1, true>(x, A, static_cast<const int*>(ids), t, m,
                                   K, g, rank, n_ad, false,
                                   static_cast<cudaStream_t>(stream));
}

// A and B are banks [n_ad, K / g, rank] and [n_ad, rank, N]; ids [m] int32
// on the device, each in [0, n_ad).  The slot projection into the caller's
// scratch t, then the GEMV; launched[] as for qalora_matvec_bf16.
extern "C" int qalora_slot_matvec_bf16(const void* x, const void* qw,
                                       const void* scale, const void* zero,
                                       const void* A, const void* B,
                                       const void* ids, void* t, void* y,
                                       int m, int K, int N, int g, int rank,
                                       int n_ad, float s, int bits,
                                       int scale_is_f32, int* launched,
                                       void* stream) {
  (void)cudaGetLastError();
  launched[0] = launched[1] = 0;
  const GemvArgs a = gemv_args(x, qw, scale, zero, t, B, ids, y, m, K, N, g,
                               rank, n_ad, s);
  if (!args_ok(a) || rank < 1 || n_ad < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = launch_rank_proj<1, true>(x, A, static_cast<const int*>(ids), t,
                                     m, K, g, rank, n_ad, kPdl, st);
  if (rc != 0) return rc;
  launched[0] = 1;
  rc = by_scale<kSlot>(a, bits, scale_is_f32, kPdl, st);
  launched[1] = rc == 0;
  return rc;
}
