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
// tensor cores become the limit, so the kernel's time is the packed-code
// stream, and the design is about keeping enough bytes in flight.
//
// Design: one thread per output column, so a warp reads 32 neighbouring
// bytes of a packed row (one 32-byte sector).  K is split twice: across
// the blocks of a thread-block cluster (Hopper; 1 to 8 blocks, chosen so
// the grid fills the card), and inside a block across its warps, group by
// group; each warp reads a group's scale and zero once and keeps M f32
// accumulators in registers (M rounded up to 1, 2, 4 or 8 at compile
// time, so the inner loop has no predicates).  A block stages its K-slice
// of x in shared memory once, in f32, and reads the rows a packed byte
// covers with one vector load.  The warps' partial sums are
// added in shared memory, and the cluster's rank-0 block adds the blocks'
// partials through distributed shared memory, in a fixed order (so the
// result does not depend on scheduling), before the epilogue.  The
// adapter path pools the staged x over groups (f32 sums rounded to bf16),
// contracts it with A's K-slice (cast to bf16) into a [M, r] f32 partial,
// which rank 0 also adds up; B is applied once per column in the epilogue.
//
// Slot mode (kernel 5) is the adapter path with per-row bank offsets:
// every block reads ids[] once into shared memory (and traps on an id
// outside the bank, so a bad id never serves another tenant's weights),
// row i's A and B pointers move to bank row ids[i], and rows of the null
// adapter (id 0, all zeros) skip the adapter work, so a batch of null
// rows gives qmatvec's output bit for bit.  The base loop and the split
// are kernel 2's.  Bytes: the base's plus, per distinct non-null id, one
// adapter's A and B rows.

#include <cooperative_groups.h>

#include "dequant.cuh"

using namespace qdq;
namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;     // warps per block, splitting its K-slice
constexpr int kCols = 32;     // output columns per block: one per lane
constexpr int kMaxSplit = 8;  // most blocks per cluster (portable size)
constexpr int kMaxM = 8;      // GEMV_MAX_M
constexpr int kBlocksWanted = 132 * 8;  // SMs x resident blocks
constexpr int kMaxRank = 128;
constexpr size_t kMaxSmem = 200 * 1024;

// what the GEMV adds to the base product
enum Mode { kBase = 0, kAdapter = 1, kSlot = 2 };

struct GemvArgs {
  const bf16* x;          // [m, K]
  const uint8_t* qw;      // [K / cpb, N]
  const void* scale;      // [K / g, N]
  const void* zero;       // [K / g, N]
  const bf16* a;          // [K / g, rank], a bank [n_ad, K / g, rank], or null
  const bf16* b;          // [rank, N], a bank [n_ad, rank, N], or null
  const int* ids;         // slot mode: [m] bank rows, else null
  bf16* y;                // [m, N]
  int m, K, N, g, rank, n_ad;
  float s;
};

// Blocks per cluster along K: double while the grid stays within what
// the card holds at once and every warp keeps at least one group.
inline int choose_split(const GemvArgs& p) {
  const int bx = (p.N + kCols - 1) / kCols, L = p.K / p.g;
  int split = 1;
  while (split < kMaxSplit && bx * split * 2 <= kBlocksWanted &&
         L / (split * 2) >= kWarps)
    split *= 2;
  return split;
}

inline int m_rounded(int m) { return m <= 1 ? 1 : m <= 2 ? 2 : m <= 4 ? 4 : 8; }

inline size_t gemv_smem_bytes(const GemvArgs& p, int split, bool adapter) {
  const size_t gpb = (p.K / p.g + split - 1) / split;
  const size_t mt = m_rounded(p.m);
  return mt * gpb * p.g * 4 + (adapter ? (size_t)p.m * gpb * 4 : 0);
}

template <int CPB>
__device__ __forceinline__ void load_x(const float* src, float (&out)[CPB]) {
  if constexpr (CPB == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (CPB == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    out[0] = v.x; out[1] = v.y;
  } else {
    out[0] = *src;
  }
}

template <int BITS, int MT, typename S, int MODE>
__global__ void __launch_bounds__(kWarps * 32)
gemv_kernel(GemvArgs p) {
  constexpr int CPB = Pack<BITS>::CPB;
  constexpr bool ADAPTER = MODE != kBase, SLOT = MODE == kSlot;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps][kMaxM][kCols];
  __shared__ float part[kMaxM * kCols];                  // this block's sums
  __shared__ float lpart[ADAPTER ? kMaxM * kMaxRank : 1];  // its pooled @ A
  __shared__ float ltot[ADAPTER ? kMaxM * kMaxRank : 1];   // rank 0: all
  __shared__ int sid[kMaxM];                               // slot: bank rows

  cg::cluster_group cluster = cg::this_cluster();
  const S* scale = static_cast<const S*>(p.scale);
  const S* zero = static_cast<const S*>(p.zero);
  const bf16* A = p.a;
  const bf16* B = p.b;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = p.m, K = p.K, N = p.N, g = p.g, rank = p.rank;
  const int n = blockIdx.x * kCols + lane;
  const bool col_ok = n < N;
  const int L = K / g, split = gridDim.y;
  const int gpb = (L + split - 1) / split;
  const int ks = blockIdx.y;  // == cluster.block_rank()
  const int g_lo = min(L, ks * gpb), ng = min(L, g_lo + gpb) - g_lo;
  const int k_lo = g_lo * g, rows = ng * g;
  float* xs = reinterpret_cast<float*>(smem);                      // [MT][rows]
  float* pooled = xs + (size_t)MT * gpb * g;                       // [m][gpb]

  if (SLOT && tid < m) {
    const int id = p.ids[tid];
    if (id < 0 || id >= p.n_ad) __trap();
    sid[tid] = id;
  }
  // stage this block's K-slice of x in f32; rows m..MT-1 are zero
  for (int e = tid; e < MT * rows; e += blockDim.x) {
    const int i = e / rows, kk = e - i * rows;
    xs[i * rows + kk] =
        i < m ? __bfloat162float(p.x[(size_t)i * K + k_lo + kk]) : 0.f;
  }
  __syncthreads();

  if (ADAPTER) {
    // pooled = pool_sum_g(x) in f32, rounded to the activation dtype
    for (int e = tid; e < m * ng; e += blockDim.x) {
      const int i = e / ng, gl = e - i * ng;
      float v = 0.f;
      for (int t = 0; t < g; ++t) v += xs[i * rows + gl * g + t];
      pooled[i * gpb + gl] = round_bf16(v);
    }
    __syncthreads();
    // lpart[m, r] = pooled @ A[K-slice] (A is bf16, the activation dtype)
    for (int e = tid; e < m * rank; e += blockDim.x) {
      const int i = e / rank, r = e - i * rank;
      const bf16* Ai = SLOT ? A + (size_t)sid[i] * L * rank : A;
      float v = 0.f;
      if (!SLOT || sid[i] != 0) {
#pragma unroll 8
        for (int gl = 0; gl < ng; ++gl)
          v = fmaf(pooled[i * gpb + gl],
                   __bfloat162float(Ai[(size_t)(g_lo + gl) * rank + r]), v);
      }
      lpart[e] = v;
    }
  }

  float acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i] = 0.f;
  if (col_ok) {
    for (int gl = warp; gl < ng; gl += kWarps) {
      const int grp = g_lo + gl;
      const float sc = to_f32(scale[(size_t)grp * N + n]);
      const float zr = to_f32(zero[(size_t)grp * N + n]);
      const uint8_t* qp = p.qw + (size_t)(grp * (g / CPB)) * N + n;
      const float* xg = xs + gl * g;
#pragma unroll 8
      for (int rb = 0; rb < g / CPB; ++rb) {
        const unsigned byte = __ldg(qp + (size_t)rb * N);
        float w[CPB];
#pragma unroll
        for (int t = 0; t < CPB; ++t)
          w[t] = dequant_bf16(code_of<BITS>(byte, t), sc, zr);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          float xv[CPB];
          load_x<CPB>(xg + i * rows + rb * CPB, xv);
#pragma unroll
          for (int t = 0; t < CPB; ++t) acc[i] = fmaf(xv[t], w[t], acc[i]);
        }
      }
    }
  }

  // this block's partial sums, then the cluster's, in rank order
#pragma unroll
  for (int i = 0; i < MT; ++i)
    if (i < m) red[warp][i][lane] = acc[i];
  __syncthreads();
  if (warp < m) {
    float v = 0.f;
    for (int w2 = 0; w2 < kWarps; ++w2) v += red[w2][warp][lane];
    part[warp * kCols + lane] = v;
  }
  cluster.sync();
  if (ks == 0) {
    if (ADAPTER) {
      for (int e = tid; e < m * rank; e += blockDim.x) {
        float v = 0.f;
        for (int r2 = 0; r2 < split; ++r2) v += cluster.map_shared_rank(lpart, r2)[e];
        ltot[e] = v;
      }
      __syncthreads();
    }
    if (warp < m && col_ok) {
      const int i = warp;
      float v = 0.f;
      for (int r2 = 0; r2 < split; ++r2)
        v += cluster.map_shared_rank(part, r2)[i * kCols + lane];
      if (ADAPTER && (!SLOT || sid[i] != 0)) {
        const bf16* Bi = SLOT ? B + (size_t)sid[i] * rank * N : B;
        float ad = 0.f;
#pragma unroll 8
        for (int r = 0; r < rank; ++r)
          ad = fmaf(round_bf16(ltot[i * rank + r]),
                    __bfloat162float(Bi[(size_t)r * N + n]), ad);
        v = add_scaled(v, p.s, ad);
      }
      p.y[(size_t)i * N + n] = __float2bfloat16_rn(v);
    }
  }
  cluster.sync();  // the other blocks' shared memory stays until rank 0 is done
}

template <int BITS, int MT, typename S, int MODE>
int launch(const GemvArgs& a, cudaStream_t stream) {
  auto kern = gemv_kernel<BITS, MT, S, MODE>;
  const int split = choose_split(a);
  const size_t smem = gemv_smem_bytes(a, split, MODE != kBase);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 24 * 1024) {  // + ~17 KB static: past the 48 KB default
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + kCols - 1) / kCols, split, 1);
  cfg.blockDim = dim3(kWarps * 32, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int BITS, typename S, int MODE>
int by_m(const GemvArgs& a, cudaStream_t stream) {
  switch (m_rounded(a.m)) {
    case 1: return launch<BITS, 1, S, MODE>(a, stream);
    case 2: return launch<BITS, 2, S, MODE>(a, stream);
    case 4: return launch<BITS, 4, S, MODE>(a, stream);
    default: return launch<BITS, 8, S, MODE>(a, stream);
  }
}

template <typename S, int MODE>
int by_bits(const GemvArgs& a, int bits, cudaStream_t stream) {
  switch (bits) {
    case 2: return by_m<2, S, MODE>(a, stream);
    case 3: return by_m<3, S, MODE>(a, stream);
    case 4: return by_m<4, S, MODE>(a, stream);
    case 8: return by_m<8, S, MODE>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int MODE>
int by_scale(const GemvArgs& a, int bits, int scale_is_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return scale_is_f32 ? by_bits<float, MODE>(a, bits, st)
                      : by_bits<bf16, MODE>(a, bits, st);
}

bool args_ok(const GemvArgs& a) {
  return a.m >= 1 && a.m <= kMaxM && a.g >= 1 && a.K % a.g == 0 &&
         a.g % 4 == 0 && a.rank >= 0 && a.rank <= kMaxRank;
}

}  // namespace

extern "C" int qmatvec_bf16(const void* x, const void* qw, const void* scale,
                            const void* zero, void* y, int m, int K, int N,
                            int g, int bits, int scale_is_f32, void* stream) {
  (void)cudaGetLastError();
  const GemvArgs a{static_cast<const bf16*>(x), static_cast<const uint8_t*>(qw),
                   scale, zero, nullptr, nullptr, nullptr, static_cast<bf16*>(y),
                   m, K, N, g, 0, 0, 0.f};
  if (!args_ok(a)) return (int)cudaErrorInvalidValue;
  return by_scale<kBase>(a, bits, scale_is_f32, stream);
}

extern "C" int qalora_matvec_bf16(const void* x, const void* qw,
                                  const void* scale, const void* zero,
                                  const void* A, const void* B, void* y,
                                  int m, int K, int N, int g, int rank,
                                  float s, int bits, int scale_is_f32,
                                  void* stream) {
  (void)cudaGetLastError();
  const GemvArgs a{static_cast<const bf16*>(x), static_cast<const uint8_t*>(qw),
                   scale, zero, static_cast<const bf16*>(A),
                   static_cast<const bf16*>(B), nullptr, static_cast<bf16*>(y),
                   m, K, N, g, rank, 1, s};
  if (!args_ok(a) || rank < 1) return (int)cudaErrorInvalidValue;
  return by_scale<kAdapter>(a, bits, scale_is_f32, stream);
}

// A and B are banks [n_ad, K / g, rank] and [n_ad, rank, N]; ids [m] int32
// on the device, each in [0, n_ad).
extern "C" int qalora_slot_matvec_bf16(const void* x, const void* qw,
                                       const void* scale, const void* zero,
                                       const void* A, const void* B,
                                       const void* ids, void* y, int m, int K,
                                       int N, int g, int rank, int n_ad,
                                       float s, int bits, int scale_is_f32,
                                       void* stream) {
  (void)cudaGetLastError();
  const GemvArgs a{static_cast<const bf16*>(x), static_cast<const uint8_t*>(qw),
                   scale, zero, static_cast<const bf16*>(A),
                   static_cast<const bf16*>(B), static_cast<const int*>(ids),
                   static_cast<bf16*>(y), m, K, N, g, rank, n_ad, s};
  if (!args_ok(a) || rank < 1 || n_ad < 1) return (int)cudaErrorInvalidValue;
  return by_scale<kSlot>(a, bits, scale_is_f32, stream);
}
