// Fused rank-1-perturbed matmuls for Hopper (sm_90a): a float32 path on the
// CUDA cores and a bf16 path on the tensor cores (mma.sync).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/rank1_matmul.py,
// batched over a leading client axis (JAX gets it from vmap):
//   rank1_matmul         y[c] = x[c] W[c] + s[c] (x[c] u[c]) v[c]^T, W (K, N)
//   rank1_matmul_expert  y[c,e] = x[c,e] W[c,e] + s[c] (x[c,e] u[c,e]) v[c,e]^T
//   rank1_matmul_t       y[c] = x[c] W[c]^T + s[c] (x[c] v[c]) u[c]^T, W (O, K)
// Every client has its own W, u, v and s, every expert its own W, u and v.
// W is a view of the stacked parameters at one layer, so each operand comes
// with its own client (and expert) stride.
//
// Bound on this card.  At the main paths' shapes (M = 264 rows per client,
// or 83 capacity rows per expert; K from 256 to 8192; N from 32 to 151936)
// the work is 2 M K N flops against 4 (K N + M K + M N) bytes, 40 to 130
// flops per byte: a float32 product is bounded by the CUDA cores' FMA rate
// (67 TFLOP/s), not by HBM.  At that rate each of an SM's four schedulers
// issues one FMA per clock, and shared memory (128 bytes a clock per SM)
// must feed every operand the FMAs read: the tile's register reuse sets how
// close to the rate it can get.  No TF32 and no tensor cores: TF32 keeps ~3
// decimal digits and the ZO coefficient (L+ - L-) / 2 eps amplifies that
// error; a 3xTF32 product would bring an error budget of its own.  Every
// product and sum here is an IEEE float32 FMA or add.
//
// All three run one kernel, rank1_gemm (the plain product is the expert
// product with E = 1; the transposed product reads W along K, TRANS):
//
// * Tile.  128 threads (2 x 2 warps) own an 88 x 128 output tile, each
//   thread 11 rows x 8 columns, so one k step is 88 FMAs against 19 floats
//   read from shared memory.  88 rows fit the shapes: M = 264 is three full
//   row tiles, M = 83 one tile 94 % live.  ~230 registers: two blocks per SM.
// * Ring.  Slabs of 16 k of x (88 x 16), W (16 x 128) and u (16) go through
//   a 4-stage ring in dynamic shared memory, filled by 16-byte cp.async.cg
//   copies that zero-fill rows past M, columns past N and k past the
//   split's end through their source size.  Slabs k+1..k+3 are in flight
//   while slab k is computed: one cp.async.wait_group and one barrier per
//   slab.  Two warps copy W, two copy x; each thread steps one source
//   pointer by fixed strides, so a copy costs an add.  x is stored
//   k-contiguous as it arrives, rows padded to 20 floats so that the four
//   rows a warp reads at once fall in distinct banks; a thread reads 4 k of
//   one row as a float4.  Shapes with K or N not a multiple of 4, or
//   operands off 16 bytes, take 4-byte copies in the same kernel
//   (VEC = false).
// * W's layout.  W (K, N) is stored [k][n] as it arrives and read as two
//   float4 per k, the thread's columns ct + {0..3} and ct + 32 + {0..3}.
//   W (O, K) of the transposed product (TRANS) is copied like x: 16-byte
//   pieces of 4 k along each output row, stored [n][k] at the same 20-float
//   pitch.  For each 4-k step a thread then reads one float4 of each of its
//   8 columns and issues 44 FMAs on it: 11 + 8 loads per 352 FMAs, as
//   above.  Its columns are lane_col + 8 j (lane_col = lane % 8), so the 8
//   lanes of a quarter-warp read 8 consecutive rows of the slab, 20 floats
//   apart: 8 distinct 4-bank groups (columns 4 apart would sit 80 floats
//   apart and alternate between banks 0 and 16).  Those columns are not
//   contiguous, so the transposed tile stores its outputs one float at a
//   time (8 lanes write 32 consecutive bytes).
// * Rank-1 dot.  x . u (x . v when TRANS) rides the same slabs: the 352
//   (row, 4 k) pieces of each x slab are spread over all 128 threads, 3
//   each, always the same ones, and summed per row in a fixed order after
//   the k loop.  W is streamed once per output tile; the perturbation costs
//   M K FMAs and the epilogue one FMA per output,
//   s (x . u)[row] v[col] + acc (s (x . v)[row] u[col] + acc when TRANS).
// * Split-K.  Where the output tiles are too few to keep the card's block
//   slots busy (the Kimi router, N = 32; Falcon's x_proj, N = 288; the
//   N = 1024 and 2048 projections), the wrapper (rank1_matmul.split_plan)
//   cuts K into S ranges of whole slabs.  Each block writes its partial tile
//   and partial x . u to a scratch buffer; rank1_reduce adds the S partials
//   in ascending order and applies the rank-1 epilogue.  No atomics: the
//   same inputs give the same bits on every call.  A split sum is rounded
//   differently from one running sum over K (it is no less accurate).  The
//   tied logits (N = 151936) fill the card with 28,488 tiles: one split.
// * Grid: (row tiles, column tiles, batch x splits), so the row tiles of
//   one column tile run side by side and share W's slabs through L2.
//
// The bf16 path (rank1_gemm_bf16, entry rank1_matmul_bf16): x, W and y in
// bf16, u, v and s in float32, as the Pallas kernels take them when the
// parameters are bf16 (the JAX pod's default).  What it computes is the
// Pallas arithmetic: x W in float32 accumulators (a product of two bf16
// values is exact in float32, so the tensor cores compute what the TPU's
// MXU does), x . u = sum_k f32(x_k) u_k in float32 over the same slabs, and
// one cast to bf16 (round to nearest even) after the float32 epilogue
// acc + s (x . u) v.
//
// Bound on this card.  At the pod's shapes (8 clients over one W, M = 2114
// rows a client, K and N from 1024 to 92,553) the work is 2 C M K N flops
// against 2 (K N + C M K + C M N) bytes, hundreds of flops per byte: the
// bf16 tensor cores (989 TFLOP/s dense) bound it, not HBM.
//
// * Tile.  256 threads (2 x 4 warps) own a 128 x 256 output tile, each warp
//   64 x 64 of it as 4 x 8 mma.sync.m16n8k16 tiles (128 float32
//   accumulators a thread, one block an SM); slabs of 64 k (four k16 steps
//   between two barriers).  Per k16 a warp loads 4 + 4 ldmatrix.x4 for 32
//   mma.  At InternVL2-26B's pod shapes 128 x 128 tiles over 32-k slabs
//   reached 22-26 % of the bf16 peak, over 64-k slabs 25-29 %, this tile
//   26-32 %.  mma.sync, not wgmma: a simple tile first; wgmma and TMA are
//   later work.
// * Ring.  Slabs of x (128 x 64), W (64 x 256, or 256 x 64 when TRANS) and u
//   (64 floats) go through a 4-stage ring in dynamic shared memory (205-217
//   KB), filled by 16-byte cp.async.cg copies (8 bf16) that zero-fill rows
//   past M, columns past N and k past the split's end; rows are padded by 8
//   bf16 (x and W^T rows 144 bytes apart, W rows 528), so that the 8 rows an
//   ldmatrix reads fall in distinct 4-bank groups.  Fragments come from
//   ldmatrix.x4 (x: row-major A; W^T: col-major B as stored; W [k][n]:
//   ldmatrix.trans).
// * Shapes.  K % 8 == 0 and 16-byte-aligned operands (the wrapper refuses
//   the rest).  W (K, N) with N % 8 != 0 (InternVL's untied 92,553 logits)
//   is first copied into rows padded to a multiple of 8 by pad_cols_kernel
//   (once per distinct W: a client stride of 0 pads one copy), 2 K N bytes
//   more than the product itself moves.
// * Rank-1 dot.  Two threads a row of the x slab, 32 k each, float32 FMAs
//   in k order; the two halves are added once after the k loop.
// * Split-K as in the float32 path: partial float32 tiles and partial x . u
//   to scratch, rank1_reduce adds them in ascending order, applies the
//   epilogue and casts once; the same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// rank1_gemm: the tile of rank1_matmul, rank1_matmul_expert and
// rank1_matmul_t.
namespace gemm {

constexpr int TM = 11;                  // rows per thread
constexpr int TN = 8;                   // columns per thread
constexpr int NB = TN / 4;
constexpr int WM = 2, WN = 2;           // warps along rows and columns
constexpr int BM = WM * 4 * TM;         // warps x 4 lane rows x TM = 88
constexpr int BN = WN * 32 * NB;        // warps x 8 lane columns x TN = 128
constexpr int BK = 16;
constexpr int NT = 32 * WM * WN;
constexpr int STAGES = 4;
constexpr int MIN_BLOCKS = 2;           // per SM, for the register budget
constexpr int XS = BK + 4;              // x row pitch (and W's, TRANS)
constexpr int QR = BK / 4;              // 4-k pieces of a row in a slab
constexpr int XQ = BM * QR;             // (row, 4 k) pieces of an x slab
constexpr int XQ_T = (XQ + NT - 1) / NT;   // pieces of the x . u dot a thread
constexpr int W_OFF = BM * XS;          // W slab after the x slab

// One ring stage: x slab, W slab ([k][n], or [n][k] at pitch XS when
// TRANS), u slab.
template <bool TRANS>
struct Stage {
  static constexpr int W_FLOATS = TRANS ? BN * XS : BK * BN;
  static constexpr int U_OFF = W_OFF + W_FLOATS;
  static constexpr int FLOATS = U_OFF + BK;
  static constexpr int BYTES = STAGES * FLOATS * 4;
  static_assert((W_OFF * 4) % 16 == 0 && (U_OFF * 4) % 16 == 0 &&
                    (FLOATS * 4) % 16 == 0,
                "stage parts must stay 16-byte aligned");
};
static_assert(NT % QR == 0, "a thread's x . u pieces share one 4-k column");
static_assert(TN % 4 == 0, "a thread's columns are whole float4s");

// The thread's j-th output column, from its first column ct: float4s 32
// apart, or (TRANS) single columns 8 apart.
template <bool TRANS>
__device__ __forceinline__ int col_of(int ct, int j) {
  return TRANS ? ct + 8 * j : ct + (j >> 2) * 32 + (j & 3);
}

__device__ __forceinline__ unsigned smem(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// dst: a shared-memory address (smem); bytes past `bytes` are zero-filled
__device__ __forceinline__ void cp16(unsigned dst, const float* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp4(unsigned dst, const float* src,
                                    int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// The copies of one slab into a stage; everything at or past (M, N, kend)
// is zero-filled through the copies' source size.  VEC: 16-byte copies.
// Warps [0, WT / 32) move W's slab, the other warps x's slab, XR rows a
// pass, each thread one 4-k piece.  W (K, N): WR rows of k a pass, each
// thread one 16-byte column.  W (O, K), TRANS: like x, WTR output rows a
// pass, each thread one 4-k piece.  A thread keeps one source pointer that
// steps by a fixed stride per pass and per slab, so a copy costs an add and
// the copy.  Otherwise 4-byte copies, element by element.
constexpr int WR = 2;                     // W rows a pass
constexpr int WT = BN / 4 * WR;           // threads that copy W
constexpr int XR = (NT - WT) / QR;        // x rows a pass
constexpr int XP = (BM + XR - 1) / XR;    // x passes
constexpr int WTR = WT / QR;              // W output rows a pass, TRANS
constexpr int WTP = BN / WTR;             // W passes, TRANS
static_assert(WT % 32 == 0 && WT < NT && (NT - WT) % QR == 0 &&
                  BK % WR == 0 && XP <= 32 && BK <= WT && WT % QR == 0 &&
                  BN % WTR == 0 && WTP <= 32,
              "copy roles: whole warps, whole rows, u from W's threads");

template <bool VEC, bool TRANS>
struct Copier {
  using St = Stage<TRANS>;
  const float *x, *W, *u;
  int M, N, K, kend, row0, col0;
  bool w_role;
  const float* src;    // VEC: this thread's first element of the next slab
  long long pass;      // VEC: source step between passes
  int dst, first;      // VEC: stage offset; first k (W) or 4-k offset (x)
  unsigned live, ok;   // VEC: passes inside the tile / inside the matrix

  __device__ Copier(const float* x_, const float* W_, const float* u_,
                    int M_, int N_, int K_, int kbeg, int kend_, int row0_,
                    int col0_)
      : x(x_), W(W_), u(u_), M(M_), N(N_), K(K_), kend(kend_), row0(row0_),
        col0(col0_), w_role(threadIdx.x < WT) {
    if (!VEC) return;
    if (w_role && TRANS) {
      const int n = threadIdx.x / QR, k = threadIdx.x % QR * 4;
      src = W + (long long)(col0 + n) * K + kbeg + k;
      pass = (long long)WTR * K;
      dst = W_OFF + n * XS + k;
      first = k;
      live = ~0u;
      ok = 0;
      for (int p = 0; p < WTP; ++p)
        ok |= static_cast<unsigned>(col0 + n + p * WTR < N) << p;
    } else if (w_role) {
      const int k = threadIdx.x / (BN / 4), n = threadIdx.x % (BN / 4) * 4;
      src = W + (long long)(kbeg + k) * N + col0 + n;
      pass = (long long)WR * N;
      dst = W_OFF + k * BN + n;
      first = k;
      live = ~0u;
      ok = col0 + n < N ? ~0u : 0u;
    } else {
      const int t = threadIdx.x - WT, m = t / QR, k = t % QR * 4;
      src = x + (long long)(row0 + m) * K + kbeg + k;
      pass = (long long)XR * K;
      dst = m * XS + k;
      first = k;
      live = ok = 0;
      for (int p = 0; p < XP; ++p) {
        const int r = m + p * XR;
        live |= static_cast<unsigned>(r < BM) << p;
        ok |= static_cast<unsigned>(r < BM && row0 + r < M) << p;
      }
    }
  }

  // Starts the copies of the slab at k0 (the slabs come in order).
  __device__ __forceinline__ void slab(float* st, int k0) {
    const int tid = threadIdx.x;
    const unsigned sst = smem(st);
    if (VEC) {
      const int kleft = kend - k0;
      const unsigned d = sst + 4 * dst;
      const float* s = src;
      if (w_role && TRANS) {
#pragma unroll
        for (int p = 0; p < WTP; ++p, s += pass)
          cp16(d + 4 * p * WTR * XS, s,
               ((ok >> p) & 1) && first < kleft ? 16 : 0);
        src += BK;
      } else if (w_role) {
#pragma unroll
        for (int p = 0; p < BK / WR; ++p, s += pass)
          cp16(d + 4 * p * WR * BN, s,
               (ok & 1) && first + p * WR < kleft ? 16 : 0);
        src += (long long)BK * N;
      } else {
#pragma unroll
        for (int p = 0; p < XP; ++p, s += pass)
          if ((live >> p) & 1)
            cp16(d + 4 * p * XR * XS, s,
                 ((ok >> p) & 1) && first < kleft ? 16 : 0);
        src += BK;
      }
    } else {
      for (int i = tid; i < BM * BK; i += NT) {
        const int m = i / BK, k = i % BK;
        const bool in = row0 + m < M && k0 + k < kend;
        cp4(sst + 4 * (m * XS + k), x + (long long)(row0 + m) * K + k0 + k,
            in ? 4 : 0);
      }
      for (int i = tid; i < BK * BN; i += NT) {
        if (TRANS) {
          const int n = i / BK, k = i % BK;
          const bool in = col0 + n < N && k0 + k < kend;
          cp4(sst + 4 * (W_OFF + n * XS + k),
              W + (long long)(col0 + n) * K + k0 + k, in ? 4 : 0);
        } else {
          const int k = i / BN, n = i % BN;
          const bool in = k0 + k < kend && col0 + n < N;
          cp4(sst + 4 * (W_OFF + k * BN + n),
              W + (long long)(k0 + k) * N + col0 + n, in ? 4 : 0);
        }
      }
    }
    if (tid < BK)
      cp4(sst + 4 * (St::U_OFF + tid), u + k0 + tid, k0 + tid < kend ? 4 : 0);
  }
};

// blockIdx.z = (c * E + e) * S + split.  S == 1: y = x W + s (x . u) v^T
// (W^T when TRANS).  S > 1: the split's partial product goes to
// part[split][c * E + e] (M, N) and its partial x . u to the (S, B, M)
// block after them; rank1_reduce ends.
template <bool VEC, bool TRANS>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
rank1_gemm_kernel(const float* __restrict__ x, const float* __restrict__ W,
                  const float* __restrict__ u, const float* __restrict__ v,
                  const float* __restrict__ s, float* __restrict__ y,
                  float* __restrict__ part, int E, int M, int N, int K,
                  int S, int kper, long long sx_c, long long sx_e,
                  long long sw_c, long long sw_e, long long su_c,
                  long long su_e, long long sv_c, long long sv_e,
                  long long sy_c, long long sy_e) {
  using St = Stage<TRANS>;
  extern __shared__ __align__(16) float ring[];
  __shared__ float xu_piece[XQ];
  __shared__ float xu_row[BM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.z % S;
  const long long b = blockIdx.z / S, c = b / E, e = b % E;
  x += c * sx_c + e * sx_e;
  W += c * sw_c + e * sw_e;
  u += c * su_c + e * su_e;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int kbeg = split * kper, kend = min(K, kbeg + kper);
  const int nk = (kend - kbeg + BK - 1) / BK;
  // the thread's rows are rt + 4 i; its columns col_of<TRANS>(ct, j)
  const int rt = (warp / WN) * (4 * TM) + (lane >> 3);
  const int ct = (warp % WN) * 32 * NB + (lane & 7) * (TRANS ? 1 : 4);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float xu[XQ_T];
#pragma unroll
  for (int j = 0; j < XQ_T; ++j) xu[j] = 0.f;

  Copier<VEC, TRANS> copier(x, W, u, M, N, K, kbeg, kend, row0, col0);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nk) copier.slab(ring + t * St::FLOATS, kbeg + t * BK);
    cp_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();   // this thread's copies of slab kt have landed
    __syncthreads();         // everyone's have, and slab kt - 1 is consumed
    const int nx = kt + STAGES - 1;
    if (nx < nk)
      copier.slab(ring + (nx % STAGES) * St::FLOATS, kbeg + nx * BK);
    cp_commit();

    const float* st = ring + (kt % STAGES) * St::FLOATS;
    const float4 uv =
        *reinterpret_cast<const float4*>(st + St::U_OFF + tid % QR * 4);
#pragma unroll
    for (int j = 0; j < XQ_T; ++j) {
      const int i = tid + j * NT;
      if (i < XQ) {
        const float4 xv =
            *reinterpret_cast<const float4*>(st + i / QR * XS + i % QR * 4);
        xu[j] = fmaf(xv.x, uv.x, xu[j]);
        xu[j] = fmaf(xv.y, uv.y, xu[j]);
        xu[j] = fmaf(xv.z, uv.z, xu[j]);
        xu[j] = fmaf(xv.w, uv.w, xu[j]);
      }
    }
    const float* xa = st + rt * XS;
    const float* wb = st + W_OFF + (TRANS ? ct * XS : ct);
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float a[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 f = *reinterpret_cast<const float4*>(xa + 4 * i * XS + kq);
        a[i][0] = f.x, a[i][1] = f.y, a[i][2] = f.z, a[i][3] = f.w;
      }
      if (TRANS) {
        // one float4 of W along k per column, 44 FMAs on it
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float4 f =
              *reinterpret_cast<const float4*>(wb + 8 * j * XS + kq);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            acc[i][j] = fmaf(a[i][0], f.x, acc[i][j]);
            acc[i][j] = fmaf(a[i][1], f.y, acc[i][j]);
            acc[i][j] = fmaf(a[i][2], f.z, acc[i][j]);
            acc[i][j] = fmaf(a[i][3], f.w, acc[i][j]);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float bv[TN];
#pragma unroll
          for (int h = 0; h < NB; ++h) {
            const float4 f =
                *reinterpret_cast<const float4*>(wb + (kq + kk) * BN + 32 * h);
            bv[4 * h] = f.x, bv[4 * h + 1] = f.y, bv[4 * h + 2] = f.z,
            bv[4 * h + 3] = f.w;
          }
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(a[i][kk], bv[j], acc[i][j]);
        }
      }
    }
  }

  // x . u per row: the 4-k pieces of a row added in order
#pragma unroll
  for (int j = 0; j < XQ_T; ++j)
    if (tid + j * NT < XQ) xu_piece[tid + j * NT] = xu[j];
  __syncthreads();
  if (tid < BM) {
    float r = xu_piece[QR * tid];
#pragma unroll
    for (int q = 1; q < QR; ++q) r += xu_piece[QR * tid + q];
    xu_row[tid] = r;
  }
  __syncthreads();

  float* out;
  float sb = 0.f, vv[TN];
  if (S == 1) {
    out = y + c * sy_c + e * sy_e;
    sb = s[c];
    const float* vb = v + c * sv_c + e * sv_e;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + col_of<TRANS>(ct, j);
      vv[j] = col < N ? vb[col] : 0.f;
    }
  } else {
    const long long B = gridDim.z / S, MN = (long long)M * N;
    out = part + (split * B + b) * MN;
    if (blockIdx.y == 0 && tid < BM && row0 + tid < M)
      part[S * B * MN + (split * B + b) * M + row0 + tid] = xu_row[tid];
#pragma unroll
    for (int j = 0; j < TN; ++j) vv[j] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + rt + 4 * i;
    if (row >= M) continue;
    const float r = sb * xu_row[rt + 4 * i];
    float* orow = out + (long long)row * N;
    if (TRANS) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = col0 + col_of<TRANS>(ct, j);
        if (col < N) orow[col] = fmaf(r, vv[j], acc[i][j]);
      }
      continue;
    }
#pragma unroll
    for (int h = 0; h < NB; ++h) {
      const int col = col0 + ct + 32 * h;
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = fmaf(r, vv[4 * h + j], acc[i][4 * h + j]);
      if (VEC) {
        if (col < N)
          *reinterpret_cast<float4*>(orow + col) =
              make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < N) orow[col + j] = o[j];
      }
    }
  }
}

__device__ __forceinline__ float to_out(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 to_out(float x, __nv_bfloat16*) {
  return __float2bfloat16_rn(x);
}

// y[c, e] = sum_k part[k][c * E + e] + s[c] (sum_k part_xu[k][c * E + e]) v
// over the S splits in ascending order, in float32, then one cast to T.
template <typename T>
__global__ void __launch_bounds__(256)
rank1_reduce_kernel(const float* __restrict__ part,
                    const float* __restrict__ v, const float* __restrict__ s,
                    T* __restrict__ y, int S, int B, int E, int M, int N,
                    long long sv_c, long long sv_e, long long sy_c,
                    long long sy_e) {
  const long long MN = (long long)M * N, total = B * MN;
  const float* pxu = part + S * total;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long b = i / MN, r = i % MN;
    const int m = static_cast<int>(r / N), n = static_cast<int>(r % N);
    float acc = part[i], xu = pxu[b * M + m];
    for (int k = 1; k < S; ++k) {
      acc += part[k * total + i];
      xu += pxu[(k * B + b) * M + m];
    }
    const long long c = b / E, e = b % E;
    y[c * sy_c + e * sy_e + r] =
        to_out(fmaf(s[c] * xu, v[c * sv_c + e * sv_e + n], acc), y);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

template <bool VEC, bool TRANS>
cudaError_t launch_gemm(dim3 grid, cudaStream_t st, const float* x,
                        const float* W, const float* u, const float* v,
                        const float* s, float* y, float* part, int E, int M,
                        int N, int K, int S, int kper, const long long* sd) {
  auto kernel = rank1_gemm_kernel<VEC, TRANS>;
  constexpr int bytes = Stage<TRANS>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, bytes, st>>>(x, W, u, v, s, y, part, E, M, N, K, S, kper,
                                  sd[0], sd[1], sd[2], sd[3], sd[4], sd[5],
                                  sd[6], sd[7], sd[8], sd[9]);
  return cudaGetLastError();
}

}  // namespace gemm

// rank1_gemm_bf16: the bf16 tile of rank1_matmul, rank1_matmul_expert and
// rank1_matmul_t on the tensor cores.
namespace gemm16 {

constexpr int BM = 128, BN = 256, BK = 64;
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int NT = 32 * WARPS_M * WARPS_N;
constexpr int WTM = BM / WARPS_M;        // 64 rows a warp
constexpr int WTN = BN / WARPS_N;        // 64 columns a warp
constexpr int MI = WTM / 16, NI = WTN / 8;
constexpr int STAGES = 4;
constexpr int MIN_BLOCKS = 1;
constexpr int XP = BK + 8;               // x row pitch (and W^T's), in bf16
constexpr int WP = BN + 8;               // W row pitch ([k][n]), in bf16
constexpr int CH = 8;                    // bf16 a 16-byte copy moves
static_assert(NI % 2 == 0 && BM * (BK / CH) % NT == 0 &&
                  BK * (BN / CH) % NT == 0 && BN * (BK / CH) % NT == 0 &&
                  2 * BM == NT && BK <= NT,
              "copy and dot roles");

// One ring stage: x slab [m][k], W slab ([k][n], or [n][k] when TRANS),
// then BK floats of u.
template <bool TRANS>
struct Stage {
  static constexpr int X_ELEMS = BM * XP;
  static constexpr int W_ELEMS = TRANS ? BN * XP : BK * WP;
  static constexpr int U_BYTES = (X_ELEMS + W_ELEMS) * 2;
  static constexpr int BYTES = U_BYTES + BK * 4;
  static_assert(U_BYTES % 16 == 0 && BYTES % 16 == 0,
                "stage parts must stay 16-byte aligned");
};

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(unsigned dst, const void* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp4(unsigned dst, const void* src,
                                    int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned r[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned r[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row) b (16 x 8, col), float32 accumulators
__device__ __forceinline__ void mma16816(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The copies of the slab at k0 into one stage: x rows of pitch K, W rows of
// pitch ldw ((K, ldw) [k][n], or (N, K) [n][k] when TRANS); everything at
// or past (M, N, kend) is zero-filled (K, ldw and kend are multiples of 8,
// so a 16-byte piece is wholly in or out).
template <bool TRANS>
__device__ __forceinline__ void load_slab(
    unsigned char* st, const __nv_bfloat16* x, const __nv_bfloat16* W,
    const float* u, int M, int N, int K, int ldw, int k0, int kend, int row0,
    int col0) {
  using St = Stage<TRANS>;
  const int tid = threadIdx.x;
  const unsigned sx = smem(st), sw = sx + 2 * St::X_ELEMS,
                 su = sx + St::U_BYTES;
#pragma unroll
  for (int i = 0; i < BM * (BK / CH) / NT; ++i) {
    const int c = tid + i * NT, r = c / (BK / CH), kc = c % (BK / CH) * CH;
    const bool in = row0 + r < M && k0 + kc < kend;
    cp16(sx + 2 * (r * XP + kc),
         in ? x + (long long)(row0 + r) * K + k0 + kc : x, in ? 16 : 0);
  }
  if (TRANS) {
#pragma unroll
    for (int i = 0; i < BN * (BK / CH) / NT; ++i) {
      const int c = tid + i * NT, n = c / (BK / CH), kc = c % (BK / CH) * CH;
      const bool in = col0 + n < N && k0 + kc < kend;
      cp16(sw + 2 * (n * XP + kc),
           in ? W + (long long)(col0 + n) * ldw + k0 + kc : W, in ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < BK * (BN / CH) / NT; ++i) {
      const int c = tid + i * NT, k = c / (BN / CH), nc = c % (BN / CH) * CH;
      const bool in = k0 + k < kend && col0 + nc < ldw;
      cp16(sw + 2 * (k * WP + nc),
           in ? W + (long long)(k0 + k) * ldw + col0 + nc : W, in ? 16 : 0);
    }
  }
  if (tid < BK) {
    const bool in = k0 + tid < kend;
    cp4(su + 4 * tid, in ? u + k0 + tid : u, in ? 4 : 0);
  }
}

// blockIdx.z = (c * E + e) * S + split, as in the float32 path.  S == 1:
// y = bf16(x W + s (x . u) v^T) (W^T when TRANS); S > 1: the split's
// float32 partial product to part[split][c * E + e] (M, N) and its partial
// x . u to the (S, B, M) block after them; rank1_reduce ends.
template <bool TRANS>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
rank1_gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ W,
                       const float* __restrict__ u,
                       const float* __restrict__ v,
                       const float* __restrict__ s,
                       __nv_bfloat16* __restrict__ y,
                       float* __restrict__ part, int E, int M, int N, int K,
                       int ldw, int S, int kper, long long sx_c,
                       long long sx_e, long long sw_c, long long sw_e,
                       long long su_c, long long su_e, long long sv_c,
                       long long sv_e, long long sy_c, long long sy_e) {
  using St = Stage<TRANS>;
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ float xu_half[NT];
  __shared__ float xu_row[BM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int split = blockIdx.z % S;
  const long long b = blockIdx.z / S, c = b / E, e = b % E;
  x += c * sx_c + e * sx_e;
  W += c * sw_c + e * sw_e;
  u += c * su_c + e * su_e;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int kbeg = split * kper, kend = min(K, kbeg + kper);
  const int nk = (kend - kbeg + BK - 1) / BK;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  // x . u: this thread's half (BK / 2 k) of row tid / 2 of each slab
  float xu = 0.f;
  const int xr = tid >> 1, xk = (tid & 1) * (BK / 2);

  // ldmatrix row addresses, in bytes from a stage's start.  x: rows
  // lane % 16 of each 16-row tile, k 0-7 / 8-15 by lane / 16.  W [k][n]:
  // k rows lane % 8 (+ 8 for lanes 8-15 and 24-31), columns + 8 for lanes
  // 16-31, read transposed.  W^T [n][k]: rows lane % 8 (+ 8 for lanes
  // 16-31), k + 8 for lanes 8-15 and 24-31.  Each x4 then holds b0, b1 of
  // two neighbouring 8-column tiles.
  const unsigned a_off = 2 * ((wm * WTM + (lane & 15)) * XP + (lane >> 4) * 8);
  const unsigned b_off =
      TRANS ? 2 * (St::X_ELEMS + (wn * WTN + (lane & 7) + (lane >> 4) * 8) * XP +
                   ((lane >> 3) & 1) * 8)
            : 2 * (St::X_ELEMS + ((lane & 7) + ((lane >> 3) & 1) * 8) * WP +
                   wn * WTN + (lane >> 4) * 8);

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nk)
      load_slab<TRANS>(ring + t * St::BYTES, x, W, u, M, N, K, ldw,
                       kbeg + t * BK, kend, row0, col0);
    cp_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();   // this thread's copies of slab kt have landed
    __syncthreads();         // everyone's have, and slab kt - 1 is consumed
    const int nx = kt + STAGES - 1;
    if (nx < nk)
      load_slab<TRANS>(ring + (nx % STAGES) * St::BYTES, x, W, u, M, N, K,
                       ldw, kbeg + nx * BK, kend, row0, col0);
    cp_commit();

    const unsigned char* st = ring + (kt % STAGES) * St::BYTES;
    {
      const uint4* xs = reinterpret_cast<const uint4*>(st + 2 * (xr * XP + xk));
      const float4* us = reinterpret_cast<const float4*>(st + St::U_BYTES +
                                                         4 * xk);
#pragma unroll
      for (int h = 0; h < BK / 16; ++h) {
        const uint4 q = xs[h];
        const unsigned w[4] = {q.x, q.y, q.z, q.w};
        const float4 u0 = us[2 * h], u1 = us[2 * h + 1];
        const float uu[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          xu = fmaf(__uint_as_float(w[j] << 16), uu[2 * j], xu);
          xu = fmaf(__uint_as_float(w[j] & 0xffff0000u), uu[2 * j + 1], xu);
        }
      }
    }
    const unsigned sst = smem(st);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned a[MI][4], bq[NI / 2][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldsm_x4(sst + a_off + 2 * (i * 16 * XP + kk), a[i]);
#pragma unroll
      for (int p = 0; p < NI / 2; ++p) {
        if (TRANS)
          ldsm_x4(sst + b_off + 2 * (p * 16 * XP + kk), bq[p]);
        else
          ldsm_x4_t(sst + b_off + 2 * (kk * WP + p * 16), bq[p]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
          mma16816(acc[i][j], a[i], bq[j / 2][(j % 2) * 2],
                   bq[j / 2][(j % 2) * 2 + 1]);
    }
  }
  cp_wait<0>();

  // x . u per row: the two halves added once
  xu_half[tid] = xu;
  __syncthreads();
  if (tid < BM) xu_row[tid] = xu_half[2 * tid] + xu_half[2 * tid + 1];
  __syncthreads();

  const int g = lane >> 2, tg = lane & 3;
  if (S == 1) {
    const float sb = s[c];
    const float* vb = v + c * sv_c + e * sv_e;
    __nv_bfloat16* out = y + c * sy_c + e * sy_e;
    const bool pair =
        N % 2 == 0 && (reinterpret_cast<std::uintptr_t>(out) & 3) == 0;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wm * WTM + i * 16 + g + 8 * h, row = row0 + rl;
        if (row >= M) continue;
        const float r = sb * xu_row[rl];
        __nv_bfloat16* orow = out + (long long)row * N;
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int col = col0 + wn * WTN + j * 8 + tg * 2;
          const float o0 = fmaf(r, col < N ? vb[col] : 0.f, acc[i][j][2 * h]);
          const float o1 =
              fmaf(r, col + 1 < N ? vb[col + 1] : 0.f, acc[i][j][2 * h + 1]);
          if (pair && col + 1 < N) {
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(o0, o1);
          } else {
            if (col < N) orow[col] = __float2bfloat16_rn(o0);
            if (col + 1 < N) orow[col + 1] = __float2bfloat16_rn(o1);
          }
        }
      }
  } else {
    const long long B = gridDim.z / S, MN = (long long)M * N;
    float* out = part + (split * B + b) * MN;
    if (blockIdx.y == 0 && tid < BM && row0 + tid < M)
      part[S * B * MN + (split * B + b) * M + row0 + tid] = xu_row[tid];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wm * WTM + i * 16 + g + 8 * h;
        if (row >= M) continue;
        float* orow = out + (long long)row * N;
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int col = col0 + wn * WTN + j * 8 + tg * 2;
          if (N % 2 == 0 && col + 1 < N) {
            *reinterpret_cast<float2*>(orow + col) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          } else {
            if (col < N) orow[col] = acc[i][j][2 * h];
            if (col + 1 < N) orow[col + 1] = acc[i][j][2 * h + 1];
          }
        }
      }
  }
}

// dst[i][r][0:ld] = src[i][r][0:cols] followed by zeros, for the nc x ne
// matrices src at c * sc + e * se (rows of `cols`), dst contiguous.
__global__ void __launch_bounds__(256)
pad_cols_kernel(const __nv_bfloat16* __restrict__ src,
                __nv_bfloat16* __restrict__ dst, int ne, int rows, int cols,
                int ld, long long sc, long long se, long long total) {
  const long long per = (long long)rows * ld;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long b = i / per, r = (i % per) / ld;
    const int col = static_cast<int>(i % ld);
    dst[i] = col < cols ? src[b / ne * sc + b % ne * se + r * cols + col]
                        : __float2bfloat16_rn(0.f);
  }
}

template <bool TRANS>
cudaError_t launch(dim3 grid, cudaStream_t st, const __nv_bfloat16* x,
                   const __nv_bfloat16* W, const float* u, const float* v,
                   const float* s, __nv_bfloat16* y, float* part, int E,
                   int M, int N, int K, int ldw, int S, int kper,
                   const long long* sd) {
  auto kernel = rank1_gemm_bf16_kernel<TRANS>;
  constexpr int bytes = STAGES * Stage<TRANS>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, bytes, st>>>(x, W, u, v, s, y, part, E, M, N, K, ldw, S,
                                  kper, sd[0], sd[1], sd[2], sd[3], sd[4],
                                  sd[5], sd[6], sd[7], sd[8], sd[9]);
  return cudaGetLastError();
}

}  // namespace gemm16

}  // namespace

// y[c, e] = x[c, e] W[c, e] + s[c] (x[c, e] . u[c, e]) v[c, e]^T for C
// clients and E experts (E = 1 for rank1_matmul); x[c, e] (M, K), W[c, e]
// (K, N), or (N, K) read as its transpose when `trans` (rank1_matmul_t,
// with u its v and v its u), u[c, e] (K), v[c, e] (N), y[c, e] (M, N),
// each float32 with contiguous rows, placed at c * stride_c + e * stride_e.
// K is cut into `splits` ranges of `kper` (a multiple of 16); with
// splits > 1, `part` holds splits * C * E * M * (N + 1) floats of scratch.
// Returns the first CUDA error of the launches.
extern "C" int rank1_matmul_f32(
    const void* x, const void* W, const void* u, const void* v, const void* s,
    void* y, void* part, int C, int E, int M, int N, int K, int splits,
    int kper, int trans, long long sx_c, long long sx_e, long long sw_c,
    long long sw_e, long long su_c, long long su_e, long long sv_c,
    long long sv_e, long long sy_c, long long sy_e, void* stream) {
  using namespace gemm;
  const bool vec = K % 4 == 0 && (trans || N % 4 == 0) && aligned16(x) &&
                   aligned16(W) && aligned16(y) && aligned16(part) &&
                   (sx_c | sx_e | sw_c | sw_e | sy_c | sy_e) % 4 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, C * E * splits);
  const long long sd[10] = {sx_c, sx_e, sw_c, sw_e, su_c,
                            su_e, sv_c, sv_e, sy_c, sy_e};
  const auto* xf = static_cast<const float*>(x);
  const auto* Wf = static_cast<const float*>(W);
  const auto* uf = static_cast<const float*>(u);
  const auto* vf = static_cast<const float*>(v);
  const auto* sf = static_cast<const float*>(s);
  auto* yf = static_cast<float*>(y);
  auto* pf = static_cast<float*>(part);
  cudaError_t err;
  if (trans)
    err = vec ? launch_gemm<true, true>(grid, st, xf, Wf, uf, vf, sf, yf, pf,
                                        E, M, N, K, splits, kper, sd)
              : launch_gemm<false, true>(grid, st, xf, Wf, uf, vf, sf, yf, pf,
                                         E, M, N, K, splits, kper, sd);
  else
    err = vec ? launch_gemm<true, false>(grid, st, xf, Wf, uf, vf, sf, yf, pf,
                                         E, M, N, K, splits, kper, sd)
              : launch_gemm<false, false>(grid, st, xf, Wf, uf, vf, sf, yf,
                                          pf, E, M, N, K, splits, kper, sd);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long total = (long long)C * E * M * N, want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  rank1_reduce_kernel<float><<<blocks, 256, 0, st>>>(
      pf, vf, sf, yf, splits, C * E, E, M, N, sv_c, sv_e, sy_c, sy_e);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 path of rank1_matmul_f32: x, W and y bf16, u, v and s float32,
// float32 accumulation and one cast on store.  K must be a multiple of 8,
// x and W 16-byte aligned with strides that are multiples of 8 elements.
// W (K, N) with N % 8 != 0 (not TRANS) is first copied into `wpad`, room
// for (sw_c == 0 ? 1 : C) * E * K * round8(N) bf16, with its rows padded
// by zeros (null otherwise).  Splits as in the float32 path (kper a
// multiple of 64).  Returns the first CUDA error of the launches, or
// cudaErrorInvalidValue for what the kernel refuses.
extern "C" int rank1_matmul_bf16(
    const void* x, const void* W, const void* u, const void* v, const void* s,
    void* y, void* part, void* wpad, int C, int E, int M, int N, int K,
    int splits, int kper, int trans, long long sx_c, long long sx_e,
    long long sw_c, long long sw_e, long long su_c, long long su_e,
    long long sv_c, long long sv_e, long long sy_c, long long sy_e,
    void* stream) {
  using namespace gemm16;
  const bool padded = !trans && N % 8 != 0;
  if (K % 8 != 0 || kper % BK != 0 || !gemm::aligned16(x) ||
      !gemm::aligned16(W) || (sx_c | sx_e | sw_c | sw_e) % 8 != 0 ||
      padded != (wpad != nullptr) || (wpad && !gemm::aligned16(wpad)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* Wb = static_cast<const __nv_bfloat16*>(W);
  int ldw = trans ? K : N;
  long long sd[10] = {sx_c, sx_e, sw_c, sw_e, su_c,
                      su_e, sv_c, sv_e, sy_c, sy_e};
  if (padded) {
    ldw = (N + 7) / 8 * 8;
    const int nc = sw_c == 0 ? 1 : C;
    const long long total = (long long)nc * E * K * ldw,
                    want = (total + 255) / 256;
    auto* dst = static_cast<__nv_bfloat16*>(wpad);
    pad_cols_kernel<<<static_cast<int>(want < 132 * 16 ? want : 132 * 16),
                      256, 0, st>>>(Wb, dst, E, K, N, ldw, sw_c, sw_e, total);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    Wb = dst;
    sd[2] = sw_c == 0 ? 0 : (long long)E * K * ldw;
    sd[3] = (long long)K * ldw;
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, C * E * splits);
  const auto* uf = static_cast<const float*>(u);
  const auto* vf = static_cast<const float*>(v);
  const auto* sf = static_cast<const float*>(s);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  auto* pf = static_cast<float*>(part);
  cudaError_t err =
      trans ? launch<true>(grid, st, xb, Wb, uf, vf, sf, yb, pf, E, M, N, K,
                           ldw, splits, kper, sd)
            : launch<false>(grid, st, xb, Wb, uf, vf, sf, yb, pf, E, M, N, K,
                            ldw, splits, kper, sd);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long total = (long long)C * E * M * N, want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  gemm::rank1_reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
      pf, vf, sf, yb, splits, C * E, E, M, N, sv_c, sv_e, sy_c, sy_e);
  return static_cast<int>(cudaGetLastError());
}
