// Fused rank-1-perturbed matmuls for Hopper (sm_90a): a float32 path on the
// CUDA cores and a bf16 path on the tensor cores (wgmma fed by TMA).
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
// MXU does), x . u = sum_k f32(x_k) u_k in float32 in a fixed k order, and
// one cast to bf16 (round to nearest even) after the float32 epilogue
// acc + s (x . u) v.
//
// Bound on this card.  At the pod's shapes (8 clients over one W, M = 2114
// rows a client, K and N from 1024 to 92,553) the work is 2 C M K N flops
// against 2 (K N + C M K + C M N) bytes, hundreds of flops per byte: the
// bf16 tensor cores (989 TFLOP/s dense) bound it, not HBM, and only wgmma
// reaches their full rate.
//
// * Block.  One block per SM, persistent over the output tiles (128 x 256).
//   Warp specialisation: two consumer warpgroups each run wgmma.mma_async
//   m64n256k16 on 64 rows of the tile (128 float32 accumulators a thread,
//   232 registers by setmaxnreg); one producer warpgroup (40 registers),
//   of which one thread issues every copy.
// * Clusters.  At this tile a slab is 48 KB for 4.2 MFLOP, so 132 SMs at
//   the peak would pull ~11 TB/s out of L2, more than it gives: one CTA
//   alone reached 49-60 % of the peak at the pod's shapes (H100 SXM,
//   700 W).  Where the row tiles are many or even
//   (rank1_matmul.cluster_of), two CTAs on neighbouring row tiles form a
//   cluster: each loads its own x and half of the W slab, multicast into
//   both, so a CTA pulls 32 KB a slab (54-67 %).  Each stage's `empty`
//   mbarrier then counts the consumer warps of both CTAs.  Few, odd row
//   tiles (3 at the Jamba experts' 330 rows) run
//   one CTA a cluster, where a pair's empty half would cost more.
// * Ring.  Slabs of 64 k, x (128 x 64) and W (64 x 256) = 48 KB, go through
//   a 4-stage ring in dynamic shared memory (192 KB) by TMA
//   (cp.async.bulk.tensor, 128-byte swizzle, as the wgmma descriptors read
//   it); each stage has a `full` mbarrier that counts its bytes and an
//   `empty` one that counts the consumer warps done with it.  x and W^T
//   [n][k] (TRANS) are K-major operands; W [k][n] is read MN-major
//   (transposed in the instruction) from four 64-column boxes.  TMA
//   zero-fills rows past M, columns past N and k past K, and takes W's
//   client and expert strides as dimensions of its tensor map (a client
//   stride of 0 is a client extent of 1).  The producer runs into the next
//   tile while the consumers store this one.
// * Rank-1 dot.  x . u of every row once, before the product (xu_kernel:
//   one warp a row, float32 FMAs in k order, a fixed butterfly), into a
//   float32 buffer the epilogue reads: one more read of x, 2-4 % of a pod
//   projection's bound, where the dot in the main loop took CUDA-core FMAs
//   on every slab of every column tile.
// * Folded clients.  When the clients share one W (a client stride of 0)
//   and x and y are contiguous over (C, M), the C products are one of C M
//   rows (16,912 at InternVL2-26B's pod: 133 row tiles where the clients
//   took 8 x 17 tiles 56 % full in their last), and W is streamed about
//   once, not C times; the epilogue finds each row's client (row / M) for
//   s and v, so a row tile may straddle two clients.  The experts keep
//   one product per (client, expert).
// * Raster.  Cluster tiles go out in bands of `group` row tiles, walked
//   column tile by column tile, so the blocks in flight share x and W
//   panels in L2 (RASTER_ROWS and tile_of on the Python side).
// * Shapes.  K % 8 == 0 and 16-byte-aligned operands (TMA's 16-byte global
//   strides; the wrapper refuses the rest).  W (K, N) with N % 8 != 0
//   (InternVL's untied 92,553 logits) is first copied into rows padded to
//   a multiple of 8 by pad_cols_kernel (once per distinct W), 2 K N bytes
//   more than the product moves.  y is stored from the accumulators
//   directly (its rows need not be 16-byte aligned: the logits).
// * Split-K as in the float32 path: partial float32 tiles to scratch,
//   rank1_reduce16 adds them in ascending order, applies the epilogue and
//   casts once; no atomics, so the same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

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
// rank1_matmul_t, a warp-specialised wgmma product fed by TMA.
namespace gemm16 {

using namespace hopper;

constexpr int BM = 128, BN = 256, BK = 64;
constexpr int STAGES = 4;                    // slabs in the ring
constexpr int CONSUMERS = 2;                 // warpgroups, 64 rows each
constexpr int NT = 128 * (CONSUMERS + 1);    // and the producer warpgroup
constexpr int MAX_CLUSTER = 2;               // CTAs sharing each W slab
constexpr int X_BYTES = BM * BK * 2;         // 128 rows of 128 bytes
constexpr int W_BOX = 64 * BK * 2;           // one 64 x 64 box of W [k][n]
constexpr int W_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
constexpr int OUT_BYTES = 64 * 128 * 2;      // a warpgroup's staged y half
constexpr int SMEM_BYTES =
    STAGES * STAGE_BYTES + CONSUMERS * OUT_BYTES + 1024;   // + alignment
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(X_BYTES % 1024 == 0 && W_BOX % 1024 == 0 &&
                  STAGE_BYTES % 1024 == 0,
              "every box starts a 128-byte swizzle atom");

// The launch's output tiles: Bv products of Mv rows (Bv = 1, Mv = C M when
// the clients' rows are folded), S splits of kper k, rt x ct tiles of
// CL BM x BN each (one BM x BN tile a CTA of the cluster), walked in bands
// of `group` row tiles.
struct Geo {
  int Bv, Mv, N, K, S, kper, rt, ct, group;
  long long tiles;
};

// Tile t: product b and split outermost; then bands of `group` row tiles,
// each walked column tile by column tile, its row tiles side by side, so
// that the blocks in flight share their x panels and W panels in L2.
__device__ __forceinline__ void tile_of(const Geo& g, long long t, int& b,
                                        int& split, int& rtile, int& ctile) {
  const long long per = static_cast<long long>(g.rt) * g.ct;
  const long long bs = t / per;
  const int r = static_cast<int>(t % per);
  b = static_cast<int>(bs / g.S);
  split = static_cast<int>(bs % g.S);
  const int band = g.group * g.ct;
  const int first = r / band * g.group;
  const int rows = min(g.group, g.rt - first);
  const int w = r % band;
  rtile = first + w % rows;
  ctile = w / rows;
}

__device__ __forceinline__ int slabs_of(const Geo& g, int split) {
  const int kbeg = split * g.kper;
  return (min(g.K, kbeg + g.kper) - kbeg + BK - 1) / BK;
}

// Row m of product b: its client c and expert e, and its output row's
// offset in y.  Folded (Mc > 0): b = 0, row m is client m / Mc's row
// m % Mc, and y's rows are contiguous over (C, M).
__device__ __forceinline__ void row_of(int b, int m, int E, int Mc, int N,
                                       long long sy_c, long long sy_e,
                                       int& c, int& e, long long& yoff) {
  if (Mc > 0) {
    c = m / Mc;
    e = 0;
    yoff = static_cast<long long>(m) * N;
  } else {
    c = b / E;
    e = b % E;
    yoff = c * sy_c + e * sy_e + static_cast<long long>(m) * N;
  }
}

// v[col] and v[col + 1] for the thread's columns col = colt + 8 j of half
// a tile, zero past N: independent loads, issued together
__device__ __forceinline__ void load_v(float (&va)[BN / 16],
                                       float (&vc)[BN / 16],
                                       const float* __restrict__ vb, int colt,
                                       int N) {
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    const int col = colt + 8 * j;
    va[j] = col < N ? __ldg(vb + col) : 0.f;
    vc[j] = col + 1 < N ? __ldg(vb + col + 1) : 0.f;
  }
}

// A consumer warp is done with a stage: lane c < CL arrives on its
// `empty` mbarrier in CTA c of the cluster (its own CTA's locally).
template <int CL>
__device__ __forceinline__ void release(uint64_t* bar, int lane, int rank) {
  if (lane == rank)
    mbar_arrive(bar);
  else if (lane < CL)
    mbar_arrive_cluster(bar, lane);
}

// One block per SM, in clusters of CL CTAs persistent over the cluster
// tiles: CTA `rank` of a cluster owns row tile CL r + rank of cluster tile
// (r, column tile), so the cluster's CTAs read the same W slabs.
// Warpgroups 0 and 1 consume: each owns 64 rows of the CTA's 128 x 256
// tile as one m64n256k16 accumulator (128 floats a thread).  Warpgroup 2
// produces: one thread keeps the ring of STAGES slabs (x 128 x 64, W
// 64 x 256) filled by TMA: its own x, and its 1 / CL of the W slab
// multicast into every CTA of the cluster.  Each stage's `full` mbarrier
// counts its bytes (its own x, and every CTA's share of W); its `empty`
// mbarrier counts the consumer warps of all the cluster's CTAs that are
// done with it, since every producer writes into every CTA's stage.  A
// producer runs ahead into the next tile while the consumers store this
// one, and at the end waits until every stage it filled is released, so
// no CTA leaves while a peer still writes or arrives in it.  S == 1:
// y = bf16(x W + s (x . u) v) (W^T when TRANS) from the x . u of `xu`,
// staged in shared memory and stored by TMA through `ymap` when `tma_y`,
// else stored from the accumulators (4-byte pairs where `pair`: y is
// 4-byte aligned); S > 1: the split's float32 partial tile to
// part[split][b] (Mv, N), which rank1_reduce16 ends.
template <bool TRANS, int CL>
__global__ void __launch_bounds__(NT, 1)
rank1_gemm_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap ymap,
                       const float* __restrict__ xu,
                       const float* __restrict__ v,
                       const float* __restrict__ s,
                       __nv_bfloat16* __restrict__ y,
                       float* __restrict__ part, const Geo g, int E, int Mc,
                       int wshared, int pair, int tma_y, long long sv_c,
                       long long sv_e, long long sy_c, long long sy_e) {
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  extern __shared__ __align__(16) unsigned char raw[];
  unsigned char* ring = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  const int wg = threadIdx.x / 128;
  const int rank = static_cast<int>(cluster_rank());
  const int cl = blockIdx.x / CL, clusters = gridDim.x / CL;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS * 4 * CL);
    }
    mbar_init_fence();
  }
  cluster_sync();

  if (wg == CONSUMERS) {
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x != CONSUMERS * 128) return;
    prefetch_map(&xmap);
    prefetch_map(&wmap);
    constexpr uint16_t ALL = (1 << CL) - 1;
    int stage = 0;
    uint32_t phase = 0;
    for (long long t = cl; t < g.tiles; t += clusters) {
      int b, split, rtile, ctile;
      tile_of(g, t, b, split, rtile, ctile);
      const int c = b / E, e = b % E, cw = wshared ? 0 : c;
      const int row0 = (rtile * CL + rank) * BM, col0 = ctile * BN;
      const int nk = slabs_of(g, split);
      for (int kt = 0; kt < nk; ++kt) {
        const int k0 = split * g.kper + kt * BK;
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = ring + stage * STAGE_BYTES;
        mbar_expect_tx(&full[stage], STAGE_BYTES);
        tma_load_4d(st, &xmap, k0, row0, e, c, &full[stage]);
        // this CTA's share of the W slab, into every CTA of the cluster:
        // W^T rows [n][k] in boxes of BN / CL, or W's 64-column boxes
        if (TRANS) {
          const int n0 = rank * (BN / CL);
          if (CL == 1)
            tma_load_4d(st + X_BYTES, &wmap, k0, col0, e, cw, &full[stage]);
          else
            tma_load_4d_multicast(st + X_BYTES + n0 * BK * 2, &wmap, k0,
                                  col0 + n0, e, cw, &full[stage], ALL);
        } else {
#pragma unroll
          for (int j = 0; j < BN / 64 / CL; ++j) {
            const int box = rank * (BN / 64 / CL) + j;
            if (CL == 1)
              tma_load_4d(st + X_BYTES + box * W_BOX, &wmap, col0 + 64 * box,
                          k0, e, cw, &full[stage]);
            else
              tma_load_4d_multicast(st + X_BYTES + box * W_BOX, &wmap,
                                    col0 + 64 * box, k0, e, cw, &full[stage],
                                    ALL);
          }
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    // every stage this producer filled has been released by the consumers
    // of every CTA it wrote into
    for (int i = 0; i < STAGES; ++i) {
      mbar_wait(&empty[stage], phase ^ 1);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    regs_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    float acc[128];
    int stage = 0;
    uint32_t phase = 0;
    for (long long t = cl; t < g.tiles; t += clusters) {
      int b, split, rtile, ctile;
      tile_of(g, t, b, split, rtile, ctile);
      const int nk = slabs_of(g, split);
      int prev = 0;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[stage], phase);
        const uint32_t sx =
            smem_u32(ring + stage * STAGE_BYTES) + wg * (X_BYTES / 2);
        const uint32_t sw = smem_u32(ring + stage * STAGE_BYTES + X_BYTES);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // x: 64 rows of 128 bytes (8-row atoms 1024 bytes apart), k16
          // steps 32 bytes along the row.  W^T [n][k] likewise (TRANS);
          // W [k][n]: four 64-column boxes 8 KB apart, 16 k rows a step.
          const uint64_t da = sw128_desc(sx + 32 * kk, 16, 1024);
          const uint64_t db = TRANS ? sw128_desc(sw + 32 * kk, 16, 1024)
                                    : sw128_desc(sw + 2048 * kk, W_BOX, 1024);
          wgmma_m64n256k16<TRANS ? 0 : 1>(acc, da, db, kt | kk);
        }
        wgmma_commit();
        fence_regs(acc);
        if (kt > 0) {
          wgmma_wait<1>();   // slab kt - 1's products have read their stage
          release<CL>(&empty[prev], lane, rank);
        }
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      // the epilogue: thread (warp, lane) holds rows 16 warp + lane / 4 +
      // 8 h and columns 8 j + 2 (lane % 4) + q of its warpgroup's 64 rows.
      // v is loaded half a tile (128 columns) at a time, 32 loads in
      // flight: the first half for the first row's client while the last
      // slab's products run, the second while the first half is stored.
      const int row0 =
          (rtile * CL + rank) * BM + wg * 64 + warp * 16 + lane / 4;
      const int colt = ctile * BN + 2 * (lane % 4);
      float va[BN / 16], vc[BN / 16];
      int c = -1, e = 0, vh = 0;   // the client, expert and half va, vc hold
      if (g.S == 1 && row0 < g.Mv) {
        long long yo;
        row_of(b, row0, E, Mc, g.N, sy_c, sy_e, c, e, yo);
        load_v(va, vc, v + c * sv_c + e * sv_e, colt, g.N);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release<CL>(&empty[prev], lane, rank);
      if (g.S == 1) {
        float r[2];
        int ch[2], eh[2];
        long long yoff[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = row0 + 8 * h;
          ch[h] = eh[h] = 0;
          yoff[h] = 0;
          r[h] = 0.f;
          if (m < g.Mv) {
            row_of(b, m, E, Mc, g.N, sy_c, sy_e, ch[h], eh[h], yoff[h]);
            r[h] = s[ch[h]] * xu[static_cast<long long>(b) * g.Mv + m];
          }
        }
        // tma_y: y through shared memory and TMA stores, a warpgroup's 64
        // rows x 128 columns at a time (two 64 x 64 boxes, 128-byte
        // swizzled: the 8 rows of a warp's store fall in 8 distinct
        // 16-byte chunks; rows past Mv are never written to y)
        unsigned char* out = ring + STAGES * STAGE_BYTES + wg * OUT_BYTES;
        const int rl0 = warp * 16 + lane / 4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (tma_y) {
            if (tid == 0) bulk_wait_read<0>();   // the staging is free
            bar_sync(1 + wg, 128);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (row0 + 8 * h >= g.Mv) continue;
            if (ch[h] != c || eh[h] != e || vh != half) {
              c = ch[h];
              e = eh[h];
              vh = half;
              load_v(va, vc, v + c * sv_c + e * sv_e, colt + half * BN / 2,
                     g.N);
            }
            const int rl = rl0 + 8 * h;
            unsigned char* srow = out + rl * 128 + 4 * (lane % 4);
            __nv_bfloat16* orow = y + yoff[h];
            // column pairs (col is even) are 4-byte aligned in an even row
            const bool two = pair && (yoff[h] & 1) == 0;
#pragma unroll
            for (int jj = 0; jj < BN / 16; ++jj) {
              const int j = half * (BN / 16) + jj;
              const float o0 = fmaf(r[h], va[jj], acc[4 * j + 2 * h]);
              const float o1 = fmaf(r[h], vc[jj], acc[4 * j + 2 * h + 1]);
              if (tma_y) {
                const int at =
                    jj / 8 * (OUT_BYTES / 2) + ((jj % 8) ^ (rl % 8)) * 16;
                *reinterpret_cast<__nv_bfloat162*>(srow + at) =
                    __floats2bfloat162_rn(o0, o1);
                continue;
              }
              const int col = colt + 8 * j;
              if (two && col + 1 < g.N) {
                *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                    __floats2bfloat162_rn(o0, o1);
              } else {
                if (col < g.N) orow[col] = __float2bfloat16_rn(o0);
                if (col + 1 < g.N) orow[col + 1] = __float2bfloat16_rn(o1);
              }
            }
          }
          if (half == 0 && c >= 0) {   // the second half's v, in flight
            vh = 1;
            load_v(va, vc, v + c * sv_c + e * sv_e, colt + BN / 2, g.N);
          }
          if (tma_y) {
            fence_async_smem();
            bar_sync(1 + wg, 128);
            if (tid == 0) {
              const int yc = Mc > 0 ? 0 : b / E, ye = Mc > 0 ? 0 : b % E;
              const int col = ctile * BN + half * (BN / 2);
              const int mw = (rtile * CL + rank) * BM + wg * 64;
              tma_store_4d(&ymap, out, col, mw, ye, yc);
              tma_store_4d(&ymap, out + OUT_BYTES / 2, col + 64, mw, ye, yc);
              bulk_commit();
            }
          }
        }
        continue;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row0 + 8 * h;
        if (m >= g.Mv) continue;
        float* orow =
            part + ((static_cast<long long>(split) * g.Bv + b) * g.Mv + m) *
                       static_cast<long long>(g.N);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = colt + 8 * j;
          if (g.N % 2 == 0 && col + 1 < g.N) {
            *reinterpret_cast<float2*>(orow + col) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          } else {
            if (col < g.N) orow[col] = acc[4 * j + 2 * h];
            if (col + 1 < g.N) orow[col + 1] = acc[4 * j + 2 * h + 1];
          }
        }
      }
    }
    if (tid == 0) bulk_wait_all();   // the last tile's stores have landed
  }
}

// xu[w] = sum_k f32(x[c, e, m, k]) u[c, e, k] for row w = (c E + e) M + m:
// one warp a row, each lane 8 k at a time (one 16-byte load of x), in k
// order, then a fixed butterfly over the lanes; float32 throughout.
__global__ void __launch_bounds__(256)
xu_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ u,
          float* __restrict__ xu, int E, int M, int K, long long rows,
          long long sx_c, long long sx_e, long long su_c, long long su_e) {
  const long long w = blockIdx.x * 8LL + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= rows) return;
  const long long b = w / M, c = b / E, e = b % E;
  const __nv_bfloat16* xr = x + c * sx_c + e * sx_e + (w % M) * K;
  const float* ub = u + c * su_c + e * su_e;
  float acc = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    const uint4 q = *reinterpret_cast<const uint4*>(xr + k);
    const unsigned wv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc = fmaf(__uint_as_float(wv[j] << 16), ub[k + 2 * j], acc);
      acc = fmaf(__uint_as_float(wv[j] & 0xffff0000u), ub[k + 2 * j + 1],
                 acc);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) xu[w] = acc;
}

// y = bf16(sum_k part[k] + s (x . u) v) over the S splits in ascending
// order, in float32, for every row of every product (rows as in the tile).
__global__ void __launch_bounds__(256)
rank1_reduce16_kernel(const float* __restrict__ part,
                      const float* __restrict__ xu,
                      const float* __restrict__ v,
                      const float* __restrict__ s,
                      __nv_bfloat16* __restrict__ y, int S, int Bv, int Mv,
                      int N, int E, int Mc, long long sv_c, long long sv_e,
                      long long sy_c, long long sy_e) {
  const long long MN = static_cast<long long>(Mv) * N, total = Bv * MN;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int b = static_cast<int>(i / MN);
    const long long r = i % MN;
    const int m = static_cast<int>(r / N), n = static_cast<int>(r % N);
    float acc = part[i];
    for (int k = 1; k < S; ++k) acc += part[k * total + i];
    int c, e;
    long long yoff;
    row_of(b, m, E, Mc, N, sy_c, sy_e, c, e, yoff);
    y[yoff + n] = __float2bfloat16_rn(
        fmaf(s[c] * xu[b * static_cast<long long>(Mv) + m],
             v[c * sv_c + e * sv_e + n], acc));
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

int blocks_for(long long total) {
  const long long want = (total + 255) / 256;
  return static_cast<int>(want < 132 * 16 ? want : 132 * 16);
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
// by zeros (null otherwise).  `xu` holds C * E * M floats (x . u of every
// row); with splits > 1, `part` holds splits * C * E * M * N floats.
// `fold` (E == 1, a client stride of 0 for W, x and y contiguous over
// (C, M)) makes the clients' rows one product of C M rows over the one W.
// Clusters of `cluster` (1 or 2) CTAs share each W slab; `group` cluster
// row tiles a band, at most `blocks` persistent blocks.  Splits
// as in the float32 path (kper a multiple of 64).  Returns the first CUDA
// error of the launches, or cudaErrorInvalidValue for what the kernel
// refuses.
extern "C" int rank1_matmul_bf16(
    const void* x, const void* W, const void* u, const void* v, const void* s,
    void* y, void* part, void* wpad, void* xu, int C, int E, int M, int N,
    int K, int splits, int kper, int trans, int fold, int cluster, int group,
    int blocks,
    long long sx_c, long long sx_e, long long sw_c, long long sw_e,
    long long su_c, long long su_e, long long sv_c, long long sv_e,
    long long sy_c, long long sy_e, void* stream) {
  using namespace gemm16;
  const bool padded = !trans && N % 8 != 0;
  if (K % 8 != 0 || kper % BK != 0 || splits < 1 || group < 1 ||
      blocks < MAX_CLUSTER || cluster < 1 || cluster > MAX_CLUSTER ||
      xu == nullptr || (splits > 1) != (part != nullptr) ||
      !gemm::aligned16(x) || !gemm::aligned16(W) ||
      (sx_c | sx_e | sw_c | sw_e) % 8 != 0 ||
      padded != (wpad != nullptr) || (wpad && !gemm::aligned16(wpad)) ||
      (fold && (E != 1 || sw_c != 0 || sx_c != (long long)M * K ||
                sy_c != (long long)M * N)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* Wb = static_cast<const __nv_bfloat16*>(W);
  const auto* uf = static_cast<const float*>(u);
  const auto* vf = static_cast<const float*>(v);
  const auto* sf = static_cast<const float*>(s);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  auto* pf = static_cast<float*>(part);
  auto* xuf = static_cast<float*>(xu);
  const int cw = sw_c == 0 ? 1 : C;
  long long ldw = trans ? K : N;
  if (padded) {
    ldw = (N + 7) / 8 * 8;
    const long long total = (long long)cw * E * K * ldw;
    auto* dst = static_cast<__nv_bfloat16*>(wpad);
    pad_cols_kernel<<<blocks_for(total), 256, 0, st>>>(
        Wb, dst, E, K, N, static_cast<int>(ldw), sw_c, sw_e, total);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    Wb = dst;
    sw_e = (long long)K * ldw;
    sw_c = sw_c == 0 ? 0 : E * sw_e;
  }
  // x . u of every row, once
  const long long rows = (long long)C * E * M;
  xu_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(
      xb, uf, xuf, E, M, K, rows, sx_c, sx_e, su_c, su_e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // tensor maps, dims innermost first: x (K, rows, E, C), or (K, C M) when
  // folded; W [k][n] (ldw, K, E, C) in 64 x 64 boxes, or W [n][k] (K, N,
  // E, C) in 64 x 128 boxes (a CTA's share of 256) when TRANS; a client
  // stride of 0 is a client extent of 1
  CUtensorMap xmap, wmap;
  const long long xd[4] = {K, fold ? (long long)C * M : M, fold ? 1 : E,
                           fold ? 1 : C};
  const long long xs[3] = {2LL * K, 2 * sx_e, 2 * sx_c};
  const long long wd[4] = {trans ? (long long)K : ldw, trans ? N : K, E, cw};
  const long long ws[3] = {2 * (trans ? (long long)K : ldw), 2 * sw_e,
                           2 * sw_c};
  if (!map_bf16_4d(&xmap, xb, xd, xs, BK, BM) ||
      !map_bf16_4d(&wmap, Wb, wd, ws, 64, trans ? BN / cluster : BK))
    return static_cast<int>(cudaErrorInvalidValue);

  Geo g;
  g.Bv = fold ? 1 : C * E;
  g.Mv = fold ? C * M : M;
  g.N = N;
  g.K = K;
  g.S = splits;
  g.kper = kper;
  g.rt = ((g.Mv + BM - 1) / BM + cluster - 1) / cluster;
  g.ct = (N + BN - 1) / BN;
  g.group = group;
  g.tiles = (long long)g.Bv * splits * g.rt * g.ct;
  const int Mc = fold ? M : 0;
  const int pair = (reinterpret_cast<std::uintptr_t>(y) & 3) == 0;
  // y by TMA stores where its rows and strides are 16-byte multiples
  // (not the 92,553-column logits), as x's map lays it out
  const int tma_y = splits == 1 && N % 8 == 0 && gemm::aligned16(y) &&
                    (sy_c | sy_e) % 8 == 0;
  CUtensorMap ymap = {};
  const long long yd[4] = {N, xd[1], xd[2], xd[3]};
  const long long ys[3] = {2LL * N, 2 * sy_e, 2 * sy_c};
  if (tma_y && !map_bf16_4d(&ymap, y, yd, ys, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int which = 2 * (cluster - 1) + (trans ? 1 : 0);
  auto kernel = which == 0   ? rank1_gemm_bf16_kernel<false, 1>
                : which == 1 ? rank1_gemm_bf16_kernel<true, 1>
                : which == 2 ? rank1_gemm_bf16_kernel<false, 2>
                             : rank1_gemm_bf16_kernel<true, 2>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  // as many clusters as the card holds at once (its SMs pair up into
  // clusters only within a GPC), at most blocks / cluster
  static int resident[4] = {0, 0, 0, 0};
  if (resident[which] == 0 && cluster == 1) resident[which] = blocks;
  if (resident[which] == 0) {
    cudaLaunchConfig_t q = {};
    q.gridDim = dim3(blocks / cluster * cluster);
    q.blockDim = dim3(NT);
    q.dynamicSmemBytes = SMEM_BYTES;
    cudaLaunchAttribute a;
    a.id = cudaLaunchAttributeClusterDimension;
    a.val.clusterDim.x = cluster;
    a.val.clusterDim.y = a.val.clusterDim.z = 1;
    q.attrs = &a;
    q.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&resident[which], kernel, &q);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (resident[which] < 1) return static_cast<int>(cudaErrorInvalidValue);
  }
  long long clusters = resident[which] < blocks / cluster
                           ? resident[which] : blocks / cluster;
  if (clusters > g.tiles) clusters = g.tiles;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * cluster));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, xmap, wmap, ymap, xuf, vf, sf, yb,
                           pf, g, E, Mc, static_cast<int>(sw_c == 0), pair,
                           tma_y, sv_c, sv_e, sy_c, sy_e);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  rank1_reduce16_kernel<<<blocks_for(rows * N), 256, 0, st>>>(
      pf, xuf, vf, sf, yb, splits, g.Bv, g.Mv, N, E, Mc, sv_c, sv_e, sy_c,
      sy_e);
  return static_cast<int>(cudaGetLastError());
}
