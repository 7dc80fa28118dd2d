// Fused rank-1-perturbed matmuls for Hopper (sm_90a), float32 CUDA cores.
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

// y[c, e] = sum_k part[k][c * E + e] + s[c] (sum_k part_xu[k][c * E + e]) v
// over the S splits in ascending order.
__global__ void __launch_bounds__(256)
rank1_reduce_kernel(const float* __restrict__ part,
                    const float* __restrict__ v, const float* __restrict__ s,
                    float* __restrict__ y, int S, int B, int E, int M, int N,
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
        fmaf(s[c] * xu, v[c * sv_c + e * sv_e + n], acc);
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
  rank1_reduce_kernel<<<blocks, 256, 0, st>>>(pf, vf, sf, yf, splits, C * E,
                                              E, M, N, sv_c, sv_e, sy_c, sy_e);
  return static_cast<int>(cudaGetLastError());
}
