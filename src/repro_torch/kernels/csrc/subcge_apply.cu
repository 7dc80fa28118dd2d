// Fused SubCGE weight update for Hopper (sm_90a), as one streaming pass:
//   W[b] <- W[b] + sum_e U[e] A[e, b] V[e]^T
//
// Replaces the Pallas TPU kernels src/repro/kernels/subcge_apply.py
// subcge_apply (one subspace, E = 1) and subcge_apply_epochs (E sender
// tau-epochs, which Pallas folds into one rank-E*r visit with a
// block-diagonal A).  Instance dims (clients x stacked layers) collapse
// into the leading b axis.  Two kernels, picked by the wrapper
// (subcge_apply.py) by W's type and the rank, with no knob:
//
// 1. subcge_stream_kernel: float32 W at r <= 32 (PR 15's stream).
// 2. update_tc_kernel: bf16 W at any rank, and float32 W at r > 32.  The
//    delta is formed on the tensor cores (wgmma, TF32 split in three).
//
// Bound on this card: one read and one write of W (3.35 TB/s).  Each
// element costs 2 E r flops, so the arithmetic per byte of W is E r / 4
// in float32 and E r / 2 in bf16: at r = 16 and E = 1 the float32 FMA
// pipes (67 TFLOP/s) keep up with the stream, but bf16 at E = 2 or r = 64
// would need 54-107 TFLOP/s of FMAs, past what they can do.
//
// ---------------------------------------------------------------------
// 1. subcge_stream_kernel (float32, r <= 32)
//
// The delta is formed as U (A V^T): AV_e = A[e, b] V_e^T over a chunk of
// bc columns is the same for every row of instance b.  The grid is
// persistent: three blocks per SM, each walking one contiguous range of
// the launch's (instance, column chunk, row tile) list, so every block
// moves the same bytes (to one tile) and the stream never waits on a
// block's start.
// * AV: when a block enters a new (instance, chunk), it stages A[e, b] and
//   the chunk's V rows in shared memory for each epoch and forms AV_e
//   (r x bc) there.
// * Each tile: every thread copies its own 4 rows x 4 columns of the next
//   tile into its own slots of a 2-stage ring in shared memory (16-byte
//   cp.async.cg: W is read once, through L2 only), then forms this tile's
//   4 x 4 delta in registers (float32 FMAs) while they are in flight, waits
//   for its own copies and stores W + delta as float4s with the
//   evict-first hint (st.global.cs).  79 registers; three blocks of 256
//   threads fit an SM (48 KB of W in flight).
// * Narrow leaves: the chunk width bc (4 to 128 columns, a power of two)
//   is chosen per leaf by subcge_apply.update_plan.
// * Epochs loop inside the tile, so W is streamed once for any E; AV of up
//   to `G` epochs fits shared memory, a larger E rebuilds AV per tile.
// * m not a multiple of 4, or W off 16 bytes, take 4-byte loads and
//   stores in the same kernel (VEC = false).
//
// ---------------------------------------------------------------------
// 2. update_tc_kernel (bf16 W at any rank; float32 W at r > 32)
//
// delta = U_tile (128 rows x k) . AV (k x 64 columns), k = E rp, where
// AV = blockdiag(A_e[b]) [V_1 ... V_E]^T over the column chunk and each
// epoch's r is padded with zeros to rp, a multiple of 8: the Pallas epochs
// kernel's own formulation, one pass over k for any E and r.
// * Tensor cores: wgmma m64n64k8 TF32 with float32 sums, U (the A
//   operand) from registers, AV (B) K-major from shared memory.  One TF32
//   pass (10 mantissa bits) would miss phase 2's tolerance (a term u av
//   off by ~2^-10 of itself), so each operand is split, x = hi + lo with
//   hi = tf32(x) and lo = tf32(x - hi) (round to nearest), and the delta is
//   hi.hi + hi.lo + lo.hi: three products a k8 step, each term within
//   ~2^-21 of the float32 product (tests/test_torch_update_plan.py holds
//   the error model).
// * Persistent, warp specialised: one block a SM walks a contiguous range
//   of tiles.  Per instance the columns go in super-chunks of `sub` 64-
//   column chunks (4 at k <= 32, 2 at k <= 64), row tile by row tile, each
//   row tile's chunks of the super-chunk side by side: a row's 512 bytes
//   (bf16, k <= 32) stream as one run, a row tile's U is split once for
//   them, and AV is formed once per (instance, super-chunk).  The tile
//   order is a Cursor stepped without division.
// * W: warp group 2 produces.  One thread loads each tile by TMA over a
//   tensor map of (nb, n, m) (128-byte swizzle, boxes of 128 bytes x 64
//   rows, evict-first L2 hint) into a ring of 6 stages (bf16; 4 in
//   float32) against `full` mbarriers, and stores the tile back by TMA
//   from its stage STAGES - 1 tiles later, once the consumer warps have
//   written W + delta there (`empty` mbarriers); the store's read of the
//   stage is awaited just before the load that reuses it.  The consumers
//   never wait on a bulk copy.
// * Warp groups 0 and 1 consume, 64 rows each, with 232 registers a
//   thread (setmaxnreg; the producer keeps 40).  At k <= 64 (every bf16
//   main-path update, and r = 64 at E = 1) each keeps two accumulators
//   and issues tile i + 1's products before tile i's epilogue, so the
//   tensor cores run under the epilogue; the row tile's U (hi and lo of
//   every k8 step) stays in registers, the next row tile's loaded a tile
//   ahead.  Past k = 64, U streams in blocks of four k8 steps
//   with two steps' products in flight; the hi.hi products sum apart from
//   the two small ones, so that the float32 sums drift by k / 8 steps, not
//   3 k / 8.
// * AV: the 256 consumer threads form it when the walk enters a
//   super-chunk, from A and V staged in shared memory 32 q a round (the
//   next round's loads in flight), and store it split (hi and lo) in the
//   K-major 128-byte-swizzled layout wgmma reads.  Up to k = KMAX = 128
//   one k group; past that the tile walks k in groups of 128 and forms
//   each group's AV per tile (still one pass over W).
// * Epilogue: a thread reads its fragment's elements of W from the stage,
//   adds the delta to f32(W), casts once to W's type (round to nearest
//   even) and writes the result back in place.  No atomics: every output
//   is the same bits on every call.
// * In place (out == W) is legal: each element is read before it is
//   written, by the one block that owns it.
// * Leaves TMA cannot describe (a row pitch or batch stride off 16 bytes,
//   or W or out off 16 bytes: InternVL's 92,553-column logits, any bf16
//   leaf with m % 8 != 0) take FLAT = true: the producer warp group copies
//   each tile row's 16-byte pieces of the leaf's flat view with cp.async
//   (the row's (row, column) from its address, its first element shifted
//   within its piece), arriving on the stage's `full` barrier; the
//   epilogue reads W from there, and the warp group stores its rows by the
//   16-byte pieces of out that lie within the tile, element by element at
//   the tile's two edges.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------- kernel 1

constexpr int NT = 256;
constexpr int WARPS = NT / 32;
constexpr int RPT = 4;     // rows per thread in a tile
constexpr int RMAX = 32;
constexpr int STAGES = 2;   // W tiles of a block in shared memory
constexpr int MIN_BLOCKS = 3;   // per SM: 79 registers, 49.5 KB at E = 1

// Forms AV[el * r + p][c] = sum_q A[e, b][p][q] V_e[col0 + c][q] for the
// epochs e = e0 .. e0 + ge - 1 (el = e - e0), zero past column m.
__device__ void build_av(float* AV, float* As, float* Vs, const float* A,
                         const float* V, int e0, int ge, long long b, int nb,
                         int m, int r, int bc, int lbc, int col0) {
  const int tid = threadIdx.x, vp = r | 1;   // odd pitch: no bank conflicts
  for (int el = 0; el < ge; ++el) {
    const long long e = e0 + el;
    __syncthreads();   // the previous epoch, group or tile is done with them
    const float* Ae = A + (e * nb + b) * r * r;
    for (int i = tid; i < r * r; i += NT) As[i] = Ae[i];
    // the chunk's V rows are contiguous: bc * r floats from row col0
    const float* Ve = V + (e * m + col0) * r;
    const int live = min(bc, m - col0) * r;
    for (int i = tid; i < bc * r; i += NT) {
      const int c = i / r, q = i - c * r;
      Vs[c * vp + q] = i < live ? Ve[i] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < r * bc; i += NT) {
      const int p = i >> lbc, c = i & (bc - 1);
      float t = 0.f;
      for (int q = 0; q < r; ++q) t = fmaf(As[p * r + q], Vs[c * vp + q], t);
      AV[(el * r + p) * bc + c] = t;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// dst: a shared-memory address; bytes past `bytes` are zero-filled
__device__ __forceinline__ void cp16(unsigned dst, const void* src,
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

__device__ __forceinline__ void cp_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Starts the copies of the thread's RPT x 4 elements of the tile whose first
// thread row is `rbase` into its own slots of one ring stage, slot i at
// stage[i * NT + tid]; elements past (n, m) are zero-filled.
template <bool VEC>
__device__ __forceinline__ void load_tile(float4* stage, const float* Wb,
                                          int rbase, int LR, int n, int m,
                                          int col) {
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = rbase + i * LR;
    const unsigned dst = smem(stage + i * NT + threadIdx.x);
    const float* src = Wb + (long long)row * m + col;
    if (VEC) {
      const bool in = row < n && col < m;
      cp16(dst, in ? src : Wb, in ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = row < n && col + j < m;
        cp4(dst + 4 * j, in ? src + j : Wb, in ? 4 : 0);
      }
    }
  }
}

// Tile g of the launch is row tile g % tiles of column chunk
// (g / tiles) % chunks of instance g / (tiles * chunks); block k takes
// tiles [k * per, min((k + 1) * per, nb * chunks * tiles)) in order.
template <bool VEC>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
subcge_stream_kernel(const float* W, float* out,   // may alias: no restrict
                     const float* __restrict__ U, const float* __restrict__ A,
                     const float* __restrict__ V, int E, int G, int nb, int n,
                     int m, int r, int lbc, int chunks, int per, bool uvec,
                     long long sw, long long so) {
  extern __shared__ __align__(16) float sm[];
  const int bc = 1 << lbc, llc = lbc - 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lr = lane >> llc, LR = 32 >> llc;   // lane row, rows a warp
  const int tr = WARPS * RPT * LR;              // rows a tile
  const int lcol = 4 * (lane & ((1 << llc) - 1));
  const int tiles = (n + tr - 1) / tr;
  const long long g0 = (long long)blockIdx.x * per;
  const long long g1 = min(g0 + per, (long long)nb * chunks * tiles);
  const int ngroups = (E + G - 1) / G;

  float4* ring = reinterpret_cast<float4*>(sm);   // STAGES x RPT x NT
  float* AV = sm + STAGES * RPT * NT * 4;
  float* As = AV + G * r * bc;
  float* Vs = As + r * r;
  // the thread's rows of tile t: t * tr + rrow + i * LR
  const int rrow = warp * RPT * LR + lr;
  long long built = -1;   // b * chunks + chunk whose AV is in shared memory

  {
    const long long bq = g0 / tiles;
    load_tile<VEC>(ring, W + bq / chunks * sw,
                   static_cast<int>(g0 % tiles) * tr + rrow, LR, n, m,
                   static_cast<int>(bq % chunks) * bc + lcol);
  }
  cp_commit();

  for (long long g = g0; g < g1; ++g) {
    const long long bq = g / tiles, b = bq / chunks;
    const int col0 = static_cast<int>(bq % chunks) * bc, col = col0 + lcol;
    const int rbase = static_cast<int>(g % tiles) * tr + rrow;
    float4* cur = ring + ((g - g0) % STAGES) * RPT * NT;
    // the next tile streams in while this one's delta is formed
    if (g + 1 < g1) {
      const long long nq = (g + 1) / tiles;
      load_tile<VEC>(ring + ((g + 1 - g0) % STAGES) * RPT * NT,
                     W + nq / chunks * sw,
                     static_cast<int>((g + 1) % tiles) * tr + rrow, LR, n, m,
                     static_cast<int>(nq % chunks) * bc + lcol);
    }
    cp_commit();
    if (ngroups == 1 && bq != built) {   // uniform over the block
      build_av(AV, As, Vs, A, V, 0, E, b, nb, m, r, bc, lbc, col0);
      built = bq;
    }
    const float* av0 = AV + lcol;
    float* Ob = out + b * so;

    float acc[RPT][4];
    int uoff[RPT];   // U row offsets; rows past n read the last row, unstored
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      uoff[i] = min(rbase + i * LR, n - 1) * r;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }

    for (int g = 0; g < ngroups; ++g) {
      const int e0 = g * G, ge = min(G, E - e0);
      if (ngroups > 1)
        build_av(AV, As, Vs, A, V, e0, ge, b, nb, m, r, bc, lbc, col0);
      for (int el = 0; el < ge; ++el) {
        const float* Ue = U + (long long)(e0 + el) * n * r;
        const float* av = av0 + el * r * bc;
        if (uvec) {
          for (int p = 0; p < r; p += 4) {
            float4 a[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              a[k] = *reinterpret_cast<const float4*>(av + (p + k) * bc);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              const float4 u4 =
                  __ldg(reinterpret_cast<const float4*>(Ue + uoff[i] + p));
              const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                acc[i][0] = fmaf(uu[k], a[k].x, acc[i][0]);
                acc[i][1] = fmaf(uu[k], a[k].y, acc[i][1]);
                acc[i][2] = fmaf(uu[k], a[k].z, acc[i][2]);
                acc[i][3] = fmaf(uu[k], a[k].w, acc[i][3]);
              }
            }
          }
        } else {
          for (int p = 0; p < r; ++p) {
            const float4 a = *reinterpret_cast<const float4*>(av + p * bc);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              const float uu = __ldg(Ue + uoff[i] + p);
              acc[i][0] = fmaf(uu, a.x, acc[i][0]);
              acc[i][1] = fmaf(uu, a.y, acc[i][1]);
              acc[i][2] = fmaf(uu, a.z, acc[i][2]);
              acc[i][3] = fmaf(uu, a.w, acc[i][3]);
            }
          }
        }
      }
    }

    cp_wait_prev();   // this thread's copies of tile t have landed
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = rbase + i * LR;
      if (row >= n) continue;
      const float4 w = cur[i * NT + threadIdx.x];
      const long long off = (long long)row * m + col;
      const float o[4] = {w.x + acc[i][0], w.y + acc[i][1], w.z + acc[i][2],
                          w.w + acc[i][3]};
      if (VEC) {
        if (col < m)
          __stcs(reinterpret_cast<float4*>(Ob + off),
                 make_float4(o[0], o[1], o[2], o[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < m) __stcs(Ob + off + j, o[j]);
      }
    }
  }
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<std::uintptr_t>(p) & (bytes - 1)) == 0;
}

// ---------------------------------------------------------------- kernel 2

namespace tc {

using namespace hopper;

constexpr int BM = 128;           // rows a tile: two warp groups of 64
constexpr int BN = 64;            // columns a tile (a chunk)
constexpr int KMAX = 128;         // k of A V^T a block keeps
constexpr int CONSUMERS = 2;
constexpr int NT = 128 * (CONSUMERS + 1);   // and the producer warp group
// registers a thread of each (setmaxnreg): the consumers' products and
// epilogue take more than the 168 of an even split
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int QC = 16;            // q a staging round of the A V^T build
constexpr int BOX_BYTES = 64 * 128;   // 64 rows of 128 bytes
constexpr int KB_BYTES = BN * 128;    // 32 k of A V^T (hi or lo) a chunk
constexpr int AV_BYTES = KMAX / 32 * KB_BYTES;   // hi or lo: 32 KB
constexpr int VS_FLOATS = BN * (QC + 1);         // odd pitch
constexpr int AS_FLOATS = QC * KMAX;

template <typename T>
struct Shape {
  static constexpr int ESZ = sizeof(T);
  static constexpr int BOXC = 128 / ESZ;         // columns of a TMA box
  static constexpr int BOXES = BN / BOXC;        // boxes of a half tile
  static constexpr int HALF = BOXES * BOX_BYTES;  // a warp group's rows
  static constexpr int PIECES = BN * ESZ / 16 + 1;   // 16-byte pieces a row
  static constexpr int PITCH = PIECES * 16;      // a row of the flat layout
  static constexpr int STAGE = BM * PITCH;       // >= 2 HALF, 1024-aligned
  static constexpr int STAGES = ESZ == 2 ? 6 : 4;
  static constexpr int SMEM = STAGES * STAGE + 2 * AV_BYTES +
                              4 * (VS_FLOATS + AS_FLOATS) + 1024;
  static_assert(STAGE % 1024 == 0 && STAGE >= 2 * HALF, "stage layout");
  static_assert(SMEM <= 232448, "one block a SM");
};

// The launch's geometry (subcge_apply.stream_plan): A V^T of a
// super-chunk's `sub` chunks, kb = ceil(kg / 32) 8 KB blocks each.
struct Geo {
  int E, nb, n, m, r, rp, K, kg, chunks, rtiles, sub, groups;
  long long sw, so;
  __device__ __forceinline__ int avs() const {   // a chunk's hi (or lo)
    return (kg + 31) / 32 * KB_BYTES;
  }
};

// A block's place in its range of tiles.  Per instance b, super-chunks sc
// of `sub` chunks (the last may hold fewer, ns), then row tiles rt, then
// the chunk j of the super-chunk: a block streams each row tile's ns
// neighbouring chunks (512 bytes of a bf16 row at sub = 4) one after the
// other, with one A V^T build per super-chunk and one U per row tile.
// Tile t of the launch is the t-th of that order; next() steps to t + 1
// with no division.
struct Cursor {
  long long b;
  int sc, rt, j, ns;

  __device__ void seek(const Geo& g, long long t) {
    const long long per_b = static_cast<long long>(g.chunks) * g.rtiles;
    b = t / per_b;
    const int u = static_cast<int>(t - b * per_b);
    sc = u / (g.sub * g.rtiles);
    const int v = u - sc * g.sub * g.rtiles;
    ns = min(g.sub, g.chunks - sc * g.sub);
    rt = v / ns;
    j = v - rt * ns;
  }
  __device__ __forceinline__ void next(const Geo& g) {
    if (++j < ns) return;
    j = 0;
    if (++rt < g.rtiles) return;
    rt = 0;
    if ((++sc) * g.sub >= g.chunks) {
      sc = 0;
      ++b;
    }
    ns = min(g.sub, g.chunks - sc * g.sub);
  }
  __device__ __forceinline__ int chunk(const Geo& g) const {
    return sc * g.sub + j;
  }
  __device__ __forceinline__ long long key(const Geo& g) const {
    return b * g.chunks + sc;
  }
};

// byte offset of AV element (k, c), k < KMAX, c < BN: K-major, 32 k (128
// bytes) a row, 128-byte swizzle (16-byte piece k / 4 of row c at piece
// k / 4 ^ c % 8), blocks of 32 k 8 KB apart
__device__ __forceinline__ int av_at(int k, int c) {
  return k / 32 * (BN * 128) + c * 128 + (((k % 32) / 4) ^ (c % 8)) * 16 +
         (k % 4) * 4;
}

// Forms AV rows [kg0, kg0 + kl) (kl <= KM) of instance b over the chunk at
// col0: AV[k][c] = sum_q A[e, b][p][q] V_e[col0 + c][q] for k = e rp + p
// (zero for p >= r or col0 + c >= m), split into TF32 hi and lo at
// av_at(k - kg0, c).  The 256 consumer threads: thread (kq, c) = (tid /
// 64, tid % 64) forms rows kq R + i (i < R, R = ne / 4 rounded up to 4) of
// each epoch's ne rows, from A and V staged in shared memory QC q a round
// (V as [col][q] at an odd pitch, A as [q][row]; the next round's global
// loads in flight while this one's sums run).  The caller's products no
// longer read AV.
template <int KM>
__device__ __forceinline__ void build_av(unsigned char* avhi,
                                         unsigned char* avlo, float* Vs,
                                         float* As,
                                         const float* __restrict__ A,
                                         const float* __restrict__ V,
                                         const Geo& g, long long b, int col0,
                                         int kg0, int kl) {
  constexpr int VN = BN * QC / 256, AN = KM * QC / 256;
  const int tid = threadIdx.x, c = tid % BN, kq = tid / BN;
  for (int e = kg0 / g.rp; e * g.rp < kg0 + kl; ++e) {
    const int k_lo = max(kg0, e * g.rp);
    const int ne = min(kg0 + kl, (e + 1) * g.rp) - k_lo;
    const int p0 = k_lo - e * g.rp;
    const int R = (ne + 15) / 16 * 4;   // rows a thread, a multiple of 4
    const float* Ve = V + ((long long)e * g.m + col0) * g.r;
    const float* Ae = A + (((long long)e * g.nb + b) * g.r + p0) * g.r;
    float vr[VN], ar[AN];
    auto load = [&](int q0) {
#pragma unroll
      for (int x = 0; x < VN; ++x) {
        const int i = tid + x * 256, cc = i / QC, q = q0 + i % QC;
        vr[x] = col0 + cc < g.m && q < g.r
                    ? __ldg(Ve + (long long)cc * g.r + q) : 0.f;
      }
#pragma unroll
      for (int x = 0; x < AN; ++x) {
        const int i = tid + x * 256, k = i / QC, q = q0 + i % QC;
        ar[x] = k < ne && p0 + k < g.r && q < g.r
                    ? __ldg(Ae + (long long)k * g.r + q) : 0.f;
      }
    };
    float acc[KM / 4];
#pragma unroll
    for (int i = 0; i < KM / 4; ++i) acc[i] = 0.f;
    load(0);
    for (int q0 = 0; q0 < g.r; q0 += QC) {
      bar_sync(1, CONSUMERS * 128);   // the last users of Vs and As are done
#pragma unroll
      for (int x = 0; x < VN; ++x) {
        const int i = tid + x * 256;
        Vs[i / QC * (QC + 1) + i % QC] = vr[x];
      }
#pragma unroll
      for (int x = 0; x < AN; ++x) {
        const int i = tid + x * 256;
        As[i % QC * KMAX + i / QC] = ar[x];
      }
      bar_sync(1, CONSUMERS * 128);
      if (q0 + QC < g.r) load(q0 + QC);
#pragma unroll 4
      for (int qq = 0; qq < QC; ++qq) {
        const float v = Vs[c * (QC + 1) + qq];
        const float* a = As + qq * KMAX + kq * R;
#pragma unroll
        for (int i4 = 0; i4 < KM / 16; ++i4) {
          if (4 * i4 < R) {
            const float4 a4 = *reinterpret_cast<const float4*>(a + 4 * i4);
            acc[4 * i4] = fmaf(a4.x, v, acc[4 * i4]);
            acc[4 * i4 + 1] = fmaf(a4.y, v, acc[4 * i4 + 1]);
            acc[4 * i4 + 2] = fmaf(a4.z, v, acc[4 * i4 + 2]);
            acc[4 * i4 + 3] = fmaf(a4.w, v, acc[4 * i4 + 3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < KM / 4; ++i) {
      const int k = kq * R + i;
      if (i < R && k < ne) {
        const uint32_t h = tf32_rna(acc[i]);
        const uint32_t l = tf32_rna(acc[i] - __uint_as_float(h));
        const int at = av_at(k_lo - kg0 + k, c);
        *reinterpret_cast<uint32_t*>(avhi + at) = h;
        *reinterpret_cast<uint32_t*>(avlo + at) = l;
      }
    }
  }
  fence_async_smem();   // AV, written here, is read by wgmma (async proxy)
  bar_sync(1, CONSUMERS * 128);
}

// build_av of any k group (KMAX rows), out of line: its 32 sums stay out
// of the register budget of the caller's products
__device__ __noinline__ void build_av_any(unsigned char* avhi,
                                          unsigned char* avlo, float* Vs,
                                          float* As, const float* A,
                                          const float* V, const Geo& g,
                                          long long b, int col0, int kg0,
                                          int kl) {
  build_av<KMAX>(avhi, avlo, Vs, As, A, V, g, b, col0, kg0, kl);
}

// The thread's A fragments of U for the (up to) four k8 steps of k [k0,
// k0 + 32) below kend, of the 64 rows at `rows` (its rows rows + 16 warp +
// lane / 4 + 8 h): u[s][i] = U[e][row][p] at row h = i % 2, k = k0 + 8 s +
// lane % 4 + 4 (i / 2) = e rp + p, zero for p >= r or a row past n.
__device__ __forceinline__ void load_u(float (&u)[4][4],
                                       const float* __restrict__ U,
                                       const Geo& g, int rows, int k0,
                                       int kend) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32 % 4;
  const int row = rows + 16 * warp + lane / 4;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int k = k0 + 8 * s;
    if (k < kend) {
      const int e = k / g.rp, p = k % g.rp + lane % 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = row + 8 * (i % 2), pp = p + 4 * (i / 2);
        u[s][i] = rr < g.n && pp < g.r
                      ? __ldg(U + ((long long)e * g.n + rr) * g.r + pp)
                      : 0.f;
      }
    }
  }
}

// Issues the products of the (up to) four k8 steps of one block of 32 k
// (block `blk` of the group, steps 4 blk ..) against the A V^T at avhi /
// avlo: for each step, u split into TF32 hi and lo (two steps' worth of
// registers, so a step waits for the one two before it), then cor += lo .
// AVhi + hi . AVlo and acc += hi . AVhi, each step its own commit group.
__device__ __forceinline__ void mma_block(float (&acc)[32], float (&cor)[32],
                                          const float (&u)[4][4],
                                          uint32_t (&ahi)[2][4],
                                          uint32_t (&alo)[2][4],
                                          uint32_t avhi, uint32_t avlo,
                                          int blk, int kl) {
#pragma unroll
  for (int s4 = 0; s4 < 4; ++s4) {
    const int s = 4 * blk + s4;
    if (8 * s < kl) {
      uint32_t(&hi)[4] = ahi[s4 % 2];
      uint32_t(&lo)[4] = alo[s4 % 2];
      if (s >= 2) {
        wgmma_wait<1>();   // step s - 2's products have read hi and lo
        fence_regs(hi);
        fence_regs(lo);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hi[i] = tf32_rna(u[s4][i]);
        lo[i] = tf32_rna(u[s4][i] - __uint_as_float(hi[i]));
      }
      const uint32_t off = blk * (BN * 128) + s4 * 32;
      const uint64_t dh = sw128_desc(avhi + off, 16, 1024);
      const uint64_t dl = sw128_desc(avlo + off, 16, 1024);
      wgmma_fence();
      wgmma_tf32_m64n64k8(cor, lo, dh, 1);
      wgmma_tf32_m64n64k8(cor, hi, dl, 1);
      wgmma_tf32_m64n64k8(acc, hi, dh, 1);
      wgmma_commit();
    }
  }
}

// Block k takes tiles [k per, min((k + 1) per, total)) of the launch, in
// the Cursor's order.  See the file's header.
template <typename T, bool FLAT>
__global__ void __launch_bounds__(NT, 1)
update_tc_kernel(const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap omap,
                 const T* W, T* out,   // may alias: no restrict
                 const float* __restrict__ U, const float* __restrict__ A,
                 const float* __restrict__ V, const Geo g, int per) {
  using S = Shape<T>;
  __shared__ __align__(8) uint64_t full[S::STAGES], empty[S::STAGES];
  extern __shared__ __align__(16) unsigned char raw[];
  unsigned char* ring = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  unsigned char* avhi = ring + S::STAGES * S::STAGE;
  unsigned char* avlo = avhi + AV_BYTES;
  float* Vs = reinterpret_cast<float*>(avlo + AV_BYTES);
  float* As = Vs + VS_FLOATS;
  const int wg = threadIdx.x / 128, ctid = threadIdx.x % 128;
  const long long total = (long long)g.nb * g.chunks * g.rtiles;
  const long long t0 = (long long)blockIdx.x * per;
  const int count = static_cast<int>(min((long long)per, total - t0));
  const int groups = g.groups;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(&full[i], FLAT ? 128 : 1);
      // TMA: each consumer warp is done with the stage; flat: each warp
      // group has stored it
      mbar_init(&empty[i], FLAT ? CONSUMERS : CONSUMERS * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    regs_dec<PRODUCER_REGS>();
    if (!FLAT && ctid != 0) return;
    // The producer warp group.  TMA: one thread loads tile i into stage i
    // % STAGES and stores it back from there once the consumers are done
    // with it, STAGES - 1 tiles later (just before the load that needs the
    // stage: by then the store of the tile before it has read its stage).
    // Flat: the warp group copies the pieces; the consumers store.
    const uint64_t policy = l2_evict_first();
    if (!FLAT) {
      prefetch_map(&wmap);
      prefetch_map(&omap);
    }
    Cursor lc, sc;   // the tile to load, the tile to store
    lc.seek(g, t0);
    sc = lc;
    for (int i = 0; i < count + S::STAGES - 1; ++i) {
      const int js = i - (S::STAGES - 1);   // the tile to store, if any
      if (!FLAT && js >= 0) {
        const int s = js % S::STAGES;
        mbar_wait(&empty[s], (js / S::STAGES) & 1);
        const unsigned char* st = ring + s * S::STAGE;
        const int col0 = sc.chunk(g) * BN, row0 = sc.rt * BM;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int x = 0; x < S::BOXES; ++x)
            tma_store_4d_hint(&omap, st + h * S::HALF + x * BOX_BYTES,
                              col0 + x * S::BOXC, row0 + 64 * h,
                              static_cast<int>(sc.b), 0, policy);
        bulk_commit();
        sc.next(g);
      }
      if (i >= count) continue;
      const int s = i % S::STAGES;
      unsigned char* st = ring + s * S::STAGE;
      const int col0 = lc.chunk(g) * BN, row0 = lc.rt * BM;
      if (!FLAT) {
        // the stage's last tile was stored by the group before the newest
        bulk_wait_read<1>();
        mbar_expect_tx(&full[s], 2 * S::HALF);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int x = 0; x < S::BOXES; ++x)
            tma_load_4d_hint(st + h * S::HALF + x * BOX_BYTES, &wmap,
                             col0 + x * S::BOXC, row0 + 64 * h,
                             static_cast<int>(lc.b), 0, &full[s], policy);
      } else {
        if (i >= S::STAGES)   // the consumers have stored the stage's tile
          mbar_wait(&empty[s], (i / S::STAGES - 1) & 1);
        // row rr's 16-byte pieces of the flat leaf that hold its elements
        // [col0, col0 + live), the first at the piece of col0
        const int live = min(BN, g.m - col0);
        const T* Wb = W + lc.b * g.sw;
        for (int k = ctid; k < BM * S::PIECES; k += 128) {
          const int rr = k / S::PIECES, j = k - rr * S::PIECES,
                    row = row0 + rr;
          if (row >= g.n) continue;
          const unsigned char* at = reinterpret_cast<const unsigned char*>(
              Wb + (long long)row * g.m + col0);
          const int shift = static_cast<int>(
              reinterpret_cast<std::uintptr_t>(at) & 15);
          if (16 * j >= shift + live * S::ESZ) continue;
          cp16(smem_u32(st + rr * S::PITCH + 16 * j), at - shift + 16 * j,
               16);
        }
        cp_async_arrive_noinc(&full[s]);
      }
      lc.next(g);
    }
    if (!FLAT) bulk_wait_all();   // the last stores have landed
    return;
  }

  // the consumers: warp group wg owns rows 64 wg .. 64 wg + 63 of a tile
  regs_inc<CONSUMER_REGS>();
  const int warp = ctid / 32, lane = ctid % 32;
  // A V^T of the super-chunk's chunk j at avhi / avlo + j avs
  const int avs = g.avs();
  long long built = -1;   // the Cursor key whose A V^T is in shared memory

  // Forms k group grp of A V^T of the super-chunk at c, unless it is there
  // already (`force`: k walks several groups, each formed anew); km: 32 or
  // 64 (k <= km, formed inline), else any k, out of line
  auto build = [&](const Cursor& c, int grp, bool force, int km) {
    if (!force && c.key(g) == built) return;
    const int kg0 = grp * g.kg, kl = min(g.kg, g.K - kg0);
    for (int j = 0; j < c.ns; ++j) {
      unsigned char *hi = avhi + j * avs, *lo = avlo + j * avs;
      const int col0 = (c.sc * g.sub + j) * BN;
      if (km == 32)
        build_av<32>(hi, lo, Vs, As, A, V, g, c.b, col0, kg0, kl);
      else if (km == 64)
        build_av<64>(hi, lo, Vs, As, A, V, g, c.b, col0, kg0, kl);
      else
        build_av_any(hi, lo, Vs, As, A, V, g, c.b, col0, kg0, kl);
    }
    built = force ? -1 : c.key(g);
  };

  // The epilogue of the i-th tile of the block (at c) from its delta
  // `acc`: thread (warp, lane) holds rows 16 warp + lane / 4 + 8 h of its
  // warp group's 64 and columns 8 j + 2 (lane % 4) + q.  Waits for the
  // tile's W; TMA: writes W + delta into the stage and hands it to the
  // producer to store; flat: stores it itself.
  auto epilogue = [&](float (&acc)[32], const Cursor& c, int i) {
    const int s = i % S::STAGES;
    mbar_wait(&full[s], (i / S::STAGES) & 1);
    unsigned char* st = ring + s * S::STAGE;
    const int col0 = c.chunk(g) * BN, row0 = c.rt * BM;
    const int live = min(BN, g.m - col0);
    if (!FLAT) {
      unsigned char* half = st + wg * S::HALF;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = 16 * warp + lane / 4 + 8 * h;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = 8 * j + 2 * (lane % 4);
          const int cb = (col % S::BOXC) * S::ESZ;
          unsigned char* at = half + col / S::BOXC * BOX_BYTES + rl * 128 +
                              ((cb / 16) ^ (rl % 8)) * 16 + cb % 16;
          if constexpr (S::ESZ == 2) {
            const uint32_t w = *reinterpret_cast<const uint32_t*>(at);
            *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(
                __uint_as_float(w << 16) + acc[4 * j + 2 * h],
                __uint_as_float(w & 0xffff0000u) + acc[4 * j + 2 * h + 1]);
          } else {
            const float2 w = *reinterpret_cast<const float2*>(at);
            *reinterpret_cast<float2*>(at) = make_float2(
                w.x + acc[4 * j + 2 * h], w.y + acc[4 * j + 2 * h + 1]);
          }
        }
      }
      fence_async_smem();   // the writes, before the producer's TMA store
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      return;
    }
    // W's rows start `ws` bytes into their first piece, out's `os`
    const T* Wb = W + c.b * g.sw;
    T* Ob = out + c.b * g.so;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = 64 * wg + 16 * warp + lane / 4 + 8 * h, row = row0 + rl;
      const unsigned char* srow = st + rl * S::PITCH;
      const int ws =
          row < g.n ? static_cast<int>(reinterpret_cast<std::uintptr_t>(
                                           Wb + (long long)row * g.m + col0) &
                                       15)
                    : 0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int cc = 8 * j + 2 * (lane % 4) + q;
          const T w = *reinterpret_cast<const T*>(srow + ws + cc * S::ESZ);
          float wf;
          if constexpr (S::ESZ == 2) wf = __bfloat162float(w);
          else wf = w;
          acc[4 * j + 2 * h + q] += wf;
        }
    }
    bar_sync(2 + wg, 128);   // the warp group's rows of W are read
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = 64 * wg + 16 * warp + lane / 4 + 8 * h, row = row0 + rl;
      if (row >= g.n) continue;
      unsigned char* srow = st + rl * S::PITCH;
      const int os = static_cast<int>(
          reinterpret_cast<std::uintptr_t>(Ob + (long long)row * g.m + col0) &
          15);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int cc = 8 * j + 2 * (lane % 4) + q;
          if (cc < live) {
            T* at = reinterpret_cast<T*>(srow + os + cc * S::ESZ);
            if constexpr (S::ESZ == 2)
              *at = __float2bfloat16_rn(acc[4 * j + 2 * h + q]);
            else
              *at = acc[4 * j + 2 * h + q];
          }
        }
    }
    bar_sync(2 + wg, 128);   // the rows of out are staged
    for (int k = ctid; k < 64 * S::PIECES; k += 128) {
      const int rl = 64 * wg + k / S::PIECES, j = k % S::PIECES,
                row = row0 + rl;
      if (row >= g.n) continue;
      unsigned char* orow =
          reinterpret_cast<unsigned char*>(Ob + (long long)row * g.m + col0);
      const int os = static_cast<int>(
          reinterpret_cast<std::uintptr_t>(orow) & 15);
      const int lo = 16 * j - os, hi = lo + 16;   // bytes of the row
      const unsigned char* srow = st + rl * S::PITCH;
      if (lo >= 0 && hi <= live * S::ESZ) {
        __stcs(reinterpret_cast<uint4*>(orow + lo),
               *reinterpret_cast<const uint4*>(srow + 16 * j));
      } else {
        for (int x = max(lo, 0); x < min(hi, live * S::ESZ); x += S::ESZ)
          *reinterpret_cast<T*>(orow + x) =
              *reinterpret_cast<const T*>(srow + os + x);
      }
    }
    bar_sync(2 + wg, 128);   // the stage is stored
    if (ctid == 0) mbar_arrive(&empty[s]);
  };

  Cursor cur;
  cur.seek(g, t0);

  // k <= 64 (every bf16 update of the main paths, and r = 64 at E = 1):
  // one k group of NS <= 8 k8 steps.  A row tile's U is split once into hi
  // and lo (kept while the super-chunk's chunks of that row tile pass; the
  // next row tile's U is loaded a tile ahead), and each warp
  // group keeps two accumulators, so that tile i + 1's products run on the
  // tensor cores while tile i's epilogue runs.  The three products of a
  // step go to one accumulator: a chain of at most 24 sums.
  auto pipe = [&](auto ns_tag) {
    constexpr int NS = decltype(ns_tag)::value;
    constexpr bool AHEAD = true;   // the next row tile's U, in flight
    uint32_t hi[NS][4], lo[NS][4];
    float un[NS][4];   // U of row tile un_rt, in flight
    float acc0[32], acc1[32];
    int cur_rt = -1, un_rt = -1;
    Cursor nxt = cur;   // the tile whose products are issued next
    auto load_rows = [&](int rt) {
#pragma unroll
      for (int b4 = 0; b4 < NS / 4; ++b4)
        load_u(*reinterpret_cast<float(*)[4][4]>(&un[4 * b4]), U, g,
               rt * BM + 64 * wg, 32 * b4, g.K);
      un_rt = rt;
    };
    // the products of tile nxt into acc, after whatever its A V^T and U
    // need; then nxt steps on
    auto issue = [&](float (&acc)[32], int i) {
      const bool need_av = nxt.key(g) != built, need_u = nxt.rt != cur_rt;
      if (need_av || need_u) {
        wgmma_wait<0>();   // the last products have read A V^T, hi and lo
#pragma unroll
        for (int s4 = 0; s4 < NS; ++s4) {
          fence_regs(hi[s4]);
          fence_regs(lo[s4]);
        }
      }
      if (need_av) build(nxt, 0, false, 8 * NS);
      if (need_u) {
        if (un_rt != nxt.rt) load_rows(nxt.rt);
#pragma unroll
        for (int s4 = 0; s4 < NS; ++s4)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            hi[s4][q] = tf32_rna(un[s4][q]);
            lo[s4][q] = tf32_rna(un[s4][q] - __uint_as_float(hi[s4][q]));
          }
        cur_rt = nxt.rt;
        un_rt = -1;
      }
      const uint32_t bh = smem_u32(avhi) + nxt.j * avs;
      const uint32_t bl = smem_u32(avlo) + nxt.j * avs;
      Cursor after = nxt;
      after.next(g);
      // the U of the next row tile, if the tile after this one starts it
      if (AHEAD && i + 1 < count && after.rt != nxt.rt) load_rows(after.rt);
#pragma unroll
      for (int q = 0; q < 32; ++q) acc[q] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int s4 = 0; s4 < NS; ++s4) {
        if (8 * s4 < g.K) {
          const uint32_t ko = s4 / 4 * KB_BYTES + s4 % 4 * 32;
          const uint64_t dh = sw128_desc(bh + ko, 16, 1024);
          const uint64_t dl = sw128_desc(bl + ko, 16, 1024);
          wgmma_tf32_m64n64k8(acc, lo[s4], dh, 1);
          wgmma_tf32_m64n64k8(acc, hi[s4], dl, 1);
          wgmma_tf32_m64n64k8(acc, hi[s4], dh, 1);
        }
      }
      wgmma_commit();
      fence_regs(acc);
      nxt = after;
    };
    auto finish = [&](float (&acc)[32], int i) {
      if (i + 1 < count) wgmma_wait<1>();   // tile i's products are done
      else wgmma_wait<0>();
      fence_regs(acc);
      epilogue(acc, cur, i);
      cur.next(g);
    };
    issue(acc0, 0);
    for (int i = 0; i < count; i += 2) {
      if (i + 1 < count) issue(acc1, i + 1);
      finish(acc0, i);
      if (i + 1 >= count) break;
      if (i + 2 < count) issue(acc0, i + 2);
      finish(acc1, i + 1);
    }
  };

  if (g.K <= 32) {
    pipe(std::integral_constant<int, 4>{});
  } else if (g.K <= 64) {
    pipe(std::integral_constant<int, 8>{});
  } else {
    // k > 64: U in blocks of four k8 steps, the next block in flight; A
    // V^T per super-chunk, or per tile and k group past k = 128.  u0 holds
    // block 0 of U of row tile u_rt (loaded for the next row tile while
    // this tile's epilogue runs), u1 the block in flight
    float u0[4][4], u1[4][4];
    // acc: the hi . hi products; cor: the two small ones, summed apart so
    // that the tensor cores' float32 sums drift by k / 8 steps, not 3 k / 8
    float acc[32], cor[32];
    uint32_t ahi[2][4], alo[2][4];
    int u_rt = -1;
    for (int i = 0; i < count; ++i) {
      const int rows = cur.rt * BM + 64 * wg;
      Cursor after = cur;
      after.next(g);
      for (int grp = 0; grp < groups; ++grp) {
        const int kg0 = grp * g.kg, kl = min(g.kg, g.K - kg0);
        const int kend = kg0 + kl, blocks = (kl + 31) / 32;
        build(cur, grp, groups > 1, 0);
        const uint32_t shi = smem_u32(avhi) + cur.j * avs;
        const uint32_t slo = smem_u32(avlo) + cur.j * avs;
        if (groups > 1 || u_rt != cur.rt) {
          load_u(u0, U, g, rows, kg0, kend);
          u_rt = groups > 1 ? -1 : cur.rt;
        }
        if (grp == 0) {
#pragma unroll
          for (int q = 0; q < 32; ++q) acc[q] = cor[q] = 0.f;
        }
        for (int blk = 0; blk < blocks; blk += 2) {
          if (blk + 1 < blocks)
            load_u(u1, U, g, rows, kg0 + 32 * (blk + 1), kend);
          mma_block(acc, cor, u0, ahi, alo, shi, slo, blk, kl);
          if (blk + 1 < blocks) {
            if (blk + 2 < blocks) {
              load_u(u0, U, g, rows, kg0 + 32 * (blk + 2), kend);
              u_rt = -1;
            }
            mma_block(acc, cor, u1, ahi, alo, shi, slo, blk + 1, kl);
          }
        }
        // the next row tile's U streams in while this tile is finished
        if (groups == 1 && i + 1 < count && after.rt != u_rt) {
          load_u(u0, U, g, after.rt * BM + 64 * wg, 0, kend);
          u_rt = after.rt;
        }
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(cor);
        fence_regs(ahi[0]);
        fence_regs(ahi[1]);
        fence_regs(alo[0]);
        fence_regs(alo[1]);
      }
#pragma unroll
      for (int q = 0; q < 32; ++q) acc[q] += cor[q];
      epilogue(acc, cur, i);
      cur = after;
    }
  }
}

template <typename T>
int launch(const void* W, void* out, const void* U, const void* A,
           const void* V, int E, int nb, int n, int m, int r, int rp, int K,
           int kg, int chunks, int rtiles, int sub, int per, int blocks,
           int smem, long long sw, long long so, void* stream) {
  using S = Shape<T>;
  const long long total = (long long)nb * chunks * rtiles;
  if (r < 1 || E < 1 || nb < 1 || n < 1 || m < 1 || rp != (r + 7) / 8 * 8 ||
      K != E * rp || kg < 8 || kg > KMAX || kg % 8 != 0 || kg > K ||
      (kg < K && kg != KMAX) || chunks != (m + BN - 1) / BN ||
      sub != max(1, 4 / ((kg + 31) / 32)) ||
      rtiles != (n + BM - 1) / BM || per < 1 || blocks < 1 ||
      (long long)(blocks - 1) * per >= total ||
      (long long)blocks * per < total || smem != S::SMEM ||
      !aligned(W, S::ESZ) || !aligned(out, S::ESZ) ||
      !aligned(U, 4) || !aligned(A, 4) || !aligned(V, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapDataType type = S::ESZ == 2
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  // dims innermost first: (m, n, nb, 1), boxes of 128 bytes x 64 rows
  const long long dims[4] = {m, n, nb, 1};
  const long long ws[3] = {(long long)m * S::ESZ, sw * S::ESZ,
                           nb * sw * S::ESZ};
  const long long os[3] = {(long long)m * S::ESZ, so * S::ESZ,
                           nb * so * S::ESZ};
  CUtensorMap wmap, omap;
  const bool tma = map_4d(&wmap, type, S::ESZ, W, dims, ws, S::BOXC, 64) &&
                   map_4d(&omap, type, S::ESZ, out, dims, os, S::BOXC, 64);
  const Geo geo{E,      nb,  n,   m,      r,      rp, K, kg,
                chunks, rtiles, sub, (K + kg - 1) / kg, sw, so};
  auto kernel = tma ? update_tc_kernel<T, false> : update_tc_kernel<T, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      wmap, omap, static_cast<const T*>(W), static_cast<T*>(out),
      static_cast<const float*>(U), static_cast<const float*>(A),
      static_cast<const float*>(V), geo, per);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// out[b] = W[b] + sum_e U[e] A[e, b] V[e]^T.  U (E, n, r), A (E, nb, r, r)
// and V (E, m, r) contiguous float32; W[b] and out[b] contiguous (n, m)
// float32 matrices at batch strides sw / so; out may alias W.  The
// geometry comes from subcge_apply.update_plan: chunk width 1 << lbc,
// `chunks` chunks per instance, `per` tiles a block over `blocks` blocks,
// AV of `G` epochs, `smem` bytes of shared memory.  Returns the launch's
// CUDA error (r > 32 and malformed plans are refused with
// cudaErrorInvalidValue).
extern "C" int subcge_apply_f32(const void* W, void* out, const void* U,
                                const void* A, const void* V, int E, int nb,
                                int n, int m, int r, int lbc, int chunks,
                                int per, int blocks, int G, int smem,
                                long long sw, long long so, void* stream) {
  if (r < 1 || r > RMAX || E < 1 || G < 1 || lbc < 2 || lbc > 7 ||
      chunks < 1 || per < 1 || blocks < 1 || nb < 1 || n < 1 ||
      chunks != (m + (1 << lbc) - 1) >> lbc)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = m % 4 == 0 && (sw | so) % 4 == 0 && aligned(W, 16) &&
                   aligned(out, 16);
  auto kernel = vec ? subcge_stream_kernel<true> : subcge_stream_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<float*>(out),
      static_cast<const float*>(U), static_cast<const float*>(A),
      static_cast<const float*>(V), E, G, nb, n, m, r, lbc, chunks, per,
      r % 4 == 0 && aligned(U, 16), sw, so);
  return static_cast<int>(cudaGetLastError());
}

// The same update on the tensor cores (update_tc_kernel): W and out
// float32 (subcge_update_tc_f32, any r) or bf16 (subcge_update_tc_bf16:
// f32(W) + delta stored rounded to nearest even); U, A and V float32 as
// above.  The geometry comes from subcge_apply.stream_plan: each epoch's
// rank padded to rp, k = E rp, k walked in groups of kg, `chunks` column
// chunks of 64 and `rtiles` row tiles of 128 per instance, walked in
// super-chunks of `sub` chunks, `per` tiles a block over `blocks` blocks,
// `smem` bytes of shared memory.  Leaves TMA
// can describe stream by TMA, the others by 16-byte cp.async.  Returns
// the launch's CUDA error (a malformed plan: cudaErrorInvalidValue).
extern "C" int subcge_update_tc_f32(const void* W, void* out, const void* U,
                                    const void* A, const void* V, int E,
                                    int nb, int n, int m, int r, int rp,
                                    int K, int kg, int chunks, int rtiles,
                                    int sub, int per, int blocks, int smem,
                                    long long sw, long long so,
                                    void* stream) {
  return tc::launch<float>(W, out, U, A, V, E, nb, n, m, r, rp, K, kg,
                           chunks, rtiles, sub, per, blocks, smem, sw, so,
                           stream);
}

extern "C" int subcge_update_tc_bf16(const void* W, void* out, const void* U,
                                     const void* A, const void* V, int E,
                                     int nb, int n, int m, int r, int rp,
                                     int K, int kg, int chunks, int rtiles,
                                     int sub, int per, int blocks, int smem,
                                     long long sw, long long so,
                                     void* stream) {
  return tc::launch<__nv_bfloat16>(W, out, U, A, V, E, nb, n, m, r, rp, K,
                                   kg, chunks, rtiles, sub, per, blocks, smem,
                                   sw, so, stream);
}
