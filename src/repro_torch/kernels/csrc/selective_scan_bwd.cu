// Backward of the Mamba-1 selective scan for Hopper (sm_90a).  The forward
//   h_t = a_t * h_{t-1} + bx_t,   y_t[d] = sum_n h_t[d, n] * c_t[n]
// (csrc/selective_scan.cu) maps a, bx (B, T, D, N), c (B, T, N) and h0
// (B, D, N) to y (B, T, D) and h_last = h_T.  Given dy (B, T, D) and
// dh_last (B, D, N), this file computes the reverse scan
//   g_T = dh_last + dy_T[d] c_T[n],   g_t = dy_t[d] c_t[n] + a_{t+1} g_{t+1}
//   da_t = g_t h_{t-1},  dbx_t = g_t,  dh0 = a_1 g_1,
//   dc_t[n] = sum_d dy_t[d] h_t[d, n]
// all float32.
//
// Replaces the gradient that jax.grad takes through _ssm_chunked
// (src/repro/models/layers.py:327) in the JAX package: the TPU path has no
// Pallas backward, XLA differentiates the chunked associative scan.
//
// Bound on this card: HBM bytes.  Each state element costs a handful of
// flops against 16 bytes: one read of a and bx, one write of da and dbx
// (dy, c, h0, dh_last, dc and dh0 are smaller by a factor of N or T).
//
// Design: one HBM pass whenever T fits a chunk.
//   A tile is COLS = 128 contiguous state elements along D*N (the N lanes of
//   a channel share a warp) x up to ``chunk`` steps.  Block k of batch row
//   b walks tiles k, k + nblk, ... (so the blocks in flight stream
//   neighbouring runs of each row), each over its chunks, the last first.
//   A (chunk, tile) item lives in one stage of a two-stage ring in shared
//   memory: a, bx, dy, the chunk's c, the tile's start state and dh_last.
//   One producer warp fills a stage with TMA tensor loads (boxes of a, bx
//   and dy over (B, T, D*N) and (B, T, D) maps) and bulk copies, completing
//   on the stage's ``full`` mbarrier, and drains it with TMA tensor stores
//   of da and dbx once the consumers arrive on its ``empty`` mbarrier; so
//   item j + 1 loads and item j - 1 stores while item j computes.  Where a
//   row is not a multiple of 16 bytes (D % 4 != 0 or N < 4) or a tensor is
//   off 16 bytes, the producer fills and drains the same ring with 4-byte
//   cp.async and plain stores instead.
//   Four consumer warps, one thread per state element:
//   - forward recompute from the start state with fmaf(a, h, bx),
//     overwriting the bx slot of step t with h_{t-1} (bx is not needed
//     again) and the start-state slot with the chunk's last h;
//   - dc: dc sums D = 8192 products whose partial sums reach ~100 x the
//     result; in float32 that sum strayed past 1e-5 of a float64 oracle, so
//     the products (exact in float64) and every sum are float64.  After the
//     forward, the consumers sweep the tile's h together: thread q sums the
//     tile's channels of one (t, n) and adds it to its own float64 slot,
//     which holds the block's partial over its tiles, in a fixed order; at
//     the block's last tile of a chunk it writes one partial per
//     (b, t, block, n), at most 128 blocks per batch row;
//   - reverse with g = fmaf(dy, c, carry), da = g * h_{t-1}, carry = a * g,
//     writing da over a's slot and dbx over h's.  The last carry is dh0.
//   The per-element arithmetic is the same sequence of the same intrinsics
//   as a single walk over T, so da, dbx and dh0 do not depend on the tiling.
//   T longer than a chunk: a pre-pass (ckpt_kernel) writes h at every chunk
//   start after the first, (B, chunks - 1, D, N); the chunks are then
//   recomputed from their checkpoints, the last first, and g is carried
//   across chunks through dh0 (each thread reads back only what it wrote).
//   That path moves ~24 B per element.
//   A second kernel sums each (b, t, n)'s block partials in ascending block
//   order, in float64, and rounds once.  No atomics: two calls give the
//   same bits.
// The geometry is chosen by the pure Python function
// ``selective_scan.scan_bwd_plan``; the entry point refuses a plan it cannot
// run.  N must be a power of two that divides 32 (1..32), as in the forward.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int COLS = 128;               // state elements of a tile
constexpr int NT = COLS;                // consumer threads, one per column
constexpr int NTHREADS = NT + 32;       // and one producer warp
constexpr int UNROLL = 8;
constexpr int SMEM_MAX = 232448;        // what a block may use on sm_90
constexpr int CKPT_NT = 256;

// ``bytes`` (a multiple of 16, both addresses 16-byte aligned) from global
// into shared memory, completing on ``bar``
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the box of ``map`` at (x, t, b) into shared memory, completing on ``bar``
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int t, int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x),
         "r"(t), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// shared memory into the box of ``map`` at (x, t, b); what falls outside
// the tensor is not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int x, int t,
                                          int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3}], [%4];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(t), "r"(b),
         "r"(smem_u32(src))
      : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__host__ __device__ constexpr long long round32(long long x) {
  return (x + 31) / 32 * 32;
}

// floats of one ring stage with ``rows`` steps per tile, every part on 128
// bytes: a and bx (rows x COLS each; da and dbx on the way out), dy (rows x
// COLS / N), c (rows x N), the tile's start state and dh_last (COLS each)
__host__ __device__ constexpr long long stage_floats(int rows, int N) {
  return 2LL * rows * COLS + round32((long long)rows * (COLS / N))
         + round32((long long)rows * N) + 2 * COLS;
}

// dynamic shared memory of a launch: the two-stage ring, the block's
// float64 dc partials (rows x N) and four mbarriers
__host__ __device__ constexpr long long smem_bytes(int rows, int N) {
  return 2 * 4 * stage_floats(rows, N) + (long long)rows * N * 8 + 32;
}

// h at every chunk start after the first: ckpt[b, k - 1] = h_{k * chunk}
// for k = 1 .. nchunks - 1.  One thread per state element, loads UNROLL
// steps ahead; the same fmaf chain as the main kernel's walk.
__global__ void __launch_bounds__(CKPT_NT)
ckpt_kernel(const float* __restrict__ a, const float* __restrict__ bx,
            const float* __restrict__ h0, float* __restrict__ ckpt, int T,
            long long DN, int chunk, int nchunks) {
  const long long idx = (long long)blockIdx.x * CKPT_NT + threadIdx.x;
  if (idx >= DN) return;
  const long long b = blockIdx.y;
  const float* ap = a + b * T * DN + idx;
  const float* bp = bx + b * T * DN + idx;
  float* out = ckpt + b * (nchunks - 1) * DN + idx;
  const int tend = (nchunks - 1) * chunk;
  float h = h0[b * DN + idx];
  for (int t0 = 0; t0 < tend; t0 += UNROLL) {
    float ra[UNROLL], rb[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool live = t0 + u < tend;
      ra[u] = live ? __ldg(ap + (long long)(t0 + u) * DN) : 0.f;
      rb[u] = live ? __ldg(bp + (long long)(t0 + u) * DN) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u;
      if (t < tend) {
        h = fmaf(ra[u], h, rb[u]);
        if ((t + 1) % chunk == 0) out[(long long)((t + 1) / chunk - 1) * DN] = h;
      }
    }
  }
}

// the tensor maps of one launch: a, bx, da, dbx over (B, T, D*N) with boxes
// of COLS x rows, dy over (B, T, D) with boxes of COLS / N x rows
struct Maps {
  CUtensorMap a, bx, da, dbx, dy;
};

// one stage of the ring: A, X (rows x COLS), Y (rows x COLS / N), C (rows x
// N), H (the start state; the chunk's last h after the forward), G (dh_last)
struct Stage {
  float *A, *X, *Y, *C, *H, *G;
};

template <int N>
__device__ __forceinline__ Stage stage_at(float* base, int rows) {
  Stage st;
  st.A = base;
  st.X = st.A + (long long)rows * COLS;
  st.Y = st.X + (long long)rows * COLS;
  st.C = st.Y + round32((long long)rows * (COLS / N));
  st.H = st.C + round32((long long)rows * N);
  st.G = st.H + COLS;
  return st;
}

template <int N>
__global__ void __launch_bounds__(NTHREADS)
scan_bwd_kernel(const __grid_constant__ Maps maps,
                const float* __restrict__ a, const float* __restrict__ bx,
                const float* __restrict__ c, const float* __restrict__ h0,
                const float* __restrict__ dy,
                const float* __restrict__ dh_last,
                const float* __restrict__ ckpt, float* __restrict__ da,
                float* __restrict__ dbx, float* __restrict__ dh0,
                double* __restrict__ part, int T, int D, int chunk,
                int nchunks, int tiles, int bulk) {
  constexpr int YW = COLS / N;            // channels of a tile
  extern __shared__ __align__(128) unsigned char smem[];
  const long long DN = (long long)D * N;
  const int rows = T < chunk ? T : chunk;
  const long long SF = stage_floats(rows, N);
  float* ring = reinterpret_cast<float*>(smem);
  double* acc = reinterpret_cast<double*>(ring + 2 * SF);
  uint64_t* full = reinterpret_cast<uint64_t*>(acc + (long long)rows * N);
  uint64_t* empty = full + 2;

  const int tid = threadIdx.x;
  const long long b = blockIdx.y;
  const int blk = blockIdx.x, nblk = gridDim.x;
  const int ntile = (tiles - blk + nblk - 1) / nblk;
  const int items = nchunks * ntile;

  if (tid < NT)
    for (int q = tid; q < rows * N; q += NT) acc[q] = 0.0;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // item j: chunk nchunks - 1 - j / ntile (the last first), tile j % ntile
  auto chunk_of = [&](int j) { return nchunks - 1 - j / ntile; };
  auto col0_of = [&](int j) {
    return (long long)(blk + j % ntile * nblk) * COLS;
  };

  if (tid >= NT) {
    // the producer warp: drain item j - 2's stage, then fill it with item j
    const int lane = tid - NT;
    auto drain = [&](int j) {
      const int t0 = chunk_of(j) * chunk;
      const long long col0 = col0_of(j);
      const Stage st = stage_at<N>(ring + (j & 1) * SF, rows);
      mbar_wait(&empty[j & 1], (j >> 1) & 1);
      if (bulk) {
        if (lane == 0) {
          tma_store(&maps.da, st.A, (int)col0, t0, (int)b);
          tma_store(&maps.dbx, st.X, (int)col0, t0, (int)b);
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        }
      } else {
        const int rk = T - t0 < chunk ? T - t0 : chunk;
        const long long base = (b * T + t0) * DN + col0;
        for (int e = lane; e < rk * COLS; e += 32) {
          const int r = e / COLS, x = e % COLS;
          if (col0 + x < DN) {
            da[base + (long long)r * DN + x] = st.A[e];
            dbx[base + (long long)r * DN + x] = st.X[e];
          }
        }
      }
      __syncwarp();
    };
    auto fill = [&](int j) {
      const int k = chunk_of(j), t0 = k * chunk;
      const bool last = k == nchunks - 1;
      const int rk = T - t0 < chunk ? T - t0 : chunk;
      const long long col0 = col0_of(j), d0 = col0 / N;
      const long long left = DN - col0, yleft = D - d0;
      const int cw = (int)(left < COLS ? left : COLS);
      const int yw = (int)(yleft < YW ? yleft : YW);
      const float* hs = (k == 0 ? h0 + b * DN
                                : ckpt + (b * (nchunks - 1) + k - 1) * DN)
                        + col0;
      const Stage st = stage_at<N>(ring + (j & 1) * SF, rows);
      uint64_t* bar = &full[j & 1];
      if (bulk) {
        if (lane == 0) {
          const uint32_t box = 4u * rows * COLS, ybox = 4u * rows * YW;
          mbar_expect_tx(bar, 2 * box + ybox + 4u * rk * N
                                  + (last ? 2u : 1u) * 4u * cw);
          tma_load(st.A, &maps.a, (int)col0, t0, (int)b, bar);
          tma_load(st.X, &maps.bx, (int)col0, t0, (int)b, bar);
          tma_load(st.Y, &maps.dy, (int)d0, t0, (int)b, bar);
          bulk_load(st.C, c + (b * T + t0) * N, 4u * rk * N, bar);
          bulk_load(st.H, hs, 4u * cw, bar);
          if (last) bulk_load(st.G, dh_last + b * DN + col0, 4u * cw, bar);
        }
      } else {
        const long long base = (b * T + t0) * DN + col0;
        const long long ybase = (b * T + t0) * D + d0;
        for (int e = lane; e < rk * COLS; e += 32) {
          const int r = e / COLS, x = e % COLS;
          if (x < cw) {
            copy4(st.A + e, a + base + (long long)r * DN + x);
            copy4(st.X + e, bx + base + (long long)r * DN + x);
          }
        }
        for (int e = lane; e < rk * yw; e += 32)
          copy4(st.Y + e / yw * YW + e % yw,
                dy + ybase + (long long)(e / yw) * D + e % yw);
        for (int e = lane; e < rk * N; e += 32)
          copy4(st.C + e, c + (b * T + t0) * N + e);
        for (int e = lane; e < cw; e += 32) {
          copy4(st.H + e, hs + e);
          if (last) copy4(st.G + e, dh_last + b * DN + col0 + e);
        }
        asm volatile("cp.async.wait_all;" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(bar);
      }
    };
    for (int j = 0; j < items; ++j) {
      if (j >= 2) drain(j - 2);
      fill(j);
    }
    for (int j = items < 2 ? 0 : items - 2; j < items; ++j) drain(j);
    if (bulk && lane == 0)
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    return;
  }

  // the consumers: one thread per state element of the tile
  const int n = tid % N, dl = tid / N;    // tiles start at multiples of N
  for (int j = 0; j < items; ++j) {
    const int k = chunk_of(j);
    const bool last = k == nchunks - 1;
    const long long col0 = col0_of(j), col = col0 + tid;
    const bool valid = col < DN;
    const int t0 = k * chunk;
    const int rk = T - t0 < chunk ? T - t0 : chunk;
    const long long yleft = D - col0 / N;
    const int yw = (int)(yleft < YW ? yleft : YW);
    const Stage st = stage_at<N>(ring + (j & 1) * SF, rows);
    // past the last chunk the carry was parked in dh0 by this thread
    const float parked = !last && valid ? dh0[b * DN + col] : 0.f;
    mbar_wait(&full[j & 1], (j >> 1) & 1);

    // forward recompute from the chunk's start state; bx's slot t <- h_{t-1}
    float h = st.H[tid];
    for (int u0 = 0; u0 < rk; u0 += UNROLL) {
      float ra[UNROLL], rb[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int t = u0 + u;
        ra[u] = t < rk ? st.A[t * COLS + tid] : 0.f;
        rb[u] = t < rk ? st.X[t * COLS + tid] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (u0 + u < rk) {
          st.X[(u0 + u) * COLS + tid] = h;
          h = fmaf(ra[u], h, rb[u]);
        }
      }
    }
    const float g_last = st.G[tid];
    st.H[tid] = h;                          // h after the chunk's last step
    asm volatile("bar.sync 1, %0;" :: "n"(NT) : "memory");

    // dc: thread q's (t, n) summed over the tile's channels, into its slot
    for (int q = tid; q < rk * N; q += NT) {
      const int t = q / N, m = q % N;
      const float* hr = t + 1 < rk ? st.X + (t + 1) * COLS : st.H;
      const float* yr = st.Y + t * YW;
      double s = 0.0;
      for (int e = 0; e < yw; ++e)
        s = fma((double)yr[e], (double)hr[e * N + m], s);
      acc[q] += s;
    }
    asm volatile("bar.sync 1, %0;" :: "n"(NT) : "memory");

    // the reverse scan over the chunk, from dh_last or the parked carry;
    // da over a's slot, dbx over h's
    float carry = last ? g_last : parked;
    for (int u0 = rk - 1; u0 >= 0; u0 -= UNROLL) {
      float ra[UNROLL], rh[UNROLL], rc[UNROLL], ry[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int t = u0 - u;
        const bool live = t >= 0;
        ra[u] = live ? st.A[t * COLS + tid] : 0.f;
        rh[u] = live ? st.X[t * COLS + tid] : 0.f;
        ry[u] = live ? st.Y[t * YW + dl] : 0.f;
        rc[u] = live ? st.C[t * N + n] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int t = u0 - u;
        if (t >= 0) {
          const float g = fmaf(ry[u], rc[u], carry);
          st.X[t * COLS + tid] = g;
          st.A[t * COLS + tid] = g * rh[u];
          carry = ra[u] * g;
        }
      }
    }
    if (valid) dh0[b * DN + col] = carry;
    // the stage goes to the producer (and its async-proxy stores)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(&empty[j & 1]);

    // the block's last tile of chunk k: its dc partials of the chunk's rows
    if (j % ntile == ntile - 1) {
      for (int q = tid; q < rk * N; q += NT) {
        part[((b * T + t0 + q / N) * nblk + blk) * N + q % N] = acc[q];
        acc[q] = 0.0;
      }
    }
  }
}

// dc[b, t, n] = sum over blocks k = 0..nblk-1 of part[b, t, k, n], in that
// order, in float64, rounded once to float32; one thread per (b, t, n).
__global__ void __launch_bounds__(256)
dc_sum_kernel(const double* __restrict__ part, float* __restrict__ dc,
              long long BT, int nblk, int N) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= BT * N) return;
  const long long bt = i / N;
  const int n = (int)(i % N);
  const double* p = part + bt * nblk * N + n;
  double s = 0.0;
  for (int k = 0; k < nblk; ++k) s += p[(long long)k * N];
  dc[i] = (float)s;
}

// a contiguous float32 (B, T, W) tensor as a map {W, T, B} with boxes of
// box_w x rows x 1; W must be a multiple of 4 (16-byte row strides)
bool map3d(CUtensorMap* m, const void* p, long long W, int T, int B,
           int box_w, int rows) {
  const EncodeTiled f = encode_tiled();
  if (f == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)W * T * 4};
  const cuuint32_t box[3] = {(cuuint32_t)box_w, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return f(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(p), dims,
           strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
           CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N>
int launch(const float* a, const float* bx, const float* c, const float* h0,
           const float* dy, const float* dh_last, float* da, float* dbx,
           float* dc, float* dh0, double* part, float* ckpt, int B, int T,
           int D, int chunk, int per, int nblk, int smem, int bulk,
           cudaStream_t stream) {
  const long long DN = (long long)D * N;
  const long long tiles = (DN + COLS - 1) / COLS;
  const int nchunks = (T + chunk - 1) / chunk;
  const int rows = T < chunk ? T : chunk;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (tiles > 0x7fffffffLL || DN > 0x7fffffffLL ||
      (long long)nblk * per < tiles || nblk > tiles || rows > 256 ||
      smem != smem_bytes(rows, N) || smem > SMEM_MAX ||
      (nchunks > 1 && ckpt == nullptr) ||
      (bulk && (D % 4 != 0 || N < 4 || !aligned(a) || !aligned(bx) ||
                !aligned(c) || !aligned(h0) || !aligned(dy) ||
                !aligned(dh_last) || !aligned(ckpt) || !aligned(da) ||
                !aligned(dbx))))
    return static_cast<int>(cudaErrorInvalidValue);
  Maps maps;
  std::memset(&maps, 0, sizeof maps);
  if (bulk && !(map3d(&maps.a, a, DN, T, B, COLS, rows) &&
                map3d(&maps.bx, bx, DN, T, B, COLS, rows) &&
                map3d(&maps.da, da, DN, T, B, COLS, rows) &&
                map3d(&maps.dbx, dbx, DN, T, B, COLS, rows) &&
                map3d(&maps.dy, dy, D, T, B, COLS / N, rows)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (nchunks > 1) {
    dim3 g((unsigned)((DN + CKPT_NT - 1) / CKPT_NT), (unsigned)B);
    ckpt_kernel<<<g, CKPT_NT, 0, stream>>>(a, bx, h0, ckpt, T, DN, chunk,
                                           nchunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(scan_bwd_kernel<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scan_bwd_kernel<N><<<dim3((unsigned)nblk, (unsigned)B), NTHREADS, smem,
                       stream>>>(maps, a, bx, c, h0, dy, dh_last, ckpt, da,
                                 dbx, dh0, part, T, D, chunk, nchunks,
                                 (int)tiles, bulk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long BT = (long long)B * T;
  const long long blocks = (BT * N + 255) / 256;
  dc_sum_kernel<<<(unsigned)blocks, 256, 0, stream>>>(part, dc, BT, nblk, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// da, dbx (B, T, D, N), dc (B, T, N) and dh0 (B, D, N) from a, bx, c, h0
// (the forward's inputs), dy (B, T, D) and dh_last (B, D, N), all contiguous
// float32, under the plan ``selective_scan.scan_bwd_plan`` gives: ``cols``
// state elements per tile, ``chunk`` steps per tile, at most ``per`` tiles
// per block, ``nblk`` blocks per batch row, ``smem`` dynamic shared bytes,
// and ``bulk`` 1 for TMA and bulk copies (D % 4 == 0, N >= 4, every tensor
// 16-byte aligned) or 0 for the masked path.  ``part`` is float64 scratch
// of B * T * nblk * N values; ``ckpt`` float32 scratch of B *
// (ceil(T / chunk) - 1) * D * N values (null when T <= chunk).  Launches
// two or three kernels and returns cudaGetLastError().  An N that is not a
// power of two <= 32, or a plan or shape this file cannot run, is refused
// with cudaErrorInvalidValue.
extern "C" int selective_scan_bwd_f32(const void* a, const void* bx,
                                      const void* c, const void* h0,
                                      const void* dy, const void* dh_last,
                                      void* da, void* dbx, void* dc,
                                      void* dh0, void* part, void* ckpt,
                                      int B, int T, int D, int N, int cols,
                                      int chunk, int per, int nblk, int smem,
                                      int bulk, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || D < 1 || cols != COLS || chunk < 1 ||
      per < 1 || nblk < 1 || part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* pa = static_cast<const float*>(a);
  const auto* pb = static_cast<const float*>(bx);
  const auto* pc = static_cast<const float*>(c);
  const auto* ph = static_cast<const float*>(h0);
  const auto* py = static_cast<const float*>(dy);
  const auto* pl = static_cast<const float*>(dh_last);
  auto* oa = static_cast<float*>(da);
  auto* ob = static_cast<float*>(dbx);
  auto* oc = static_cast<float*>(dc);
  auto* oh = static_cast<float*>(dh0);
  auto* pp = static_cast<double*>(part);
  auto* pk = static_cast<float*>(ckpt);
  auto s = static_cast<cudaStream_t>(stream);
#define SCAN_BWD_CASE(NN)                                                    \
  case NN:                                                                   \
    return launch<NN>(pa, pb, pc, ph, py, pl, oa, ob, oc, oh, pp, pk, B, T,  \
                      D, chunk, per, nblk, smem, bulk, s);
  switch (N) {
    SCAN_BWD_CASE(1)
    SCAN_BWD_CASE(2)
    SCAN_BWD_CASE(4)
    SCAN_BWD_CASE(8)
    SCAN_BWD_CASE(16)
    SCAN_BWD_CASE(32)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SCAN_BWD_CASE
}
