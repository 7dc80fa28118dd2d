// Fused SubCGE weight update for Hopper (sm_90a), as one streaming pass:
//   W[b] <- W[b] + sum_e U[e] A[e, b] V[e]^T
//
// Replaces the Pallas TPU kernels src/repro/kernels/subcge_apply.py
// subcge_apply (one subspace, E = 1) and subcge_apply_epochs (E sender
// tau-epochs, which Pallas folds into one rank-E*r visit with a
// block-diagonal A).  Instance dims (clients x stacked layers) collapse
// into the leading b axis.
//
// Bound on this card: with r = 16 every element of W costs E*r FMAs
// against 8 bytes of HBM traffic (read + write), i.e. 4*E flops per byte,
// below the float32 ridge of ~20 flops per byte: the update is HBM-bound
// at exactly one read and one write of W (3.35 TB/s).  To stream at that
// rate an SM needs, by Little's law, some 25-40 KB of W in flight at every
// moment, and nothing else may cost it time.
//
// Design.  The delta is formed as U (A V^T): AV_e = A[e, b] V_e^T over a
// chunk of bc columns is the same for every row of instance b.  The grid is
// persistent: three blocks per SM, each walking one contiguous range of the
// launch's (instance, column chunk, row tile) list, so every block moves the
// same bytes (to one tile) and the stream never waits on a block's start.
// (Dealing neighbouring chunks of the same rows to neighbouring blocks, so
// that the card reads whole rows at a time as a copy does, measured slower.)
//
// * AV: when a block enters a new (instance, chunk), it stages A[e, b] and
//   the chunk's V rows in shared memory for each epoch and forms AV_e
//   (r x bc) there: r * r * bc FMAs, against 32 * bc * r per tile of the
//   tiles that follow (tens to thousands of them on the main paths).
// * Each tile: every thread copies its own 4 rows x 4 columns of the next
//   tile into its own slots of a 2-stage ring in shared memory (16-byte
//   cp.async.cg: W is read once, through L2 only), then forms this tile's
//   4 x 4 delta in registers while they are in flight: for each epoch and
//   4 p, one float4 of each of its rows of U (read through L1; a warp's
//   lanes share a few rows) and 4 float4s of AV from shared memory, 64
//   FMAs.  Then it waits for its own copies of this tile (cp.async
//   wait_group; a thread reads only its own slots, so no barrier) and
//   stores W + delta as float4s with the evict-first hint (st.global.cs).
//   No register holds W, so a thread needs 79 and three blocks of 256
//   threads fit an SM (48 KB of W in flight).  Of the shapes tried (8 or 4
//   rows a thread, 2 to 4 stages, 1 to 4 blocks per SM), this one streamed
//   fastest.  What is left is the delta's arithmetic beside the stream:
//   small at E = 1, and at E >= 2 the tile's 2 E r FMAs per element keep
//   the stream from its rate (PERF.md).
// * Narrow leaves.  The chunk width bc (4 to 128 columns, a power of two)
//   is chosen per leaf by the wrapper (subcge_apply.update_plan), so that
//   m = 4, 16, 32 or 288 pads little: bc / 4 lanes cover a row, 32 / (bc / 4)
//   rows a warp, and a tile is 8 warps x 4 rows x that many rows.
// * Epochs loop inside the tile, so W is streamed once for any E.  AV of up
//   to `G` epochs fits the block's shared memory (G = E on the main paths);
//   a larger E takes the epochs G at a time and rebuilds AV per tile.
// * In place (out == W) is legal: each element is read and then written by
//   the one thread that owns it, and no block reads another's elements.
// * r <= 32; m not a multiple of 4, or W off 16 bytes, take 4-byte loads
//   and stores in the same kernel (VEC = false); r not a multiple of 4, or
//   U off 16 bytes, reads U one float at a time.
// * bf16 W (subcge_apply_bf16: the JAX pod's default parameters), as the
//   Pallas kernel takes it: the delta is formed in float32 from float32 U,
//   A and V exactly as above, added to f32(W), and the sum stored as bf16
//   rounded to nearest even, once.  The same kernel with T = bf16: a
//   thread's 4 columns are 8 bytes, copied by 8-byte cp.async into its ring
//   slots; W moves 2 + 2 bytes an element, so the bound halves.  m not a
//   multiple of 4, or W off 8 bytes (InternVL's untied 92,553-column
//   logits), reads the thread's 16 elements with plain loads just before
//   the store instead of through the ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

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

__device__ __forceinline__ void cp8(unsigned dst, const void* src,
                                    int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
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
// stage[i * NT + tid]; elements past (n, m) are zero-filled.  bf16 fills
// the first 8 bytes of a slot; bf16 without VEC copies nothing (the store
// reads W itself).
template <typename T, bool VEC>
__device__ __forceinline__ void load_tile(float4* stage, const T* Wb,
                                          int rbase, int LR, int n, int m,
                                          int col) {
  constexpr bool F32 = std::is_same<T, float>::value;
  if (!F32 && !VEC) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = rbase + i * LR;
    const unsigned dst = smem(stage + i * NT + threadIdx.x);
    const T* src = Wb + (long long)row * m + col;
    if (!F32) {
      const bool in = row < n && col < m;
      cp8(dst, in ? src : Wb, in ? 8 : 0);
    } else if (VEC) {
      const bool in = row < n && col < m;
      cp16(dst, in ? reinterpret_cast<const float*>(src)
                   : reinterpret_cast<const float*>(Wb),
           in ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = row < n && col + j < m;
        cp4(dst + 4 * j,
            reinterpret_cast<const float*>(in ? src + j : Wb), in ? 4 : 0);
      }
    }
  }
}

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ unsigned bf16x2_rn(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

// Tile g of the launch is row tile g % tiles of column chunk
// (g / tiles) % chunks of instance g / (tiles * chunks); block k takes
// tiles [k * per, min((k + 1) * per, nb * chunks * tiles)) in order.
template <typename T, bool VEC>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
subcge_stream_kernel(const T* W, T* out,   // may alias: no restrict
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
    load_tile<T, VEC>(ring, W + bq / chunks * sw,
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
      load_tile<T, VEC>(ring + ((g + 1 - g0) % STAGES) * RPT * NT,
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
    T* Ob = out + b * so;

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
    if constexpr (std::is_same<T, float>::value) {
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
    } else {
      // bf16: f32(W) + delta, rounded to nearest even once
      float w[RPT][4];
      const T* Wb = W + b * sw;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = rbase + i * LR;
        const long long off = (long long)min(row, n - 1) * m + col;
        if (VEC) {
          const uint2 q = *reinterpret_cast<const uint2*>(cur + i * NT +
                                                          threadIdx.x);
          w[i][0] = bf16_lo(q.x), w[i][1] = bf16_hi(q.x);
          w[i][2] = bf16_lo(q.y), w[i][3] = bf16_hi(q.y);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            w[i][j] = col + j < m ? __bfloat162float(Wb[off + j]) : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = rbase + i * LR;
        if (row >= n) continue;
        const long long off = (long long)row * m + col;
        const float o[4] = {w[i][0] + acc[i][0], w[i][1] + acc[i][1],
                            w[i][2] + acc[i][2], w[i][3] + acc[i][3]};
        if (VEC) {
          if (col < m)
            __stcs(reinterpret_cast<uint2*>(Ob + off),
                   make_uint2(bf16x2_rn(o[0], o[1]), bf16x2_rn(o[2], o[3])));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (col + j < m) Ob[off + j] = __float2bfloat16_rn(o[j]);
        }
      }
    }
  }
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<std::uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename T>
int launch(const void* W, void* out, const void* U, const void* A,
           const void* V, int E, int nb, int n, int m, int r, int lbc,
           int chunks, int per, int blocks, int G, int smem, long long sw,
           long long so, void* stream) {
  if (r < 1 || r > RMAX || E < 1 || G < 1 || lbc < 2 || lbc > 7 ||
      chunks < 1 || per < 1 || blocks < 1 || nb < 1 || n < 1 ||
      chunks != (m + (1 << lbc) - 1) >> lbc)
    return static_cast<int>(cudaErrorInvalidValue);
  // a thread's 4 columns as one 16-byte (float) or 8-byte (bf16) piece
  constexpr int piece = 4 * sizeof(T);
  const bool vec = m % 4 == 0 && (sw | so) % 4 == 0 && aligned(W, piece) &&
                   aligned(out, piece);
  auto kernel = vec ? subcge_stream_kernel<T, true>
                    : subcge_stream_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(W), static_cast<T*>(out),
      static_cast<const float*>(U), static_cast<const float*>(A),
      static_cast<const float*>(V), E, G, nb, n, m, r, lbc, chunks, per,
      r % 4 == 0 && aligned(U, 16), sw, so);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[b] = W[b] + sum_e U[e] A[e, b] V[e]^T.  U (E, n, r), A (E, nb, r, r)
// and V (E, m, r) contiguous float32; W[b] and out[b] contiguous (n, m)
// matrices at batch strides sw / so; out may alias W.  The geometry comes
// from subcge_apply.update_plan: chunk width 1 << lbc, `chunks` chunks per
// instance, `per` tiles a block over `blocks` blocks, AV of `G` epochs,
// `smem` bytes of shared memory.  Returns the launch's CUDA error (r > 32
// and malformed plans are refused with cudaErrorInvalidValue).
extern "C" int subcge_apply_f32(const void* W, void* out, const void* U,
                                const void* A, const void* V, int E, int nb,
                                int n, int m, int r, int lbc, int chunks,
                                int per, int blocks, int G, int smem,
                                long long sw, long long so, void* stream) {
  return launch<float>(W, out, U, A, V, E, nb, n, m, r, lbc, chunks, per,
                       blocks, G, smem, sw, so, stream);
}

// The same with W and out bf16 (U, A and V stay float32): f32(W) + delta,
// stored rounded to nearest even.
extern "C" int subcge_apply_bf16(const void* W, void* out, const void* U,
                                 const void* A, const void* V, int E, int nb,
                                 int n, int m, int r, int lbc, int chunks,
                                 int per, int blocks, int G, int smem,
                                 long long sw, long long so, void* stream) {
  return launch<__nv_bfloat16>(W, out, U, A, V, E, nb, n, m, r, lbc, chunks,
                               per, blocks, G, smem, sw, so, stream);
}
