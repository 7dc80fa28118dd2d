// Fused rank-1-perturbed matmuls for Hopper (sm_90a), float32 CUDA cores.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/rank1_matmul.py:
// rank1_matmul (y = x W + s (x u) v^T, W stored (K, N)), rank1_matmul_t
// (y = x W^T + s (x v) u^T, W stored output-major (O, K) and never
// transposed in memory), both batched over a leading client axis, and
// rank1_matmul_expert (y[c,e] = x[c,e] W[c,e] + s[c] (x[c,e] u[c,e])
// v[c,e]^T), batched over clients and experts: every client has its own W,
// u, v and s, and every expert its own W, u and v.
//
// Bound on this card: at the main paths' shapes (M = 264 rows per client,
// or 83 capacity rows per expert; K, N from 1024 to 8192, O = 151936 or
// N = 20480 for a head) the work is 2 M K N flops against
// 4 (K N + M K + M N) bytes, 40 to 130 flops per byte, so a float32 product
// is bounded by the CUDA-core rate (67 TFLOP/s), not by HBM.  TF32 tensor
// cores are deliberately not used: they keep ~3 decimal digits, and the ZO
// coefficient (L+ - L-) / 2 eps amplifies that error.
//
// Design: one shared-memory SGEMM tile (64 rows x 128 columns per block,
// k-slab of 16, 256 threads each owning a 4 x 8 register tile) as a device
// function, with the rank-1 term riding the same k loop: the first 64
// threads keep the row dot product x . cvec from the x slab already in
// shared memory, so W is streamed exactly once and the perturbation costs
// M K extra FMAs.  The epilogue adds s * (x . cvec)[row] * ovec[col].  The
// transposed variant loads W rows along the contraction axis (coalesced)
// and stores them transposed into shared memory.  Ragged edges (M = 264 or
// 83, any N) are masked.  The Pallas expert kernel carries its accumulators
// across a sequential k grid axis; here the k loop lives inside the block,
// and the (client, expert) pair is the grid's z axis, each entry point
// computing its operands' offsets from its own batch strides (W is a view
// of the stacked (clients, layers, experts, K, N) parameters at one layer).
// wgmma/TMA pipelines are later work.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 8;
constexpr int NT = 256;   // (BM / TM) * (BN / TN)

// One 64 x 128 output tile at (row0, col0) of y = x W + sb (x . cvec) ovec^T
// (W^T when TRANS); every pointer already offset to its batch entry.
template <bool TRANS>
__device__ __forceinline__ void rank1_tile(
    const float* __restrict__ x, const float* __restrict__ W,
    const float* __restrict__ cvec, const float* __restrict__ ovec,
    const float sb, float* __restrict__ y, const int M, const int N,
    const int K, const int row0, const int col0) {
  __shared__ __align__(16) float As[BK][BM + 4];   // x slab, transposed
  __shared__ __align__(16) float Bs[BK][BN + 4];   // W slab, [k][col]
  __shared__ float Cs[BK];                         // cvec slab
  __shared__ float XC[BM];                         // x . cvec per row

  const int tid = threadIdx.x;
  const int tr = tid / (BN / TN);   // 0..15
  const int tc = tid % (BN / TN);   // 0..15

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float xc = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int m = i / BK, k = i % BK;
      const int gm = row0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? x[(long long)gm * K + gk] : 0.f;
    }
    if (TRANS) {
      // W (N, K): consecutive threads walk the contraction axis of one row
      for (int i = tid; i < BK * BN; i += NT) {
        const int n = i / BK, k = i % BK;
        const int gn = col0 + n, gk = k0 + k;
        Bs[k][n] = (gn < N && gk < K) ? W[(long long)gn * K + gk] : 0.f;
      }
    } else {
      // W (K, N): consecutive threads walk the output axis of one row
      for (int i = tid; i < BK * BN; i += NT) {
        const int k = i / BN, n = i % BN;
        const int gk = k0 + k, gn = col0 + n;
        Bs[k][n] = (gk < K && gn < N) ? W[(long long)gk * N + gn] : 0.f;
      }
    }
    if (tid < BK) Cs[tid] = (k0 + tid < K) ? cvec[k0 + tid] : 0.f;
    __syncthreads();

    if (tid < BM) {
#pragma unroll
      for (int k = 0; k < BK; ++k) xc = fmaf(As[k][tid], Cs[k], xc);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[k][tr * TM]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tc * TN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][tc * TN + 4]);
      const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
      const float bb[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (tid < BM) XC[tid] = xc;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + tr * TM + i;
    if (gm >= M) continue;
    const float sx_row = sb * XC[tr * TM + i];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + tc * TN + j;
      if (gn < N) y[(long long)gm * N + gn] = acc[i][j] + sx_row * ovec[gn];
    }
  }
}

template <bool TRANS>
__global__ void __launch_bounds__(NT)
rank1_matmul_kernel(const float* __restrict__ x, const float* __restrict__ W,
                    const float* __restrict__ cvec,
                    const float* __restrict__ ovec,
                    const float* __restrict__ s, float* __restrict__ y,
                    int M, int N, int K, long long sx, long long sw,
                    long long sc, long long so, long long sy) {
  const long long b = blockIdx.z;
  rank1_tile<TRANS>(x + b * sx, W + b * sw, cvec + b * sc, ovec + b * so,
                    s[b], y + b * sy, M, N, K, blockIdx.y * BM,
                    blockIdx.x * BN);
}

// blockIdx.z = c * E + e; each operand has a client and an expert stride.
__global__ void __launch_bounds__(NT)
rank1_matmul_expert_kernel(const float* __restrict__ x,
                           const float* __restrict__ W,
                           const float* __restrict__ u,
                           const float* __restrict__ v,
                           const float* __restrict__ s, float* __restrict__ y,
                           int E, int M, int N, int K, long long sx_c,
                           long long sx_e, long long sw_c, long long sw_e,
                           long long su_c, long long su_e, long long sv_c,
                           long long sv_e, long long sy_c, long long sy_e) {
  const long long c = blockIdx.z / E;
  const long long e = blockIdx.z % E;
  rank1_tile<false>(x + c * sx_c + e * sx_e, W + c * sw_c + e * sw_e,
                    u + c * su_c + e * su_e, v + c * sv_c + e * sv_e, s[c],
                    y + c * sy_c + e * sy_e, M, N, K, blockIdx.y * BM,
                    blockIdx.x * BN);
}

}  // namespace

// y[b] = x[b] W[b] (+ s[b] (x[b] . cvec[b]) ovec[b]^T); W[b] is (K, N), or
// (N, K) when trans != 0.  All operands float32 with contiguous inner
// dimensions; s[b] is read at s + b.  Returns cudaGetLastError().
extern "C" int rank1_matmul_f32(const void* x, const void* W, const void* cvec,
                                const void* ovec, const void* s, void* y,
                                int nb, int M, int N, int K, long long sx,
                                long long sw, long long sc, long long so,
                                long long sy, int trans, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, nb);
  dim3 block(NT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(W);
  const float* cf = static_cast<const float*>(cvec);
  const float* of = static_cast<const float*>(ovec);
  const float* sf = static_cast<const float*>(s);
  float* yf = static_cast<float*>(y);
  if (trans) {
    rank1_matmul_kernel<true><<<grid, block, 0, st>>>(
        xf, wf, cf, of, sf, yf, M, N, K, sx, sw, sc, so, sy);
  } else {
    rank1_matmul_kernel<false><<<grid, block, 0, st>>>(
        xf, wf, cf, of, sf, yf, M, N, K, sx, sw, sc, so, sy);
  }
  return static_cast<int>(cudaGetLastError());
}

// y[c, e] = x[c, e] W[c, e] + s[c] (x[c, e] . u[c, e]) v[c, e]^T for C
// clients and E experts; x[c, e] (M, K), W[c, e] (K, N), u[c, e] (K),
// v[c, e] (N), y[c, e] (M, N), each float32 with contiguous rows, placed at
// c * stride_c + e * stride_e.  Returns cudaGetLastError().
extern "C" int rank1_matmul_expert_f32(
    const void* x, const void* W, const void* u, const void* v, const void* s,
    void* y, int C, int E, int M, int N, int K, long long sx_c,
    long long sx_e, long long sw_c, long long sw_e, long long su_c,
    long long su_e, long long sv_c, long long sv_e, long long sy_c,
    long long sy_e, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, C * E);
  dim3 block(NT);
  rank1_matmul_expert_kernel<<<grid, block, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(W),
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<const float*>(s), static_cast<float*>(y), E, M, N, K, sx_c,
      sx_e, sw_c, sw_e, su_c, su_e, sv_c, sv_e, sy_c, sy_e);
  return static_cast<int>(cudaGetLastError());
}
