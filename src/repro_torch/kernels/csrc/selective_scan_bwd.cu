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
// flops against tens of bytes.  The least traffic is one read of a, bx, dy,
// c, h0, dh_last and one write of da, dbx, dh0 and dc.
//
// Design: one thread owns one state element h[b, d, n], as in the forward.
//   Pass 1 (forward recompute) walks t = 0..T-1, keeps h in a register and
//   stores h_{t-1} into da[t]: the output buffer is the scratch, so no
//   (B, T, D, N) temporary is allocated.  a_t is never inverted (exp(dt A)
//   underflows to 0).  The same pass forms dy_t[d] h_t[d, n] and reduces it
//   over the block's channels: a __shfl_xor_sync tree over the channels of
//   a warp, then the warps summed in a fixed order through shared memory,
//   one partial per (b, t, block, n).  dc sums D = 8192 products whose
//   partial sums reach ~100 x the result; in float32 that sum was 4x
//   further from a float64 oracle than PyTorch's own reduction, so the
//   products and every partial sum are taken in float64 (a few double
//   operations per element, and 8-byte partials) and dc is rounded once.
//   Pass 2 (reverse) walks t = T-1..0, reads h_{t-1} back from da[t] and
//   overwrites it with g_t h_{t-1}, writes dbx_t = g_t, and carries
//   a_t g_t; the last carry is dh0.  Loads run UNROLL steps ahead in both
//   passes, as in the forward.
//   A second kernel sums each (b, t, n)'s block partials in ascending block
//   order, in float64.  No atomics: two calls give the same bits.
// N must be a power of two that divides 32 (1..32), as in the forward.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int UNROLL = 8;

template <int N>
__global__ void __launch_bounds__(NT)
scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ bx,
                const float* __restrict__ c, const float* __restrict__ h0,
                const float* __restrict__ dy,
                const float* __restrict__ dh_last, float* __restrict__ da,
                float* __restrict__ dbx, float* __restrict__ dh0,
                double* __restrict__ part, int T, int D) {
  __shared__ double red[NW][UNROLL][N];
  const long long DN = (long long)D * N;
  const long long idx = (long long)blockIdx.x * NT + threadIdx.x;
  const long long b = blockIdx.y;
  const int nblk = gridDim.x;
  // D*N and NT are multiples of N: a channel's N lanes are all in range or
  // all out of it, and every thread reaches each shuffle and barrier
  const bool valid = idx < DN;
  const int n = threadIdx.x % N;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const long long d = valid ? idx / N : 0;

  const float* ap = a + b * T * DN + idx;
  const float* bp = bx + b * T * DN + idx;
  const float* cp = c + b * T * N + n;
  const float* yp = dy + b * T * D + d;
  float* dap = da + b * T * DN + idx;
  float* dbp = dbx + b * T * DN + idx;

  // pass 1: recompute h, park h_{t-1} in da[t], reduce dy_t h_t over d
  float h = valid ? h0[b * DN + idx] : 0.f;
  for (int t0 = 0; t0 < T; t0 += UNROLL) {
    float ra[UNROLL], rb[UNROLL], rc[UNROLL], ry[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u;
      const bool live = valid && t < T;
      ra[u] = live ? __ldg(ap + (long long)t * DN) : 0.f;
      rb[u] = live ? __ldg(bp + (long long)t * DN) : 0.f;
      ry[u] = live ? __ldg(yp + (long long)t * D) : 0.f;
      rc[u] = t < T ? __ldg(cp + (long long)t * N) : 0.f;
    }
    double p[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u;
      if (valid && t < T) dap[(long long)t * DN] = h;
      h = fmaf(ra[u], h, rb[u]);
      p[u] = (double)ry[u] * (double)h;     // 0 past T and off the range
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int off = N; off < 32; off <<= 1)
        p[u] += __shfl_xor_sync(0xffffffffu, p[u], off);
      if (lane < N) red[warp][u][lane] = p[u];
    }
    __syncthreads();
    if (threadIdx.x < UNROLL * N) {
      const int u = threadIdx.x / N, m = threadIdx.x % N;
      const int t = t0 + u;
      double s = 0.0;
#pragma unroll
      for (int w = 0; w < NW; ++w) s += red[w][u][m];
      if (t < T) part[((b * T + t) * nblk + blockIdx.x) * N + m] = s;
    }
    __syncthreads();                        // red is reused next chunk
  }
  if (!valid) return;                       // no barrier below

  // pass 2: the reverse scan
  float carry = dh_last[b * DN + idx];
  for (int t0 = T - 1; t0 >= 0; t0 -= UNROLL) {
    float ra[UNROLL], rh[UNROLL], rc[UNROLL], ry[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 - u;
      const bool live = t >= 0;
      ra[u] = live ? __ldg(ap + (long long)t * DN) : 0.f;
      rh[u] = live ? dap[(long long)t * DN] : 0.f;   // written above
      ry[u] = live ? __ldg(yp + (long long)t * D) : 0.f;
      rc[u] = live ? __ldg(cp + (long long)t * N) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 - u;
      if (t < 0) break;
      const float g = fmaf(ry[u], rc[u], carry);
      dbp[(long long)t * DN] = g;
      dap[(long long)t * DN] = g * rh[u];
      carry = ra[u] * g;
    }
  }
  dh0[b * DN + idx] = carry;
}

// dc[b, t, n] = sum over blocks k = 0..nblk-1 of part[b, t, k, n], in that
// order, in float64, rounded once to float32; one thread per (b, t, n).
__global__ void __launch_bounds__(NT)
dc_sum_kernel(const double* __restrict__ part, float* __restrict__ dc,
              long long BT, int nblk, int N) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= BT * N) return;
  const long long bt = i / N;
  const int n = (int)(i % N);
  const double* p = part + bt * nblk * N + n;
  double s = 0.0;
  for (int k = 0; k < nblk; ++k) s += p[(long long)k * N];
  dc[i] = (float)s;
}

template <int N>
int launch(const float* a, const float* bx, const float* c, const float* h0,
           const float* dy, const float* dh_last, float* da, float* dbx,
           float* dc, float* dh0, double* part, int B, int T, int D,
           cudaStream_t stream) {
  const long long DN = (long long)D * N;
  dim3 grid((unsigned)((DN + NT - 1) / NT), (unsigned)B);
  scan_bwd_kernel<N><<<grid, NT, 0, stream>>>(a, bx, c, h0, dy, dh_last, da,
                                              dbx, dh0, part, T, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long BT = (long long)B * T;
  const long long blocks = (BT * N + NT - 1) / NT;
  dc_sum_kernel<<<(unsigned)blocks, NT, 0, stream>>>(part, dc, BT,
                                                     (int)grid.x, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Number of blocks along D*N of the main kernel: the partial buffer ``part``
// holds B * T * blocks * N doubles.
extern "C" int selective_scan_bwd_blocks(int D, int N) {
  return (int)(((long long)D * N + NT - 1) / NT);
}

// da, dbx (B, T, D, N), dc (B, T, N) and dh0 (B, D, N) from a, bx, c, h0
// (the forward's inputs), dy (B, T, D) and dh_last (B, D, N), all contiguous
// float32; ``part`` is float64 scratch of B * T *
// selective_scan_bwd_blocks(D, N) * N values.  Launches both kernels; returns cudaGetLastError().  An N that
// is not a power of two <= 32, or an empty or too large grid, is refused
// with cudaErrorInvalidValue.
extern "C" int selective_scan_bwd_f32(const void* a, const void* bx,
                                      const void* c, const void* h0,
                                      const void* dy, const void* dh_last,
                                      void* da, void* dbx, void* dc,
                                      void* dh0, void* part, int B, int T,
                                      int D, int N, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || D < 1)
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
  auto s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 1: return launch<1>(pa, pb, pc, ph, py, pl, oa, ob, oc, oh, pp, B, T, D, s);
    case 2: return launch<2>(pa, pb, pc, ph, py, pl, oa, ob, oc, oh, pp, B, T, D, s);
    case 4: return launch<4>(pa, pb, pc, ph, py, pl, oa, ob, oc, oh, pp, B, T, D, s);
    case 8: return launch<8>(pa, pb, pc, ph, py, pl, oa, ob, oc, oh, pp, B, T, D, s);
    case 16: return launch<16>(pa, pb, pc, ph, py, pl, oa, ob, oc, oh, pp, B, T, D, s);
    case 32: return launch<32>(pa, pb, pc, ph, py, pl, oa, ob, oc, oh, pp, B, T, D, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
