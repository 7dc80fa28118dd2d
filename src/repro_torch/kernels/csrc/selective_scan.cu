// Mamba-1 selective scan for Hopper (sm_90a):
//   h_t = a_t * h_{t-1} + bx_t,   y_t[d] = sum_n h_t[d, n] * c_t[n]
// with a, bx (B, T, D, N), c (B, T, N), h0 (B, D, N) -> y (B, T, D) and
// h_last = h_T (B, D, N), all float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/selective_scan.py
// selective_scan, which keeps a (bd, N) panel of h in VMEM across a
// sequential grid axis over T.  Blocks on the card run in no order, so the
// sequential axis becomes a loop inside each thread instead.
//
// Bound on this card: every element of a and bx is read once and costs
// ~4 flops against 8 bytes, far below the float32 ridge (~20 flops per
// byte): the scan is HBM-bound at one read of a, bx, c, h0 and one write of
// y, h_last (3.35 TB/s).
//
// Design: one thread owns one state element h[b, d, n] in a register and
// walks t = 0..T-1 in its own loop.  A warp covers 32/N channels x N
// states, so its loads of a[b, t, d:d+32/N, :] (and of bx) are 128
// contiguous bytes; c[b, t, :] is broadcast through the read-only cache.
// Loads run UNROLL time steps ahead of the recurrence (they do not depend
// on h), so each thread keeps 2*UNROLL loads in flight.  The readout sum
// over n is a __shfl_xor_sync tree over the N lanes of a channel, and lane
// n = 0 stores y[b, t, d].  Grid (ceil(D*N / 256), B).  No atomics and no
// shared memory: the result is deterministic.  N must be a power of two
// that divides 32 (1..32); any other N is refused, never approximated.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int UNROLL = 8;

template <int N>
__global__ void __launch_bounds__(NT)
selective_scan_kernel(const float* __restrict__ a,
                      const float* __restrict__ bx,
                      const float* __restrict__ c,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_last, int T, int D) {
  const long long DN = (long long)D * N;
  const long long idx = (long long)blockIdx.x * NT + threadIdx.x;
  const long long b = blockIdx.y;
  // D*N and NT are multiples of N, so a channel's N lanes are all in range
  // or all out of it, and every lane of a warp reaches each shuffle
  const bool valid = idx < DN;
  const int n = threadIdx.x % N;
  const long long d = idx / N;

  const float* ap = a + b * T * DN + idx;
  const float* bp = bx + b * T * DN + idx;
  const float* cp = c + b * T * N + n;
  float* yp = y + b * T * D + d;
  float h = valid ? h0[b * DN + idx] : 0.f;

  for (int t0 = 0; t0 < T; t0 += UNROLL) {
    float ra[UNROLL], rb[UNROLL], rc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u;
      const bool live = valid && t < T;
      ra[u] = live ? __ldg(ap + (long long)t * DN) : 0.f;
      rb[u] = live ? __ldg(bp + (long long)t * DN) : 0.f;
      rc[u] = t < T ? __ldg(cp + (long long)t * N) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u;
      if (t >= T) break;                    // uniform across the warp
      h = fmaf(ra[u], h, rb[u]);
      float p = h * rc[u];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (valid && n == 0) yp[(long long)t * D] = p;
    }
  }
  if (valid) h_last[b * DN + idx] = h;
}

template <int N>
int launch(const float* a, const float* bx, const float* c, const float* h0,
           float* y, float* h_last, int B, int T, int D,
           cudaStream_t stream) {
  const long long DN = (long long)D * N;
  dim3 grid((unsigned)((DN + NT - 1) / NT), (unsigned)B);
  selective_scan_kernel<N><<<grid, NT, 0, stream>>>(a, bx, c, h0, y, h_last,
                                                    T, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (B, T, D) and h_last (B, D, N) from a, bx (B, T, D, N), c (B, T, N) and
// h0 (B, D, N), all contiguous float32.  Returns cudaGetLastError(); an N
// that is not a power of two <= 32, or an empty or too large grid, is
// refused with cudaErrorInvalidValue.
extern "C" int selective_scan_f32(const void* a, const void* bx,
                                  const void* c, const void* h0, void* y,
                                  void* h_last, int B, int T, int D, int N,
                                  void* stream) {
  if (B < 1 || B > 65535 || T < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* pa = static_cast<const float*>(a);
  const auto* pb = static_cast<const float*>(bx);
  const auto* pc = static_cast<const float*>(c);
  const auto* ph = static_cast<const float*>(h0);
  auto* py = static_cast<float*>(y);
  auto* pl = static_cast<float*>(h_last);
  auto s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 1: return launch<1>(pa, pb, pc, ph, py, pl, B, T, D, s);
    case 2: return launch<2>(pa, pb, pc, ph, py, pl, B, T, D, s);
    case 4: return launch<4>(pa, pb, pc, ph, py, pl, B, T, D, s);
    case 8: return launch<8>(pa, pb, pc, ph, py, pl, B, T, D, s);
    case 16: return launch<16>(pa, pb, pc, ph, py, pl, B, T, D, s);
    case 32: return launch<32>(pa, pb, pc, ph, py, pl, B, T, D, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
