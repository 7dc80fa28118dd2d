// Fused SubCGE weight update for Hopper (sm_90a):
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
// at exactly one read and one write of W (3.35 TB/s).
//
// Design: one block per (32-row x 128-column) tile of one instance.  For
// each epoch it stages A[e, b] (r x r), the tile's U rows and V rows in
// shared memory, forms UA = U_rows A once per tile (32 x r), and
// accumulates delta = UA V_rows^T in registers (4 x 4 per thread, f32).
// Only after the last epoch is W touched: one coalesced read, one f32 add,
// one write.  Epochs loop inside the tile instead of building the
// block-diagonal A, so W is still streamed once for any E.  The update may
// run in place (out == W): each element is read and written by the same
// thread.  r <= 32 (28 KB of static shared memory).

#include <cuda_runtime.h>

namespace {

constexpr int TR = 32;    // rows per tile
constexpr int TC = 128;   // columns per tile
constexpr int NT = 256;
constexpr int RMAX = 32;

__global__ void __launch_bounds__(NT)
subcge_apply_kernel(const float* W, float* out,   // may alias: no restrict
                    const float* __restrict__ U, const float* __restrict__ A,
                    const float* __restrict__ V, int E, int nb, int n, int m,
                    int r, long long sw, long long so) {
  const long long b = blockIdx.z;
  const int row0 = blockIdx.y * TR;
  const int col0 = blockIdx.x * TC;

  __shared__ float As[RMAX * RMAX];
  __shared__ float Us[TR * RMAX];
  __shared__ float UA[TR * RMAX];
  __shared__ float Vs[RMAX * TC];   // transposed: Vs[s * TC + col]

  const int tid = threadIdx.x;
  const int ty = tid / 32;   // 0..7  -> rows ty*4 .. ty*4+3
  const int tx = tid % 32;   // 0..31 -> cols tx + 32*jj

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int e = 0; e < E; ++e) {
    const float* Ae = A + ((long long)e * nb + b) * r * r;
    const float* Ue = U + (long long)e * n * r;
    const float* Ve = V + (long long)e * m * r;
    for (int i = tid; i < r * r; i += NT) As[i] = Ae[i];
    for (int i = tid; i < TR * r; i += NT) {
      const int row = i / r, q = i % r;
      const int g = row0 + row;
      Us[i] = (g < n) ? Ue[(long long)g * r + q] : 0.f;
    }
    for (int i = tid; i < TC * r; i += NT) {
      const int col = i / r, q = i % r;
      const int g = col0 + col;
      Vs[q * TC + col] = (g < m) ? Ve[(long long)g * r + q] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < TR * r; i += NT) {
      const int row = i / r, q = i % r;
      float t = 0.f;
      for (int p = 0; p < r; ++p) t = fmaf(Us[row * r + p], As[p * r + q], t);
      UA[i] = t;
    }
    __syncthreads();
    for (int q = 0; q < r; ++q) {
      float ua[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ua[i] = UA[(ty * 4 + i) * r + q];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[q * TC + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ua[i], vv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float* Wb = W + b * sw;
  float* Ob = out + b * so;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int g = row0 + ty * 4 + i;
    if (g >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 32 * j;
      if (c < m) {
        const long long off = (long long)g * m + c;
        Ob[off] = Wb[off] + acc[i][j];
      }
    }
  }
}

}  // namespace

// out[b] = W[b] + sum_e U[e] A[e, b] V[e]^T.  U (E, n, r), A (E, nb, r, r)
// and V (E, m, r) contiguous float32; W[b] and out[b] contiguous (n, m)
// matrices at batch strides sw / so; out may alias W.  Returns
// cudaGetLastError() (r > 32 is refused with cudaErrorInvalidValue).
extern "C" int subcge_apply_f32(const void* W, void* out, const void* U,
                                const void* A, const void* V, int E, int nb,
                                int n, int m, int r, long long sw,
                                long long so, void* stream) {
  if (r < 1 || r > RMAX || E < 1) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((m + TC - 1) / TC, (n + TR - 1) / TR, nb);
  subcge_apply_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<float*>(out),
      static_cast<const float*>(U), static_cast<const float*>(A),
      static_cast<const float*>(V), E, nb, n, m, r, sw, so);
  return static_cast<int>(cudaGetLastError());
}
