// K1: the fused local Poisson operator  w = D^T ( G ( D u ) ), per element.
//
// Replaces the TPU kernel src/repro/kernels/nekbone_ax.py:nekbone_ax_kernel
// (pallas_call at :281), which kept a block of elements resident in VMEM and
// folded the element and layer axes into skinny matmuls.  On Hopper the
// kernel goes back to the paper's own design (DESIGN.md §1, the "2-D thread
// structure"): one thread block per element, an n x n layer of threads
// (thread (i, j) owns the node column (:, j, i)) marching through the k
// layers.  D and D^T sit in shared memory; each thread holds its column of
// u and its column of w in registers.  Per layer k:
//   1. the layer u[k, :, :] goes to shared memory;
//   2. wr, ws from the layer, wt from the thread's own u column;
//   3. the six metric entries of the node are read and applied;
//   4. ur, us go to shared memory; their transposed contractions finish
//      w[k, j, i], and ut is scattered into the whole w column (registers).
//
// Bound on this card: 7 reads and 1 write of a field per launch — u, the
// six metric entries, w — about 65.5 MB at E=1024, n=10 in fp64
// (8 x 8.19 MB); 12n+17 flops per node, 0.14 GFLOP, so the kernel is bound
// by device-memory bytes (about 20 us at the data sheet's 3.35 TB/s).  The
// design reads each input once and writes w once: u's column is loaded
// once into registers, the metric is read once per node, and nothing else
// leaves the SM.  It is a first, simple version: no TMA, no prefetch of the
// next layer's metric, one element per block.
//
// n is a template parameter (2..16, dispatched at run time); T is float or
// double, and the kernel accumulates in T (the reference's _accum rule for
// f32 and f64 storage).  bf16 is not built.
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

template <int N, typename T>
__global__ void __launch_bounds__(N * N)
nekbone_ax_kernel(const T* __restrict__ u, const T* __restrict__ D,
                  const T* __restrict__ g, T* __restrict__ w) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  __shared__ T sD[N][N];   // sD[a][b]  = D[a, b]
  __shared__ T sDt[N][N];  // sDt[a][b] = D[b, a]
  __shared__ T su[N][N];   // layer k of u
  __shared__ T sr[N][N];   // layer k of ur
  __shared__ T ss[N][N];   // layer k of us

  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const size_t e = blockIdx.x;
  const T* ue = u + e * N3 + j * N + i;
  const T* ge = g + e * 6 * N3 + j * N + i;
  T* we = w + e * N3 + j * N + i;

  sD[j][i] = D[j * N + i];
  sDt[i][j] = D[j * N + i];
  T uc[N];
  T wc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    uc[k] = ue[k * N2];
    wc[k] = T(0);
  }

#pragma unroll
  for (int k = 0; k < N; ++k) {
    su[j][i] = uc[k];
    __syncthreads();
    T wr = T(0), ws = T(0), wt = T(0);
#pragma unroll
    for (int l = 0; l < N; ++l) {
      wr += sDt[l][i] * su[j][l];
      ws += sD[j][l] * su[l][i];
      wt += sD[k][l] * uc[l];
    }
    const T* gk = ge + k * N2;
    const T grr = gk[0 * N3], grs = gk[1 * N3], grt = gk[2 * N3];
    const T gss = gk[3 * N3], gst = gk[4 * N3], gtt = gk[5 * N3];
    const T ur = grr * wr + grs * ws + grt * wt;
    const T us = grs * wr + gss * ws + gst * wt;
    const T ut = grt * wr + gst * ws + gtt * wt;
    sr[j][i] = ur;
    ss[j][i] = us;
    __syncthreads();
    T acc = T(0);
#pragma unroll
    for (int l = 0; l < N; ++l) {
      acc += sD[l][i] * sr[j][l];
      acc += sD[l][j] * ss[l][i];
    }
    wc[k] += acc;
#pragma unroll
    for (int m = 0; m < N; ++m) wc[m] += sD[k][m] * ut;
    // The next layer writes su before its first barrier and sr/ss only
    // after it; every read of this layer's su happened before the second
    // barrier above, and of sr/ss before any thread reaches the next first
    // barrier, so no third barrier is needed.
  }

#pragma unroll
  for (int k = 0; k < N; ++k) we[k * N2] = wc[k];
}

template <int N, typename T>
cudaError_t launch(const T* u, const T* D, const T* g, T* w, int E,
                   cudaStream_t stream) {
  nekbone_ax_kernel<N, T><<<E, dim3(N, N), 0, stream>>>(u, D, g, w);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const T* u, const T* D, const T* g, T* w, int E, int n,
             void* stream) {
  if (E <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N) \
  case N:               \
    return static_cast<int>(launch<N, T>(u, D, g, w, E, s));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// u, w: (E, n^3); D: (n, n); g: (E, 6, n^3); all contiguous, on `stream`.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int nekbone_ax_f64(const double* u, const double* D,
                              const double* g, double* w, int E, int n,
                              void* stream) {
  return nekbone::dispatch<double>(u, D, g, w, E, n, stream);
}

extern "C" int nekbone_ax_f32(const float* u, const float* D, const float* g,
                              float* w, int E, int n, void* stream) {
  return nekbone::dispatch<float>(u, D, g, w, E, n, stream);
}
