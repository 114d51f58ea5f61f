// K4: the front half of one v2 CG iteration, per element.
//
//     p   = r + beta * p_prev          (stored: the direction CG applies)
//     w   = mask * (D^T G D p)         (diagonal metric, mask from factors)
//     pap = sum(p * w)                 (per-element partial, before assembly)
//
// Replaces the TPU kernel
// src/repro/kernels/nekbone_ax.py:nekbone_ax_slab_kernel (pallas_call at
// :592).  The TPU kernel kept whole z-slabs resident in VMEM and also did
// the x/y and in-slab z direct-stiffness sums there, sending the slab's two
// boundary z-planes to the update kernel.  One slab of the paper case is
// 64 elements x 8 KB (fp64) = 512 KB, more than the 227 KB of shared memory
// a block may use, so here the work splits differently:
//
// * this kernel is per element (one thread block, an n x n thread layer
//   marching the k layers as in nekbone_ax.cu; the layer loop is
//   common.cuh's ax_diag_columns, shared with the Chebyshev kernel) and
//   writes the *unassembled* masked w;
// * the update kernel (nekbone_cg_update.cu) assembles w node by node,
//   reading the neighbours' face copies straight from device memory in
//   core/gs.ds_sum_local's order.
//
// The pap partial is taken before assembly, which is what the continuity
// identity (DESIGN.md §3.2) needs: for a continuous p,
// sum_e sum(p * mask * w_local) == p . c . (mask gs w_local).  The Dirichlet
// mask is rebuilt per node from the three per-axis factors mx, my, mz
// (core/geom.box_axis_factors), so it costs no field stream.
//
// Streams (the 13-stream book of core/cost.py, kept): this kernel reads p,
// r and the three metric diagonals (5) and writes p and w (2); the update
// kernel reads x, p, r, w (4) and writes x and r (2): 9 reads + 4 writes.
// At E=1024, n=10, fp64 this kernel moves 7 x 8.19 MB = 57.3 MB per launch;
// about 12n+10 flops per node, so it is bound by device-memory bytes (about
// 17 us at the data sheet's 3.35 TB/s).  pap leaves as one value per element
// (E values), summed outside by torch.sum.
//
// beta is read from a device pointer, so the CG loop never waits for the
// card.  p = r + beta * p_prev is computed with rounded, uncontracted
// multiply and add, so the stored p is bitwise the plain version's.
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

template <int N, typename T>
__global__ void __launch_bounds__(N * N)
nekbone_ax_slab_kernel(const T* __restrict__ p_prev, const T* __restrict__ r,
                       const T* __restrict__ D, const T* __restrict__ g3,
                       const T* __restrict__ mx, const T* __restrict__ my,
                       const T* __restrict__ mz, const T* __restrict__ beta,
                       T* __restrict__ p_out, T* __restrict__ w,
                       T* __restrict__ pap, int ex, int ey) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  __shared__ AxShared<N, T> sh;
  __shared__ T red[N2];

  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const int tid = j * N + i;
  const size_t e = blockIdx.x;
  const int ix = static_cast<int>(e % ex);
  const int iy = static_cast<int>((e / ex) % ey);
  const int iz = static_cast<int>(e / (static_cast<size_t>(ex) * ey));
  const size_t base = e * N3 + tid;

  load_D(sh, D, i, j);
  const T b = *beta;
  T pc[N];
  T wc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    pc[k] = add_rn(r[base + k * N2], mul_rn(b, p_prev[base + k * N2]));
    p_out[base + k * N2] = pc[k];
  }
  ax_diag_columns(sh, g3 + e * 3 * N3 + tid, pc, wc, i, j);

  const T myx = my[iy * N + j] * mx[ix * N + i];
  T part = T(0);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    // the box mask is (mz * my) * mx; all factors are 0 or 1, so any order
    // of the product is exact.
    const T v = wc[k] * (mz[iz * N + k] * myx);
    part += pc[k] * v;
    w[base + k * N2] = v;
  }
  const T total = block_sum<N2>(part, red, tid);
  if (tid == 0) pap[e] = total;
}

template <int N, typename T>
cudaError_t launch(const T* p_prev, const T* r, const T* D, const T* g3,
                   const T* mx, const T* my, const T* mz, const T* beta,
                   T* p_out, T* w, T* pap, int ex, int ey, int ez,
                   cudaStream_t stream) {
  const int E = ex * ey * ez;
  nekbone_ax_slab_kernel<N, T><<<E, dim3(N, N), 0, stream>>>(
      p_prev, r, D, g3, mx, my, mz, beta, p_out, w, pap, ex, ey);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const T* p_prev, const T* r, const T* D, const T* g3,
             const T* mx, const T* my, const T* mz, const T* beta, T* p_out,
             T* w, T* pap, int ex, int ey, int ez, int n, void* stream) {
  if (ex <= 0 || ey <= 0 || ez <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N)                                                  \
  case N:                                                                \
    return static_cast<int>(launch<N, T>(p_prev, r, D, g3, mx, my, mz,   \
                                         beta, p_out, w, pap, ex, ey, ez, \
                                         s));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// p_prev, r, p_out, w: (E, n^3); D: (n, n); g3: (E, 3, n^3); mx: (EX, n);
// my: (EY, n); mz: (EZ, n); beta: one value; pap: (E,).  Elements z-major
// over (EX, EY, EZ).  Returns cudaGetLastError() after the launch.
#ifdef NEKBONE_REAL_F64
extern "C" int nekbone_ax_slab_f64(const double* p_prev, const double* r,
                                   const double* D, const double* g3,
                                   const double* mx, const double* my,
                                   const double* mz, const double* beta,
                                   double* p_out, double* w, double* pap,
                                   int ex, int ey, int ez, int n,
                                   void* stream) {
  return nekbone::dispatch<double>(p_prev, r, D, g3, mx, my, mz, beta, p_out,
                                   w, pap, ex, ey, ez, n, stream);
}
#endif

#ifdef NEKBONE_REAL_F32
extern "C" int nekbone_ax_slab_f32(const float* p_prev, const float* r,
                                   const float* D, const float* g3,
                                   const float* mx, const float* my,
                                   const float* mz, const float* beta,
                                   float* p_out, float* w, float* pap, int ex,
                                   int ey, int ez, int n, void* stream) {
  return nekbone::dispatch<float>(p_prev, r, D, g3, mx, my, mz, beta, p_out,
                                  w, pap, ex, ey, ez, n, stream);
}
#endif
