// K10: the back half of one Jacobi-PCG iteration, per element.
//
//     w    = gs(w_local)               (direct-stiffness sum, node by node)
//     x   += alpha * p
//     z   -= alpha * (invd * w)        (z = invd * r, the carried residual)
//     d    = 1 / invd                  (so r = d * z, never stored)
//     rtz  = sum(z * c * z * d)        (r.c.z: next beta's numerator)
//     rcr  = sum(z * c * z * d * d)    (r.c.r: the history entry)
//
// Replaces the TPU kernel
// src/repro/kernels/nekbone_ax.py:nekbone_pcg_update_kernel (pallas_call at
// :1406).  The solver carries the preconditioned residual z, so the front
// half is K4 (nekbone_ax_slab.cu) unchanged, with z in its residual slot.
// Like K5 (nekbone_cg_update.cu), which this kernel extends by one stream:
// the TPU kernel received w summed inside each z-slab block plus the two
// neighbouring blocks' boundary planes; here K4 writes the unassembled
// masked w and this kernel assembles it node by node with common.cuh's
// sum_xyz (core/gs.ds_sum_local's tree, bitwise).  One thread block per
// element, an n x n thread layer marching the k layers.
//
// Bound: bytes.  Reads x, p, z, w, invd (5), writes x, z (2): at E=1024,
// n=10, fp64, 7 x 8.19 MB = 57.3 MB per launch, 17.1 us at the data
// sheet's 3.35 TB/s; about 14 flops per node.  The face gathers of w come
// from L2 (the neighbours read the same copies in the same wave) and are
// counted as no stream.  The partials leave as one value per element each,
// summed outside by torch.sum.
//
// Both partials see the *stored* z (the reference's precision rule 2: the
// next iteration's K4 re-reads it), and d is the correctly rounded
// reciprocal of invd, taken node by node.  alpha is read from a device
// pointer; x and z use rounded, uncontracted arithmetic, so both are bitwise
// the plain version's.
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

template <int N, typename T>
__global__ void __launch_bounds__(N * N)
nekbone_pcg_update_kernel(const T* __restrict__ x, const T* __restrict__ p,
                          const T* __restrict__ z, const T* __restrict__ w,
                          const T* __restrict__ alpha,
                          const T* __restrict__ invd,
                          const T* __restrict__ cx, const T* __restrict__ cy,
                          const T* __restrict__ cz, T* __restrict__ x_out,
                          T* __restrict__ z_out, T* __restrict__ rtz,
                          T* __restrict__ rcr, int ex, int ey, int ez) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  __shared__ T red[N2];

  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const int tid = j * N + i;
  const size_t e = blockIdx.x;
  const int ix = static_cast<int>(e % ex);
  const int iy = static_cast<int>((e / ex) % ey);
  const int iz = static_cast<int>(e / (static_cast<size_t>(ex) * ey));
  const size_t base = e * N3 + tid;
  const T a = *alpha;
  const T cyx = cy[iy * N + j] * cx[ix * N + i];

  T part_rtz = T(0);
  T part_rcr = T(0);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const size_t o = base + k * N2;
    const T wa = sum_xyz<N>(w, e, k, j, i, ix, iy, iz, ex, ey, ez);
    const T id = invd[o];
    x_out[o] = add_rn(x[o], mul_rn(a, p[o]));
    const T zn = sub_rn(z[o], mul_rn(a, mul_rn(id, wa)));
    z_out[o] = zn;
    const T d = rcp_rn(id);
    // c is (cz * cy) * cx, exact in any order (factors 0, 1/2, 1).
    const T c = cz[iz * N + k] * cyx;
    const T t = mul_rn(mul_rn(mul_rn(zn, c), zn), d);
    part_rtz += t;
    part_rcr += mul_rn(t, d);
  }
  const T total_rtz = block_sum<N2>(part_rtz, red, tid);
  if (tid == 0) rtz[e] = total_rtz;
  __syncthreads();  // red is reused
  const T total_rcr = block_sum<N2>(part_rcr, red, tid);
  if (tid == 0) rcr[e] = total_rcr;
}

template <int N, typename T>
cudaError_t launch(const T* x, const T* p, const T* z, const T* w,
                   const T* alpha, const T* invd, const T* cx, const T* cy,
                   const T* cz, T* x_out, T* z_out, T* rtz, T* rcr, int ex,
                   int ey, int ez, cudaStream_t stream) {
  const int E = ex * ey * ez;
  nekbone_pcg_update_kernel<N, T><<<E, dim3(N, N), 0, stream>>>(
      x, p, z, w, alpha, invd, cx, cy, cz, x_out, z_out, rtz, rcr, ex, ey,
      ez);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const T* x, const T* p, const T* z, const T* w, const T* alpha,
             const T* invd, const T* cx, const T* cy, const T* cz, T* x_out,
             T* z_out, T* rtz, T* rcr, int ex, int ey, int ez, int n,
             void* stream) {
  if (ex <= 0 || ey <= 0 || ez <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N)                                                      \
  case N:                                                                    \
    return static_cast<int>(launch<N, T>(x, p, z, w, alpha, invd, cx, cy,    \
                                         cz, x_out, z_out, rtz, rcr, ex, ey, \
                                         ez, s));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// x, p, z, w (unassembled, masked), invd, x_out, z_out: (E, n^3); alpha: one
// value; cx: (EX, n); cy: (EY, n); cz: (EZ, n); rtz, rcr: (E,).  Elements
// z-major over (EX, EY, EZ).  Returns cudaGetLastError() after the launch.
#ifdef NEKBONE_REAL_F64
extern "C" int nekbone_pcg_update_f64(const double* x, const double* p,
                                      const double* z, const double* w,
                                      const double* alpha, const double* invd,
                                      const double* cx, const double* cy,
                                      const double* cz, double* x_out,
                                      double* z_out, double* rtz, double* rcr,
                                      int ex, int ey, int ez, int n,
                                      void* stream) {
  return nekbone::dispatch<double>(x, p, z, w, alpha, invd, cx, cy, cz, x_out,
                                   z_out, rtz, rcr, ex, ey, ez, n, stream);
}
#endif

#ifdef NEKBONE_REAL_F32
extern "C" int nekbone_pcg_update_f32(const float* x, const float* p,
                                      const float* z, const float* w,
                                      const float* alpha, const float* invd,
                                      const float* cx, const float* cy,
                                      const float* cz, float* x_out,
                                      float* z_out, float* rtz, float* rcr,
                                      int ex, int ey, int ez, int n,
                                      void* stream) {
  return nekbone::dispatch<float>(x, p, z, w, alpha, invd, cx, cy, cz, x_out,
                                  z_out, rtz, rcr, ex, ey, ez, n, stream);
}
#endif
