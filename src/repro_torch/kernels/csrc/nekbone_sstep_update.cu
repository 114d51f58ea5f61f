// K9: the multi-axpy back half of one s-step CG cycle, per element.
//
//     V   = [p, basis[0..s-1], r, basis[s..2s-2]]   (K8's column order)
//     x  += V @ coef[0]
//     r   = V @ coef[1]
//     p   = V @ coef[2]
//     rcr = sum(r * c * r)                          (per element, stored r)
//
// with coef the (3, 2s+1) rows of the float64 host recurrence
// (core/cg_sstep.cycle_coefficients) in the accumulation dtype.
//
// Replaces the TPU kernel
// src/repro/kernels/nekbone_ax.py:nekbone_sstep_update_kernel (pallas_call
// at :1274), which applied the same combinations to a VMEM block of
// elements.  It is element-local and needs no assembly, so the port keeps
// the per-element layout of K5: one thread block per element, an n x n
// thread layer marching the k layers; each node reads its 2s+1 vector values
// once and forms the three combinations.  The terms are summed in the
// reference's order (x from the old x, r and p from zero, over V's columns
// in order) with rounded, uncontracted multiply and add, so x, r and p are
// bitwise the plain version's.  The weight c = mask/multiplicity is rebuilt
// per node from the factors cx, cy, cz.  rcr leaves as one value per element
// (E values), summed outside by torch.sum.
//
// Bound: bytes.  x, p, r and the 2s - 1 basis vectors in, x, r, p out:
// 13 fields at s=4, 106.5 MB at E=1024, n=10, fp64 (31.8 us at the data
// sheet's 3.35 TB/s); 6(2s+1) + 3 flops per node, far below.
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

template <int N, typename T>
__global__ void __launch_bounds__(N * N)
nekbone_sstep_update_kernel(const T* __restrict__ x, const T* __restrict__ p,
                            const T* __restrict__ r,
                            const T* __restrict__ basis,
                            const T* __restrict__ coef,
                            const T* __restrict__ cx,
                            const T* __restrict__ cy,
                            const T* __restrict__ cz, T* __restrict__ x_out,
                            T* __restrict__ r_out, T* __restrict__ p_out,
                            T* __restrict__ rcr, int s, int ex, int ey) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  __shared__ T sco[3][kSstepMaxK];
  __shared__ T red[N2];

  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const int tid = j * N + i;
  const size_t e = blockIdx.x;
  const int ix = static_cast<int>(e % ex);
  const int iy = static_cast<int>((e / ex) % ey);
  const int iz = static_cast<int>(e / (static_cast<size_t>(ex) * ey));
  const int K = 2 * s + 1;
  const int nb = 2 * s - 1;
  const size_t base = e * N3 + tid;
  const T* be = basis + e * nb * N3 + tid;

  for (int t = tid; t < 3 * K; t += N2) sco[t / K][t % K] = coef[t];
  __syncthreads();
  // c is (cz * cy) * cx; the factors are 0, 1/2 or 1, so the product is
  // exact in any order.
  const T cyx = cy[iy * N + j] * cx[ix * N + i];

  T part = T(0);
  for (int k = 0; k < N; ++k) {
    const size_t o = base + k * N2;
    T xa = x[o];
    T ra = T(0);
    T pa = T(0);
    for (int m = 0; m < K; ++m) {
      T v;
      if (m == 0)
        v = p[o];
      else if (m <= s)
        v = be[(m - 1) * N3 + k * N2];
      else if (m == s + 1)
        v = r[o];
      else
        v = be[(m - 2) * N3 + k * N2];
      xa = add_rn(xa, mul_rn(sco[0][m], v));
      ra = add_rn(ra, mul_rn(sco[1][m], v));
      pa = add_rn(pa, mul_rn(sco[2][m], v));
    }
    x_out[o] = xa;
    r_out[o] = ra;
    p_out[o] = pa;
    const T c = cz[iz * N + k] * cyx;
    part += (ra * c) * ra;
  }
  const T total = block_sum<N2>(part, red, tid);
  if (tid == 0) rcr[e] = total;
}

template <int N, typename T>
cudaError_t launch(const T* x, const T* p, const T* r, const T* basis,
                   const T* coef, const T* cx, const T* cy, const T* cz,
                   T* x_out, T* r_out, T* p_out, T* rcr, int ex, int ey,
                   int ez, int s, cudaStream_t stream) {
  const int E = ex * ey * ez;
  nekbone_sstep_update_kernel<N, T><<<E, dim3(N, N), 0, stream>>>(
      x, p, r, basis, coef, cx, cy, cz, x_out, r_out, p_out, rcr, s, ex, ey);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const T* x, const T* p, const T* r, const T* basis,
             const T* coef, const T* cx, const T* cy, const T* cz, T* x_out,
             T* r_out, T* p_out, T* rcr, int ex, int ey, int ez, int n,
             int s, void* stream) {
  if (ex <= 0 || ey <= 0 || ez <= 0 || s < 1 || s > kSstepMaxS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N)                                                     \
  case N:                                                                   \
    return static_cast<int>(launch<N, T>(x, p, r, basis, coef, cx, cy, cz,  \
                                         x_out, r_out, p_out, rcr, ex, ey,  \
                                         ez, s, st));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// x, p, r, x_out, r_out, p_out: (E, n^3); basis: (E, 2s-1, n^3); coef:
// (3, 2s+1); cx: (EX, n); cy: (EY, n); cz: (EZ, n); rcr: (E,).  Elements
// z-major over (EX, EY, EZ); 1 <= s <= 10.  Returns cudaGetLastError()
// after the launch.
#ifdef NEKBONE_REAL_F64
extern "C" int nekbone_sstep_update_f64(
    const double* x, const double* p, const double* r, const double* basis,
    const double* coef, const double* cx, const double* cy, const double* cz,
    double* x_out, double* r_out, double* p_out, double* rcr, int ex, int ey,
    int ez, int n, int s, void* stream) {
  return nekbone::dispatch<double>(x, p, r, basis, coef, cx, cy, cz, x_out,
                                   r_out, p_out, rcr, ex, ey, ez, n, s,
                                   stream);
}
#endif

#ifdef NEKBONE_REAL_F32
extern "C" int nekbone_sstep_update_f32(
    const float* x, const float* p, const float* r, const float* basis,
    const float* coef, const float* cx, const float* cy, const float* cz,
    float* x_out, float* r_out, float* p_out, float* rcr, int ex, int ey,
    int ez, int n, int s, void* stream) {
  return nekbone::dispatch<float>(x, p, r, basis, coef, cx, cy, cz, x_out,
                                  r_out, p_out, rcr, ex, ey, ez, n, s,
                                  stream);
}
#endif
