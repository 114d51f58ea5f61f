// K7: K5 (the back half of one v2 CG iteration) over b right-hand sides.
//
//     for each lane l:
//       w_l    = gs(w_local_l)              (direct-stiffness sum)
//       x_l   += alpha_l * p_l
//       r_l   -= alpha_l * w_l
//       rcr_l  = sum(r_l * c * r_l)         (per-element partial, stored r)
//
// Replaces the TPU kernel
// src/repro/kernels/nekbone_ax.py:nekbone_cg_update_block_kernel
// (pallas_call at :918).  As in K5 (nekbone_cg_update.cu) the work is per
// element, one n x n thread layer marching the k layers, and the assembly
// reads the neighbours' face copies of the unassembled w straight from
// device memory in core/gs.ds_sum_local's tree (common.cuh's sum_xyz).  The
// weight c = mask / multiplicity is rebuilt once per element from its
// per-axis factors: the thread's (cy * cx) product, times the layer's cz
// factor (an L1 hit) at each layer.  The block loops over the lanes and runs
// K5's arithmetic on each: the same gathers, the same rounded, uncontracted
// axpys, the same partial sum.  So each lane's x, r and rcr are bitwise
// K5's on that lane.
//
// Registers decide this kernel's speed (H100, n=10, fp64): left alone,
// nvcc hoists every layer's neighbour addresses out of the lane loop and
// holds them live across it (168 registers against K5's 56, and K7 at b=1
// took twice K5's time); holding the n values of c across the lanes costs
// registers too.  So an opaque per-lane copy of the element index keeps the
// address arithmetic inside the loop, and c's layer factor is read again
// per lane.
//
// Bound: bytes.  Per lane x, p, r, w in and x, r out: 6 fields of 8.19 MB
// at E=1024, n=10, fp64, 196.6 MB at b=4 (58.7 us at 3.35 TB/s).  K5 has no
// operator stream to share, so the batch saves only launches here.  rcr
// leaves as (b, E) values, summed per lane outside.
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

template <int N, typename T>
__global__ void __launch_bounds__(N * N)
nekbone_cg_update_block_kernel(const T* __restrict__ x,
                               const T* __restrict__ p,
                               const T* __restrict__ r,
                               const T* __restrict__ w,
                               const T* __restrict__ alpha,
                               const T* __restrict__ cx,
                               const T* __restrict__ cy,
                               const T* __restrict__ cz,
                               T* __restrict__ x_out, T* __restrict__ r_out,
                               T* __restrict__ rcr, int ex, int ey, int ez,
                               int nrhs) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  __shared__ T red[N2];

  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const int tid = j * N + i;
  const size_t e = blockIdx.x;
  const size_t E = gridDim.x;
  const int ix = static_cast<int>(e % ex);
  const int iy = static_cast<int>((e / ex) % ey);
  const int iz = static_cast<int>(e / (static_cast<size_t>(ex) * ey));

  // c is (cz * cy) * cx; the factors are 0, 1/2 or 1, so the product is
  // exact in any order (K5 forms the same values).
  const T cyx = cy[iy * N + j] * cx[ix * N + i];

  for (int l = 0; l < nrhs; ++l) {
    // opaque to nvcc: the neighbour addresses are recomputed per lane, not
    // hoisted out of the loop and held live across it
    size_t el = e;
    asm volatile("" : "+l"(el));
    const size_t lane = l * E * N3;
    const size_t base = lane + el * N3 + tid;
    const T* wl = w + lane;
    const T a = alpha[l];
    T part = T(0);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const size_t o = base + k * N2;
      const T wa = sum_xyz<N>(wl, el, k, j, i, ix, iy, iz, ex, ey, ez);
      x_out[o] = add_rn(x[o], mul_rn(a, p[o]));
      const T rn = sub_rn(r[o], mul_rn(a, wa));
      r_out[o] = rn;
      const T c = cz[iz * N + k] * cyx;
      part += (rn * c) * rn;
    }
    const T total = block_sum<N2>(part, red, tid);
    if (tid == 0) rcr[l * E + e] = total;
  }
}

template <int N, typename T>
cudaError_t launch(const T* x, const T* p, const T* r, const T* w,
                   const T* alpha, const T* cx, const T* cy, const T* cz,
                   T* x_out, T* r_out, T* rcr, int ex, int ey, int ez,
                   int nrhs, cudaStream_t stream) {
  const int E = ex * ey * ez;
  nekbone_cg_update_block_kernel<N, T><<<E, dim3(N, N), 0, stream>>>(
      x, p, r, w, alpha, cx, cy, cz, x_out, r_out, rcr, ex, ey, ez, nrhs);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const T* x, const T* p, const T* r, const T* w, const T* alpha,
             const T* cx, const T* cy, const T* cz, T* x_out, T* r_out,
             T* rcr, int ex, int ey, int ez, int n, int nrhs, void* stream) {
  if (ex <= 0 || ey <= 0 || ez <= 0 || nrhs <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N)                                                     \
  case N:                                                                   \
    return static_cast<int>(launch<N, T>(x, p, r, w, alpha, cx, cy, cz,     \
                                         x_out, r_out, rcr, ex, ey, ez,     \
                                         nrhs, s));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// x, p, r, w (unassembled, masked), x_out, r_out: (b, E, n^3); alpha: (b,);
// cx: (EX, n); cy: (EY, n); cz: (EZ, n); rcr: (b, E).  Elements z-major over
// (EX, EY, EZ).  Returns cudaGetLastError() after the launch.
#ifdef NEKBONE_REAL_F64
extern "C" int nekbone_cg_update_block_f64(
    const double* x, const double* p, const double* r, const double* w,
    const double* alpha, const double* cx, const double* cy,
    const double* cz, double* x_out, double* r_out, double* rcr, int ex,
    int ey, int ez, int n, int nrhs, void* stream) {
  return nekbone::dispatch<double>(x, p, r, w, alpha, cx, cy, cz, x_out,
                                   r_out, rcr, ex, ey, ez, n, nrhs, stream);
}
#endif

#ifdef NEKBONE_REAL_F32
extern "C" int nekbone_cg_update_block_f32(
    const float* x, const float* p, const float* r, const float* w,
    const float* alpha, const float* cx, const float* cy, const float* cz,
    float* x_out, float* r_out, float* rcr, int ex, int ey, int ez, int n,
    int nrhs, void* stream) {
  return nekbone::dispatch<float>(x, p, r, w, alpha, cx, cy, cz, x_out,
                                  r_out, rcr, ex, ey, ez, n, nrhs, stream);
}
#endif
