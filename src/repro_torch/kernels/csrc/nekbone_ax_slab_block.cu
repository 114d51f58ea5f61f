// K6: K4 (the front half of one v2 CG iteration) over b right-hand sides.
//
//     for each lane l:
//       p_l   = r_l + beta_l * p_prev_l     (stored)
//       w_l   = mask * (D^T G D p_l)        (unassembled; diagonal metric)
//       pap_l = sum(p_l * w_l)              (per-element partial)
//
// Replaces the TPU kernel
// src/repro/kernels/nekbone_ax.py:nekbone_ax_slab_block_kernel (pallas_call
// at :825).  As in K4 (nekbone_ax_slab.cu) the work is per element: one
// thread block, an n x n thread layer marching the k layers, the
// unassembled masked w out, the assembly left to the update kernel (K7).
// The operator data is loaded once for all b lanes: D and D^T into shared
// memory, the element's three metric diagonals into registers (each thread
// holds its column, 3n values), the mask column as n register values.  The
// block then loops over the lanes and runs K4's per-lane arithmetic on
// them: the same common.cuh device function (ax_diag_columns_g) with the
// metric read from those registers instead of device memory, the same
// rounded p update, the same mask product and partial sum.  Each lane's p,
// w and pap are therefore bitwise K4's on that lane.
//
// Bound: bytes.  Per lane p_prev and r in, p and w out (4 fields), plus the
// 3 metric diagonals once: (4b + 3) fields, 8.19 MB each at E=1024, n=10,
// fp64 — 155.6 MB at b=4, 46.4 us at 3.35 TB/s.  About 12n + 10 flops per
// node and lane.  The shared metric is what the batch saves: K4 run b times
// moves 7b fields (229.4 MB at b=4).  pap leaves as (b, E) values, summed
// per lane outside.
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

template <int N, typename T>
__global__ void __launch_bounds__(N * N)
nekbone_ax_slab_block_kernel(const T* __restrict__ p_prev,
                             const T* __restrict__ r, const T* __restrict__ D,
                             const T* __restrict__ g3,
                             const T* __restrict__ mx,
                             const T* __restrict__ my,
                             const T* __restrict__ mz,
                             const T* __restrict__ beta,
                             T* __restrict__ p_out, T* __restrict__ w,
                             T* __restrict__ pap, int ex, int ey, int nrhs) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  __shared__ AxShared<N, T> sh;
  __shared__ T red[N2];

  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const int tid = j * N + i;
  const size_t e = blockIdx.x;
  const size_t E = gridDim.x;
  const int ix = static_cast<int>(e % ex);
  const int iy = static_cast<int>((e / ex) % ey);
  const int iz = static_cast<int>(e / (static_cast<size_t>(ex) * ey));

  // operator data, once for every lane
  load_D(sh, D, i, j);
  const T* ge = g3 + e * 3 * N3 + tid;
  T gc[3][N];
  T mk[N];
  // the box mask is (mz * my) * mx; all factors are 0 or 1, so the product
  // is exact in any order (K4 forms the same values).
  const T myx = my[iy * N + j] * mx[ix * N + i];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    gc[0][k] = ge[0 * N3 + k * N2];
    gc[1][k] = ge[1 * N3 + k * N2];
    gc[2][k] = ge[2 * N3 + k * N2];
    mk[k] = mz[iz * N + k] * myx;
  }
  const auto metric = [&gc](int c, int k) { return gc[c][k]; };

  for (int l = 0; l < nrhs; ++l) {
    const size_t base = (l * E + e) * N3 + tid;
    const T b = beta[l];
    T pc[N];
    T wc[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      pc[k] = add_rn(r[base + k * N2], mul_rn(b, p_prev[base + k * N2]));
      p_out[base + k * N2] = pc[k];
    }
    ax_diag_columns_g(sh, metric, pc, wc, i, j);
    T part = T(0);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const T v = wc[k] * mk[k];
      part += pc[k] * v;
      w[base + k * N2] = v;
    }
    const T total = block_sum<N2>(part, red, tid);
    if (tid == 0) pap[l * E + e] = total;
  }
}

template <int N, typename T>
cudaError_t launch(const T* p_prev, const T* r, const T* D, const T* g3,
                   const T* mx, const T* my, const T* mz, const T* beta,
                   T* p_out, T* w, T* pap, int ex, int ey, int ez, int nrhs,
                   cudaStream_t stream) {
  const int E = ex * ey * ez;
  nekbone_ax_slab_block_kernel<N, T><<<E, dim3(N, N), 0, stream>>>(
      p_prev, r, D, g3, mx, my, mz, beta, p_out, w, pap, ex, ey, nrhs);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const T* p_prev, const T* r, const T* D, const T* g3,
             const T* mx, const T* my, const T* mz, const T* beta, T* p_out,
             T* w, T* pap, int ex, int ey, int ez, int n, int nrhs,
             void* stream) {
  if (ex <= 0 || ey <= 0 || ez <= 0 || nrhs <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N)                                                  \
  case N:                                                                \
    return static_cast<int>(launch<N, T>(p_prev, r, D, g3, mx, my, mz,   \
                                         beta, p_out, w, pap, ex, ey, ez, \
                                         nrhs, s));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// p_prev, r, p_out, w: (b, E, n^3); D: (n, n); g3: (E, 3, n^3); mx: (EX, n);
// my: (EY, n); mz: (EZ, n); beta: (b,); pap: (b, E).  Elements z-major over
// (EX, EY, EZ).  Returns cudaGetLastError() after the launch.
#ifdef NEKBONE_REAL_F64
extern "C" int nekbone_ax_slab_block_f64(
    const double* p_prev, const double* r, const double* D, const double* g3,
    const double* mx, const double* my, const double* mz, const double* beta,
    double* p_out, double* w, double* pap, int ex, int ey, int ez, int n,
    int nrhs, void* stream) {
  return nekbone::dispatch<double>(p_prev, r, D, g3, mx, my, mz, beta, p_out,
                                   w, pap, ex, ey, ez, n, nrhs, stream);
}
#endif

#ifdef NEKBONE_REAL_F32
extern "C" int nekbone_ax_slab_block_f32(
    const float* p_prev, const float* r, const float* D, const float* g3,
    const float* mx, const float* my, const float* mz, const float* beta,
    float* p_out, float* w, float* pap, int ex, int ey, int ez, int n,
    int nrhs, void* stream) {
  return nekbone::dispatch<float>(p_prev, r, D, g3, mx, my, mz, beta, p_out,
                                  w, pap, ex, ey, ez, n, nrhs, stream);
}
#endif
