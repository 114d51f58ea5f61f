// K5: the back half of one v2 CG iteration, per element.
//
//     w   = gs(w_local)                (direct-stiffness sum, node by node)
//     x  += alpha * p
//     r  -= alpha * w
//     rcr = sum(r * c * r)             (per-element partial, stored r)
//
// Replaces the TPU kernel
// src/repro/kernels/nekbone_ax.py:nekbone_cg_update_kernel (pallas_call at
// :698).  The TPU kernel received w already summed inside each z-slab block
// and stitched in the two neighbouring blocks' boundary planes.  Here the
// front-half kernel (nekbone_ax_slab.cu) writes the unassembled masked w,
// and this kernel assembles it: thread (i, j) of the element's n x n layer,
// at layer k, reads the node's own copy and, on a face, edge or corner, the
// coincident copies in the neighbouring elements, straight from device
// memory.  The sums follow core/gs.ds_sum_local's tree exactly: pairs
// across x first, then pairs of x-sums across y, then pairs of xy-sums
// across z, each pair as (lower element) + (upper element).  IEEE addition
// is commutative but not associative, so fixing the tree makes the
// assembled w bitwise the plain version's in fp64 and fp32.
//
// Streams: reads x, p, r, w (4) and writes x, r (2) — with the front half,
// the 13-stream book of core/cost.py.  The face gathers read at most 8
// copies at a corner and 2 on a face; they are counted as no extra stream,
// since the neighbours' copies are read by their own blocks in the same
// wave and come from L2.  At E=1024, n=10, fp64 one launch moves
// 6 x 8.19 MB = 49.2 MB (about 15 us at the data sheet's 3.35 TB/s); a
// handful of flops per node, so the kernel is bound by bytes.  rcr leaves
// as one value per element (E values), summed outside by torch.sum.
//
// alpha is read from a device pointer.  Both axpys use rounded, uncontracted
// multiply and add, so x and r are bitwise the plain version's.  The
// weight c = mask/multiplicity is rebuilt per node from the factors cx, cy,
// cz (exact binary fractions).
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

template <int N, typename T>
__device__ __forceinline__ T node(const T* __restrict__ w, size_t e, int k,
                                  int j, int i) {
  return w[e * (N * N * N) + (k * N + j) * N + i];
}

// x pairs: face i = n-1 of element ex meets i = 0 of element ex + 1.
template <int N, typename T>
__device__ __forceinline__ T sum_x(const T* __restrict__ w, size_t e, int k,
                                   int j, int i, int ix, int ex) {
  if (i == N - 1 && ix < ex - 1)
    return add_rn(node<N>(w, e, k, j, N - 1), node<N>(w, e + 1, k, j, 0));
  if (i == 0 && ix > 0)
    return add_rn(node<N>(w, e - 1, k, j, N - 1), node<N>(w, e, k, j, 0));
  return node<N>(w, e, k, j, i);
}

// y pairs of x-sums.
template <int N, typename T>
__device__ __forceinline__ T sum_xy(const T* __restrict__ w, size_t e, int k,
                                    int j, int i, int ix, int iy, int ex,
                                    int ey) {
  const size_t sy = static_cast<size_t>(ex);
  if (j == N - 1 && iy < ey - 1)
    return add_rn(sum_x<N>(w, e, k, N - 1, i, ix, ex),
                  sum_x<N>(w, e + sy, k, 0, i, ix, ex));
  if (j == 0 && iy > 0)
    return add_rn(sum_x<N>(w, e - sy, k, N - 1, i, ix, ex),
                  sum_x<N>(w, e, k, 0, i, ix, ex));
  return sum_x<N>(w, e, k, j, i, ix, ex);
}

// z pairs of xy-sums: the assembled value of node (k, j, i) of element e.
template <int N, typename T>
__device__ __forceinline__ T sum_xyz(const T* __restrict__ w, size_t e, int k,
                                     int j, int i, int ix, int iy, int iz,
                                     int ex, int ey, int ez) {
  const size_t sz = static_cast<size_t>(ex) * ey;
  if (k == N - 1 && iz < ez - 1)
    return add_rn(sum_xy<N>(w, e, N - 1, j, i, ix, iy, ex, ey),
                  sum_xy<N>(w, e + sz, 0, j, i, ix, iy, ex, ey));
  if (k == 0 && iz > 0)
    return add_rn(sum_xy<N>(w, e - sz, N - 1, j, i, ix, iy, ex, ey),
                  sum_xy<N>(w, e, 0, j, i, ix, iy, ex, ey));
  return sum_xy<N>(w, e, k, j, i, ix, iy, ex, ey);
}

template <int N, typename T>
__global__ void __launch_bounds__(N * N)
nekbone_cg_update_kernel(const T* __restrict__ x, const T* __restrict__ p,
                         const T* __restrict__ r, const T* __restrict__ w,
                         const T* __restrict__ alpha,
                         const T* __restrict__ cx, const T* __restrict__ cy,
                         const T* __restrict__ cz, T* __restrict__ x_out,
                         T* __restrict__ r_out, T* __restrict__ rcr, int ex,
                         int ey, int ez) {
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

  T part = T(0);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const size_t o = base + k * N2;
    const T wa = sum_xyz<N>(w, e, k, j, i, ix, iy, iz, ex, ey, ez);
    x_out[o] = add_rn(x[o], mul_rn(a, p[o]));
    const T rn = sub_rn(r[o], mul_rn(a, wa));
    r_out[o] = rn;
    // c is (cz * cy) * cx; the factors are 0, 1/2 or 1, so the product is
    // exact in any order.
    const T c = cz[iz * N + k] * cyx;
    part += (rn * c) * rn;
  }
  const T total = block_sum<N2>(part, red, tid);
  if (tid == 0) rcr[e] = total;
}

template <int N, typename T>
cudaError_t launch(const T* x, const T* p, const T* r, const T* w,
                   const T* alpha, const T* cx, const T* cy, const T* cz,
                   T* x_out, T* r_out, T* rcr, int ex, int ey, int ez,
                   cudaStream_t stream) {
  const int E = ex * ey * ez;
  nekbone_cg_update_kernel<N, T><<<E, dim3(N, N), 0, stream>>>(
      x, p, r, w, alpha, cx, cy, cz, x_out, r_out, rcr, ex, ey, ez);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const T* x, const T* p, const T* r, const T* w, const T* alpha,
             const T* cx, const T* cy, const T* cz, T* x_out, T* r_out,
             T* rcr, int ex, int ey, int ez, int n, void* stream) {
  if (ex <= 0 || ey <= 0 || ez <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N)                                                     \
  case N:                                                                   \
    return static_cast<int>(launch<N, T>(x, p, r, w, alpha, cx, cy, cz,     \
                                         x_out, r_out, rcr, ex, ey, ez, s));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// x, p, r, w (unassembled, masked), x_out, r_out: (E, n^3); alpha: one
// value; cx: (EX, n); cy: (EY, n); cz: (EZ, n); rcr: (E,).  Elements z-major
// over (EX, EY, EZ).  Returns cudaGetLastError() after the launch.
extern "C" int nekbone_cg_update_f64(const double* x, const double* p,
                                     const double* r, const double* w,
                                     const double* alpha, const double* cx,
                                     const double* cy, const double* cz,
                                     double* x_out, double* r_out,
                                     double* rcr, int ex, int ey, int ez,
                                     int n, void* stream) {
  return nekbone::dispatch<double>(x, p, r, w, alpha, cx, cy, cz, x_out,
                                   r_out, rcr, ex, ey, ez, n, stream);
}

extern "C" int nekbone_cg_update_f32(const float* x, const float* p,
                                     const float* r, const float* w,
                                     const float* alpha, const float* cx,
                                     const float* cy, const float* cz,
                                     float* x_out, float* r_out, float* rcr,
                                     int ex, int ey, int ez, int n,
                                     void* stream) {
  return nekbone::dispatch<float>(x, p, r, w, alpha, cx, cy, cz, x_out,
                                  r_out, rcr, ex, ey, ez, n, stream);
}
