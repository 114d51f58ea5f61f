// K11: the Chebyshev preconditioner z = q_k(A) r and the partial r.c.z.
//
//     d = c00 * r;  z = d;  res = r
//     for i in 1..k:
//         res -= gs(mask * A_loc d)        (masked, then assembled)
//         d    = c_i0 * d + c_i1 * res
//         z   += d
//     rtz = sum(r * c * z)                 (per element, over the stored z)
//
// with coef = (c_i0, c_i1), the (k+1, 2) recurrence scalars of
// core/precond.cheb_scalars.
//
// Replaces the TPU kernel
// src/repro/kernels/nekbone_ax.py:nekbone_cheb_apply_kernel (pallas_call at
// :1563).  The TPU kernel kept a block of z-slabs plus k ghost slabs on each
// side in VMEM, so the k chained *assembled* operator applications never
// left the chip.  On Hopper one thread block cannot see its neighbours' new
// d without a grid-wide barrier, and a tile of elements with k ghost layers
// does not fit the 227 KB of shared memory a block may use (one fp64 n=10
// element is 8 KB; a cooperative launch is out, since at E=4096 not every
// block can be resident).  So the polynomial runs as a chain of k + 1
// launches on the caller's stream, one thread block per element, an n x n
// thread layer marching the k layers:
//
// * start:       d = c00 * r; writes d and the unassembled masked A_loc d;
// * step i < k:  assembles the previous A_loc d with common.cuh's sum_xyz
//                (core/gs.ds_sum_local's tree), applies the recurrence,
//                writes d, res, z and the unassembled masked A_loc of the
//                new d (the block holds its whole element's new d);
// * step k:      the same recurrence, then writes z and the per-element
//                rtz partial.
//
// The unassembled A_loc d ping-pongs between two buffers, since a step reads
// its neighbours' copies of the previous one while it writes the next; d,
// res and z are read and written only by their own element's block, so they
// are updated in place.  The local operator is common.cuh's masked_ax
// (ax_diag_columns, the same code as K4's), shared with K8.
//
// Bound: bytes.  The reference's book is r and the 3 metric diagonals in,
// z out: 5 x 8.19 MB = 41.0 MB at E=1024, n=10, fp64 (12.2 us at 3.35
// TB/s).  The work is k (12n + 10) flops per node (core/cost.py
// cheb_apply_flops), 0.53 GF at k=4: 8.5 us with the contractions on the
// fp64 tensor cores (67 TF/s) and the rest at 34 TF/s, below the book's
// bytes.  The chain moves far more than the book: the start launch 6
// fields, each middle step 11 (d, res, z, A d and 3 metric diagonals in;
// d, res, z, A d out), the last step 6 (d, res, z, A d, r in; z out), so 45
// fields at k=4 — what a halo-tiled, one-residency design would save.
//
// The recurrence uses rounded, uncontracted arithmetic, as the plain
// version's separate tensor operations do; only the operator's
// contractions use FMA.  The scalars are read from a device pointer.
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

template <int N, typename T>
__global__ void __launch_bounds__(N * N)
nekbone_cheb_start_kernel(const T* __restrict__ r, const T* __restrict__ D,
                          const T* __restrict__ g3, const T* __restrict__ mx,
                          const T* __restrict__ my, const T* __restrict__ mz,
                          const T* __restrict__ coef, T* __restrict__ d,
                          T* __restrict__ ad, int ex, int ey) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  __shared__ AxShared<N, T> sh;

  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const size_t e = blockIdx.x;
  const int ix = static_cast<int>(e % ex);
  const int iy = static_cast<int>((e / ex) % ey);
  const int iz = static_cast<int>(e / (static_cast<size_t>(ex) * ey));
  const size_t base = e * N3 + j * N + i;

  load_D(sh, D, i, j);
  const T c00 = coef[0];
  T dc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    dc[k] = mul_rn(c00, r[base + k * N2]);
    d[base + k * N2] = dc[k];
  }
  masked_ax(sh, g3, mx, my, mz, dc, ad, e, i, j, ix, iy, iz);
}

// Step i of the recurrence.  res_in is r at step 1 and z_in is d there (z
// starts as d); from step 2 on they alias res and z.  The pointers that may
// alias are not __restrict__.
template <int N, typename T, bool LAST>
__global__ void __launch_bounds__(N * N)
nekbone_cheb_step_kernel(const T* res_in, const T* z_in, T* d, T* res, T* z,
                         const T* __restrict__ ad_in, T* __restrict__ ad_out,
                         const T* __restrict__ r, const T* __restrict__ D,
                         const T* __restrict__ g3, const T* __restrict__ mx,
                         const T* __restrict__ my, const T* __restrict__ mz,
                         const T* __restrict__ cx, const T* __restrict__ cy,
                         const T* __restrict__ cz, const T* __restrict__ coef,
                         T* __restrict__ rtz, int step, int ex, int ey,
                         int ez) {
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

  if (!LAST) load_D(sh, D, i, j);
  const T ci0 = coef[2 * step];
  const T ci1 = coef[2 * step + 1];
  const T cyx = cy[iy * N + j] * cx[ix * N + i];
  T dc[N];
  T part = T(0);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const size_t o = base + k * N2;
    const T aw = sum_xyz<N>(ad_in, e, k, j, i, ix, iy, iz, ex, ey, ez);
    const T rn = sub_rn(res_in[o], aw);
    const T dn = add_rn(mul_rn(ci0, d[o]), mul_rn(ci1, rn));
    const T zn = add_rn(z_in[o], dn);
    z[o] = zn;
    if (LAST) {
      // c is (cz * cy) * cx, exact in any order (factors 0, 1/2, 1).
      part += mul_rn(mul_rn(r[o], cz[iz * N + k] * cyx), zn);
    } else {
      res[o] = rn;
      d[o] = dn;
      dc[k] = dn;
    }
  }
  if (LAST) {
    const T total = block_sum<N2>(part, red, tid);
    if (tid == 0) rtz[e] = total;
  } else {
    masked_ax(sh, g3, mx, my, mz, dc, ad_out, e, i, j, ix, iy, iz);
  }
}

template <int N, typename T>
cudaError_t launch(const T* r, const T* D, const T* g3, const T* mx,
                   const T* my, const T* mz, const T* cx, const T* cy,
                   const T* cz, const T* coef, T* z, T* d, T* res, T* ad0,
                   T* ad1, T* rtz, int ex, int ey, int ez, int k,
                   cudaStream_t stream) {
  const int E = ex * ey * ez;
  const dim3 threads(N, N);
  nekbone_cheb_start_kernel<N, T><<<E, threads, 0, stream>>>(
      r, D, g3, mx, my, mz, coef, d, ad0, ex, ey);
  cudaError_t err = cudaGetLastError();
  T* ad[2] = {ad0, ad1};
  for (int step = 1; step <= k && err == cudaSuccess; ++step) {
    const T* res_in = step == 1 ? r : res;
    const T* z_in = step == 1 ? d : z;
    const T* ad_in = ad[(step - 1) % 2];
    T* ad_out = ad[step % 2];
    if (step < k)
      nekbone_cheb_step_kernel<N, T, false><<<E, threads, 0, stream>>>(
          res_in, z_in, d, res, z, ad_in, ad_out, r, D, g3, mx, my, mz, cx,
          cy, cz, coef, rtz, step, ex, ey, ez);
    else
      nekbone_cheb_step_kernel<N, T, true><<<E, threads, 0, stream>>>(
          res_in, z_in, d, res, z, ad_in, ad_out, r, D, g3, mx, my, mz, cx,
          cy, cz, coef, rtz, step, ex, ey, ez);
    err = cudaGetLastError();
  }
  return err;
}

template <typename T>
int dispatch(const T* r, const T* D, const T* g3, const T* mx, const T* my,
             const T* mz, const T* cx, const T* cy, const T* cz,
             const T* coef, T* z, T* d, T* res, T* ad0, T* ad1, T* rtz,
             int ex, int ey, int ez, int n, int k, void* stream) {
  if (ex <= 0 || ey <= 0 || ez <= 0 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N)                                                      \
  case N:                                                                    \
    return static_cast<int>(launch<N, T>(r, D, g3, mx, my, mz, cx, cy, cz,   \
                                         coef, z, d, res, ad0, ad1, rtz, ex, \
                                         ey, ez, k, s));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// r, z and the scratch d, res, ad0, ad1: (E, n^3); D: (n, n); g3: (E, 3,
// n^3); mx, cx: (EX, n); my, cy: (EY, n); mz, cz: (EZ, n); coef: (k+1, 2);
// rtz: (E,).  Elements z-major over (EX, EY, EZ).  Queues k + 1 launches
// and returns the first non-zero cudaGetLastError(), or 0.
#ifdef NEKBONE_REAL_F64
extern "C" int nekbone_cheb_apply_f64(
    const double* r, const double* D, const double* g3, const double* mx,
    const double* my, const double* mz, const double* cx, const double* cy,
    const double* cz, const double* coef, double* z, double* d, double* res,
    double* ad0, double* ad1, double* rtz, int ex, int ey, int ez, int n,
    int k, void* stream) {
  return nekbone::dispatch<double>(r, D, g3, mx, my, mz, cx, cy, cz, coef, z,
                                   d, res, ad0, ad1, rtz, ex, ey, ez, n, k,
                                   stream);
}
#endif

#ifdef NEKBONE_REAL_F32
extern "C" int nekbone_cheb_apply_f32(
    const float* r, const float* D, const float* g3, const float* mx,
    const float* my, const float* mz, const float* cx, const float* cy,
    const float* cz, const float* coef, float* z, float* d, float* res,
    float* ad0, float* ad1, float* rtz, int ex, int ey, int ez, int n, int k,
    void* stream) {
  return nekbone::dispatch<float>(r, D, g3, mx, my, mz, cx, cy, cz, coef, z,
                                  d, res, ad0, ad1, rtz, ex, ey, ez, n, k,
                                  stream);
}
#endif
