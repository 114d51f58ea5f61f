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
//
// Storage and accumulation (common.cuh), K5's roles plus one: S the CG
// vectors (p, z, w) and the c factors, X the solution, O the operator's
// data (invd), A alpha, the arithmetic and both partials.  Four builds: f64
// and f32 (one type throughout); bf16 (S = X = O = bf16, A = f32) and
// bf16_ir (S = bf16, X = O = A = f32: the bf16_ir policy keeps x and the
// operator's data in f32, core/precision.py).  w is assembled in A from its
// bf16 copies, the updated z is rounded to S before both partials (the next
// iteration's K4 reads the stored z), and d = 1/invd is taken in A.  bf16
// moves 14 bytes per node, bf16_ir 20 (x and invd in f32).
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

template <int N, typename S, typename X, typename O, typename A>
__global__ void __launch_bounds__(N * N)
nekbone_pcg_update_kernel(const X* __restrict__ x, const S* __restrict__ p,
                          const S* __restrict__ z, const S* __restrict__ w,
                          const A* __restrict__ alpha,
                          const O* __restrict__ invd,
                          const S* __restrict__ cx, const S* __restrict__ cy,
                          const S* __restrict__ cz, X* __restrict__ x_out,
                          S* __restrict__ z_out, A* __restrict__ rtz,
                          A* __restrict__ rcr, int ex, int ey, int ez) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  __shared__ A red[N2];

  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const int tid = j * N + i;
  const size_t e = blockIdx.x;
  const int ix = static_cast<int>(e % ex);
  const int iy = static_cast<int>((e / ex) % ey);
  const int iz = static_cast<int>(e / (static_cast<size_t>(ex) * ey));
  const size_t base = e * N3 + tid;
  const A a = *alpha;
  const A cyx = convert<A>(cy[iy * N + j]) * convert<A>(cx[ix * N + i]);

  A part_rtz = A(0);
  A part_rcr = A(0);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const size_t o = base + k * N2;
    const A wa = sum_xyz<N>(w, e, k, j, i, ix, iy, iz, ex, ey, ez);
    const A id = convert<A>(invd[o]);
    x_out[o] =
        convert<X>(add_rn(convert<A>(x[o]), mul_rn(a, convert<A>(p[o]))));
    // the stored z, and both partials over exactly it
    const S zs =
        convert<S>(sub_rn(convert<A>(z[o]), mul_rn(a, mul_rn(id, wa))));
    z_out[o] = zs;
    const A zn = convert<A>(zs);
    const A d = rcp_rn(id);
    // c is (cz * cy) * cx, exact in any order (factors 0, 1/2, 1).
    const A c = convert<A>(cz[iz * N + k]) * cyx;
    const A t = mul_rn(mul_rn(mul_rn(zn, c), zn), d);
    part_rtz += t;
    part_rcr += mul_rn(t, d);
  }
  const A total_rtz = block_sum<N2>(part_rtz, red, tid);
  if (tid == 0) rtz[e] = total_rtz;
  __syncthreads();  // red is reused
  const A total_rcr = block_sum<N2>(part_rcr, red, tid);
  if (tid == 0) rcr[e] = total_rcr;
}

template <int N, typename S, typename X, typename O, typename A>
cudaError_t launch(const X* x, const S* p, const S* z, const S* w,
                   const A* alpha, const O* invd, const S* cx, const S* cy,
                   const S* cz, X* x_out, S* z_out, A* rtz, A* rcr, int ex,
                   int ey, int ez, cudaStream_t stream) {
  const int E = ex * ey * ez;
  nekbone_pcg_update_kernel<N, S, X, O, A><<<E, dim3(N, N), 0, stream>>>(
      x, p, z, w, alpha, invd, cx, cy, cz, x_out, z_out, rtz, rcr, ex, ey,
      ez);
  return cudaGetLastError();
}

template <typename S, typename X, typename O, typename A>
int dispatch(const X* x, const S* p, const S* z, const S* w, const A* alpha,
             const O* invd, const S* cx, const S* cy, const S* cz, X* x_out,
             S* z_out, A* rtz, A* rcr, int ex, int ey, int ez, int n,
             void* stream) {
  if (ex <= 0 || ey <= 0 || ez <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N)                                                      \
  case N:                                                                    \
    return static_cast<int>(launch<N, S, X, O, A>(                           \
        x, p, z, w, alpha, invd, cx, cy, cz, x_out, z_out, rtz, rcr, ex, ey, \
        ez, s));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// x, x_out: (E, n^3) in X; p, z, w (unassembled, masked), z_out: (E, n^3)
// in S; invd: (E, n^3) in O; alpha: one value and rtz, rcr: (E,) in A; cx:
// (EX, n), cy: (EY, n), cz: (EZ, n) in S.  Elements z-major over (EX, EY,
// EZ).  Returns cudaGetLastError() after the launch.
#define NEKBONE_PCG_UPDATE_ENTRY(NAME, S, X, O, A)                           \
  extern "C" int NAME(const X* x, const S* p, const S* z, const S* w,       \
                      const A* alpha, const O* invd, const S* cx,           \
                      const S* cy, const S* cz, X* x_out, S* z_out, A* rtz, \
                      A* rcr, int ex, int ey, int ez, int n, void* stream) { \
    return nekbone::dispatch<S, X, O, A>(x, p, z, w, alpha, invd, cx, cy,    \
                                         cz, x_out, z_out, rtz, rcr, ex, ey, \
                                         ez, n, stream);                     \
  }

#ifdef NEKBONE_REAL_F64
NEKBONE_PCG_UPDATE_ENTRY(nekbone_pcg_update_f64, double, double, double,
                         double)
#endif
#ifdef NEKBONE_REAL_F32
NEKBONE_PCG_UPDATE_ENTRY(nekbone_pcg_update_f32, float, float, float, float)
#endif
#ifdef NEKBONE_REAL_BF16
NEKBONE_PCG_UPDATE_ENTRY(nekbone_pcg_update_bf16, __nv_bfloat16,
                         __nv_bfloat16, __nv_bfloat16, float)
#endif
#ifdef NEKBONE_REAL_BF16_IR
NEKBONE_PCG_UPDATE_ENTRY(nekbone_pcg_update_bf16_ir, __nv_bfloat16, float,
                         float, float)
#endif
