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
// memory (common.cuh's sum_xyz, shared with K10 and K11).  The sums follow
// core/gs.ds_sum_local's tree exactly, so the assembled w is bitwise the
// plain version's in fp64 and fp32.
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
//
// Storage and accumulation (common.cuh).  The template takes the storage
// type S of the CG vectors (p, r, w and the c factors), the storage type X
// of the solution and the accumulation type A (alpha, the arithmetic, the
// assembly of w, rcr).  Four builds: f64 and f32 (one type throughout);
// bf16 (S = X = bf16, A = f32) and bf16_ir (S = bf16, X = A = f32: the
// bf16_ir policy keeps x in f32, core/precision.py).  The updated r is
// rounded to storage before r.c.r, as the TPU kernel does
// (nekbone_ax.py:662): the partial is next iteration's beta numerator, and
// that iteration reads the stored r.  w is assembled in A from its bf16
// copies.  bf16 moves 12 bytes per node, bf16_ir 16 (x in f32).
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

template <int N, typename S, typename X, typename A>
__global__ void __launch_bounds__(N * N)
nekbone_cg_update_kernel(const X* __restrict__ x, const S* __restrict__ p,
                         const S* __restrict__ r, const S* __restrict__ w,
                         const A* __restrict__ alpha,
                         const S* __restrict__ cx, const S* __restrict__ cy,
                         const S* __restrict__ cz, X* __restrict__ x_out,
                         S* __restrict__ r_out, A* __restrict__ rcr, int ex,
                         int ey, int ez) {
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

  A part = A(0);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const size_t o = base + k * N2;
    const A wa = sum_xyz<N>(w, e, k, j, i, ix, iy, iz, ex, ey, ez);
    x_out[o] =
        convert<X>(add_rn(convert<A>(x[o]), mul_rn(a, convert<A>(p[o]))));
    // the stored residual, and r.c.r over exactly it (the round trip
    // through S is the identity for f64 and f32)
    const S rs = convert<S>(sub_rn(convert<A>(r[o]), mul_rn(a, wa)));
    r_out[o] = rs;
    const A rn = convert<A>(rs);
    // c is (cz * cy) * cx; the factors are 0, 1/2 or 1, so the product is
    // exact in any order.
    const A c = convert<A>(cz[iz * N + k]) * cyx;
    part += (rn * c) * rn;
  }
  const A total = block_sum<N2>(part, red, tid);
  if (tid == 0) rcr[e] = total;
}

template <int N, typename S, typename X, typename A>
cudaError_t launch(const X* x, const S* p, const S* r, const S* w,
                   const A* alpha, const S* cx, const S* cy, const S* cz,
                   X* x_out, S* r_out, A* rcr, int ex, int ey, int ez,
                   cudaStream_t stream) {
  const int E = ex * ey * ez;
  nekbone_cg_update_kernel<N, S, X, A><<<E, dim3(N, N), 0, stream>>>(
      x, p, r, w, alpha, cx, cy, cz, x_out, r_out, rcr, ex, ey, ez);
  return cudaGetLastError();
}

template <typename S, typename X, typename A>
int dispatch(const void* x, const void* p, const void* r, const void* w,
             const void* alpha, const void* cx, const void* cy,
             const void* cz, void* x_out, void* r_out, void* rcr, int ex,
             int ey, int ez, int n, void* stream) {
  if (ex <= 0 || ey <= 0 || ez <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const X* xs = static_cast<const X*>(x);
  const S* ps = static_cast<const S*>(p);
  const S* rs = static_cast<const S*>(r);
  const S* ws = static_cast<const S*>(w);
  const A* as = static_cast<const A*>(alpha);
  const S* cxs = static_cast<const S*>(cx);
  const S* cys = static_cast<const S*>(cy);
  const S* czs = static_cast<const S*>(cz);
  X* xo = static_cast<X*>(x_out);
  S* ro = static_cast<S*>(r_out);
  A* rc = static_cast<A*>(rcr);
  switch (n) {
#define NEKBONE_CASE(N)                                                     \
  case N:                                                                   \
    return static_cast<int>(launch<N, S, X, A>(xs, ps, rs, ws, as, cxs,     \
                                               cys, czs, xo, ro, rc, ex, ey, \
                                               ez, s));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// x, x_out: (E, n^3) in X; p, r, w (unassembled, masked), r_out: (E, n^3)
// in S; alpha: one value and rcr: (E,) in A; cx: (EX, n), cy: (EY, n), cz:
// (EZ, n) in S.  Elements z-major over (EX, EY, EZ).  Returns
// cudaGetLastError() after the launch.
#define NEKBONE_CG_UPDATE_ENTRY(NAME, S, X, A)                              \
  extern "C" int NAME(const void* x, const void* p, const void* r,          \
                      const void* w, const void* alpha, const void* cx,     \
                      const void* cy, const void* cz, void* x_out,          \
                      void* r_out, void* rcr, int ex, int ey, int ez, int n, \
                      void* stream) {                                       \
    return nekbone::dispatch<S, X, A>(x, p, r, w, alpha, cx, cy, cz, x_out, \
                                      r_out, rcr, ex, ey, ez, n, stream);   \
  }

#ifdef NEKBONE_REAL_F64
NEKBONE_CG_UPDATE_ENTRY(nekbone_cg_update_f64, double, double, double)
#endif
#ifdef NEKBONE_REAL_F32
NEKBONE_CG_UPDATE_ENTRY(nekbone_cg_update_f32, float, float, float)
#endif
#ifdef NEKBONE_REAL_BF16
NEKBONE_CG_UPDATE_ENTRY(nekbone_cg_update_bf16, __nv_bfloat16, __nv_bfloat16,
                        float)
#endif
#ifdef NEKBONE_REAL_BF16_IR
NEKBONE_CG_UPDATE_ENTRY(nekbone_cg_update_bf16_ir, __nv_bfloat16, float,
                        float)
#endif
