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
//
// Storage and accumulation (common.cuh), K5's roles: S the CG vectors (p,
// r, w and the c factors), X the solution, A alpha, the arithmetic, the
// assembly of w and rcr.  Four builds: f64 and f32 (one type throughout);
// bf16 (S = X = bf16, A = f32) and bf16_ir (S = bf16, X = A = f32).  Each
// lane rounds as K5 does: w is assembled in A from its S copies and the
// updated r is rounded to S before r.c.r (the next iteration reads the
// stored r), so each bf16 lane is bitwise the bf16 K5's on that lane.  At
// b=4 bf16 moves 48 bytes a node, bf16_ir 64 (x in f32).
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

template <int N, typename S, typename X, typename A>
__global__ void __launch_bounds__(N * N)
nekbone_cg_update_block_kernel(const X* __restrict__ x,
                               const S* __restrict__ p,
                               const S* __restrict__ r,
                               const S* __restrict__ w,
                               const A* __restrict__ alpha,
                               const S* __restrict__ cx,
                               const S* __restrict__ cy,
                               const S* __restrict__ cz,
                               X* __restrict__ x_out, S* __restrict__ r_out,
                               A* __restrict__ rcr, int ex, int ey, int ez,
                               int nrhs) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  __shared__ A red[N2];

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
  const A cyx = convert<A>(cy[iy * N + j]) * convert<A>(cx[ix * N + i]);

  for (int l = 0; l < nrhs; ++l) {
    // opaque to nvcc: the neighbour addresses are recomputed per lane, not
    // hoisted out of the loop and held live across it
    size_t el = e;
    asm volatile("" : "+l"(el));
    const size_t lane = l * E * N3;
    const size_t base = lane + el * N3 + tid;
    const S* wl = w + lane;
    const A a = alpha[l];
    A part = A(0);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const size_t o = base + k * N2;
      const A wa = sum_xyz<N>(wl, el, k, j, i, ix, iy, iz, ex, ey, ez);
      x_out[o] =
          convert<X>(add_rn(convert<A>(x[o]), mul_rn(a, convert<A>(p[o]))));
      // the stored residual, and r.c.r over exactly it (the round trip
      // through S is the identity for f64 and f32)
      const S rs = convert<S>(sub_rn(convert<A>(r[o]), mul_rn(a, wa)));
      r_out[o] = rs;
      const A rn = convert<A>(rs);
      const A c = convert<A>(cz[iz * N + k]) * cyx;
      part += (rn * c) * rn;
    }
    const A total = block_sum<N2>(part, red, tid);
    if (tid == 0) rcr[l * E + e] = total;
  }
}

template <int N, typename S, typename X, typename A>
cudaError_t launch(const X* x, const S* p, const S* r, const S* w,
                   const A* alpha, const S* cx, const S* cy, const S* cz,
                   X* x_out, S* r_out, A* rcr, int ex, int ey, int ez,
                   int nrhs, cudaStream_t stream) {
  const int E = ex * ey * ez;
  nekbone_cg_update_block_kernel<N, S, X, A><<<E, dim3(N, N), 0, stream>>>(
      x, p, r, w, alpha, cx, cy, cz, x_out, r_out, rcr, ex, ey, ez, nrhs);
  return cudaGetLastError();
}

template <typename S, typename X, typename A>
int dispatch(const X* x, const S* p, const S* r, const S* w, const A* alpha,
             const S* cx, const S* cy, const S* cz, X* x_out, S* r_out,
             A* rcr, int ex, int ey, int ez, int n, int nrhs, void* stream) {
  if (ex <= 0 || ey <= 0 || ez <= 0 || nrhs <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N)                                                      \
  case N:                                                                    \
    return static_cast<int>(launch<N, S, X, A>(x, p, r, w, alpha, cx, cy,    \
                                               cz, x_out, r_out, rcr, ex,    \
                                               ey, ez, nrhs, s));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// x, x_out: (b, E, n^3) in X; p, r, w (unassembled, masked), r_out: (b, E,
// n^3) in S; alpha: (b,) and rcr: (b, E) in A; cx: (EX, n), cy: (EY, n),
// cz: (EZ, n) in S.  Elements z-major over (EX, EY, EZ).  Returns
// cudaGetLastError() after the launch.
#define NEKBONE_CG_UPDATE_BLOCK_ENTRY(NAME, S, X, A)                         \
  extern "C" int NAME(const void* x, const void* p, const void* r,          \
                      const void* w, const void* alpha, const void* cx,     \
                      const void* cy, const void* cz, void* x_out,          \
                      void* r_out, void* rcr, int ex, int ey, int ez, int n, \
                      int nrhs, void* stream) {                             \
    return nekbone::dispatch<S, X, A>(                                      \
        static_cast<const X*>(x), static_cast<const S*>(p),                 \
        static_cast<const S*>(r), static_cast<const S*>(w),                 \
        static_cast<const A*>(alpha), static_cast<const S*>(cx),            \
        static_cast<const S*>(cy), static_cast<const S*>(cz),               \
        static_cast<X*>(x_out), static_cast<S*>(r_out),                     \
        static_cast<A*>(rcr), ex, ey, ez, n, nrhs, stream);                 \
  }

#ifdef NEKBONE_REAL_F64
NEKBONE_CG_UPDATE_BLOCK_ENTRY(nekbone_cg_update_block_f64, double, double,
                              double)
#endif
#ifdef NEKBONE_REAL_F32
NEKBONE_CG_UPDATE_BLOCK_ENTRY(nekbone_cg_update_block_f32, float, float,
                              float)
#endif
#ifdef NEKBONE_REAL_BF16
NEKBONE_CG_UPDATE_BLOCK_ENTRY(nekbone_cg_update_block_bf16, __nv_bfloat16,
                              __nv_bfloat16, float)
#endif
#ifdef NEKBONE_REAL_BF16_IR
NEKBONE_CG_UPDATE_BLOCK_ENTRY(nekbone_cg_update_block_bf16_ir,
                              __nv_bfloat16, float, float)
#endif
