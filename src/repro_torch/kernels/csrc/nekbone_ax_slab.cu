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
//
// Storage and accumulation (common.cuh).  The template takes the storage
// type S of the CG vectors (p, r, w and the mask factors), the storage type
// O of the operator's data (D, metric) and the accumulation type A (beta,
// the arithmetic, pap).  Four builds: f64 and f32 (one type throughout);
// bf16 (S = O = bf16, A = f32) and bf16_ir (S = bf16, O = A = f32: the
// bf16_ir policy keeps the operator in f32, core/precision.py).  In bf16
// the direction is rounded to storage before the operator, as the TPU
// kernel does (nekbone_ax.py:519): K5 applies alpha to the stored p, so w
// must be A of exactly that vector.  w leaves rounded to bf16; pap is f32,
// over the unrounded w.  bf16 moves 14 bytes per node (p, r, p out, w out
// in bf16; the metric diagonal in bf16), bf16_ir 20 (the metric in f32).
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

template <int N, typename S, typename O, typename A>
__global__ void __launch_bounds__(N * N)
nekbone_ax_slab_kernel(const S* __restrict__ p_prev, const S* __restrict__ r,
                       const O* __restrict__ D, const O* __restrict__ g3,
                       const S* __restrict__ mx, const S* __restrict__ my,
                       const S* __restrict__ mz, const A* __restrict__ beta,
                       S* __restrict__ p_out, S* __restrict__ w,
                       A* __restrict__ pap, int ex, int ey) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  __shared__ AxShared<N, A> sh;
  __shared__ A red[N2];

  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const int tid = j * N + i;
  const size_t e = blockIdx.x;
  const int ix = static_cast<int>(e % ex);
  const int iy = static_cast<int>((e / ex) % ey);
  const int iz = static_cast<int>(e / (static_cast<size_t>(ex) * ey));
  const size_t base = e * N3 + tid;

  load_D(sh, D, i, j);
  const A b = *beta;
  A pc[N];
  A wc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    // the stored direction, and the operator applied to exactly it (the
    // round trip through S is the identity for f64 and f32)
    const size_t o = base + k * N2;
    const S ps =
        convert<S>(add_rn(convert<A>(r[o]), mul_rn(b, convert<A>(p_prev[o]))));
    p_out[o] = ps;
    pc[k] = convert<A>(ps);
  }
  ax_diag_columns(sh, g3 + e * 3 * N3 + tid, pc, wc, i, j);

  const A myx = convert<A>(my[iy * N + j]) * convert<A>(mx[ix * N + i]);
  A part = A(0);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    // the box mask is (mz * my) * mx; all factors are 0 or 1, so any order
    // of the product is exact.
    const A v = wc[k] * (convert<A>(mz[iz * N + k]) * myx);
    part += pc[k] * v;
    w[base + k * N2] = convert<S>(v);
  }
  const A total = block_sum<N2>(part, red, tid);
  if (tid == 0) pap[e] = total;
}

template <int N, typename S, typename O, typename A>
cudaError_t launch(const S* p_prev, const S* r, const O* D, const O* g3,
                   const S* mx, const S* my, const S* mz, const A* beta,
                   S* p_out, S* w, A* pap, int ex, int ey, int ez,
                   cudaStream_t stream) {
  const int E = ex * ey * ez;
  nekbone_ax_slab_kernel<N, S, O, A><<<E, dim3(N, N), 0, stream>>>(
      p_prev, r, D, g3, mx, my, mz, beta, p_out, w, pap, ex, ey);
  return cudaGetLastError();
}

template <typename S, typename O, typename A>
int dispatch(const void* p_prev, const void* r, const void* D, const void* g3,
             const void* mx, const void* my, const void* mz,
             const void* beta, void* p_out, void* w, void* pap, int ex,
             int ey, int ez, int n, void* stream) {
  if (ex <= 0 || ey <= 0 || ez <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const S* ps = static_cast<const S*>(p_prev);
  const S* rs = static_cast<const S*>(r);
  const O* Ds = static_cast<const O*>(D);
  const O* gs = static_cast<const O*>(g3);
  const S* mxs = static_cast<const S*>(mx);
  const S* mys = static_cast<const S*>(my);
  const S* mzs = static_cast<const S*>(mz);
  const A* bs = static_cast<const A*>(beta);
  S* po = static_cast<S*>(p_out);
  S* wo = static_cast<S*>(w);
  A* pa = static_cast<A*>(pap);
  switch (n) {
#define NEKBONE_CASE(N)                                                    \
  case N:                                                                  \
    return static_cast<int>(launch<N, S, O, A>(ps, rs, Ds, gs, mxs, mys,   \
                                               mzs, bs, po, wo, pa, ex, ey, \
                                               ez, s));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// p_prev, r, p_out, w: (E, n^3) in S; D: (n, n) and g3: (E, 3, n^3) in O;
// mx: (EX, n), my: (EY, n), mz: (EZ, n) in S; beta: one value and pap: (E,)
// in A.  Elements z-major over (EX, EY, EZ).  Returns cudaGetLastError()
// after the launch.
#define NEKBONE_AX_SLAB_ENTRY(NAME, S, O, A)                                 \
  extern "C" int NAME(const void* p_prev, const void* r, const void* D,      \
                      const void* g3, const void* mx, const void* my,        \
                      const void* mz, const void* beta, void* p_out, void* w, \
                      void* pap, int ex, int ey, int ez, int n,              \
                      void* stream) {                                        \
    return nekbone::dispatch<S, O, A>(p_prev, r, D, g3, mx, my, mz, beta,    \
                                      p_out, w, pap, ex, ey, ez, n, stream); \
  }

#ifdef NEKBONE_REAL_F64
NEKBONE_AX_SLAB_ENTRY(nekbone_ax_slab_f64, double, double, double)
#endif
#ifdef NEKBONE_REAL_F32
NEKBONE_AX_SLAB_ENTRY(nekbone_ax_slab_f32, float, float, float)
#endif
#ifdef NEKBONE_REAL_BF16
NEKBONE_AX_SLAB_ENTRY(nekbone_ax_slab_bf16, __nv_bfloat16, __nv_bfloat16,
                      float)
#endif
#ifdef NEKBONE_REAL_BF16_IR
NEKBONE_AX_SLAB_ENTRY(nekbone_ax_slab_bf16_ir, __nv_bfloat16, float, float)
#endif
