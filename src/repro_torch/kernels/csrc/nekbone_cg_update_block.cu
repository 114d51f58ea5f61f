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
// (pallas_call at :918).
//
// Design: K5's walker (nekbone_cg_update.cu, common.cuh's update walkers)
// over b x E work items, item q = l * E + e, its fields at q * n^3 of each
// (b, E, n^3) operand.  The items are lane-major, so block ranges cut across
// the lanes and all b lanes are in flight across the grid together;
// kernels/nekbone_ax.k7_plan sizes the grid for b E items.  Each item reads
// its own alpha[l] and writes rcr at (l, e).  The kernel this replaced ran
// one block per element that looped over the lanes in series, each lane
// ending in a block sum; it kept the neighbour addresses inside the loop
// with an opaque copy of the element index, and took at b = 4 in bf16 about
// the fp64 kernel's time on a quarter of the bytes.
//
// Every item goes through K5's function (common.cuh cg_update_item): the
// same gathers in core/gs.ds_sum_local's tree, the same rounded,
// uncontracted axpys, the same partial sum.  So each lane's x, r and rcr
// are bitwise K5's on that lane.
//
// Bound: bytes.  Per lane x, p, r, w in and x, r out: 6 fields of 8.19 MB
// at E=1024, n=10, fp64, 196.6 MB at b=4 (58.7 us at 3.35 TB/s).  K5 has no
// operator stream to share, so the batch saves only launches here.  rcr
// leaves as (b, E) values, summed per lane outside.
//
// Storage and accumulation (common.cuh), K5's roles: S the CG vectors (p,
// r, w and the c factors), X the solution, A alpha, the arithmetic, the
// assembly of w and rcr.  Four builds: f64 and f32 (one type throughout);
// bf16 (S = X = bf16, A = f32) and bf16_ir (S = bf16, X = A = f32).  At b=4
// bf16 moves 48 bytes a node, bf16_ir 64 (x in f32).
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

template <int N, typename S, typename X, typename A>
__global__ void __launch_bounds__(N * N, kWalkMinBlocks<N, A>)
nekbone_cg_update_block_kernel(const UpdateArgs<S, X, A> a) {
  __shared__ A red[2 * N * N];
  __shared__ unsigned long long full[kMaxStages];
  extern __shared__ __align__(128) unsigned char ring_bytes[];
  if (a.plan.bulk && a.plan.staged == 15)
    cg_update_walk<N, true>(a, full, ring_bytes, red);
  else
    cg_update_walk<N, false>(a, full, ring_bytes, red);
}

template <int N, typename S, typename X, typename A>
const void* kernel_fn() {
  return reinterpret_cast<const void*>(
      &nekbone_cg_update_block_kernel<N, S, X, A>);
}

// out: common.cuh coop_query's seven values for this instantiation.
template <int N, typename S, typename X, typename A>
cudaError_t query(int dyn, int* out) {
  return coop_query(kernel_fn<N, S, X, A>(), N * N, 1, dyn, out);
}

template <int N, typename S, typename X, typename A>
cudaError_t launch(const UpdateArgs<S, X, A>& a, int grid,
                   cudaStream_t stream) {
  const long long items =
      static_cast<long long>(a.ex) * a.ey * a.ez * a.lanes;
  int dyn = 0;
  if (!update_plan_ok<N>(a, items, grid, dyn)) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel_fn<N, S, X, A>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
      dyn);
  if (err != cudaSuccess) return err;
  nekbone_cg_update_block_kernel<N, S, X, A>
      <<<grid, dim3(N, N), dyn, stream>>>(a);
  return cudaGetLastError();
}

template <typename S, typename X, typename A>
int dispatch_query(int n, int dyn, int* out) {
  switch (n) {
#define NEKBONE_CASE(N) \
  case N:               \
    return static_cast<int>(query<N, S, X, A>(dyn, out));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename S, typename X, typename A>
int dispatch(const UpdateArgs<S, X, A>& a, int n, int grid, void* stream) {
  if (a.ex <= 0 || a.ey <= 0 || a.ez <= 0 || a.lanes <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N) \
  case N:               \
    return static_cast<int>(launch<N, S, X, A>(a, grid, s));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// x, x_out: (b, E, n^3) in X; p, r, w (unassembled, masked), r_out: (b, E,
// n^3) in S; alpha: (b,) and rcr: (b, E) in A; cx: (EX, n), cy: (EY, n),
// cz: (EZ, n) in S.  Elements z-major over (EX, EY, EZ).  The plan
// (per_block, grid, stages, staged, bulk) is kernels/nekbone_ax.k7_plan's,
// over b E items; a plan the pointers do not allow returns
// cudaErrorInvalidValue.  Returns cudaGetLastError() after the launch.
//
// nekbone_cg_update_block_query_<dtype>(n, resident, dyn, out): fills
// out[7] as common.cuh coop_query documents (resident is ignored); returns
// a CUDA error, or 0.
#define NEKBONE_CG_UPDATE_BLOCK_ENTRY(SUFFIX, S, X, A)                        \
  extern "C" int nekbone_cg_update_block_##SUFFIX(                            \
      const void* x, const void* p, const void* r, const void* w,             \
      const void* alpha, const void* cx, const void* cy, const void* cz,      \
      void* x_out, void* r_out, void* rcr, int ex, int ey, int ez, int n,     \
      int nrhs, int per_block, int grid, int stages, int staged, int bulk,    \
      void* stream) {                                                         \
    const nekbone::UpdateArgs<S, X, A> a{                                     \
        static_cast<const X*>(x),     static_cast<const S*>(p),               \
        static_cast<const S*>(r),     static_cast<const S*>(w),               \
        static_cast<const A*>(alpha), static_cast<const S*>(cx),              \
        static_cast<const S*>(cy),    static_cast<const S*>(cz),              \
        static_cast<X*>(x_out),       static_cast<S*>(r_out),                 \
        static_cast<A*>(rcr),         ex, ey, ez, nrhs,                       \
        {per_block, stages, staged, bulk}};                                   \
    return nekbone::dispatch<S, X, A>(a, n, grid, stream);                    \
  }                                                                           \
  extern "C" int nekbone_cg_update_block_query_##SUFFIX(int n, int resident,  \
                                                        int dyn, int* out) {  \
    (void)resident;                                                           \
    return nekbone::dispatch_query<S, X, A>(n, dyn, out);                     \
  }

#ifdef NEKBONE_REAL_F64
NEKBONE_CG_UPDATE_BLOCK_ENTRY(f64, double, double, double)
#endif
#ifdef NEKBONE_REAL_F32
NEKBONE_CG_UPDATE_BLOCK_ENTRY(f32, float, float, float)
#endif
#ifdef NEKBONE_REAL_BF16
NEKBONE_CG_UPDATE_BLOCK_ENTRY(bf16, __nv_bfloat16, __nv_bfloat16, float)
#endif
#ifdef NEKBONE_REAL_BF16_IR
NEKBONE_CG_UPDATE_BLOCK_ENTRY(bf16_ir, __nv_bfloat16, float, float)
#endif
