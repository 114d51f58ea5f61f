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
// at layer k, takes the node's own copy and, on a face, edge or corner, the
// coincident copies in the neighbouring elements.  The sums follow
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
// Design (common.cuh's update walkers, the skeleton of K4's).  One block of
// n x n threads per element, with every thread loading one value per field
// per layer, left too few bytes in flight (in bf16 above all: 2 bytes a
// load), branched inside a warp on face, edge and corner nodes (each path
// waiting for its own loads) and ran 7.8 blocks an SM in one ragged wave at
// E=1024.  Here:
//
// * persistent blocks, one wave: kernels/nekbone_ax.k5_plan sizes the grid
//   from the occupancy calculator; block b owns the z-major elements
//   [b * per_block, (b + 1) * per_block) and walks them;
// * a ring of two stages in dynamic shared memory holds the next element's
//   x, p, r and its own copy of w while the current one is updated (n = 10:
//   2 x 32,000 bytes in fp64, 2 x 8,000 in bf16): one thread's TMA bulk
//   copies where n is even, per-thread cp.async where it is odd;
// * the neighbours' copies of w are read through L2 by predicated loads
//   that every thread issues alike (common.cuh sum_xyz_nc), paired as
//   sum_xyz pairs them;
// * a thread assembles its column's n values of w before it stores
//   anything, so that an item's neighbour loads are in flight together
//   and none waits behind a store; the walk steps its items' grid
//   coordinates and its ring's stage and phase instead of dividing for
//   each item (common.cuh ItemPos, ring_fill_stage), and where the plan
//   stages every operand by bulk copies (n even) it runs a walk that knows
//   so at compile time: the kernel issues few instructions a byte, so
//   instructions, not the ring, set its time;
// * the partials go through block_sum's tree with its last steps as warp
//   shuffles (block_sum_shfl: the same pairs, two barriers for eight).
//
// The arithmetic is the one-block-per-element kernel's: x and r bitwise,
// and rcr too (each column's partial in k order, then block_sum's pairs).
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
__global__ void __launch_bounds__(N * N, kWalkMinBlocks<N, A>)
nekbone_cg_update_kernel(const UpdateArgs<S, X, A> a) {
  __shared__ A red[2 * N * N];
  __shared__ unsigned long long full[kMaxStages];
  extern __shared__ __align__(128) unsigned char ring_bytes[];
  if (a.plan.bulk && a.plan.staged == 15)
    cg_update_walk<N, true>(a, full, ring_bytes, red);
  else
    cg_update_walk<N, false>(a, full, ring_bytes, red);
}

// The planes instantiation: a sharded solve's shard, whose bottom and top
// element layers take a neighbour shard's x,y-assembled edge plane in the z
// step (common.cuh EdgePlanes, sum_xyz_nc_planes).  The kernel above is the
// walk without that operand, so its code is the single-shard kernel's.
template <int N, typename S, typename X, typename A>
__global__ void __launch_bounds__(N * N, kWalkMinBlocks<N, A>)
nekbone_cg_update_planes_kernel(const UpdateArgs<S, X, A> a,
                                const EdgePlanes<A> pl) {
  __shared__ A red[2 * N * N];
  __shared__ unsigned long long full[kMaxStages];
  extern __shared__ __align__(128) unsigned char ring_bytes[];
  if (a.plan.bulk && a.plan.staged == 15)
    cg_update_walk<N, true>(a, full, ring_bytes, red, pl);
  else
    cg_update_walk<N, false>(a, full, ring_bytes, red, pl);
}

// P is empty for the single-shard kernel, or EdgePlanes<A> for the planes
// kernel, which runs on the single-shard kernel's plan (the same walk, ring
// and register cap).
template <int N, typename S, typename X, typename A, typename... P>
const void* kernel_fn() {
  if constexpr (sizeof...(P) == 0)
    return reinterpret_cast<const void*>(
        &nekbone_cg_update_kernel<N, S, X, A>);
  else
    return reinterpret_cast<const void*>(
        &nekbone_cg_update_planes_kernel<N, S, X, A>);
}

// out: common.cuh coop_query's seven values for this instantiation.
template <int N, typename S, typename X, typename A>
cudaError_t query(int dyn, int* out) {
  return coop_query(kernel_fn<N, S, X, A>(), N * N, 1, dyn, out);
}

template <int N, typename S, typename X, typename A, typename... P>
cudaError_t launch(const UpdateArgs<S, X, A>& a, int grid,
                   cudaStream_t stream, const P&... pl) {
  const long long E = static_cast<long long>(a.ex) * a.ey * a.ez;
  int dyn = 0;
  if (!update_plan_ok<N>(a, E, grid, dyn)) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel_fn<N, S, X, A, P...>(),
      cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return err;
  if constexpr (sizeof...(P) == 0)
    nekbone_cg_update_kernel<N, S, X, A><<<grid, dim3(N, N), dyn, stream>>>(a);
  else
    nekbone_cg_update_planes_kernel<N, S, X, A>
        <<<grid, dim3(N, N), dyn, stream>>>(a, pl...);
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

template <typename S, typename X, typename A, typename... P>
int dispatch(const UpdateArgs<S, X, A>& a, int n, int grid, void* stream,
             const P&... pl) {
  if (a.ex <= 0 || a.ey <= 0 || a.ez <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N) \
  case N:               \
    return static_cast<int>(launch<N, S, X, A>(a, grid, s, pl...));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// x, x_out: (E, n^3) in X; p, r, w (unassembled, masked), r_out: (E, n^3)
// in S; alpha: one value and rcr: (E,) in A; cx: (EX, n), cy: (EY, n), cz:
// (EZ, n) in S.  Elements z-major over (EX, EY, EZ).  The plan (per_block,
// grid, stages, staged, bulk) is kernels/nekbone_ax.k5_plan's; a plan the
// pointers do not allow returns cudaErrorInvalidValue.  Returns
// cudaGetLastError() after the launch.
//
// nekbone_cg_update_planes_<dtype>(..., rcr, below, above, ex, ...): the
// same launch with a sharded solve's edge planes below, above: (EY*EX, n, n)
// in A, or null at a global end (common.cuh EdgePlanes).
//
// nekbone_cg_update_query_<dtype>(n, resident, dyn, out): fills out[7] as
// common.cuh coop_query documents (resident is ignored); returns a CUDA
// error, or 0.
#define NEKBONE_CG_UPDATE_ENTRY(SUFFIX, S, X, A)                              \
  extern "C" int nekbone_cg_update_##SUFFIX(                                  \
      const void* x, const void* p, const void* r, const void* w,             \
      const void* alpha, const void* cx, const void* cy, const void* cz,      \
      void* x_out, void* r_out, void* rcr, int ex, int ey, int ez, int n,     \
      int per_block, int grid, int stages, int staged, int bulk,              \
      void* stream) {                                                         \
    const nekbone::UpdateArgs<S, X, A> a{                                     \
        static_cast<const X*>(x),     static_cast<const S*>(p),               \
        static_cast<const S*>(r),     static_cast<const S*>(w),               \
        static_cast<const A*>(alpha), static_cast<const S*>(cx),              \
        static_cast<const S*>(cy),    static_cast<const S*>(cz),              \
        static_cast<X*>(x_out),       static_cast<S*>(r_out),                 \
        static_cast<A*>(rcr),         ex, ey, ez, /*lanes=*/1,                \
        {per_block, stages, staged, bulk}};                                   \
    return nekbone::dispatch<S, X, A>(a, n, grid, stream);                    \
  }                                                                           \
  extern "C" int nekbone_cg_update_planes_##SUFFIX(                           \
      const void* x, const void* p, const void* r, const void* w,             \
      const void* alpha, const void* cx, const void* cy, const void* cz,      \
      void* x_out, void* r_out, void* rcr, const void* below,                 \
      const void* above, int ex, int ey, int ez, int n, int per_block,        \
      int grid, int stages, int staged, int bulk, void* stream) {             \
    const nekbone::UpdateArgs<S, X, A> a{                                     \
        static_cast<const X*>(x),     static_cast<const S*>(p),               \
        static_cast<const S*>(r),     static_cast<const S*>(w),               \
        static_cast<const A*>(alpha), static_cast<const S*>(cx),              \
        static_cast<const S*>(cy),    static_cast<const S*>(cz),              \
        static_cast<X*>(x_out),       static_cast<S*>(r_out),                 \
        static_cast<A*>(rcr),         ex, ey, ez, /*lanes=*/1,                \
        {per_block, stages, staged, bulk}};                                   \
    const nekbone::EdgePlanes<A> pl{static_cast<const A*>(below),             \
                                    static_cast<const A*>(above)};            \
    return nekbone::dispatch<S, X, A>(a, n, grid, stream, pl);                \
  }                                                                           \
  extern "C" int nekbone_cg_update_query_##SUFFIX(int n, int resident,        \
                                                  int dyn, int* out) {        \
    (void)resident;                                                           \
    return nekbone::dispatch_query<S, X, A>(n, dyn, out);                     \
  }

#ifdef NEKBONE_REAL_F64
NEKBONE_CG_UPDATE_ENTRY(f64, double, double, double)
#endif
#ifdef NEKBONE_REAL_F32
NEKBONE_CG_UPDATE_ENTRY(f32, float, float, float)
#endif
#ifdef NEKBONE_REAL_BF16
NEKBONE_CG_UPDATE_ENTRY(bf16, __nv_bfloat16, __nv_bfloat16, float)
#endif
#ifdef NEKBONE_REAL_BF16_IR
NEKBONE_CG_UPDATE_ENTRY(bf16_ir, __nv_bfloat16, float, float)
#endif
