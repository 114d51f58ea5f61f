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
// * this kernel works element by element (an n x n thread layer marching
//   an element's k layers, the layer loop in ax_diag_columns' order) and
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
// Design (common.cuh's walkers).  One block per element, each loading its
// columns, sweeping the operator and storing in series, left the sweep and
// the traffic unoverlapped, 1.29 waves of blocks at E=1024 and the
// operator's shared-memory reads of D on every node.  Here:
//
// * persistent blocks, one wave: kernels/nekbone_ax.k4_plan sizes the grid
//   from the occupancy calculator; block b owns the z-major elements
//   [b * per_block, (b + 1) * per_block) and walks them (an ordinary
//   launch: no block waits for another);
// * a ring of stages (two) in dynamic shared memory holds the next
//   element's p_prev, r and metric diagonals (operands 0, 1, 2) while the
//   operator sweeps the current one: one thread's TMA bulk copies where n is
//   even, per-thread cp.async where it is odd, each stage completed on an
//   mbarrier.  The planner stages what fits two blocks an SM (all three at
//   n = 10 in every build); an operand it does not stage is read from
//   device memory, prefetched to L2 one element ahead;
// * thread (i, j) holds D's rows i, j and columns i, j in registers
//   (common.cuh DRegs, 4n values); only the broadcast row D[k][.] and the
//   layers go through shared memory.  __launch_bounds__ asks for two blocks
//   an SM at n = 10 in fp64 (255 registers a thread) and four in f32 and
//   bf16 (128; common.cuh kWalkMinBlocks).
//
// Every product and sum of a node is taken in ax_diag_columns' order and
// pap goes through block_sum<N*N>'s tree, so p, w and pap are bitwise the
// kernel of one block per element (and K6's lanes stay bitwise K4's).
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

// The operands of one launch, passed by value.
template <typename S, typename O, typename A>
struct SlabArgs {
  const S* p_prev;
  const S* r;
  const O* D;
  const O* g3;
  const S* mx;
  const S* my;
  const S* mz;
  const A* beta;
  S* p_out;
  S* w;
  A* pap;
  int ex, ey, ez;
  WalkPlan plan;
};

// Operands 0, 1, 2 of the ring: p_prev, r (n^3 values in S) and the metric
// diagonals (3 n^3 in O) of one element; their bytes and value sizes.
template <int N, typename S, typename O>
__host__ __device__ __forceinline__ void slab_operands(int (&bytes)[3],
                                                       int (&size)[3]) {
  constexpr int kS = static_cast<int>(sizeof(S));
  constexpr int kO = static_cast<int>(sizeof(O));
  bytes[0] = bytes[1] = N * N * N * kS;
  bytes[2] = 3 * N * N * N * kO;
  size[0] = size[1] = kS;
  size[2] = kO;
}

template <int N, typename S, typename O, typename A>
__global__ void __launch_bounds__(N * N, kWalkMinBlocks<N, A>)
nekbone_ax_slab_kernel(const SlabArgs<S, O, A> a) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  __shared__ AxShared<N, A> sh;
  __shared__ A red[N2];
  __shared__ unsigned long long full[kMaxStages];
  extern __shared__ __align__(128) unsigned char ring_bytes[];

  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const int tid = j * N + i;
  const size_t E = static_cast<size_t>(a.ex) * a.ey * a.ez;
  size_t first, last;
  walk_range(E, a.plan.per_block, first, last);
  const int count = static_cast<int>(last - first);
  const void* const src[3] = {a.p_prev, a.r, a.g3};
  int bytes[3], size[3];
  slab_operands<N, S, O>(bytes, size);
  WalkRing<3> ring(full, ring_bytes, a.plan, src, bytes, size);
  ring.init(tid, N2);
  load_D(sh, a.D, i, j);
  DRegs<N, A> dr;
  dr.load(a.D, i, j);
  const A b = *a.beta;
  __syncthreads();
  for (int t = 0; t < a.plan.stages && t < count; ++t)
    ring.fill(t, first + t, tid, N2);

  for (int t = 0; t < count; ++t) {
    const size_t e = first + t;
    if (t + 1 < count) ring.prefetch(e + 1, tid, N2);
    const int ix = static_cast<int>(e % a.ex);
    const int iy = static_cast<int>((e / a.ex) % a.ey);
    const int iz = static_cast<int>(e / (static_cast<size_t>(a.ex) * a.ey));
    const size_t base = e * N3 + tid;
    ring.wait(t);
    const S* pp = ring.at<S>(0, t, e) + tid;
    const S* rr = ring.at<S>(1, t, e) + tid;
    const O* ge = ring.at<O>(2, t, e) + tid;
    A pc[N];
    A wc[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      // the stored direction, and the operator applied to exactly it (the
      // round trip through S is the identity for f64 and f32)
      const S ps = convert<S>(
          add_rn(convert<A>(rr[k * N2]), mul_rn(b, convert<A>(pp[k * N2]))));
      a.p_out[base + k * N2] = ps;
      pc[k] = convert<A>(ps);
    }
    ax_columns_dregs(
        sh, dr,
        [ge](int k, A wr, A ws, A wt, A& ur, A& us, A& ut) {
          ur = convert<A>(ge[0 * N3 + k * N2]) * wr;
          us = convert<A>(ge[1 * N3 + k * N2]) * ws;
          ut = convert<A>(ge[2 * N3 + k * N2]) * wt;
        },
        pc, wc, i, j);

    const A myx =
        convert<A>(a.my[iy * N + j]) * convert<A>(a.mx[ix * N + i]);
    A part = A(0);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      // the box mask is (mz * my) * mx; all factors are 0 or 1, so any
      // order of the product is exact.
      const A v = wc[k] * (convert<A>(a.mz[iz * N + k]) * myx);
      part += pc[k] * v;
      a.w[base + k * N2] = convert<S>(v);
    }
    const A total = block_sum<N2>(part, red, tid);
    if (tid == 0) a.pap[e] = total;
    // block_sum's barriers: no thread reads this element's stage any more
    if (t + a.plan.stages < count)
      ring.fill(t + a.plan.stages, e + a.plan.stages, tid, N2);
  }
}

template <int N, typename S, typename O, typename A>
const void* kernel_fn() {
  return reinterpret_cast<const void*>(&nekbone_ax_slab_kernel<N, S, O, A>);
}

// out: common.cuh coop_query's seven values for this instantiation.
template <int N, typename S, typename O, typename A>
cudaError_t query(int dyn, int* out) {
  return coop_query(kernel_fn<N, S, O, A>(), N * N, 1, dyn, out);
}

template <int N, typename S, typename O, typename A>
cudaError_t launch(const SlabArgs<S, O, A>& a, int grid,
                   cudaStream_t stream) {
  const void* const src[3] = {a.p_prev, a.r, a.g3};
  int bytes[3], size[3];
  slab_operands<N, S, O>(bytes, size);
  const long long E = static_cast<long long>(a.ex) * a.ey * a.ez;
  if (!walk_plan_ok(a.plan, E, grid, src, bytes, size))
    return cudaErrorInvalidValue;
  const int dyn = walk_ring_bytes(a.plan, bytes);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel_fn<N, S, O, A>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
      dyn);
  if (err != cudaSuccess) return err;
  nekbone_ax_slab_kernel<N, S, O, A><<<grid, dim3(N, N), dyn, stream>>>(a);
  return cudaGetLastError();
}

template <typename S, typename O, typename A>
int dispatch_query(int n, int dyn, int* out) {
  switch (n) {
#define NEKBONE_CASE(N) \
  case N:               \
    return static_cast<int>(query<N, S, O, A>(dyn, out));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename S, typename O, typename A>
int dispatch(const SlabArgs<S, O, A>& a, int n, int grid, void* stream) {
  if (a.ex <= 0 || a.ey <= 0 || a.ez <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N) \
  case N:               \
    return static_cast<int>(launch<N, S, O, A>(a, grid, s));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// p_prev, r, p_out, w: (E, n^3) in S; D: (n, n) and g3: (E, 3, n^3) in O;
// mx: (EX, n), my: (EY, n), mz: (EZ, n) in S; beta: one value and pap: (E,)
// in A.  Elements z-major over (EX, EY, EZ).  The plan (per_block, grid,
// stages, staged, bulk) is kernels/nekbone_ax.k4_plan's; a plan the
// pointers do not allow returns cudaErrorInvalidValue.  Returns
// cudaGetLastError() after the launch.
//
// nekbone_ax_slab_query_<dtype>(n, resident, dyn, out): fills out[7] as
// common.cuh coop_query documents (resident is ignored); returns a CUDA
// error, or 0.
#define NEKBONE_AX_SLAB_ENTRY(SUFFIX, S, O, A)                                \
  extern "C" int nekbone_ax_slab_##SUFFIX(                                    \
      const void* p_prev, const void* r, const void* D, const void* g3,       \
      const void* mx, const void* my, const void* mz, const void* beta,       \
      void* p_out, void* w, void* pap, int ex, int ey, int ez, int n,         \
      int per_block, int grid, int stages, int staged, int bulk,              \
      void* stream) {                                                         \
    const nekbone::SlabArgs<S, O, A> a{                                       \
        static_cast<const S*>(p_prev), static_cast<const S*>(r),              \
        static_cast<const O*>(D),      static_cast<const O*>(g3),             \
        static_cast<const S*>(mx),     static_cast<const S*>(my),             \
        static_cast<const S*>(mz),     static_cast<const A*>(beta),           \
        static_cast<S*>(p_out),        static_cast<S*>(w),                    \
        static_cast<A*>(pap),          ex,                                    \
        ey,                            ez,                                    \
        {per_block, stages, staged, bulk}};                                   \
    return nekbone::dispatch<S, O, A>(a, n, grid, stream);                    \
  }                                                                           \
  extern "C" int nekbone_ax_slab_query_##SUFFIX(int n, int resident, int dyn, \
                                                int* out) {                   \
    (void)resident;                                                           \
    return nekbone::dispatch_query<S, O, A>(n, dyn, out);                     \
  }

#ifdef NEKBONE_REAL_F64
NEKBONE_AX_SLAB_ENTRY(f64, double, double, double)
#endif
#ifdef NEKBONE_REAL_F32
NEKBONE_AX_SLAB_ENTRY(f32, float, float, float)
#endif
#ifdef NEKBONE_REAL_BF16
NEKBONE_AX_SLAB_ENTRY(bf16, __nv_bfloat16, __nv_bfloat16, float)
#endif
#ifdef NEKBONE_REAL_BF16_IR
NEKBONE_AX_SLAB_ENTRY(bf16_ir, __nv_bfloat16, float, float)
#endif
