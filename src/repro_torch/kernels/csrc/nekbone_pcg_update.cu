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
// K10 is K5 (nekbone_cg_update.cu) plus one stream: the TPU kernel received
// w summed inside each z-slab block plus the two neighbouring blocks'
// boundary planes; here K4 writes the unassembled masked w and this kernel
// assembles it node by node in core/gs.ds_sum_local's tree (common.cuh
// sum_xyz_nc, bitwise sum_xyz's).
//
// Bound: bytes.  Reads x, p, z, w, invd (5), writes x, z (2): at E=1024,
// n=10, fp64, 7 x 8.19 MB = 57.3 MB per launch, 17.1 us at the data
// sheet's 3.35 TB/s; about 14 flops per node.  The face gathers of w come
// from L2 (the neighbours read the same copies in the same wave) and are
// counted as no stream.  The partials leave as one value per element each,
// summed outside by torch.sum.
//
// Design (K5's walker, common.cuh's update-walker section).  One block of
// n x n threads per element, loading one value per field and layer per
// thread, with a branching direct-stiffness sum a node (each path waiting
// for its own neighbour loads), two block_sums of eight barriers each and
// no overlap of one element's loads with the next one's arithmetic, ran at
// about half its bound.  Here:
//
// * persistent blocks, one wave: kernels/nekbone_ax.k10_plan sizes the grid
//   from the occupancy calculator; block b owns the z-major elements
//   [b * per_block, (b + 1) * per_block) and walks them, stepping the
//   element's grid coordinates (common.cuh ItemPos);
// * a ring of two stages in dynamic shared memory holds the next element's
//   x, p, z, invd and its own copy of w while the current one is updated
//   (n = 10: 2 x 40,000 bytes in fp64, two blocks an SM; 2 x 10,000 in
//   bf16; common.cuh WalkRing<5>, ring_fill_stage): one thread's TMA bulk
//   copies where every staged operand is a multiple of 16 bytes and
//   aligned (n even), per-thread cp.async otherwise, an mbarrier a stage;
//   where the plan stages all five by bulk copies the walk knows so at
//   compile time (kBulkAll, as K5's); an operand the plan does not stage
//   is read from device memory, prefetched to L2 one element ahead;
// * the neighbours' copies of w are read through L2 by predicated
//   read-only loads that every thread issues alike (sum_xyz_nc), and a
//   thread assembles its column's n values of w before it stores anything;
// * both partials go through block_sum_shfl's pairs under one set of
//   barriers (common.cuh block_sum2_shfl), its buffers alternating between
//   elements;
// * the walkers' register cap (common.cuh kWalkMinBlocks, K5's), and K5's
//   planning rule (every operand staged where one block of that ring fits
//   an SM): at n = 10 the fp64 ring holds two blocks an SM, the cap's
//   count.  A ring without invd at three blocks an SM (under K9's cap of
//   three) and a ring of one stage measured slower
//   (scripts/parent_compare.py times them, and the chosen plan under K9's
//   cap, beside the chosen plan).
//
// The arithmetic is the one-block-per-element kernel's, node by node: x and
// z with rounded, uncontracted multiply and add; d = rcp_rn(invd) taken per
// node (a precomputed d would be a new stream); z rounded to its storage
// type before both partials; each column's partials summed in k order, then
// block_sum's pairs.  So x, z, rtz and rcr are bitwise its outputs in every
// build.  alpha is read from a device pointer; c = mask/multiplicity is
// rebuilt per node from the factors cx, cy, cz (exact binary fractions).
//
// Both partials see the *stored* z (the reference's precision rule 2: the
// next iteration's K4 re-reads it), and d is the correctly rounded
// reciprocal of invd, as torch's reciprocal gives it.
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

// The operands of one launch, passed by value.
template <typename S, typename X, typename O, typename A>
struct PcgArgs {
  const X* x;
  const S* p;
  const S* z;
  const S* w;
  const A* alpha;
  const O* invd;
  const S* cx;
  const S* cy;
  const S* cz;
  X* x_out;
  S* z_out;
  A* rtz;
  A* rcr;
  int ex, ey, ez;
  WalkPlan plan;
};

// Operands 0..4 of the ring: x (n^3 values in X), p, z and w (n^3 in S)
// and invd (n^3 in O) of one element; their bytes and value sizes.
template <int N, typename S, typename X, typename O>
__host__ __device__ __forceinline__ void pcg_operands(int (&bytes)[5],
                                                      int (&size)[5]) {
  constexpr int kS = static_cast<int>(sizeof(S));
  constexpr int kX = static_cast<int>(sizeof(X));
  constexpr int kO = static_cast<int>(sizeof(O));
  bytes[0] = N * N * N * kX;
  bytes[1] = bytes[2] = bytes[3] = N * N * N * kS;
  bytes[4] = N * N * N * kO;
  size[0] = kX;
  size[1] = size[2] = size[3] = kS;
  size[4] = kO;
}

// One element, the t-th of the block, whose stage has landed: thread (i, j)
// assembles its column's n values of w first, then marches its k layers (x
// += alpha p, z -= alpha invd w, its rtz and rcr partials in k order), and
// the block sums both partials in block_sum's tree (`red` one of two
// buffers of 2 n^2 values).
// P is NoPlanes, or EdgePlanes<A> for the planes instantiation (a sharded
// solve's shard, common.cuh sum_xyz_nc_planes).
template <int N, bool kBulkAll, typename S, typename X, typename O,
          typename A, typename P = NoPlanes>
__device__ __forceinline__ void pcg_update_item(
    const PcgArgs<S, X, O, A>& a, const WalkRing<5>& ring,
    const unsigned char* stage, size_t e, const ItemPos& pos, A al, A* red,
    int i, int j, const P& pl = P{}) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  const int tid = j * N + i;
  const int ix = pos.ix, iy = pos.iy, iz = pos.iz;
  const X* xs = ring_at_stage<X, kBulkAll>(ring, stage, 0, e) + tid;
  const S* ps = ring_at_stage<S, kBulkAll>(ring, stage, 1, e) + tid;
  const S* zs = ring_at_stage<S, kBulkAll>(ring, stage, 2, e) + tid;
  const S* ws = ring_at_stage<S, kBulkAll>(ring, stage, 3, e) + tid;
  const O* ds = ring_at_stage<O, kBulkAll>(ring, stage, 4, e) + tid;
  const size_t base = e * N3 + tid;
  const A cyx = convert<A>(a.cy[iy * N + j]) * convert<A>(a.cx[ix * N + i]);
  A wa[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if constexpr (P::kOn)
      wa[k] = sum_xyz_nc_planes<N>(a.w, convert<A>(ws[k * N2]), e, k, j, i,
                                   ix, iy, iz, a.ex, a.ey, a.ez, pl);
    else
      wa[k] = sum_xyz_nc<N>(a.w, convert<A>(ws[k * N2]), e, k, j, i, ix, iy,
                            iz, a.ex, a.ey, a.ez);
  }
  A part_rtz = A(0);
  A part_rcr = A(0);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const size_t o = base + k * N2;
    const A id = convert<A>(ds[k * N2]);
    a.x_out[o] = convert<X>(
        add_rn(convert<A>(xs[k * N2]), mul_rn(al, convert<A>(ps[k * N2]))));
    // the stored z, and both partials over exactly it
    const S zn_s = convert<S>(
        sub_rn(convert<A>(zs[k * N2]), mul_rn(al, mul_rn(id, wa[k]))));
    a.z_out[o] = zn_s;
    const A zn = convert<A>(zn_s);
    const A d = rcp_rn(id);
    // c is (cz * cy) * cx, exact in any order (factors 0, 1/2, 1).
    const A c = convert<A>(a.cz[iz * N + k]) * cyx;
    const A t = mul_rn(mul_rn(mul_rn(zn, c), zn), d);
    part_rtz += t;
    part_rcr += mul_rn(t, d);
  }
  block_sum2_shfl<N2>(part_rtz, part_rcr, red, tid);
  if (tid == 0) {
    a.rtz[e] = part_rtz;
    a.rcr[e] = part_rcr;
  }
}

// The walk of a block over its elements, kBulkAll as for ring_fill_stage,
// P as for pcg_update_item.
template <int N, bool kBulkAll, typename S, typename X, typename O,
          typename A, typename P = NoPlanes>
__device__ __forceinline__ void pcg_update_walk(const PcgArgs<S, X, O, A>& a,
                                                unsigned long long* full,
                                                unsigned char* ring_bytes,
                                                A* red, const P& pl = P{}) {
  constexpr int N2 = N * N;
  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const int tid = j * N + i;
  const size_t E = static_cast<size_t>(a.ex) * a.ey * a.ez;
  size_t first, last;
  walk_range(E, a.plan.per_block, first, last);
  const int count = static_cast<int>(last - first);
  const void* const src[5] = {a.x, a.p, a.z, a.w, a.invd};
  int bytes[5], size[5];
  pcg_operands<N, S, X, O>(bytes, size);
  WalkRing<5> ring(full, ring_bytes, a.plan, src, bytes, size);
  ring.init(tid, N2);
  __syncthreads();
  const int stages = a.plan.stages;
  for (int t = 0; t < stages && t < count; ++t)
    ring_fill_stage<kBulkAll>(ring, t, first + t, tid, N2);
  const A al = *a.alpha;
  ItemPos pos(first, E, a.ex, a.ey);
  // the t-th element's stage s = t % stages, and its phase (t / stages) & 1
  int s = 0;
  unsigned phase = 0;
  for (int t = 0; t < count; ++t, pos.next(a.ex, a.ey, a.ez)) {
    const size_t e = first + t;
    if (!kBulkAll && t + 1 < count) ring.prefetch(e + 1, tid, N2);
    if (kBulkAll || a.plan.staged) mbar_wait(&full[s], phase);
    pcg_update_item<N, kBulkAll>(a, ring, ring.base + s * ring.stage_bytes,
                                 e, pos, al, red + (t & 1) * 2 * N2, i, j,
                                 pl);
    // block_sum2_shfl's barrier: no thread reads this element's stage any
    // more
    if (t + stages < count)
      ring_fill_stage<kBulkAll>(ring, s, e + stages, tid, N2);
    if (++s == stages) {
      s = 0;
      phase ^= 1u;
    }
  }
}

template <int N, typename S, typename X, typename O, typename A>
__global__ void __launch_bounds__(N * N, kWalkMinBlocks<N, A>)
nekbone_pcg_update_kernel(const PcgArgs<S, X, O, A> a) {
  __shared__ A red[4 * N * N];
  __shared__ unsigned long long full[kMaxStages];
  extern __shared__ __align__(128) unsigned char ring_bytes[];
  if (a.plan.bulk && a.plan.staged == 31)
    pcg_update_walk<N, true>(a, full, ring_bytes, red);
  else
    pcg_update_walk<N, false>(a, full, ring_bytes, red);
}

// The planes instantiation: a sharded solve's shard (common.cuh
// EdgePlanes).  The kernel above is the walk without that operand, so its
// code is the single-shard kernel's.
template <int N, typename S, typename X, typename O, typename A>
__global__ void __launch_bounds__(N * N, kWalkMinBlocks<N, A>)
nekbone_pcg_update_planes_kernel(const PcgArgs<S, X, O, A> a,
                                 const EdgePlanes<A> pl) {
  __shared__ A red[4 * N * N];
  __shared__ unsigned long long full[kMaxStages];
  extern __shared__ __align__(128) unsigned char ring_bytes[];
  if (a.plan.bulk && a.plan.staged == 31)
    pcg_update_walk<N, true>(a, full, ring_bytes, red, pl);
  else
    pcg_update_walk<N, false>(a, full, ring_bytes, red, pl);
}

// P is empty for the single-shard kernel, or EdgePlanes<A> for the planes
// kernel, which runs on the single-shard kernel's plan.
template <int N, typename S, typename X, typename O, typename A,
          typename... P>
const void* kernel_fn() {
  if constexpr (sizeof...(P) == 0)
    return reinterpret_cast<const void*>(
        &nekbone_pcg_update_kernel<N, S, X, O, A>);
  else
    return reinterpret_cast<const void*>(
        &nekbone_pcg_update_planes_kernel<N, S, X, O, A>);
}

// out: common.cuh coop_query's seven values for this instantiation.
template <int N, typename S, typename X, typename O, typename A>
cudaError_t query(int dyn, int* out) {
  return coop_query(kernel_fn<N, S, X, O, A>(), N * N, 1, dyn, out);
}

template <int N, typename S, typename X, typename O, typename A,
          typename... P>
cudaError_t launch(const PcgArgs<S, X, O, A>& a, int grid,
                   cudaStream_t stream, const P&... pl) {
  const long long E = static_cast<long long>(a.ex) * a.ey * a.ez;
  const void* const src[5] = {a.x, a.p, a.z, a.w, a.invd};
  int bytes[5], size[5];
  pcg_operands<N, S, X, O>(bytes, size);
  // the cp.async path reads a copy's first unit from before an operand
  // that starts inside it (copy_window), so any view aligned to its values
  // is taken
  if (!walk_plan_ok(a.plan, E, grid, src, bytes, size, /*any_head=*/true))
    return cudaErrorInvalidValue;
  const int dyn = walk_ring_bytes(a.plan, bytes);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel_fn<N, S, X, O, A, P...>(),
      cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return err;
  if constexpr (sizeof...(P) == 0)
    nekbone_pcg_update_kernel<N, S, X, O, A>
        <<<grid, dim3(N, N), dyn, stream>>>(a);
  else
    nekbone_pcg_update_planes_kernel<N, S, X, O, A>
        <<<grid, dim3(N, N), dyn, stream>>>(a, pl...);
  return cudaGetLastError();
}

template <typename S, typename X, typename O, typename A>
int dispatch_query(int n, int dyn, int* out) {
  switch (n) {
#define NEKBONE_CASE(N) \
  case N:               \
    return static_cast<int>(query<N, S, X, O, A>(dyn, out));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename S, typename X, typename O, typename A, typename... P>
int dispatch(const PcgArgs<S, X, O, A>& a, int n, int grid, void* stream,
             const P&... pl) {
  if (a.ex <= 0 || a.ey <= 0 || a.ez <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N) \
  case N:               \
    return static_cast<int>(launch<N, S, X, O, A>(a, grid, s, pl...));
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
// EZ).  The plan (per_block, grid, stages, staged, bulk) is
// kernels/nekbone_ax.k10_plan's; a plan the pointers do not allow returns
// cudaErrorInvalidValue.  Returns cudaGetLastError() after the launch.
//
// nekbone_pcg_update_planes_<dtype>(..., rcr, below, above, ex, ...): the
// same launch with a sharded solve's edge planes below, above: (EY*EX, n, n)
// in A, or null at a global end (common.cuh EdgePlanes).
//
// nekbone_pcg_update_query_<dtype>(n, resident, dyn, out): fills out[7] as
// common.cuh coop_query documents (resident is ignored); returns a CUDA
// error, or 0.
#define NEKBONE_PCG_UPDATE_ENTRY(SUFFIX, S, X, O, A)                          \
  extern "C" int nekbone_pcg_update_##SUFFIX(                                 \
      const void* x, const void* p, const void* z, const void* w,             \
      const void* alpha, const void* invd, const void* cx, const void* cy,    \
      const void* cz, void* x_out, void* z_out, void* rtz, void* rcr, int ex, \
      int ey, int ez, int n, int per_block, int grid, int stages,             \
      int staged, int bulk, void* stream) {                                   \
    const nekbone::PcgArgs<S, X, O, A> a{                                     \
        static_cast<const X*>(x),     static_cast<const S*>(p),               \
        static_cast<const S*>(z),     static_cast<const S*>(w),               \
        static_cast<const A*>(alpha), static_cast<const O*>(invd),            \
        static_cast<const S*>(cx),    static_cast<const S*>(cy),              \
        static_cast<const S*>(cz),    static_cast<X*>(x_out),                 \
        static_cast<S*>(z_out),       static_cast<A*>(rtz),                   \
        static_cast<A*>(rcr),         ex,                                     \
        ey,                           ez,                                     \
        {per_block, stages, staged, bulk}};                                   \
    return nekbone::dispatch<S, X, O, A>(a, n, grid, stream);                 \
  }                                                                           \
  extern "C" int nekbone_pcg_update_planes_##SUFFIX(                          \
      const void* x, const void* p, const void* z, const void* w,             \
      const void* alpha, const void* invd, const void* cx, const void* cy,    \
      const void* cz, void* x_out, void* z_out, void* rtz, void* rcr,         \
      const void* below, const void* above, int ex, int ey, int ez, int n,    \
      int per_block, int grid, int stages, int staged, int bulk,              \
      void* stream) {                                                         \
    const nekbone::PcgArgs<S, X, O, A> a{                                     \
        static_cast<const X*>(x),     static_cast<const S*>(p),               \
        static_cast<const S*>(z),     static_cast<const S*>(w),               \
        static_cast<const A*>(alpha), static_cast<const O*>(invd),            \
        static_cast<const S*>(cx),    static_cast<const S*>(cy),              \
        static_cast<const S*>(cz),    static_cast<X*>(x_out),                 \
        static_cast<S*>(z_out),       static_cast<A*>(rtz),                   \
        static_cast<A*>(rcr),         ex,                                     \
        ey,                           ez,                                     \
        {per_block, stages, staged, bulk}};                                   \
    const nekbone::EdgePlanes<A> pl{static_cast<const A*>(below),             \
                                    static_cast<const A*>(above)};            \
    return nekbone::dispatch<S, X, O, A>(a, n, grid, stream, pl);             \
  }                                                                           \
  extern "C" int nekbone_pcg_update_query_##SUFFIX(int n, int resident,       \
                                                   int dyn, int* out) {       \
    (void)resident;                                                           \
    return nekbone::dispatch_query<S, X, O, A>(n, dyn, out);                  \
  }

#ifdef NEKBONE_REAL_F64
NEKBONE_PCG_UPDATE_ENTRY(f64, double, double, double, double)
#endif
#ifdef NEKBONE_REAL_F32
NEKBONE_PCG_UPDATE_ENTRY(f32, float, float, float, float)
#endif
#ifdef NEKBONE_REAL_BF16
NEKBONE_PCG_UPDATE_ENTRY(bf16, __nv_bfloat16, __nv_bfloat16, __nv_bfloat16,
                         float)
#endif
#ifdef NEKBONE_REAL_BF16_IR
NEKBONE_PCG_UPDATE_ENTRY(bf16_ir, __nv_bfloat16, float, float, float)
#endif
