// K9: the multi-axpy back half of one s-step CG cycle, per element.
//
//     V   = [p, basis[0..s-1], r, basis[s..2s-2]]   (K8's column order)
//     x  += V @ coef[0]
//     r   = V @ coef[1]
//     p   = V @ coef[2]
//     rcr = sum(r * c * r)                          (per element, stored r)
//
// with coef the (3, 2s+1) rows of the float64 host recurrence
// (core/cg_sstep.cycle_coefficients) in the accumulation dtype.
//
// Replaces the TPU kernel
// src/repro/kernels/nekbone_ax.py:nekbone_sstep_update_kernel (pallas_call
// at :1274), which applied the same combinations to a VMEM block of
// elements.  It is element-local and needs no assembly.  The terms are
// summed in the reference's order (x from the old x, r and p from zero, over
// V's columns in order) with rounded, uncontracted multiply and add, so x, r
// and p are bitwise the plain version's.  The weight c = mask/multiplicity
// is rebuilt per node from the factors cx, cy, cz.  rcr leaves as one value
// per element (E values), summed outside by torch.sum.
//
// Bound: bytes.  x, p, r and the 2s - 1 basis vectors in, x, r, p out:
// 13 fields at s=4, 106.5 MB at E=1024, n=10, fp64 (31.8 us at the data
// sheet's 3.35 TB/s); 6(2s+1) + 3 flops per node, far below.
//
// Design (K5's walker, common.cuh's update-walker section).  One block per
// element, 4 warps, loaded a node's 2s + 1 values one after another (a
// branch picked each column's source inside a loop of run-time length) and
// overlapped nothing.  Here:
//
// * persistent blocks in one wave (kernels/nekbone_ax.k9_plan): block b
//   owns the z-major elements [b * per_block, (b + 1) * per_block) and
//   walks them, stepping the element's grid coordinates (ItemPos);
// * a ring of two stages in dynamic shared memory holds the next element's
//   x, p, r and its basis block (contiguous in the (E, 2s-1, n^3) layout:
//   one bulk copy) while the current one is updated: all four wherever one
//   block of that ring fits an SM (s = 4, n = 10: 2 x 80,000 bytes in
//   fp64, one block an SM), else as far as the residency allows (s = 10 in
//   fp64: x, p and r, the basis read from device memory and prefetched to
//   L2 one element ahead); TMA bulk copies at even n, per-thread cp.async
//   at odd n or off 16-byte alignment, an mbarrier per stage; a register
//   cap of its own (kSstepMinBlocks) lets three fp64 blocks share an SM at
//   n = 10 where the ring leaves room;
// * once per element a table points each of V's columns at its slot in
//   the stage or at device memory, so the column loop has no branch; it is
//   unrolled to kSstepMaxK with a guard m < K (s stays a run-time argument:
//   no build per s), and for each column a thread's n loads (one a layer)
//   issue together into its 3n running sums;
// * the coefficients sit in shared memory as one 16- or 32-byte row a
//   column, read once an element per column;
// * the partials go through block_sum's pairs (block_sum_shfl).
//
// Every node's sums are the one-block-per-element kernel's, in its order
// (x, r and p over the columns in order; r.c.r over the layers in order,
// then block_sum's tree), so x, r, p and rcr are bitwise its outputs.
//
// Storage and accumulation (common.cuh), K5's roles: S the CG vectors (p,
// r, the basis) and the c factors, X the solution, A the coefficients, the
// arithmetic and rcr.  Four builds: f64 and f32 (one type throughout);
// bf16 (S = X = bf16, A = f32) and bf16_ir (S = bf16, X = A = f32).  Each
// combination is summed in A from the upcast values and rounded once to
// its storage type; r is rounded to S before r.c.r, since the next cycle's
// K8 reads the stored r (the round trip is the identity for f64 and f32).
// At s=4 bf16 moves 26 bytes per node, bf16_ir 30 (x in f32).
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

// The operands of one launch, passed by value.
template <typename S, typename X, typename A>
struct SstepArgs {
  const X* x;
  const S* p;
  const S* r;
  const S* basis;
  const A* coef;
  const S* cx;
  const S* cy;
  const S* cz;
  X* x_out;
  S* r_out;
  S* p_out;
  A* rcr;
  int ex, ey, ez, s;
  WalkPlan plan;
};

// Operands 0..3 of the ring: x (n^3 values in X), p and r (n^3 in S) and
// the element's basis block ((2s - 1) n^3 in S); their bytes and value
// sizes.
template <int N, typename S, typename X>
__host__ __device__ __forceinline__ void sstep_operands(int s,
                                                        int (&bytes)[4],
                                                        int (&size)[4]) {
  constexpr int kS = static_cast<int>(sizeof(S));
  constexpr int kX = static_cast<int>(sizeof(X));
  bytes[0] = N * N * N * kX;
  bytes[1] = bytes[2] = N * N * N * kS;
  bytes[3] = (2 * s - 1) * N * N * N * kS;
  size[0] = kX;
  size[1] = size[2] = size[3] = kS;
}

// K9's register cap: as many blocks an SM as 384 threads (8-byte
// accumulation) or 512 (4-byte) fill, at least one.  At n = 10 in fp64 that
// is three blocks of 128 threads (168 registers a thread) where the walkers'
// cap (common.cuh kWalkMinBlocks) is two: wherever the ring leaves room (s
// = 1; s = 10, whose basis is read from device memory) a third block keeps
// more loads in flight.
template <int N, typename A>
constexpr int kSstepMinBlocks =
    (sizeof(A) == 8 ? 384 : 512) / ((N * N + 31) / 32 * 32) > 1
        ? (sizeof(A) == 8 ? 384 : 512) / ((N * N + 31) / 32 * 32)
        : 1;

// A column's three coefficients (x, r, p rows) in a row of 4 values of A.
__device__ __forceinline__ void coef3(const double (&row)[4], double& c0,
                                      double& c1, double& c2) {
  const double2 q = *reinterpret_cast<const double2*>(row);
  c0 = q.x;
  c1 = q.y;
  c2 = row[2];
}
__device__ __forceinline__ void coef3(const float (&row)[4], float& c0,
                                      float& c1, float& c2) {
  const float4 q = *reinterpret_cast<const float4*>(row);
  c0 = q.x;
  c1 = q.y;
  c2 = q.z;
}

// One element, the t-th of the block, whose stage has landed: V's columns
// in order into each node's x, r and p sums (rounded, uncontracted), then
// the stores and the r.c.r partial over the layers in order, summed in
// block_sum's tree (`red` one of two buffers of n^2 values).
template <int N, typename S, typename X, typename A>
__device__ __forceinline__ void sstep_item(const SstepArgs<S, X, A>& a,
                                           const WalkRing<4>& ring,
                                           const unsigned char* stage,
                                           size_t e, const ItemPos& pos,
                                           const A (&sco)[kSstepMaxK][4],
                                           A* red, int i, int j) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  const int tid = j * N + i;
  const int s = a.s;
  const int K = 2 * s + 1;
  const X* xs = ring_at_stage<X, false>(ring, stage, 0, e) + tid;
  const S* ps = ring_at_stage<S, false>(ring, stage, 1, e) + tid;
  const S* rs = ring_at_stage<S, false>(ring, stage, 2, e) + tid;
  const S* bs = ring_at_stage<S, false>(ring, stage, 3, e) + tid;
  // V's columns: p, basis[0..s-1], r, basis[s..2s-2]
  const S* col[kSstepMaxK];
#pragma unroll
  for (int m = 0; m < kSstepMaxK; ++m)
    col[m] = m == 0 ? ps
                    : m == s + 1 ? rs : bs + (m <= s ? m - 1 : m - 2) * N3;
  A xa[N], ra[N], pa[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    xa[k] = convert<A>(xs[k * N2]);
    ra[k] = A(0);
    pa[k] = A(0);
  }
#pragma unroll
  for (int m = 0; m < kSstepMaxK; ++m) {
    if (m < K) {
      A c0, c1, c2;
      coef3(sco[m], c0, c1, c2);
      A v[N];
#pragma unroll
      for (int k = 0; k < N; ++k) v[k] = convert<A>(col[m][k * N2]);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        xa[k] = add_rn(xa[k], mul_rn(c0, v[k]));
        ra[k] = add_rn(ra[k], mul_rn(c1, v[k]));
        pa[k] = add_rn(pa[k], mul_rn(c2, v[k]));
      }
    }
  }
  // c is (cz * cy) * cx; the factors are 0, 1/2 or 1, so the product is
  // exact in any order.
  const A cyx =
      convert<A>(a.cy[pos.iy * N + j]) * convert<A>(a.cx[pos.ix * N + i]);
  const size_t base = e * N3 + tid;
  A part = A(0);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const size_t o = base + k * N2;
    a.x_out[o] = convert<X>(xa[k]);
    const S rn_s = convert<S>(ra[k]);
    a.r_out[o] = rn_s;
    a.p_out[o] = convert<S>(pa[k]);
    const A rn = convert<A>(rn_s);
    const A c = convert<A>(a.cz[pos.iz * N + k]) * cyx;
    part += (rn * c) * rn;
  }
  const A total = block_sum_shfl<N2>(part, red, tid);
  if (tid == 0) a.rcr[e] = total;
}

template <int N, typename S, typename X, typename A>
__global__ void __launch_bounds__(N * N, kSstepMinBlocks<N, A>)
nekbone_sstep_update_kernel(const SstepArgs<S, X, A> a) {
  constexpr int N2 = N * N;
  __shared__ __align__(16) A sco[kSstepMaxK][4];
  __shared__ A red[2 * N2];
  __shared__ unsigned long long full[kMaxStages];
  extern __shared__ __align__(128) unsigned char ring_bytes[];

  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const int tid = j * N + i;
  const int K = 2 * a.s + 1;
  for (int t = tid; t < 3 * K; t += N2) sco[t % K][t / K] = a.coef[t];
  const size_t E = static_cast<size_t>(a.ex) * a.ey * a.ez;
  size_t first, last;
  walk_range(E, a.plan.per_block, first, last);
  const int count = static_cast<int>(last - first);
  const void* const src[4] = {a.x, a.p, a.r, a.basis};
  int bytes[4], size[4];
  sstep_operands<N, S, X>(a.s, bytes, size);
  WalkRing<4> ring(full, ring_bytes, a.plan, src, bytes, size);
  ring.init(tid, N2);
  __syncthreads();
  const int stages = a.plan.stages;
  for (int t = 0; t < stages && t < count; ++t)
    ring_fill_stage<false>(ring, t, first + t, tid, N2);
  ItemPos pos(first, E, a.ex, a.ey);
  // the t-th element's stage s = t % stages, and its phase (t / stages) & 1
  int s = 0;
  unsigned phase = 0;
  for (int t = 0; t < count; ++t, pos.next(a.ex, a.ey, a.ez)) {
    const size_t e = first + t;
    if (t + 1 < count) ring.prefetch(e + 1, tid, N2);
    if (a.plan.staged) mbar_wait(&full[s], phase);
    sstep_item<N>(a, ring, ring.base + s * ring.stage_bytes, e, pos, sco,
                  red + (t & 1) * N2, i, j);
    // block_sum_shfl's barrier: no thread reads this element's stage any
    // more
    if (t + stages < count)
      ring_fill_stage<false>(ring, s, e + stages, tid, N2);
    if (++s == stages) {
      s = 0;
      phase ^= 1u;
    }
  }
}

template <int N, typename S, typename X, typename A>
const void* kernel_fn() {
  return reinterpret_cast<const void*>(
      &nekbone_sstep_update_kernel<N, S, X, A>);
}

// out: common.cuh coop_query's seven values for this instantiation.
template <int N, typename S, typename X, typename A>
cudaError_t query(int dyn, int* out) {
  return coop_query(kernel_fn<N, S, X, A>(), N * N, 1, dyn, out);
}

template <int N, typename S, typename X, typename A>
cudaError_t launch(const SstepArgs<S, X, A>& a, int grid,
                   cudaStream_t stream) {
  const long long E = static_cast<long long>(a.ex) * a.ey * a.ez;
  const void* const src[4] = {a.x, a.p, a.r, a.basis};
  int bytes[4], size[4];
  sstep_operands<N, S, X>(a.s, bytes, size);
  // the cp.async path reads a copy's first unit from before an operand
  // that starts inside it (copy_window), so any view aligned to its values
  // is taken
  if (!walk_plan_ok(a.plan, E, grid, src, bytes, size, /*any_head=*/true))
    return cudaErrorInvalidValue;
  const int dyn = walk_ring_bytes(a.plan, bytes);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel_fn<N, S, X, A>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
      dyn);
  if (err != cudaSuccess) return err;
  nekbone_sstep_update_kernel<N, S, X, A>
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
int dispatch(const SstepArgs<S, X, A>& a, int n, int grid, void* stream) {
  if (a.ex <= 0 || a.ey <= 0 || a.ez <= 0 || a.s < 1 || a.s > kSstepMaxS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N) \
  case N:               \
    return static_cast<int>(launch<N, S, X, A>(a, grid, st));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// x, x_out: (E, n^3) in X; p, r, r_out, p_out: (E, n^3) and basis: (E,
// 2s-1, n^3) in S; coef: (3, 2s+1) and rcr: (E,) in A; cx: (EX, n); cy:
// (EY, n); cz: (EZ, n) in S.  Elements z-major over (EX, EY, EZ);
// 1 <= s <= 10.  The plan (per_block, grid, stages, staged, bulk) is
// kernels/nekbone_ax.k9_plan's; a plan the pointers do not allow returns
// cudaErrorInvalidValue.  Returns cudaGetLastError() after the launch.
//
// nekbone_sstep_update_query_<dtype>(n, resident, dyn, out): fills out[7]
// as common.cuh coop_query documents (resident is ignored); returns a CUDA
// error, or 0.
#define NEKBONE_SSTEP_UPDATE_ENTRY(SUFFIX, S, X, A)                          \
  extern "C" int nekbone_sstep_update_##SUFFIX(                              \
      const void* x, const void* p, const void* r, const void* basis,        \
      const void* coef, const void* cx, const void* cy, const void* cz,      \
      void* x_out, void* r_out, void* p_out, void* rcr, int ex, int ey,      \
      int ez, int n, int s, int per_block, int grid, int stages, int staged, \
      int bulk, void* stream) {                                              \
    const nekbone::SstepArgs<S, X, A> a{                                     \
        static_cast<const X*>(x),    static_cast<const S*>(p),               \
        static_cast<const S*>(r),    static_cast<const S*>(basis),           \
        static_cast<const A*>(coef), static_cast<const S*>(cx),              \
        static_cast<const S*>(cy),   static_cast<const S*>(cz),              \
        static_cast<X*>(x_out),      static_cast<S*>(r_out),                 \
        static_cast<S*>(p_out),      static_cast<A*>(rcr),                   \
        ex,                          ey,                                     \
        ez,                          s,                                      \
        {per_block, stages, staged, bulk}};                                  \
    return nekbone::dispatch<S, X, A>(a, n, grid, stream);                   \
  }                                                                          \
  extern "C" int nekbone_sstep_update_query_##SUFFIX(int n, int resident,    \
                                                     int dyn, int* out) {    \
    (void)resident;                                                          \
    return nekbone::dispatch_query<S, X, A>(n, dyn, out);                    \
  }

#ifdef NEKBONE_REAL_F64
NEKBONE_SSTEP_UPDATE_ENTRY(f64, double, double, double)
#endif
#ifdef NEKBONE_REAL_F32
NEKBONE_SSTEP_UPDATE_ENTRY(f32, float, float, float)
#endif
#ifdef NEKBONE_REAL_BF16
NEKBONE_SSTEP_UPDATE_ENTRY(bf16, __nv_bfloat16, __nv_bfloat16, float)
#endif
#ifdef NEKBONE_REAL_BF16_IR
NEKBONE_SSTEP_UPDATE_ENTRY(bf16_ir, __nv_bfloat16, float, float)
#endif
