// K1: the fused local Poisson operator  w = D^T ( G ( D u ) ), per element.
//
// Replaces the TPU kernel src/repro/kernels/nekbone_ax.py:nekbone_ax_kernel
// (pallas_call at :281), which kept a block of elements resident in VMEM and
// folded the element and layer axes into skinny matmuls.  On Hopper an
// element is the paper's 2-D thread structure (DESIGN.md §1): an n x n layer
// of threads (thread (i, j) owns the node column (:, j, i)) marching through
// the k layers, with the column of u and of w in registers.  Per layer k:
//   1. the layer u[k, :, :] goes to shared memory;
//   2. wr, ws from the layer, wt from the thread's own u column;
//   3. the six metric entries of the node are read and applied;
//   4. ur, us go to shared memory; their transposed contractions finish
//      w[k, j, i], and ut is scattered into the whole w column.
//
// Bound on this card: 7 reads and 1 write of a field per launch — u, the
// six metric entries, w — about 65.5 MB at E=1024, n=10 in fp64
// (8 x 8.19 MB); 12n+17 flops per node, 0.14 GFLOP, so the kernel is bound
// by device-memory bytes (about 20 us at the data sheet's 3.35 TB/s).  Each
// input is read once and w written once.
//
// Design (K3's walker, nekbone_ax_dots.cu, and common.cuh's ring).  One
// block per element ran 7.8 blocks an SM at E=1024 in one ragged wave, each
// loading, sweeping and storing in series.  Here:
//
// * persistent blocks in one wave (kernels/nekbone_ax.k1_plan): block b
//   owns the z-major elements [b * per_block, (b + 1) * per_block) and
//   walks them;
// * a ring of two stages in dynamic shared memory holds the next element's
//   u and metric while the current one is swept, as far as the residency
//   allows (n = 10: both in fp64, 2 x 56,000 bytes at two blocks an SM, and
//   in the bf16 builds; the metric alone in f32, at four blocks an SM, u
//   read from device memory and prefetched to L2 one element ahead): one
//   thread's TMA bulk copies where every operand is a multiple of 16 bytes
//   and aligned, per-thread cp.async otherwise, an mbarrier per stage;
// * D's rows and columns of thread (i, j) in registers (common.cuh DRegs);
// * the layer sweep reads the contractions along a row of the layer in
//   16-byte vectors (common.cuh ax_columns_vec: u[j][.], r[j][.], and
//   D[k][.] once a layer for both of its uses; the strided reads stay
//   scalar, free of bank conflicts), 1.5n vector and 2n scalar loads a
//   node and layer in fp64 for ax_columns' 6n scalar ones.
//   scripts/parent_compare.py times it beside edited copies with K3's
//   scalar sweep (ax_columns_dregs) and with a sweep that also reads the
//   strided operands as vectors, from transposed copies of the layers.
//
// Every product and sum of a node is ax_columns', in its order, so w is
// bitwise the kernel of one block per element in every build.
//
// n is a template parameter (2..16, dispatched at run time).  The storage
// roles are common.cuh's: S for u and w, O for D and the six metric fields,
// and A = accum_t<S> for the arithmetic (the reference's _accum rule).  Four
// builds: f64 and f32 (one type throughout, so every convert is the
// identity and the arithmetic is the single-type kernel's), bf16 (S = O =
// bf16, A = f32) and bf16_ir (S = bf16, O = A = f32).  u and the metric are
// upcast on load, the whole operator runs in A, and w is rounded to S once,
// on store, as the TPU kernel does (w_ref[...] = w.astype(w_ref.dtype)).
// In bf16 K1 moves 16 bytes a node (u, 6 metric fields, w), in bf16_ir 28
// (the metric in f32).
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

// The operands of one launch, passed by value.
template <typename S, typename O>
struct AxArgs {
  const S* u;
  const O* D;
  const O* g;
  S* w;
  int E;
  WalkPlan plan;
};

// Operands 0 and 1 of the ring: u (n^3 values in S) and the metric (6 n^3
// in O) of one element; their bytes and value sizes.
template <int N, typename S, typename O>
__host__ __device__ __forceinline__ void ax_operands(int (&bytes)[2],
                                                     int (&size)[2]) {
  constexpr int kS = static_cast<int>(sizeof(S));
  constexpr int kO = static_cast<int>(sizeof(O));
  bytes[0] = N * N * N * kS;
  bytes[1] = 6 * N * N * N * kO;
  size[0] = kS;
  size[1] = kO;
}

template <int N, typename S, typename O>
__global__ void __launch_bounds__(N * N, kWalkMinBlocks<N, accum_t<S>>)
nekbone_ax_kernel(const AxArgs<S, O> a) {
  using A = accum_t<S>;
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  __shared__ __align__(16) AxVecShared<N, A> sh;
  __shared__ unsigned long long full[kMaxStages];
  extern __shared__ __align__(128) unsigned char ring_bytes[];

  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const int tid = j * N + i;
  size_t first, last;
  walk_range(static_cast<size_t>(a.E), a.plan.per_block, first, last);
  const int count = static_cast<int>(last - first);
  const void* const src[2] = {a.u, a.g};
  int bytes[2], size[2];
  ax_operands<N, S, O>(bytes, size);
  WalkRing<2> ring(full, ring_bytes, a.plan, src, bytes, size);
  ring.init(tid, N2);
  load_D(sh, a.D, i, j);
  DRegs<N, A> dr;
  dr.load(a.D, i, j);
  __syncthreads();
  const int stages = a.plan.stages;
  for (int t = 0; t < stages && t < count; ++t)
    ring_fill_stage<false>(ring, t, first + t, tid, N2);

  // the t-th element's stage s = t % stages, and its phase (t / stages) & 1
  int s = 0;
  unsigned phase = 0;
  for (int t = 0; t < count; ++t) {
    const size_t e = first + t;
    if (t + 1 < count) ring.prefetch(e + 1, tid, N2);
    if (a.plan.staged) mbar_wait(&full[s], phase);
    const unsigned char* stage = ring.base + s * ring.stage_bytes;
    const S* ue = ring_at_stage<S, false>(ring, stage, 0, e) + tid;
    const O* ge = ring_at_stage<O, false>(ring, stage, 1, e) + tid;
    A uc[N];
    A wc[N];
#pragma unroll
    for (int k = 0; k < N; ++k) uc[k] = convert<A>(ue[k * N2]);
    const auto metric = [ge](int k, A wr, A ws, A wt, A& ur, A& us,
                             A& ut) {
      const O* gk = ge + k * (N * N);
      const A grr = convert<A>(gk[0 * (N * N * N)]);
      const A grs = convert<A>(gk[1 * (N * N * N)]);
      const A grt = convert<A>(gk[2 * (N * N * N)]);
      const A gss = convert<A>(gk[3 * (N * N * N)]);
      const A gst = convert<A>(gk[4 * (N * N * N)]);
      const A gtt = convert<A>(gk[5 * (N * N * N)]);
      ur = grr * wr + grs * ws + grt * wt;
      us = grs * wr + gss * ws + gst * wt;
      ut = grt * wr + gst * ws + gtt * wt;
    };
    ax_columns_vec(sh, dr, metric, uc, wc, i, j);
    // every read of this element's stage (u's column, the metric) came
    // before the sweep's last barrier: the stage may be refilled
    if (t + stages < count)
      ring_fill_stage<false>(ring, s, e + stages, tid, N2);
    S* we = a.w + e * N3 + tid;
#pragma unroll
    for (int k = 0; k < N; ++k) we[k * N2] = convert<S>(wc[k]);
    if (++s == stages) {
      s = 0;
      phase ^= 1u;
    }
  }
}

template <int N, typename S, typename O>
const void* kernel_fn() {
  return reinterpret_cast<const void*>(&nekbone_ax_kernel<N, S, O>);
}

// out: common.cuh coop_query's seven values for this instantiation.
template <int N, typename S, typename O>
cudaError_t query(int dyn, int* out) {
  return coop_query(kernel_fn<N, S, O>(), N * N, 1, dyn, out);
}

template <int N, typename S, typename O>
cudaError_t launch(const AxArgs<S, O>& a, int grid, cudaStream_t stream) {
  const void* const src[2] = {a.u, a.g};
  int bytes[2], size[2];
  ax_operands<N, S, O>(bytes, size);
  // the cp.async path reads a copy's first unit from before an operand
  // that starts inside it (copy_window), so any view aligned to its
  // values is taken
  if (!walk_plan_ok(a.plan, a.E, grid, src, bytes, size,
                    /*any_head=*/true))
    return cudaErrorInvalidValue;
  const int dyn = walk_ring_bytes(a.plan, bytes);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel_fn<N, S, O>(), cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return err;
  nekbone_ax_kernel<N, S, O><<<grid, dim3(N, N), dyn, stream>>>(a);
  return cudaGetLastError();
}

template <typename S, typename O>
int dispatch_query(int n, int dyn, int* out) {
  switch (n) {
#define NEKBONE_CASE(N) \
  case N:               \
    return static_cast<int>(query<N, S, O>(dyn, out));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename S, typename O>
int dispatch(const AxArgs<S, O>& a, int n, int grid, void* stream) {
  if (a.E <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N) \
  case N:               \
    return static_cast<int>(launch<N, S, O>(a, grid, s));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// u, w: (E, n^3) in S; D: (n, n) and g: (E, 6, n^3) in O; all contiguous,
// on `stream`.  The plan (per_block, grid, stages, staged, bulk) is
// kernels/nekbone_ax.k1_plan's; a plan the pointers do not allow returns
// cudaErrorInvalidValue.  Returns cudaGetLastError() after the launch (0 on
// success).
//
// nekbone_ax_query_<dtype>(n, resident, dyn, out): fills out[7] as
// common.cuh coop_query documents (resident is ignored); returns a CUDA
// error, or 0.
#define NEKBONE_AX_ENTRY(SUFFIX, S, O)                                       \
  extern "C" int nekbone_ax_##SUFFIX(const void* u, const void* D,           \
                                     const void* g, void* w, int E, int n,   \
                                     int per_block, int grid, int stages,    \
                                     int staged, int bulk, void* stream) {   \
    const nekbone::AxArgs<S, O> a{                                           \
        static_cast<const S*>(u), static_cast<const O*>(D),                  \
        static_cast<const O*>(g), static_cast<S*>(w),                        \
        E,                        {per_block, stages, staged, bulk}};        \
    return nekbone::dispatch<S, O>(a, n, grid, stream);                      \
  }                                                                          \
  extern "C" int nekbone_ax_query_##SUFFIX(int n, int resident, int dyn,     \
                                           int* out) {                       \
    (void)resident;                                                          \
    return nekbone::dispatch_query<S, O>(n, dyn, out);                       \
  }

#ifdef NEKBONE_REAL_F64
NEKBONE_AX_ENTRY(f64, double, double)
#endif
#ifdef NEKBONE_REAL_F32
NEKBONE_AX_ENTRY(f32, float, float)
#endif
#ifdef NEKBONE_REAL_BF16
NEKBONE_AX_ENTRY(bf16, __nv_bfloat16, __nv_bfloat16)
#endif
#ifdef NEKBONE_REAL_BF16_IR
NEKBONE_AX_ENTRY(bf16_ir, __nv_bfloat16, float)
#endif
