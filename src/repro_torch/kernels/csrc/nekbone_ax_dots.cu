// K3 and K2: the operator of the v1 fused CG iteration, per element.
//
//     w   = mask * (D^T G D p)         (full 6-component metric, mask field)
//     pap = sum(p * w)                 (per-element partial, before assembly)
//     rcz = sum(r * c * r)             (K2 only: per-element partial)
//
// Replaces the TPU kernels src/repro/kernels/nekbone_ax.py:
// nekbone_ax_pap_kernel (K3, pallas_call at :441) and nekbone_ax_dots_kernel
// (K2, pallas_call at :373).  Both kept a block of elements resident in VMEM
// and emitted one partial per block.  Here an n x n thread layer marches an
// element's k layers (the layer loop in ax_full_columns' order), with the
// mask multiply and the per-element partials added; one template serves
// both, DOTS selecting K2's extra operands.  The mask and the weight c are
// fields here, as in the reference's v1 API, so the kernels take any mesh,
// not only the structured box.
//
// Design: K4's (nekbone_ax_slab.cu, common.cuh's walkers).  Persistent
// blocks in one wave (kernels/nekbone_ax.k3_plan), each walking a
// contiguous z-major range of elements; a ring of two stages in dynamic
// shared memory, filled by TMA bulk copies (n even) or per-thread cp.async
// (n odd) on an mbarrier per stage, holds the next element's p, metric and
// mask (operands 0, 1, 2) as far as two blocks an SM allow: one fp64
// element at n = 10 is 64 KB, so there the planner stages the metric (48
// KB) alone and p and the mask are read from device memory, prefetched to
// L2 one element ahead (K2's r and c likewise), the mask's column read
// into registers before the sweep; D's rows and columns of thread (i, j) in
// registers; two blocks an SM in fp64, four in f32 and bf16
// (common.cuh kWalkMinBlocks).  w, pap and rcz are bitwise the kernel of
// one block per element (the same products and sums in the same order,
// the same block_sum<N*N> trees).
//
// pap is taken before assembly: for a continuous p, sum over elements of
// sum(p * mask * w_local) equals p . c . (mask gs w_local) (DESIGN.md §3.2).
// The partials leave as one value per element (E values), summed outside by
// torch.sum.  The v1 loop (core/cg_fused.py) carries r.c.r from the
// previous update, so it launches K3 only; K2 is the general-field API
// (ops.nekbone_ax_dots) and no route launches it.
//
// Bound: bytes.  K3 reads p, the 6 metric fields and the mask and writes w:
// 9 fields, 73.7 MB at E=1024, n=10, fp64 (22.0 us at the data sheet's 3.35
// TB/s); K2 also reads r and c: 11 fields, 90.1 MB (26.9 us).  About
// 12n + 20 flops per node, 0.14 GF, far below.  Each input is read once
// (p's column into registers, the metric and mask once per node) and w
// written once.
//
// Storage and accumulation (common.cuh).  The template takes the storage
// type S of the fields (p, mask, w, and r, c for K2), the storage type O of
// the operator's data (D, metric) and the accumulation type A (the
// arithmetic, the partials).  K3 has four builds: f64 and f32 (one type
// throughout), bf16 (S = O = bf16, A = f32) and bf16_ir (S = bf16, O = A =
// f32), and so has K2.  pap and rcz are taken in A (over the unrounded w,
// and r and c upcast) and leave in A, the reference's _accum rule; w leaves
// rounded to S, as the TPU kernel does.  K3 moves 18 bytes per node in
// bf16 (p, 6 metric fields, mask, w) and 30 in bf16_ir (the metric in f32);
// K2 22 and 34 (r and c too).
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

// The operands of one launch, passed by value (r, c and rcz: K2 only).
template <typename S, typename O, typename A>
struct DotsArgs {
  const S* p;
  const O* D;
  const O* g;
  const S* mask;
  const S* r;
  const S* c;
  S* w;
  A* pap;
  A* rcz;
  int E;
  WalkPlan plan;
};

// Operands 0, 1, 2 of the ring: p (n^3 values in S), the metric (6 n^3 in
// O) and the mask (n^3 in S) of one element; their bytes and value sizes.
template <int N, typename S, typename O>
__host__ __device__ __forceinline__ void dots_operands(int (&bytes)[3],
                                                       int (&size)[3]) {
  constexpr int kS = static_cast<int>(sizeof(S));
  constexpr int kO = static_cast<int>(sizeof(O));
  bytes[0] = bytes[2] = N * N * N * kS;
  bytes[1] = 6 * N * N * N * kO;
  size[0] = size[2] = kS;
  size[1] = kO;
}

template <int N, typename S, typename O, typename A, bool DOTS>
__global__ void __launch_bounds__(N * N, kWalkMinBlocks<N, A>)
nekbone_ax_dots_kernel(const DotsArgs<S, O, A> a) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  __shared__ AxShared<N, A> sh;
  __shared__ A red[2][N2];
  __shared__ unsigned long long full[kMaxStages];
  extern __shared__ __align__(128) unsigned char ring_bytes[];

  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const int tid = j * N + i;
  size_t first, last;
  walk_range(static_cast<size_t>(a.E), a.plan.per_block, first, last);
  const int count = static_cast<int>(last - first);
  const void* const src[3] = {a.p, a.g, a.mask};
  int bytes[3], size[3];
  dots_operands<N, S, O>(bytes, size);
  WalkRing<3> ring(full, ring_bytes, a.plan, src, bytes, size);
  ring.init(tid, N2);
  load_D(sh, a.D, i, j);
  DRegs<N, A> dr;
  dr.load(a.D, i, j);
  __syncthreads();
  for (int t = 0; t < a.plan.stages && t < count; ++t)
    ring.fill(t, first + t, tid, N2);

  for (int t = 0; t < count; ++t) {
    const size_t e = first + t;
    if (t + 1 < count) {
      ring.prefetch(e + 1, tid, N2);
      if (DOTS) {
        // K2's r and c: never staged
        const size_t o = (e + 1) * N3;
        for (int line = tid; line * 128 < N3 * static_cast<int>(sizeof(S));
             line += N2) {
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
              reinterpret_cast<const unsigned char*>(a.r + o) + line * 128));
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
              reinterpret_cast<const unsigned char*>(a.c + o) + line * 128));
        }
      }
    }
    const size_t base = e * N3 + tid;
    ring.wait(t);
    const S* pe = ring.at<S>(0, t, e) + tid;
    const O* ge = ring.at<O>(1, t, e) + tid;
    const S* me = ring.at<S>(2, t, e) + tid;
    A pc[N];
    A wc[N];
    A mk[N];
#pragma unroll
    for (int k = 0; k < N; ++k) pc[k] = convert<A>(pe[k * N2]);
    // the mask's column now, so that its loads (from device memory where
    // it is not staged) overlap the sweep
#pragma unroll
    for (int k = 0; k < N; ++k) mk[k] = convert<A>(me[k * N2]);
    ax_columns_dregs(
        sh, dr,
        [ge](int k, A wr, A ws, A wt, A& ur, A& us, A& ut) {
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
        },
        pc, wc, i, j);

    A part = A(0);
    A part_r = A(0);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const size_t o = base + k * N2;
      const A v = wc[k] * mk[k];
      part += pc[k] * v;
      a.w[o] = convert<S>(v);
      if (DOTS) {
        // one rounding (an FMA), which nvcc does not contract here itself:
        // rcz keeps the rounding the per-element kernel gave it
        const A rk = convert<A>(a.r[o]);
        part_r = fma_rn(rk * convert<A>(a.c[o]), rk, part_r);
      }
    }
    const A total = block_sum<N2>(part, red[0], tid);
    if (tid == 0) a.pap[e] = total;
    if (DOTS) {
      const A total_r = block_sum<N2>(part_r, red[1], tid);
      if (tid == 0) a.rcz[e] = total_r;
    }
    // block_sum's barriers: no thread reads this element's stage any more
    if (t + a.plan.stages < count)
      ring.fill(t + a.plan.stages, e + a.plan.stages, tid, N2);
  }
}

template <int N, typename S, typename O, typename A, bool DOTS>
const void* kernel_fn() {
  return reinterpret_cast<const void*>(
      &nekbone_ax_dots_kernel<N, S, O, A, DOTS>);
}

// out: common.cuh coop_query's seven values for this instantiation.
template <int N, typename S, typename O, typename A, bool DOTS>
cudaError_t query(int dyn, int* out) {
  return coop_query(kernel_fn<N, S, O, A, DOTS>(), N * N, 1, dyn, out);
}

template <int N, typename S, typename O, typename A, bool DOTS>
cudaError_t launch(const DotsArgs<S, O, A>& a, int grid,
                   cudaStream_t stream) {
  const void* const src[3] = {a.p, a.g, a.mask};
  int bytes[3], size[3];
  dots_operands<N, S, O>(bytes, size);
  if (!walk_plan_ok(a.plan, a.E, grid, src, bytes, size))
    return cudaErrorInvalidValue;
  const int dyn = walk_ring_bytes(a.plan, bytes);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel_fn<N, S, O, A, DOTS>(),
      cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return err;
  nekbone_ax_dots_kernel<N, S, O, A, DOTS>
      <<<grid, dim3(N, N), dyn, stream>>>(a);
  return cudaGetLastError();
}

template <typename S, typename O, typename A, bool DOTS>
int dispatch_query(int n, int dyn, int* out) {
  switch (n) {
#define NEKBONE_CASE(N) \
  case N:               \
    return static_cast<int>(query<N, S, O, A, DOTS>(dyn, out));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename S, typename O, typename A, bool DOTS>
int dispatch(const DotsArgs<S, O, A>& a, int n, int grid, void* stream) {
  if (a.E <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N) \
  case N:               \
    return static_cast<int>(launch<N, S, O, A, DOTS>(a, grid, s));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// p, mask, w (and r, c for K2): (E, n^3) in S; D: (n, n) and g: (E, 6, n^3)
// in O; pap (and rcz): (E,) in A.  All contiguous, on `stream`.  The plan
// (per_block, grid, stages, staged, bulk) is kernels/nekbone_ax.k3_plan's;
// a plan the pointers do not allow returns cudaErrorInvalidValue.  Returns
// cudaGetLastError() after the launch (0 on success).
//
// nekbone_ax_pap_query_<dtype> and nekbone_ax_dots_query_<dtype>(n,
// resident, dyn, out): fill out[7] as common.cuh coop_query documents
// (resident is ignored); return a CUDA error, or 0.
#define NEKBONE_WALK_ARGS \
  int per_block, int grid, int stages, int staged, int bulk, void* stream
#define NEKBONE_AX_PAP_ENTRY(SUFFIX, S, O, A)                                 \
  extern "C" int nekbone_ax_pap_##SUFFIX(const void* p, const void* D,        \
                                         const void* g, const void* mask,     \
                                         void* w, void* pap, int E, int n,    \
                                         NEKBONE_WALK_ARGS) {                 \
    const nekbone::DotsArgs<S, O, A> a{                                       \
        static_cast<const S*>(p), static_cast<const O*>(D),                   \
        static_cast<const O*>(g), static_cast<const S*>(mask),                \
        nullptr,                  nullptr,                                    \
        static_cast<S*>(w),       static_cast<A*>(pap),                       \
        nullptr,                  E,                                          \
        {per_block, stages, staged, bulk}};                                   \
    return nekbone::dispatch<S, O, A, false>(a, n, grid, stream);             \
  }                                                                           \
  extern "C" int nekbone_ax_pap_query_##SUFFIX(int n, int resident, int dyn,  \
                                               int* out) {                    \
    (void)resident;                                                           \
    return nekbone::dispatch_query<S, O, A, false>(n, dyn, out);              \
  }
#define NEKBONE_AX_DOTS_ENTRY(SUFFIX, S, O, A)                                \
  extern "C" int nekbone_ax_dots_##SUFFIX(                                    \
      const void* p, const void* D, const void* g, const void* mask,          \
      const void* r, const void* c, void* w, void* pap, void* rcz, int E,     \
      int n, NEKBONE_WALK_ARGS) {                                             \
    const nekbone::DotsArgs<S, O, A> a{                                       \
        static_cast<const S*>(p), static_cast<const O*>(D),                   \
        static_cast<const O*>(g), static_cast<const S*>(mask),                \
        static_cast<const S*>(r), static_cast<const S*>(c),                   \
        static_cast<S*>(w),       static_cast<A*>(pap),                       \
        static_cast<A*>(rcz),     E,                                          \
        {per_block, stages, staged, bulk}};                                   \
    return nekbone::dispatch<S, O, A, true>(a, n, grid, stream);              \
  }                                                                           \
  extern "C" int nekbone_ax_dots_query_##SUFFIX(int n, int resident, int dyn, \
                                                int* out) {                   \
    (void)resident;                                                           \
    return nekbone::dispatch_query<S, O, A, true>(n, dyn, out);               \
  }

#ifdef NEKBONE_REAL_F64
NEKBONE_AX_PAP_ENTRY(f64, double, double, double)
NEKBONE_AX_DOTS_ENTRY(f64, double, double, double)
#endif
#ifdef NEKBONE_REAL_F32
NEKBONE_AX_PAP_ENTRY(f32, float, float, float)
NEKBONE_AX_DOTS_ENTRY(f32, float, float, float)
#endif
#ifdef NEKBONE_REAL_BF16
NEKBONE_AX_PAP_ENTRY(bf16, __nv_bfloat16, __nv_bfloat16, float)
NEKBONE_AX_DOTS_ENTRY(bf16, __nv_bfloat16, __nv_bfloat16, float)
#endif
#ifdef NEKBONE_REAL_BF16_IR
NEKBONE_AX_PAP_ENTRY(bf16_ir, __nv_bfloat16, float, float)
NEKBONE_AX_DOTS_ENTRY(bf16_ir, __nv_bfloat16, float, float)
#endif
