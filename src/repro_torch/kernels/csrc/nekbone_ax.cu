// K1: the fused local Poisson operator  w = D^T ( G ( D u ) ), per element.
//
// Replaces the TPU kernel src/repro/kernels/nekbone_ax.py:nekbone_ax_kernel
// (pallas_call at :281), which kept a block of elements resident in VMEM and
// folded the element and layer axes into skinny matmuls.  On Hopper the
// kernel goes back to the paper's own design (DESIGN.md §1, the "2-D thread
// structure"): one thread block per element, an n x n layer of threads
// (thread (i, j) owns the node column (:, j, i)) marching through the k
// layers.  D and D^T sit in shared memory; each thread holds its column of
// u and its column of w in registers.  Per layer k:
//   1. the layer u[k, :, :] goes to shared memory;
//   2. wr, ws from the layer, wt from the thread's own u column;
//   3. the six metric entries of the node are read and applied;
//   4. ur, us go to shared memory; their transposed contractions finish
//      w[k, j, i], and ut is scattered into the whole w column (registers).
//
// Bound on this card: 7 reads and 1 write of a field per launch — u, the
// six metric entries, w — about 65.5 MB at E=1024, n=10 in fp64
// (8 x 8.19 MB); 12n+17 flops per node, 0.14 GFLOP, so the kernel is bound
// by device-memory bytes (about 20 us at the data sheet's 3.35 TB/s).  The
// design reads each input once and writes w once: u's column is loaded
// once into registers, the metric is read once per node, and nothing else
// leaves the SM.  The layer loop is common.cuh's ax_full_columns, shared
// with K2 and K3 (nekbone_ax_dots.cu).  It is a first, simple version: no
// TMA, no prefetch of the next layer's metric, one element per block.
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

template <int N, typename S, typename O>
__global__ void __launch_bounds__(N * N)
nekbone_ax_kernel(const S* __restrict__ u, const O* __restrict__ D,
                  const O* __restrict__ g, S* __restrict__ w) {
  using A = accum_t<S>;
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  __shared__ AxShared<N, A> sh;

  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const size_t e = blockIdx.x;
  const size_t base = e * N3 + j * N + i;

  load_D(sh, D, i, j);
  A uc[N];
  A wc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) uc[k] = convert<A>(u[base + k * N2]);
  ax_full_columns(sh, g + e * 6 * N3 + j * N + i, uc, wc, i, j);
#pragma unroll
  for (int k = 0; k < N; ++k) w[base + k * N2] = convert<S>(wc[k]);
}

template <int N, typename S, typename O>
cudaError_t launch(const S* u, const O* D, const O* g, S* w, int E,
                   cudaStream_t stream) {
  nekbone_ax_kernel<N, S, O><<<E, dim3(N, N), 0, stream>>>(u, D, g, w);
  return cudaGetLastError();
}

template <typename S, typename O>
int dispatch(const S* u, const O* D, const O* g, S* w, int E, int n,
             void* stream) {
  if (E <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N) \
  case N:               \
    return static_cast<int>(launch<N, S, O>(u, D, g, w, E, s));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// u, w: (E, n^3) in S; D: (n, n) and g: (E, 6, n^3) in O; all contiguous,
// on `stream`.  Returns cudaGetLastError() after the launch (0 on success).
#define NEKBONE_AX_ENTRY(SUFFIX, S, O)                                       \
  extern "C" int nekbone_ax_##SUFFIX(const void* u, const void* D,           \
                                     const void* g, void* w, int E, int n,   \
                                     void* stream) {                         \
    return nekbone::dispatch<S, O>(                                          \
        static_cast<const S*>(u), static_cast<const O*>(D),                  \
        static_cast<const O*>(g), static_cast<S*>(w), E, n, stream);         \
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
