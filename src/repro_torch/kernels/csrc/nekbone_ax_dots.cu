// K3 and K2: the operator of the v1 fused CG iteration, per element.
//
//     w   = mask * (D^T G D p)         (full 6-component metric, mask field)
//     pap = sum(p * w)                 (per-element partial, before assembly)
//     rcz = sum(r * c * r)             (K2 only: per-element partial)
//
// Replaces the TPU kernels src/repro/kernels/nekbone_ax.py:
// nekbone_ax_pap_kernel (K3, pallas_call at :441) and nekbone_ax_dots_kernel
// (K2, pallas_call at :373).  Both kept a block of elements resident in VMEM
// and emitted one partial per block.  Here they are K1's design
// (nekbone_ax.cu: one thread block per element, an n x n thread layer
// marching the k layers, D in shared memory, the layer loop common.cuh's
// ax_full_columns) with the mask multiply and the per-element partials
// added; one template serves both, DOTS selecting K2's extra operands.  The
// mask and the weight c are fields here, as in the reference's v1 API, so
// the kernels take any mesh, not only the structured box.
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
// f32).  pap is taken over the unrounded w in A, and w leaves rounded to S,
// as the TPU kernel does.  K2 is built for f64 and f32 only: no route
// launches it.  K3 moves 18 bytes per node in bf16 (p, 6 metric fields,
// mask, w) and 30 in bf16_ir (the metric in f32).
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

template <int N, typename S, typename O, typename A, bool DOTS>
__global__ void __launch_bounds__(N * N)
nekbone_ax_dots_kernel(const S* __restrict__ p, const O* __restrict__ D,
                       const O* __restrict__ g, const S* __restrict__ mask,
                       const S* __restrict__ r, const S* __restrict__ c,
                       S* __restrict__ w, A* __restrict__ pap,
                       A* __restrict__ rcz) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  __shared__ AxShared<N, A> sh;
  __shared__ A red[2][N2];

  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const int tid = j * N + i;
  const size_t e = blockIdx.x;
  const size_t base = e * N3 + tid;

  load_D(sh, D, i, j);
  A pc[N];
  A wc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) pc[k] = convert<A>(p[base + k * N2]);
  ax_full_columns(sh, g + e * 6 * N3 + tid, pc, wc, i, j);

  A part = A(0);
  A part_r = A(0);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const size_t o = base + k * N2;
    const A v = wc[k] * convert<A>(mask[o]);
    part += pc[k] * v;
    w[o] = convert<S>(v);
    if (DOTS) {
      const A rk = convert<A>(r[o]);
      part_r += (rk * convert<A>(c[o])) * rk;
    }
  }
  const A total = block_sum<N2>(part, red[0], tid);
  if (tid == 0) pap[e] = total;
  if (DOTS) {
    const A total_r = block_sum<N2>(part_r, red[1], tid);
    if (tid == 0) rcz[e] = total_r;
  }
}

template <int N, typename S, typename O, typename A, bool DOTS>
cudaError_t launch(const S* p, const O* D, const O* g, const S* mask,
                   const S* r, const S* c, S* w, A* pap, A* rcz, int E,
                   cudaStream_t stream) {
  nekbone_ax_dots_kernel<N, S, O, A, DOTS><<<E, dim3(N, N), 0, stream>>>(
      p, D, g, mask, r, c, w, pap, rcz);
  return cudaGetLastError();
}

template <typename S, typename O, typename A, bool DOTS>
int dispatch(const void* p, const void* D, const void* g, const void* mask,
             const void* r, const void* c, void* w, void* pap, void* rcz,
             int E, int n, void* stream) {
  if (E <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const S* ps = static_cast<const S*>(p);
  const O* Ds = static_cast<const O*>(D);
  const O* gs = static_cast<const O*>(g);
  const S* ms = static_cast<const S*>(mask);
  const S* rs = static_cast<const S*>(r);
  const S* cs = static_cast<const S*>(c);
  S* wo = static_cast<S*>(w);
  A* pa = static_cast<A*>(pap);
  A* rc = static_cast<A*>(rcz);
  switch (n) {
#define NEKBONE_CASE(N)                                                       \
  case N:                                                                     \
    return static_cast<int>(launch<N, S, O, A, DOTS>(ps, Ds, gs, ms, rs, cs,  \
                                                     wo, pa, rc, E, s));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// p, mask, w (and r, c for K2): (E, n^3) in S; D: (n, n) and g: (E, 6, n^3)
// in O; pap (and rcz): (E,) in A.  All contiguous, on `stream`.  Returns
// cudaGetLastError() after the launch (0 on success).
#define NEKBONE_AX_PAP_ENTRY(NAME, S, O, A)                                  \
  extern "C" int NAME(const void* p, const void* D, const void* g,           \
                      const void* mask, void* w, void* pap, int E, int n,    \
                      void* stream) {                                        \
    return nekbone::dispatch<S, O, A, false>(p, D, g, mask, nullptr, nullptr, \
                                             w, pap, nullptr, E, n, stream); \
  }
#define NEKBONE_AX_DOTS_ENTRY(NAME, S, O, A)                                 \
  extern "C" int NAME(const void* p, const void* D, const void* g,           \
                      const void* mask, const void* r, const void* c,        \
                      void* w, void* pap, void* rcz, int E, int n,           \
                      void* stream) {                                        \
    return nekbone::dispatch<S, O, A, true>(p, D, g, mask, r, c, w, pap, rcz, \
                                            E, n, stream);                   \
  }

#ifdef NEKBONE_REAL_F64
NEKBONE_AX_PAP_ENTRY(nekbone_ax_pap_f64, double, double, double)
NEKBONE_AX_DOTS_ENTRY(nekbone_ax_dots_f64, double, double, double)
#endif
#ifdef NEKBONE_REAL_F32
NEKBONE_AX_PAP_ENTRY(nekbone_ax_pap_f32, float, float, float)
NEKBONE_AX_DOTS_ENTRY(nekbone_ax_dots_f32, float, float, float)
#endif
#ifdef NEKBONE_REAL_BF16
NEKBONE_AX_PAP_ENTRY(nekbone_ax_pap_bf16, __nv_bfloat16, __nv_bfloat16, float)
#endif
#ifdef NEKBONE_REAL_BF16_IR
NEKBONE_AX_PAP_ENTRY(nekbone_ax_pap_bf16_ir, __nv_bfloat16, float, float)
#endif
