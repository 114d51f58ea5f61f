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
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

template <int N, typename T, bool DOTS>
__global__ void __launch_bounds__(N * N)
nekbone_ax_dots_kernel(const T* __restrict__ p, const T* __restrict__ D,
                       const T* __restrict__ g, const T* __restrict__ mask,
                       const T* __restrict__ r, const T* __restrict__ c,
                       T* __restrict__ w, T* __restrict__ pap,
                       T* __restrict__ rcz) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  __shared__ AxShared<N, T> sh;
  __shared__ T red[2][N2];

  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const int tid = j * N + i;
  const size_t e = blockIdx.x;
  const size_t base = e * N3 + tid;

  load_D(sh, D, i, j);
  T pc[N];
  T wc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) pc[k] = p[base + k * N2];
  ax_full_columns(sh, g + e * 6 * N3 + tid, pc, wc, i, j);

  T part = T(0);
  T part_r = T(0);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const size_t o = base + k * N2;
    const T v = wc[k] * mask[o];
    part += pc[k] * v;
    w[o] = v;
    if (DOTS) {
      const T rk = r[o];
      part_r += (rk * c[o]) * rk;
    }
  }
  const T total = block_sum<N2>(part, red[0], tid);
  if (tid == 0) pap[e] = total;
  if (DOTS) {
    const T total_r = block_sum<N2>(part_r, red[1], tid);
    if (tid == 0) rcz[e] = total_r;
  }
}

template <int N, typename T, bool DOTS>
cudaError_t launch(const T* p, const T* D, const T* g, const T* mask,
                   const T* r, const T* c, T* w, T* pap, T* rcz, int E,
                   cudaStream_t stream) {
  nekbone_ax_dots_kernel<N, T, DOTS><<<E, dim3(N, N), 0, stream>>>(
      p, D, g, mask, r, c, w, pap, rcz);
  return cudaGetLastError();
}

template <typename T, bool DOTS>
int dispatch(const T* p, const T* D, const T* g, const T* mask, const T* r,
             const T* c, T* w, T* pap, T* rcz, int E, int n, void* stream) {
  if (E <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N)                                                     \
  case N:                                                                   \
    return static_cast<int>(                                                \
        launch<N, T, DOTS>(p, D, g, mask, r, c, w, pap, rcz, E, s));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// p, mask, w (and r, c for K2): (E, n^3); D: (n, n); g: (E, 6, n^3); pap
// (and rcz): (E,).  All contiguous, on `stream`.  Returns
// cudaGetLastError() after the launch (0 on success).
#ifdef NEKBONE_REAL_F64
extern "C" int nekbone_ax_pap_f64(const double* p, const double* D,
                                  const double* g, const double* mask,
                                  double* w, double* pap, int E, int n,
                                  void* stream) {
  return nekbone::dispatch<double, false>(p, D, g, mask, nullptr, nullptr, w,
                                          pap, nullptr, E, n, stream);
}

extern "C" int nekbone_ax_dots_f64(const double* p, const double* D,
                                   const double* g, const double* mask,
                                   const double* r, const double* c,
                                   double* w, double* pap, double* rcz,
                                   int E, int n, void* stream) {
  return nekbone::dispatch<double, true>(p, D, g, mask, r, c, w, pap, rcz, E,
                                         n, stream);
}
#endif

#ifdef NEKBONE_REAL_F32
extern "C" int nekbone_ax_pap_f32(const float* p, const float* D,
                                  const float* g, const float* mask,
                                  float* w, float* pap, int E, int n,
                                  void* stream) {
  return nekbone::dispatch<float, false>(p, D, g, mask, nullptr, nullptr, w,
                                         pap, nullptr, E, n, stream);
}

extern "C" int nekbone_ax_dots_f32(const float* p, const float* D,
                                   const float* g, const float* mask,
                                   const float* r, const float* c, float* w,
                                   float* pap, float* rcz, int E, int n,
                                   void* stream) {
  return nekbone::dispatch<float, true>(p, D, g, mask, r, c, w, pap, rcz, E,
                                        n, stream);
}
#endif
