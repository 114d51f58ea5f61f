// K6: K4 (the front half of one v2 CG iteration) over b right-hand sides.
//
//     for each lane l:
//       p_l   = r_l + beta_l * p_prev_l     (stored)
//       w_l   = mask * (D^T G D p_l)        (unassembled; diagonal metric)
//       pap_l = sum(p_l * w_l)              (per-element partial)
//
// Replaces the TPU kernel
// src/repro/kernels/nekbone_ax.py:nekbone_ax_slab_block_kernel (pallas_call
// at :825).  As in K4 (nekbone_ax_slab.cu) the work is per element: one
// block, an n x n thread layer marching the k layers, the unassembled
// masked w out, the assembly left to the update kernel (K7).  What bounds
// it on the card is the operator's shared-memory traffic and barriers, not
// device memory (K4 and K11 measured that), so the design shares them
// between lanes and keeps enough warps in flight:
//
// * the lanes go through the layer sweep in pairs (kLanes; blockIdx.y picks
//   the pair, an odd b's last lane runs alone): common.cuh's
//   ax_diag_columns_lanes reads each value of D and of the metric once, and
//   takes two barriers a layer, for both lanes;
// * a pair's p columns, the operator's inputs, live in dynamic shared
//   memory (one column of n^3 values per lane), the outputs wc in
//   registers, and the metric is read once per pair, layer by layer (from
//   device memory, then mostly from L2); a lane alone keeps its column and
//   its metric in registers, as the kernel of one lane at a time did;
// * the register cap of __launch_bounds__ is 128, four blocks of 100
//   threads an SM at n = 10 (at 80 registers the pairs spill, and the
//   kernel is slower).  Two elements side by side in a block measured no
//   faster at b = 4 and slower at b = 1 (PERF.md), so a block holds one.
//
// Each lane keeps K4's arithmetic operation for operation: the same rounded
// p update, the operator's products contracted and summed in the same
// order, the same mask product, and pap summed by block_sum<N2>'s tree.
// Each lane's p, w and pap are therefore bitwise K4's on that lane.
//
// Bound: bytes.  Per lane p_prev and r in, p and w out (4 fields), plus the
// 3 metric diagonals once: (4b + 3) fields, 8.19 MB each at E=1024, n=10,
// fp64 — 155.6 MB at b=4, 46.4 us at 3.35 TB/s.  About 12n + 10 flops per
// node and lane.  The design moves (4b + 3 ceil(b/2)) fields: the metric
// once per pair.  pap leaves as (b, E) values, summed per lane outside.
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

// Lanes that share one layer sweep: pairs (in fours the outputs' 4n values
// spill at the register cap, and the kernel is slower;
// scripts/k8_k6_compare.py --ablation).
constexpr int kLanes = 2;
// The operands of one launch and the block's element.
template <int N, typename T>
struct BlockLanes {
  const T* __restrict__ p_prev;
  const T* __restrict__ r;
  const T* __restrict__ g3;
  const T* __restrict__ mx;
  const T* __restrict__ my;
  const T* __restrict__ mz;
  const T* __restrict__ beta;
  T* __restrict__ p_out;
  T* __restrict__ w;
  T* __restrict__ pap;
  AxSharedL<N, T, kLanes>* sh;
  T (*red)[N * N];  // [kLanes][n^2]: the pap sums
  T* cols;          // [kLanes][n^3]: the lanes' p columns
  size_t e, E;
  int ix, iy, iz;
};

// Lanes l0 .. l0 + W - 1 of the block's element: p, the operator, w and
// pap, each lane as K4 computes it.  A group's p columns live in the
// block's shared columns; a lane alone keeps its column in registers, as
// K4 does.
template <int N, typename T, int W>
__device__ __forceinline__ void lanes(const BlockLanes<N, T>& a, int l0,
                                      int i, int j) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  const int tid = j * N + i;
  const T* ge = a.g3 + a.e * 3 * N3 + tid;
  // a lane alone loads its element's metric into registers before the
  // sweep, as K6's kernel of one lane at a time did: read layer by layer,
  // each load's latency shows once the metric is past L2 (E = 4096)
  T gc[3][N];
  if constexpr (W == 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      gc[0][k] = ge[0 * N3 + k * N2];
      gc[1][k] = ge[1 * N3 + k * N2];
      gc[2][k] = ge[2 * N3 + k * N2];
    }
  }
  size_t base[W];
  T* col[W];
  T pc[N];
#pragma unroll
  for (int q = 0; q < W; ++q) {
    base[q] = ((l0 + q) * a.E + a.e) * N3 + tid;
    col[q] = a.cols + q * N3 + tid;
    const T b = a.beta[l0 + q];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const size_t o = base[q] + k * N2;
      const T v = add_rn(a.r[o], mul_rn(b, a.p_prev[o]));
      if (W == 1)
        pc[k] = v;
      else
        col[q][k * N2] = v;
      a.p_out[o] = v;
    }
  }
  T wc[W][N];
  if constexpr (W == 1) {
    ax_diag_columns_g(
        a.sh->one, [&gc](int c, int k) { return gc[c][k]; }, pc, wc[0], i,
        j);
  } else {
    SharedColumn<N, T> uc[W];
#pragma unroll
    for (int q = 0; q < W; ++q) uc[q] = SharedColumn<N, T>{col[q]};
    ax_diag_columns_lanes(*a.sh, ge, uc, wc, i, j);
  }

  // the box mask is (mz * my) * mx; all factors are 0 or 1, so the product
  // is exact in any order (K4 forms the same values).
  const T myx = a.my[a.iy * N + j] * a.mx[a.ix * N + i];
  T part[W];
#pragma unroll
  for (int q = 0; q < W; ++q) {
    part[q] = T(0);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const T v = wc[q][k] * (a.mz[a.iz * N + k] * myx);
      part[q] += (W == 1 ? pc[k] : col[q][k * N2]) * v;
      a.w[base[q] + k * N2] = v;
    }
  }
  // block_sum<N2>'s tree for each lane, the lanes' barriers shared
#pragma unroll
  for (int q = 0; q < W; ++q) a.red[q][tid] = part[q];
  __syncthreads();
  constexpr int kHalf = pow2_ceil(N2) / 2;
#pragma unroll
  for (int s = kHalf; s > 0; s >>= 1) {
    if (tid < s && tid + s < N2) {
#pragma unroll
      for (int q = 0; q < W; ++q) a.red[q][tid] += a.red[q][tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
#pragma unroll
    for (int q = 0; q < W; ++q) a.pap[(l0 + q) * a.E + a.e] = a.red[q][0];
  }
}

// The group's lanes, w of them (1 <= w <= W): one instantiation per width.
template <int N, typename T, int W>
__device__ __forceinline__ void lanes_of(const BlockLanes<N, T>& a, int l0,
                                         int w, int i, int j) {
  if constexpr (W == 1) {
    lanes<N, T, 1>(a, l0, i, j);
  } else {
    if (w == W)
      lanes<N, T, W>(a, l0, i, j);
    else
      lanes_of<N, T, W - 1>(a, l0, w, i, j);
  }
}

// Block (N, N), grid (E, ceil(b / kLanes)): block x works on element x for
// the lanes of group blockIdx.y.
template <int N, typename T>
__global__ void __launch_bounds__(N * N, min_blocks(N * N, 128))
nekbone_ax_slab_block_kernel(const T* __restrict__ p_prev,
                             const T* __restrict__ r, const T* __restrict__ D,
                             const T* __restrict__ g3,
                             const T* __restrict__ mx,
                             const T* __restrict__ my,
                             const T* __restrict__ mz,
                             const T* __restrict__ beta,
                             T* __restrict__ p_out, T* __restrict__ w,
                             T* __restrict__ pap, int ex, int ey, int nrhs) {
  __shared__ AxSharedL<N, T, kLanes> sh;
  __shared__ T red[kLanes][N * N];
  extern __shared__ __align__(16) unsigned char col_bytes[];

  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const size_t e = blockIdx.x;
  const BlockLanes<N, T> a{
      p_prev, r, g3, mx, my, mz, beta, p_out, w, pap, &sh, red,
      reinterpret_cast<T*>(col_bytes), e, gridDim.x,
      static_cast<int>(e % ex), static_cast<int>((e / ex) % ey),
      static_cast<int>(e / (static_cast<size_t>(ex) * ey))};

  load_D(sh.one, D, i, j);
  const int l0 = blockIdx.y * kLanes;
  const int width = nrhs - l0 < kLanes ? nrhs - l0 : kLanes;
  lanes_of<N, T, kLanes>(a, l0, width, i, j);
}

template <int N, typename T>
cudaError_t launch(const T* p_prev, const T* r, const T* D, const T* g3,
                   const T* mx, const T* my, const T* mz, const T* beta,
                   T* p_out, T* w, T* pap, int ex, int ey, int ez, int nrhs,
                   cudaStream_t stream) {
  const size_t dyn = static_cast<size_t>(kLanes) * N * N * N * sizeof(T);
  const void* fn = reinterpret_cast<const void*>(
      &nekbone_ax_slab_block_kernel<N, T>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dyn));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(ex * ey * ez),
                  static_cast<unsigned>((nrhs + kLanes - 1) / kLanes));
  nekbone_ax_slab_block_kernel<N, T><<<grid, dim3(N, N), dyn, stream>>>(
      p_prev, r, D, g3, mx, my, mz, beta, p_out, w, pap, ex, ey, nrhs);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const T* p_prev, const T* r, const T* D, const T* g3,
             const T* mx, const T* my, const T* mz, const T* beta, T* p_out,
             T* w, T* pap, int ex, int ey, int ez, int n, int nrhs,
             void* stream) {
  if (ex <= 0 || ey <= 0 || ez <= 0 || nrhs <= 0 || nrhs > 65535 * kLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N)                                                  \
  case N:                                                                \
    return static_cast<int>(launch<N, T>(p_prev, r, D, g3, mx, my, mz,   \
                                         beta, p_out, w, pap, ex, ey, ez, \
                                         nrhs, s));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// p_prev, r, p_out, w: (b, E, n^3); D: (n, n); g3: (E, 3, n^3); mx: (EX, n);
// my: (EY, n); mz: (EZ, n); beta: (b,); pap: (b, E).  Elements z-major over
// (EX, EY, EZ).  Returns cudaGetLastError() after the launch.
#ifdef NEKBONE_REAL_F64
extern "C" int nekbone_ax_slab_block_f64(
    const double* p_prev, const double* r, const double* D, const double* g3,
    const double* mx, const double* my, const double* mz, const double* beta,
    double* p_out, double* w, double* pap, int ex, int ey, int ez, int n,
    int nrhs, void* stream) {
  return nekbone::dispatch<double>(p_prev, r, D, g3, mx, my, mz, beta, p_out,
                                   w, pap, ex, ey, ez, n, nrhs, stream);
}
#endif

#ifdef NEKBONE_REAL_F32
extern "C" int nekbone_ax_slab_block_f32(
    const float* p_prev, const float* r, const float* D, const float* g3,
    const float* mx, const float* my, const float* mz, const float* beta,
    float* p_out, float* w, float* pap, int ex, int ey, int ez, int n,
    int nrhs, void* stream) {
  return nekbone::dispatch<float>(p_prev, r, D, g3, mx, my, mz, beta, p_out,
                                  w, pap, ex, ey, ez, n, nrhs, stream);
}
#endif
