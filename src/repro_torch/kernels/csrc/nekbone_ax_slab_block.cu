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
//
// Storage and accumulation (common.cuh), K4's roles: S the CG vectors
// (p_prev, r, p, w and the mask factors), O the operator's data (D,
// metric), A beta, the arithmetic and pap.  Four builds: f64 and f32 (one
// type throughout); bf16 (S = O = bf16, A = f32) and bf16_ir (S = bf16,
// O = A = f32).  Each lane rounds as K4 does: p is rounded to S before the
// operator (the stored p, which K7 applies alpha to, is the one the
// operator sees), w is rounded to S once, and pap is A over the unrounded
// w.  A pair's p columns stay in shared memory as the stored S values,
// read as A; the layers, D and the pap sums are A.  So each bf16 lane is
// bitwise the bf16 K4's on that lane too.  At b=4 bf16 moves 38 bytes a
// node (4 lanes of p_prev, r, p, w in bf16 and the metric), bf16_ir 44.
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

// Lanes that share one layer sweep: pairs (in fours the outputs' 4n values
// spill at the register cap, and the kernel is slower;
// scripts/k8_k6_compare.py --ablation).
constexpr int kLanes = 2;
// The operands of one launch and the block's element.
template <int N, typename S, typename O, typename A>
struct BlockLanes {
  const S* __restrict__ p_prev;
  const S* __restrict__ r;
  const O* __restrict__ g3;
  const S* __restrict__ mx;
  const S* __restrict__ my;
  const S* __restrict__ mz;
  const A* __restrict__ beta;
  S* __restrict__ p_out;
  S* __restrict__ w;
  A* __restrict__ pap;
  AxSharedL<N, A, kLanes>* sh;
  A (*red)[N * N];  // [kLanes][n^2]: the pap sums
  S* cols;          // [kLanes][n^3]: the lanes' stored p columns
  size_t e, E;
  int ix, iy, iz;
};

// Lanes l0 .. l0 + W - 1 of the block's element: p, the operator, w and
// pap, each lane as K4 computes it.  A group's p columns live in the
// block's shared columns; a lane alone keeps its column in registers, as
// K4 does.
template <int N, typename S, typename O, typename A, int W>
__device__ __forceinline__ void lanes(const BlockLanes<N, S, O, A>& a,
                                      int l0, int i, int j) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  const int tid = j * N + i;
  const O* ge = a.g3 + a.e * 3 * N3 + tid;
  // a lane alone loads its element's metric into registers before the
  // sweep, as K6's kernel of one lane at a time did: read layer by layer,
  // each load's latency shows once the metric is past L2 (E = 4096)
  A gc[3][N];
  if constexpr (W == 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      gc[0][k] = convert<A>(ge[0 * N3 + k * N2]);
      gc[1][k] = convert<A>(ge[1 * N3 + k * N2]);
      gc[2][k] = convert<A>(ge[2 * N3 + k * N2]);
    }
  }
  size_t base[W];
  S* col[W];
  A pc[N];
#pragma unroll
  for (int q = 0; q < W; ++q) {
    base[q] = ((l0 + q) * a.E + a.e) * N3 + tid;
    col[q] = a.cols + q * N3 + tid;
    const A b = a.beta[l0 + q];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const size_t o = base[q] + k * N2;
      // the stored direction, and the operator applied to exactly it (the
      // round trip through S is the identity for f64 and f32)
      const S v = convert<S>(
          add_rn(convert<A>(a.r[o]), mul_rn(b, convert<A>(a.p_prev[o]))));
      if (W == 1)
        pc[k] = convert<A>(v);
      else
        col[q][k * N2] = v;
      a.p_out[o] = v;
    }
  }
  A wc[W][N];
  if constexpr (W == 1) {
    ax_diag_columns_g(
        a.sh->one, [&gc](int c, int k) { return gc[c][k]; }, pc, wc[0], i,
        j);
  } else {
    SharedColumn<N, A, S> uc[W];
#pragma unroll
    for (int q = 0; q < W; ++q) uc[q] = SharedColumn<N, A, S>{col[q]};
    ax_diag_columns_lanes(*a.sh, ge, uc, wc, i, j);
  }

  // the box mask is (mz * my) * mx; all factors are 0 or 1, so the product
  // is exact in any order (K4 forms the same values).
  const A myx =
      convert<A>(a.my[a.iy * N + j]) * convert<A>(a.mx[a.ix * N + i]);
  A part[W];
#pragma unroll
  for (int q = 0; q < W; ++q) {
    part[q] = A(0);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const A v = wc[q][k] * (convert<A>(a.mz[a.iz * N + k]) * myx);
      part[q] += (W == 1 ? pc[k] : convert<A>(col[q][k * N2])) * v;
      a.w[base[q] + k * N2] = convert<S>(v);
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
template <int N, typename S, typename O, typename A, int W>
__device__ __forceinline__ void lanes_of(const BlockLanes<N, S, O, A>& a,
                                         int l0, int w, int i, int j) {
  if constexpr (W == 1) {
    lanes<N, S, O, A, 1>(a, l0, i, j);
  } else {
    if (w == W)
      lanes<N, S, O, A, W>(a, l0, i, j);
    else
      lanes_of<N, S, O, A, W - 1>(a, l0, w, i, j);
  }
}

// Block (N, N), grid (E, ceil(b / kLanes)): block x works on element x for
// the lanes of group blockIdx.y.
template <int N, typename S, typename O, typename A>
__global__ void __launch_bounds__(N * N, min_blocks(N * N, 128))
nekbone_ax_slab_block_kernel(const S* __restrict__ p_prev,
                             const S* __restrict__ r, const O* __restrict__ D,
                             const O* __restrict__ g3,
                             const S* __restrict__ mx,
                             const S* __restrict__ my,
                             const S* __restrict__ mz,
                             const A* __restrict__ beta,
                             S* __restrict__ p_out, S* __restrict__ w,
                             A* __restrict__ pap, int ex, int ey, int nrhs) {
  __shared__ AxSharedL<N, A, kLanes> sh;
  __shared__ A red[kLanes][N * N];
  extern __shared__ __align__(16) unsigned char col_bytes[];

  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const size_t e = blockIdx.x;
  const BlockLanes<N, S, O, A> a{
      p_prev, r, g3, mx, my, mz, beta, p_out, w, pap, &sh, red,
      reinterpret_cast<S*>(col_bytes), e, gridDim.x,
      static_cast<int>(e % ex), static_cast<int>((e / ex) % ey),
      static_cast<int>(e / (static_cast<size_t>(ex) * ey))};

  load_D(sh.one, D, i, j);
  const int l0 = blockIdx.y * kLanes;
  const int width = nrhs - l0 < kLanes ? nrhs - l0 : kLanes;
  lanes_of<N, S, O, A, kLanes>(a, l0, width, i, j);
}

template <int N, typename S, typename O, typename A>
cudaError_t launch(const S* p_prev, const S* r, const O* D, const O* g3,
                   const S* mx, const S* my, const S* mz, const A* beta,
                   S* p_out, S* w, A* pap, int ex, int ey, int ez, int nrhs,
                   cudaStream_t stream) {
  // a pair's stored p columns
  const size_t dyn = static_cast<size_t>(kLanes) * N * N * N * sizeof(S);
  const void* fn = reinterpret_cast<const void*>(
      &nekbone_ax_slab_block_kernel<N, S, O, A>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dyn));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(ex * ey * ez),
                  static_cast<unsigned>((nrhs + kLanes - 1) / kLanes));
  nekbone_ax_slab_block_kernel<N, S, O, A><<<grid, dim3(N, N), dyn, stream>>>(
      p_prev, r, D, g3, mx, my, mz, beta, p_out, w, pap, ex, ey, nrhs);
  return cudaGetLastError();
}

template <typename S, typename O, typename A>
int dispatch(const S* p_prev, const S* r, const O* D, const O* g3,
             const S* mx, const S* my, const S* mz, const A* beta, S* p_out,
             S* w, A* pap, int ex, int ey, int ez, int n, int nrhs,
             void* stream) {
  if (ex <= 0 || ey <= 0 || ez <= 0 || nrhs <= 0 || nrhs > 65535 * kLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N)                                                     \
  case N:                                                                   \
    return static_cast<int>(launch<N, S, O, A>(p_prev, r, D, g3, mx, my, mz, \
                                               beta, p_out, w, pap, ex, ey,  \
                                               ez, nrhs, s));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// p_prev, r, p_out, w: (b, E, n^3) in S; D: (n, n) and g3: (E, 3, n^3) in
// O; mx: (EX, n), my: (EY, n), mz: (EZ, n) in S; beta: (b,) and pap: (b, E)
// in A.  Elements z-major over (EX, EY, EZ).  Returns cudaGetLastError()
// after the launch.
#define NEKBONE_AX_SLAB_BLOCK_ENTRY(NAME, S, O, A)                            \
  extern "C" int NAME(const void* p_prev, const void* r, const void* D,      \
                      const void* g3, const void* mx, const void* my,        \
                      const void* mz, const void* beta, void* p_out,         \
                      void* w, void* pap, int ex, int ey, int ez, int n,     \
                      int nrhs, void* stream) {                              \
    return nekbone::dispatch<S, O, A>(                                       \
        static_cast<const S*>(p_prev), static_cast<const S*>(r),             \
        static_cast<const O*>(D), static_cast<const O*>(g3),                 \
        static_cast<const S*>(mx), static_cast<const S*>(my),                \
        static_cast<const S*>(mz), static_cast<const A*>(beta),              \
        static_cast<S*>(p_out), static_cast<S*>(w), static_cast<A*>(pap),    \
        ex, ey, ez, n, nrhs, stream);                                        \
  }

#ifdef NEKBONE_REAL_F64
NEKBONE_AX_SLAB_BLOCK_ENTRY(nekbone_ax_slab_block_f64, double, double,
                            double)
#endif
#ifdef NEKBONE_REAL_F32
NEKBONE_AX_SLAB_BLOCK_ENTRY(nekbone_ax_slab_block_f32, float, float, float)
#endif
#ifdef NEKBONE_REAL_BF16
NEKBONE_AX_SLAB_BLOCK_ENTRY(nekbone_ax_slab_block_bf16, __nv_bfloat16,
                            __nv_bfloat16, float)
#endif
#ifdef NEKBONE_REAL_BF16_IR
NEKBONE_AX_SLAB_BLOCK_ENTRY(nekbone_ax_slab_block_bf16_ir, __nv_bfloat16,
                            float, float)
#endif
