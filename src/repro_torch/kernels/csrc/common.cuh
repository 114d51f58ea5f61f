// Shared helpers of the Nekbone kernels (nekbone_ax.cu, nekbone_ax_dots.cu,
// nekbone_ax_slab.cu, nekbone_cg_update.cu, nekbone_pcg_update.cu,
// nekbone_cheb_apply.cu, nekbone_ax_slab_block.cu,
// nekbone_cg_update_block.cu, nekbone_ax_powers.cu,
// nekbone_sstep_update.cu, nekbone_interp.cu).
//
// * Rounded arithmetic without contraction.  The CG vector updates
//   (p = r + beta p, x += alpha p, r -= alpha w, the Chebyshev recurrence)
//   use explicitly rounded multiply and add, so nvcc does not fuse them into
//   an FMA: the stored vectors are then bitwise what the plain PyTorch
//   versions compute (one rounding per operation, as separate tensor ops
//   do).  The tensor contractions are free to use FMA.
// * A deterministic block sum: a fixed shared-memory tree, so partial inner
//   products are the same from run to run (no atomics).
// * The local operator of one element, with the full metric (K1, K2, K3)
//   or its diagonal (K4, K6, K8, K11), for one input or several (K6's
//   lanes, K8's two chains) through one layer sweep, and the node-by-node
//   direct-stiffness sum of an unassembled field in core/gs.ds_sum_local's
//   tree (K10; K8 and K11 in a branch-free form with coherent loads, K5 and
//   K7 in one with read-only loads beside the walkers' own staged copy).
// * The block shape and occupancy query of the persistent cooperative
//   kernels (K8, K11), and the register cap of K6's.
// * Dispatch of the run-time n (2..16) to the template instantiations.
// * Storage apart from accumulation.  A field is loaded in its storage type
//   and upcast to the accumulation type (convert), the arithmetic runs in
//   the accumulation type, and a field output is rounded to its storage
//   type on store (round to nearest even, as torch's .to() does).  f64 and
//   f32 accumulate in their own type, so for them every convert is the
//   identity and the arithmetic is what it was before the split; bf16
//   (__nv_bfloat16) accumulates in f32 (accum_t), the reference's _accum
//   rule.  The rounded, uncontracted helpers work in the accumulation type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace nekbone {

// The accumulation type of a storage type: f64 and f32 their own, bf16 f32.
template <typename S>
struct Accum {
  using type = S;
};
template <>
struct Accum<__nv_bfloat16> {
  using type = float;
};
template <typename S>
using accum_t = typename Accum<S>::type;

// Value conversion between storage and accumulation types: exact upward,
// round to nearest even downward, the identity within one type.
template <typename To, typename From>
__device__ __forceinline__ To convert(From v) {
  return static_cast<To>(v);
}
template <>
__device__ __forceinline__ float convert<float, __nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 convert<__nv_bfloat16, float>(
    float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
// correctly rounded 1 / a, as torch's reciprocal division gives it.
__device__ __forceinline__ double rcp_rn(double a) { return __drcp_rn(a); }
__device__ __forceinline__ float rcp_rn(float a) { return __frcp_rn(a); }

__host__ __device__ constexpr int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// Sum of one value per thread over the block's NT threads (tid < NT); the
// result is valid in thread 0.  `sh` holds at least NT values.
template <int NT, typename T>
__device__ __forceinline__ T block_sum(T v, T* sh, int tid) {
  sh[tid] = v;
  __syncthreads();
  constexpr int kHalf = pow2_ceil(NT) / 2;
#pragma unroll
  for (int s = kHalf; s > 0; s >>= 1) {
    if (tid < s && tid + s < NT) sh[tid] += sh[tid + s];
    __syncthreads();
  }
  return sh[0];
}

// The largest s of the s-step kernels (K8, K9): the Gram tile and the
// coefficient rows are sized by it.  The monomial basis loses fp64 parity
// with plain CG well before it (core/cg_sstep.py).
constexpr int kSstepMaxS = 10;
constexpr int kSstepMaxK = 2 * kSstepMaxS + 1;

// ---------------------------------------------------------------------------
// Local operator, one element per n x n thread block.
// ---------------------------------------------------------------------------

// Shared memory of ax_diag_columns: D and D^T, and three layers.
template <int N, typename T>
struct AxShared {
  T D[N][N];
  T Dt[N][N];
  T u[N][N];
  T r[N][N];
  T s[N][N];
};

// Thread (i, j) loads D[j][i] and its transpose, upcast to the
// accumulation type T; the first barrier of ax_diag_columns publishes them.
template <int N, typename T, typename O>
__device__ __forceinline__ void load_D(AxShared<N, T>& sh,
                                       const O* __restrict__ D, int i, int j) {
  const T d = convert<T>(D[j * N + i]);
  sh.D[j][i] = d;
  sh.Dt[i][j] = d;
}

// w = D^T M D u for one element: thread (i, j) holds the column
// uc[k] = u[k][j][i] (a register array, or anything indexable that reads
// it, such as K11's column in shared memory) and receives wc[k] =
// w[k][j][i] (unassembled, unmasked).  metric(k, wr, ws, wt, ur, us, ut) applies the metric of the
// thread's node at layer k to the reference-space gradient (wr, ws, wt).
// The layer loop marches k: the r- and s-contractions go through the shared
// layer, the t-contraction reads the thread's own column, and the t-part of
// D^T scatters into all of wc.  Two calls in a row need no barrier between
// them, for the reason the layers of one call need none (see the end of the
// loop).
template <int N, typename T, typename Metric, typename U>
__device__ __forceinline__ void ax_columns(AxShared<N, T>& sh, Metric metric,
                                           const U& uc, T (&wc)[N], int i,
                                           int j) {
#pragma unroll
  for (int k = 0; k < N; ++k) wc[k] = T(0);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    sh.u[j][i] = uc[k];
    __syncthreads();
    T wr = T(0), ws = T(0), wt = T(0);
#pragma unroll
    for (int l = 0; l < N; ++l) {
      wr += sh.Dt[l][i] * sh.u[j][l];
      ws += sh.D[j][l] * sh.u[l][i];
      wt += sh.D[k][l] * uc[l];
    }
    T ur, us, ut;
    metric(k, wr, ws, wt, ur, us, ut);
    sh.r[j][i] = ur;
    sh.s[j][i] = us;
    __syncthreads();
    T acc = T(0);
#pragma unroll
    for (int l = 0; l < N; ++l) {
      acc += sh.D[l][i] * sh.r[j][l];
      acc += sh.D[l][j] * sh.s[l][i];
    }
    wc[k] += acc;
#pragma unroll
    for (int m = 0; m < N; ++m) wc[m] += sh.D[k][m] * ut;
    // The next layer writes u before its first barrier and r/s only after
    // it; every read of this layer's u happened before the second barrier
    // above, and of r/s before any thread reaches the next first barrier.
  }
}

// The diagonal metric: g(c, k) returns diagonal c (rr, ss, tt) at the
// thread's node of layer k.
template <int N, typename T, typename Metric, typename U>
__device__ __forceinline__ void ax_diag_columns_g(AxShared<N, T>& sh,
                                                  Metric g, const U& uc,
                                                  T (&wc)[N], int i, int j) {
  ax_columns(
      sh,
      [&g](int k, T wr, T ws, T wt, T& ur, T& us, T& ut) {
        ur = g(0, k) * wr;
        us = g(1, k) * ws;
        ut = g(2, k) * wt;
      },
      uc, wc, i, j);
}

// The same with the metric read from device memory (in its storage type
// G): ge points at the element's metric diagonal (3, n^3) plus the
// thread's offset j * n + i.
template <int N, typename T, typename G, typename U>
__device__ __forceinline__ void ax_diag_columns(AxShared<N, T>& sh,
                                                const G* __restrict__ ge,
                                                const U& uc, T (&wc)[N],
                                                int i, int j) {
  ax_diag_columns_g(
      sh,
      [ge](int c, int k) {
        return convert<T>(ge[c * (N * N * N) + k * (N * N)]);
      },
      uc, wc, i, j);
}

// Several inputs through one layer sweep (K6's lanes, K8's two chains):
// ax_diag_columns on each uc[q] into wc[q], operation for operation as one
// call on that input alone (the same products, contracted and summed in
// the same order, so each output is bitwise the one-input call's), with
// each value of D and of the metric read once for all W inputs and two
// barriers a layer for all.  The first input's layers live in sh.one (so
// that ax_diag_columns(sh.one, ...) runs one input on the same memory),
// input q's in u[q - 1], r[q - 1], s[q - 1].
template <int N, typename T, int L>
struct AxSharedL {
  static constexpr int kMore = L > 1 ? L - 1 : 1;
  AxShared<N, T> one;
  T u[kMore][N][N];
  T r[kMore][N][N];
  T s[kMore][N][N];
};

template <int N, typename T, int L>
__device__ __forceinline__ T (&lane_u(AxSharedL<N, T, L>& sh, int q))[N][N] {
  return q == 0 ? sh.one.u : sh.u[q - 1];
}
template <int N, typename T, int L>
__device__ __forceinline__ T (&lane_r(AxSharedL<N, T, L>& sh, int q))[N][N] {
  return q == 0 ? sh.one.r : sh.r[q - 1];
}
template <int N, typename T, int L>
__device__ __forceinline__ T (&lane_s(AxSharedL<N, T, L>& sh, int q))[N][N] {
  return q == 0 ? sh.one.s : sh.s[q - 1];
}

template <int N, typename T, int L, typename G, typename U, int W>
__device__ __forceinline__ void ax_diag_columns_lanes(AxSharedL<N, T, L>& sh,
                                                      const G* __restrict__ ge,
                                                      const U (&uc)[W],
                                                      T (&wc)[W][N], int i,
                                                      int j) {
  static_assert(W >= 1 && W <= L, "ax_diag_columns_lanes: 1 <= W <= L");
  AxShared<N, T>& s0 = sh.one;
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int q = 0; q < W; ++q) wc[q][k] = T(0);
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int q = 0; q < W; ++q) lane_u(sh, q)[j][i] = uc[q][k];
    __syncthreads();
    T wr[W], ws[W], wt[W];
#pragma unroll
    for (int q = 0; q < W; ++q) wr[q] = ws[q] = wt[q] = T(0);
#pragma unroll
    for (int l = 0; l < N; ++l) {
      const T dt = s0.Dt[l][i];
      const T dj = s0.D[j][l];
      const T dk = s0.D[k][l];
#pragma unroll
      for (int q = 0; q < W; ++q) {
        wr[q] += dt * lane_u(sh, q)[j][l];
        ws[q] += dj * lane_u(sh, q)[l][i];
        wt[q] += dk * uc[q][l];
      }
    }
    const T grr = convert<T>(ge[0 * (N * N * N) + k * (N * N)]);
    const T gss = convert<T>(ge[1 * (N * N * N) + k * (N * N)]);
    const T gtt = convert<T>(ge[2 * (N * N * N) + k * (N * N)]);
    T ut[W];
#pragma unroll
    for (int q = 0; q < W; ++q) {
      ut[q] = gtt * wt[q];
      lane_r(sh, q)[j][i] = grr * wr[q];
      lane_s(sh, q)[j][i] = gss * ws[q];
    }
    __syncthreads();
    T acc[W];
#pragma unroll
    for (int q = 0; q < W; ++q) acc[q] = T(0);
#pragma unroll
    for (int l = 0; l < N; ++l) {
      const T di = s0.D[l][i];
      const T dj = s0.D[l][j];
#pragma unroll
      for (int q = 0; q < W; ++q) {
        acc[q] += di * lane_r(sh, q)[j][l];
        acc[q] += dj * lane_s(sh, q)[l][i];
      }
    }
#pragma unroll
    for (int q = 0; q < W; ++q) wc[q][k] += acc[q];
#pragma unroll
    for (int m = 0; m < N; ++m) {
      const T dm = s0.D[k][m];
#pragma unroll
      for (int q = 0; q < W; ++q) wc[q][m] += dm * ut[q];
    }
  }
}

// The full metric (rr, rs, rt, ss, st, tt) read from device memory: ge
// points at the element's (6, n^3) metric plus the thread's offset (K1, K2,
// K3).
template <int N, typename T, typename G>
__device__ __forceinline__ void ax_full_columns(AxShared<N, T>& sh,
                                                const G* __restrict__ ge,
                                                const T (&uc)[N], T (&wc)[N],
                                                int i, int j) {
  ax_columns(
      sh,
      [ge](int k, T wr, T ws, T wt, T& ur, T& us, T& ut) {
        const G* gk = ge + k * (N * N);
        const T grr = convert<T>(gk[0 * (N * N * N)]);
        const T grs = convert<T>(gk[1 * (N * N * N)]);
        const T grt = convert<T>(gk[2 * (N * N * N)]);
        const T gss = convert<T>(gk[3 * (N * N * N)]);
        const T gst = convert<T>(gk[4 * (N * N * N)]);
        const T gtt = convert<T>(gk[5 * (N * N * N)]);
        ur = grr * wr + grs * ws + grt * wt;
        us = grs * wr + gss * ws + gst * wt;
        ut = grt * wr + gst * ws + gtt * wt;
      },
      uc, wc, i, j);
}

// Masked A_loc of the thread's column dc, written unassembled to ad: the box
// mask (mz * my) * mx from its per-axis factors, whose values 0 and 1 make
// any order of the product exact (K8, K11).
template <int N, typename T>
__device__ __forceinline__ void masked_ax(AxShared<N, T>& sh,
                                          const T* __restrict__ g3,
                                          const T* __restrict__ mx,
                                          const T* __restrict__ my,
                                          const T* __restrict__ mz,
                                          const T (&dc)[N], T* ad, size_t e,
                                          int i, int j, int ix, int iy,
                                          int iz) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  const int tid = j * N + i;
  T wc[N];
  ax_diag_columns(sh, g3 + e * 3 * N3 + tid, dc, wc, i, j);
  const T myx = my[iy * N + j] * mx[ix * N + i];
#pragma unroll
  for (int k = 0; k < N; ++k)
    ad[e * N3 + tid + k * N2] = wc[k] * (mz[iz * N + k] * myx);
}

// ---------------------------------------------------------------------------
// Persistent cooperative kernels (K8, K11): one launch in which every block
// is resident at once and owns a contiguous, z-major range of elements for
// all its steps, with grid-wide barriers between them.  A block is (n, n, P)
// threads: P elements side by side, each slice an n x n layer marching its
// element's layers.
// ---------------------------------------------------------------------------

// Elements a block works on side by side (its z extent) in K11: at most
// 512 threads, so that two blocks an SM keep every owned element of the
// paper case (E = 1024, fp64, n = 10) in flight at once.
template <int N>
constexpr int kSlices = N >= 12 ? 2 : N >= 8 ? 4 : N >= 5 ? 8 : 16;
// Blocks an SM must hold at up to `registers` registers a thread: ptxas
// keeps to what lets them be resident (also K6's cap).
constexpr int min_blocks(int threads, int registers) {
  const int fit = 65536 / (registers * ((threads + 31) / 32 * 32));
  return fit > 1 ? fit : 1;
}
// K11 at up to 78 registers (the chain of launches it replaced took
// 74-78): 72 at n = 10, two blocks of 13 warps.
template <int N>
constexpr int kMinBlocks = min_blocks(N * N * kSlices<N>, 78);
// K8 holds two operator outputs a thread (2n values: its two chains):
// about 256 threads a block, and two blocks an SM at up to 128 registers
// (at K11's shape the outputs spill, and it is slower;
// scripts/k8_k6_compare.py --ablation).
template <int N>
constexpr int kWideSlices = 256 / (N * N) > 1 ? 256 / (N * N) : 1;
template <int N>
constexpr int kWideMinBlocks = min_blocks(N * N * kWideSlices<N>, 128);

// The thread's column of a field kept in shared memory, layer k at k N^2:
// the operator's input without the N registers a copy would hold.  The
// column holds V values (K8's bf16 builds: storage) and reads as T.
template <int N, typename T, typename V = T>
struct SharedColumn {
  const V* p;
  __device__ __forceinline__ T operator[](int k) const {
    return convert<T>(p[k * N * N]);
  }
};

// The occupancy of a cooperative kernel fn of `threads` threads a block
// (`slices` elements side by side): out = {blocks per SM at dyn bytes of
// dynamic shared memory (0 if a block may not take that much), static
// shared bytes, registers per thread, the most dynamic shared bytes a block
// may take, SM count, cooperative launch supported (0/1), slices}.
inline cudaError_t coop_query(const void* fn, int threads, int slices,
                              int dyn, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  int optin = 0, sms = 0, coop = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  const int max_dyn = optin - static_cast<int>(attr.sharedSizeBytes);
  int blocks = 0;
  if (dyn <= max_dyn) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, max_dyn);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                          threads, dyn);
    if (err != cudaSuccess) return err;
  }
  out[0] = blocks;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = attr.numRegs;
  out[3] = max_dyn;
  out[4] = sms;
  out[5] = coop;
  out[6] = slices;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// Direct-stiffness sum of an unassembled field, one node at a time.
//
// Thread (i, j) of element e, at layer k, reads the node's own copy and, on a
// face, edge or corner, the coincident copies in the neighbouring elements,
// straight from device memory.  The sums follow core/gs.ds_sum_local's tree
// exactly: pairs across x first, then pairs of x-sums across y, then pairs
// of xy-sums across z, each pair as (lower element) + (upper element).  IEEE
// addition is commutative but not associative, so fixing the tree makes the
// assembled value bitwise the plain version's in fp64 and fp32.  Elements
// are z-major over (ex, ey, ez).
// ---------------------------------------------------------------------------

template <int N, typename T>
__device__ __forceinline__ accum_t<T> node(const T* __restrict__ w, size_t e,
                                           int k, int j, int i) {
  return convert<accum_t<T>>(w[e * (N * N * N) + (k * N + j) * N + i]);
}

// x pairs: face i = n-1 of element ex meets i = 0 of element ex + 1.
template <int N, typename T>
__device__ __forceinline__ accum_t<T> sum_x(const T* __restrict__ w,
                                            size_t e, int k, int j, int i,
                                            int ix, int ex) {
  if (i == N - 1 && ix < ex - 1)
    return add_rn(node<N>(w, e, k, j, N - 1), node<N>(w, e + 1, k, j, 0));
  if (i == 0 && ix > 0)
    return add_rn(node<N>(w, e - 1, k, j, N - 1), node<N>(w, e, k, j, 0));
  return node<N>(w, e, k, j, i);
}

// y pairs of x-sums.
template <int N, typename T>
__device__ __forceinline__ accum_t<T> sum_xy(const T* __restrict__ w,
                                             size_t e, int k, int j, int i,
                                             int ix, int iy, int ex, int ey) {
  const size_t sy = static_cast<size_t>(ex);
  if (j == N - 1 && iy < ey - 1)
    return add_rn(sum_x<N>(w, e, k, N - 1, i, ix, ex),
                  sum_x<N>(w, e + sy, k, 0, i, ix, ex));
  if (j == 0 && iy > 0)
    return add_rn(sum_x<N>(w, e - sy, k, N - 1, i, ix, ex),
                  sum_x<N>(w, e, k, 0, i, ix, ex));
  return sum_x<N>(w, e, k, j, i, ix, ex);
}

// z pairs of xy-sums: the assembled value of node (k, j, i) of element e,
// in the accumulation type (an unassembled bf16 field sums in f32).
template <int N, typename T>
__device__ __forceinline__ accum_t<T> sum_xyz(const T* __restrict__ w,
                                              size_t e, int k, int j, int i,
                                              int ix, int iy, int iz, int ex,
                                              int ey, int ez) {
  const size_t sz = static_cast<size_t>(ex) * ey;
  if (k == N - 1 && iz < ez - 1)
    return add_rn(sum_xy<N>(w, e, N - 1, j, i, ix, iy, ex, ey),
                  sum_xy<N>(w, e + sz, 0, j, i, ix, iy, ex, ey));
  if (k == 0 && iz > 0)
    return add_rn(sum_xy<N>(w, e - sz, N - 1, j, i, ix, iy, ex, ey),
                  sum_xy<N>(w, e, 0, j, i, ix, iy, ex, ey));
  return sum_xy<N>(w, e, k, j, i, ix, iy, ex, ey);
}

// The same sum over a field that other blocks of the running launch wrote
// before a grid-wide barrier (K11's exchanged A d), without branches.
// Every load goes through L2 (ld.global.cg): neither L1 nor the
// non-coherent read-only path, which a const __restrict__ pointer lets nvcc
// pick, is coherent with those writes.  The loads are volatile asm, so that
// nvcc keeps them after the barrier.  Kept apart from the helpers above so
// that K4, K5, K8 and K10 compile as before.
//
// sum_xyz's branches diverge inside a warp (face, edge and corner nodes
// take other paths), and each path then waits for its own loads.  Here
// every node issues the same eight loads, the copies it does not have
// predicated off, and selects: the own copy and, along each axis with a
// neighbour, the neighbour's, paired x first, then y, then z, as sum_xyz
// pairs them.  IEEE addition is commutative, so (own + neighbour) is
// bitwise sum_xyz's (lower + upper) for either side.
__device__ __forceinline__ double ld_cg(bool p, const double* a) {
  double v;
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n mov.b64 %0, 0;\n"
      " @p ld.global.cg.f64 %0, [%1];\n}"
      : "=d"(v)
      : "l"(a), "r"(static_cast<int>(p)));
  return v;
}
__device__ __forceinline__ float ld_cg(bool p, const float* a) {
  float v;
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n mov.b32 %0, 0;\n"
      " @p ld.global.cg.f32 %0, [%1];\n}"
      : "=f"(v)
      : "l"(a), "r"(static_cast<int>(p)));
  return v;
}

template <int N, typename T>
__device__ __forceinline__ T sum_xyz_cg(const T* w, size_t e, int k, int j,
                                        int i, int ix, int iy, int iz, int ex,
                                        int ey, int ez) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  // along each axis: is there a neighbour's copy, and where is it (element
  // offset, and the node index on its side: N - 1 - own)
  const bool hx = (i == N - 1 && ix < ex - 1) || (i == 0 && ix > 0);
  const bool hy = (j == N - 1 && iy < ey - 1) || (j == 0 && iy > 0);
  const bool hz = (k == N - 1 && iz < ez - 1) || (k == 0 && iz > 0);
  const ptrdiff_t sx = i == N - 1 ? 1 : -1;
  const ptrdiff_t sy = (j == N - 1 ? 1 : -1) * static_cast<ptrdiff_t>(ex);
  const ptrdiff_t sz =
      (k == N - 1 ? 1 : -1) * static_cast<ptrdiff_t>(ex) * ey;
  const T* own = w + e * N3 + (k * N + j) * N + i;
  // the copy of the node in the element offset along the axes flagged
  auto at = [&](bool dx, bool dy, bool dz) {
    return own + ((dx ? sx : 0) + (dy ? sy : 0) + (dz ? sz : 0)) * N3 +
           (dx ? (N - 1 - 2 * i) : 0) + (dy ? (N - 1 - 2 * j) * N : 0) +
           (dz ? (N - 1 - 2 * k) * N2 : 0);
  };
  auto xsum = [&](bool p, bool dy, bool dz) {
    const T a = ld_cg(p, at(false, dy, dz));
    const T b = ld_cg(p && hx, at(true, dy, dz));
    return hx ? add_rn(a, b) : a;
  };
  auto xysum = [&](bool p, bool dz) {
    const T a = xsum(p, false, dz);
    const T b = xsum(p && hy, true, dz);
    return hy ? add_rn(a, b) : a;
  };
  const T a = xysum(true, false);
  const T b = xysum(hz, true);
  return hz ? add_rn(a, b) : a;
}

}  // namespace nekbone

// Expands CASE(N) for every supported n; used inside a switch on n.
#define NEKBONE_FOR_EACH_N(CASE) \
  CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) \
  CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)

namespace nekbone {

// kSlices of the run-time n (1 outside 2..16).
inline int slices_of(int n) {
  switch (n) {
#define NEKBONE_CASE(N) \
  case N:               \
    return kSlices<N>;
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return 1;
  }
}

}  // namespace nekbone

namespace nekbone {

// ---------------------------------------------------------------------------
// Persistent element walkers (K4, K3, K2; K5 and K7 below).  A block of
// n x n threads owns a contiguous, z-major range of elements
// (kernels/nekbone_ax.k4_plan, k3_plan) and walks it one element at a
// time.  A ring of stages in dynamic shared memory holds the operands of
// the elements after the current one:
// each stage is filled by TMA bulk copies issued by one thread (the bulk
// path: every operand's size and address a multiple of 16 bytes, n even) or
// by per-thread cp.async (n odd), and completes on its own mbarrier.  The
// operator sweeps the current element meanwhile, with the rows and columns
// of D that thread (i, j) contracts with held in registers.  Operands the
// plan does not stage are read from device memory, prefetched to L2 one
// element ahead.  Kept apart from the helpers above, so that the other
// kernels compile as before.
// ---------------------------------------------------------------------------

// The most stages a ring may have.
constexpr int kMaxStages = 4;
// The walkers' register cap: as many blocks an SM as 256 threads (8-byte
// accumulation) or 512 (4-byte) fill, at least one.  At n = 10 (128-thread
// blocks): fp64 two blocks an SM at up to 255 registers a thread (its 4n
// values of D take 80), f32 and the bf16 builds four at up to 128
// (scripts/k4_k3_compare.py --ablation: fp64 spills below 168, and three
// blocks measured slower; the 4-byte builds ran fastest at four).
template <int N, typename A>
constexpr int kWalkMinBlocks =
    (sizeof(A) == 8 ? 256 : 512) / ((N * N + 31) / 32 * 32) > 1
        ? (sizeof(A) == 8 ? 256 : 512) / ((N * N + 31) / 32 * 32)
        : 1;

// a * b + c rounded once (the contraction nvcc may or may not make of
// `c += a * b`, made explicit where the kernels it replaced made it).
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// The launch plan of a walker, as the planner made it.
struct WalkPlan {
  int per_block;  // elements a block owns
  int stages;     // depth of the ring (1..kMaxStages)
  int staged;     // bit q: operand q is staged
  int bulk;       // 1: TMA bulk copies; 0: per-thread cp.async
};

// A slot's bytes in a stage: the operand's bytes per element on the bulk
// path; on the cp.async path its 16-byte rounding and a 16-byte margin for
// the copy window (an element that starts inside a copy unit).
__host__ __device__ constexpr int walk_slot_bytes(int bytes, int bulk) {
  return bulk ? bytes : (bytes + 15) / 16 * 16 + 16;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Thread 0 arms the barrier for `bytes` of bulk copies (its one arrival).
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the barrier's phase of this parity has completed.  A copy
// that never lands traps (a launch error) after 2^28 tries, seconds, rather
// than hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  for (unsigned tries = 0;; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 28)) __trap();
  }
}

// One TMA 1-D bulk copy of `bytes` (a multiple of 16; both addresses
// 16-byte aligned) into shared memory, completed on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One cp.async of a U-byte unit of which the first `src_bytes` are read
// (the rest zero-filled).
template <int U>
__device__ __forceinline__ void cp_async_unit(void* dst, const void* src,
                                              int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(U), "r"(src_bytes)
               : "memory");
}

// The barrier's phase counts this thread's arrival once its earlier
// cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// `bytes` from src, which starts anywhere inside a U-byte unit, copied by
// the n threads in U-byte units from the unit that holds its first byte:
// the copy lands (src % U) bytes into dst.  The first unit may read the
// bytes before src (of the same allocation, whose base is U-aligned); the
// last reads no byte past src + bytes.
template <int U>
__device__ __forceinline__ void copy_window(unsigned char* dst,
                                            const unsigned char* src,
                                            int bytes, int tid, int threads) {
  const int head = static_cast<int>(reinterpret_cast<size_t>(src) % U);
  const unsigned char* from = src - head;
  const int span = head + bytes;
  for (int c = tid; c * U < span; c += threads) {
    const int left = span - c * U;
    cp_async_unit<U>(dst + c * U, from + c * U, left < U ? left : U);
  }
}

// The ring of a walker over K operands.  Operand q lies in device memory
// at src[q] + e * bytes[q] for element e; where the plan stages it, the
// t-th element of the block finds it in stage t % stages at offset off[q]
// (plus the copy window's head on the cp.async path).
template <int K>
struct WalkRing {
  unsigned long long* full;     // one barrier per stage
  unsigned char* base;          // the stages, in dynamic shared memory
  const unsigned char* src[K];  // each operand in device memory
  int bytes[K];                 // its bytes per element
  int unit[K];                  // cp.async path: its copy unit (4 or 8)
  int off[K];                   // its slot in a stage
  int stage_bytes;
  WalkPlan plan;

  __device__ __forceinline__ WalkRing(unsigned long long* full_,
                                      unsigned char* base_,
                                      const WalkPlan& plan_,
                                      const void* const (&src_)[K],
                                      const int (&bytes_)[K],
                                      const int (&size_)[K])
      : full(full_), base(base_), plan(plan_) {
    stage_bytes = 0;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      src[q] = static_cast<const unsigned char*>(src_[q]);
      bytes[q] = bytes_[q];
      unit[q] = size_[q] < 4 ? 4 : size_[q];
      off[q] = stage_bytes;
      if (has(q)) stage_bytes += walk_slot_bytes(bytes[q], plan.bulk);
    }
  }

  __device__ __forceinline__ bool has(int q) const {
    return (plan.staged >> q) & 1;
  }

  // Thread 0 makes the barriers; a __syncthreads() must follow before any
  // thread fills or waits.
  __device__ __forceinline__ void init(int tid, int threads) {
    if (tid == 0 && plan.staged) {
      for (int s = 0; s < plan.stages; ++s)
        mbar_init(&full[s], plan.bulk ? 1u : static_cast<unsigned>(threads));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }

  // Element e, the t-th of the block, into stage t % stages; called by
  // every thread once no thread reads that stage any more.
  __device__ __forceinline__ void fill(int t, size_t e, int tid,
                                       int threads) {
    if (!plan.staged) return;
    const int s = t % plan.stages;
    unsigned char* stage = base + s * stage_bytes;
    if (plan.bulk) {
      if (tid != 0) return;
      // the stage's last reads were generic; its next writes are TMA's
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      unsigned total = 0;
#pragma unroll
      for (int q = 0; q < K; ++q)
        if (has(q)) total += static_cast<unsigned>(bytes[q]);
      mbar_expect_tx(&full[s], total);
#pragma unroll
      for (int q = 0; q < K; ++q)
        if (has(q))
          bulk_copy(stage + off[q], src[q] + e * bytes[q],
                    static_cast<unsigned>(bytes[q]), &full[s]);
    } else {
#pragma unroll
      for (int q = 0; q < K; ++q) {
        if (!has(q)) continue;
        if (unit[q] == 8)
          copy_window<8>(stage + off[q], src[q] + e * bytes[q], bytes[q],
                         tid, threads);
        else
          copy_window<4>(stage + off[q], src[q] + e * bytes[q], bytes[q],
                         tid, threads);
      }
      cp_async_arrive(&full[s]);
    }
  }

  // Until the t-th element's stage has landed.
  __device__ __forceinline__ void wait(int t) const {
    if (plan.staged)
      mbar_wait(&full[t % plan.stages],
                static_cast<unsigned>((t / plan.stages) & 1));
  }

  // Operand q of element e, the t-th: in its stage where staged, else in
  // device memory.
  template <typename T>
  __device__ __forceinline__ const T* at(int q, int t, size_t e) const {
    const unsigned char* g = src[q] + e * bytes[q];
    if (!has(q)) return reinterpret_cast<const T*>(g);
    const int head =
        plan.bulk ? 0 : static_cast<int>(reinterpret_cast<size_t>(g) % unit[q]);
    return reinterpret_cast<const T*>(base + (t % plan.stages) * stage_bytes +
                                      off[q] + head);
  }

  // The operands element e will read from device memory, prefetched to L2.
  __device__ __forceinline__ void prefetch(size_t e, int tid,
                                           int threads) const {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      if (has(q)) continue;
      const unsigned char* g = src[q] + e * bytes[q];
      if (plan.bulk) {
        if (tid == 0)
          asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(g),
                       "r"(static_cast<unsigned>(bytes[q]))
                       : "memory");
      } else {
        for (int c = tid; c * 128 < bytes[q]; c += threads)
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(g + c * 128));
      }
    }
  }
};

// D's rows i and j and columns i and j, the values thread (i, j) contracts
// with (ax_columns reads them from shared memory as Dt[l][i], D[j][l],
// D[l][i] and D[l][j]), in registers in the accumulation type T.
template <int N, typename T>
struct DRegs {
  T row_i[N], row_j[N], col_i[N], col_j[N];

  template <typename O>
  __device__ __forceinline__ void load(const O* __restrict__ D, int i,
                                       int j) {
#pragma unroll
    for (int l = 0; l < N; ++l) {
      row_i[l] = convert<T>(D[i * N + l]);
      row_j[l] = convert<T>(D[j * N + l]);
      col_i[l] = convert<T>(D[l * N + i]);
      col_j[l] = convert<T>(D[l * N + j]);
    }
  }
  __device__ __forceinline__ T ri(int l) const { return row_i[l]; }
  __device__ __forceinline__ T rj(int l) const { return row_j[l]; }
  __device__ __forceinline__ T ci(int l) const { return col_i[l]; }
  __device__ __forceinline__ T cj(int l) const { return col_j[l]; }
};

// ax_columns with the thread's rows and columns of D from `dr` (DRegs):
// the same products, contracted and summed in the same order, so wc is
// bitwise ax_columns'.  The broadcast row D[k][.] and the layers stay in
// shared memory (sh.D, published by the first barrier; sh.Dt is not read).
template <int N, typename T, typename DR, typename Metric, typename U>
__device__ __forceinline__ void ax_columns_dregs(AxShared<N, T>& sh,
                                                 const DR& dr, Metric metric,
                                                 const U& uc, T (&wc)[N],
                                                 int i, int j) {
#pragma unroll
  for (int k = 0; k < N; ++k) wc[k] = T(0);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    sh.u[j][i] = uc[k];
    __syncthreads();
    T wr = T(0), ws = T(0), wt = T(0);
#pragma unroll
    for (int l = 0; l < N; ++l) {
      wr += dr.ri(l) * sh.u[j][l];
      ws += dr.rj(l) * sh.u[l][i];
      wt += sh.D[k][l] * uc[l];
    }
    T ur, us, ut;
    metric(k, wr, ws, wt, ur, us, ut);
    sh.r[j][i] = ur;
    sh.s[j][i] = us;
    __syncthreads();
    T acc = T(0);
#pragma unroll
    for (int l = 0; l < N; ++l) {
      acc += dr.ci(l) * sh.r[j][l];
      acc += dr.cj(l) * sh.s[l][i];
    }
    wc[k] += acc;
#pragma unroll
    for (int m = 0; m < N; ++m) wc[m] += sh.D[k][m] * ut;
  }
}

// The first and one-past-last element of this block's range.
__device__ __forceinline__ void walk_range(size_t E, int per_block,
                                           size_t& first, size_t& last) {
  first = static_cast<size_t>(blockIdx.x) * per_block;
  last = first + per_block < E ? first + per_block : E;
  if (first > E) first = E;
}

// The dynamic shared bytes of a ring over K operands (the planner's
// smem_bytes).
template <int K>
inline int walk_ring_bytes(const WalkPlan& p, const int (&bytes)[K]) {
  int stage = 0;
  for (int q = 0; q < K; ++q)
    if ((p.staged >> q) & 1) stage += walk_slot_bytes(bytes[q], p.bulk);
  return p.stages * stage;
}

// A plan the kernel can run on these pointers (bulk: every operand
// 16-byte aligned with sizes a multiple of 16; cp.async: aligned to its
// copy unit, or with `any_head` to its values alone).
template <int K>
inline bool walk_plan_ok(const WalkPlan& p, long long E, int grid,
                         const void* const (&src)[K], const int (&bytes)[K],
                         const int (&size)[K], bool any_head = false) {
  if (p.per_block < 1 || grid < 1 ||
      static_cast<long long>(grid) * p.per_block < E || p.stages < 1 ||
      p.stages > kMaxStages || p.staged < 0 || p.staged >= (1 << K) ||
      (p.bulk != 0 && p.bulk != 1))
    return false;
  for (int q = 0; q < K; ++q) {
    const size_t a = reinterpret_cast<size_t>(src[q]);
    const int unit = any_head ? size[q] : size[q] < 4 ? 4 : size[q];
    if (p.bulk ? (a % 16 != 0 || bytes[q] % 16 != 0) : a % unit != 0)
      return false;
  }
  return true;
}

}  // namespace nekbone

namespace nekbone {

// ---------------------------------------------------------------------------
// The CG update walkers (K5, K7).  A work item is one element of one lane:
// item q = l * E + e (lane-major, so K5 is K7 with one lane), its fields at
// q * n^3 of each (lanes, E, n^3) operand.  A block of n x n threads walks
// its contiguous range of items on the walkers' ring (WalkRing above): the
// next item's x, p, r and its own copy of the unassembled w land in a stage
// while the current item is updated.  The copies of w in the neighbouring
// elements are not staged: every thread issues the same seven predicated
// loads a node, through the read-only path, switched off along an axis
// without a neighbour (sum_xyz_nc).  Kept apart from the helpers above, so
// that the other kernels compile as before.
// ---------------------------------------------------------------------------

// The value at a where p, else 0, through the non-coherent read-only path:
// the field was written before the launch and no block writes it.  Not
// volatile, so that nvcc may issue a layer's loads early.
__device__ __forceinline__ double ld_nc(bool p, const double* a) {
  double v;
  asm("{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n mov.b64 %0, 0;\n"
      " @p ld.global.nc.f64 %0, [%1];\n}"
      : "=d"(v)
      : "l"(a), "r"(static_cast<int>(p)));
  return v;
}
__device__ __forceinline__ float ld_nc(bool p, const float* a) {
  float v;
  asm("{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n mov.b32 %0, 0;\n"
      " @p ld.global.nc.f32 %0, [%1];\n}"
      : "=f"(v)
      : "l"(a), "r"(static_cast<int>(p)));
  return v;
}
__device__ __forceinline__ __nv_bfloat16 ld_nc(bool p,
                                               const __nv_bfloat16* a) {
  unsigned short v;
  asm("{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n mov.b16 %0, 0;\n"
      " @p ld.global.nc.b16 %0, [%1];\n}"
      : "=h"(v)
      : "l"(a), "r"(static_cast<int>(p)));
  return __ushort_as_bfloat16(v);
}

// sum_xyz's value of node (k, j, i) of element e, in the accumulation type,
// from the node's own copy `own` (read by the caller) and the neighbours'
// copies in w, without branches: every node issues the same seven loads,
// those of copies it does not have predicated off, and selects.  The pairs
// are sum_xyz's, x first, then y, then z, each as (own side + neighbour's
// side); IEEE addition is commutative, so that is bitwise sum_xyz's (lower
// + upper) for either side.
template <int N, typename T>
__device__ __forceinline__ accum_t<T> sum_xyz_nc(const T* __restrict__ w,
                                                 accum_t<T> own, size_t e,
                                                 int k, int j, int i, int ix,
                                                 int iy, int iz, int ex,
                                                 int ey, int ez) {
  using A = accum_t<T>;
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  // along each axis: is there a neighbour's copy, and where is it (element
  // offset, and the node index on its side: N - 1 - own)
  const bool hx = (i == N - 1 && ix < ex - 1) || (i == 0 && ix > 0);
  const bool hy = (j == N - 1 && iy < ey - 1) || (j == 0 && iy > 0);
  const bool hz = (k == N - 1 && iz < ez - 1) || (k == 0 && iz > 0);
  const ptrdiff_t sx = i == N - 1 ? 1 : -1;
  const ptrdiff_t sy = (j == N - 1 ? 1 : -1) * static_cast<ptrdiff_t>(ex);
  const ptrdiff_t sz =
      (k == N - 1 ? 1 : -1) * static_cast<ptrdiff_t>(ex) * ey;
  const T* at0 = w + e * N3 + (k * N + j) * N + i;
  // the copy of the node in the element offset along the axes flagged
  auto at = [&](bool dx, bool dy, bool dz) {
    return at0 + ((dx ? sx : 0) + (dy ? sy : 0) + (dz ? sz : 0)) * N3 +
           (dx ? (N - 1 - 2 * i) : 0) + (dy ? (N - 1 - 2 * j) * N : 0) +
           (dz ? (N - 1 - 2 * k) * N2 : 0);
  };
  auto ld = [&](bool p, bool dx, bool dy, bool dz) {
    return convert<A>(ld_nc(p, at(dx, dy, dz)));
  };
  // a (the copy on the own side along x) paired with its x neighbour
  auto xsum = [&](A a, bool p, bool dy, bool dz) {
    const A b = ld(p && hx, true, dy, dz);
    return hx ? add_rn(a, b) : a;
  };
  // the x-sum of a paired with the x-sum on the y neighbour's side
  auto xysum = [&](A a, bool p, bool dz) {
    const A lo = xsum(a, p, false, dz);
    const A hi = xsum(ld(p && hy, false, true, dz), p && hy, true, dz);
    return hy ? add_rn(lo, hi) : lo;
  };
  const A lo = xysum(own, true, false);
  const A hi = xysum(ld(hz, false, false, true), hz, true);
  return hz ? add_rn(lo, hi) : lo;
}

// The edge planes of a sharded solve (core/gs.edge_planes): a neighbour
// shard's x,y-assembled face, (EY*EX, n, n) values in the accumulation type
// A, that the z step adds to the k = 0 face of the bottom element layer
// (below) or to the k = n-1 face of the top one (above); null where the
// shard holds the global end.  NoPlanes is the single-shard walk's: its
// code is the walk without this operand.
template <typename A>
struct EdgePlanes {
  static constexpr bool kOn = true;
  const A* below;
  const A* above;
};
struct NoPlanes {
  static constexpr bool kOn = false;
};

// sum_xyz_nc with the edge planes: along z, a node on the bottom layer's k
// = 0 face (or the top layer's k = n-1 face) whose shard is not at that
// global end takes the plane's value where sum_xyz_nc takes the z
// neighbour's x,y sum.  Both are that neighbour copy's (x then y) sum, so
// the pair (own side + neighbour's side) is bitwise the single-shard one.
template <int N, typename T>
__device__ __forceinline__ accum_t<T> sum_xyz_nc_planes(
    const T* __restrict__ w, accum_t<T> own, size_t e, int k, int j, int i,
    int ix, int iy, int iz, int ex, int ey, int ez,
    const EdgePlanes<accum_t<T>>& pl) {
  using A = accum_t<T>;
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  const bool hx = (i == N - 1 && ix < ex - 1) || (i == 0 && ix > 0);
  const bool hy = (j == N - 1 && iy < ey - 1) || (j == 0 && iy > 0);
  const bool hz = (k == N - 1 && iz < ez - 1) || (k == 0 && iz > 0);
  const bool pz = (k == 0 && iz == 0 && pl.below != nullptr) ||
                  (k == N - 1 && iz == ez - 1 && pl.above != nullptr);
  const ptrdiff_t sx = i == N - 1 ? 1 : -1;
  const ptrdiff_t sy = (j == N - 1 ? 1 : -1) * static_cast<ptrdiff_t>(ex);
  const ptrdiff_t sz =
      (k == N - 1 ? 1 : -1) * static_cast<ptrdiff_t>(ex) * ey;
  const T* at0 = w + e * N3 + (k * N + j) * N + i;
  auto at = [&](bool dx, bool dy, bool dz) {
    return at0 + ((dx ? sx : 0) + (dy ? sy : 0) + (dz ? sz : 0)) * N3 +
           (dx ? (N - 1 - 2 * i) : 0) + (dy ? (N - 1 - 2 * j) * N : 0) +
           (dz ? (N - 1 - 2 * k) * N2 : 0);
  };
  auto ld = [&](bool p, bool dx, bool dy, bool dz) {
    return convert<A>(ld_nc(p, at(dx, dy, dz)));
  };
  auto xsum = [&](A a, bool p, bool dy, bool dz) {
    const A b = ld(p && hx, true, dy, dz);
    return hx ? add_rn(a, b) : a;
  };
  auto xysum = [&](A a, bool p, bool dz) {
    const A lo = xsum(a, p, false, dz);
    const A hi = xsum(ld(p && hy, false, true, dz), p && hy, true, dz);
    return hy ? add_rn(lo, hi) : lo;
  };
  // the plane's copy of the node: (EY*EX, N, N), element (iy, ix), (j, i)
  const A* plane =
      pz ? (k == 0 ? pl.below : pl.above) +
               (static_cast<size_t>(iy) * ex + ix) * N2 + j * N + i
         : pl.below;
  const A lo = xysum(own, true, false);
  const A hz_hi = xysum(ld(hz, false, false, true), hz, true);
  const A p_hi = ld_nc(pz, plane);
  const A hi = hz ? hz_hi : p_hi;
  return (hz || pz) ? add_rn(lo, hi) : lo;
}

// block_sum's tree over the NT values of the block's threads, with its
// pairs (tid, tid + s) in its order, so bitwise block_sum's: the steps of s
// >= 64 through shared memory, the rest in warp 0 (s = 32 from shared
// memory, then shuffles); two barriers at NT = 100 against block_sum's
// eight.  The result is valid in thread 0, and every thread has passed the
// last barrier after its value was in.  Warp 0 reads `sh` after that
// barrier, so consecutive calls alternate two buffers of NT values.
template <int NT, typename T>
__device__ __forceinline__ T block_sum_shfl(T v, T* sh, int tid) {
  constexpr int kHalf = pow2_ceil(NT) / 2;
  if constexpr (kHalf >= 32) {
    sh[tid] = v;
    __syncthreads();
#pragma unroll
    for (int s = kHalf; s >= 64; s >>= 1) {
      if (tid < s && tid + s < NT) sh[tid] += sh[tid + s];
      __syncthreads();
    }
    if (tid < 32) v = tid + 32 < NT ? sh[tid] + sh[tid + 32] : sh[tid];
  } else {
    __syncthreads();
  }
  if (tid < 32) {
    constexpr unsigned kLanes = NT >= 32 ? 0xffffffffu : (1u << NT) - 1u;
#pragma unroll
    for (int s = kHalf >= 32 ? 16 : kHalf; s > 0; s >>= 1) {
      const T o = __shfl_down_sync(kLanes, v, s);
      if (tid < s && tid + s < NT) v += o;
    }
  }
  return v;
}

// Two sums of block_sum_shfl's form under one set of barriers (K10's rtz
// and rcr): each value goes through block_sum_shfl's pairs in its order, so
// each result is bitwise block_sum's of its value.  `sh` holds 2 NT values
// (a's, then b's); consecutive calls alternate two such buffers.  The
// results are valid in thread 0.
template <int NT, typename T>
__device__ __forceinline__ void block_sum2_shfl(T& a, T& b, T* sh, int tid) {
  constexpr int kHalf = pow2_ceil(NT) / 2;
  T* sa = sh;
  T* sb = sh + NT;
  if constexpr (kHalf >= 32) {
    sa[tid] = a;
    sb[tid] = b;
    __syncthreads();
#pragma unroll
    for (int s = kHalf; s >= 64; s >>= 1) {
      if (tid < s && tid + s < NT) {
        sa[tid] += sa[tid + s];
        sb[tid] += sb[tid + s];
      }
      __syncthreads();
    }
    if (tid < 32) {
      a = tid + 32 < NT ? sa[tid] + sa[tid + 32] : sa[tid];
      b = tid + 32 < NT ? sb[tid] + sb[tid + 32] : sb[tid];
    }
  } else {
    __syncthreads();
  }
  if (tid < 32) {
    constexpr unsigned kLanes = NT >= 32 ? 0xffffffffu : (1u << NT) - 1u;
#pragma unroll
    for (int s = kHalf >= 32 ? 16 : kHalf; s > 0; s >>= 1) {
      const T oa = __shfl_down_sync(kLanes, a, s);
      const T ob = __shfl_down_sync(kLanes, b, s);
      if (tid < s && tid + s < NT) {
        a += oa;
        b += ob;
      }
    }
  }
}

// The operands of one launch of K5 or K7, passed by value.
template <typename S, typename X, typename A>
struct UpdateArgs {
  const X* x;
  const S* p;
  const S* r;
  const S* w;
  const A* alpha;  // one value a lane
  const S* cx;
  const S* cy;
  const S* cz;
  X* x_out;
  S* r_out;
  A* rcr;  // one value an item
  int ex, ey, ez;
  int lanes;
  WalkPlan plan;
};

// Operands 0..3 of the ring: x (n^3 values in X), p, r and w (n^3 in S) of
// one item; their bytes and value sizes.
template <int N, typename S, typename X>
__host__ __device__ __forceinline__ void update_operands(int (&bytes)[4],
                                                         int (&size)[4]) {
  constexpr int kS = static_cast<int>(sizeof(S));
  constexpr int kX = static_cast<int>(sizeof(X));
  bytes[0] = N * N * N * kX;
  bytes[1] = bytes[2] = bytes[3] = N * N * N * kS;
  size[0] = kX;
  size[1] = size[2] = size[3] = kS;
}

// Where item q lies: its lane and its element's grid coordinates.  The
// walk divides once, for its first item, and steps from there.
struct ItemPos {
  size_t lane;
  int ix, iy, iz;

  __device__ __forceinline__ ItemPos(size_t q, size_t E, int ex, int ey) {
    lane = q / E;
    const size_t e = q - lane * E;
    ix = static_cast<int>(e % ex);
    iy = static_cast<int>((e / ex) % ey);
    iz = static_cast<int>(e / (static_cast<size_t>(ex) * ey));
  }
  // to item q + 1 (z-major elements, then the next lane)
  __device__ __forceinline__ void next(int ex, int ey, int ez) {
    if (++ix < ex) return;
    ix = 0;
    if (++iy < ey) return;
    iy = 0;
    if (++iz < ez) return;
    iz = 0;
    ++lane;
  }
};

// WalkRing's fill and at with the stage s given: the update walk keeps its
// stage and phase as it goes, so that an item pays no division (t % stages
// in fill, wait and at, and a copy unit's modulo in at, are integer
// divisions by run-time values).  kBulkAll: the plan stages every operand
// by bulk copies (n even, as on the paper case), known at compile time, so
// that neither the other copy path nor device-memory operands cost
// instructions or registers there.  WalkRing's own are K4's, K3's and K2's
// and stay as they are.
template <bool kBulkAll, int K>
__device__ __forceinline__ void ring_fill_stage(const WalkRing<K>& ring,
                                                int s, size_t e, int tid,
                                                int threads) {
  if (!kBulkAll && !ring.plan.staged) return;
  unsigned char* stage = ring.base + s * ring.stage_bytes;
  if (kBulkAll || ring.plan.bulk) {
    if (tid != 0) return;
    // the stage's last reads were generic; its next writes are TMA's
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    unsigned total = 0;
#pragma unroll
    for (int q = 0; q < K; ++q)
      if (kBulkAll || ring.has(q))
        total += static_cast<unsigned>(ring.bytes[q]);
    mbar_expect_tx(&ring.full[s], total);
#pragma unroll
    for (int q = 0; q < K; ++q)
      if (kBulkAll || ring.has(q))
        bulk_copy(stage + ring.off[q], ring.src[q] + e * ring.bytes[q],
                  static_cast<unsigned>(ring.bytes[q]), &ring.full[s]);
  } else {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      if (!ring.has(q)) continue;
      if (ring.unit[q] == 8)
        copy_window<8>(stage + ring.off[q], ring.src[q] + e * ring.bytes[q],
                       ring.bytes[q], tid, threads);
      else
        copy_window<4>(stage + ring.off[q], ring.src[q] + e * ring.bytes[q],
                       ring.bytes[q], tid, threads);
    }
    cp_async_arrive(&ring.full[s]);
  }
}

// Operand q of element e, in `stage` (its stage's base) where staged, else
// in device memory; copy units are 4 or 8 bytes, so the head is a mask.
template <typename T, bool kBulkAll, int K>
__device__ __forceinline__ const T* ring_at_stage(const WalkRing<K>& ring,
                                                  const unsigned char* stage,
                                                  int q, size_t e) {
  if (kBulkAll) return reinterpret_cast<const T*>(stage + ring.off[q]);
  const unsigned char* g = ring.src[q] + e * ring.bytes[q];
  if (!ring.has(q)) return reinterpret_cast<const T*>(g);
  const int head = ring.plan.bulk ? 0
                                  : static_cast<int>(
                                        reinterpret_cast<size_t>(g) &
                                        static_cast<size_t>(ring.unit[q] - 1));
  return reinterpret_cast<const T*>(stage + ring.off[q] + head);
}

// One item, the t-th of the block, whose stage has landed: thread (i, j)
// assembles its column's n values of w first (every neighbour load of the
// item in flight at once, none behind a store), then marches its k layers
// (x += alpha p, r -= alpha w, its r.c.r partial in k order), and the
// block sums the partials in block_sum's tree (block_sum_shfl, `red` two
// buffers of n^2 values).  K5 and K7 run every item through this one
// function, so each K7 lane is bitwise K5 on that lane.
//
// P is NoPlanes, or EdgePlanes<A> for the planes instantiation of K5 (a
// sharded solve's shard, one lane).
template <int N, bool kBulkAll, typename S, typename X, typename A,
          typename P = NoPlanes>
__device__ __forceinline__ void cg_update_item(const UpdateArgs<S, X, A>& a,
                                               const WalkRing<4>& ring,
                                               const unsigned char* stage,
                                               size_t q, const ItemPos& pos,
                                               A* red, int i, int j,
                                               const P& pl = P{}) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  const int tid = j * N + i;
  const int ix = pos.ix, iy = pos.iy, iz = pos.iz;
  const A al = a.alpha[pos.lane];
  const X* xs = ring_at_stage<X, kBulkAll>(ring, stage, 0, q) + tid;
  const S* ps = ring_at_stage<S, kBulkAll>(ring, stage, 1, q) + tid;
  const S* rs = ring_at_stage<S, kBulkAll>(ring, stage, 2, q) + tid;
  const S* ws = ring_at_stage<S, kBulkAll>(ring, stage, 3, q) + tid;
  const size_t base = q * N3 + tid;
  const A cyx = convert<A>(a.cy[iy * N + j]) * convert<A>(a.cx[ix * N + i]);
  A wa[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if constexpr (P::kOn)
      wa[k] = sum_xyz_nc_planes<N>(a.w, convert<A>(ws[k * N2]), q, k, j, i,
                                   ix, iy, iz, a.ex, a.ey, a.ez, pl);
    else
      wa[k] = sum_xyz_nc<N>(a.w, convert<A>(ws[k * N2]), q, k, j, i, ix, iy,
                            iz, a.ex, a.ey, a.ez);
  }
  A part = A(0);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const size_t o = base + k * N2;
    a.x_out[o] = convert<X>(
        add_rn(convert<A>(xs[k * N2]), mul_rn(al, convert<A>(ps[k * N2]))));
    // the stored residual, and r.c.r over exactly it (the round trip
    // through S is the identity for f64 and f32)
    const S rn_s =
        convert<S>(sub_rn(convert<A>(rs[k * N2]), mul_rn(al, wa[k])));
    a.r_out[o] = rn_s;
    const A rn = convert<A>(rn_s);
    // c is (cz * cy) * cx; the factors are 0, 1/2 or 1, so the product is
    // exact in any order.
    const A c = convert<A>(a.cz[iz * N + k]) * cyx;
    part += (rn * c) * rn;
  }
  const A total = block_sum_shfl<N2>(part, red, tid);
  if (tid == 0) a.rcr[q] = total;
}

// The walk of a block over its items (lanes * E of them), kBulkAll as for
// ring_fill_stage, P as for cg_update_item.
template <int N, bool kBulkAll, typename S, typename X, typename A,
          typename P = NoPlanes>
__device__ __forceinline__ void cg_update_walk(const UpdateArgs<S, X, A>& a,
                                               unsigned long long* full,
                                               unsigned char* ring_bytes,
                                               A* red, const P& pl = P{}) {
  constexpr int N2 = N * N;
  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const int tid = j * N + i;
  const size_t E = static_cast<size_t>(a.ex) * a.ey * a.ez;
  size_t first, last;
  walk_range(E * a.lanes, a.plan.per_block, first, last);
  const int count = static_cast<int>(last - first);
  const void* const src[4] = {a.x, a.p, a.r, a.w};
  int bytes[4], size[4];
  update_operands<N, S, X>(bytes, size);
  WalkRing<4> ring(full, ring_bytes, a.plan, src, bytes, size);
  ring.init(tid, N2);
  __syncthreads();
  const int stages = a.plan.stages;
  for (int t = 0; t < stages && t < count; ++t)
    ring_fill_stage<kBulkAll>(ring, t, first + t, tid, N2);
  ItemPos pos(first, E, a.ex, a.ey);
  // the t-th item's stage s = t % stages, and its phase (t / stages) & 1
  int s = 0;
  unsigned phase = 0;
  for (int t = 0; t < count; ++t, pos.next(a.ex, a.ey, a.ez)) {
    const size_t q = first + t;
    if (!kBulkAll && t + 1 < count) ring.prefetch(q + 1, tid, N2);
    if (kBulkAll || a.plan.staged) mbar_wait(&full[s], phase);
    cg_update_item<N, kBulkAll>(a, ring, ring.base + s * ring.stage_bytes, q,
                                pos, red + (t & 1) * N2, i, j, pl);
    // block_sum_shfl's barrier: no thread reads this item's stage any more
    if (t + stages < count)
      ring_fill_stage<kBulkAll>(ring, s, q + stages, tid, N2);
    if (++s == stages) {
      s = 0;
      phase ^= 1u;
    }
  }
}

// A plan the update walkers can run on these operands, over `items` items.
// The cp.async path takes any operand aligned to its values: copy_window
// reads from the copy unit that holds an item's first byte, which lies in
// the operand's allocation (CUDA allocations are 256-byte aligned), so a
// bf16 view that starts 2 bytes past a 4-byte boundary (a lane of a (b, E,
// n^3) field at odd n) is read as it is.
template <int N, typename S, typename X, typename A>
inline bool update_plan_ok(const UpdateArgs<S, X, A>& a, long long items,
                           int grid, int& dyn) {
  const void* const src[4] = {a.x, a.p, a.r, a.w};
  int bytes[4], size[4];
  update_operands<N, S, X>(bytes, size);
  dyn = walk_ring_bytes(a.plan, bytes);
  return walk_plan_ok(a.plan, items, grid, src, bytes, size,
                      /*any_head=*/true);
}

}  // namespace nekbone

namespace nekbone {

// ---------------------------------------------------------------------------
// The layer sweep with vector reads of the layer (K1).  ax_columns reads
// each contraction's operands one value at a time from shared memory:
// u[j][l], u[l][i], D[k][l] (twice), r[j][l] and s[l][i], about 6n scalar
// loads a node and layer.  Here the contractions along a row of the layer
// read it in 16-byte vectors: u[j][.] and r[j][.], and the broadcast row
// D[k][.] once a layer for both of its uses; the strided u[l][i] and
// s[l][i] stay scalar loads, which a warp serves without bank conflicts
// (its threads read consecutive i of one row).  In fp64 that is 1.5n
// vector and 2n scalar loads a node and layer.  Transposed copies of the
// layers, which would turn the strided reads into vectors too, cost a
// store each and measured slower in every build (scripts/parent_compare.py
// times that form beside this one).  Kept apart from the helpers above, so
// that the other kernels compile as before.
// ---------------------------------------------------------------------------

// Values a row of AxVecShared holds: N values of T padded to an odd number
// of 16-byte units, so that every row starts on a 16-byte boundary (vector
// reads) and the rows that one quarter-warp's vector reads touch start in
// different groups of four banks.
template <int N, typename T>
constexpr int kVecPitch =
    (((N * static_cast<int>(sizeof(T)) + 15) / 16) | 1) * 16 /
    static_cast<int>(sizeof(T));

// Shared memory of ax_columns_vec: D's rows and the layers of u, r and s.
template <int N, typename T>
struct AxVecShared {
  static constexpr int kPitch = kVecPitch<N, T>;
  __align__(16) T D[N][kPitch];
  __align__(16) T u[N][kPitch];
  __align__(16) T r[N][kPitch];
  __align__(16) T s[N][kPitch];
};

// Thread (i, j) loads D[j][i], upcast to T; the first barrier of
// ax_columns_vec publishes it.
template <int N, typename T, typename O>
__device__ __forceinline__ void load_D(AxVecShared<N, T>& sh,
                                       const O* __restrict__ D, int i, int j) {
  sh.D[j][i] = convert<T>(D[j * N + i]);
}

// The N values of a row of AxVecShared (16-byte aligned, padded) by
// 16-byte loads: double2 for 8-byte T, float4 for 4-byte T.
template <int N, typename T>
__device__ __forceinline__ void ld_row(const T* row, T (&v)[N]) {
  static_assert(sizeof(T) == 8 || sizeof(T) == 4, "ld_row: f64 or f32");
  if constexpr (sizeof(T) == 8) {
#pragma unroll
    for (int c = 0; c < (N + 1) / 2; ++c) {
      const double2 q = reinterpret_cast<const double2*>(row)[c];
      v[2 * c] = q.x;
      if (2 * c + 1 < N) v[2 * c + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < (N + 3) / 4; ++c) {
      const float4 q = reinterpret_cast<const float4*>(row)[c];
      v[4 * c] = q.x;
      if (4 * c + 1 < N) v[4 * c + 1] = q.y;
      if (4 * c + 2 < N) v[4 * c + 2] = q.z;
      if (4 * c + 3 < N) v[4 * c + 3] = q.w;
    }
  }
}

// ax_columns_dregs with vector reads of the layer's rows: the same
// products, contracted and summed in the same order (wr, ws, wt and acc as
// chains over l, each on its own, wc[k] += acc before wc[k] += D[k][k] ut),
// so wc is bitwise ax_columns'.  The scatter of ut into wc[m], m != k, goes before
// the second barrier: each of those wc[m] takes one term a layer, so its
// order is kept.
template <int N, typename T, typename DR, typename Metric, typename U>
__device__ __forceinline__ void ax_columns_vec(AxVecShared<N, T>& sh,
                                               const DR& dr, Metric metric,
                                               const U& uc, T (&wc)[N], int i,
                                               int j) {
#pragma unroll
  for (int k = 0; k < N; ++k) wc[k] = T(0);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    sh.u[j][i] = uc[k];
    __syncthreads();
    // one row of values live at a time: the row u[j][.] is done with
    // before D[k][.] is read
    T wr = T(0), ws = T(0), wt = T(0);
    {
      T row[N];
      ld_row<N>(sh.u[j], row);
#pragma unroll
      for (int l = 0; l < N; ++l) wr += dr.ri(l) * row[l];
    }
#pragma unroll
    for (int l = 0; l < N; ++l) ws += dr.rj(l) * sh.u[l][i];
    T dk[N];
    ld_row<N>(sh.D[k], dk);
#pragma unroll
    for (int l = 0; l < N; ++l) wt += dk[l] * uc[l];
    T ur, us, ut;
    metric(k, wr, ws, wt, ur, us, ut);
    sh.r[j][i] = ur;
    sh.s[j][i] = us;
#pragma unroll
    for (int m = 0; m < N; ++m)
      if (m != k) wc[m] += dk[m] * ut;
    const T dkk = dk[k];
    __syncthreads();
    T row[N];
    ld_row<N>(sh.r[j], row);
    T acc = T(0);
#pragma unroll
    for (int l = 0; l < N; ++l) {
      acc += dr.ci(l) * row[l];
      acc += dr.cj(l) * sh.s[l][i];
    }
    wc[k] += acc;
    wc[k] += dkk * ut;
    // The next layer writes u before its first barrier and r and s only
    // after it; every read of this layer's u happened before the second
    // barrier above, and of r and s before any thread reaches the next
    // first barrier.
  }
}

}  // namespace nekbone
