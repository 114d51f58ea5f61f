// K8: the matrix-powers front half of one s-step CG cycle.
//
//     A' v  = (1/theta) * gs(mask * A_loc v)      (mask, assemble, scale)
//     V     = [p, A'p, .., A'^s p, r, A'r, .., A'^(s-1) r]
//     basis = V without p and r                   (E, 2s-1, n^3)
//     gram  = per element, G_ab = sum(V_a * c * V_b)   (E, 2s+1, 2s+1)
//
// Replaces the TPU kernel
// src/repro/kernels/nekbone_ax.py:nekbone_ax_powers_kernel (pallas_call at
// :1164).  The TPU kernel kept a block of z-slabs plus s ghost slabs on each
// side in VMEM (sstep_extend_field / sstep_extend_zfactor), so the 2s - 1
// chained assembled applications never left the chip; the windows exist
// because the TPU walks its grid in order.  On Hopper a block cannot see its
// neighbours' new vector without a grid-wide barrier, so the whole cycle is
// one persistent, cooperative launch (cudaLaunchCooperativeKernel), K11's
// design (nekbone_cheb_apply.cu): every block is resident at once and owns
// one contiguous, z-major range of elements for the whole call; a block is
// (n, n, P) threads, P elements side by side (kWideSlices, 2 at n = 10),
// each slice an n x n layer marching its element's layers, over as many
// rounds as the block owns elements / P; two blocks an SM at up to 128
// registers (common.cuh kWideMinBlocks: the two chains' operator outputs
// are 2n values a thread).
//
// * start:       the masked, unassembled A_loc p (and A_loc r when s >= 2);
// * step j=1..s: grid sync; assembles both chains' previous unassembled
//                outputs with common.cuh's sum_xyz_cg (core/gs.ds_sum_local's
//                pairing, branch-free, read through L2 since other blocks
//                wrote them), scales by 1/theta and stores A'^j p in the
//                basis (and A'^j r while j <= s - 1), a layer at a time;
//                then applies the operator to the new vectors unless their
//                chain ends here, both chains through one layer sweep
//                (common.cuh ax_diag_columns_lanes: D and the metric read
//                once for both);
// * gram:        right after the last step, with no further grid sync: each
//                slice stages only its own element's values, which its
//                threads stored themselves.
//
// s grid syncs per call.  The unassembled outputs ping-pong between two
// buffers per chain, since a step reads its neighbours' copies of the
// previous one while it writes the next.  The operator is common.cuh's
// ax_diag_columns (or its two-input form, each output bitwise the same)
// with its input columns read from the slice's shared scratch (K4's and
// K11's arithmetic, FMA contractions included), the
// assembly keeps ds_sum_local's pairing and the scale is mul_rn, so the
// basis is bitwise what the chain of s + 2 launches this kernel replaced
// computed (scripts/k8_k6_compare.py); every vector is rounded through
// storage before the next application and before the Gram reads it.
//
// Storage and accumulation (common.cuh), K4's roles: S the vectors (p, r,
// the basis, the operator's input columns) and the mask and c factors, O
// the operator's data (D, the metric), A inv_theta, the arithmetic, the
// unassembled operator outputs and the Gram partials.  Four builds: f64 and
// f32 (one type throughout); bf16 (S = O = bf16, A = f32) and bf16_ir
// (S = bf16, O = A = f32).  In the bf16 builds the unassembled outputs stay
// in A, so each element's contribution is summed before the one rounding
// of the assembled, scaled vector to S, as the reference does; the Gram
// stages its layers upcast to A by plain loads (cp.async copies 4 bytes or
// more) and sums them in the same order, a bf16 x bf16 product being exact
// in f32.
//
// Every application reads the metric diagonals through L2 (24.6 MB at
// E = 1024, beside the four A v buffers' 32.8 MB).  A copy of the owned
// elements' metric in shared memory (24 KB an element at fp64, n = 10)
// measured slower where it fit: 224.7 us against 162.0 at fp64 E = 512,
// s = 4, since it leaves room for one block an SM, not two (PERF.md).
// kernels/nekbone_ax.k8_plan sizes the grid.
//
// The Gram is spread over every thread of a slice: the (2s+1)^2 pairs form
// 3 x 3 tiles, thread (i, j) takes tile j (of a pass of n tiles) and row i
// of each layer, and keeps its tile's 9 sums in registers, so each staged
// value it reads serves 3 pairs; the layers of the element's vectors (and
// c) arrive by cp.async into a ring of shared buffers, the next ones in
// flight while one is summed.  The order of terms is fixed: per row the
// layers in order and each layer's nodes in order, then the n rows in
// order, every product and sum rounded on its own
// (kernels/ref.sstep_gram_emulated reproduces the partials bitwise).  The
// partials are summed over elements by torch.sum; only the (2s+1)^2 matrix
// goes to the host.
//
// Bound: bytes.  The book is p, r and the 3 metric diagonals in and the
// 2s - 1 basis vectors out: 12 fields at s=4, 98.3 MB at E=1024, n=10, fp64
// (29.3 us at the data sheet's 3.35 TB/s), plus the Gram partials.  The
// work is (2s - 1)(12n + 10) flops per node for the applications and 3 per
// pair and node for the Gram, 1.1 GF at s=4: below the bytes' time.  What
// the design moves (chip_smoke.py prints it): p and r; per step with an
// application the metric; per application its unassembled output; per
// stored vector its assembled input and its basis write; the Gram's vectors
// once.  On the card the operator's
// shared-memory reads take most of the time, as in K11
// (scripts/k8_k6_compare.py --ablation).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

namespace cg = cooperative_groups;

// The operands of one call, passed by value to the kernel.
template <typename S, typename O, typename A>
struct PowersArgs {
  const S* p;
  const S* r;
  const O* D;
  const O* g3;
  const S* mx;
  const S* my;
  const S* mz;
  const S* cx;
  const S* cy;
  const S* cz;
  const A* inv_theta;
  S* basis;
  A* gram;
  A* adp0;  // unassembled A_loc of the p chain, even steps
  A* adp1;  // odd steps
  A* adr0;  // the r chain
  A* adr1;
  int ex, ey, ez, s, per_block;
};

// The Gram's tiles: kGramTile x kGramTile pairs (a, b) a thread sums.
constexpr int kGramTile = 3;
// Layers of the Gram's staging ring: ring - 1 in flight while one is
// summed; 4 up to s = 4, 2 past it (so that the ring of 2s + 2 staged
// values a node still fits beside two blocks' other shared memory).
__host__ __device__ inline int gram_ring(int s) { return s <= 4 ? 4 : 2; }

// A values of one slice's shared scratch: the p and the r chain's operator
// input columns (n^3 S values each, rounded up to whole A values) during
// the steps; after them, the Gram's ring of staged layers of the 2s + 1
// vectors and c (gram_ring (2s + 2) n (n + 1): rows padded by one value, so
// that threads on different rows of a layer read different banks) and, in
// the same place, its sums (kGramTile^2 n^2).
// (kernels/nekbone_ax.k8_scratch_bytes is the same formula in bytes.)
template <typename S, typename A>
__host__ __device__ inline int scratch_values(int n, int s) {
  constexpr int sa = static_cast<int>(sizeof(A));
  const int column =
      (2 * n * n * n * static_cast<int>(sizeof(S)) + sa - 1) / sa;
  const int staged = gram_ring(s) * (2 * s + 2) * n * (n + 1);
  const int sums = kGramTile * kGramTile * n * n;
  const int most = column > staged ? column : staged;
  return most > sums ? most : sums;
}

// One value from device memory into shared memory, asynchronously.
template <typename T>
__device__ __forceinline__ void cp_async_value(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(static_cast<int>(sizeof(T))));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most `pending` of the thread's newest groups are in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

// The thread's element in one round of a block's owned range: slice p of
// round q works on element first + q P + p; a slice past the range (the
// last round of the last block) computes on the block's last element and
// stores nothing outside its own shared scratch, so that it still meets
// every barrier.  per_block is a multiple of P.
template <int N, typename S, typename O, typename A>
struct PowersNode {
  size_t e;       // the element the slice computes on
  bool active;    // e is its own
  int ix, iy, iz;
  size_t base;    // offset of the thread's layer-0 node
  A* scratch;     // the slice's shared scratch
  S* colp;        // the thread's columns in it (the p and the r chain's
  S* colr;        // operator inputs), layer 0
  const O* gm;    // the metric diagonals at the thread's node, layer 0

  __device__ __forceinline__ PowersNode(const PowersArgs<S, O, A>& a,
                                        A* smem, int slot, size_t first,
                                        size_t last, int q, int p, int tid) {
    constexpr int P = kWideSlices<N>;
    constexpr int N3 = N * N * N;
    const size_t local = static_cast<size_t>(q) * P + p;
    active = first + local < last;
    e = active ? first + local : last - 1;
    ix = static_cast<int>(e % a.ex);
    iy = static_cast<int>((e / a.ex) % a.ey);
    iz = static_cast<int>(e / (static_cast<size_t>(a.ex) * a.ey));
    base = e * N3 + tid;
    scratch = smem + static_cast<size_t>(p) * slot;
    colp = reinterpret_cast<S*>(scratch) + tid;
    colr = reinterpret_cast<S*>(scratch) + N3 + tid;
    gm = a.g3 + e * 3 * N3 + tid;
  }
};

// mask * wc, unassembled, into ad (active slices only): common.cuh
// masked_ax's product.
template <int N, typename S, typename O, typename A>
__device__ __forceinline__ void masked_store(
    const PowersArgs<S, O, A>& a, const PowersNode<N, S, O, A>& nd,
    const A (&wc)[N], A* ad, int i, int j) {
  constexpr int N2 = N * N;
  const A myx = convert<A>(a.my[nd.iy * N + j]) *
                convert<A>(a.mx[nd.ix * N + i]);
  if (nd.active) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      ad[nd.base + k * N2] = wc[k] * (convert<A>(a.mz[nd.iz * N + k]) * myx);
  }
}

// The masked, unassembled A_loc of the p chain's column into adp (and, when
// adr is not null, of the r chain's into adr through the same layer sweep):
// common.cuh masked_ax, operation for operation, with the columns read from
// shared memory; ax_diag_columns_lanes gives each output bitwise what
// ax_diag_columns gives it alone.
template <int N, typename S, typename O, typename A>
__device__ __forceinline__ void powers_ax(AxSharedL<N, A, 2>& sh,
                                          const PowersArgs<S, O, A>& a,
                                          const PowersNode<N, S, O, A>& nd,
                                          A* adp, A* adr, int i, int j) {
  if (adr != nullptr) {
    A w[2][N];
    const SharedColumn<N, A, S> cols[2] = {{nd.colp}, {nd.colr}};
    ax_diag_columns_lanes(sh, nd.gm, cols, w, i, j);
    masked_store(a, nd, w[0], adp, i, j);
    masked_store(a, nd, w[1], adr, i, j);
  } else {
    A wp[N];
    ax_diag_columns(sh.one, nd.gm, SharedColumn<N, A, S>{nd.colp}, wp, i,
                    j);
    masked_store(a, nd, wp, adp, i, j);
  }
}

// One chain's vector of a step: v = (1/theta) gs(ad_in), rounded to
// storage, into basis slot m and, when the chain goes on (keep), into the
// thread's column col.  A layer at a time: unrolled, the eight loads of
// every layer in flight at once spill registers (scripts/k8_k6_compare.py
// --ablation).
template <int N, typename S, typename O, typename A>
__device__ __forceinline__ void powers_assemble(
    const PowersArgs<S, O, A>& a, const PowersNode<N, S, O, A>& nd,
    const A* ad_in, S* col, bool keep, int m, A ith, int i, int j) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  S* vm = a.basis + (nd.e * (2 * a.s - 1) + m) * N3 + j * N + i;
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    const S v = convert<S>(mul_rn(sum_xyz_cg<N>(ad_in, nd.e, k, j, i, nd.ix,
                                                nd.iy, nd.iz, a.ex, a.ey,
                                                a.ez),
                                  ith));
    if (nd.active) vm[k * N2] = v;
    if (keep) col[k * N2] = v;
  }
}

// One value of a vector into the staging buffer, in A: asynchronously
// where S is A (cp.async), else upcast by a plain load (cp.async copies no
// unit below 4 bytes).
template <typename S, typename A>
__device__ __forceinline__ void gram_value(A* dst, const S* src) {
  if constexpr (sizeof(S) == sizeof(A))
    cp_async_value(dst, src);
  else
    *dst = convert<A>(*src);
}

// Layer k of the slice's element into the staging buffer buf ([2s + 2]
// [row][n + 1]): thread (i, j) copies its node of the 2s + 1 vectors, in
// V's order, and stores c there last.  The caller commits the group.
template <int N, typename S, typename O, typename A>
__device__ __forceinline__ void gram_stage(
    const PowersArgs<S, O, A>& a, const PowersNode<N, S, O, A>& nd, A* buf,
    int k, int i, int j) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  constexpr int NP = N * (N + 1);
  const int s = a.s;
  const int tid = j * N + i;
  const int at = j * (N + 1) + i;
  const S* bas = a.basis + nd.e * (2 * s - 1) * N3 + k * N2 + tid;
  // V's order: p, A'p..A'^s p, r, A'r..A'^(s-1) r
  gram_value(buf + at, a.p + nd.base + k * N2);
  for (int v = 1; v <= s; ++v)
    gram_value(buf + v * NP + at, bas + (v - 1) * N3);
  gram_value(buf + (s + 1) * NP + at, a.r + nd.base + k * N2);
  for (int v = s + 2; v <= 2 * s; ++v)
    gram_value(buf + v * NP + at, bas + (v - 2) * N3);
  // c = cz * (cy * cx); the factors are 0, 1/2 or 1, so any order is exact
  buf[(2 * s + 1) * NP + at] =
      convert<A>(a.cz[nd.iz * N + k]) *
      (convert<A>(a.cy[nd.iy * N + j]) * convert<A>(a.cx[nd.ix * N + i]));
}

// The Gram partials of the slice's element.  Its (2s+1)^2 pairs form
// kGramTile x kGramTile tiles (ta <= tb); thread t of the slice takes tile
// t / n and row t % n of each layer (passes of n tiles), and adds
// (V_a c) V_b of the row's nodes, layers in order and each layer's nodes in
// order, to a register per pair of its tile; the layers arrive by cp.async
// into a ring of gram_ring(s) buffers, the next ones in flight while one
// is summed.  Then the tile's first thread sums its n rows in
// order.  A diagonal tile's pairs a > b are computed and dropped; an index
// past 2s is clamped and dropped.
template <int N, typename S, typename O, typename A>
__device__ __forceinline__ void powers_gram(
    const PowersArgs<S, O, A>& a, const PowersNode<N, S, O, A>& nd, int i,
    int j) {
  constexpr int N2 = N * N;
  constexpr int NP = N * (N + 1);
  constexpr int G = kGramTile;
  const int R = gram_ring(a.s);
  const int tid = j * N + i;
  const int K = 2 * a.s + 1;
  const int nt = (K + G - 1) / G;
  const int ntiles = nt * (nt + 1) / 2;
  const int stride = (K + 1) * NP;  // one staged layer: V, then c
  A* red = nd.scratch;
  for (int t0 = 0; t0 < ntiles; t0 += N) {
    // this thread's tile (ta, tb), row-major over ta <= tb, and row
    int tile = t0 + tid / N;
    const int row = tid % N;
    const bool busy = tile < ntiles;
    int ta = 0;
    if (busy) {
      while (tile >= nt - ta) {
        tile -= nt - ta;
        ++ta;
      }
    }
    const int tb = ta + (busy ? tile : 0);
    int av[G], bv[G];
#pragma unroll
    for (int x = 0; x < G; ++x) {
      av[x] = min(G * ta + x, K - 1);
      bv[x] = min(G * tb + x, K - 1);
    }
    A acc[G][G];
#pragma unroll
    for (int x = 0; x < G; ++x)
#pragma unroll
      for (int y = 0; y < G; ++y) acc[x][y] = A(0);
    // one group per layer (empty past the last), so that layer k's group
    // is the k-th
    for (int k = 0; k < R - 1; ++k) {
      if (k < N) gram_stage(a, nd, nd.scratch + k * stride, k, i, j);
      cp_async_commit();
    }
#pragma unroll 1
    for (int k = 0; k < N; ++k) {
      // layer k is in, and every thread is done with layer k - 1's buffer,
      // where layer k + R - 1 goes
      if (R == 4)
        cp_async_wait<2>();
      else
        cp_async_wait<0>();
      __syncthreads();
      if (k + R - 1 < N)
        gram_stage(a, nd, nd.scratch + ((k + R - 1) % R) * stride,
                   k + R - 1, i, j);
      cp_async_commit();
      const A* buf = nd.scratch + (k % R) * stride + row * (N + 1);
      if (busy) {
#pragma unroll 2
        for (int x0 = 0; x0 < N; ++x0) {
          const A cn = buf[K * NP + x0];
          A wa[G], vb[G];
#pragma unroll
          for (int x = 0; x < G; ++x) {
            wa[x] = mul_rn(buf[av[x] * NP + x0], cn);
            vb[x] = buf[bv[x] * NP + x0];
          }
#pragma unroll
          for (int x = 0; x < G; ++x)
#pragma unroll
            for (int y = 0; y < G; ++y)
              acc[x][y] = add_rn(acc[x][y], mul_rn(wa[x], vb[y]));
        }
      }
    }
    // every thread is done with the staged layers: the sums take their place
    __syncthreads();
#pragma unroll
    for (int x = 0; x < G; ++x)
#pragma unroll
      for (int y = 0; y < G; ++y) red[(x * G + y) * N2 + tid] = acc[x][y];
    __syncthreads();
    if (busy && row == 0 && nd.active) {
      A* ge = a.gram + nd.e * K * K;
#pragma unroll
      for (int x = 0; x < G; ++x)
#pragma unroll
        for (int y = 0; y < G; ++y) {
          const int pa = G * ta + x;
          const int pb = G * tb + y;
          if (pa <= pb && pb < K) {
            A g = red[(x * G + y) * N2 + tid];
#pragma unroll
            for (int l = 1; l < N; ++l)
              g = add_rn(g, red[(x * G + y) * N2 + tid + l]);
            ge[pa * K + pb] = g;
            ge[pb * K + pa] = g;
          }
        }
    }
    // the sums' slots are staged into again by the next pass or round
    __syncthreads();
  }
}

// Block (N, N, P): slice p = threadIdx.z works on its own element of each
// round, with its own operator layers and scratch; the barriers inside the
// operator and the Gram are block-wide, so every slice runs every round.
template <int N, typename S, typename O, typename A>
__global__ void __launch_bounds__(N * N * kWideSlices<N>,
                                  kWideMinBlocks<N>)
nekbone_powers_kernel(const PowersArgs<S, O, A> a) {
  constexpr int N2 = N * N;
  constexpr int P = kWideSlices<N>;
  __shared__ AxSharedL<N, A, 2> sh_all[P];
  extern __shared__ __align__(16) unsigned char scratch_bytes[];
  A* smem = reinterpret_cast<A*>(scratch_bytes);

  cg::grid_group grid = cg::this_grid();
  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const int p = threadIdx.z;
  const int tid = j * N + i;
  AxSharedL<N, A, 2>& sh = sh_all[p];
  const int slot = scratch_values<S, A>(N, a.s);
  const size_t E = static_cast<size_t>(a.ex) * a.ey * a.ez;
  const size_t first = static_cast<size_t>(blockIdx.x) * a.per_block;
  const size_t last = first + a.per_block < E ? first + a.per_block : E;
  const int rounds = static_cast<int>((last - first + P - 1) / P);

  load_D(sh.one, a.D, i, j);
  const A ith = *a.inv_theta;

  // start: A_loc p into adp0 and, when the r chain has a step, A_loc r
  // into adr0 through the same layer sweep
  for (int q = 0; q < rounds; ++q) {
    const PowersNode<N, S, O, A> nd(a, smem, slot, first, last, q, p,
                                    tid);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      nd.colp[k * N2] = a.p[nd.base + k * N2];
      if (a.s >= 2) nd.colr[k * N2] = a.r[nd.base + k * N2];
    }
    powers_ax(sh, a, nd, a.adp0, a.s >= 2 ? a.adr0 : nullptr, i, j);
  }
  for (int step = 1; step <= a.s; ++step) {
    // every block's A_loc of the previous step is written
    grid.sync();
    const bool odd = step % 2;
    const A* inp = odd ? a.adp0 : a.adp1;
    A* outp = odd ? a.adp1 : a.adp0;
    const A* inr = odd ? a.adr0 : a.adr1;
    A* outr = odd ? a.adr1 : a.adr0;
    for (int q = 0; q < rounds; ++q) {
      const PowersNode<N, S, O, A> nd(a, smem, slot, first, last, q, p,
                                      tid);
      // chain c = 0 (p) stores A'^step p in slot step - 1 and goes on
      // while step < s; chain 1 (r) stores A'^step r in slot s + step - 1
      // while step <= s - 1, and goes on while step < s - 1
#pragma unroll 1
      for (int c = 0; c < (step <= a.s - 1 ? 2 : 1); ++c)
        powers_assemble(a, nd, c ? inr : inp, c ? nd.colr : nd.colp,
                        step < a.s - c, c ? a.s + step - 1 : step - 1, ith,
                        i, j);
      if (step < a.s)
        powers_ax(sh, a, nd, outp, step < a.s - 1 ? outr : nullptr, i, j);
    }
  }
  // the Gram of the owned elements: each slice stages its own element's
  // values, which its threads stored themselves; the barrier orders the
  // last operator's reads of the columns before the staging
  __syncthreads();
  for (int q = 0; q < rounds; ++q) {
    const PowersNode<N, S, O, A> nd(a, smem, slot, first, last, q, p,
                                    tid);
    powers_gram(a, nd, i, j);
  }
}

template <int N, typename S, typename A>
size_t dyn_bytes(int s) {
  return static_cast<size_t>(kWideSlices<N>) * scratch_values<S, A>(N, s) *
         sizeof(A);
}

// out: common.cuh coop_query's seven values for this instantiation.
template <int N, typename S, typename O, typename A>
cudaError_t query(int dyn, int* out) {
  return coop_query(
      reinterpret_cast<const void*>(&nekbone_powers_kernel<N, S, O, A>),
      N * N * kWideSlices<N>, kWideSlices<N>, dyn, out);
}

template <int N, typename S, typename O, typename A>
cudaError_t launch(const PowersArgs<S, O, A>& a, int grid,
                   cudaStream_t stream) {
  if (a.per_block % kWideSlices<N> != 0) return cudaErrorInvalidValue;
  const void* fn =
      reinterpret_cast<const void*>(&nekbone_powers_kernel<N, S, O, A>);
  const size_t dyn = dyn_bytes<N, S, A>(a.s);
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dyn));
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<PowersArgs<S, O, A>*>(&a)};
  return cudaLaunchCooperativeKernel(fn, dim3(grid),
                                     dim3(N, N, kWideSlices<N>), args, dyn,
                                     stream);
}

template <typename S, typename O, typename A>
int dispatch_query(int n, int dyn, int* out) {
  switch (n) {
#define NEKBONE_CASE(N) \
  case N:               \
    return static_cast<int>(query<N, S, O, A>(dyn, out));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename S, typename O, typename A>
int dispatch(const PowersArgs<S, O, A>& a, int n, int grid, void* stream) {
  const long long E = static_cast<long long>(a.ex) * a.ey * a.ez;
  if (a.ex <= 0 || a.ey <= 0 || a.ez <= 0 || a.s < 1 || a.s > kSstepMaxS ||
      a.per_block < 1 || grid < 1 ||
      static_cast<long long>(grid) * a.per_block < E ||
      static_cast<long long>(grid - 1) * a.per_block >= E)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N) \
  case N:               \
    return static_cast<int>(launch<N, S, O, A>(a, grid, st));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// p, r: (E, n^3), basis: (E, 2s-1, n^3), mx, cx: (EX, n), my, cy: (EY, n)
// and mz, cz: (EZ, n) in S; D: (n, n) and g3: (E, 3, n^3) in O; inv_theta:
// one value, gram: (E, 2s+1, 2s+1) and the scratch ad0p, ad1p, ad0r, ad1r:
// (E, n^3) in A.  Elements z-major over (EX, EY, EZ); 1 <= s <= 10; block
// b owns elements [b * per_block, (b + 1) * per_block), and every block
// owns one.  One cooperative launch of `grid` blocks; returns its error
// (cudaErrorCooperativeLaunchTooLarge when the grid cannot be resident at
// once), or 0.
//
// nekbone_ax_powers_query_<dtype>(n, resident, dyn, out): fills out[7] as
// common.cuh coop_query documents; returns a CUDA error, or 0.  K8 has one
// instantiation, so `resident` is ignored (it keeps the form of K11's
// query).
#define NEKBONE_POWERS_ENTRY(SUFFIX, S, O, A)                                 \
  extern "C" int nekbone_ax_powers_##SUFFIX(                                  \
      const S* p, const S* r, const O* D, const O* g3, const S* mx,           \
      const S* my, const S* mz, const S* cx, const S* cy, const S* cz,        \
      const A* inv_theta, S* basis, A* gram, A* ad0p, A* ad1p, A* ad0r,       \
      A* ad1r, int ex, int ey, int ez, int n, int s, int per_block,           \
      int grid, void* stream) {                                               \
    const nekbone::PowersArgs<S, O, A> a{                                     \
        p,     r,    D,    g3,   mx,   my,   mz, cx, cy, cz, inv_theta,       \
        basis, gram, ad0p, ad1p, ad0r, ad1r, ex, ey, ez, s,  per_block};      \
    return nekbone::dispatch<S, O, A>(a, n, grid, stream);                    \
  }                                                                           \
  extern "C" int nekbone_ax_powers_query_##SUFFIX(int n, int /*resident*/,   \
                                                  int dyn, int* out) {        \
    return nekbone::dispatch_query<S, O, A>(n, dyn, out);                     \
  }

#ifdef NEKBONE_REAL_F64
NEKBONE_POWERS_ENTRY(f64, double, double, double)
#endif
#ifdef NEKBONE_REAL_F32
NEKBONE_POWERS_ENTRY(f32, float, float, float)
#endif
#ifdef NEKBONE_REAL_BF16
NEKBONE_POWERS_ENTRY(bf16, __nv_bfloat16, __nv_bfloat16, float)
#endif
#ifdef NEKBONE_REAL_BF16_IR
NEKBONE_POWERS_ENTRY(bf16_ir, __nv_bfloat16, float, float)
#endif
