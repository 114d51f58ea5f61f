// K11: the Chebyshev preconditioner z = q_k(A) r and the partial r.c.z.
//
//     d = c00 * r;  z = d;  res = r
//     for i in 1..k:
//         res -= gs(mask * A_loc d)        (masked, then assembled)
//         d    = c_i0 * d + c_i1 * res
//         z   += d
//     rtz = sum(r * c * z)                 (per element, over the stored z)
//
// with coef = (c_i0, c_i1), the (k+1, 2) recurrence scalars of
// core/precond.cheb_scalars.
//
// Replaces the TPU kernel
// src/repro/kernels/nekbone_ax.py:nekbone_cheb_apply_kernel (pallas_call at
// :1563).  The TPU kernel kept a block of z-slabs plus k ghost slabs on each
// side in VMEM, so the k chained *assembled* operator applications never
// left the chip.  On Hopper a tile of elements with k ghost layers does not
// fit the 227 KB of shared memory a block may use, and a block cannot see
// its neighbours' new A d without a grid-wide barrier.  So the whole
// polynomial is one persistent, cooperative launch
// (cudaLaunchCooperativeKernel): every block is resident at once and owns
// one contiguous, z-major range of elements for all k steps.
//
// * start:      d = c00 * r; writes the masked, unassembled A_loc d;
// * step i < k: grid sync; assembles the previous A_loc d, applies the
//               recurrence and writes the masked, unassembled A_loc of the
//               new d;
// * step k:     grid sync; the same recurrence, then writes z and the
//               per-element rtz partial.
//
// k grid syncs per call.  Only the unassembled A d crosses blocks; it
// ping-pongs between two buffers, since a step reads its neighbours' copies
// of the previous one while it writes the next, and it is assembled by
// common.cuh's sum_xyz_cg: core/gs.ds_sum_local's pairing, bitwise, read
// through L2 (other blocks of this launch wrote it) and without branches
// (the branchy tree made each face, edge and corner path of a warp wait
// for its own loads).  A block is (n, n, P) threads: P elements side by
// side (4 at n = 10), each slice an n x n layer marching its element's k
// layers with common.cuh's operator (ax_diag_columns, K4's code, so A_loc
// is bitwise masked_ax's), over as many rounds as the block owns elements
// / P.  Thread (i, j) of a slice is the only one that touches column
// (i, j) of its elements' d, res and z, so that state needs no barrier.
// Where it is kept is a template parameter, chosen by
// kernels/nekbone_ax.k11_plan:
//
// * RESIDENT: d, res and z of the owned elements stay in the block's
//   dynamic shared memory from the start to the last step (24 KB per fp64
//   element at n = 10: four elements a block, two blocks an SM hold the
//   paper case's 1024), and only z goes to device memory, at the end;
// * otherwise, where the owned state does not fit (fp64, n = 10 past about
//   1,050 elements on 132 SMs), they live in device memory, read and
//   written by their owner alone, with a shared copy of the operator's
//   input column per slice.
//
// The operator reads its input column from shared memory (the state's d,
// or that copy) rather than from registers, and the block asks for two
// blocks an SM (__launch_bounds__): 72 registers at n = 10.  The grid is
// sized from cudaOccupancyMaxActiveBlocksPerMultiprocessor for the
// instantiation and its dynamic shared memory, times the SM count; a
// cooperative launch that does not fit is refused, and the caller raises.
//
// Bound: bytes.  The reference's book is r and the 3 metric diagonals in,
// z out: 5 x 8.19 MB = 41.0 MB at E=1024, n=10, fp64 (12.2 us at 3.35
// TB/s).  The work is k (12n + 10) flops per node (core/cost.py
// cheb_apply_flops), 0.53 GF at k=4: 8.5 us with the contractions on the
// fp64 tensor cores (67 TF/s) and the rest at 34 TF/s, below the book's
// bytes.  What the design moves: the RESIDENT variant reads r and the
// metric (4 fields) and writes A d (1) at the start, reads A d and the
// metric (4) and writes A d (1) at each middle step, and reads A d and r
// (2) and writes z (1) at the last: 5k + 3 fields, 23 at k = 4 (the metric
// and both A d buffers, 41 MB at E=1024, fit the 50 MB L2).  The device
// variant adds the state, 11k fields, 44 at k = 4 (the chain of k + 1
// launches it replaced moved 45).  On the card the operator's
// shared-memory reads take most of the time (scripts/k11_k14_ablation.py).
//
// The recurrence uses rounded, uncontracted arithmetic, as the plain
// version's separate tensor operations do; only the operator's
// contractions use FMA.  The scalars are read from a device pointer.
//
// Storage and accumulation (common.cuh).  The template takes the storage
// type S of the vectors (r, z and the mask and c factors), the storage
// type O of the operator's data (D, metric) and the accumulation type A
// (the scalars, the arithmetic, the partials).  Four builds: f64 and f32
// (one type throughout); bf16 (S = O = bf16, A = f32) and bf16_ir
// (S = bf16, O = A = f32: the bf16_ir policy keeps the operator's data in
// f32, core/precision.py).  The TPU kernel runs the whole recurrence in
// the accumulation type and rounds only z to storage, forming r.c.z over
// the rounded z (the next K4 reads the stored z).  So here the
// recurrence's state d, res and z, both unassembled A d buffers and the
// partials are A, whatever S is: the state in shared memory (RESIDENT) or
// in device scratch; in the device variant, where S is not A, the running
// z lives in a scratch field of its own (zacc) and the stored z is
// written once, at the last step.  Shared memory is sized by A
// (cheb_dyn_bytes, kernels/nekbone_ax.k11_state_bytes), so the bf16
// builds keep f32's plan.  bf16 reads r and the metric at 2 bytes a value
// (bf16_ir: the metric at 4) and writes z at 2.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

namespace nekbone {

namespace cg = cooperative_groups;

// The operands of one call, passed by value to the kernel.
template <typename S, typename O, typename A>
struct ChebArgs {
  const S* r;
  const O* D;
  const O* g3;
  const S* mx;
  const S* my;
  const S* mz;
  const S* cx;
  const S* cy;
  const S* cz;
  const A* coef;
  S* z;
  A* d;    // device variant only: (E, n^3) scratch
  A* res;  // device variant only: (E, n^3) scratch
  A* ad0;  // unassembled A d, even steps
  A* ad1;  // unassembled A d, odd steps
  A* rtz;
  int ex, ey, ez, k, per_block;
  A* zacc;  // device variant with S != A only: the running z, (E, n^3)
};

// The running z of the device variant: the output field itself where it
// holds A values, else its scratch.
template <typename S, typename O, typename A>
__device__ __forceinline__ A* running_z(const ChebArgs<S, O, A>& a) {
  if constexpr (std::is_same<S, A>::value)
    return a.z;
  else
    return a.zacc;
}

// The dynamic shared bytes of a block (kernels/nekbone_ax.k11_state_bytes
// and k11_plan compute the same): RESIDENT, d, res and z of its per_block
// elements; else one copy of the operator's input column per slice; every
// value an A.
template <int N, typename A>
constexpr size_t cheb_dyn_bytes(bool resident, int per_block) {
  return (resident ? static_cast<size_t>(per_block) * 3
                   : static_cast<size_t>(kSlices<N>)) *
         N * N * N * sizeof(A);
}

// The thread's element in one round of a block's owned range: slice p of
// round q works on element first + q P + p; a slice past the range (the
// last round of the last block) computes on the block's last element and
// stores nothing outside its own (allocated, unused) shared slot, so that
// it still meets every barrier.  per_block is a multiple of P.
template <int N, typename A, bool RESIDENT>
struct ChebNode {
  size_t e;       // the element the slice computes on
  bool active;    // e is its own
  int ix, iy, iz;
  size_t base;    // offset of the thread's layer-0 node
  A* sd;          // the thread's column of d, res and z, layer 0 (the
  A* sres;        // layers N * N apart)
  A* sz;
  A* col;         // the column of the operator's input d, in shared memory

  template <typename S, typename O>
  __device__ __forceinline__ ChebNode(const ChebArgs<S, O, A>& a, A* smem,
                                      size_t first, size_t last, int q, int p,
                                      int tid) {
    constexpr int N3 = N * N * N;
    const size_t local = static_cast<size_t>(q) * kSlices<N> + p;
    active = first + local < last;
    e = active ? first + local : last - 1;
    ix = static_cast<int>(e % a.ex);
    iy = static_cast<int>((e / a.ex) % a.ey);
    iz = static_cast<int>(e / (static_cast<size_t>(a.ex) * a.ey));
    base = e * N3 + tid;
    if (RESIDENT) {
      // [element][d, res, z][layer][thread]; a slot past the range is
      // allocated, and a slice past the range writes only there
      sd = smem + local * 3 * N3 + tid;
      sres = sd + N3;
      sz = sd + 2 * N3;
      col = sd;
    } else {
      sd = a.d + base;
      sres = a.res + base;
      sz = running_z(a) + base;
      // [slice][layer][thread]: the operator's copy of d
      col = smem + p * N3 + tid;
    }
  }
};

// The masked, unassembled A_loc of the thread's column of d into ad:
// common.cuh masked_ax, operation for operation (so the output is bitwise
// the same), with the column read from shared memory and the store kept to
// active slices.
template <int N, typename S, typename O, typename A>
__device__ __forceinline__ void cheb_ax(AxShared<N, A>& sh,
                                        const ChebArgs<S, O, A>& a,
                                        const A* col, A* ad, size_t e,
                                        bool active, int i, int j, int ix,
                                        int iy, int iz) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  const int tid = j * N + i;
  A wc[N];
  ax_diag_columns(sh, a.g3 + e * 3 * N3 + tid, SharedColumn<N, A>{col}, wc,
                  i, j);
  const A myx = convert<A>(a.my[iy * N + j]) * convert<A>(a.mx[ix * N + i]);
  if (active) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      ad[e * N3 + tid + k * N2] =
          wc[k] * (convert<A>(a.mz[iz * N + k]) * myx);
  }
}

// One step of the recurrence over the block's rounds: assemble ad_in, update
// d, res, z, then (not LAST) write the masked A_loc of the new d to ad_out,
// or (LAST) write z and the rtz partials.  At step 1 the device variant
// reads res as r and z as d (the RESIDENT start stores them).
template <int N, typename S, typename O, typename A, bool RESIDENT,
          bool LAST>
__device__ __forceinline__ void cheb_step(const ChebArgs<S, O, A>& a,
                                          AxShared<N, A>& sh, A* red, A* smem,
                                          const A* ad_in, A* ad_out,
                                          int step, size_t first, size_t last,
                                          int rounds, int p, int i, int j) {
  constexpr int N2 = N * N;
  const int tid = j * N + i;
  const A ci0 = a.coef[2 * step];
  const A ci1 = a.coef[2 * step + 1];
  for (int q = 0; q < rounds; ++q) {
    const ChebNode<N, A, RESIDENT> nd(a, smem, first, last, q, p, tid);
    A part = A(0);
    A cyx = A(0);
    if (LAST)
      cyx = convert<A>(a.cy[nd.iy * N + j]) * convert<A>(a.cx[nd.ix * N + i]);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int s = k * N2;
      const A aw = sum_xyz_cg<N>(ad_in, nd.e, k, j, i, nd.ix, nd.iy, nd.iz,
                                 a.ex, a.ey, a.ez);
      const A dold = nd.sd[s];
      const A resold = (!RESIDENT && step == 1)
                           ? convert<A>(a.r[nd.base + k * N2])
                           : nd.sres[s];
      const A zold = (!RESIDENT && step == 1) ? dold : nd.sz[s];
      const A rn = sub_rn(resold, aw);
      const A dn = add_rn(mul_rn(ci0, dold), mul_rn(ci1, rn));
      const A zn = add_rn(zold, dn);
      if (LAST) {
        // the stored z, and r.c.z over exactly it (the round trip through
        // S is the identity for f64 and f32)
        const S zs = convert<S>(zn);
        if (nd.active) a.z[nd.base + k * N2] = zs;
        // c is (cz * cy) * cx, exact in any order (factors 0, 1/2, 1).
        part += mul_rn(mul_rn(convert<A>(a.r[nd.base + k * N2]),
                              convert<A>(a.cz[nd.iz * N + k]) * cyx),
                       convert<A>(zs));
      } else {
        if (RESIDENT || nd.active) {
          nd.sd[s] = dn;
          nd.sres[s] = rn;
          nd.sz[s] = zn;
        }
        if (!RESIDENT) nd.col[s] = dn;
      }
    }
    if (LAST) {
      const A total = block_sum<N2>(part, red, tid);
      if (tid == 0 && nd.active) a.rtz[nd.e] = total;
    } else {
      cheb_ax(sh, a, nd.col, ad_out, nd.e, nd.active, i, j, nd.ix, nd.iy,
              nd.iz);
    }
  }
}

// Block (N, N, P): slice p = threadIdx.z works on its own element of each
// round, with its own operator scratch; the barriers inside the operator
// and the block sum are block-wide, so every slice runs every round.
template <int N, typename S, typename O, typename A, bool RESIDENT>
__global__ void __launch_bounds__(N * N * kSlices<N>, kMinBlocks<N>)
nekbone_cheb_kernel(const ChebArgs<S, O, A> a) {
  constexpr int N2 = N * N;
  constexpr int P = kSlices<N>;
  __shared__ AxShared<N, A> sh_all[P];
  __shared__ A red_all[P][N2];
  extern __shared__ __align__(16) unsigned char state_bytes[];
  A* smem = reinterpret_cast<A*>(state_bytes);

  cg::grid_group grid = cg::this_grid();
  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const int p = threadIdx.z;
  const int tid = j * N + i;
  AxShared<N, A>& sh = sh_all[p];
  A* red = red_all[p];
  const size_t E = static_cast<size_t>(a.ex) * a.ey * a.ez;
  const size_t first = static_cast<size_t>(blockIdx.x) * a.per_block;
  const size_t last = first + a.per_block < E ? first + a.per_block : E;
  const int rounds = static_cast<int>((last - first + P - 1) / P);

  // start: d = c00 r, and the masked A_loc d into ad0.  D is published by
  // the first barrier of the operator.
  load_D(sh, a.D, i, j);
  const A c00 = a.coef[0];
  for (int q = 0; q < rounds; ++q) {
    const ChebNode<N, A, RESIDENT> nd(a, smem, first, last, q, p, tid);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const A rv = convert<A>(a.r[nd.base + k * N2]);
      const A dk = mul_rn(c00, rv);
      if (RESIDENT || nd.active) nd.sd[k * N2] = dk;
      if (RESIDENT) {
        nd.sres[k * N2] = rv;
        nd.sz[k * N2] = dk;
      } else {
        nd.col[k * N2] = dk;
      }
    }
    cheb_ax(sh, a, nd.col, a.ad0, nd.e, nd.active, i, j, nd.ix, nd.iy,
            nd.iz);
  }
  for (int step = 1; step <= a.k; ++step) {
    // every block's A d of the previous step is written
    grid.sync();
    const A* ad_in = step % 2 ? a.ad0 : a.ad1;
    A* ad_out = step % 2 ? a.ad1 : a.ad0;
    if (step < a.k)
      cheb_step<N, S, O, A, RESIDENT, false>(a, sh, red, smem, ad_in, ad_out,
                                             step, first, last, rounds, p, i,
                                             j);
    else
      cheb_step<N, S, O, A, RESIDENT, true>(a, sh, red, smem, ad_in, ad_out,
                                            step, first, last, rounds, p, i,
                                            j);
  }
}

// out: common.cuh coop_query's seven values for this instantiation.
template <int N, typename S, typename O, typename A, bool RESIDENT>
cudaError_t query(int dyn, int* out) {
  return coop_query(reinterpret_cast<const void*>(
                        &nekbone_cheb_kernel<N, S, O, A, RESIDENT>),
                    N * N * kSlices<N>, kSlices<N>, dyn, out);
}

template <int N, typename S, typename O, typename A, bool RESIDENT>
cudaError_t launch(const ChebArgs<S, O, A>& a, int grid,
                   cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(
      &nekbone_cheb_kernel<N, S, O, A, RESIDENT>);
  const size_t dyn = cheb_dyn_bytes<N, A>(RESIDENT, a.per_block);
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dyn));
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<ChebArgs<S, O, A>*>(&a)};
  return cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(N, N, kSlices<N>),
                                     args, dyn, stream);
}

template <typename S, typename O, typename A>
int dispatch_query(int n, int resident, int dyn, int* out) {
  switch (n) {
#define NEKBONE_CASE(N)                                                    \
  case N:                                                                  \
    return static_cast<int>(resident ? query<N, S, O, A, true>(dyn, out)   \
                                     : query<N, S, O, A, false>(dyn, out));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename S, typename O, typename A>
int dispatch(const ChebArgs<S, O, A>& a, int n, int resident, int grid,
             void* stream) {
  const long long E = static_cast<long long>(a.ex) * a.ey * a.ez;
  if (a.ex <= 0 || a.ey <= 0 || a.ez <= 0 || a.k < 1 || a.per_block < 1 ||
      a.per_block % slices_of(n) != 0 ||
      grid < 1 || static_cast<long long>(grid) * a.per_block < E ||
      (!resident && (a.d == nullptr || a.res == nullptr ||
                     (!std::is_same<S, A>::value && a.zacc == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N)                                                     \
  case N:                                                                   \
    return static_cast<int>(resident ? launch<N, S, O, A, true>(a, grid, s) \
                                     : launch<N, S, O, A, false>(a, grid, s));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// r, z: (E, n^3) in S; D: (n, n) and g3: (E, 3, n^3) in O; mx, cx: (EX,
// n), my, cy: (EY, n), mz, cz: (EZ, n) in S; coef: (k+1, 2) and rtz: (E,)
// in A; ad0, ad1: (E, n^3) scratch in A; d, res: (E, n^3) scratch in A of
// the device variant (null when resident); zacc: (E, n^3) scratch in A of
// the device variant where S is not A (else null, unread).  Elements
// z-major over (EX, EY, EZ); block b owns elements [b * per_block, (b + 1)
// * per_block).  One cooperative launch of `grid` blocks; returns its
// error (cudaErrorCooperativeLaunchTooLarge when the grid cannot be
// resident at once), or 0.
//
// nekbone_cheb_apply_query_<dtype>(n, resident, dyn, out): fills out[7] as
// common.cuh coop_query documents; returns a CUDA error, or 0.
#define NEKBONE_CHEB_ENTRY(SUFFIX, S, O, A)                                   \
  extern "C" int nekbone_cheb_apply_##SUFFIX(                                 \
      const void* r, const void* D, const void* g3, const void* mx,           \
      const void* my, const void* mz, const void* cx, const void* cy,         \
      const void* cz, const void* coef, void* z, void* d, void* res,          \
      void* ad0, void* ad1, void* rtz, void* zacc, int ex, int ey, int ez,    \
      int n, int k, int resident, int per_block, int grid, void* stream) {    \
    const nekbone::ChebArgs<S, O, A> a{                                       \
        static_cast<const S*>(r),    static_cast<const O*>(D),                \
        static_cast<const O*>(g3),   static_cast<const S*>(mx),               \
        static_cast<const S*>(my),   static_cast<const S*>(mz),               \
        static_cast<const S*>(cx),   static_cast<const S*>(cy),               \
        static_cast<const S*>(cz),   static_cast<const A*>(coef),             \
        static_cast<S*>(z),          static_cast<A*>(d),                      \
        static_cast<A*>(res),        static_cast<A*>(ad0),                    \
        static_cast<A*>(ad1),        static_cast<A*>(rtz),                    \
        ex,                          ey,                                      \
        ez,                          k,                                       \
        per_block,                   static_cast<A*>(zacc)};                  \
    return nekbone::dispatch<S, O, A>(a, n, resident, grid, stream);          \
  }                                                                           \
  extern "C" int nekbone_cheb_apply_query_##SUFFIX(int n, int resident,       \
                                                   int dyn, int* out) {       \
    return nekbone::dispatch_query<S, O, A>(n, resident, dyn, out);           \
  }

#ifdef NEKBONE_REAL_F64
NEKBONE_CHEB_ENTRY(f64, double, double, double)
#endif
#ifdef NEKBONE_REAL_F32
NEKBONE_CHEB_ENTRY(f32, float, float, float)
#endif
#ifdef NEKBONE_REAL_BF16
NEKBONE_CHEB_ENTRY(bf16, __nv_bfloat16, __nv_bfloat16, float)
#endif
#ifdef NEKBONE_REAL_BF16_IR
NEKBONE_CHEB_ENTRY(bf16_ir, __nv_bfloat16, float, float)
#endif
