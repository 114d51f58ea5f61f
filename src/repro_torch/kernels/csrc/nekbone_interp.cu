// K12: tensor-product GLL-to-GLL interpolation of every element.
//
//     v[e][ko][jo][io] = sum_k mt[k][ko] sum_j mt[j][jo] sum_i mt[i][io]
//                        * u[e][k][j][i]
//
// with mt (nin, nout), rows indexed by the input grid: mt = J restricts
// (fine -> coarse, the unweighted core of the p-multigrid restriction) and
// mt = J^T prolongs (coarse -> fine); J = core/pmg.gll_interp_matrix.
//
// Replaces the TPU kernel src/repro/kernels/nekbone_ax.py:
// nekbone_interp_kernel (pallas_call at :1647).  The TPU kernel contracted a
// VMEM-resident block of z-slabs with three matrix-unit dot_generals.  Here
// the contractions are as small as they look (nin, nout <= 16).
//
// Bound: bytes, and at the coarse levels launch latency.  E=1024, fp64:
// 10 -> 5 reads 8.19 MB and writes 1.02 MB (2.8 us at 3.35 TB/s), 5 -> 3
// 1.02 + 0.22 MB, 3 -> 2 0.22 + 0.07 MB — well under the few microseconds
// a launch takes (bf16: 10 -> 5 2.05 + 0.26 MB).  2 (nin^2 nout + nin
// nout^2 + nout^3) flops per element.
//
// Design: a walker over groups of elements.  Blocks of a few whole
// elements, 256 threads, each ran once: load the whole input, a barrier,
// three contractions separated by barriers (at 10 -> 5 the last one had 125
// outputs for 256 threads), nothing overlapping the next element's load,
// and the block count fixed at compile time.  Here:
//
// * persistent blocks in one wave, planned on the host
//   (kernels/nekbone_ax.k12_plan): the elements go in groups of G, block b
//   owns the groups [b * per_block, (b + 1) * per_block) and walks them.  A
//   group's input is contiguous in (E, nin^3): one TMA bulk copy where its
//   bytes (and the last, shorter group's) are a multiple of 16 and u is
//   16-byte aligned (fp64 5 -> 10 and 3 -> 2 need G >= 2, bf16 5 -> 10
//   G >= 8), per-thread cp.async otherwise.  G keeps the most elements
//   resident an SM among the counts up to the least that keeps about 128
//   threads a block busy: the coarse steps run blocks of about 128
//   threads where they ran 4- to 25-thread elements, and 10 -> 5 takes
//   small groups, its input filling shared memory;
// * a ring of one stage in dynamic shared memory (common.cuh WalkRing<1>,
//   one mbarrier): the next group's copy is issued as soon as the current
//   group's contraction along i is done, so it lands while the group is
//   contracted along j and k; the fill is the ring's, with the group's own
//   byte count (the last group may be shorter); the first copy is issued
//   before mt is staged, once a block, in A.  The depth is the constant
//   kInterpStages: a second stage bought nothing as a ring (0.97-1.02x
//   where a block walks several groups; at E = 1024 every block walks one)
//   and costs shared memory.  scripts/parent_compare.py times a copy with
//   two; at fp64 10 -> 5 that copy compiles to fewer registers and keeps
//   three 150-thread blocks an SM where this one keeps two (140
//   registers), so it runs faster there;
// * the paper's thread structure: each element gets nout x max(nin, nout)
//   threads, and thread (jo, io) of its first nout x nout owns output
//   column (jo, io).  The block contracts every row of the group along i
//   at once (each thread the rows of its io, up to nin of them; on a
//   restriction the element's other threads share them) into shared
//   memory, one barrier, then thread (jo, io) contracts along j for each
//   of its nin layers into registers, and along k over those nin values
//   with no barrier; v is stored straight from registers, coalesced along
//   io.
//   The layer-by-layer form (one barrier a layer, two layer buffers)
//   measured slower (scripts/parent_compare.py times it beside this one).
//
// Order kept: along i, then j, then k, each sum over l = 0..n-1 in that
// order with rounded, uncontracted multiply and add, v rounded to S once.
// So v is bitwise the one-block-a-few-elements kernel's and the plain
// version's (kernels/ref.nekbone_interp_plain, whose separate tensor
// operations round each product and each sum) in every build, and the
// face property stays exact: an endpoint row of J is 0/1, so an element's
// face values depend only on its input face, and neighbours that agree on a
// face agree bitwise after prolongation.
//
// Storage and accumulation (common.cuh).  The template takes the storage
// type S of the fields (u in, v out), the storage type O of the transfer
// matrix mt and the accumulation type A.  Four builds: f64 and f32 (one
// type throughout); bf16 (S = O = bf16, A = f32) and bf16_ir (S = bf16,
// O = A = f32: the bf16_ir policy keeps the operator's data, the pmg
// transfers among them, in f32).  u is staged in S and upcast to A as it is
// read, mt is staged in A, the contractions and their buffer are A, and v
// is rounded to S once, at the end, as the TPU kernel does.  bf16
// moves 2 bytes per value in and out.
//
// Instantiated for the pairs of the p-multigrid ladder, (n, ceil(n/2)) and
// (ceil(n/2), n) for n = 3..16; any other pair returns an error.
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

// Threads a group's element takes: nout x max(nin, nout).  Thread (jo, io)
// of the first nout x nout owns output column (jo, io); on a restriction
// the other nout (nin - nout) share the contraction along i.
template <int NIN, int NOUT>
constexpr int kInterpLanes = NOUT * (NIN > NOUT ? NIN : NOUT);

// The most threads a block may have (G kInterpLanes): 1024 (64 registers a
// thread) where a row of the input is at most 20 bytes in A, else 256 (255
// registers).
template <int NIN, typename A>
constexpr int kInterpMaxThreads =
    NIN * static_cast<int>(sizeof(A)) <= 20 ? 1024 : 256;

// The ring's depth: one stage (kernels/nekbone_ax.K12_STAGES).
constexpr int kInterpStages = 1;

// The operands and plan of one launch, passed by value.
template <typename S, typename O>
struct InterpArgs {
  const S* u;
  const O* mt;
  S* v;
  int E;
  int group;      // G: elements a group, one copy
  int per_block;  // groups a block owns
  int bulk;       // 1: TMA bulk copies; 0: per-thread cp.async
};

// A group's input bytes and its slot in a stage (common.cuh
// walk_slot_bytes), and the dynamic shared bytes of a block: the ring,
// then the contraction along i of the group, G nin^2 nout values of A.
template <int NIN, int NOUT, typename S, typename A>
__host__ __device__ constexpr int interp_dyn_bytes(int group, int bulk) {
  return kInterpStages * walk_slot_bytes(group * NIN * NIN * NIN *
                                             static_cast<int>(sizeof(S)),
                                         bulk) +
         group * NIN * NIN * NOUT * static_cast<int>(sizeof(A));
}

// The N values of a row of the staged input, upcast to A, one value at a
// time (16-byte vector loads of the aligned rows measured no faster:
// scripts/parent_compare.py times them beside these).
template <int N, typename S, typename A>
__device__ __forceinline__ void interp_row(const S* row, A (&v)[N]) {
#pragma unroll
  for (int l = 0; l < N; ++l) v[l] = convert<A>(row[l]);
}

// The ne elements from e0 on into stage s of the ring: ring_fill_stage's
// copy with the group's own byte count (the last group may be shorter).
template <bool kBulk, int NIN3, typename S>
__device__ __forceinline__ void interp_fill(const WalkRing<1>& ring, int s,
                                            const S* u, size_t e0, int ne,
                                            int tid, int threads) {
  unsigned char* stage = ring.base + s * ring.stage_bytes;
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(u + e0 * NIN3);
  const int bytes = ne * NIN3 * static_cast<int>(sizeof(S));
  if constexpr (kBulk) {
    if (tid != 0) return;
    // the stage's last reads were generic; its next writes are TMA's
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(&ring.full[s], static_cast<unsigned>(bytes));
    bulk_copy(stage, src, static_cast<unsigned>(bytes), &ring.full[s]);
  } else {
    if constexpr (sizeof(S) == 8)
      copy_window<8>(stage, src, bytes, tid, threads);
    else
      copy_window<4>(stage, src, bytes, tid, threads);
    cp_async_arrive(&ring.full[s]);
  }
}

// The walk of a block over its groups.
template <int NIN, int NOUT, bool kBulk, typename S, typename O, typename A>
__device__ __forceinline__ void interp_walk(const InterpArgs<S, O>& a,
                                            A* smt, unsigned long long* full,
                                            unsigned char* ring_bytes) {
  constexpr int NIN2 = NIN * NIN;
  constexpr int NIN3 = NIN2 * NIN;
  constexpr int NOUT2 = NOUT * NOUT;
  constexpr int NOUT3 = NOUT2 * NOUT;
  constexpr int kU = sizeof(S) == 8 ? 8 : 4;  // the cp.async copy unit
  // rows along i a thread contracts for a group: G nin^2 rows over G
  // kInterpLanes / nout row slots
  constexpr int kSlots = kInterpLanes<NIN, NOUT> / NOUT;
  constexpr int kRows = (NIN2 + kSlots - 1) / kSlots;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int G = a.group;
  const size_t groups = (static_cast<size_t>(a.E) + G - 1) / G;
  size_t first, last;
  walk_range(groups, a.per_block, first, last);
  const int count = static_cast<int>(last - first);
  const void* const src[1] = {a.u};
  const int bytes[1] = {G * NIN3 * static_cast<int>(sizeof(S))};
  const int size[1] = {static_cast<int>(sizeof(S))};
  const WalkPlan plan{a.per_block, kInterpStages, 1, kBulk ? 1 : 0};
  WalkRing<1> ring(full, ring_bytes, plan, src, bytes, size);
  A* v1 = reinterpret_cast<A*>(ring_bytes + kInterpStages * ring.stage_bytes);
  // the elements of group g (the last group may be shorter)
  auto elements = [&](size_t g) {
    const size_t left = static_cast<size_t>(a.E) - g * G;
    return left < static_cast<size_t>(G) ? static_cast<int>(left) : G;
  };
  // the first copy is in flight while mt is staged: on the bulk path
  // thread 0 makes the barrier and issues it at once; cp.async copies
  // need every thread to see the barrier first
  if (kBulk) {
    if (tid == 0) {
      ring.init(tid, threads);
      for (int t = 0; t < kInterpStages && t < count; ++t)
        interp_fill<kBulk, NIN3>(ring, t, a.u, (first + t) * G,
                                 elements(first + t), tid, threads);
    }
  } else {
    ring.init(tid, threads);
  }
  for (int q = tid; q < NIN * NOUT; q += threads) smt[q] = convert<A>(a.mt[q]);
  __syncthreads();
  if (!kBulk)
    for (int t = 0; t < kInterpStages && t < count; ++t)
      interp_fill<kBulk, NIN3>(ring, t, a.u, (first + t) * G,
                               elements(first + t), tid, threads);
  // thread (el, jo, io), tid < G nout^2: element el of the group, output
  // column (jo, io); every thread's rows along i are those of its io
  const int el = tid / NOUT2;
  const int jo = (tid / NOUT) % NOUT;
  const int io = tid % NOUT;
  A mi[NIN], mj[NIN];
#pragma unroll
  for (int l = 0; l < NIN; ++l) {
    mi[l] = smt[l * NOUT + io];
    mj[l] = smt[l * NOUT + jo];
  }
  const int row0 = tid / NOUT;
  const int rows_step = G * kSlots;
  // the t-th group's stage s = t % kInterpStages and its phase
  // (t / kInterpStages) & 1
  int s = 0;
  unsigned phase = 0;
  for (int t = 0; t < count; ++t) {
    const size_t g = first + t;
    const size_t e0 = g * G;
    const int ne = elements(g);
    mbar_wait(&full[s], phase);
    const S* in = reinterpret_cast<const S*>(
        ring.base + s * ring.stage_bytes +
        (kBulk ? 0
               : static_cast<int>(reinterpret_cast<size_t>(a.u + e0 * NIN3) &
                                  (kU - 1))));
    // along i, every layer: v1[el'][k][j][io] = sum_i u[el'][k][j][i]
    // mt[i][io], the rows (el', k, j) contiguous in the stage
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int row = row0 + m * rows_step;
      if (row < ne * NIN2) {
        A uv[NIN];
        interp_row<NIN>(in + row * NIN, uv);
        A acc = A(0);
#pragma unroll
        for (int l = 0; l < NIN; ++l) acc = add_rn(acc, mul_rn(uv[l], mi[l]));
        v1[row * NOUT + io] = acc;
      }
    }
    __syncthreads();
    // no thread reads this group's stage any more
    if (t + kInterpStages < count)
      interp_fill<kBulk, NIN3>(ring, s, a.u, (g + kInterpStages) * G,
                               elements(g + kInterpStages), tid, threads);
    // along j, every layer: v2[k] = sum_j v1[el][k][j][io] mt[j][jo]
    if (el < ne) {
      A v2[NIN];
      const A* b = v1 + el * NIN2 * NOUT + io;
#pragma unroll
      for (int k = 0; k < NIN; ++k) {
        A acc = A(0);
#pragma unroll
        for (int l = 0; l < NIN; ++l)
          acc = add_rn(acc, mul_rn(b[(k * NIN + l) * NOUT], mj[l]));
        v2[k] = acc;
      }
      // along k, in registers: v[ko][jo][io] = sum_k v2[k] mt[k][ko]
      S* out = a.v + (e0 + el) * NOUT3 + jo * NOUT + io;
#pragma unroll
      for (int ko = 0; ko < NOUT; ++ko) {
        A acc = A(0);
#pragma unroll
        for (int l = 0; l < NIN; ++l)
          acc = add_rn(acc, mul_rn(v2[l], smt[l * NOUT + ko]));
        out[ko * NOUT2] = convert<S>(acc);
      }
    }
    // v1 is the next group's
    if (t + 1 < count) __syncthreads();
    if (++s == kInterpStages) {
      s = 0;
      phase ^= 1u;
    }
  }
}

template <int NIN, int NOUT, typename S, typename O, typename A>
__global__ void __launch_bounds__(kInterpMaxThreads<NIN, A>)
nekbone_interp_kernel(const InterpArgs<S, O> a) {
  __shared__ A smt[NIN * NOUT];
  __shared__ unsigned long long full[kMaxStages];
  extern __shared__ __align__(128) unsigned char ring_bytes[];
  if (a.bulk)
    interp_walk<NIN, NOUT, true>(a, smt, full, ring_bytes);
  else
    interp_walk<NIN, NOUT, false>(a, smt, full, ring_bytes);
}

// The launch floor the coarse steps are read against: a kernel that does
// nothing, launched as K12 is (nekbone_interp_floor_<dtype>).
__global__ void nekbone_interp_floor_kernel() {}

template <int NIN, int NOUT, typename S, typename O, typename A>
const void* kernel_fn() {
  return reinterpret_cast<const void*>(
      &nekbone_interp_kernel<NIN, NOUT, S, O, A>);
}

// A plan the kernel can run on these pointers: G kInterpLanes threads at
// most kInterpMaxThreads, every group owned; the
// bulk path needs u 16-byte aligned and every group's bytes (the last's
// too) a multiple of 16, the cp.async path u aligned to its values.
template <int NIN, int NOUT, typename S, typename O, typename A>
bool interp_plan_ok(const InterpArgs<S, O>& a, int grid) {
  constexpr long long kIn =
      static_cast<long long>(NIN) * NIN * NIN * sizeof(S);
  if (a.group < 1 ||
      a.group * kInterpLanes<NIN, NOUT> > kInterpMaxThreads<NIN, A> ||
      a.per_block < 1 || grid < 1 || (a.bulk != 0 && a.bulk != 1))
    return false;
  const long long groups = (a.E + a.group - 1) / a.group;
  if (static_cast<long long>(grid) * a.per_block < groups) return false;
  const size_t addr = reinterpret_cast<size_t>(a.u);
  if (!a.bulk) return addr % sizeof(S) == 0;
  const long long tail = a.E - (groups - 1) * a.group;
  return addr % 16 == 0 && (a.group * kIn) % 16 == 0 && (tail * kIn) % 16 == 0;
}

template <int NIN, int NOUT, typename S, typename O, typename A>
cudaError_t launch(const InterpArgs<S, O>& a, int grid, cudaStream_t stream) {
  if (!interp_plan_ok<NIN, NOUT, S, O, A>(a, grid))
    return cudaErrorInvalidValue;
  const int dyn = interp_dyn_bytes<NIN, NOUT, S, A>(a.group, a.bulk);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel_fn<NIN, NOUT, S, O, A>(),
      cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return err;
  nekbone_interp_kernel<NIN, NOUT, S, O, A>
      <<<grid, a.group * kInterpLanes<NIN, NOUT>, dyn, stream>>>(a);
  return cudaGetLastError();
}

// out: common.cuh coop_query's seven values for this instantiation at
// `threads` threads a block.
template <int NIN, int NOUT, typename S, typename O, typename A>
cudaError_t query(int threads, int dyn, int* out) {
  return coop_query(kernel_fn<NIN, NOUT, S, O, A>(), threads, 1, dyn, out);
}

// The ladder pairs: (n, ceil(n/2)) and back for n = 3..16.
#define NEKBONE_FOR_EACH_PAIR(PAIR)                                     \
  PAIR(3) PAIR(4) PAIR(5) PAIR(6) PAIR(7) PAIR(8) PAIR(9) PAIR(10)     \
  PAIR(11) PAIR(12) PAIR(13) PAIR(14) PAIR(15) PAIR(16)

template <typename S, typename O, typename A>
int dispatch(const InterpArgs<S, O>& a, int nin, int nout, int grid,
             void* stream) {
  if (a.E <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nin * 32 + nout) {
#define NEKBONE_PAIR(NF)                                                   \
  case (NF) * 32 + ((NF) + 1) / 2:                                         \
    return static_cast<int>(                                               \
        launch<(NF), ((NF) + 1) / 2, S, O, A>(a, grid, s));                \
  case (((NF) + 1) / 2) * 32 + (NF):                                       \
    return static_cast<int>(                                               \
        launch<((NF) + 1) / 2, (NF), S, O, A>(a, grid, s));
    NEKBONE_FOR_EACH_PAIR(NEKBONE_PAIR)
#undef NEKBONE_PAIR
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename S, typename O, typename A>
int dispatch_query(int nin, int nout, int threads, int dyn, int* out) {
  switch (nin * 32 + nout) {
#define NEKBONE_PAIR(NF)                                                   \
  case (NF) * 32 + ((NF) + 1) / 2:                                         \
    return static_cast<int>(                                               \
        query<(NF), ((NF) + 1) / 2, S, O, A>(threads, dyn, out));          \
  case (((NF) + 1) / 2) * 32 + (NF):                                       \
    return static_cast<int>(                                               \
        query<((NF) + 1) / 2, (NF), S, O, A>(threads, dyn, out));
    NEKBONE_FOR_EACH_PAIR(NEKBONE_PAIR)
#undef NEKBONE_PAIR
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// u: (E, nin^3) and v: (E, nout^3) in S; mt: (nin, nout) in O.  The plan
// (group, per_block, grid, bulk) is kernels/nekbone_ax.k12_plan's;
// a plan the pointers do not allow returns cudaErrorInvalidValue.  Returns
// cudaGetLastError() after the launch.
//
// nekbone_interp_query_<dtype>(nin, nout, threads, dyn, out): fills out[7]
// as common.cuh coop_query documents for blocks of `threads` threads;
// returns a CUDA error, or 0.
//
// nekbone_interp_floor_<dtype>(grid, threads, dyn, stream): launches the
// empty kernel on that grid; returns cudaGetLastError().
#define NEKBONE_INTERP_ENTRY(SUFFIX, S, O, A)                                \
  extern "C" int nekbone_interp_##SUFFIX(                                    \
      const void* u, const void* mt, void* v, int E, int nin, int nout,      \
      int group, int per_block, int grid, int bulk, void* stream) {          \
    const nekbone::InterpArgs<S, O> a{                                       \
        static_cast<const S*>(u), static_cast<const O*>(mt),                 \
        static_cast<S*>(v),       E,                                         \
        group,                    per_block,                                 \
        bulk};                                                               \
    return nekbone::dispatch<S, O, A>(a, nin, nout, grid, stream);           \
  }                                                                          \
  extern "C" int nekbone_interp_query_##SUFFIX(int nin, int nout,            \
                                               int threads, int dyn,         \
                                               int* out) {                   \
    return nekbone::dispatch_query<S, O, A>(nin, nout, threads, dyn, out);   \
  }                                                                          \
  extern "C" int nekbone_interp_floor_##SUFFIX(int grid, int threads,        \
                                               int dyn, void* stream) {      \
    if (dyn > 48 * 1024) {                                                   \
      const cudaError_t err = cudaFuncSetAttribute(                          \
          nekbone::nekbone_interp_floor_kernel,                              \
          cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);                 \
      if (err != cudaSuccess) return static_cast<int>(err);                  \
    }                                                                        \
    nekbone::nekbone_interp_floor_kernel<<<grid, threads, dyn,               \
                                           static_cast<cudaStream_t>(        \
                                               stream)>>>();                 \
    return static_cast<int>(cudaGetLastError());                             \
  }

#ifdef NEKBONE_REAL_F64
NEKBONE_INTERP_ENTRY(f64, double, double, double)
#endif
#ifdef NEKBONE_REAL_F32
NEKBONE_INTERP_ENTRY(f32, float, float, float)
#endif
#ifdef NEKBONE_REAL_BF16
NEKBONE_INTERP_ENTRY(bf16, __nv_bfloat16, __nv_bfloat16, float)
#endif
#ifdef NEKBONE_REAL_BF16_IR
NEKBONE_INTERP_ENTRY(bf16_ir, __nv_bfloat16, float, float)
#endif
