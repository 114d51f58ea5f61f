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
// the three contractions are as small as they look (nin, nout <= 16), so a
// thread block takes a few whole elements: it stages their input and mt in
// shared memory, and runs the contractions in the reference's order — along
// i first ((k, j, i) -> (k, j, io)), then j, then k — one output value per
// thread and step, each sum over l = 0..n-1 in that fixed order, with
// rounded, uncontracted multiply and add.  That makes the result bitwise the
// plain version's (kernels/ref.nekbone_interp_plain, whose separate tensor
// operations round each product and each sum) in fp64 and fp32, and keeps
// the face property exact: an endpoint row of J is 0/1, so an element's
// face values depend only on its input face and neighbours that agree on a
// face agree bitwise after prolongation.
//
// Shared memory per element: the input, later reused for the second
// stage's output, and the first stage's output.  Elements per block are
// chosen on the host to put about 1024 input or output values in a block
// (one element at 10 -> 5, eight at 5 -> 3, 37 at 3 -> 2), so the coarse
// levels do not run 4- to 25-thread blocks.
//
// Storage and accumulation (common.cuh).  The template takes the storage
// type S of the fields (u in, v out), the storage type O of the transfer
// matrix mt and the accumulation type A.  Four builds: f64 and f32 (one
// type throughout); bf16 (S = O = bf16, A = f32) and bf16_ir (S = bf16,
// O = A = f32: the bf16_ir policy keeps the operator's data, the pmg
// transfers among them, in f32).  u and mt are upcast to A as they are
// staged, so every staged value, the three contractions and both
// intermediate buffers are A, and v is rounded to S once, at the end, as
// the TPU kernel does; the shared memory is sized by A.  bf16 moves 2
// bytes per value in and out.
//
// Bound: bytes, and at the coarse levels launch latency.  E=1024, fp64:
// 10 -> 5 reads 8.19 MB and writes 1.02 MB (2.8 us at 3.35 TB/s), 5 -> 3
// 1.02 + 0.22 MB, 3 -> 2 0.22 + 0.07 MB — well under the few microseconds
// a launch takes (bf16: 10 -> 5 2.05 + 0.26 MB).  2 (nin^2 nout + nin
// nout^2 + nout^3) flops per element.
//
// Instantiated for the pairs of the p-multigrid ladder, (n, ceil(n/2)) and
// (ceil(n/2), n) for n = 3..16; any other pair returns an error.
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

template <int NIN, int NOUT>
struct InterpShape {
  static constexpr int kIn = NIN * NIN * NIN;     // u: (k, j, i)
  static constexpr int kV1 = NIN * NIN * NOUT;    // (k, j, io)
  static constexpr int kV2 = NIN * NOUT * NOUT;   // (k, jo, io)
  static constexpr int kOut = NOUT * NOUT * NOUT; // (ko, jo, io)
  // bufA holds u, then the second stage's output; bufB the first's
  static constexpr int kA = kIn > kV2 ? kIn : kV2;
  static constexpr int kPerElem = kA + kV1;
  static constexpr int kMt = (NIN * NOUT + 1) / 2 * 2;  // keeps bufA aligned
};

constexpr int kInterpThreads = 256;

template <int NIN, int NOUT, typename S, typename O, typename A>
__global__ void __launch_bounds__(kInterpThreads)
nekbone_interp_kernel(const S* __restrict__ u, const O* __restrict__ mt,
                      S* __restrict__ v, int E, int epb) {
  using Sh = InterpShape<NIN, NOUT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* smt = reinterpret_cast<A*>(smem_raw);
  A* bufA = smt + Sh::kMt;
  A* bufB = bufA + static_cast<size_t>(epb) * Sh::kA;

  const size_t e0 = static_cast<size_t>(blockIdx.x) * epb;
  const int ne = min(epb, E - static_cast<int>(e0));
  const int tid = threadIdx.x;
  constexpr int nt = kInterpThreads;

  for (int t = tid; t < NIN * NOUT; t += nt) smt[t] = convert<A>(mt[t]);
  const S* ub = u + e0 * Sh::kIn;
  for (int t = tid; t < ne * Sh::kIn; t += nt) {
    const int el = t / Sh::kIn;
    bufA[el * Sh::kA + (t - el * Sh::kIn)] = convert<A>(ub[t]);
  }
  __syncthreads();

  // along i: v1[k][j][io] = sum_i u[k][j][i] mt[i][io]
  for (int t = tid; t < ne * Sh::kV1; t += nt) {
    const int el = t / Sh::kV1;
    const int q = t - el * Sh::kV1;
    const int io = q % NOUT;
    const A* a = bufA + el * Sh::kA + (q / NOUT) * NIN;
    A acc = A(0);
#pragma unroll
    for (int l = 0; l < NIN; ++l) acc = add_rn(acc, mul_rn(a[l], smt[l * NOUT + io]));
    bufB[t] = acc;
  }
  __syncthreads();

  // along j: v2[k][jo][io] = sum_j v1[k][j][io] mt[j][jo]
  for (int t = tid; t < ne * Sh::kV2; t += nt) {
    const int el = t / Sh::kV2;
    const int q = t - el * Sh::kV2;
    const int io = q % NOUT;
    const int jo = (q / NOUT) % NOUT;
    const int k = q / (NOUT * NOUT);
    const A* b = bufB + el * Sh::kV1 + k * NIN * NOUT + io;
    A acc = A(0);
#pragma unroll
    for (int l = 0; l < NIN; ++l)
      acc = add_rn(acc, mul_rn(b[l * NOUT], smt[l * NOUT + jo]));
    bufA[el * Sh::kA + q] = acc;
  }
  __syncthreads();

  // along k: v[ko][jo][io] = sum_k v2[k][jo][io] mt[k][ko], rounded to S
  S* vb = v + e0 * Sh::kOut;
  for (int t = tid; t < ne * Sh::kOut; t += nt) {
    const int el = t / Sh::kOut;
    const int q = t - el * Sh::kOut;
    const int ko = q / (NOUT * NOUT);
    const A* a = bufA + el * Sh::kA + (q - ko * NOUT * NOUT);
    A acc = A(0);
#pragma unroll
    for (int l = 0; l < NIN; ++l)
      acc = add_rn(acc, mul_rn(a[l * NOUT * NOUT], smt[l * NOUT + ko]));
    vb[t] = convert<S>(acc);
  }
}

// The dynamic shared bytes of a block of epb elements: mt and the two
// buffers, every value staged in A.
template <int NIN, int NOUT, typename A>
constexpr size_t interp_smem_bytes(int epb) {
  using Sh = InterpShape<NIN, NOUT>;
  return (Sh::kMt + static_cast<size_t>(epb) * Sh::kPerElem) * sizeof(A);
}

template <int NIN, int NOUT, typename S, typename O, typename A>
cudaError_t launch(const S* u, const O* mt, S* v, int E,
                   cudaStream_t stream) {
  using Sh = InterpShape<NIN, NOUT>;
  constexpr int kBig = Sh::kIn > Sh::kOut ? Sh::kIn : Sh::kOut;
  constexpr int epb = kBig >= 1024 ? 1 : 1024 / kBig;
  const size_t smem = interp_smem_bytes<NIN, NOUT, A>(epb);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nekbone_interp_kernel<NIN, NOUT, S, O, A>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (E + epb - 1) / epb;
  nekbone_interp_kernel<NIN, NOUT, S, O, A>
      <<<blocks, kInterpThreads, smem, stream>>>(u, mt, v, E, epb);
  return cudaGetLastError();
}

template <typename S, typename O, typename A>
int dispatch(const S* u, const O* mt, S* v, int E, int nin, int nout,
             void* stream) {
  if (E <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nin * 32 + nout) {
#define NEKBONE_PAIR(NF)                                                   \
  case (NF) * 32 + ((NF) + 1) / 2:                                         \
    return static_cast<int>(                                               \
        launch<(NF), ((NF) + 1) / 2, S, O, A>(u, mt, v, E, s));            \
  case (((NF) + 1) / 2) * 32 + (NF):                                       \
    return static_cast<int>(                                               \
        launch<((NF) + 1) / 2, (NF), S, O, A>(u, mt, v, E, s));
    NEKBONE_PAIR(3) NEKBONE_PAIR(4) NEKBONE_PAIR(5) NEKBONE_PAIR(6)
    NEKBONE_PAIR(7) NEKBONE_PAIR(8) NEKBONE_PAIR(9) NEKBONE_PAIR(10)
    NEKBONE_PAIR(11) NEKBONE_PAIR(12) NEKBONE_PAIR(13) NEKBONE_PAIR(14)
    NEKBONE_PAIR(15) NEKBONE_PAIR(16)
#undef NEKBONE_PAIR
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// u: (E, nin^3) and v: (E, nout^3) in S; mt: (nin, nout) in O.  Returns
// cudaGetLastError() after the launch.
#define NEKBONE_INTERP_ENTRY(NAME, S, O, A)                                  \
  extern "C" int NAME(const void* u, const void* mt, void* v, int E,        \
                      int nin, int nout, void* stream) {                    \
    return nekbone::dispatch<S, O, A>(static_cast<const S*>(u),              \
                                      static_cast<const O*>(mt),             \
                                      static_cast<S*>(v), E, nin, nout,      \
                                      stream);                               \
  }

#ifdef NEKBONE_REAL_F64
NEKBONE_INTERP_ENTRY(nekbone_interp_f64, double, double, double)
#endif
#ifdef NEKBONE_REAL_F32
NEKBONE_INTERP_ENTRY(nekbone_interp_f32, float, float, float)
#endif
#ifdef NEKBONE_REAL_BF16
NEKBONE_INTERP_ENTRY(nekbone_interp_bf16, __nv_bfloat16, __nv_bfloat16,
                     float)
#endif
#ifdef NEKBONE_REAL_BF16_IR
NEKBONE_INTERP_ENTRY(nekbone_interp_bf16_ir, __nv_bfloat16, float, float)
#endif
