"""The paper's cost model (Eq. 1-2) and the byte books of the ported paths.

Paper §III-A:  per CG iteration over ``D`` degrees of freedom with ``n`` GLL
points per direction,

    C(D, n) = D * (12 n + 34)                 flops            (Eq. 1)
    reads   = 24 D,   writes = 6 D            fp64 words
    I(n)    = (12 n + 34) / 240               flop/byte (fp64) (Eq. 2)

Pure arithmetic, hardware-independent: a copy of the reference's
``core/cost.py``, every public name: the v1, v2 and s-step books, the
preconditioned v2 books (Jacobi, Chebyshev), the p-multigrid books, the
multi-RHS books, the side channels and collectives of the reference's halo'd
and sharded pipelines, and the dtype-aware rung table
(:data:`PIPELINE_STREAMS`, :func:`bytes_per_dof_iter`).  They count bytes
and flops, not time, so they carry over as they are; the port's own K11 is
priced by :func:`cheb_apply_flops`.
"""
from __future__ import annotations

import dataclasses

__all__ = ["flops_per_dof", "cg_iter_flops", "cg_iter_bytes", "intensity",
           "ax_local_flops", "ax_local_bytes", "CostModel",
           "CG_READ_STREAMS", "CG_WRITE_STREAMS", "FUSED_CG_READ_STREAMS",
           "FUSED_CG_WRITE_STREAMS", "fused_cg_iter_bytes",
           "fused_intensity", "SSTEP_DEFAULT_S", "sstep_cycle_streams",
           "sstep_streams", "sstep_halo_streams", "sstep_intensity",
           "FUSED_V2_READ_STREAMS",
           "FUSED_V2_WRITE_STREAMS", "fused_v2_cg_iter_bytes",
           "PRECISION_ITEMSIZE", "precision_itemsize",
           "JACOBI_V2_READ_STREAMS", "JACOBI_V2_WRITE_STREAMS",
           "CHEB_V2_READ_STREAMS", "CHEB_V2_WRITE_STREAMS", "CHEB_DEFAULT_K",
           "cheb_apply_flops", "PMG_DEFAULT_K", "PMG_COARSE_ITERS",
           "PMG_SMOOTH_RATIO", "pmg_degrees", "pmg_dof_fracs",
           "pmg_vcycle_streams", "pmg_streams", "pmg_flops_per_dof",
           "MULTI_RHS_SHARED_STREAMS", "multi_rhs_streams",
           "ir_overhead_streams", "MULTI_RHS_BATCHES", "streams_per_rhs",
           "multi_rhs_halo_streams", "fused_v2_intensity",
           "fused_v2_plane_streams", "sstep_collective_streams",
           "cheb_collective_streams", "v2_plane_collective_streams",
           "sstep_effective_streams", "cheb_halo_streams",
           "cheb_effective_streams", "cheb_flops_per_dof",
           "pmg_halo_streams", "pmg_effective_streams", "PIPELINE_STREAMS",
           "bytes_per_dof_iter", "pipeline_flops_per_dof",
           "pipeline_intensity", "roofline_gflops"]

# Eq. 2's stream counts: words moved per DOF per CG iteration when the
# operator, mask, and every inner product run as separate passes.
CG_READ_STREAMS = 24
CG_WRITE_STREAMS = 6

# The fused-iteration pipeline v1 (core/cg_fused.py, DESIGN.md §3.3) moves:
#   kernel (K3): reads p, 6 metric fields, mask      (8)    writes w (1)
#   vector pass: reads x, p, r, w, c                 (5)    writes x, r, p (3)
# The r·c·r reduction is carried through the loop state, so the kernel
# reads no r/c — 13R + 4W = 17 streams.  The per-element dot partials are E
# scalars — charged as zero streams.
FUSED_CG_READ_STREAMS = 13
FUSED_CG_WRITE_STREAMS = 4

# The v2 pipeline (core/cg_fused.py) runs the whole iteration in two
# kernels:
#   K4 (front half): reads p, r, 3 metric diagonals    (5)    writes p, w (2)
#   K5 (back half):  reads x, p, r, w                  (4)    writes x, r (2)
# The mask and the weight c are rebuilt from per-axis factors, and the
# axis-aligned box metric is diagonal.  K5's reads of the neighbours' face
# copies of w are not counted as a stream.
FUSED_V2_READ_STREAMS = 9
FUSED_V2_WRITE_STREAMS = 4

# The s-step pipeline (core/cg_sstep.py, DESIGN.md §8) runs s CG iterations
# per *cycle*:
#   powers kernel (K8): reads p, r, 3 metric diagonals   (5)  writes 2s-1
#                       basis vectors
#   update kernel (K9): reads x + the 2s+1 basis (incl.  (2s+2)  writes x,
#                       p and r, re-read)                        r, p (3)
# = (2s+7) reads + (2s+2) writes = 4s+9 streams per s iterations: the v2
# budget (13) at s=1, 25/4 = 6.25 streams/iter at the default s=4.  In the
# port K8 is a chain of s + 2 launches over the whole box (its source note
# states what the chain moves); the books stay the reference's, the least
# traffic the algorithm needs.
SSTEP_DEFAULT_S = 4


def sstep_cycle_streams(s: int) -> tuple[int, int]:
    """(reads, writes) full-field streams per s-step *cycle* (s iterations)."""
    return 2 * s + 7, 2 * s + 2


def sstep_streams(s: int) -> tuple[float, float]:
    """(reads, writes) streams per DOF per CG *iteration* of the s-step
    pipeline — the per-cycle budget amortized by 1/s.  ``sstep_streams(1)``
    equals the v2 budget exactly: (9, 4)."""
    r, w = sstep_cycle_streams(s)
    return r / float(s), w / float(s)


def sstep_halo_streams(s: int, sz: int) -> float:
    """Stream-equivalents of the reference's matrix-powers halo, per
    iteration: ``5 * 2s / sz`` stream-fractions per cycle over s iterations,
    ``10/sz`` whatever s is.  It prices the TPU kernel's materialized ghost
    windows, which the port's K8 does not have; kept for parity with the
    reference's books, not as the port's bound."""
    return 2.0 * 5.0 * float(s) / (float(sz) * float(s))


# Preconditioned v2 pipelines (core/precond.py, DESIGN.md §9).
#
# Jacobi: the solver carries the *preconditioned* residual z = D^-1 r, so
# the slab front-half is the v2 kernel unchanged (reads p, z, 3 metric
# diagonals; writes p, w) and the merged PCG update kernel adds exactly one
# stream — the assembled operator diagonal:
#   update kernel: reads x, p, z, w, invdiag    (5)    writes x, z (2)
# = 10R + 4W = 14 streams/iter, one more than unpreconditioned v2.
JACOBI_V2_READ_STREAMS = 10
JACOBI_V2_WRITE_STREAMS = 4

# Chebyshev(k): one extra kernel per iteration evaluates z = q_k(A) r; in
# the reference it is a single halo'd slab residency (the §8
# matrix-powers machinery):
#   cheb kernel:   reads r, 3 metric diagonals  (4)    writes z (1)
#   slab kernel:   reads p, z, 3 metric         (5)    writes p, w (2)
#   update kernel: reads x, p, r, w             (4)    writes x, r (2)
# = 13R + 5W = 18 streams/iter regardless of k (the k chained operator
# applications stay on chip).  The win is the *iteration count*: the
# E=1024/n=10 acceptance case converges to 1e-8 in ~2x fewer iterations
# at k=4.
CHEB_V2_READ_STREAMS = 13
CHEB_V2_WRITE_STREAMS = 5
CHEB_DEFAULT_K = 4

# In the port the Chebyshev apply (K11, kernels/csrc/nekbone_cheb_apply.cu)
# is one cooperative launch with a grid sync between its k steps, not one
# halo'd residency: the books above stay the reference's (the least traffic
# the algorithm needs), and what the kernel moves (5k + 3 fields with its
# state in shared memory, 11k in device memory) is stated in its source
# note.


PRECISION_ITEMSIZE = {"f64": 8, "f32": 4, "bf16": 2,
                      "f32_ir": 4, "bf16_ir": 2}


def precision_itemsize(precision) -> int:
    """Storage bytes/word of a policy name or PrecisionPolicy instance."""
    itemsize = getattr(precision, "itemsize", None)
    if itemsize is not None:
        return int(itemsize)
    return PRECISION_ITEMSIZE[str(precision)]


def flops_per_dof(n: int) -> int:
    """Eq. 1 coefficient: flops per DOF per CG iteration."""
    return 12 * n + 34


def cg_iter_flops(ndof: int, n: int) -> int:
    """Eq. 1: C(D, n)."""
    return ndof * flops_per_dof(n)


def cg_iter_bytes(ndof: int, itemsize: int = 8) -> tuple[int, int]:
    """(read_bytes, write_bytes) per CG iteration: 24 D reads, 6 D writes."""
    return (CG_READ_STREAMS * ndof * itemsize,
            CG_WRITE_STREAMS * ndof * itemsize)


def intensity(n: int, itemsize: int = 8) -> float:
    """Eq. 2 generalized to dtype: I = (12n+34) / (30 * itemsize)."""
    return flops_per_dof(n) / (30.0 * itemsize)


def fused_cg_iter_bytes(ndof: int, itemsize: int = 8) -> tuple[int, int]:
    """(read_bytes, write_bytes) of the step-fused CG iteration (v1, with
    the carried r·c·r): 13 D reads, 4 D writes (vs Eq. 2's 24 + 6 — a
    30/17 ≈ 1.76x traffic cut)."""
    return (FUSED_CG_READ_STREAMS * ndof * itemsize,
            FUSED_CG_WRITE_STREAMS * ndof * itemsize)


def fused_intensity(n: int, itemsize: int = 8) -> float:
    """Eq. 2 re-evaluated for the fused pipeline: same flops over 17 streams."""
    return flops_per_dof(n) / (
        (FUSED_CG_READ_STREAMS + FUSED_CG_WRITE_STREAMS) * float(itemsize))


def sstep_intensity(n: int, s: int, itemsize: int = 8) -> float:
    """Eq. 2 re-evaluated for the s-step pipeline (headline streams)."""
    r, w = sstep_streams(s)
    return flops_per_dof(n) / ((r + w) * float(itemsize))


def fused_v2_cg_iter_bytes(ndof: int, itemsize: int = 8) -> tuple[int, int]:
    """(read_bytes, write_bytes) of the v2 two-kernel iteration: 9 D reads,
    4 D writes (vs Eq. 2's 24 + 6)."""
    return (FUSED_V2_READ_STREAMS * ndof * itemsize,
            FUSED_V2_WRITE_STREAMS * ndof * itemsize)


def ir_overhead_streams(inner_iters: int, hi_itemsize: int = 8,
                        itemsize: int = 2) -> float:
    """Storage-stream equivalents the refinement outer loop adds per inner
    iteration.

    Each sweep runs one high-precision pass — the operator refresh
    (7R + 1W), the residual/solution axpys (4R + 2W) — ~14 ``hi_itemsize``
    words/DOF, amortized over ``inner_iters`` low-precision iterations and
    expressed in units of one storage-dtype stream.  At the defaults
    (bf16 inner, f64 outer, 12 inner iters) that is ~4.7 extra bf16
    streams on the v2 budget's 13: ~35 bytes/DOF/iter against unrefined
    f32 v2's 52 — the refined pipeline still moves ~1.5x fewer bytes."""
    return 14.0 * float(hi_itemsize) / (float(itemsize) * float(inner_iters))


def ax_local_flops(nelt: int, n: int) -> int:
    """Exact flops of the local tensor-product operator (both stages):
    3 forward contractions (2n each), the metric (15), 3 transposed
    contractions (2n each) summed into w (2) => 12n + 17 per point."""
    return nelt * n ** 3 * (12 * n + 17)


def ax_local_bytes(nelt: int, n: int, itemsize: int = 8) -> tuple[int, int]:
    """Minimal device-memory traffic of the fused local operator.

    Reads: u (1 field) + G (6 fields) (+ D, negligible); writes: w (1 field).
    """
    ndof = nelt * n ** 3
    return 7 * ndof * itemsize, 1 * ndof * itemsize


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Cost model instance for a given case size."""

    nelt: int
    n: int
    itemsize: int = 8

    @property
    def ndof(self) -> int:
        return self.nelt * self.n ** 3

    @property
    def cg_flops(self) -> int:
        return cg_iter_flops(self.ndof, self.n)

    @property
    def cg_read_bytes(self) -> int:
        return cg_iter_bytes(self.ndof, self.itemsize)[0]

    @property
    def cg_write_bytes(self) -> int:
        return cg_iter_bytes(self.ndof, self.itemsize)[1]

    @property
    def intensity(self) -> float:
        return intensity(self.n, self.itemsize)


def cheb_apply_flops(n: int, k: int = CHEB_DEFAULT_K) -> tuple[int, int]:
    """Flops per point of the Chebyshev apply z = q_k(A) r (K11), as
    ``(contraction, other)``.

    k diagonal-metric operator applications, each 12n contraction flops
    (3 forward and 3 transposed n-long dot products) plus 4 (3 metric
    products, 1 add), then per application the mask (1), the residual
    update (1), the recurrence ``d = c0 d + c1 res`` (3) and ``z += d``
    (1): ``k (12n + 10)`` in all, ``12 n k`` of it in contractions.  The
    assembly's face sums are left out, so this is a lower bound."""
    return 12 * n * k, 10 * k


# ---------------------------------------------------------------------------
# p-multigrid (core/pmg.py, the pmg branch of core/precond.py): a degree
# ladder n -> ceil(n/2) -> ... -> 2, each fine level smoothed twice (pre +
# post) by the Chebyshev(k) apply, a fixed-iteration CG base solve at n=2.
# The books count per V-cycle, scaled per level by the DOF fraction
# phi_l = (n_l / n)^3: a level-l field is phi_l of one fine-grid stream.
# The defaults are the reference's, tuned on the paper case (E=1024, n=10,
# rtol 1e-8): k=3 at ratio 24 with 12 base iterations.
# ---------------------------------------------------------------------------
PMG_DEFAULT_K = 3
PMG_COARSE_ITERS = 12
PMG_SMOOTH_RATIO = 24.0

# Stream table of one symmetric V-cycle per smoothed level, in units of one
# *level-l* field (multiply by phi_l):
#   pre-smooth (cheb kernel)      4R 1W   | prolong-add z+=m*e  3R 1W
#   A z #1     (v2 slab kernel)   5R 2W   | A z #2 (slab)       5R 2W
#   res1 = r - w                  2R 1W   | res2 = r - w        2R 1W
#   c-weight   t = c * res        2R 1W   | post-smooth (cheb)  4R 1W
#   restrict interp (fine side)   1R  -   | z += dz             2R 1W
_PMG_LEVEL_READS = 30.0
_PMG_LEVEL_WRITES = 12.0
# ... and per coarse transition, in units of one *level-(l+1)* field: the
# restrict interp's output write, the gather-scatter + mask pass (2R 1W)
# and the prolong interp's input read.
_PMG_COARSE_SIDE_READS = 3.0
_PMG_COARSE_SIDE_WRITES = 2.0


def pmg_degrees(n: int) -> tuple[int, ...]:
    """The p-coarsening ladder ``n -> ceil(n/2) -> ... -> 2`` (degree
    halving; GLL count n = degree + 1, so n=2 is the trilinear base)."""
    if n < 2:
        raise ValueError(f"need n >= 2 GLL points, got {n}")
    ns = [int(n)]
    while ns[-1] > 2:
        ns.append((ns[-1] + 1) // 2)
    return tuple(ns)


def pmg_dof_fracs(n: int) -> tuple[float, ...]:
    """Per-level DOF fractions ``phi_l = (n_l / n)^3`` of the ladder."""
    return tuple((nl / float(n)) ** 3 for nl in pmg_degrees(n))


def pmg_vcycle_streams(n: int = 10,
                       coarse_iters: int = PMG_COARSE_ITERS
                       ) -> tuple[float, float]:
    """(reads, writes) full-*fine*-field streams of ONE symmetric V-cycle:
    the level table over the smoothed levels, the transition table over the
    level boundaries, and ``coarse_iters`` Eq.-2 CG iterations (24R + 6W)
    at the base fraction."""
    fr = pmg_dof_fracs(n)
    reads = sum(_PMG_LEVEL_READS * f for f in fr[:-1])
    reads += sum(_PMG_COARSE_SIDE_READS * f for f in fr[1:])
    reads += CG_READ_STREAMS * coarse_iters * fr[-1]
    writes = sum(_PMG_LEVEL_WRITES * f for f in fr[:-1])
    writes += sum(_PMG_COARSE_SIDE_WRITES * f for f in fr[1:])
    writes += CG_WRITE_STREAMS * coarse_iters * fr[-1]
    return reads, writes


def pmg_streams(n: int = 10, coarse_iters: int = PMG_COARSE_ITERS
                ) -> tuple[float, float]:
    """(reads, writes) streams per DOF per PCG iteration of pmg: the v2
    iteration (9 + 4) plus one V-cycle."""
    vr, vw = pmg_vcycle_streams(n, coarse_iters)
    return FUSED_V2_READ_STREAMS + vr, FUSED_V2_WRITE_STREAMS + vw


def pmg_flops_per_dof(n: int, k: int = PMG_DEFAULT_K,
                      coarse_iters: int = PMG_COARSE_ITERS) -> float:
    """Eq.-1 flops/DOF/iteration of pmg-PCG: the v2 iteration plus, per
    smoothed level at its DOF fraction, two Chebyshev applies (k operator
    applications + recurrence axpys each), two explicit operator
    applications, the transfer contractions (3 directions x 2 n_c flops per
    fine point, both directions) and ~8 glue axpys; plus the base-level CG
    iterations."""
    ns = pmg_degrees(n)
    fr = pmg_dof_fracs(n)
    total = float(flops_per_dof(n))
    for lev, (nl, f) in enumerate(zip(ns[:-1], fr[:-1])):
        level = 2.0 * k * (12 * nl + 17 + 6)      # pre+post smoother
        level += 2.0 * (12 * nl + 17)             # the two A z residuals
        level += 2.0 * 3.0 * 2.0 * ns[lev + 1]    # interp down + up
        level += 8.0                              # residual/correction glue
        total += f * level
    total += fr[-1] * coarse_iters * flops_per_dof(ns[-1])
    return total


# ---------------------------------------------------------------------------
# multi-RHS (block) books (core/cg_block.py): the operator streams are
# shared by the b right-hand sides, the vector streams are per RHS.
# ---------------------------------------------------------------------------

# The 3 metric diagonals (rr, ss, tt): read once per element for all b.  D
# and the per-axis factors are shared too, but sub-stream.
MULTI_RHS_SHARED_STREAMS = 3.0


# The ladder's rung family: *_rhs{b} entries are pinned at these batches.
MULTI_RHS_BATCHES = (2, 4, 8)


def multi_rhs_streams(b: int, pipeline: str = "fused_v2", *,
                      s: int = SSTEP_DEFAULT_S) -> tuple[float, float]:
    """(reads, writes) full-field streams per DOF per iteration *per RHS*
    of a b-way block solve.

    ``fused_v2``: of the 9 read streams, 3 are the shared metric diagonals
    and 6 are per-RHS vectors; all 4 write streams are per RHS:
    ``reads = 6 + 3/b``, ``writes = 4``.

    ``sstep_v3``: the same 3 shared streams sit inside the per-cycle
    budget (2s+7 reads, 2s+2 writes over s iterations), so composing the
    s-step cycle with a b-way block divides them by s*b:
    ``reads = (2s+4)/s + 3/(s*b)``, ``writes = (2s+2)/s``.  Neither package
    has a batched s-step kernel (``route_name`` sends b > 1 s-step
    requests to ``block``); the branch prices the composition.
    """
    b = float(b)
    if b < 1:
        raise ValueError(f"RHS batch must be >= 1, got {b}")
    if pipeline == "fused_v2":
        reads = (FUSED_V2_READ_STREAMS - MULTI_RHS_SHARED_STREAMS
                 + MULTI_RHS_SHARED_STREAMS / b)
        return reads, float(FUSED_V2_WRITE_STREAMS)
    if pipeline == "sstep_v3":
        cr, cw = sstep_cycle_streams(s)
        reads = ((cr - MULTI_RHS_SHARED_STREAMS) / float(s)
                 + MULTI_RHS_SHARED_STREAMS / (float(s) * b))
        return reads, cw / float(s)
    raise ValueError(f"no multi-RHS books for pipeline {pipeline!r}")


def streams_per_rhs(b: int, pipeline: str = "fused_v2", *,
                    s: int = SSTEP_DEFAULT_S) -> float:
    """Total (reads + writes) streams per DOF per iteration per RHS,
    strictly decreasing in b."""
    r, w = multi_rhs_streams(b, pipeline, s=s)
    return r + w


def multi_rhs_halo_streams(b: int, s: int, sz: int) -> float:
    """Per-RHS matrix-powers halo of a b-way block s-step solve in the
    reference's books: of the 5 halo'd fields (:func:`sstep_halo_streams`)
    p and r are per RHS, the 3 metric diagonals are read once for the
    batch: ``(4 + 6/b)/sz`` per iteration per RHS."""
    return 2.0 * float(s) * (2.0 + 3.0 / float(b)) / (float(sz) * float(s))


def _multi_rhs_rung(pipeline: str) -> tuple[str, int] | None:
    """Split a ``<base>_rhs<b>`` ladder rung into (base, b); None if the
    name is not a multi-RHS rung."""
    base, sep, tail = pipeline.rpartition("_rhs")
    if not sep or not tail.isdigit():
        return None
    return base, int(tail)


# ---------------------------------------------------------------------------
# side channels and per-device collectives of the reference's books.  They
# price the reference's halo'd slab residencies and its sharded pipelines;
# the port's kernels have no halos (K8 and K11 are one cooperative launch
# each; a shard runs them on its ghost-extended grid, distributed/halo.py).
# The collective books are the bytes a shard with two neighbours sends and
# receives (distributed/sharding.COLLECTIVE_BYTES): its ppermutes per
# iteration, in streams of the shard's E_local n^3 values.  They carry over
# as books: bytes and flops, not time.
# ---------------------------------------------------------------------------

def fused_v2_intensity(n: int, itemsize: int = 8) -> float:
    """Eq. 2 re-evaluated for the v2 pipeline: same flops over 13 streams."""
    return flops_per_dof(n) / (
        (FUSED_V2_READ_STREAMS + FUSED_V2_WRITE_STREAMS) * float(itemsize))


def fused_v2_plane_streams(n: int, sz: int) -> float:
    """Stream-equivalents of the reference's v2 boundary-plane side
    channel: per block of ``sz`` slabs two ``EX*EY*n^2``-word planes written
    and read back, ``4 / (n * sz)`` of one full stream."""
    return 4.0 / (float(n) * float(sz))


def sstep_collective_streams(s: int, ez_local: int) -> float:
    """Per-device stream-equivalents of the sharded s-step halo exchange,
    per iteration: 2 fields x s slabs x 2 directions, each sent and
    received, per cycle of s iterations: ``8/ez_local``."""
    return 2.0 * 2.0 * 2.0 * float(s) / (float(ez_local) * float(s))


def cheb_collective_streams(k: int, ez_local: int) -> float:
    """Per-device stream-equivalents of the sharded Chebyshev apply's
    k-deep residual ghost exchange, per iteration: ``4k/ez_local``."""
    return 2.0 * 2.0 * float(k) / float(ez_local)


def v2_plane_collective_streams(n: int, ez_local: int) -> float:
    """Per-device stream-equivalents of the sharded v2-family plane stitch:
    ``4 / (n * ez_local)``."""
    return 2.0 * 2.0 / (float(n) * float(ez_local))


def _local_ez(ndev: int, ez: int | None) -> int:
    if ndev == 1:
        return 0                      # unused: collective terms are zero
    if ez is None:
        raise ValueError("ndev > 1 needs the global EZ (ez=) to size the "
                         "per-device halo")
    if ez % ndev:
        raise ValueError(f"EZ {ez} not divisible by ndev {ndev}")
    return ez // ndev


def sstep_effective_streams(s: int, sz: int, ndev: int = 1,
                            ez: int | None = None) -> float:
    """Headline + halo side channel (+ the per-device collective channel
    when ``ndev > 1``, which needs the global ``ez``): total effective
    streams per iteration of the s-step pipeline."""
    r, w = sstep_streams(s)
    total = r + w + sstep_halo_streams(s, sz)
    ez_l = _local_ez(ndev, ez)
    if ndev > 1:
        total += sstep_collective_streams(s, ez_l)
    return total


def cheb_halo_streams(k: int, sz: int) -> float:
    """Stream-equivalents of the reference's Chebyshev-kernel halo: 4
    halo'd fields over ``2k`` ghost slabs per ``sz``-slab block, every
    iteration: ``8k/sz``.  The port's K11 has no halo; it is priced by
    :func:`cheb_apply_flops` and its source note."""
    return 2.0 * 4.0 * float(k) / float(sz)


def cheb_effective_streams(k: int, sz: int, ndev: int = 1,
                           ez: int | None = None, n: int = 10) -> float:
    """Headline + halo: total effective streams per iteration of
    Chebyshev-PCG; ``ndev > 1`` adds the residual ghosts and the v2 plane
    stitch at ``ez_local = ez/ndev``."""
    total = (CHEB_V2_READ_STREAMS + CHEB_V2_WRITE_STREAMS
             + cheb_halo_streams(k, sz))
    ez_l = _local_ez(ndev, ez)
    if ndev > 1:
        total += cheb_collective_streams(k, ez_l)
        total += v2_plane_collective_streams(n, ez_l)
    return total


def cheb_flops_per_dof(n: int, k: int = CHEB_DEFAULT_K) -> int:
    """Eq.-1 flops per DOF per iteration of Chebyshev-PCG in the
    reference's books: the CG iteration plus k operator applications
    (12n + 17 each) and 6 recurrence flops per application."""
    return flops_per_dof(n) + k * (12 * n + 17 + 6)


def pmg_halo_streams(n: int, k: int = PMG_DEFAULT_K,
                     sz: int = 4) -> tuple[float, float]:
    """(reads, writes) side-channel stream-equivalents of one V-cycle in
    the reference's books: per smoothed level two Chebyshev-apply halos and
    two v2 plane stitches (split evenly), each at the level's DOF
    fraction, one representative ``sz`` at every level."""
    fr = pmg_dof_fracs(n)
    ns = pmg_degrees(n)
    reads = writes = 0.0
    for nl, f in zip(ns[:-1], fr[:-1]):
        reads += 2.0 * cheb_halo_streams(k, sz) * f
        half = 2.0 * fused_v2_plane_streams(nl, sz) / 2.0
        reads += half * f
        writes += half * f
    return reads, writes


def pmg_effective_streams(n: int = 10, k: int = PMG_DEFAULT_K,
                          sz: int = 4,
                          coarse_iters: int = PMG_COARSE_ITERS) -> float:
    """Headline + halo/plane side channels: total effective streams per
    PCG iteration of pmg (single device)."""
    r, w = pmg_streams(n, coarse_iters)
    hr, hw = pmg_halo_streams(n, k, sz)
    return r + w + hr + hw


# ---------------------------------------------------------------------------
# dtype-aware accounting: the stream counts are fixed per pipeline rung; the
# precision policy sets the bytes each stream carries.
# ---------------------------------------------------------------------------

# (reads, writes) full-field streams per DOF per CG iteration, per rung.
# The s-step rung carries the default s=4 point, the pmg rung n=10.
PIPELINE_STREAMS = {
    "eq2": (CG_READ_STREAMS, CG_WRITE_STREAMS),
    "fused_v1": (FUSED_CG_READ_STREAMS, FUSED_CG_WRITE_STREAMS),
    "fused_v2": (FUSED_V2_READ_STREAMS, FUSED_V2_WRITE_STREAMS),
    "sstep_v3": sstep_streams(SSTEP_DEFAULT_S),
    "fused_v2_jacobi": (JACOBI_V2_READ_STREAMS, JACOBI_V2_WRITE_STREAMS),
    "fused_v2_cheb": (CHEB_V2_READ_STREAMS, CHEB_V2_WRITE_STREAMS),
    "fused_v2_pmg": pmg_streams(10, PMG_COARSE_ITERS),
}
# the multi-RHS rungs, per RHS, standalone (batched v2) and composed with
# the s-step cycle
PIPELINE_STREAMS.update({
    f"{base}_rhs{nb}": multi_rhs_streams(nb, base)
    for base in ("fused_v2", "sstep_v3") for nb in MULTI_RHS_BATCHES
})


def bytes_per_dof_iter(pipeline: str, precision, *, exact: bool = False,
                       n: int = 10, sz: int = 4,
                       s: int = SSTEP_DEFAULT_S,
                       k: int = CHEB_DEFAULT_K, ndev: int = 1,
                       ez: int | None = None) -> tuple[float, float]:
    """(read_bytes, write_bytes) per DOF per CG iteration for a pipeline
    rung under a precision policy.

    ``exact=True`` folds in the reference's sub-stream side channels: the
    v2 boundary planes (:func:`fused_v2_plane_streams`, split evenly into
    reads and writes; the Jacobi and Chebyshev rungs inherit them), the
    s-step halo (:func:`sstep_halo_streams`, reads) and the Chebyshev halo
    (:func:`cheb_halo_streams`, reads); eq2 and fused_v1 have none.
    ``ndev > 1`` (needs ``ez`` and ``exact=True``) adds the per-device
    collective channels of the sharded pipelines, split evenly; pipelines
    without a sharded variant reject it.
    """
    reads, writes = PIPELINE_STREAMS[pipeline]
    if pipeline == "sstep_v3" and s != SSTEP_DEFAULT_S:
        reads, writes = sstep_streams(s)
    if pipeline == "fused_v2_pmg" and n != 10:
        reads, writes = pmg_streams(n)
    rhs_rung = _multi_rhs_rung(pipeline)
    if rhs_rung is not None and rhs_rung[0] == "sstep_v3" \
            and s != SSTEP_DEFAULT_S:
        reads, writes = multi_rhs_streams(rhs_rung[1], "sstep_v3", s=s)
    if ndev > 1 and pipeline not in ("sstep_v3", "fused_v2",
                                     "fused_v2_jacobi", "fused_v2_cheb"):
        raise ValueError(f"pipeline {pipeline!r} has no sharded variant; "
                         "ndev > 1 is not meaningful for it")
    if ndev > 1 and not exact:
        raise ValueError("ndev > 1 only affects the exact accounting; "
                         "pass exact=True")
    if exact:
        ez_l = _local_ez(ndev, ez)
        if pipeline in ("fused_v2", "fused_v2_jacobi", "fused_v2_cheb"):
            half = fused_v2_plane_streams(n, sz) / 2.0
            reads, writes = reads + half, writes + half
            if pipeline == "fused_v2_cheb":
                reads = reads + cheb_halo_streams(k, sz)
            if ndev > 1:
                half_c = v2_plane_collective_streams(n, ez_l) / 2.0
                reads, writes = reads + half_c, writes + half_c
                if pipeline == "fused_v2_cheb":
                    half_k = cheb_collective_streams(k, ez_l) / 2.0
                    reads, writes = reads + half_k, writes + half_k
        elif pipeline == "fused_v2_pmg":
            half = fused_v2_plane_streams(n, sz) / 2.0
            hr, hw = pmg_halo_streams(n, PMG_DEFAULT_K, sz)
            reads, writes = reads + half + hr, writes + half + hw
        elif pipeline == "sstep_v3":
            reads = reads + sstep_halo_streams(s, sz)
            if ndev > 1:
                half_s = sstep_collective_streams(s, ez_l) / 2.0
                reads, writes = reads + half_s, writes + half_s
        elif rhs_rung is not None:
            base, nb = rhs_rung
            if base == "fused_v2":
                # every RHS's planes travel: the b=1 charge per RHS
                half = fused_v2_plane_streams(n, sz) / 2.0
                reads, writes = reads + half, writes + half
            else:  # sstep_v3_rhs{b}: metric halo shared across the batch
                reads = reads + multi_rhs_halo_streams(nb, s, sz)
    itemsize = precision_itemsize(precision)
    return reads * itemsize, writes * itemsize


def pipeline_flops_per_dof(n: int, pipeline: str, *,
                           s: int = SSTEP_DEFAULT_S,
                           k: int = CHEB_DEFAULT_K) -> float:
    """Eq.-1 flops per DOF per CG iteration of a pipeline rung: the fusion
    ladder and the block rungs keep (12n + 34); Jacobi adds 3; Chebyshev
    adds k operator applications (:func:`cheb_flops_per_dof`); pmg its
    V-cycle (:func:`pmg_flops_per_dof`)."""
    if pipeline in ("eq2", "fused_v1", "fused_v2", "sstep_v3"):
        return float(flops_per_dof(n))
    if _multi_rhs_rung(pipeline) is not None:
        return float(flops_per_dof(n))
    if pipeline == "fused_v2_jacobi":
        return float(flops_per_dof(n) + 3)
    if pipeline == "fused_v2_cheb":
        return float(cheb_flops_per_dof(n, k))
    if pipeline == "fused_v2_pmg":
        return pmg_flops_per_dof(n)
    raise ValueError(f"unknown pipeline {pipeline!r}")


def pipeline_intensity(n: int, pipeline: str, precision) -> float:
    """Eq. 2 arithmetic intensity of a (pipeline, precision) point."""
    return pipeline_flops_per_dof(n, pipeline) / float(
        sum(bytes_per_dof_iter(pipeline, precision)))


def roofline_gflops(bandwidth_gbs: float, n: int, itemsize: int = 8) -> float:
    """Memory-roofline performance bound: BW * I(n) (paper §VI-B)."""
    return bandwidth_gbs * intensity(n, itemsize)
