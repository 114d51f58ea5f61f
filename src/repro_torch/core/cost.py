"""The paper's cost model (Eq. 1-2) and the byte books of the ported paths.

Paper §III-A:  per CG iteration over ``D`` degrees of freedom with ``n`` GLL
points per direction,

    C(D, n) = D * (12 n + 34)                 flops            (Eq. 1)
    reads   = 24 D,   writes = 6 D            fp64 words
    I(n)    = (12 n + 34) / 240               flop/byte (fp64) (Eq. 2)

Pure arithmetic, hardware-independent: a copy of the part of the
reference's ``core/cost.py`` that the ported paths and ``chip_smoke.py``
use to turn times into bytes per second.  The s-step, Chebyshev, pmg and
multi-RHS books are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

__all__ = ["flops_per_dof", "cg_iter_flops", "cg_iter_bytes", "intensity",
           "ax_local_flops", "ax_local_bytes", "CostModel",
           "CG_READ_STREAMS", "CG_WRITE_STREAMS", "FUSED_V2_READ_STREAMS",
           "FUSED_V2_WRITE_STREAMS", "fused_v2_cg_iter_bytes",
           "PRECISION_ITEMSIZE", "precision_itemsize"]

# Eq. 2's stream counts: words moved per DOF per CG iteration when the
# operator, mask, and every inner product run as separate passes.
CG_READ_STREAMS = 24
CG_WRITE_STREAMS = 6

# The v2 pipeline (core/cg_fused.py) runs the whole iteration in two
# kernels:
#   K4 (front half): reads p, r, 3 metric diagonals    (5)    writes p, w (2)
#   K5 (back half):  reads x, p, r, w                  (4)    writes x, r (2)
# The mask and the weight c are rebuilt from per-axis factors, and the
# axis-aligned box metric is diagonal.  K5's reads of the neighbours' face
# copies of w are not counted as a stream.
FUSED_V2_READ_STREAMS = 9
FUSED_V2_WRITE_STREAMS = 4

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


def fused_v2_cg_iter_bytes(ndof: int, itemsize: int = 8) -> tuple[int, int]:
    """(read_bytes, write_bytes) of the v2 two-kernel iteration: 9 D reads,
    4 D writes (vs Eq. 2's 24 + 6)."""
    return (FUSED_V2_READ_STREAMS * ndof * itemsize,
            FUSED_V2_WRITE_STREAMS * ndof * itemsize)


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
