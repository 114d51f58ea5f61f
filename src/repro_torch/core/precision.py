"""Precision policies for the fused CG pipeline, mapped to torch dtypes.

A policy splits the field dtype into two choices:

* **storage** — the dtype ``x``/``r``/``p``/``w`` and the diagonal metric
  occupy in device memory.  Every stream of the byte books is billed in it.
* **accum** — the dtype the kernels accumulate the tensor contractions,
  the direct-stiffness sums and the ``p·c·Ap`` / ``r·c·r`` partials in.

Named policies::

    f64      f64 storage, f64 accum          (the paper's precision)
    f32      f32 storage, f32 accum
    bf16     bf16 storage, f32 accum
    f32_ir   f32 storage, f32 accum, refined
    bf16_ir  bf16 vectors, f32 accum + x + metric, refined

What runs on the card: every kernel, K1 to K12, in ``f64``, ``f32`` and
two bf16 builds, ``bf16`` (every operand bf16) and ``bf16_ir`` (bf16
vectors; x and the operator's data in f32), both accumulating in f32:
K1 (reference CG), K4, K5 (v2), K3 (v1), K8, K9 (s-step), K10
(Jacobi-PCG), K11 (Chebyshev-PCG), K11 with K12 (pmg-PCG) and K6, K7
(block CG); K2 has no route, as in the reference.  The refined policies
run the ``ir`` route (``cg_fused.cg_ir_fixed_iters``) over v2, v1 and
s-step; with a preconditioner or b > 1 a refined case routes elsewhere,
as the reference's does, so ``bf16_ir`` reaches K6, K7, K11 and K12
through the drivers (``precond.pcg_fused_v2_fixed_iters``,
``cg_block.cg_block_fixed_iters``).  On the CPU every policy runs the
plain versions.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["PrecisionPolicy", "POLICIES", "resolve_policy",
           "policy_from_dtype"]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """One (storage, accum, refine) point of the precision space.

    Attributes:
      name:    registry key (``POLICIES``).
      storage: dtype name fields live in, in device memory.
      accum:   dtype in-kernel contractions and reduction partials use.
      refine:  wrap the solve in the iterative-refinement outer loop.
      x_storage: optional override for the solution vector's storage dtype.
      op_storage: optional override for the dtype of the operator's
               defining data (the diagonal metric and ``D``).
    """

    name: str
    storage: str
    accum: str
    refine: bool = False
    x_storage: str | None = None
    op_storage: str | None = None

    @property
    def storage_dtype(self) -> torch.dtype:
        return _dtype(self.storage)

    @property
    def accum_dtype(self) -> torch.dtype:
        return _dtype(self.accum)

    @property
    def x_storage_dtype(self) -> torch.dtype:
        return _dtype(self.x_storage or self.storage)

    @property
    def op_storage_dtype(self) -> torch.dtype:
        return _dtype(self.op_storage or self.storage)

    @property
    def itemsize(self) -> int:
        """Bytes per stored word — the byte books' multiplier."""
        return self.storage_dtype.itemsize

    @property
    def gram(self) -> str:
        """Dtype of the s-step Gram/recurrence solve — always float64.

        The (2s+1)^2 Gram block conditions like ``kappa(A)^{2s}`` (DESIGN.md
        §8), so the coefficient recurrence is solved on the host in f64
        whatever the storage and accumulation dtypes: O(s^2) scalar work
        per cycle, never a stream.
        """
        return "float64"


POLICIES: dict[str, PrecisionPolicy] = {
    "f64": PrecisionPolicy("f64", "float64", "float64"),
    "f32": PrecisionPolicy("f32", "float32", "float32"),
    "bf16": PrecisionPolicy("bf16", "bfloat16", "float32"),
    "f32_ir": PrecisionPolicy("f32_ir", "float32", "float32", refine=True),
    "bf16_ir": PrecisionPolicy("bf16_ir", "bfloat16", "float32",
                               refine=True, x_storage="float32",
                               op_storage="float32"),
}


def policy_from_dtype(dtype: torch.dtype) -> PrecisionPolicy:
    """The non-refined policy matching a bare operand dtype: f64
    accumulates in f64, everything narrower in f32."""
    if dtype == torch.float64:
        return POLICIES["f64"]
    if dtype == torch.bfloat16:
        return POLICIES["bf16"]
    if dtype == torch.float32:
        return POLICIES["f32"]
    name = str(dtype).removeprefix("torch.")
    return PrecisionPolicy(name, name, "float32")


def resolve_policy(precision, dtype: torch.dtype | None = None
                   ) -> PrecisionPolicy:
    """Normalize a ``precision=`` argument to a :class:`PrecisionPolicy`.

    Args:
      precision: a policy name (``POLICIES`` key), a policy instance, or
                 ``None`` to infer from ``dtype``.
      dtype:     operand dtype used when ``precision`` is ``None``.
    """
    if precision is None:
        if dtype is None:
            raise ValueError("precision=None needs an operand dtype")
        return policy_from_dtype(dtype)
    if isinstance(precision, PrecisionPolicy):
        return precision
    try:
        return POLICIES[str(precision)]
    except KeyError:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of "
            f"{sorted(POLICIES)} or a PrecisionPolicy") from None
