"""Carry a case's operator data across from arrays.

The port's "weights" are the operator data of a Nekbone case: ``D``, the
metric ``g``, the ``mask``, the multiplicity ``mult``, the weight ``c`` and
the mass ``bmass``.  :func:`case_from_arrays` builds a port
:class:`~repro_torch.core.nekbone.NekboneCase` whose fields are exactly the
given arrays (for instance the reference package's case fields as numpy),
so both packages can be fed identical operator data — including a random
SPD metric (``geom.random_spd_metric``) in place of the box's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.nekbone import NekboneCase

__all__ = ["FIELDS", "case_from_arrays"]

FIELDS = ("D", "g", "mask", "mult", "c", "bmass")


def case_from_arrays(n: int, grid: tuple[int, int, int],
                     lengths: tuple[float, float, float],
                     arrays: dict[str, np.ndarray], *, dtype: torch.dtype,
                     device, ax_impl: str = "fused") -> NekboneCase:
    """A port case on ``grid`` whose fields are the given arrays.

    ``arrays`` maps names from :data:`FIELDS` to numpy arrays of the
    reference layout (``g``: (E, 6, n, n, n), the others (E, n, n, n) or
    (n, n) for ``D``); a field left out keeps the box's own value.
    """
    unknown = set(arrays) - set(FIELDS)
    if unknown:
        raise ValueError(f"unknown case fields {sorted(unknown)}; "
                         f"expected some of {FIELDS}")
    case = NekboneCase(n=n, grid=tuple(grid), lengths=tuple(lengths),
                       dtype=dtype, ax_impl=ax_impl, device=device)
    for name, a in arrays.items():
        want = tuple(getattr(case, name).shape)
        a = np.asarray(a)
        if a.shape != want:
            raise ValueError(f"{name} has shape {a.shape}, expected {want}")
        setattr(case, name, torch.tensor(a, dtype=dtype, device=case.device))
    return case
