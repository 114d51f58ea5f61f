"""Nekbone case configurations (the paper's own experiment grid).

Paper §V: polynomial degree 9 (n = 10 GLL points), 64 - 4096 elements per
GPU, 100 CG iterations.  Element grids are chosen to keep the box roughly
cubic, matching Nekbone's ``data.rea`` defaults.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["NekboneConfig", "PAPER_CASES", "paper_case"]


@dataclasses.dataclass(frozen=True)
class NekboneConfig:
    name: str
    n: int                               # GLL points per direction (= p + 1)
    grid: tuple[int, int, int]           # element grid (per device)
    niter: int = 100                     # paper: 100 CG iterations
    dtype: str = "float32"               # the reference's default
    # see NekboneCase.ax_impl for the value list; "pallas" is the paper's
    # operator kernel (K1) inside the reference CG loop.
    ax_impl: str = "pallas"
    # precision policy (core/precision.py) or None to leave the solver
    # dtype to ``dtype``.
    precision: str | None = None

    @property
    def nelt(self) -> int:
        ex, ey, ez = self.grid
        return ex * ey * ez

    @property
    def ndof(self) -> int:
        return self.nelt * self.n ** 3

    def make_case(self, **overrides):
        """Instantiate the runnable :class:`repro_torch.core.nekbone.NekboneCase`
        for this configuration (keyword overrides win; ``device=None`` is
        the card)."""
        from repro_torch.core.nekbone import NekboneCase

        kwargs = dict(n=self.n, grid=self.grid,
                      dtype=getattr(torch, self.dtype), ax_impl=self.ax_impl,
                      precision=self.precision)
        kwargs.update(overrides)
        return NekboneCase(**kwargs)


def _case(nelt: int, grid) -> NekboneConfig:
    return NekboneConfig(name=f"nekbone-e{nelt}", n=10, grid=grid)


# Element counts from the paper's sweep (Fig. 2/3), degree 9.
PAPER_CASES = {
    64: _case(64, (4, 4, 4)),
    128: _case(128, (4, 4, 8)),
    256: _case(256, (4, 8, 8)),
    512: _case(512, (8, 8, 8)),
    1024: _case(1024, (8, 8, 16)),
    2048: _case(2048, (8, 16, 16)),
    3584: _case(3584, (16, 16, 14)),     # Kebnekaise point (448*8)
    4096: _case(4096, (16, 16, 16)),
}


def paper_case(nelt: int = 1024, precision: str | None = None
               ) -> NekboneConfig:
    """A paper-grid case, optionally re-priced under a precision policy.
    (The reference's ``precond=`` argument waits for the preconditioners,
    ROADMAP.md queue 1 item 8.)"""
    cfg = PAPER_CASES[nelt]
    if precision != cfg.precision:
        cfg = dataclasses.replace(cfg, precision=precision)
    return cfg
