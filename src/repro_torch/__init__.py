"""repro_torch: the Nekbone tensor-product solver in PyTorch and CUDA.

A port of the JAX package ``repro`` to PyTorch on an NVIDIA H100.  Plain
tensor code is PyTorch; the operator kernel and the two kernels of the v2
CG iteration are CUDA C++ (``kernels/csrc/``), built with ``nvcc`` at first
use.  The package imports neither ``jax`` nor ``repro``.

Top-level surface (lazy, like the reference's)::

    import repro_torch
    res = repro_torch.solve(1024, niter=100)     # paper case, on the card

Entry points run on the card unless given ``device="cpu"``.
"""
__version__ = "0.1.0"

_LAZY = {
    "solve": ("repro_torch.core.solvers", "solve"),
    "SolveResult": ("repro_torch.core.cg", "SolveResult"),
    "NekboneCase": ("repro_torch.core.nekbone", "NekboneCase"),
}


def __getattr__(name):
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(module), attr)


def __dir__():
    return sorted([*globals(), *_LAZY])
