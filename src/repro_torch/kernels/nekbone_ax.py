"""Wrappers of the three CUDA kernels of the Nekbone operator and v2 CG.

* ``nekbone_ax_cuda`` — K1, ``csrc/nekbone_ax.cu``, replaces the reference's
  ``kernels/nekbone_ax.py:nekbone_ax_kernel``;
* ``nekbone_ax_slab_cuda`` — K4, ``csrc/nekbone_ax_slab.cu``, replaces
  ``nekbone_ax_slab_kernel``;
* ``nekbone_cg_update_cuda`` — K5, ``csrc/nekbone_cg_update.cu``, replaces
  ``nekbone_cg_update_kernel``.

Every wrapper takes the kernel's flat operands ((E, n^3) fields), and:

* for tensors on the CPU, returns its plain PyTorch version
  (kernels/ref.py) — the tests' path;
* for CUDA tensors, checks device, dtype, shape and contiguity, allocates
  the outputs, launches the kernel on the current stream, raises if the
  launch returned an error, and adds one to its count in :data:`LAUNCHES`.
  There is no fallback: a CUDA tensor the kernel does not take (bf16, say)
  raises.

The kernels are built from the sources at first use (kernels/_build.py).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (nekbone_ax_plain, nekbone_ax_slab_plain,
                                     nekbone_cg_update_plain)

__all__ = ["LAUNCHES", "reset_launches", "nekbone_ax_cuda",
           "nekbone_ax_slab_cuda", "nekbone_cg_update_cuda",
           "nekbone_ax_plain", "nekbone_ax_slab_plain",
           "nekbone_cg_update_plain", "N_RANGE"]

# Kernel launches per wrapper since the last reset_launches(); plain ints.
LAUNCHES = {"nekbone_ax": 0, "nekbone_ax_slab": 0, "nekbone_cg_update": 0}

# The n the kernels are instantiated for (template parameter).
N_RANGE = range(2, 17)

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: pointers, then the ints, then the stream.
_ARGTYPES = {
    "nekbone_ax": [_P] * 4 + [_I] * 2 + [_P],
    "nekbone_ax_slab": [_P] * 11 + [_I] * 4 + [_P],
    "nekbone_cg_update": [_P] * 11 + [_I] * 4 + [_P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _function(stem: str, dtype: torch.dtype):
    fn = getattr(_build.load(stem), f"{stem}_{_SUFFIX[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[stem]
        fn.restype = ctypes.c_int
    return fn


def _check(stem: str, n: int, dtype: torch.dtype, device: torch.device,
           **tensors: tuple[torch.Tensor, tuple[int, ...]]) -> None:
    if device.type != "cuda":
        raise ValueError(f"{stem}: tensors must be on the CPU or a CUDA "
                         f"device, got {device}")
    if dtype not in _SUFFIX:
        raise NotImplementedError(
            f"{stem}: the CUDA kernel is built for float32 and float64, not "
            f"{dtype} (bf16 variants: ROADMAP.md queue 2)")
    if n not in N_RANGE:
        raise ValueError(f"{stem}: n={n} outside the built range 2..16")
    for name, (t, shape) in tensors.items():
        if t.device != device:
            raise ValueError(f"{stem}: {name} is on {t.device}, not {device}")
        if t.dtype != dtype:
            raise TypeError(f"{stem}: {name} is {t.dtype}, not {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{stem}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{stem}: {name} must be contiguous")


def _launch(stem: str, dtype: torch.dtype, device: torch.device,
            tensors, ints) -> None:
    fn = _function(stem, dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), *ints, stream)
    if err != 0:
        raise RuntimeError(f"{stem}: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[stem] += 1


def nekbone_ax_cuda(u2: torch.Tensor, D: torch.Tensor, g2: torch.Tensor, *,
                    n: int) -> torch.Tensor:
    """K1: ``w = D^T G D u``.  u2: (E, n^3); D: (n, n); g2: (E, 6, n^3)."""
    if u2.device.type == "cpu":
        return nekbone_ax_plain(u2, D, g2, n=n)
    E = u2.shape[0]
    n3 = n ** 3
    _check("nekbone_ax", n, u2.dtype, u2.device, u2=(u2, (E, n3)),
           D=(D, (n, n)), g2=(g2, (E, 6, n3)))
    w2 = torch.empty_like(u2)
    _launch("nekbone_ax", u2.dtype, u2.device, (u2, D, g2, w2), (E, n))
    return w2


def nekbone_ax_slab_cuda(p2, r2, D, g3, mx, my, mz, beta, *, n: int):
    """K4: ``p = r + beta p2``, masked diagonal-metric Ax, pap partials.

    Operands as :func:`repro_torch.kernels.ref.nekbone_ax_slab_plain`; the
    element grid is ``(len(mx), len(my), len(mz))``.  Returns
    ``(p, w, pap)`` with ``w`` unassembled and ``pap`` of shape (E,).
    """
    if p2.device.type == "cpu":
        return nekbone_ax_slab_plain(p2, r2, D, g3, mx, my, mz, beta, n=n)
    ex, ey, ez = mx.shape[0], my.shape[0], mz.shape[0]
    E = ex * ey * ez
    n3 = n ** 3
    _check("nekbone_ax_slab", n, p2.dtype, p2.device, p2=(p2, (E, n3)),
           r2=(r2, (E, n3)), D=(D, (n, n)), g3=(g3, (E, 3, n3)),
           mx=(mx, (ex, n)), my=(my, (ey, n)), mz=(mz, (ez, n)),
           beta=(beta.reshape(1), (1,)))
    p_out = torch.empty_like(p2)
    w2 = torch.empty_like(p2)
    pap = torch.empty(E, dtype=p2.dtype, device=p2.device)
    _launch("nekbone_ax_slab", p2.dtype, p2.device,
            (p2, r2, D, g3, mx, my, mz, beta, p_out, w2, pap), (ex, ey, ez, n))
    return p_out, w2, pap


def nekbone_cg_update_cuda(x2, p2, r2, w2, alpha, cx, cy, cz, *, n: int):
    """K5: assemble ``w``, ``x += alpha p``, ``r -= alpha w``, rcr partials.

    Operands as :func:`repro_torch.kernels.ref.nekbone_cg_update_plain`;
    ``w2`` is K4's unassembled output.  Returns ``(x, r, rcr)`` with
    ``rcr`` of shape (E,).
    """
    if x2.device.type == "cpu":
        return nekbone_cg_update_plain(x2, p2, r2, w2, alpha, cx, cy, cz, n=n)
    ex, ey, ez = cx.shape[0], cy.shape[0], cz.shape[0]
    E = ex * ey * ez
    n3 = n ** 3
    _check("nekbone_cg_update", n, x2.dtype, x2.device, x2=(x2, (E, n3)),
           p2=(p2, (E, n3)), r2=(r2, (E, n3)), w2=(w2, (E, n3)),
           alpha=(alpha.reshape(1), (1,)), cx=(cx, (ex, n)),
           cy=(cy, (ey, n)), cz=(cz, (ez, n)))
    x_out = torch.empty_like(x2)
    r_out = torch.empty_like(r2)
    rcr = torch.empty(E, dtype=x2.dtype, device=x2.device)
    _launch("nekbone_cg_update", x2.dtype, x2.device,
            (x2, p2, r2, w2, alpha, cx, cy, cz, x_out, r_out, rcr),
            (ex, ey, ez, n))
    return x_out, r_out, rcr
