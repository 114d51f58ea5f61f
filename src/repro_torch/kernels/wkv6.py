"""Wrapper of K14, the RWKV6 WKV recurrence kernel (``csrc/wkv6.cu``).

Replaces the reference's ``kernels/wkv6.py:wkv6`` (its ``_wkv6_kernel``).
The TPU kernel has two bodies, ``sequential`` and ``chunked``, which
compute one function; one CUDA kernel serves both.  :func:`wkv6_cuda`:

* for tensors on the CPU, returns the plain PyTorch version, the
  sequential recurrence :func:`repro_torch.kernels.ref.wkv6_ref` — the
  tests' path;
* for CUDA tensors, checks device, dtypes (r, k and v float32 or bfloat16
  alike; w, u and the state float32 — a bfloat16 call with a float32 ``w``
  is the normal case), shapes, the head size (16 or 64, the sizes it is
  built for) and contiguity, allocates the output and the final state,
  launches the kernel on the current stream, raises if the launch returned
  an error, and adds one to ``LAUNCHES["wkv6"]`` (kernels/_build.py).
  There is no fallback.

The kernel splits each head's value columns into tiles of ``col_tile``
columns, one block each, its key rows into ``row_groups`` groups inside a
block, gives each thread ``cols_per_thread`` columns of its group, and
stages ``steps`` time steps per pass (:data:`TILES`, picked by measurement on the card with
``scripts/k11_k14_compare.py``);
:func:`repro_torch.kernels.ref.wkv6_split_emulated` is its arithmetic in
torch (the columns a thread holds do not change it).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import wkv6_ref

__all__ = ["HEAD_DIMS", "TILES", "DECODE_TILES", "wkv6_cuda"]

HEAD_DIMS = (16, 64)           # the head sizes the kernel is built for
# {d: (col_tile, row_groups, cols_per_thread, steps per pass)} the wrapper
# launches with, for a prompt (T > 1) and for one decode step (T = 1): the
# tilings csrc/wkv6.cu is built for
TILES = {64: (32, 8, 2, 32), 16: (16, 4, 1, 32)}
DECODE_TILES = {64: (32, 16, 2, 1), 16: (16, 8, 1, 1)}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I = ctypes.c_void_p, ctypes.c_int
# r, k, v, w, u, s0, o, s_out; B, H, T, d, col_tile, row_groups,
# cols_per_thread, steps; stream
_ARGTYPES = [_P] * 8 + [_I] * 8 + [_P]


def wkv6_cuda(r, k, v, w, u, *, initial_state=None):
    """K14.  r, k, v, w: (B, H, T, d); u: (H, d); initial_state: (B, H, d,
    d) or None (zeros).  Returns ``(o, state)``: o (B, H, T, d) in r's
    dtype, the final state (B, H, d, d) in float32."""
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, initial_state=initial_state,
                        return_state=True)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: tensors must be on the CPU or a CUDA "
                         f"device, got {r.device}")
    if r.dtype not in _SUFFIX:
        raise NotImplementedError(f"wkv6: the CUDA kernel is built for "
                                  f"float32 and bfloat16, not {r.dtype}")
    B, H, T, d = r.shape
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"wkv6: head size {d} is not one of the "
                                  f"built sizes {HEAD_DIMS}")
    tiles = (DECODE_TILES if T == 1 else TILES)[d]
    f32 = torch.float32
    want = {"k": (k, r.dtype, (B, H, T, d)), "v": (v, r.dtype, (B, H, T, d)),
            "w": (w, f32, (B, H, T, d)), "u": (u, f32, (H, d))}
    if initial_state is not None:
        want["initial_state"] = (initial_state, f32, (B, H, d, d))
    for name, (t, dtype, shape) in want.items():
        if t.device != r.device:
            raise ValueError(f"wkv6: {name} is on {t.device}, not {r.device}")
        if t.dtype != dtype:
            raise TypeError(f"wkv6: {name} is {t.dtype}, not {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"wkv6: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    # the kernel reads r, k, v and w four values at a time: 16-byte
    # aligned rows (a fresh copy where a view starts elsewhere)
    r, k, v, w = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                  else t.clone(memory_format=torch.contiguous_format)
                  for t in (r, k, v, w))
    u = u.contiguous()
    s0 = None if initial_state is None else initial_state.contiguous()
    o = torch.empty_like(r)
    state = torch.empty((B, H, d, d), dtype=f32, device=r.device)
    _build.launch(
        f"wkv6_{_SUFFIX[r.dtype]}", _ARGTYPES, r.device,
        (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
         u.data_ptr(), 0 if s0 is None else s0.data_ptr(), o.data_ptr(),
         state.data_ptr(), B, H, T, d, *tiles))
    return o, state
