"""Wrapper of K13, the flash-attention forward kernel (``csrc/flash_attn.cu``).

Replaces the reference's ``kernels/flash_attn.py:flash_attention`` (its
``_attn_kernel``).  The bf16 build runs on the tensor cores (``mma.sync``
on 64 query rows x 64-key tiles staged by ``cp.async``, P split into two
bf16 terms; its arithmetic is :func:`repro_torch.kernels.ref.
flash_attention_tc_emulated`), the f32 build on the CUDA cores (16 query
rows x 32-key tiles).  :func:`flash_attention_cuda`:

* for tensors on the CPU, returns the plain PyTorch version
  (:func:`repro_torch.kernels.ref.flash_attention_plain`) — the tests' path;
* for any other tensors, checks the dtype (float32 or bfloat16, the same
  for q, k and v) and the head size (16, 64, 128 or 192, the sizes it is
  built for), then the device (a CUDA device), shapes, contiguity and
  16-byte alignment (the bf16 kernel copies rows in 16-byte
  pieces; a misaligned tensor raises, it is not copied), allocates the
  output, launches the kernel on the current stream, raises if the launch
  returned an error, and adds one to ``LAUNCHES["flash_attn"]`` and to
  the build's count by head size, window, ``_noncausal`` for a
  non-causal call (whisper's encoder and cross-attention) and ``_cross``
  where Sq != Skv (the cross-attention) (``BUILD_LAUNCHES``,
  kernels/_build.py).  There is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_plain

__all__ = ["HEAD_DIMS", "flash_attention_cuda"]

# the head sizes the kernel is built for: the reduced configs', hymba's and
# whisper's, gemma2's and the other 128-wide models', and nemotron-4's
HEAD_DIMS = (16, 64, 128, 192)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, o; B, Hq, Hkv, Sq, Skv, d; scale; causal, has_window, window,
# has_cap; cap; q_offset; stream
_ARGTYPES = [_P] * 4 + [_I] * 6 + [_F] + [_I] * 4 + [_F, _I, _P]


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, scale: float, window: int | None,
                         softcap: float | None, q_offset: int
                         ) -> torch.Tensor:
    """K13.  q: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d) -> (B, Hq, Sq, d)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     window=window, softcap=softcap,
                                     q_offset=q_offset)
    if q.dtype not in _SUFFIX:
        raise NotImplementedError(f"flash_attn: the CUDA kernel is built for "
                                  f"float32 and bfloat16, not {q.dtype}")
    B, Hq, Sq, d = q.shape
    _, Hkv, Skv, _ = k.shape
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"flash_attn: head size {d} is not one of "
                                  f"the built sizes {HEAD_DIMS}")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn: tensors must be on the CPU or a CUDA "
                         f"device, got {q.device}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attn: {Hq} query heads over {Hkv} kv heads")
    for name, t, shape in (("k", k, (B, Hkv, Skv, d)),
                           ("v", v, (B, Hkv, Skv, d))):
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"flash_attn: {name} is {t.dtype} on {t.device}, "
                            f"q is {q.dtype} on {q.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"flash_attn: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    for name, value in (("window", window or 0), ("q_offset", q_offset)):
        if not -2 ** 31 <= value < 2 ** 31:
            raise ValueError(f"flash_attn: {name} {value} outside int32")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attn: {name}'s data is not 16-byte "
                             f"aligned (address {t.data_ptr():#x})")
    _build.launch(
        f"flash_attn_{_SUFFIX[q.dtype]}", _ARGTYPES, q.device,
        (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Hq, Hkv,
         Sq, Skv, d, float(scale), int(causal), int(window is not None),
         int(window or 0), int(softcap is not None), float(softcap or 0.0),
         int(q_offset)),
        detail=f"_d{d}" + ("" if window is None else f"_window{window}")
        + ("" if causal else "_noncausal")
        + ("" if Sq == Skv else "_cross"))
    return o
