"""Gradient compression for the cross-pod all-reduce.

The port of the reference's ``distributed/compression.py``: the pod
axis's gradient all-reduce with a narrow wire format, over that axis's
:class:`~repro_torch.distributed.sharding.SolverMesh`.

  * :func:`compressed_psum` — cast to bf16 (or another narrow dtype),
    all-gather, sum in f32 in mesh order, cast back: half the bytes of f32
    on the wire, and no rounding accumulated across the pods.
  * :func:`quantized_psum` — int8 with one f32 scale a tensor and
    optional stochastic rounding: all-gather the int8 values and the
    scales, sum in f32.  The noise is drawn from an explicit
    ``torch.Generator`` and never from the global one.
  * :func:`psum_tree` — either, or the plain ``sharding.psum``, over a
    ``{name: tensor}`` tree; with int8, each leaf in key order draws from
    its own generator seeded from the one given (the counterpart of
    ``jax.random.split``).

As in the reference, the train step only rounds its gradients through
bf16 (``launch/steps.make_train_step``) and the trainer calls none of
these: they are the explicit form a data-parallel caller would apply.
Under gloo the gathers are staged through the host
(``sharding.HOST_STAGED_BYTES``); gloo gathers bf16 and int8 as they are.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import SolverMesh, all_gather, psum

__all__ = ["compressed_psum", "quantized_psum", "psum_tree"]

COMPRESSIONS = ("none", "bf16", "int8")


def _sum_in_order(parts: torch.Tensor, weights=None) -> torch.Tensor:
    """``sum_p parts[p] (* weights[p])`` in f32, in mesh order."""
    acc = None
    for p in range(parts.shape[0]):
        term = parts[p].to(torch.float32)
        if weights is not None:
            term = term * weights[p]
        acc = term if acc is None else acc + term
    return acc


def compressed_psum(x: torch.Tensor, mesh: SolverMesh,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """``psum`` with ``dtype`` on the wire and an f32 sum: all-gather the
    narrow values, sum them in f32 in mesh order, cast to ``x``'s dtype."""
    g = all_gather(x.to(dtype)[None], mesh)               # (pods, ...)
    return _sum_in_order(g).to(x.dtype)


def quantized_psum(x: torch.Tensor, mesh: SolverMesh, *,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """int8 all-reduce with a per-tensor scale (``max |x| / 127``, 1 where x
    is 0): round to int8 — stochastically, with uniform noise in
    [-0.5, 0.5) from ``generator``, where one is given — all-gather the
    values and the scales, and sum ``q * scale`` in f32 in mesh order."""
    amax = x.abs().max().to(torch.float32)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    y = x.to(torch.float32) / scale
    if generator is not None:
        y = y + (torch.rand(x.shape, generator=generator, device=x.device,
                            dtype=torch.float32) - 0.5)
    q = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    qg = all_gather(q[None], mesh)                        # (pods, ...)
    sg = all_gather(scale.reshape(1), mesh)               # (pods,)
    return _sum_in_order(qg, sg).to(x.dtype)


def psum_tree(tree: dict, mesh: SolverMesh, *, compression: str = "none",
              generator: torch.Generator | None = None) -> dict:
    """A ``{name: tensor}`` gradient tree summed over ``mesh`` with the
    wire format ``compression``: ``"none"`` (``sharding.psum`` a leaf),
    ``"bf16"`` (:func:`compressed_psum`) or ``"int8"``
    (:func:`quantized_psum`; with ``generator``, leaf ``k``-th in sorted key
    order rounds with a generator seeded by the ``k``-th of the seeds drawn
    from ``generator``)."""
    if compression not in COMPRESSIONS:
        raise ValueError(f"unknown compression {compression!r}")
    if compression == "none":
        return {k: psum(g, mesh) for k, g in tree.items()}
    if compression == "bf16":
        return {k: compressed_psum(g, mesh) for k, g in tree.items()}
    keys = sorted(tree)
    gens = dict.fromkeys(keys)
    if generator is not None:
        seeds = torch.randint(0, 2 ** 62, (len(keys),), generator=generator,
                              device=generator.device).tolist()
        gens = {k: torch.Generator(tree[k].device).manual_seed(s)
                for k, s in zip(keys, seeds)}
    out = {k: quantized_psum(tree[k], mesh, generator=gens[k]) for k in keys}
    return {k: out[k] for k in tree}
