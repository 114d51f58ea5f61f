"""The step functions of the port: one training step, prefill and one-token
decode.

The port of the reference's ``launch/steps.py``, closures of ``cfg``:

  * ``train_step``    — forward + backward (autograd, through K13 and K14's
                        Functions, ``kernels/autograd.py``) + the AdamW
                        update, in place on the state (the counterpart of
                        the reference's donated train state).
  * ``serve_prefill`` — full-prompt forward producing the cache.
  * ``serve_step``    — one-token decode against the cache.

The serving closures run under ``torch.inference_mode()``: a model whose
parameters require grad (a train state's) builds no graph there.
``launch/serve.serve`` also turns that ``requires_grad`` off for its run,
so such a model serves bitwise as one that does not.  PyTorch runs
eagerly, so nothing here is compiled (the reference jits these closures).
Under an active mesh (``distributed.sharding.use_mesh``) the step pins each
gradient to its parameter's layout before AdamW, as the reference does:
the port's parameters are laid out by ``models.model.run_specs`` (the
reference pins to its ``param_specs``, the layout its GSPMD parameters
have), so the two cannot disagree.  The port's gradients are plain
tensors, which ``constrain`` leaves as they are: the pin is an identity
kept for parity, and the state is bitwise that of the same step without a
mesh.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed.sharding import constrain, current_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               cosine_schedule)

__all__ = ["TrainState", "make_train_state", "make_train_step",
           "make_serve_prefill", "make_serve_step"]


@dataclasses.dataclass
class TrainState:
    """The model (``params``, an ``M.LM``), AdamW's moments ``mu`` and
    ``nu`` ({parameter name: tensor}) and the updates taken (``step``)."""

    params: M.LM
    mu: dict
    nu: dict
    step: int

    def named(self) -> dict:
        return dict(self.params.named_parameters())

    def tree(self) -> dict:
        """The checkpoint's tree: parameters by name, ``mu``, ``nu`` and
        ``step`` (``CheckpointManager.save``)."""
        return {**{k: p.detach() for k, p in self.named().items()},
                "mu": self.mu, "nu": self.nu, "step": self.step}

    @torch.no_grad()
    def load(self, tree: dict) -> "TrainState":
        """Copy a tree of :meth:`tree`'s form (``CheckpointManager.restore``)
        into this state, in place."""
        for k, p in self.named().items():
            p.copy_(tree[k])
        for mine, theirs in ((self.mu, tree["mu"]), (self.nu, tree["nu"])):
            for k, t in mine.items():
                t.copy_(theirs[k])
        self.step = int(tree["step"])
        return self


def make_train_state(gen: torch.Generator, cfg) -> TrainState:
    """A fresh state: weights from ``gen`` on its device, requiring grad;
    zero moments in ``cfg.opt_moment_dtype``; step 0."""
    params = M.init_params(gen, cfg).requires_grad_(True)
    opt = adamw_init(dict(params.named_parameters()),
                     moment_dtype=L.dtype_of(cfg.opt_moment_dtype))
    return TrainState(params=params, mu=opt.mu, nu=opt.nu, step=opt.step)


def _grads(loss, named: dict) -> dict:
    """d loss / d each parameter, in its dtype (zeros where unused)."""
    got = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(named.items(), got)}


def make_train_step(cfg, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, grad_compression: str = "none",
                    grad_accum: int = 1):
    """Returns ``train_step(state, batch, extra=None) -> (state, metrics)``,
    metrics ``loss``, ``lr``, ``grad_norm`` and ``step``.

    ``batch["tokens"]``: (B, S + 1) integer tokens on the state's device.
    ``grad_accum`` > 1 splits the batch (and ``extra``) into that many
    micro-batches along B, sums their gradients in f32 and divides by
    ``grad_accum`` (the loss likewise).  ``grad_compression="bf16"`` rounds
    every gradient to bf16 and back (the cross-pod all-reduce's wire
    format); ``"int8"`` and ``"none"`` leave them as they are, exactly as in
    the reference, whose step acts on ``"bf16"`` only.  The learning rate
    is ``cosine_schedule`` of the state's step.
    """
    if grad_compression not in ("none", "bf16", "int8"):
        raise ValueError(f"unknown grad_compression {grad_compression!r}")

    pin = [None, None]          # the last mesh, and run_specs on it

    def train_step(state: TrainState, batch, extra=None):
        named = state.named()
        tokens = batch["tokens"]
        if grad_accum > 1:
            mb = tokens.shape[0] // grad_accum
            grads, lsum = None, 0.0
            for i in range(grad_accum):
                rows = slice(i * mb, (i + 1) * mb)
                ex = (None if extra is None
                      else {k: a[rows] for k, a in extra.items()})
                loss = M.loss_fn(state.params, cfg, {"tokens": tokens[rows]},
                                 ex)
                g = _grads(loss, named)
                if grads is None:       # own f32 buffers, summed in place
                    grads = {k: t.to(torch.float32, copy=True)
                             for k, t in g.items()}
                else:
                    for k, t in g.items():
                        grads[k].add_(t)
                lsum = lsum + loss.detach()
                del loss, g
            for t in grads.values():
                t.div_(grad_accum)
            loss = lsum / grad_accum
        else:
            loss = M.loss_fn(state.params, cfg, batch, extra)
            grads = _grads(loss, named)
            loss = loss.detach()

        if grad_compression == "bf16":
            for g in grads.values():
                g.copy_(g.to(torch.bfloat16))

        mesh = current_mesh()
        if mesh is not None:
            if pin[0] is not mesh:
                pin[:] = mesh, M.run_specs(cfg, grads, mesh)
            grads = {k: constrain(g, pin[1][k]) for k, g in grads.items()}

        lr = cosine_schedule(state.step, peak=peak_lr, warmup_steps=warmup,
                             total_steps=total_steps)
        _, opt, om = adamw_update(named, grads,
                                  AdamWState(state.step, state.mu, state.nu),
                                  lr=lr)
        del grads
        state.step = opt.step
        return state, {"loss": loss, "lr": lr, "grad_norm": om["grad_norm"],
                       "step": opt.step}

    return train_step


def make_serve_prefill(cfg, *, max_len: int):
    def serve_prefill(params, tokens, extra=None):
        with torch.inference_mode():
            return M.prefill(params, cfg, tokens, extra, max_len=max_len)

    return serve_prefill


def make_serve_step(cfg):
    def serve_step(params, tokens, cache, index):
        with torch.inference_mode():
            return M.decode_step(params, cfg, tokens, cache, index)

    return serve_step
