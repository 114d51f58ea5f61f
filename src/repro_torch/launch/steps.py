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

Under an active mesh (``distributed.sharding.use_mesh``, a ``DeviceMesh``)
the train step is one rank's part of the reference's GSPMD step:

  * the global batch is cut over the batch axes (``pod`` x ``data``): a
    rank takes its rows, and the layers know it (``sharding.batch_cut``);
  * the loss is the mean of the ranks' losses over those axes
    (``sharding.mean_over``), so the loss and the gradients are the whole
    batch's;
  * a leaf held cut (``models.model.hold_cut``: FSDP over ``data``, TP
    over ``model``) is gathered where a layer uses it and its gradient
    comes back as this rank's block, summed over the batch's ranks; a leaf
    the batch axes do not cut gets its gradient summed over them here (one
    psum a group of leaves);
  * each gradient is pinned to the train ``models.model.param_specs``
    (``constrain``: an identity on the port's plain tensors, kept for
    parity with the reference's pin);
  * the gradient norm sums each leaf's squared blocks over the axes that
    cut it, and AdamW steps this rank's blocks.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.distributed import sharding as SH
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
    ``nu`` ({parameter name: tensor}) and the updates taken (``step``).
    Where the model is held cut (``models.model.hold_cut``) each parameter
    and its moments are this rank's blocks."""

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

    def shardings(self) -> dict | None:
        """The ``shardings`` tree of :meth:`tree` for the checkpoint's
        sharded save and restore, or None where the state is whole."""
        layout = M.cut_layout(self.params)
        if layout is None:
            return None
        mesh, specs, _ = layout
        ns = {k: SH.NamedSharding(mesh, specs[k]) for k in self.mu}
        return {**ns, "mu": ns, "nu": ns}

    def like(self) -> dict:
        """A tree of :meth:`tree`'s form whose leaves have the whole
        leaves' shapes and this state's dtypes and device, at the memory of
        one value each (``CheckpointManager.restore``'s ``tree_like``)."""
        layout = M.cut_layout(self.params)

        def whole(k, t):
            shape = t.shape if layout is None else layout[2][k]
            return torch.empty((), dtype=t.dtype,
                               device=t.device).expand(shape)

        return {**{k: whole(k, p) for k, p in self.named().items()},
                "mu": {k: whole(k, t) for k, t in self.mu.items()},
                "nu": {k: whole(k, t) for k, t in self.nu.items()},
                "step": 0}

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


def make_train_state(gen: torch.Generator, cfg, mesh=None) -> TrainState:
    """A fresh state: weights from ``gen`` on its device, requiring grad;
    zero moments in ``cfg.opt_moment_dtype``; step 0.  With ``mesh`` (a
    ``DeviceMesh``) the weights, drawn whole on every rank, are held cut by
    the train ``param_specs`` (``models.model.hold_cut``) and so are the
    moments."""
    params = M.init_params(gen, cfg).requires_grad_(True)
    if mesh is not None:
        M.hold_cut(params, cfg, mesh)
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

    pin = [None, None]          # the last mesh, and the train specs on it

    def train_step(state: TrainState, batch, extra=None):
        named = state.named()
        tokens = batch["tokens"]
        mesh = current_mesh()
        # a mesh of specs alone (an AbstractMesh, no process group) pins
        # and runs whole
        ranks = mesh is not None and SH.has_group(mesh)
        lines = SH.dp_lines(mesh) if ranks else []
        if lines:
            tokens, extra = _local_rows(tokens, extra, lines)
        with SH.batch_cut() if lines else contextlib.nullcontext():
            loss, grads = _loss_and_grads(state, cfg, tokens, extra, named,
                                          lines, grad_accum)

        layout = M.cut_layout(state.params)
        if mesh is not None and pin[0] is not mesh:
            pin[:] = mesh, (layout[1] if layout is not None
                            else M.param_specs(cfg, grads, mesh))
        if ranks:
            _sum_over_batch(grads, pin[1], mesh, layout is not None)
        if grad_compression == "bf16":
            for g in grads.values():
                g.copy_(g.to(torch.bfloat16))
        if mesh is not None:
            grads = {k: constrain(g, pin[1][k]) for k, g in grads.items()}

        lr = cosine_schedule(state.step, peak=peak_lr, warmup_steps=warmup,
                             total_steps=total_steps)
        gnorm = (_grad_norm(grads, pin[1], mesh)
                 if ranks and layout is not None else None)
        _, opt, om = adamw_update(named, grads,
                                  AdamWState(state.step, state.mu, state.nu),
                                  lr=lr, grad_norm=gnorm)
        del grads
        state.step = opt.step
        return state, {"loss": loss, "lr": lr, "grad_norm": om["grad_norm"],
                       "step": opt.step}

    return train_step


def _local_rows(tokens, extra, lines):
    """This rank's rows of the global batch (and of ``extra``), cut over
    the batch axes' ``lines`` in their order."""
    i, n = 0, 1
    for line in lines:
        i, n = i * line.ndev + line.shard, n * line.ndev
    B = tokens.shape[0]
    if B % n:
        raise ValueError(f"a batch of {B} rows does not divide over the "
                         f"mesh's {n} batch ranks")
    rows = slice(i * B // n, (i + 1) * B // n)
    ex = None if extra is None else {k: a[rows] for k, a in extra.items()}
    return tokens[rows], ex


def _loss_and_grads(state, cfg, tokens, extra, named, lines, grad_accum):
    """The batch's loss (the mean over the batch ranks ``lines``) and the
    gradients of this rank's leaves; ``grad_accum`` micro-batches summed
    in f32 and divided."""
    def loss_of(tok, ex):
        loss = M.loss_fn(state.params, cfg, {"tokens": tok}, ex)
        return SH.mean_over(loss, lines) if lines else loss

    if grad_accum == 1:
        loss = loss_of(tokens, extra)
        return loss.detach(), _grads(loss, named)
    mb = tokens.shape[0] // grad_accum
    grads, lsum = None, 0.0
    for i in range(grad_accum):
        rows = slice(i * mb, (i + 1) * mb)
        ex = None if extra is None else {k: a[rows] for k, a in extra.items()}
        loss = loss_of(tokens[rows], ex)
        g = _grads(loss, named)
        if grads is None:       # own f32 buffers, summed in place
            grads = {k: t.to(torch.float32, copy=True) for k, t in g.items()}
        else:
            for k, t in g.items():
                grads[k].add_(t)
        lsum = lsum + loss.detach()
        del loss, g
    for t in grads.values():
        t.div_(grad_accum)
    return lsum / grad_accum, grads


def _spec_axes(spec, mesh) -> set:
    """The mesh axes of more than one rank that ``spec`` cuts by."""
    return {a for _, _, axes in SH._cuts(spec, mesh) for a in axes}


def _sum_over_batch(grads, held, mesh, cut: bool) -> None:
    """Sum each gradient over the batch axes that do not cut its leaf (in
    place; a leaf held cut had its sum over the others in its gather's
    backward): one psum of the flattened leaves a group of axes and
    dtype."""
    batch = [a for a in SH.RULES.dp if SH.mesh_axes(mesh).get(a, 1) > 1]
    groups: dict = {}
    for k, g in grads.items():
        done = _spec_axes(held[k], mesh) if cut else set()
        todo = tuple(a for a in batch if a not in done)
        if todo:
            groups.setdefault((todo, str(g.dtype)), []).append(k)
    for (axes, _), names in sorted(groups.items()):
        flat = torch.cat([grads[k].reshape(-1) for k in names])
        for a in axes:
            flat = SH.psum(flat, SH.axis_mesh(mesh, a))
        at = 0
        for k in names:
            n = grads[k].numel()
            grads[k].copy_(flat[at:at + n].view_as(grads[k]))
            at += n


def _grad_norm(grads, held, mesh) -> torch.Tensor:
    """The global norm of gradients held as this rank's blocks: each leaf's
    squared sum, summed over the axes that cut it (one psum an axis a
    group of leaves cut alike), in float32."""
    parts: dict = {}
    for k, g in grads.items():
        axes = tuple(sorted(_spec_axes(held[k], mesh)))
        s = torch.sum(torch.square(g.float()))
        parts[axes] = s if axes not in parts else parts[axes] + s
    total = None
    for axes in sorted(parts):
        s = parts[axes].reshape(1)
        for a in axes:
            s = SH.psum(s, SH.axis_mesh(mesh, a))
        total = s if total is None else total + s
    return torch.sqrt(total[0])


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
