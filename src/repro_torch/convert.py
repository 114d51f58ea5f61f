"""Carry a case's operator data across from arrays.

The port's "weights" are the operator data of a Nekbone case: ``D``, the
metric ``g``, the ``mask``, the multiplicity ``mult``, the weight ``c`` and
the mass ``bmass``.  :func:`case_from_arrays` builds a port
:class:`~repro_torch.core.nekbone.NekboneCase` whose fields are exactly the
given arrays (for instance the reference package's case fields as numpy),
so both packages can be fed identical operator data — including a random
SPD metric (``geom.random_spd_metric``) in place of the box's.
:func:`precond_from_reference` carries a preconditioner across the same
way: the Jacobi diagonal as an array, the Chebyshev order and interval and
the p-multigrid ladder, order, per-level intervals, base iterations and box
lengths as numbers, so both packages can run one set of intervals rather
than two Lanczos estimates.  :func:`sstep_theta_from_reference` carries the
s-step basis scale theta the same way, so both packages run one theta
rather than two power iterations.  :func:`lm_params_from_reference` loads
the reference's LM parameter pytree (``models/model.init_params``, as numpy
arrays) into the port's model, so both packages serve with identical
weights; :func:`train_state_from_reference` does the same for a training
state (parameters, AdamW's moments and step), so both packages train from
one state.  :func:`shard_params` cuts a full model to one rank's shards of
a mesh by per-parameter specs (``models.model.param_specs`` or
``run_specs``): weights reach a sharded run only through it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.nekbone import NekboneCase
from repro_torch.core.precond import (ChebyshevPrecond, JacobiPrecond,
                                      PMGPrecond)

__all__ = ["FIELDS", "case_from_arrays", "precond_from_reference",
           "sstep_theta_from_reference", "lm_params_from_reference",
           "lm_named_arrays", "train_state_from_reference", "shard_params"]

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


def precond_from_reference(spec, *, dtype: torch.dtype, device
                           ) -> JacobiPrecond | ChebyshevPrecond | PMGPrecond:
    """The port's preconditioner spec for a reference spec, read as data.

    ``spec`` is any object with the reference spec's attributes: ``name``
    ``"jacobi"`` with an array-like ``invdiag`` (E, n, n, n); ``name``
    ``"cheb"`` with ``k``, ``lmin`` and ``lmax``; or ``name`` ``"pmg"``
    with ``ns``, ``k``, ``intervals``, ``coarse_iters`` and ``lengths``.
    """
    name = getattr(spec, "name", None)
    if name == "jacobi":
        return JacobiPrecond(invdiag=torch.tensor(
            np.asarray(spec.invdiag), dtype=dtype, device=device))
    if name == "cheb":
        return ChebyshevPrecond(k=int(spec.k), lmin=float(spec.lmin),
                                lmax=float(spec.lmax))
    if name == "pmg":
        return PMGPrecond(
            ns=tuple(int(n) for n in spec.ns), k=int(spec.k),
            intervals=tuple((float(a), float(b)) for a, b in spec.intervals),
            coarse_iters=int(spec.coarse_iters),
            lengths=tuple(float(x) for x in spec.lengths))
    raise ValueError(f"cannot carry preconditioner {name!r} across; "
                     "expected 'jacobi', 'cheb' or 'pmg'")


def sstep_theta_from_reference(source, case: NekboneCase) -> float:
    """Give ``case`` the s-step basis scale theta of ``source``.

    ``source`` is a number, or any object with the reference case's cached
    ``_sstep_theta`` (set by its first s-step solve).  The port case then
    skips its own power iteration (``solvers._drive_sstep`` reads the same
    attribute).  Returns theta.
    """
    theta = getattr(source, "_sstep_theta", source)
    if theta is None:
        raise ValueError("the reference case has no s-step theta yet: run "
                         "one s-step solve on it first")
    case._sstep_theta = float(theta)
    return case._sstep_theta


def _leaves(tree, prefix=()):
    for key, sub in tree.items():
        if isinstance(sub, dict):
            yield from _leaves(sub, prefix + (key,))
        else:
            yield prefix + (key,), sub


def lm_named_arrays(cfg, tree):
    """``(port parameter name, numpy array)`` for each leaf of a reference
    tree shaped like ``init_params(key, cfg)``: nested dicts whose keys are
    the port's module attribute names, the per-layer entries under
    ``"layers"`` and whisper's ``"enc_layers"`` stacked on a leading axis of
    ``cfg.n_layers`` and ``cfg.enc_layers`` layers (``jax.vmap``), which is
    unstacked here."""
    stacks = {"layers": cfg.n_layers, "enc_layers": cfg.enc_layers}
    for path, leaf in _leaves(tree):
        a = np.asarray(leaf)
        if path[0] not in stacks:
            yield ".".join(path), a
            continue
        n = stacks[path[0]]
        if a.shape[0] != n:
            raise ValueError(f"{'.'.join(path)} stacks {a.shape[0]} "
                             f"layers, cfg has {n}")
        for i in range(n):
            yield ".".join((path[0], str(i)) + path[1:]), a[i]


@torch.no_grad()
def _load_named(dst: dict, cfg, tree, what: str) -> None:
    """Copy every leaf of ``tree`` into the tensor of ``dst`` of its port
    name; every tensor of ``dst`` must be given, with its shape."""
    seen = set()
    for name, arr in lm_named_arrays(cfg, tree):
        if name not in dst:
            raise ValueError(f"the reference {what} has {name}, which the "
                             "port's model does not")
        if tuple(arr.shape) != tuple(dst[name].shape):
            raise ValueError(f"{name} has shape {arr.shape}, expected "
                             f"{tuple(dst[name].shape)}")
        # bfloat16 leaves (ml_dtypes' numpy type): exact through float32
        if str(arr.dtype) == "bfloat16":
            arr = arr.astype(np.float32)
        dst[name].copy_(torch.tensor(arr))
        seen.add(name)
    missing = sorted(set(dst) - seen)
    if missing:
        raise ValueError(f"the reference {what} lacks {missing}")


def lm_params_from_reference(cfg, tree, *, device=None):
    """The port's LM (``models.model.LM``) holding the reference's weights.

    ``tree`` is the reference's ``init_params(key, cfg)`` pytree with numpy
    (or array-like) leaves: nested dicts whose keys are the port's module
    attribute names (a hymba layer's ``mamba`` tree and its
    ``norm_attn_out`` and ``norm_ssm_out``, a moe layer's ``moe`` tree,
    whisper's ``xattn``, ``norm_x``, ``pos_embed``, ``enc_pos`` and
    ``enc_final_norm`` included), stacked per layer as
    :func:`lm_named_arrays` reads them.  Every port parameter must be
    given, with its shape; dtypes follow ``cfg.param_dtype``.  ``device`` is
    the card unless given.
    """
    from repro_torch.models import model as M

    device = torch.device("cuda" if device is None else device)
    model = M.init_params(torch.Generator(device).manual_seed(0), cfg)
    _load_named(dict(model.named_parameters()), cfg, tree, "tree")
    return model


def train_state_from_reference(cfg, params_tree, mu_tree, nu_tree, step, *,
                               device=None):
    """The port's ``launch.steps.TrainState`` holding a reference train
    state (``launch/steps.TrainState``'s ``params``, ``mu``, ``nu`` and
    ``step``, numpy leaves): the model from :func:`lm_params_from_reference`
    with its parameters requiring grad, the moments in
    ``cfg.opt_moment_dtype`` keyed by parameter name, ``int(step)``.
    ``device`` is the card unless given."""
    from repro_torch.launch import steps as St

    device = torch.device("cuda" if device is None else device)
    state = St.make_train_state(torch.Generator(device).manual_seed(0), cfg)
    _load_named(state.named(), cfg, params_tree, "params")
    _load_named(state.mu, cfg, mu_tree, "mu")
    _load_named(state.nu, cfg, nu_tree, "nu")
    state.step = int(np.asarray(step))
    return state


@torch.no_grad()
def shard_params(params, specs: dict, mesh):
    """Cut the full model ``params`` (an ``nn.Module``) to this rank's
    shards, in place, and return it.

    ``specs`` maps parameter names to specs (``distributed/sharding.P``:
    each entry an axis name, a tuple of axis names or None); ``mesh`` is
    the ``DeviceMesh``, whose ``get_coordinate()`` places this process.
    Each parameter keeps ``sharding.shard_block`` of itself (the reference's
    layout of a ``NamedSharding``; axes the mesh lacks are ignored).  A cut
    parameter is replaced by a contiguous copy of its block, so the full
    one can be freed."""
    from repro_torch.distributed.sharding import shard_block

    named = dict(params.named_parameters())
    unknown = sorted(set(specs) - set(named))
    if unknown:
        raise ValueError(f"specs name parameters the model lacks: "
                         f"{unknown[:5]}")
    for name, spec in specs.items():
        t = named[name]
        try:
            block = shard_block(t, spec, mesh)
        except ValueError as exc:
            raise ValueError(f"{name}: {exc}") from None
        if block is not t:
            module, _, attr = name.rpartition(".")
            setattr(params.get_submodule(module), attr, torch.nn.Parameter(
                block.clone(memory_format=torch.contiguous_format),
                requires_grad=t.requires_grad))
    return params
