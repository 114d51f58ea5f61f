"""Sharding: the LM mesh's rules, and the collectives of the sharded
drivers.

The port of the reference's ``distributed/sharding.py``, in two halves.

**The LM half** (reference ``:73-190``).  Axis convention
(``launch/mesh.py``): ``pod`` (data parallelism across pods), ``data``
(FSDP parameter sharding and batch data parallelism), ``model`` (tensor
parallelism: heads, ffn hidden, experts, vocab).  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named axes, made active
by :func:`use_mesh` and read by :func:`current_mesh`; an
:class:`AbstractMesh` (axis names and sizes, no process group) stands in
where only specs are wanted, such as the production meshes' 256 and 512
ranks.  :class:`P` is the port's PartitionSpec: a tuple whose entries are
an axis name, a tuple of axis names, or None.  :class:`AxisRules` maps
logical dimensions to mesh axes, sharding a dimension only when the axes
divide it (:meth:`AxisRules.div`); :data:`RULES` is the one instance every
module reads, tuned by :func:`set_rules`.

:func:`constrain` keeps the reference's call sites.  Without an active
mesh it is the identity, and so is a size: ``AxisRules._size`` is 1, so
every single-device path is what it was.  With a mesh it drops the axis
names the mesh lacks, redistributes a ``DTensor`` to the spec's placements,
and returns a plain tensor unchanged (no copy): the port has no GSPMD, so a
plain tensor is replicated over the mesh, every rank computing it whole,
and the sharded work is done by explicit branches that cut it —
sequence-sharded attention and context-parallel decode
(``models/attention.py``, ``distributed/context_parallel.py``) and the
expert-parallel MoE (``models/moe.py``) — and by parameters held cut and
gathered where they are used (``models/model.hold_cut``).  They talk over one axis of the
mesh through :func:`axis_mesh`, a :class:`SolverMesh` over that axis's
ranks, and the collectives below.

**The solver half.**  The sharded solvers (``core/gs.py``,
``core/cg_fused.py``, ``distributed/sstep.py``, ``distributed/pcg.py``)
split the element grid into contiguous z-slabs, one per process, over a
1-D :class:`SolverMesh`, and talk through three of its collectives:

* :func:`ppermute_pair` — a block to the next shard and a block to the
  previous one, both directions in one ``dist.batch_isend_irecv``, zeros
  received at the global ends (two ``ppermute``\\ s, one a direction, as
  the reference's ``halo_exchange_z`` counts them);
* :func:`psum` — ``all_reduce`` SUM of one stacked buffer;
* :func:`all_gather` — the answer, once, after a solve's loop.

The LM branches use those three (an all-gather along any dimension) and
three more: :func:`ppermute_shift` (a block to the next shard only, one
ppermute: the attention halo and the pipeline's boundary activation),
:func:`ppermute_ring` (a block to the next shard around the ring, started
here and waited for by the caller: the collective matmul) and :func:`pmax`
(``all_reduce`` MAX: the context-parallel softmax's maximum).  On a mesh
axis that is not the whole world the reductions and the gather run over
that axis's process group (``SolverMesh.group``).  :func:`shard_block` and
:func:`unshard` cut a whole tensor to a rank's block of a spec and gather
it back (``convert.shard_params``, the checkpoint's restore onto another
mesh and its sharded save).

Training over the mesh adds :func:`reduce_scatter` (a sum over the shards
and this shard's block of it) and differentiable forms of the collectives,
whose backward depends on what consumes their output: consumers
*replicated* over the axis (every rank computes the same downstream) give
every rank the whole gradient, so the backward is local; consumers
*partial* over it (each rank uses the output for its own slice of the
work) give every rank its part, so the backward sums over the axis.
:func:`all_gather_ad` (either), :func:`psum_ad` (replicated: identity
backward), :func:`grad_psum` (the identity forward where replicated
values enter partial work: its gradient summed), :func:`halo_extend`
(the attention halo, its gradient shifted back to the shard it came
from), :func:`mean_over` (the loss's mean over the batch ranks) and
:func:`gather_leaf` (a parameter held as this rank's block, gathered
whole; backward, summed over the batch axes and cut back to the block).
:func:`batch_cut` marks a block in which each rank holds its own rows of
the batch (the train step's).

Every call adds one to its kind in :data:`COLLECTIVES` and its bytes to
:data:`COLLECTIVE_BYTES`, which ``obs/metrics.measure_collectives`` reads:
a ppermute's bytes are those sent plus those received (a shard at a global
end has one neighbour), a psum's, a pmax's or a reduce-scatter's the
buffer's, an all-gather's the gathered result's.  A call is counted where
it is issued, also on a one-shard mesh, where it moves nothing (a one-rank
process group still runs its all-reduce and all-gather).  On tensors on
``torch.device("meta")`` (the dry run, ``launch/dryrun.py``, under a fake
process group) a call counts the same and moves nothing.

Backends.  An NCCL group exchanges the device tensors themselves.  Gloo's
send, receive and all-reduce take host tensors, so under gloo every
operand on a CUDA device is copied to the host, exchanged there and copied
back: the planes, ghost slabs and scalars are staged through the host in
the open, and :data:`HOST_STAGED_BYTES` counts the bytes copied each way.
That lets several gloo processes share one card, the kernels on the card
and the exchanges on the host; it says nothing of how a solve scales over
several cards.  Without an initialised process group,
:func:`solver_mesh` returns the one-shard mesh, whose collectives are the
identities above (zeros from the absent neighbours).
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

__all__ = ["SolverMesh", "solver_mesh", "shard_leading", "ppermute_pair",
           "ppermute_shift", "ppermute_ring", "psum", "pmax", "all_gather",
           "COLLECTIVES", "COLLECTIVE_BYTES", "HOST_STAGED_BYTES",
           "reset_collectives", "collective_log", "P", "AbstractMesh",
           "NamedSharding", "use_mesh", "current_mesh", "mesh_axes",
           "axis_mesh", "shard_block", "unshard", "constrain", "AxisRules",
           "RULES", "set_rules", "reduce_scatter", "all_gather_ad",
           "psum_ad", "grad_psum", "halo_extend", "gather_leaf",
           "mean_over", "dp_lines", "has_group", "batch_cut", "batch_is_cut",
           "swap_leaves"]

# Calls and bytes by kind since the last reset_collectives().
COLLECTIVES = {"ppermute": 0, "psum": 0, "pmax": 0, "all_gather": 0,
               "reduce_scatter": 0}
COLLECTIVE_BYTES = {"ppermute": 0, "psum": 0, "pmax": 0, "all_gather": 0,
                    "reduce_scatter": 0}
# Bytes copied between the card and the host for a gloo group (both ways).
HOST_STAGED_BYTES = {"to_host": 0, "to_device": 0}


def reset_collectives() -> None:
    for d in (COLLECTIVES, COLLECTIVE_BYTES):
        for key in d:
            d[key] = 0
    for key in HOST_STAGED_BYTES:
        HOST_STAGED_BYTES[key] = 0


@dataclasses.dataclass
class CollectiveLog:
    """What :func:`collective_log` saw: calls and bytes by kind (kinds with
    no call left out of ``counts``), and the bytes staged through the
    host."""

    counts: dict = dataclasses.field(default_factory=dict)
    bytes: dict = dataclasses.field(default_factory=dict)
    host_staged: int = 0


@contextlib.contextmanager
def collective_log():
    """Count the collectives issued inside the ``with`` block."""
    c0, b0 = dict(COLLECTIVES), dict(COLLECTIVE_BYTES)
    h0 = sum(HOST_STAGED_BYTES.values())
    log = CollectiveLog()
    try:
        yield log
    finally:
        log.counts = {k: COLLECTIVES[k] - c0[k] for k in COLLECTIVES
                      if COLLECTIVES[k] != c0[k]}
        log.bytes = {k: COLLECTIVE_BYTES[k] - b0[k] for k in COLLECTIVES
                     if COLLECTIVES[k] != c0[k]}
        log.host_staged = sum(HOST_STAGED_BYTES.values()) - h0


@dataclasses.dataclass(frozen=True)
class SolverMesh:
    """The world's ranks as a 1-D mesh along z: shard ``shard`` of
    ``ndev`` owns the ``shard``-th block of ``EZ / ndev`` element layers.

    ``order`` lists the world's ranks in shard order, so the neighbours of
    this process are ``order[shard - 1]`` and ``order[shard + 1]``;
    ``backend`` is ``"nccl"``, ``"gloo"``, or None on the one-shard mesh;
    ``group`` is the process group of ``order``'s ranks where they are not
    the whole world (:func:`axis_mesh`), else None.
    """

    order: tuple[int, ...]
    shard: int
    backend: str | None = None
    group: object = dataclasses.field(default=None, compare=False)

    @property
    def ndev(self) -> int:
        return len(self.order)

    @property
    def first(self) -> bool:
        """This shard holds the global bottom (z = 0) layer."""
        return self.shard == 0

    @property
    def last(self) -> bool:
        """This shard holds the global top layer."""
        return self.shard == self.ndev - 1

    @property
    def staged(self) -> bool:
        """Collectives go through the host (gloo)."""
        return self.backend == "gloo"


def solver_mesh(order=None) -> SolverMesh:
    """The solver mesh of this process, over the world's ranks.

    Args:
      order: the world's ranks in shard order (default: ascending).
             A hierarchy of axes, such as the reference's ``('pod',
             'data')`` mesh (its ``_flat_shift``), is one group whose ranks
             run in the flattened order: pass the ranks as a nested array,
             ``order[pod][data]``, and it is flattened in C order.

    Without an initialised ``torch.distributed`` process group this is the
    one-shard mesh.
    """
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        if order is not None and [int(r) for r in np.ravel(order)] != [0]:
            raise ValueError("no process group is initialised: the solver "
                             "mesh has one shard, rank 0")
        return SolverMesh(order=(0,), shard=0)
    ranks = list(range(dist.get_world_size()))
    order = tuple(ranks if order is None
                  else (int(r) for r in np.ravel(np.asarray(order))))
    if sorted(order) != ranks:
        raise ValueError(f"order {order} is not a permutation of the "
                         f"group's ranks {ranks}")
    me = dist.get_rank()
    return SolverMesh(order=order, shard=order.index(me),
                      backend=str(dist.get_backend()))


def shard_leading(x: torch.Tensor, mesh: SolverMesh) -> torch.Tensor:
    """This shard's block of ``x`` along its leading (z-major element)
    axis: a contiguous view, ``x`` cut into ``ndev`` equal blocks."""
    if x.shape[0] % mesh.ndev:
        raise ValueError(f"leading axis {x.shape[0]} not divisible by "
                         f"{mesh.ndev} shards")
    m = x.shape[0] // mesh.ndev
    return x[mesh.shard * m:(mesh.shard + 1) * m]


def _host(t: torch.Tensor, mesh: SolverMesh) -> torch.Tensor:
    if mesh.staged and t.device.type != "cpu":
        HOST_STAGED_BYTES["to_host"] += t.numel() * t.element_size()
        # page-locked, from the caching host allocator: a copy to pageable
        # memory runs at a few GB/s, a pinned one near the link's rate
        return torch.empty(t.shape, dtype=t.dtype,
                           pin_memory=True).copy_(t)
    return t.contiguous()


def _back(t: torch.Tensor, device: torch.device,
          mesh: SolverMesh) -> torch.Tensor:
    if t.device != device:
        HOST_STAGED_BYTES["to_device"] += t.numel() * t.element_size()
        return t.to(device)
    return t


def _meta(t: torch.Tensor) -> bool:
    """``t`` lies on ``torch.device("meta")`` (the dry run): a collective
    counts its call and bytes and moves nothing."""
    return t.device.type == "meta"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def ppermute_pair(to_next: torch.Tensor, to_prev: torch.Tensor,
                  mesh: SolverMesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Send ``to_next`` to the next shard and ``to_prev`` to the previous
    one; return ``(from_prev, from_next)``, what those shards sent here,
    zeros where there is no such shard (the global ends).

    Both directions go in one ``dist.batch_isend_irecv``; counted as two
    ppermutes.
    """
    import torch.distributed as dist

    COLLECTIVES["ppermute"] += 2
    device = to_next.device
    from_prev = torch.zeros_like(to_prev)
    from_next = torch.zeros_like(to_next)
    if mesh.ndev == 1:
        return from_prev, from_next
    if _meta(to_next):
        COLLECTIVE_BYTES["ppermute"] += 2 * (
            (not mesh.last) * _nbytes(to_next)
            + (not mesh.first) * _nbytes(to_prev))
        return from_prev, from_next
    ops, recv = [], []
    nbytes = 0
    if not mesh.last:
        peer = mesh.order[mesh.shard + 1]
        buf = _host(to_next, mesh)
        got = torch.empty_like(buf if mesh.staged else from_next)
        ops += [dist.P2POp(dist.isend, buf, peer),
                dist.P2POp(dist.irecv, got, peer)]
        recv.append(("next", got))
        nbytes += 2 * buf.numel() * buf.element_size()
    if not mesh.first:
        peer = mesh.order[mesh.shard - 1]
        buf = _host(to_prev, mesh)
        got = torch.empty_like(buf if mesh.staged else from_prev)
        ops += [dist.P2POp(dist.isend, buf, peer),
                dist.P2POp(dist.irecv, got, peer)]
        recv.append(("prev", got))
        nbytes += 2 * buf.numel() * buf.element_size()
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    COLLECTIVE_BYTES["ppermute"] += nbytes
    for side, got in recv:
        if side == "next":
            from_next = _back(got, device, mesh)
        else:
            from_prev = _back(got, device, mesh)
    return from_prev, from_next


def psum(buf: torch.Tensor, mesh: SolverMesh) -> torch.Tensor:
    """``buf`` summed over the shards (``all_reduce`` SUM), as a new
    tensor on ``buf``'s device; every shard gets the same bits."""
    import torch.distributed as dist

    COLLECTIVES["psum"] += 1
    COLLECTIVE_BYTES["psum"] += buf.numel() * buf.element_size()
    if mesh.backend is None or _meta(buf):
        return buf.clone()
    return _all_reduce(buf, mesh, dist.ReduceOp.SUM)


def pmax(buf: torch.Tensor, mesh: SolverMesh) -> torch.Tensor:
    """``buf``'s elementwise maximum over the shards (``all_reduce`` MAX),
    as a new tensor on ``buf``'s device."""
    import torch.distributed as dist

    COLLECTIVES["pmax"] += 1
    COLLECTIVE_BYTES["pmax"] += buf.numel() * buf.element_size()
    if mesh.backend is None or _meta(buf):
        return buf.clone()
    return _all_reduce(buf, mesh, dist.ReduceOp.MAX)


def _all_reduce(buf, mesh, op):
    import torch.distributed as dist

    t = _host(buf, mesh)
    if t is buf:
        t = buf.clone()
    dist.all_reduce(t, op=op, group=mesh.group)
    return _back(t, buf.device, mesh)


def all_gather(x: torch.Tensor, mesh: SolverMesh,
               dim: int = 0) -> torch.Tensor:
    """The shards' blocks of ``x`` concatenated along ``dim`` (the leading
    axis by default) in shard order: the global field, on every shard.
    Under gloo, ndev - 1 ring steps of point-to-point exchanges through the
    host; else one ``all_gather``."""
    import torch.distributed as dist

    COLLECTIVES["all_gather"] += 1
    COLLECTIVE_BYTES["all_gather"] += (mesh.ndev * x.numel()
                                       * x.element_size())
    if mesh.backend is None:
        return x.clone()
    if _meta(x):
        return torch.cat([x] * mesh.ndev, dim=dim)
    t = _host(x, mesh)
    if mesh.staged:
        return torch.cat([_back(b, x.device, mesh)
                          for b in _ring_gather(t, mesh)], dim=dim)
    parts = [torch.empty_like(t) for _ in range(mesh.ndev)]
    dist.all_gather(parts, t, group=mesh.group)
    idx = [r if mesh.group is None else dist.get_group_rank(mesh.group, r)
           for r in mesh.order]
    out = torch.cat([parts[i] for i in idx], dim=dim)
    return _back(out, x.device, mesh)


def _ring_step(block: torch.Tensor, mesh: SolverMesh) -> torch.Tensor:
    """Send ``block`` to the next shard around the ring and return the
    previous shard's, one ``batch_isend_irecv`` (host tensors)."""
    import torch.distributed as dist

    got = torch.empty(block.shape, dtype=block.dtype,
                      pin_memory=block.is_pinned())
    nxt = mesh.order[(mesh.shard + 1) % mesh.ndev]
    prev = mesh.order[(mesh.shard - 1) % mesh.ndev]
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, block, nxt),
                                       dist.P2POp(dist.irecv, got, prev)]):
        req.wait()
    return got


def _ring_gather(t: torch.Tensor, mesh: SolverMesh) -> list:
    """Every shard's block, in shard order, by ndev - 1 ring steps (gloo's
    point-to-point moves large blocks several times faster than its
    all-gather on one host)."""
    blocks = [None] * mesh.ndev
    i = mesh.shard
    blocks[i] = t
    for _ in range(mesh.ndev - 1):
        got = _ring_step(blocks[i], mesh)
        i = (i - 1) % mesh.ndev
        blocks[i] = got
    return blocks


def _ring_reduce_scatter(t: torch.Tensor, mesh: SolverMesh,
                         dim: int) -> torch.Tensor:
    """This shard's block of the sum over the shards, by ndev - 1 ring
    steps, each adding the received partial sum to its own block: block
    ``i`` sums the shards from ``i + 1`` round to ``i``."""
    chunks = [c.contiguous() for c in t.chunk(mesh.ndev, dim=dim)]
    i = (mesh.shard - 1) % mesh.ndev
    acc = chunks[i]
    for _ in range(mesh.ndev - 1):
        got = _ring_step(acc, mesh)
        i = (i - 1) % mesh.ndev
        acc = got + chunks[i]
    return acc


def ppermute_shift(x: torch.Tensor, mesh: SolverMesh, *,
                   reverse: bool = False) -> torch.Tensor:
    """Send ``x`` to the next shard; return what the previous shard sent,
    zeros on the first shard (the reference's ``ppermute`` with the
    permutation ``[(i, i + 1)]``).  ``reverse``: the other way round, to
    the previous shard, zeros on the last (the permutation ``[(i + 1,
    i)]``, the forward shift's transpose).  One ppermute; its bytes are
    those sent plus those received."""
    import torch.distributed as dist

    COLLECTIVES["ppermute"] += 1
    got = torch.zeros_like(x)
    if mesh.ndev == 1:
        return got
    step = -1 if reverse else 1
    sends = not (mesh.first if reverse else mesh.last)
    gets = not (mesh.last if reverse else mesh.first)
    if _meta(x):
        COLLECTIVE_BYTES["ppermute"] += (sends + gets) * _nbytes(x)
        return got
    ops, nbytes = [], 0
    buf = recv = None
    if sends:
        buf = _host(x, mesh)
        ops.append(dist.P2POp(dist.isend, buf,
                              mesh.order[mesh.shard + step]))
        nbytes += buf.numel() * buf.element_size()
    if gets:
        recv = torch.empty_like(x, device="cpu" if mesh.staged else x.device)
        ops.append(dist.P2POp(dist.irecv, recv,
                              mesh.order[mesh.shard - step]))
        nbytes += recv.numel() * recv.element_size()
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    COLLECTIVE_BYTES["ppermute"] += nbytes
    return got if recv is None else _back(recv, x.device, mesh)


def ppermute_ring(x: torch.Tensor, mesh: SolverMesh):
    """Start sending ``x`` to the next shard around the ring (the last
    shard's next is the first) and receiving the previous shard's block,
    both in one ``dist.batch_isend_irecv`` (at two shards the next and
    the previous shard are one peer); return a function that waits for
    both and returns the received block on ``x``'s device.  The caller
    works between the two calls.  One ppermute (the reference's
    permutation ``[(i, (i + 1) % P)]``); its bytes are those sent plus
    those received.  On a one-shard mesh the block comes back to itself."""
    import torch.distributed as dist

    COLLECTIVES["ppermute"] += 1
    if mesh.ndev == 1:
        return lambda: x
    if _meta(x):
        COLLECTIVE_BYTES["ppermute"] += 2 * _nbytes(x)
        return lambda: torch.empty_like(x)
    buf = _host(x, mesh)
    recv = torch.empty_like(buf)
    nxt = mesh.order[(mesh.shard + 1) % mesh.ndev]
    prev = mesh.order[(mesh.shard - 1) % mesh.ndev]
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, buf, nxt),
                                   dist.P2POp(dist.irecv, recv, prev)])
    COLLECTIVE_BYTES["ppermute"] += 2 * buf.numel() * buf.element_size()

    def wait() -> torch.Tensor:
        for req in reqs:
            req.wait()
        return _back(recv, x.device, mesh)

    return wait


def reduce_scatter(x: torch.Tensor, mesh: SolverMesh,
                   dim: int = 0) -> torch.Tensor:
    """``x`` summed over the shards, and this shard's block of the sum
    along ``dim`` (``x.shape[dim] / ndev`` wide, in shard order): under
    gloo ndev - 1 ring steps through the host, else an ``all_reduce`` and
    a cut.  One reduce_scatter; its bytes are the buffer's, ``x``'s."""
    import torch.distributed as dist

    COLLECTIVES["reduce_scatter"] += 1
    COLLECTIVE_BYTES["reduce_scatter"] += _nbytes(x)
    if x.shape[dim] % mesh.ndev:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} is not a "
                         f"multiple of {mesh.ndev} shards")
    m = x.shape[dim] // mesh.ndev
    if mesh.backend is None or _meta(x):
        return x.narrow(dim, mesh.shard * m, m).clone()
    if mesh.staged:
        t = _ring_reduce_scatter(_host(x.contiguous(), mesh), mesh, dim)
        return _back(t, x.device, mesh)
    t = _all_reduce(x.contiguous(), mesh, dist.ReduceOp.SUM)
    return t.narrow(dim, mesh.shard * m, m).contiguous()


# ---------------------------------------------------------------------------
# gradients through the collectives: what the backward of each does depends
# on what consumes its output.  Consumers *replicated* over the axis (every
# rank computes the same downstream) give every rank the whole gradient:
# the backward is local.  Consumers *partial* over the axis (each rank uses
# the output for its own slice of the work) give every rank its part: the
# backward sums over the axis.
# ---------------------------------------------------------------------------

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, partial):
        ctx.mesh, ctx.dim, ctx.partial, ctx.n = mesh, dim, partial, \
            x.shape[dim]
        return all_gather(x.contiguous(), mesh, dim=dim)

    @staticmethod
    def backward(ctx, g):
        mesh, dim = ctx.mesh, ctx.dim
        if ctx.partial:
            g = reduce_scatter(g, mesh, dim)
        else:
            g = g.narrow(dim, mesh.shard * ctx.n, ctx.n)
        return g, None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return psum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GradPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g.contiguous(), ctx.mesh), None


class _HaloExtend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kv, halo, mesh):
        ctx.halo, ctx.mesh = halo, mesh
        S = kv.shape[-2]
        got = ppermute_shift(kv[..., S - halo:, :].contiguous(), mesh)
        if mesh.first:
            return kv.view_as(kv)
        return torch.cat([got, kv], dim=-2)

    @staticmethod
    def backward(ctx, g):
        halo, mesh = ctx.halo, ctx.mesh
        if mesh.first:
            d_halo, d_own = torch.zeros_like(g[..., :halo, :]), g
        else:
            d_halo, d_own = g[..., :halo, :], g[..., halo:, :]
        back = ppermute_shift(d_halo.contiguous(), mesh, reverse=True)
        d_own = d_own.clone()
        if not mesh.last:
            d_own[..., -halo:, :] += back
        return d_own, None, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lines):
        ctx.n = 1
        for line in lines:
            x = psum(x, line)
            ctx.n *= line.ndev
        return x / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _GatherLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, spec, mesh, summed):
        ctx.spec, ctx.mesh, ctx.summed = spec, mesh, summed
        return unshard(t, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        for dim, _, axes in _cuts(ctx.spec, ctx.mesh):
            for a in axes:
                line = axis_mesh(ctx.mesh, a)
                if a in ctx.summed:
                    g = reduce_scatter(g, line, dim)
                else:
                    m = g.shape[dim] // line.ndev
                    g = g.narrow(dim, line.shard * m, m)
        return g.contiguous(), None, None, None


def all_gather_ad(x: torch.Tensor, mesh: SolverMesh, dim: int = 0, *,
                  partial: bool) -> torch.Tensor:
    """:func:`all_gather`, differentiable: its backward is this shard's
    block of the gradient, summed over the shards first
    (:func:`reduce_scatter`) where the consumers are ``partial``."""
    return _AllGather.apply(x, mesh, dim, partial)


def psum_ad(x: torch.Tensor, mesh: SolverMesh) -> torch.Tensor:
    """:func:`psum`, differentiable, for replicated consumers: its backward
    is the identity."""
    return _Psum.apply(x, mesh)


def grad_psum(x: torch.Tensor, mesh: SolverMesh) -> torch.Tensor:
    """``x`` where it enters work that each shard does a slice of: the
    identity forward, its gradient summed over the shards backward."""
    return _GradPsum.apply(x, mesh)


def halo_extend(kv: torch.Tensor, halo: int,
                mesh: SolverMesh) -> torch.Tensor:
    """``[the previous shard's last halo rows | kv]`` along dim -2, or
    ``kv`` itself on the first shard (one :func:`ppermute_shift` of the
    last ``halo`` rows); differentiable: the halo's gradient is shifted
    back to the shard it came from and added to its last rows."""
    return _HaloExtend.apply(kv, halo, mesh)


def mean_over(x: torch.Tensor, lines) -> torch.Tensor:
    """The mean of ``x`` over the shards of every mesh line of ``lines``
    (one psum a line), differentiable: each shard's gradient is the
    mean's, divided by the shard count (every shard holds the mean)."""
    return _MeanOver.apply(x, tuple(lines))


def gather_leaf(t: torch.Tensor, spec, mesh, summed=()) -> torch.Tensor:
    """The whole leaf of which ``t`` is this rank's :func:`shard_block` by
    ``spec`` on ``mesh`` (:func:`unshard`), differentiable: backward, each
    cut dimension's gradient is cut back to this rank's block, summed
    first over the axes in ``summed`` (:func:`reduce_scatter`: the batch
    axes, whose ranks hold different data) and not over the others (their
    ranks computed the same gradient).  ``t`` itself where nothing is
    cut."""
    if not _cuts(spec, mesh):
        return t
    return _GatherLeaf.apply(t, spec, mesh, frozenset(summed))


@contextlib.contextmanager
def swap_leaves(module, fn):
    """Inside the block, each parameter ``t`` of ``module`` (an
    ``nn.Module``, all its submodules) named ``name`` reads as ``fn(name,
    t)`` (where that is not None); the parameters come back on exit."""
    swapped = []
    try:
        for name, t in list(module.named_parameters()):
            new = fn(name, t)
            if new is None or new is t:
                continue
            owner, _, attr = name.rpartition(".")
            sub = module.get_submodule(owner)
            swapped.append((sub, attr, sub._parameters[attr]))
            sub._parameters[attr] = new
        yield module
    finally:
        for sub, attr, t in reversed(swapped):
            sub._parameters[attr] = t


_BATCH_CUT: list = []


@contextlib.contextmanager
def batch_cut():
    """Inside the block the batch is already cut over the mesh's batch
    axes (``RULES.dp``): a rank holds its own rows (the train step), so a
    layer's batch is one data shard's."""
    _BATCH_CUT.append(True)
    try:
        yield
    finally:
        _BATCH_CUT.pop()


def batch_is_cut() -> bool:
    return bool(_BATCH_CUT)


def has_group(mesh) -> bool:
    """``mesh`` is a ``DeviceMesh`` over a process group (not an
    :class:`AbstractMesh`, which holds specs alone)."""
    return getattr(mesh, "mesh_dim_names", None) is not None


def dp_lines(mesh) -> list:
    """This rank's lines of ``mesh`` along the batch axes of more than one
    rank (``RULES.dp`` order)."""
    sizes = mesh_axes(mesh)
    return [axis_mesh(mesh, a) for a in RULES.dp if sizes.get(a, 1) > 1]


# ---------------------------------------------------------------------------
# the LM half: specs, the active mesh, constrain, the rules
# ---------------------------------------------------------------------------

class P(tuple):
    """A partition spec: one entry a dimension, each an axis name, a tuple
    of axis names, or None (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (tuple(e) if isinstance(e, list) else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no process group behind it:
    enough for specs (:class:`AxisRules`, ``models.model.param_specs``,
    ``configs.specs``), not for collectives."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout on a mesh, the counterpart of
    ``jax.sharding.NamedSharding``: ``mesh`` (a ``DeviceMesh``, or a stand-in
    with ``axis_names``, ``shape`` and ``get_coordinate``) and ``spec`` (a
    :class:`P`).  The rank-local tensor of a leaf so laid out is
    :func:`shard_block` of the whole leaf."""

    mesh: object
    spec: P


_ACTIVE: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh`` with named axes, or an
    :class:`AbstractMesh`) the active mesh inside the block."""
    mesh_axes(mesh)
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def current_mesh():
    """The active mesh (:func:`use_mesh`), or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an
    :class:`AbstractMesh` (or any object with ``axis_names`` and a
    ``shape`` mapping), in the mesh's order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    if getattr(mesh, "axis_names", None) is None:
        raise TypeError(f"{type(mesh).__name__} is not a mesh with named "
                        "axes")
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def axis_mesh(mesh, axis: str) -> SolverMesh:
    """This rank's line of ``mesh`` (a ``DeviceMesh``) along ``axis``, as a
    :class:`SolverMesh`: the ranks that share this rank's coordinates on
    the other axes, in ``axis`` order, with that axis's process group."""
    import torch.distributed as dist

    names = list(mesh.mesh_dim_names)
    grid = mesh.mesh
    me = dist.get_rank()
    coord = [int(c) for c in (grid == me).nonzero()[0]]
    line = [coord[i] if name != axis else slice(None)
            for i, name in enumerate(names)]
    order = tuple(int(r) for r in grid[tuple(line)].reshape(-1))
    group = None if len(order) == dist.get_world_size() else \
        mesh.get_group(axis)
    return SolverMesh(order=order, shard=order.index(me),
                      backend=str(dist.get_backend()), group=group)


def _cuts(spec, mesh) -> list:
    """``(dim, parts, axes)`` for each dimension ``spec`` cuts on ``mesh``:
    ``axes`` the mesh axes of more than one rank that its entry names, in
    the order named (axes the mesh lacks are ignored), ``parts`` the
    product of their sizes."""
    sizes = mesh_axes(mesh)
    cuts = []
    for dim, entry in enumerate(spec):
        axes = [a for a in ((entry,) if isinstance(entry, str) else entry or ())
                if sizes.get(a, 1) > 1]
        if axes:
            cuts.append((dim, int(np.prod([sizes[a] for a in axes])), axes))
    return cuts


def shard_block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` laid out by ``spec`` on
    ``mesh`` (``mesh.get_coordinate()`` places the rank): a dimension whose
    entry names axes is cut into as many equal blocks as those axes have
    ranks together and keeps block ``i``, ``i`` this rank's position on them
    in the order named (the layout of the reference's ``NamedSharding``).
    Returns a view of ``t`` (``t`` itself where nothing is cut)."""
    cuts = _cuts(spec, mesh)
    if not cuts:
        return t
    sizes = mesh_axes(mesh)
    coord = dict(zip(sizes, mesh.get_coordinate()))
    for dim, parts, axes in cuts:
        if t.shape[dim] % parts:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} is not a "
                             f"multiple of {parts} shards")
        i = 0
        for a in axes:
            i = i * sizes[a] + coord[a]
        m = t.shape[dim] // parts
        t = t.narrow(dim, i * m, m)
    return t


def unshard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's :func:`shard_block`:
    one :func:`all_gather` along each cut dimension for each axis that cuts
    it, over that axis's line of ``mesh`` (a ``DeviceMesh``), the last
    named axis first.  ``t`` itself where nothing is cut."""
    for dim, _, axes in _cuts(spec, mesh):
        for a in reversed(axes):
            t = all_gather(t.contiguous(), axis_mesh(mesh, a), dim=dim)
    return t


def _filter(spec, names) -> P:
    def filt(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in names)
            return kept if kept else None
        return entry if entry in names else None

    return P(*(filt(e) for e in spec))


def constrain(x, spec):
    """The reference's ``with_sharding_constraint``, without GSPMD.

    Without an active mesh: ``x``.  With one: a ``DTensor`` is
    redistributed to ``spec`` (less the axis names the mesh lacks, as the
    reference drops them) — ``Shard(d)`` on each axis that names dimension
    d, ``Replicate()`` on the others; a plain tensor is returned as it is,
    not copied (module docstring)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    spec = _filter(spec, mesh_axes(mesh))
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    placements = [Replicate()] * len(mesh_axes(mesh))
    names = list(mesh_axes(mesh))
    for dim, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            placements[names.index(a)] = Shard(dim)
    return x.redistribute(x.device_mesh, placements)


@dataclasses.dataclass
class AxisRules:
    """Logical-to-mesh mapping with divisibility-aware helpers.

    Mutable singleton (:data:`RULES`): launchers tune it per run via
    :func:`set_rules` (e.g. ``fsdp_pod=True`` for the >100B archs) and every
    module sees the change because they all hold the same object.
    """

    dp: tuple[str, ...] = ("pod", "data")   # batch / token parallelism
    fsdp: str | None = "data"               # parameter sharding
    fsdp_pod: bool = False                  # also FSDP over 'pod' (huge archs)
    tp: str | None = "model"                # tensor parallelism
    seq: str | None = "data"                # context parallelism (long decode)

    # -- axis-size helpers --------------------------------------------------
    def _size(self, axes) -> int:
        mesh = current_mesh()
        if mesh is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        sizes = mesh_axes(mesh)
        s = 1
        for a in axes:
            s *= sizes.get(a, 1)
        return s

    def div(self, dim: int, axes):
        """Return ``axes`` if ``dim`` divides evenly over them, else None."""
        if axes is None:
            return None
        sz = self._size(axes)
        return axes if (sz > 1 and dim % sz == 0) else (axes if sz == 1
                                                         else None)

    @property
    def fsdp_axes(self):
        if self.fsdp is None:
            return None
        return ("pod", self.fsdp) if self.fsdp_pod else self.fsdp

    # -- common specs --------------------------------------------------------
    def act_btd(self, d: int | None = None) -> P:
        """Activations (batch, seq, d_model): batch over dp."""
        return P(self.dp, None, None)

    def act_bthd(self, heads: int) -> P:
        """(batch, seq, heads, head_dim): heads over tp when divisible."""
        return P(self.dp, None, self.div(heads, self.tp), None)

    def w_in(self, d_in: int, d_out: int) -> P:
        """Input-side weight (d_in, d_out): FSDP rows, TP cols."""
        return P(self.div(d_in, self.fsdp_axes), self.div(d_out, self.tp))

    def w_out(self, d_in: int, d_out: int) -> P:
        """Output-side weight (d_in, d_out): TP rows, FSDP cols."""
        return P(self.div(d_in, self.tp), self.div(d_out, self.fsdp_axes))

    def w_expert(self, n_exp: int, d_in: int, d_out: int) -> P:
        """Expert weights (E, d_in, d_out): experts over TP, FSDP on d_in."""
        return P(self.div(n_exp, self.tp), self.div(d_in, self.fsdp_axes),
                 None)

    def embed(self, vocab: int, d: int) -> P:
        """Embedding / unembedding (vocab, d): vocab over TP, d over FSDP."""
        return P(self.div(vocab, self.tp), self.div(d, self.fsdp_axes))

    def kv_cache(self, kv_heads: int) -> P:
        """KV cache (batch, kv_heads, seq, head_dim)."""
        return P(self.dp, self.div(kv_heads, self.tp), None, None)

    def kv_cache_cp(self, kv_heads: int) -> P:
        """Context-parallel KV cache for long single-sequence decode:
        the *sequence* axis is sharded (batch is 1)."""
        return P(None, self.div(kv_heads, self.tp), self.seq, None)


RULES = AxisRules()


def set_rules(**kw) -> AxisRules:
    """Mutate the global rules in place (same object everywhere)."""
    for k, v in kw.items():
        if not hasattr(RULES, k):
            raise AttributeError(f"AxisRules has no field {k!r}")
        setattr(RULES, k, v)
    return RULES
