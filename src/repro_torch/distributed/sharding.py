"""The solver mesh and the collectives of the sharded Nekbone drivers.

The reference's ``distributed/sharding.py`` holds two things: the LM
production mesh's rules (``AxisRules``, ``constrain``, ``RULES``), which
are not ported yet (ROADMAP.md queue 1 item 14, the LM half), and the
solver half ported here.  The sharded solvers (``core/gs.py``,
``core/cg_fused.py``, ``distributed/sstep.py``, ``distributed/pcg.py``)
split the element grid into contiguous z-slabs, one per process, over a
1-D :class:`SolverMesh`, and talk through three collectives only:

* :func:`ppermute_pair` — a block to the next shard and a block to the
  previous one, both directions in one ``dist.batch_isend_irecv``, zeros
  received at the global ends (two ``ppermute``\\ s, one a direction, as
  the reference's ``halo_exchange_z`` counts them);
* :func:`psum` — ``all_reduce`` SUM of one stacked buffer;
* :func:`all_gather` — the answer, once, after a solve's loop.

Every call adds one to its kind in :data:`COLLECTIVES` and its bytes to
:data:`COLLECTIVE_BYTES`, which ``obs/metrics.measure_collectives`` reads:
a ppermute's bytes are those sent plus those received (a shard at a global
end has one neighbour), a psum's the buffer's, an all-gather's the gathered
result's.  A call is counted where it is issued, also on a one-shard mesh,
where it moves nothing (a one-rank process group still runs its
all-reduce and all-gather).

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

__all__ = ["SolverMesh", "solver_mesh", "shard_leading", "ppermute_pair", "psum", "all_gather", "COLLECTIVES",
           "COLLECTIVE_BYTES", "HOST_STAGED_BYTES", "reset_collectives",
           "collective_log"]

# Calls and bytes by kind since the last reset_collectives().
COLLECTIVES = {"ppermute": 0, "psum": 0, "all_gather": 0}
COLLECTIVE_BYTES = {"ppermute": 0, "psum": 0, "all_gather": 0}
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
    ``backend`` is ``"nccl"``, ``"gloo"``, or None on the one-shard mesh.
    """

    order: tuple[int, ...]
    shard: int
    backend: str | None = None

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
        return t.to("cpu")
    return t.contiguous()


def _back(t: torch.Tensor, device: torch.device,
          mesh: SolverMesh) -> torch.Tensor:
    if t.device != device:
        HOST_STAGED_BYTES["to_device"] += t.numel() * t.element_size()
        return t.to(device)
    return t


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
    if mesh.backend is None:
        return buf.clone()
    t = _host(buf, mesh)
    if t is buf:
        t = buf.clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return _back(t, buf.device, mesh)


def all_gather(x: torch.Tensor, mesh: SolverMesh) -> torch.Tensor:
    """The shards' blocks of ``x`` concatenated along the leading axis in
    shard order: the global field, on every shard."""
    import torch.distributed as dist

    COLLECTIVES["all_gather"] += 1
    COLLECTIVE_BYTES["all_gather"] += (mesh.ndev * x.numel()
                                       * x.element_size())
    if mesh.backend is None:
        return x.clone()
    t = _host(x, mesh)
    parts = [torch.empty_like(t) for _ in range(mesh.ndev)]
    dist.all_gather(parts, t)
    out = torch.cat([parts[r] for r in mesh.order], dim=0)
    return _back(out, x.device, mesh)
