"""Compute/communication overlap: the collective (all-gather) matmul.

The port of the reference's ``distributed/overlap.py``.  Tensor parallelism
pays for ``all_gather(x) @ w`` twice over when the link idles while the
matmul runs and the other way round.  The collective matmul pipelines the
two: at each step of a ring the rank multiplies the block it holds while
the next block travels, so the gather is never built.

:func:`collective_matmul_allgather` takes this rank's rows of ``x`` and a
``w`` that is replicated or cut by columns (the product is layout-agnostic:
with column blocks of ``w`` each rank computes its column block of the
result), over one axis's :class:`~repro_torch.distributed.sharding.SolverMesh`
(``sharding.axis_mesh(mesh, "model")``).  Each ring step posts its
``isend``/``irecv`` (``sharding.ppermute_ring``) before that step's matmul
and waits after it: PyTorch's form of the overlap.  Under gloo the blocks
are staged through the host, so the exchange runs on gloo's threads while
the card multiplies.  The reference forwards the block on its last step as
well and discards what arrives; the port skips that send, so a ring of P
shards issues P - 1 ppermutes.

The product is ``torch.matmul`` in ``x``'s dtype: bf16 and f32 inputs
accumulate in f32 (cuBLAS's bf16 GEMM accumulates in f32 and rounds once),
as the reference's ``preferred_element_type=f32`` and cast do.  In fp64 the
port stays in fp64, where the reference still accumulates in f32 (its
result is then f32-accurate).  The reference computes this outside any
Pallas kernel, so the matmul is a library call here too.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import SolverMesh, ppermute_ring

__all__ = ["collective_matmul_allgather"]


def collective_matmul_allgather(x: torch.Tensor, w: torch.Tensor,
                                mesh: SolverMesh) -> torch.Tensor:
    """``all_gather(x) @ w`` without the gather.

    x: (m_local, k), this shard's rows of the global (m_local * P, k);
    w: (k, n), replicated, or this shard's column block.  Returns
    (m_local * P, n), rows in shard order, the same on every shard.

    Ring schedule: at step s this shard holds the block that started at
    shard (i - s) mod P and writes its product into that block's rows.
    """
    P, i = mesh.ndev, mesh.shard
    m_loc = x.shape[0]
    out = torch.empty((m_loc * P, w.shape[1]), dtype=x.dtype, device=x.device)
    blk = x.contiguous()
    for s in range(P):
        src = (i - s) % P
        wait = ppermute_ring(blk, mesh) if s < P - 1 else None
        torch.matmul(blk, w, out=out[src * m_loc:(src + 1) * m_loc])
        if wait is not None:
            blk = wait()
    return out
