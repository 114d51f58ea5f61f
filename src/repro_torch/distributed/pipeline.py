"""GPipe pipeline parallelism over one mesh axis.

The port of the reference's ``distributed/pipeline.py``.  Stage ``s`` of
the axis owns a contiguous slice of the layers; microbatches stream through
and the boundary activation moves from stage to stage by
``sharding.ppermute_shift`` (the reference's ``ppermute`` with the
permutation ``[(i, i + 1)]``).  The classic schedule: ``M + S - 1`` ticks
for M microbatches on S stages, a bubble of ``(S - 1) / (M + S - 1)``.

The reference runs every stage on every tick, as one SPMD program must,
and masks the rows a stage may write.  Here a stage runs ``stage_fn`` only
on the ticks whose microbatch is in range and sends zeros on the others:
what arrives on such a tick lands on one where the next stage is out of
range too, so every row written is the reference's.  Each tick issues one
ppermute either way.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import SolverMesh, ppermute_shift

__all__ = ["pipeline_apply"]


def pipeline_apply(stage_params, microbatches: torch.Tensor, stage_fn,
                   mesh: SolverMesh) -> torch.Tensor:
    """Run the pipeline over ``mesh`` (the pipeline axis's line, e.g.
    ``sharding.axis_mesh(mesh, "pod")`` or ``sharding.solver_mesh()``).

    stage_params: this stage's slice of the layers, passed to ``stage_fn``;
    microbatches: (M, mb, ...), the global input, the same on every stage
    (only stage 0 reads it); ``stage_fn(stage_params, x) -> y`` runs this
    stage's layers on one microbatch, ``y`` of ``x``'s shape and dtype.
    Returns (M, mb, ...): valid on the last stage (each other stage holds
    its own stage's outputs).
    """
    S, sid = mesh.ndev, mesh.shard
    M = microbatches.shape[0]
    out = torch.zeros_like(microbatches)
    cur = torch.zeros_like(microbatches[0])
    for t in range(M + S - 1):
        m = t - sid                       # this stage's microbatch
        if 0 <= m < M:
            x_in = microbatches[m] if sid == 0 else cur
            y = stage_fn(stage_params, x_in)
            out[m] = y
        else:
            y = torch.zeros_like(cur)
        cur = ppermute_shift(y.contiguous(), mesh)
    return out
