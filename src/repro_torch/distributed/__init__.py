"""The sharded Nekbone solves over ``torch.distributed`` (DESIGN.md §10).

* :mod:`~repro_torch.distributed.sharding` — the 1-D solver mesh along z
  and its three collectives (ppermute pair, psum, all-gather), counted;
* :mod:`~repro_torch.distributed.halo` — a shard's ghost-extended grid,
  on which K8 and K11 run unchanged;
* :mod:`~repro_torch.distributed.sstep` — sharded s-step CG (K8 + K9: one
  exchange and one psum a cycle);
* :mod:`~repro_torch.distributed.pcg` — sharded Jacobi and Chebyshev PCG
  (K4 + K10, or K4 + K5 + K11, K5 and K10 taking the neighbour shards'
  edge planes).

The sharded gather-scatter is ``core/gs.ds_sum_sharded`` and the sharded
v1 pipeline ``core/cg_fused.cg_fused_sharded_fixed_iters``.  The LM half of
the reference's ``distributed/`` (``AxisRules``, ``constrain``, the
collective matmul, pipelining, compressed psums, context-parallel
attention) is not ported yet (ROADMAP.md queue 1 item 14).
"""
from repro_torch.distributed import halo, pcg, sharding, sstep  # noqa: F401
from repro_torch.distributed.sharding import (  # noqa: F401
    SolverMesh, all_gather, ppermute_pair, psum, solver_mesh)

__all__ = ["halo", "pcg", "sharding", "sstep", "SolverMesh", "solver_mesh",
           "ppermute_pair", "psum", "all_gather"]
