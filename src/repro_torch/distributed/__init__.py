"""Sharding over ``torch.distributed``: the Nekbone solves (DESIGN.md §10)
and the LM mesh.

* :mod:`~repro_torch.distributed.sharding` — the 1-D solver mesh along z
  and the collectives (ppermute pair and shift, psum, pmax, all-gather),
  counted; the LM mesh's rules (``AxisRules``, ``RULES``, ``constrain``,
  ``use_mesh``);
* :mod:`~repro_torch.distributed.halo` — a shard's ghost-extended grid,
  on which K8 and K11 run unchanged;
* :mod:`~repro_torch.distributed.sstep` — sharded s-step CG (K8 + K9: one
  exchange and one psum a cycle);
* :mod:`~repro_torch.distributed.pcg` — sharded Jacobi and Chebyshev PCG
  (K4 + K10, or K4 + K5 + K11, K5 and K10 taking the neighbour shards'
  edge planes);
* :mod:`~repro_torch.distributed.context_parallel` — decode attention over
  a sequence-sharded KV cache (one pmax, one psum);
* :mod:`~repro_torch.distributed.overlap` — the collective matmul,
  ``all_gather(x) @ w`` over a ring whose exchange overlaps the matmul;
* :mod:`~repro_torch.distributed.pipeline` — GPipe over one axis, the
  boundary activation moved stage to stage by ppermute;
* :mod:`~repro_torch.distributed.compression` — the gradient all-reduce
  with a bf16 or int8 wire format (``psum_tree``).

The sharded gather-scatter is ``core/gs.ds_sum_sharded`` and the sharded
v1 pipeline ``core/cg_fused.cg_fused_sharded_fixed_iters``; the LM's
sequence-sharded attention and expert-parallel MoE are branches of
``models/attention.py`` and ``models/moe.py``, its meshes
``launch/mesh.py``, and the restore onto another mesh
``checkpoint/manager.py`` (``NamedSharding``, ``shard_block`` and
``unshard`` in ``sharding``).
"""
from repro_torch.distributed import (compression,  # noqa: F401
                                     context_parallel, halo, overlap, pcg,
                                     pipeline, sharding, sstep)
from repro_torch.distributed.sharding import (  # noqa: F401
    SolverMesh, all_gather, ppermute_pair, psum, solver_mesh)

__all__ = ["compression", "context_parallel", "halo", "overlap", "pcg",
           "pipeline", "sharding", "sstep",
           "SolverMesh", "solver_mesh", "ppermute_pair", "psum",
           "all_gather"]
