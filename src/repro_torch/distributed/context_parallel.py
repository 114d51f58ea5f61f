"""Context-parallel decode attention: one token against a sequence-sharded
KV cache (the reference's ``distributed/context_parallel.py``).

Each shard attends its own slice of the cache and the partial results
combine exactly by the log-sum-exp rule:

    out = sum_s exp(m_s - m) * o_s  /  sum_s exp(m_s - m) * l_s

with ``m_s``, ``l_s`` and ``o_s`` a shard's row maximum, its sum of
``exp(s - m_s)`` and its unnormalised output, and ``m`` the maximum over
the shards.  The reference's body runs inside ``shard_map``; here every
rank of the axis calls it with its own slice and the axis's
:class:`~repro_torch.distributed.sharding.SolverMesh`.  It issues one
:func:`~repro_torch.distributed.sharding.pmax` (of ``m_s``) and one
:func:`~repro_torch.distributed.sharding.psum` (``l`` and ``o`` in one
buffer; the reference issues two psums).  The scores are plain f32
einsums, as in the reference, where this is XLA code outside any Pallas
kernel.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import SolverMesh, pmax, psum
from repro_torch.kernels.ref import NEG_INF

__all__ = ["cp_decode_attention"]


def cp_decode_attention(q, k_shard, v_shard, *, mesh: SolverMesh,
                        kv_valid_len: int, window=None, softcap=None,
                        scale=None):
    """One shard's part; every shard of ``mesh`` calls it together.

    q:        (B, H, 1, hd), the same on every shard.
    k_shard, v_shard: (B, Hkv, S_local, hd), this shard's slice of the
              cache: shard i holds positions ``i * S_local`` on.
    kv_valid_len: the global number of valid cache entries; with a
              ``window`` only the last ``window`` of them are attended.
    Returns (B, H, 1, hd) in q's dtype, the same on every shard.
    """
    B, H, _, hd = q.shape
    Hkv, S_loc = k_shard.shape[1], k_shard.shape[2]
    G = H // Hkv
    scale = hd ** -0.5 if scale is None else scale

    qg = q.reshape(B, Hkv, G, 1, hd).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k_shard.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kpos = mesh.shard * S_loc + torch.arange(S_loc, device=q.device)
    mask = kpos < kv_valid_len
    if window is not None:
        mask &= kpos > kv_valid_len - 1 - window
    s = torch.where(mask, s, NEG_INF)

    m_loc = s.amax(-1, keepdim=True)                    # (B, Hkv, G, 1, 1)
    p = torch.exp(s - m_loc)
    l_loc = p.sum(-1, keepdim=True)
    o_loc = torch.einsum("bhgqk,bhkd->bhgqd", p, v_shard.float())

    m = pmax(m_loc, mesh)
    corr = torch.exp(m_loc - m)
    lo = psum(torch.cat([l_loc * corr, o_loc * corr], dim=-1), mesh)
    l, o = lo[..., :1], lo[..., 1:]
    out = o / torch.where(l == 0, 1.0, l)
    return out.reshape(B, H, 1, hd).to(q.dtype)
