"""GQA attention: prefill through K13 and single-token decode.

The port of the reference's ``models/attention.py``.

Prefill (:func:`attention`).  The reference's implementation ladder is
``naive`` (the full score matrix), ``chunked`` (an XLA online softmax) and
``flash`` (the Pallas kernel, K13).  Here every impl runs K13
(``ops.flash_attention``) on a CUDA tensor, so a prefill on the card never
takes a plain version.  On a CPU tensor the impl picks the plain
formulation: ``naive`` the reference's oracle (``kernels/ref.attention_ref``),
``chunked`` and ``flash`` the kernel's own online-softmax function (K13's
plain version; ``chunked`` computes that same function in the reference).
``kv_override=(k, v)`` supplies the keys and values, (B, Hkv, Skv, hd),
in place of the layer's own projections (whisper's cross-attention, over
the encoder's output); with ``causal=False`` it and the encoder's
self-attention run K13 non-causal, with Sq != Skv for the former.  Where a
gradient is wanted (training), K13 and its plain version run through
``kernels/autograd.FlashAttentionFn``, whose backward is FlashAttention-2's
in plain torch; serving calls the wrapper itself.

Sequence-sharded prefill (:func:`_seq_sharded_chunked`).  Under an active
mesh (``distributed/sharding.use_mesh``) whose ``model`` axis does not
divide the head count (hymba's 25 heads over a model axis of 2), the
reference's ``chunked`` impl splits the queries along the sequence over
that axis instead of replicating the quadratic work, and so does the port:
rank r of the axis runs K13 on its contiguous query slice, with
``q_offset``.  The layer's q, k and v are computed whole on every rank (the
port has no GSPMD: activations are replicated over the mesh), and the
branch takes only its own slice of each, as a sequence-sharded layout
would hold them.  The key and value collectives below therefore move what
the rank already holds: they are kept so that the branch issues the
reference's data movement, the one a sequence-sharded activation layout
needs (in hymba's prefill over a model axis of 2: 3 all-gathers and 29
ppermutes, 107 MB of the 946 MB its collectives move; the output's
all-gather, the rest, is needed either way).  Global layers all-gather the keys and values (one
all-gather of k and v together), cut at the slice's last query where the
layer is causal.  Windowed layers with ``window < S_loc`` keep them
sharded and take a ``window``-deep block from the left neighbour (one
:func:`~repro_torch.distributed.sharding.ppermute_shift` of k and v
together); K13 has no key shift, so the first rank, which has no left
neighbour, runs on its own keys with ``q_offset = 0`` and every other rank
on ``[halo | own]`` with ``q_offset = window``.  The output projection runs
on the slice and one all-gather along the sequence makes the layer's
output whole again (the gather the reference's caller's constraint does).

Decode (:func:`decode_attention`) attends a (B, Hkv, max_len, hd) cache.
It is plain torch, as in the reference, where it is einsum code outside any
Pallas kernel.  The cache is updated in place (the reference returns a new
array): one slot per step, no copy of the cache.  Under a mesh whose
``model`` axis does not divide the KV heads — or, with
``context_parallel``, along the ``data`` axis — the cache is sharded along
its sequence (:func:`init_kv_cache`: each rank holds ``max_len / size``
slots, so ``max_len`` must be a multiple of the axis size), and
:func:`_decode_attn_seq_sharded` writes the new token's k and v on the
rank that owns its slot and combines the ranks' partial softmaxes
(``distributed/context_parallel.cp_decode_attention``: one pmax, one psum).

Supports GQA grouping, sliding window, gemma2 logit softcap, QKV biases,
qk-norm and rotary positions.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed import sharding as SH
from repro_torch.distributed.context_parallel import cp_decode_attention
from repro_torch.distributed.sharding import RULES, constrain
from repro_torch.kernels import autograd as AG
from repro_torch.kernels.ref import NEG_INF, attention_ref
from repro_torch.models import layers as L

__all__ = ["IMPLS", "Attention", "init_attention", "attention",
           "decode_attention", "init_kv_cache", "fill_kv_cache"]

IMPLS = ("naive", "chunked", "flash")


class Attention(nn.Module):
    def __init__(self, gen: torch.Generator, cfg):
        super().__init__()
        d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        dt = L.dtype_of(cfg.param_dtype)
        self.wq = L.Linear(gen, d, H * hd, bias=cfg.qkv_bias, dtype=dt)
        self.wk = L.Linear(gen, d, Hkv * hd, bias=cfg.qkv_bias, dtype=dt)
        self.wv = L.Linear(gen, d, Hkv * hd, bias=cfg.qkv_bias, dtype=dt)
        self.wo = L.Linear(gen, H * hd, d, dtype=dt)
        self.q_norm = self.k_norm = None
        if cfg.qk_norm:
            self.q_norm = L.Norm(hd, dtype=dt, device=gen.device)
            self.k_norm = L.Norm(hd, dtype=dt, device=gen.device)


def init_attention(gen: torch.Generator, cfg) -> Attention:
    return Attention(gen, cfg)


def _heads(x, w: L.Linear, n: int, cfg, norm=None, positions=None):
    """(B, S, d) -> (B, S, n, hd) through ``w``; rms-normed by ``norm``
    (qk-norm) if given, and rotated where the config has RoPE and
    ``positions`` is given."""
    B, S, _ = x.shape
    t = L.linear(x, w, L.dtype_of(cfg.compute_dtype)).reshape(B, S, n, cfg.hd)
    if norm is not None:
        t = L.rms_norm(t, norm, eps=cfg.norm_eps)
    if cfg.pos_emb == "rope" and positions is not None:
        t = L.rope(t, positions, theta=cfg.rope_theta)
    return t


def _project_qkv(x, p: Attention, cfg, positions, *, kv: bool = True):
    """q, k, v in (B, S, heads, hd); k and v are None unless ``kv``."""
    q = constrain(_heads(x, p.wq, cfg.n_heads, cfg, p.q_norm, positions),
                  RULES.act_bthd(cfg.n_heads))
    if not kv:
        return q, None, None
    k = _heads(x, p.wk, cfg.n_kv_heads, cfg, p.k_norm, positions)
    v = _heads(x, p.wv, cfg.n_kv_heads, cfg)
    k = constrain(k, RULES.act_bthd(cfg.n_kv_heads))
    v = constrain(v, RULES.act_bthd(cfg.n_kv_heads))
    return q, k, v


# ---------------------------------------------------------------------------
# The mesh branches
# ---------------------------------------------------------------------------
def _use_seq_shard(cfg, B: int, S: int) -> bool:
    """The reference's choice of the sequence-sharded prefill: an active
    mesh whose TP axis (size > 1) does not divide the heads, and divides
    the sequence into slices of 8 or more; the batch divides over dp (a
    batch already cut over dp, the train step's, always does)."""
    mesh = SH.current_mesh()
    if mesh is None:
        return False
    sizes = SH.mesh_axes(mesh)
    if RULES.tp not in sizes:
        return False
    tp_size = sizes[RULES.tp]
    if tp_size == 1 or cfg.n_heads % tp_size == 0:
        return False
    return (S % tp_size == 0 and S // tp_size >= 8
            and (SH.batch_is_cut() or B % RULES._size(RULES.dp) == 0))


def _seq_sharded_chunked(q, k, v, *, causal, window, cap, scale):
    """This rank's query slice of the sequence-sharded prefill (module
    docstring), through K13.  q: (B, H, S, hd); k, v: (B, Hkv, S, hd), the
    whole sequence (this rank reads only its slice), or (B, Hkv, Skv, hd)
    with Skv != S (cross-attention: replicated keys, used whole, as the
    reference's replicated key spec has them).  Returns (B, H, S_loc, hd),
    the rows of the TP axis's shard of the sequence.  The key collectives
    are differentiable: each rank's query slice uses the gathered keys,
    so the gather's backward sums over the axis, and the halo's gradient
    goes back to the shard it came from."""
    line = SH.axis_mesh(SH.current_mesh(), RULES.tp)
    S = q.shape[2]
    S_loc = S // line.ndev
    lo = line.shard * S_loc
    q_l = q[:, :, lo:lo + S_loc]
    k_l, v_l = k[:, :, lo:lo + S_loc], v[:, :, lo:lo + S_loc]
    if window is not None and causal and window < S_loc:
        kv = SH.halo_extend(torch.stack([k_l, v_l]), window, line)
        k_e, v_e = kv[0], kv[1]
        q_offset = 0 if line.first else window
    elif k.shape[2] != S:              # cross-attention: every key, whole
        k_e, v_e, q_offset = k, v, lo
    else:
        kv = SH.all_gather_ad(torch.stack([k_l, v_l]), line, dim=3,
                              partial=True)
        end = lo + S_loc if causal else S
        k_e, v_e, q_offset = kv[0, :, :, :end], kv[1, :, :, :end], lo
    return AG.flash_attention(q_l.contiguous(), k_e.contiguous(),
                              v_e.contiguous(), causal=causal, scale=scale,
                              window=window, softcap=cap, q_offset=q_offset)


def attention(x, p: Attention, cfg, *, positions, window=None, causal=True,
              impl: str = "chunked", kv_override=None):
    """Full-sequence (prefill) attention.

    Returns (out, (k, v)) — k/v in (B, Hkv, S, hd) for cache construction.
    ``kv_override`` supplies external K/V (cross-attention), already
    (B, Hkv, Skv, hd); the layer's own k and v are then not computed.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; have {IMPLS}")
    H, hd = cfg.n_heads, cfg.hd
    seq_sharded = impl == "chunked" and _use_seq_shard(cfg, x.shape[0],
                                                       x.shape[1])
    if seq_sharded and torch.is_grad_enabled():
        # each rank works on its query slice of what every rank computes
        # whole: the gradients of x, of the keys given and of the layer's
        # weights are summed over the axis where they enter
        line = SH.axis_mesh(SH.current_mesh(), RULES.tp)
        x = SH.grad_psum(x, line)
        if kv_override is not None:
            kv_override = tuple(SH.grad_psum(t, line) for t in kv_override)
        with SH.swap_leaves(p, lambda _, t: SH.grad_psum(t, line)):
            return _attention(x, p, cfg, positions, window, causal, impl,
                              kv_override, seq_sharded)
    return _attention(x, p, cfg, positions, window, causal, impl,
                      kv_override, seq_sharded)


def _attention(x, p, cfg, positions, window, causal, impl, kv_override,
               seq_sharded):
    H, hd = cfg.n_heads, cfg.hd
    q, k, v = _project_qkv(x, p, cfg, positions, kv=kv_override is None)
    q = q.transpose(1, 2)
    if kv_override is not None:
        k, v = kv_override
    else:
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    scale = hd ** -0.5
    cdt = L.dtype_of(cfg.compute_dtype)
    if seq_sharded:
        out = _seq_sharded_chunked(q, k, v, causal=causal, window=window,
                                   cap=cfg.attn_softcap, scale=scale)
    elif impl == "naive" and q.device.type == "cpu":
        out = attention_ref(q, k, v, causal=causal, scale=scale,
                            window=window, softcap=cfg.attn_softcap)
    else:
        out = AG.flash_attention(q, k, v, causal=causal, scale=scale,
                                 window=window, softcap=cfg.attn_softcap)
    B, _, S, _ = out.shape
    out = out.transpose(1, 2).reshape(B, S, H * hd)
    if not seq_sharded:
        return L.linear(out, p.wo, cdt), (k, v)
    # the output projection on the sequence shard, then its (B, S, d)
    # result gathered whole (replicated consumers: the gather's backward
    # is this rank's rows of the gradient)
    out = constrain(out, SH.P(RULES.dp, RULES.tp, None))
    line = SH.axis_mesh(SH.current_mesh(), RULES.tp)
    y = L.linear(out, p.wo, cdt).contiguous()
    return SH.all_gather_ad(y, line, dim=1, partial=False), (k, v)


def _cache_seq_axis(cfg, batch: int, context_parallel: bool):
    """The mesh axis the KV cache's sequence is sharded over, or None: the
    reference's decode branch choice (``RULES.seq`` for context-parallel
    decode; else the TP axis where it does not divide the KV heads)."""
    mesh = SH.current_mesh()
    if mesh is None:
        return None
    sizes = SH.mesh_axes(mesh)
    if context_parallel and RULES.seq in sizes:
        return RULES.seq
    tp = sizes.get(RULES.tp, 1)
    if (tp > 1 and cfg.n_kv_heads % tp != 0
            and (SH.batch_is_cut() or batch % RULES._size(RULES.dp) == 0)):
        return RULES.tp
    return None


def init_kv_cache(cfg, batch: int, max_len: int, *, device,
                  context_parallel: bool = False) -> dict:
    """One layer's zero KV cache, (batch, Hkv, max_len, hd) in the compute
    dtype; under a mesh that shards the cache's sequence
    (:func:`_cache_seq_axis`), this rank's (batch, Hkv, max_len / size, hd)
    slice of it."""
    axis = _cache_seq_axis(cfg, batch, context_parallel)
    if axis is not None:
        size = SH.mesh_axes(SH.current_mesh())[axis]
        if max_len % size:
            raise ValueError(f"max_len {max_len} is not a multiple of the "
                             f"{axis!r} axis ({size}), over which the KV "
                             "cache's sequence is sharded")
        max_len //= size
    shape = (batch, cfg.n_kv_heads, max_len, cfg.hd)
    dt = L.dtype_of(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def fill_kv_cache(cfg, cache: dict, k, v, *,
                  context_parallel: bool = False) -> None:
    """Write a prefill's k and v, (B, Hkv, S, hd), into the cache's first S
    positions (in place): into this rank's slots of them where the cache's
    sequence is sharded."""
    kc, vc = cache["k"], cache["v"]
    lo, S = 0, k.shape[2]
    axis = _cache_seq_axis(cfg, k.shape[0], context_parallel)
    if axis is not None:
        lo = SH.axis_mesh(SH.current_mesh(), axis).shard * kc.shape[2]
    hi = min(S, lo + kc.shape[2])
    if hi > lo:
        kc[:, :, :hi - lo] = k[:, :, lo:hi].to(kc.dtype)
        vc[:, :, :hi - lo] = v[:, :, lo:hi].to(vc.dtype)


def _decode_attn_seq_sharded(q, cache_k, cache_v, k_new, v_new, cache_index,
                             *, axis: str, window, softcap, scale):
    """Decode against a sequence-sharded KV cache, no cache movement: the
    rank that owns slot ``cache_index`` writes the new k and v there (in
    place; no collective), and the ranks' partial softmaxes combine
    (``cp_decode_attention``).  q, k_new, v_new: (B, heads, 1, hd); the
    cache: this rank's (B, Hkv, S_loc, hd).  Returns the output, (B, H, 1,
    hd)."""
    line = SH.axis_mesh(SH.current_mesh(), axis)
    S_loc = cache_k.shape[2]
    li = cache_index - line.shard * S_loc
    if 0 <= li < S_loc:
        cache_k[:, :, li:li + 1] = k_new.to(cache_k.dtype)
        cache_v[:, :, li:li + 1] = v_new.to(cache_v.dtype)
    return cp_decode_attention(q, cache_k, cache_v, mesh=line,
                               kv_valid_len=cache_index + 1, window=window,
                               softcap=softcap, scale=scale)


def decode_attention(x, p: Attention, cfg, cache: dict, cache_index: int, *,
                     window=None, context_parallel: bool = False):
    """Single-token decode: write the cache at ``cache_index`` (in place)
    and attend.  x: (B, 1, d); cache k/v: (B, Hkv, S, hd), or this rank's
    sequence slice of it (:func:`init_kv_cache`).  Returns (out, cache)."""
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // Hkv
    positions = torch.full((B, 1), cache_index, dtype=torch.long,
                           device=x.device)
    q, k_new, v_new = _project_qkv(x, p, cfg, positions)
    axis = _cache_seq_axis(cfg, B, context_parallel)
    if axis is not None:
        out = _decode_attn_seq_sharded(
            q.transpose(1, 2), cache["k"], cache["v"], k_new.transpose(1, 2),
            v_new.transpose(1, 2), cache_index, axis=axis, window=window,
            softcap=cfg.attn_softcap, scale=hd ** -0.5)
        out = out.transpose(1, 2).reshape(B, 1, H * hd)
        out = L.linear(out.to(x.dtype), p.wo, L.dtype_of(cfg.compute_dtype))
        return out, cache
    k, v = cache["k"], cache["v"]
    k[:, :, cache_index:cache_index + 1] = k_new.transpose(1, 2).to(k.dtype)
    v[:, :, cache_index:cache_index + 1] = v_new.transpose(1, 2).to(v.dtype)

    qg = q.reshape(B, 1, Hkv, G, hd).float()
    s = torch.einsum("bqhgd,bhkd->bhgqk", qg, k.float()) * (hd ** -0.5)
    s = L.softcap(s, cfg.attn_softcap)
    kpos = torch.arange(k.shape[2], device=x.device)
    mask = kpos <= cache_index
    if window is not None:
        mask &= cache_index - kpos < window
    s = torch.where(mask, s, NEG_INF)
    pe = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bhgqk,bhkd->bhgqd", pe, v.float())
    out = out / pe.sum(-1, keepdim=True)
    out = out.reshape(B, H, 1, hd).transpose(1, 2).reshape(B, 1, H * hd)
    out = L.linear(out.to(x.dtype), p.wo, L.dtype_of(cfg.compute_dtype))
    return out, cache
