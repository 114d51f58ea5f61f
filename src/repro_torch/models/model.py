"""The LM of the port: every block kind of the reference, for serving and
training.

Block kinds (static per arch): ``dense`` (attention + MLP), ``moe``
(attention + MoE, plus a parallel dense MLP for arctic), ``rwkv`` (RWKV6
time/channel mix) and ``hymba`` (attention and a Mamba path in parallel,
then the MLP).  Whisper wraps a non-causal encoder stack, over stub frame
embeddings, plus a decoder stack with cross-attention to it; LLaVA prepends
stub patch embeddings to the token embeddings.  Learned positions
(whisper) are added after the embedding.

The port of the reference's ``models/model.py``.  The reference stacks
per-layer params on a leading L axis and scans over window-pattern groups;
here the model is an ``nn.Module`` with a ``ModuleList`` of layers (and of
encoder layers), and layer i takes window ``pattern[i % p]`` of
``cfg.window_pattern()`` (which still requires the period p to divide
``n_layers``).  Attribute names follow the reference's pytree keys.

Entry points (the reference's signatures, with ``params`` the module):
  * ``init_params(gen, cfg)``                 — weights from a
    ``torch.Generator``, on its device
  * ``forward(params, cfg, tokens, extra)``   — full-sequence logits
  * ``loss_fn(params, cfg, batch, extra)``    — next-token cross entropy
    plus the z-loss, an f32 scalar
  * ``init_cache(cfg, batch, max_len, device=...)`` — per-layer caches
  * ``prefill(params, cfg, tokens, extra, max_len=...)`` — fill the cache,
    last-position logits
  * ``decode_step(params, cfg, tok, cache, index)`` — one-token decode

Cut parameters (:func:`hold_cut`).  Under a mesh the model may hold each
leaf as this rank's block of its spec (FSDP over ``data``, TP over
``model``: the train :func:`param_specs`; the dry run also holds serving
layouts), gathered whole where a layer uses it (:func:`gathered`; the
embedding and the head where they are read): inside the remat group, so
the backward gathers again and no whole leaf outlives its group, the FSDP
pattern.  A gathered leaf's gradient comes back as the block, summed over
the batch axes (``sharding.gather_leaf``).  The axes :func:`run_specs`
keeps (the experts over ``model``) stay cut.  Dense layers compute whole on
every rank of ``model``: tensor-parallel compute is not ported (ROADMAP
item 19).

``extra`` holds the modality stubs: ``img_embeds`` (B, img_tokens, d) for
llava, ``audio_embeds`` (B, audio_ctx, d) for whisper
(``configs/specs.extra_specs``).  Training differentiates ``loss_fn`` with
autograd: K13 and K14 carry their gradients through
``kernels/autograd.py``.  Remat: with ``cfg.remat`` set and a gradient
wanted, each window-pattern group of layers (whisper's encoder and decoder
stacks included) runs under ``torch.utils.checkpoint.checkpoint``
(non-reentrant), which keeps only the group's input and recomputes its
forward in the backward pass, the counterpart of the reference's
``jax.checkpoint`` with ``nothing_saveable``.

Sharding.  The reference's ``constrain`` calls stand where they stand there
(identities without a mesh, and on the port's plain tensors:
``distributed/sharding.py``).  Under an active mesh the model runs its
explicit branches: sequence-sharded prefill attention and sequence-sharded
or context-parallel decode (``models/attention.py``; ``init_cache``,
``prefill`` and ``decode_step`` take ``context_parallel``) and the
expert-parallel MoE (``models/moe.py``).  :func:`param_specs` is the
reference's spec of every parameter (train, or ``serve=True``), by
parameter name; :func:`run_specs` the part of it the port's branches take
— each MoE expert tensor's expert axis over ``model``, everything else
replicated, since without GSPMD a dense weight is used whole — and
``convert.shard_params`` cuts a full model to one rank's shards by either.
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import RULES, P, constrain, mesh_axes
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MO
from repro_torch.models import rwkv6 as R
from repro_torch.models import ssm as SM

__all__ = ["Layer", "LM", "init_params", "forward", "loss_fn", "init_cache",
           "prefill", "decode_step", "param_specs", "run_specs", "hold_cut",
           "cut_layout", "gathered"]


def _norm(x, p, cfg):
    if cfg.norm == "layernorm":
        return L.layer_norm(x, p, eps=cfg.norm_eps)
    return L.rms_norm(x, p, eps=cfg.norm_eps, plus_one=cfg.scale_embed)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
class Layer(nn.Module):
    """One layer; ``cross`` adds whisper's decoder cross-attention
    (``norm_x``, ``xattn``)."""

    def __init__(self, gen: torch.Generator, cfg, *, cross: bool = False):
        super().__init__()
        dt = L.dtype_of(cfg.param_dtype)
        bias = cfg.norm == "layernorm"

        def norm():
            return L.Norm(cfg.d_model, bias=bias, dtype=dt, device=gen.device)

        self.norm1 = norm()
        self.norm2 = norm()
        if cfg.block == "rwkv":
            self.rwkv = R.init_rwkv6(gen, cfg)
            return
        self.attn = A.init_attention(gen, cfg)
        if cfg.sandwich_norm:
            self.norm1b = norm()
            self.norm2b = norm()
        if cross:
            self.norm_x = norm()
            self.xattn = A.init_attention(gen, cfg)
        self.moe = MO.init_moe(gen, cfg) if cfg.block == "moe" else None
        self.mlp = (L.MLP(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated,
                          dtype=dt)
                    if cfg.block != "moe" or cfg.dense_residual else None)
        if cfg.block == "hymba":
            self.mamba = SM.init_mamba(gen, cfg)
            self.norm_attn_out = L.Norm(cfg.d_model, dtype=dt,
                                        device=gen.device)
            self.norm_ssm_out = L.Norm(cfg.d_model, dtype=dt,
                                       device=gen.device)


class LM(nn.Module):
    def __init__(self, gen: torch.Generator, cfg):
        super().__init__()
        dt = L.dtype_of(cfg.param_dtype)
        d, V = cfg.d_model, cfg.vocab
        bias = cfg.norm == "layernorm"
        self.embed = L.normal(gen, (V, d), 0.02, dt)
        self.final_norm = L.Norm(d, bias=bias, dtype=dt, device=gen.device)
        cross = cfg.enc_layers > 0
        self.layers = nn.ModuleList(Layer(gen, cfg, cross=cross)
                                    for _ in range(cfg.n_layers))
        self.lm_head = (None if cfg.tie_embeddings
                        else L.normal(gen, (V, d), 0.02, dt))
        self.pos_embed = (L.normal(gen, (32768, d), 0.02, dt)
                          if cfg.pos_emb == "learned" else None)
        if cfg.enc_layers:
            self.enc_layers = nn.ModuleList(Layer(gen, cfg)
                                            for _ in range(cfg.enc_layers))
            self.enc_pos = L.normal(gen, (max(cfg.audio_ctx, 1), d), 0.02, dt)
            self.enc_final_norm = L.Norm(d, bias=bias, dtype=dt,
                                         device=gen.device)


def init_params(gen: torch.Generator, cfg) -> LM:
    """The model with weights drawn from ``gen``, on ``gen``'s device, in
    ``cfg.param_dtype`` (the reference's distributions, not its values).
    ``gen`` may be ``layers.MetaGen()``: the model's shapes and dtypes on
    ``torch.device("meta")``, nothing drawn (the dry run)."""
    return LM(gen, cfg)


def _windows(cfg, n: int) -> list:
    pattern = cfg.window_pattern()
    return [pattern[i % len(pattern)] for i in range(n)]


# ---------------------------------------------------------------------------
# Cut parameters: held as this rank's blocks, gathered where they are used
# ---------------------------------------------------------------------------
def _summed(mesh) -> tuple:
    """The axes over which a gathered leaf's gradient is summed: the batch
    axes, whose ranks hold different rows."""
    sizes = mesh_axes(mesh)
    return tuple(a for a in RULES.dp if sizes.get(a, 1) > 1)


def _leaf(module, name: str):
    """``module``'s parameter ``name``, gathered whole where it is held cut
    (:func:`hold_cut`)."""
    t = getattr(module, name)
    cut = getattr(module, "_gather", None)
    if cut is None or name not in cut[1]:
        return t
    mesh, specs = cut
    return SH.gather_leaf(t, specs[name], mesh, _summed(mesh))


def gathered(module):
    """Inside the block, each parameter of ``module`` (a :class:`Layer`)
    held cut reads as the whole leaf (``sharding.gather_leaf``), outside
    it as this rank's block.  A no-op for a module held whole."""
    cut = getattr(module, "_gather", None)
    if cut is None:
        return contextlib.nullcontext()
    mesh, specs = cut
    summed = _summed(mesh)
    return SH.swap_leaves(module, lambda name, t: SH.gather_leaf(
        t, specs[name], mesh, summed) if name in specs else None)


def _gather_spec(hold, use) -> P:
    """The part of ``hold`` that a run gathers to reach ``use``: each
    dimension's axes, less those ``use`` keeps."""
    return P(*(h if u is None else None for h, u in zip(hold, use)))


def hold_cut(params: "LM", cfg, mesh, specs: dict | None = None) -> dict:
    """Hold ``params`` (whole, on every rank) cut, in place: each leaf as
    this rank's ``sharding.shard_block`` of it by ``specs`` (default the
    train :func:`param_specs`: FSDP over 'data', and 'pod' where
    ``RULES.fsdp_pod``, TP over 'model'), gathered whole where a layer uses
    it (:func:`gathered`, inside the remat group, so that the backward
    gathers again and no whole leaf outlives its group), except for the
    axes :func:`run_specs` keeps cut (the experts over 'model').  Returns
    the specs the leaves are held by."""
    if specs is None:
        specs = param_specs(cfg, params, mesh)
    use = run_specs(cfg, params, mesh)
    shapes = {n: tuple(t.shape) for n, t in params.named_parameters()}
    gather = {}
    for name, t in list(params.named_parameters()):
        block = SH.shard_block(t, specs[name], mesh)
        if block is not t:
            owner, _, attr = name.rpartition(".")
            # a copy of its own: a view would keep the whole leaf alive
            params.get_submodule(owner)._parameters[attr] = nn.Parameter(
                block.clone(memory_format=torch.contiguous_format),
                requires_grad=t.requires_grad)
        g = _gather_spec(specs[name], use[name])
        if SH._cuts(g, mesh):
            gather[name] = g
    # each layer gathers its own leaves; the root its direct ones
    for prefix, module in params.named_modules():
        if not isinstance(module, (Layer, LM)):
            continue
        mine = {}
        for name, g in gather.items():
            if isinstance(module, LM):
                if "." not in name:
                    mine[name] = g
            elif name.startswith(prefix + "."):
                mine[name[len(prefix) + 1:]] = g
        module._gather = (mesh, mine) if mine else None
    params._cut = (mesh, specs, shapes)
    return specs


def cut_layout(params: "LM"):
    """``(mesh, specs, whole shapes)`` of a model held cut
    (:func:`hold_cut`), else None."""
    return getattr(params, "_cut", None)


# ---------------------------------------------------------------------------
# Layer bodies
# ---------------------------------------------------------------------------
def _mix_paths(ao, so, lp: Layer, cfg):
    """hymba: the mean of the rms-normed attention and SSM outputs."""
    return 0.5 * (L.rms_norm(ao, lp.norm_attn_out, eps=cfg.norm_eps)
                  + L.rms_norm(so, lp.norm_ssm_out, eps=cfg.norm_eps))


def _ffn(h, lp: Layer, cfg):
    """The layer's feed-forward part on the normed stream h: the MLP, or
    the MoE (plus the MLP where the config has a dense residual)."""
    cdt = L.dtype_of(cfg.compute_dtype)
    ff = None if lp.moe is None else MO.moe_ffn(h, lp.moe, cfg)
    if lp.mlp is not None:
        y = L.mlp(h, lp.mlp, act=cfg.act, compute_dtype=cdt)
        ff = y if ff is None else ff + y
    if cfg.sandwich_norm:
        ff = _norm(ff, lp.norm2b, cfg)
    return ff


def _attn_layer(x, lp: Layer, cfg, *, positions, window, causal=True,
                cross=None):
    """One full-sequence dense, moe or hymba layer, with cross-attention to
    ``cross`` = (k, v), each (B, Hkv, Skv, hd), where given.  Returns the
    new residual stream, the layer's (k, v) and, for hymba, its SSM cache
    (the conv tail and the scan's last state; else None)."""
    h = _norm(x, lp.norm1, cfg)
    ao, kv = A.attention(h, lp.attn, cfg, positions=positions, window=window,
                         causal=causal, impl=cfg.attn_impl)
    ao = constrain(ao, RULES.act_btd())
    ssm = None
    if cfg.block == "hymba":
        so, tail, hT = SM._mamba_core(h, lp.mamba, cfg)
        ao = _mix_paths(ao, so.to(h.dtype), lp, cfg)
        ssm = {"conv": tail, "h": hT}
    if cfg.sandwich_norm:
        ao = _norm(ao, lp.norm1b, cfg)
    x = x + ao
    if cross is not None:
        h = _norm(x, lp.norm_x, cfg)
        xo, _ = A.attention(h, lp.xattn, cfg, positions=positions,
                            causal=False, impl=cfg.attn_impl,
                            kv_override=cross)
        x = x + constrain(xo, RULES.act_btd())
    h = _norm(x, lp.norm2, cfg)
    return constrain(x + _ffn(h, lp, cfg), RULES.act_btd()), kv, ssm


def _embed(params: LM, cfg, tokens, extra=None, pos0: int = 0):
    """Token embeddings, with llava's image embeddings prepended and
    learned positions from ``pos0`` on added.  Returns (B, img_tokens + S,
    d)."""
    x = _leaf(params, "embed")[tokens].to(L.dtype_of(cfg.compute_dtype))
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    if cfg.img_tokens and extra is not None and "img_embeds" in extra:
        x = torch.cat([extra["img_embeds"].to(x.dtype), x], dim=1)
    if cfg.pos_emb == "learned":
        x = x + _leaf(params, "pos_embed")[pos0:pos0 + x.shape[1]].to(
            x.dtype)
    return constrain(x, RULES.act_btd())


def _vocab_spec(cfg) -> P:
    return P(RULES.dp, None, RULES.div(cfg.vocab, RULES.tp))


def _head(params: LM, cfg):
    return _leaf(params, "embed" if cfg.tie_embeddings else "lm_head")


def _logits(params: LM, cfg, x, head=None):
    head = _head(params, cfg) if head is None else head
    logits = x @ head.to(x.dtype).T
    return constrain(L.softcap(logits.float(), cfg.logit_softcap),
                     _vocab_spec(cfg))


def _positions(x):
    B, S, _ = x.shape
    return torch.arange(S, device=x.device).expand(B, S)


def _run_stack(x, layers, cfg, *, positions, causal=True, cross=None):
    """The full-sequence layers in order (window ``pattern[i % p]`` for
    layer i, cross-attention ``cross[i]`` where given), by window-pattern
    groups of p layers; with ``cfg.remat`` and a gradient wanted, each
    group under ``checkpoint`` (module docstring)."""
    n = len(layers)
    windows = _windows(cfg, n)
    cross = [None] * n if cross is None else cross
    p = len(cfg.window_pattern())

    def group(x, lo):
        for i in range(lo, min(lo + p, n)):
            lp = layers[i]
            with gathered(lp):
                if cfg.block == "rwkv":
                    x = R.rwkv6_block(x, lp.rwkv, cfg, lp.norm1, lp.norm2)
                else:
                    x, _, _ = _attn_layer(x, lp, cfg, positions=positions,
                                          window=windows[i], causal=causal,
                                          cross=cross[i])
        return constrain(x, RULES.act_btd())

    remat = cfg.remat and torch.is_grad_enabled()
    for lo in range(0, n, p):
        x = (checkpoint(group, x, lo, use_reentrant=False) if remat
             else group(x, lo))
    return x


def _encode(params: LM, cfg, extra):
    """Whisper's encoder on stub frame embeddings (B, audio_ctx, d): learned
    positions, the non-causal stack, the final norm."""
    if extra is None or "audio_embeds" not in extra:
        raise ValueError(f"{cfg.name} needs extra['audio_embeds'] of shape "
                         f"(batch, {cfg.audio_ctx}, {cfg.d_model})")
    x = extra["audio_embeds"].to(L.dtype_of(cfg.compute_dtype))
    x = x + _leaf(params, "enc_pos")[:x.shape[1]].to(x.dtype)
    x = _run_stack(x, params.enc_layers, cfg, positions=_positions(x),
                   causal=False)
    return _norm(x, params.enc_final_norm, cfg)


def _cross_kv_all_layers(params: LM, cfg, enc_out) -> list:
    """Each decoder layer's cross-attention (k, v) of the encoder's output,
    (B, Hkv, Se, hd) each, contiguous."""
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    B, Se, _ = enc_out.shape
    cdt = L.dtype_of(cfg.compute_dtype)

    def heads(w):
        return (L.linear(enc_out, w, cdt).reshape(B, Se, Hkv, hd)
                .transpose(1, 2).contiguous())

    out = []
    for lp in params.layers:
        with gathered(lp):
            out.append((heads(lp.xattn.wk), heads(lp.xattn.wv)))
    return out


def _cross(params: LM, cfg, extra) -> list:
    """Per decoder layer: its cross-attention (k, v), or None."""
    if not cfg.enc_layers:
        return [None] * cfg.n_layers
    return _cross_kv_all_layers(params, cfg, _encode(params, cfg, extra))


# ---------------------------------------------------------------------------
# Public: full-sequence forward
# ---------------------------------------------------------------------------
def forward(params: LM, cfg, tokens, extra=None):
    """Full-sequence logits.  tokens: (B, S_text); returns (B, S_total, V)
    float32, S_total counting llava's image tokens."""
    x = _embed(params, cfg, tokens, extra)
    x = _run_stack(x, params.layers, cfg, positions=_positions(x),
                   cross=_cross(params, cfg, extra))
    x = _norm(x, params.final_norm, cfg)
    return _logits(params, cfg, x)


# logits beyond this many bytes (f32) are made and reduced a chunk of tokens
# at a time under checkpoint (loss_fn)
LOSS_CHUNK_BYTES = 4 << 30


def loss_fn(params: LM, cfg, batch, extra=None):
    """Next-token cross entropy plus a 1e-4 z-loss over ``batch["tokens"]``
    (B, S) integer tokens: the mean of ``logz - logit[target]`` and of
    ``logz ** 2`` over the B x (S - 1) predicted positions (with llava's
    image tokens first, the text logits are the tail).  Returns an f32
    scalar.  The picked logit is a ``torch.gather``: the same function as
    the reference's masked sum over the vocabulary, which exists for its
    vocab-sharded layout.  Where the f32 logits would pass
    :data:`LOSS_CHUNK_BYTES` and a gradient is wanted, they are made,
    reduced and freed a chunk of tokens at a time, each chunk under
    ``checkpoint`` (the backward makes its chunk again): the same function
    summed in another order, in the memory of one chunk (the reference's
    vocab-sharded logits are 1/16 of the whole on its production
    meshes)."""
    tokens = batch["tokens"]
    n = tokens.shape[1] - 1
    targets = tokens[:, 1:].long()
    if not (torch.is_grad_enabled() and tokens.shape[0] * n * cfg.vocab * 4
            > LOSS_CHUNK_BYTES):
        logits = forward(params, cfg, tokens[:, :-1], extra)
        logits = constrain(logits[:, -n:], _vocab_spec(cfg))
        nll, z2 = _nll_z2(logits, targets)
        return (nll.mean() + 1e-4 * z2.mean()).float()
    x = _embed(params, cfg, tokens[:, :-1], extra)
    x = _run_stack(x, params.layers, cfg, positions=_positions(x),
                   cross=_cross(params, cfg, extra))
    x = x[:, -n:].reshape(-1, x.shape[-1])
    t = targets.reshape(-1)
    rows = max(1, LOSS_CHUNK_BYTES // 4 // (cfg.vocab * 4))
    head = _head(params, cfg)           # gathered once, not a chunk

    def chunk(xc, tc):
        logits = _logits(params, cfg, _norm(xc, params.final_norm, cfg),
                         head)
        nll, z2 = _nll_z2(logits, tc)
        return torch.stack([nll.sum(), z2.sum()])

    total = sum(checkpoint(chunk, x[i:i + rows], t[i:i + rows],
                           use_reentrant=False)
                for i in range(0, x.shape[0], rows))
    return (total[0] / t.numel() + 1e-4 * total[1] / t.numel()).float()


def _nll_z2(logits, targets):
    """Each position's ``logz - logit[target]`` and ``logz ** 2``."""
    picked = torch.gather(logits, -1, targets[..., None])[..., 0]
    logz = torch.logsumexp(logits, dim=-1)
    return logz - picked, logz ** 2


# ---------------------------------------------------------------------------
# Public: serving (prefill + decode)
# ---------------------------------------------------------------------------
def init_cache(cfg, batch: int, max_len: int, *, device,
               context_parallel: bool = False) -> list[dict]:
    """Per-layer caches (zeros): KV caches of ``max_len`` slots for
    attention layers (with whisper's cross-attention ``xk`` and ``xv`` of
    ``audio_ctx`` slots), recurrent caches for rwkv layers, both for hymba
    layers.  Under a mesh that shards the KV cache's sequence, this rank's
    ``max_len / size`` slots of it (``attention.init_kv_cache``)."""
    if cfg.block == "rwkv":
        return [R.init_rwkv6_cache(cfg, batch, device=device)
                for _ in range(cfg.n_layers)]
    cdt = L.dtype_of(cfg.compute_dtype)
    caches = [A.init_kv_cache(cfg, batch, max_len, device=device,
                              context_parallel=context_parallel)
              for _ in range(cfg.n_layers)]
    for c in caches:
        if cfg.block == "hymba":
            c.update(SM.init_mamba_cache(cfg, batch, device=device))
        if cfg.enc_layers:
            shape = (batch, cfg.n_kv_heads, max(cfg.audio_ctx, 1), cfg.hd)
            c["xk"] = torch.zeros(shape, dtype=cdt, device=device)
            c["xv"] = torch.zeros(shape, dtype=cdt, device=device)
    return caches


def _cross_decode(x, lp: Layer, cfg, cache_l):
    """One token's cross-attention to the cached encoder keys and values:
    plain f32 einsums, as in the reference."""
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cdt = L.dtype_of(cfg.compute_dtype)
    h = _norm(x, lp.norm_x, cfg)
    q = L.linear(h, lp.xattn.wq, cdt)
    qg = q.reshape(B, 1, Hkv, H // Hkv, hd).float()
    s = torch.einsum("bqhgd,bhkd->bhgqk", qg,
                     cache_l["xk"].float()) * (hd ** -0.5)
    pe = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", pe, cache_l["xv"].float())
    o = o.reshape(B, H, 1, hd).transpose(1, 2).reshape(B, 1, H * hd)
    return x + L.linear(o.to(x.dtype), lp.xattn.wo, cdt)


def _decode_layer(x, lp: Layer, cfg, cache_l, index, window,
                  context_parallel=False):
    if cfg.block == "rwkv":
        return R.rwkv6_decode(x, lp.rwkv, cfg, cache_l, lp.norm1, lp.norm2)
    h = _norm(x, lp.norm1, cfg)
    ao, cache_l = A.decode_attention(h, lp.attn, cfg, cache_l, index,
                                     window=window,
                                     context_parallel=context_parallel)
    if cfg.block == "hymba":
        so, sc = SM.mamba_decode(h, lp.mamba, cfg, cache_l)
        ao = _mix_paths(ao, so, lp, cfg)
        cache_l["conv"], cache_l["h"] = sc["conv"], sc["h"]
    if cfg.sandwich_norm:
        ao = _norm(ao, lp.norm1b, cfg)
    x = x + ao
    if cfg.enc_layers:
        x = _cross_decode(x, lp, cfg, cache_l)
    h = _norm(x, lp.norm2, cfg)
    return x + _ffn(h, lp, cfg), cache_l


def decode_step(params: LM, cfg, tokens, cache, index: int, *,
                context_parallel: bool = False):
    """One decode step.  tokens: (B, 1); ``index``: the position of the new
    token (counting llava's image tokens).  Returns (logits (B, 1, V),
    cache); KV caches are updated in place."""
    x = _embed(params, cfg, tokens, pos0=index)
    new_cache = []
    for lp, cache_l, window in zip(params.layers, cache,
                                   _windows(cfg, cfg.n_layers)):
        with gathered(lp):
            x, nc = _decode_layer(x, lp, cfg, cache_l, index, window,
                                  context_parallel)
        new_cache.append(nc)
    x = _norm(x, params.final_norm, cfg)
    return _logits(params, cfg, x), new_cache


def prefill(params: LM, cfg, tokens, extra=None, *, max_len: int,
            context_parallel: bool = False):
    """Run the full prompt (after llava's image tokens; whisper's encoder
    first), build the cache, return last-position logits (B, 1, V) and the
    cache."""
    B = tokens.shape[0]
    x = _embed(params, cfg, tokens, extra)
    S = x.shape[1]
    cache = []
    if cfg.block == "rwkv":
        for lp in params.layers:
            with gathered(lp):
                h = L.rms_norm(x, lp.norm1, eps=cfg.norm_eps)
                out, s_new = R._time_mix(h, R._shift(h), lp.rwkv, cfg,
                                         return_state=True)
                x = x + out
                h2 = L.rms_norm(x, lp.norm2, eps=cfg.norm_eps)
                x = x + R._channel_mix(h2, R._shift(h2), lp.rwkv)
            cache.append({"tm_x": h[:, -1:], "cm_x": h2[:, -1:],
                          "state": s_new})
    else:
        positions = _positions(x)
        cache = init_cache(cfg, B, max_len, device=tokens.device,
                           context_parallel=context_parallel)
        cross = _cross(params, cfg, extra)
        spec = (RULES.kv_cache_cp(cfg.n_kv_heads) if context_parallel
                else RULES.kv_cache(cfg.n_kv_heads))
        for lp, cache_l, window, ckv in zip(
                params.layers, cache, _windows(cfg, cfg.n_layers), cross):
            with gathered(lp):
                x, (k, v), ssm = _attn_layer(x, lp, cfg, positions=positions,
                                             window=window, cross=ckv)
            A.fill_kv_cache(cfg, cache_l, k, v,
                            context_parallel=context_parallel)
            cache_l["k"] = constrain(cache_l["k"], spec)
            cache_l["v"] = constrain(cache_l["v"], spec)
            if ssm is not None:
                cache_l["conv"] = ssm["conv"].to(cache_l["conv"].dtype)
                cache_l["h"] = ssm["h"]
            if ckv is not None:
                cache_l["xk"] = ckv[0].to(cache_l["xk"].dtype)
                cache_l["xv"] = ckv[1].to(cache_l["xv"].dtype)
    x = _norm(x, params.final_norm, cfg)
    return _logits(params, cfg, x[:, -1:]), cache


# ---------------------------------------------------------------------------
# Parameter sharding specs
# ---------------------------------------------------------------------------
def _named(params) -> dict:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_specs(cfg, params, mesh, *, serve: bool = False) -> dict:
    """``{parameter name: P}`` for the model ``params`` (an :class:`LM`, or
    a ``{name: tensor}`` mapping) on ``mesh`` (a ``DeviceMesh`` or an
    ``AbstractMesh``): the reference's ``param_specs``, leaf by leaf, less
    its leading ``None`` for the stacked layer axis (the port keeps one
    module a layer).

    Train mode: FSDP over 'data' (+ 'pod' when ``RULES.fsdp_pod``), TP over
    'model'; dims shard only when divisible.  ``serve=True`` drops FSDP
    (weights replicated over the batch axes, TP only)."""
    sizes = mesh_axes(mesh)

    def div(dim, axes):
        if axes is None:
            return None
        ax = (axes,) if isinstance(axes, str) else tuple(axes)
        sz = 1
        for a in ax:
            sz *= sizes.get(a, 1)
        return (axes if dim % sz == 0 else None) if sz > 1 else None

    fsdp = None if serve else RULES.fsdp_axes
    tp = RULES.tp

    def spec_for(keys, shape):
        core = tuple(shape)
        name = keys[-1]
        parent = keys[-2] if len(keys) > 1 else ""

        def out(*entries):
            entries = tuple(entries[:len(core)])
            return P(*(entries + (None,) * (len(core) - len(entries))))

        if name in ("embed", "lm_head"):
            return P(div(shape[0], tp), div(shape[1], fsdp))
        if name in ("pos_embed", "enc_pos"):
            return P(None, div(shape[1], fsdp))
        if len(core) == 0:
            return P()
        # MoE expert tensors: (E, d_in, d_out)
        if parent == "moe" and len(core) == 3:
            if name == "w_out":
                return out(div(core[0], tp), None, div(core[2], fsdp))
            return out(div(core[0], tp), div(core[1], fsdp), None)
        if parent == "moe" and name == "router":
            return out(div(core[0], fsdp), None)
        # Linear weights by role
        if name == "w" or (len(core) == 2 and name in (
                "in_proj", "x_proj", "dt_proj", "out_proj", "mix_A", "w_A",
                "w_B", "mix_B", "A_log", "conv_w", "router")):
            d_in, d_out = core[-2], core[-1]
            out_side = parent in ("wo", "w_out", "cm_wv") or name == "out_proj"
            if out_side:
                return out(div(d_in, tp), div(d_out, fsdp))
            return out(div(d_in, fsdp), div(d_out, tp))
        if len(core) == 1:
            return out(None)
        return out(*([None] * len(core)))

    return {name: spec_for(name.split("."), t.shape)
            for name, t in _named(params).items()}


def run_specs(cfg, params, mesh) -> dict:
    """The specs a sharded run of the port takes (module docstring): the
    serving :func:`param_specs` with each MoE expert tensor's expert axis
    kept and every other entry None."""
    def keep(name, spec):
        if len(spec) == 3 and name.split(".")[-2] == "moe":
            return P(spec[0], None, None)
        return P(*([None] * len(spec)))

    return {name: keep(name, spec) for name, spec in
            param_specs(cfg, params, mesh, serve=True).items()}
