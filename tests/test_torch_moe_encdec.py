"""The MoE block, cross-attention, whisper's encoder, llava's image tokens,
the input specs and serving's default stubs: the port against the JAX
package, on the CPU, in float32 at ``reduced()`` size.

Tolerances: the MoE FFN within 1e-5 of max |y| (two float32 orders of the
router, the expert products and the sum over a token's k experts; a
routing that differs would move whole rows); attention and the encoder
within 1e-5 of max |out| (float32 orders); capacities and shapes exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import specs as JS
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import moe as JMO
from repro_torch import convert
from repro_torch.configs import ARCHS, SHAPES, specs
from repro_torch.launch import serve as S
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models import moe as MO

TOL = 1e-5
MOE_NAMES = ["qwen3-moe-30b-a3b", "arctic-480b"]


def _gen():
    return torch.Generator("cpu").manual_seed(0)


def _load(module, tree):
    """``module`` holding the numpy leaves of the reference subtree."""
    params = dict(module.named_parameters())
    names = set()
    for path, leaf in convert._leaves(tree):
        name = ".".join(path)
        params[name].copy_(torch.tensor(np.asarray(leaf)))
        names.add(name)
    assert names == set(params)
    return module


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _model(name, seed=0):
    cfg = ARCHS[name].reduced()
    tree = jax.tree.map(np.asarray, JM.init_params(
        jax.random.PRNGKey(seed), JARCHS[name].reduced()))
    return cfg, tree, convert.lm_params_from_reference(cfg, tree,
                                                       device="cpu")


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 2.0, 8.0])
@pytest.mark.parametrize("tokens", [1, 2, 7, 16, 17, 100, 512, 8192])
def test_capacity_matches_reference(tokens, cf):
    for k, E in ((1, 8), (2, 8), (2, 3), (2, 128), (8, 128)):
        assert (MO._capacity(tokens, k, E, cf)
                == JMO._capacity(tokens, k, E, cf)), (k, E)


@pytest.mark.parametrize("cf", [8.0, 1.0, 0.5])
@pytest.mark.parametrize("name", MOE_NAMES)
def test_moe_ffn_matches_reference(name, cf):
    """The reduced config's capacity factor 8 drops nothing; at 1.0 and 0.5
    over 512 tokens some experts overflow, and the dropped assignments must
    be the reference's."""
    cfg = dataclasses.replace(ARCHS[name].reduced(), capacity_factor=cf)
    jcfg = dataclasses.replace(JARCHS[name].reduced(), capacity_factor=cf)
    tree = jax.tree.map(np.asarray, JMO.init_moe(jax.random.PRNGKey(3), jcfg))
    moe = _load(MO.init_moe(_gen(), cfg), tree)
    x = np.random.default_rng(4).standard_normal((4, 128, cfg.d_model),
                                                 dtype=np.float32)
    want = JMO.moe_ffn(jnp.asarray(x), tree, jcfg)
    got = MO.moe_ffn(torch.as_tensor(x), moe, cfg)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= TOL
    T, k, E = 4 * 128, cfg.top_k, cfg.n_experts
    cap = MO._capacity(T, k, E, cf)
    _, _, slot = MO._route(torch.as_tensor(x).reshape(T, -1), moe.router,
                           top_k=k, capacity=cap)
    kept = int((slot < E * cap).sum())
    assert kept == T * k if cf == 8.0 else kept < T * k


def test_route_fills_each_expert_in_token_order():
    """Kept slots are distinct, each expert's first ``capacity`` assignments
    by token take slots 0, 1, ... of its group, and the rest are dropped."""
    cfg = ARCHS["qwen3-moe-30b-a3b"].reduced()
    moe = MO.init_moe(_gen(), cfg)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (300, cfg.d_model), dtype=np.float32))
    cap, E = 40, cfg.n_experts
    eid, gate, slot = MO._route(x, moe.router, top_k=cfg.top_k, capacity=cap)
    assert torch.allclose(gate.reshape(300, -1).sum(-1), torch.ones(300))
    for e in range(E):
        mine = torch.nonzero(eid == e).flatten()       # in token order
        want = torch.where(torch.arange(len(mine)) < cap,
                           e * cap + torch.arange(len(mine)), E * cap)
        assert torch.equal(slot[mine], want)


def test_arctic_layer_sums_moe_and_dense_residual():
    """arctic's layer has both ``moe`` and ``mlp``; qwen3's only ``moe``."""
    arctic = M.Layer(_gen(), ARCHS["arctic-480b"].reduced())
    qwen3 = M.Layer(_gen(), ARCHS["qwen3-moe-30b-a3b"].reduced())
    assert arctic.moe is not None and arctic.mlp is not None
    assert qwen3.moe is not None and qwen3.mlp is None
    cfg = ARCHS["arctic-480b"].reduced()
    h = torch.randn(2, 5, cfg.d_model, generator=_gen())
    want = (MO.moe_ffn(h, arctic.moe, cfg)
            + M.L.mlp(h, arctic.mlp, act=cfg.act,
                      compute_dtype=torch.float32))
    assert torch.equal(M._ffn(h, arctic, cfg), want)


# ---------------------------------------------------------------------------
# Cross-attention and whisper's encoder
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("override", [True, False], ids=["cross", "self"])
@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("name", ["whisper-large-v3", "qwen3-moe-30b-a3b"])
def test_noncausal_attention_matches_reference(name, impl, override):
    """Non-causal attention, over given keys and values (Sq 10, Skv 24) or
    the layer's own (the encoder's self-attention); qwen3 adds GQA,
    qk-norm and RoPE on q."""
    cfg, jcfg = ARCHS[name].reduced(), JARCHS[name].reduced()
    tree = jax.tree.map(np.asarray,
                        JA.init_attention(jax.random.PRNGKey(5), jcfg))
    attn = _load(A.init_attention(_gen(), cfg), tree)
    rng = np.random.default_rng(6)
    B, Sq, Skv = 2, 10, 24
    x = rng.standard_normal((B, Sq, cfg.d_model), dtype=np.float32)
    pos = np.tile(np.arange(Sq), (B, 1))
    kv = [rng.standard_normal((B, cfg.n_kv_heads, Skv, cfg.hd),
                              dtype=np.float32) for _ in range(2)]
    want, (wk, wv) = JA.attention(
        jnp.asarray(x), tree, jcfg, positions=jnp.asarray(pos), causal=False,
        impl=impl,
        kv_override=tuple(map(jnp.asarray, kv)) if override else None)
    tkv = tuple(map(torch.as_tensor, kv))
    got, (gk, gv) = A.attention(
        torch.as_tensor(x), attn, cfg, positions=torch.as_tensor(pos),
        causal=False, impl=impl, kv_override=tkv if override else None)
    assert _rel(got.numpy(), want) <= TOL
    if override:
        assert gk is tkv[0] and gv is tkv[1]
    else:
        assert _rel(gk.numpy(), wk) <= TOL and _rel(gv.numpy(), wv) <= TOL


def test_whisper_encoder_matches_reference():
    cfg, tree, model = _model("whisper-large-v3")
    jcfg = JARCHS["whisper-large-v3"].reduced()
    audio = 0.1 * np.random.default_rng(7).standard_normal(
        (2, cfg.audio_ctx, cfg.d_model), dtype=np.float32)
    want = JM._encode(tree, jcfg, {"audio_embeds": jnp.asarray(audio)})
    got = M._encode(model, cfg, {"audio_embeds": torch.as_tensor(audio)})
    assert _rel(got.numpy(), want) <= TOL
    wk, wv = JM._cross_kv_all_layers(tree, jcfg, want)
    kv = M._cross_kv_all_layers(model, cfg, got)
    assert len(kv) == cfg.n_layers
    for i, (k, v) in enumerate(kv):
        assert k.is_contiguous() and v.is_contiguous()
        assert _rel(k.numpy(), wk[i]) <= TOL and _rel(v.numpy(), wv[i]) <= TOL


def test_whisper_needs_its_audio():
    cfg, _, model = _model("whisper-large-v3")
    with pytest.raises(ValueError, match="audio_embeds"):
        M.forward(model, cfg, torch.zeros(1, 4, dtype=torch.long))


def test_whisper_cache_holds_the_cross_keys():
    cfg, _, model = _model("whisper-large-v3")
    cache = M.init_cache(cfg, 2, 12, device="cpu")
    assert tuple(cache[0]["xk"].shape) == (2, cfg.n_kv_heads, cfg.audio_ctx,
                                          cfg.hd)
    audio = torch.randn(2, cfg.audio_ctx, cfg.d_model, generator=_gen())
    _, cache = M.prefill(model, cfg, torch.zeros(2, 4, dtype=torch.long),
                         {"audio_embeds": audio}, max_len=12)
    kv = M._cross_kv_all_layers(model, cfg,
                                M._encode(model, cfg, {"audio_embeds": audio}))
    for c, (k, v) in zip(cache, kv):
        assert torch.equal(c["xk"], k) and torch.equal(c["xv"], v)


# ---------------------------------------------------------------------------
# llava's image tokens
# ---------------------------------------------------------------------------
def test_llava_forward_with_image_embeddings_matches_reference():
    """The image rows come first: (B, img_tokens + S, V), and they reach
    the text logits; without them the forward is text only, as in the
    reference."""
    name = "llava-next-mistral-7b"
    cfg, tree, model = _model(name)
    jcfg = JARCHS[name].reduced()
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, cfg.vocab, (2, 12))
    img = 0.1 * rng.standard_normal((2, cfg.img_tokens, cfg.d_model),
                                    dtype=np.float32)
    want = JM.forward(tree, jcfg, jnp.asarray(tokens, jnp.int32),
                      {"img_embeds": jnp.asarray(img)})
    got = M.forward(model, cfg, torch.as_tensor(tokens),
                    {"img_embeds": torch.as_tensor(img)})
    assert tuple(got.shape) == (2, cfg.img_tokens + 12, cfg.vocab)
    assert _rel(got.numpy(), want) <= 1e-4
    text = M.forward(model, cfg, torch.as_tensor(tokens))
    want_text = JM.forward(tree, jcfg, jnp.asarray(tokens, jnp.int32))
    assert tuple(text.shape) == (2, 12, cfg.vocab)
    assert _rel(text.numpy(), want_text) <= 1e-4
    assert float((got[:, cfg.img_tokens:] - text).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# Specs, conversion, serving's stubs
# ---------------------------------------------------------------------------
def _dtype_name(dt) -> str:
    return (str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype)
            else np.dtype(dt).name)


def _same_spec(got, want):
    if want is None:
        assert got is None
        return
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].device.type == "meta"
        assert tuple(got[key].shape) == tuple(w.shape), key
        assert _dtype_name(got[key].dtype) == _dtype_name(w.dtype), key


@pytest.mark.parametrize("name", list(JARCHS))
def test_extra_specs_match_reference(name):
    _same_spec(specs.extra_specs(ARCHS[name], 3),
               JS.extra_specs(JARCHS[name], 3))


@pytest.mark.parametrize("cell", list(JSHAPES))
@pytest.mark.parametrize("name", list(JARCHS))
def test_input_specs_match_reference(name, cell):
    """Shapes of every input of every cell; the port's decode cache is one
    dict a layer where the reference stacks the layers on a leading axis."""
    got = specs.input_specs(ARCHS[name], SHAPES[cell])
    want, _ = JS.input_specs(JARCHS[name], JSHAPES[cell])
    assert set(got) == set(want)
    if SHAPES[cell].kind == "decode":
        assert tuple(got["tokens"].shape) == want["tokens"].shape
        assert tuple(got["index"].shape) == want["index"].shape == ()
        L = ARCHS[name].n_layers
        assert len(got["cache"]) == L
        for layer in got["cache"]:
            assert set(layer) == set(want["cache"])
            for key, w in want["cache"].items():
                assert (L,) + tuple(layer[key].shape) == w.shape, key
                assert layer[key].device.type == "meta"
                assert _dtype_name(layer[key].dtype) == _dtype_name(w.dtype)
        return
    batch = got["batch"] if "batch" in got else got
    wbatch = want["batch"] if "batch" in want else want
    assert tuple(batch["tokens"].shape) == wbatch["tokens"].shape
    _same_spec(got["extra"], want["extra"])


@pytest.mark.parametrize("fault", ["count", "shape", "missing"])
def test_convert_rejects_a_bad_encoder_stack(fault):
    cfg, tree, _ = _model("whisper-large-v3")
    if fault == "count":
        tree["enc_layers"] = jax.tree.map(lambda a: a[:1], tree["enc_layers"])
        match = "enc_layers.* stacks 1 layers, cfg has 2"
    elif fault == "shape":
        tree["enc_pos"] = tree["enc_pos"][:-1]
        match = "enc_pos has shape"
    else:
        del tree["enc_final_norm"]
        match = "enc_final_norm"
    with pytest.raises(ValueError, match=match):
        convert.lm_params_from_reference(cfg, tree, device="cpu")


@pytest.mark.parametrize("name", ["llava-next-mistral-7b", "whisper-large-v3"])
def test_serve_defaults_to_zero_stubs_of_the_reference_shape(name,
                                                             monkeypatch):
    cfg = ARCHS[name].reduced()
    seen = {}
    prefill = M.prefill

    def spy(params, cfg_, tokens, extra=None, *, max_len):
        seen.update(extra=extra, max_len=max_len)
        return prefill(params, cfg_, tokens, extra, max_len=max_len)

    monkeypatch.setattr(M, "prefill", spy)
    tokens, _ = S.serve(cfg, batch=2, prompt_len=8, gen=3, device="cpu")
    want = JS.extra_specs(JARCHS[name].reduced(), 2)
    assert set(seen["extra"]) == set(want)
    for key, w in want.items():
        t = seen["extra"][key]
        assert tuple(t.shape) == w.shape
        assert _dtype_name(t.dtype) == _dtype_name(w.dtype)
        assert not t.any()
    assert seen["max_len"] == (cfg.img_tokens or 0) + 8 + 3
    zeros = {k: torch.zeros_like(t) for k, t in seen["extra"].items()}
    again, _ = S.serve(cfg, batch=2, prompt_len=8, gen=3, device="cpu",
                       extra=zeros)
    assert torch.equal(tokens, again)
