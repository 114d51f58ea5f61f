"""The LM serving slice of the port against the JAX package, on the CPU.

All ten architectures at ``reduced()`` size (float32; hymba with its Mamba
path and both paths' norms, the moe models with their experts, whisper with
its encoder and cross-attention, llava with its image tokens): the
reference's weights carried across by ``convert.lm_params_from_reference``,
the same prompts and modality stubs (numpy, from a seed; the stubs 0.1 x
N(0, 1), as the reference's tests/test_models.py makes them), the
reference's ``prefill`` + ``decode_step`` greedy loop against the port's
``serve``.  Tolerance: logits within 1e-4 of max |logit| at every step
(float32 round-off of two evaluation orders); greedy tokens identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import ARCHS, get
from repro_torch.kernels import _build
from repro_torch.launch import serve as S
from repro_torch.models import model as M

NAMES = list(JARCHS)
LOGIT_TOL = 1e-4           # relative to max |logit|
B, PROMPT, GEN = 2, 24, 6  # prompt > gemma2's reduced window of 16


def _weights(name, seed=0):
    cfg = ARCHS[name].reduced()
    tree = JM.init_params(jax.random.PRNGKey(seed), JARCHS[name].reduced())
    model = convert.lm_params_from_reference(
        cfg, jax.tree.map(np.asarray, tree), device="cpu")
    return cfg, tree, model


def _prompts(cfg, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, PROMPT))


def _extra(cfg, seed=2):
    """The modality stubs as numpy float32, 0.1 x N(0, 1), or None."""
    rng = np.random.default_rng(seed)
    if cfg.img_tokens:
        return {"img_embeds": 0.1 * rng.standard_normal(
            (B, cfg.img_tokens, cfg.d_model), dtype=np.float32)}
    if cfg.enc_layers:
        return {"audio_embeds": 0.1 * rng.standard_normal(
            (B, cfg.audio_ctx, cfg.d_model), dtype=np.float32)}
    return None


def _as(extra, to):
    return None if extra is None else {k: to(v) for k, v in extra.items()}


def _jax_greedy(name, tree, prompts, extra):
    cfg = JARCHS[name].reduced()
    off = cfg.img_tokens or 0
    prefill = jax.jit(lambda p, t, e: JM.prefill(p, cfg, t, e,
                                                 max_len=off + PROMPT + GEN))
    step = jax.jit(lambda p, t, c, i: JM.decode_step(p, cfg, t, c, i))
    logits, cache = prefill(tree, jnp.asarray(prompts, jnp.int32),
                            _as(extra, jnp.asarray))
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    toks, picked = [tok], [logits[:, -1]]
    for i in range(GEN - 1):
        logits, cache = step(tree, tok, cache,
                             jnp.asarray(off + PROMPT + i, jnp.int32))
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        toks.append(tok)
        picked.append(logits[:, -1])
    return (np.asarray(jnp.concatenate(toks, axis=1)),
            np.stack([np.asarray(x) for x in picked], axis=1))


def _top2_gap(logits):
    top = np.sort(logits, axis=-1)[..., -2:]
    return float((top[..., 1] - top[..., 0]).min())


@pytest.mark.parametrize("name", NAMES)
def test_serve_matches_reference(name):
    cfg, tree, model = _weights(name)
    prompts, extra = _prompts(cfg), _extra(cfg)
    want_tok, want_logits = _jax_greedy(name, tree, prompts, extra)
    _build.reset_launches()
    tok, stats = S.serve(cfg, batch=B, prompt_len=PROMPT, gen=GEN,
                         device="cpu", params=model,
                         prompts=torch.as_tensor(prompts),
                         extra=_as(extra, torch.as_tensor))
    got = stats["logits"].numpy()
    assert got.shape == want_logits.shape == (B, GEN, cfg.vocab)
    scale = float(np.abs(want_logits).max())
    for t in range(GEN):
        err = float(np.abs(got[:, t] - want_logits[:, t]).max())
        assert err <= LOGIT_TOL * scale, (t, err, scale)
    assert np.array_equal(tok.numpy(), want_tok), (
        f"tokens differ; smallest top-2 gap of the reference's logits "
        f"{_top2_gap(want_logits):.3e}")
    # the CPU path runs the plain versions: no kernel was launched
    assert not any(_build.LAUNCHES.values())


@pytest.mark.parametrize("name", NAMES)
def test_prefill_decode_matches_forward(name):
    """The port's prefill + decode steps == its own full forward (the
    reference's test_models.py check, same tolerance)."""
    cfg, _, model = _weights(name)
    S_ = 20
    off = cfg.img_tokens or 0
    tokens = torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab, (B, S_)))
    extra = _as(_extra(cfg), torch.as_tensor)
    full = M.forward(model, cfg, tokens, extra)
    k0 = S_ - 3
    logits, cache = M.prefill(model, cfg, tokens[:, :k0], extra,
                              max_len=off + S_)
    errs = [float((logits[:, -1] - full[:, off + k0 - 1]).abs().max())]
    for i in range(k0, S_):
        logits, cache = M.decode_step(model, cfg, tokens[:, i:i + 1], cache,
                                      off + i)
        errs.append(float((logits[:, 0] - full[:, off + i]).abs().max()))
    scale = float(full.abs().max())
    assert max(errs) < 2e-4 * max(scale, 10.0), errs


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(name):
    cfg, tree, model = _weights(name)
    tokens, extra = _prompts(cfg), _extra(cfg)
    want = np.asarray(JM.forward(tree, JARCHS[name].reduced(),
                                 jnp.asarray(tokens, jnp.int32),
                                 _as(extra, jnp.asarray)))
    got = M.forward(model, cfg, torch.as_tensor(tokens),
                    _as(extra, torch.as_tensor)).numpy()
    assert got.shape == want.shape == (B, (cfg.img_tokens or 0) + PROMPT,
                                       cfg.vocab)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


@pytest.mark.parametrize("name", NAMES)
def test_configs_are_the_reference_configs(name):
    cfg, ref = ARCHS[name], JARCHS[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(
        ref.reduced())
    assert cfg.param_count() == ref.param_count()
    assert np.array_equal(cfg.layer_windows(), ref.layer_windows())
    assert cfg.window_pattern() == ref.window_pattern()
    assert get(name) is cfg


def test_every_reference_arch_resolves():
    assert list(ARCHS) == list(JARCHS)
    for name in JARCHS:
        assert get(name).name == name
    with pytest.raises(KeyError, match="unknown arch 'gpt-2'"):
        get("gpt-2")


def test_lm_params_from_reference_rejects_a_partial_tree():
    cfg = ARCHS["gemma2-27b"].reduced()
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                   JARCHS[cfg.name].reduced()))
    del tree["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        convert.lm_params_from_reference(cfg, tree, device="cpu")


def test_serve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.serve(ARCHS["rwkv6-1.6b"].reduced(), batch=1, prompt_len=4, gen=2)


def test_serve_cli_and_seeds():
    tokens, stats = S.main(["--arch", "rwkv6-1.6b", "--reduced", "--device",
                            "cpu", "--batch", "2", "--prompt-len", "8",
                            "--gen", "3"])
    again, _ = S.serve(ARCHS["rwkv6-1.6b"].reduced(), batch=2, prompt_len=8,
                       gen=3, device="cpu")
    assert tokens.shape == (2, 3) and torch.equal(tokens, again)
    assert stats["logits"].shape == (2, 3, 512)
    assert bool(((tokens >= 0) & (tokens < 512)).all())
