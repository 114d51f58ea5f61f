"""The LM serving slice of the port against the JAX package, on the CPU.

rwkv6-1.6b, gemma2-27b, nemotron-4-340b and hymba-1.5b at ``reduced()``
size (float32; hymba with its Mamba path and both paths' norms): the
reference's
weights carried across by ``convert.lm_params_from_reference``, the same
prompts (numpy, from a seed), the reference's ``prefill`` + ``decode_step``
greedy loop against the port's ``serve``.  Tolerance: logits within 1e-4 of
max |logit| at every step (float32 round-off of two evaluation orders);
greedy tokens identical.
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

NAMES = ["rwkv6-1.6b", "gemma2-27b", "nemotron-4-340b", "hymba-1.5b"]
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


def _jax_greedy(name, tree, prompts):
    cfg = JARCHS[name].reduced()
    prefill = jax.jit(lambda p, t: JM.prefill(p, cfg, t, max_len=PROMPT + GEN))
    step = jax.jit(lambda p, t, c, i: JM.decode_step(p, cfg, t, c, i))
    logits, cache = prefill(tree, jnp.asarray(prompts, jnp.int32))
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    toks, picked = [tok], [logits[:, -1]]
    for i in range(GEN - 1):
        logits, cache = step(tree, tok, cache,
                             jnp.asarray(PROMPT + i, jnp.int32))
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
    prompts = _prompts(cfg)
    want_tok, want_logits = _jax_greedy(name, tree, prompts)
    _build.reset_launches()
    tok, stats = S.serve(cfg, batch=B, prompt_len=PROMPT, gen=GEN,
                         device="cpu", params=model,
                         prompts=torch.as_tensor(prompts))
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
    tokens = torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab, (B, S_)))
    full = M.forward(model, cfg, tokens)
    k0 = S_ - 3
    logits, cache = M.prefill(model, cfg, tokens[:, :k0], max_len=S_)
    errs = [float((logits[:, -1] - full[:, k0 - 1]).abs().max())]
    for i in range(k0, S_):
        logits, cache = M.decode_step(model, cfg, tokens[:, i:i + 1], cache, i)
        errs.append(float((logits[:, 0] - full[:, i]).abs().max()))
    scale = float(full.abs().max())
    assert max(errs) < 2e-4 * max(scale, 10.0), errs


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(name):
    cfg, tree, model = _weights(name)
    tokens = _prompts(cfg)
    want = np.asarray(JM.forward(tree, JARCHS[name].reduced(),
                                 jnp.asarray(tokens, jnp.int32)))
    got = M.forward(model, cfg, torch.as_tensor(tokens)).numpy()
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


def test_unported_archs_and_blocks_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get("qwen3-moe-30b-a3b")
    gen = torch.Generator("cpu").manual_seed(0)
    for cfg in (JARCHS["qwen3-moe-30b-a3b"].reduced(),
                JARCHS["arctic-480b"].reduced(),
                JARCHS["whisper-large-v3"].reduced(),
                JARCHS["llava-next-mistral-7b"].reduced()):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            M.init_params(gen, cfg)


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
