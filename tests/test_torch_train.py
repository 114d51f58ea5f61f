"""The training path of the port against the JAX package, on the CPU.

* Both autograd Functions (``kernels/autograd.py``): ``gradcheck`` in f64
  at tiny sizes (K13's backward over tiles of 2 keys, so that every tile
  edge is crossed), and against ``jax.grad`` of the reference's chunked
  attention and ``wkv6_chunked`` in f32 (each gradient within 1e-5 of its
  largest value: two f32 evaluation orders).  Cases: causal, window,
  softcap, GQA 2:1, non-causal with Sq != Skv, ``q_offset``, rows with no
  visible key; WKV with and without an initial state.
* All ten architectures at ``reduced()`` size: ``loss_fn`` and every
  parameter's gradient against ``jax.value_and_grad(loss_fn)`` with the
  weights carried by ``convert`` (loss relative 1e-5; each gradient within
  1e-4 of its largest value, where the worst measured is 3.9e-5, rwkv6's
  ``u``).  Remat on and off bitwise.
* One ``train_step`` (``grad_accum`` 1 and 2, ``grad_compression`` bf16)
  against the reference's from one state (``convert.
  train_state_from_reference``): loss and gradient norm relative 1e-5, the
  moments within 1e-4 (mu) and 2e-4 (nu) of their largest value (plus one
  bf16 step of each value with bf16 compression, whose rounding of a
  gradient at a rounding boundary may go either way), and the parameters
  within 1e-6 of their largest value plus 1e-3 lr where the gradient is
  more than 1e-4 of its leaf's largest or 0 on both sides (AdamW's first
  step is sign(g) lr: where g is within round-off of 0 either sign is
  right; those entries, at most 1% of all, are held to the step's size,
  2 lr (1 + wd |p|)).
* ``train`` for 6 steps against 3 + restart + 3, bitwise; the serving path
  with a model that requires grad, bitwise and with no graph.
"""
import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.kernels import ref as JR
from repro.launch import steps as JSt
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import moe as JMO
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS
from repro_torch.data import SyntheticLMStream
from repro_torch.kernels import autograd as AG
from repro_torch.launch import serve as SV
from repro_torch.launch import steps as St
from repro_torch.launch import train as TR
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MO
from repro_torch.models import ssm

NAMES = list(JARCHS)
FN_TOL = 1e-5            # autograd Functions against jax.grad, f32
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4          # each leaf, relative to its largest |g|
B, S = 2, 24             # S > gemma2's reduced window of 16

# (B, Hq, Hkv, Sq, Skv, causal, window, softcap, q_offset)
ATTN_CASES = {
    "causal": (1, 2, 2, 7, 7, True, None, None, 0),
    "window": (1, 2, 2, 9, 9, True, 3, None, 0),
    "softcap": (2, 2, 2, 6, 6, True, None, 2.0, 0),
    "gqa2": (1, 4, 2, 7, 7, True, 4, None, 0),
    "noncausal_cross": (1, 2, 1, 5, 11, False, None, None, 0),
    "q_offset": (1, 2, 2, 4, 10, True, None, None, 6),
    "masked_rows": (1, 2, 2, 6, 6, True, 2, None, -3),
}


def _attn_inputs(case, dtype, seed=0):
    Bq, Hq, Hkv, Sq, Skv, *_ = ATTN_CASES[case]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Bq, Hq, Sq, 8)),
            rng.standard_normal((Bq, Hkv, Skv, 8)),
            rng.standard_normal((Bq, Hkv, Skv, 8)),
            rng.standard_normal((Bq, Hq, Sq, 8)))


def _attn_kw(case):
    *_, causal, window, cap, q_offset = ATTN_CASES[case]
    return dict(causal=causal, window=window, softcap=cap, q_offset=q_offset)


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_attention_fn_gradcheck_f64(case, monkeypatch):
    monkeypatch.setattr(AG, "BLOCK_K", 2)
    q, k, v, _ = (torch.tensor(a, requires_grad=True)
                  for a in _attn_inputs(case, np.float64))
    kw = _attn_kw(case)

    def f(q, k, v):
        return AG.FlashAttentionFn.apply(q, k, v, kw["causal"], 0.35,
                                         kw["window"], kw["softcap"],
                                         kw["q_offset"])

    assert torch.autograd.gradcheck(f, (q, k, v))


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_attention_fn_matches_jax_grad(case, monkeypatch):
    monkeypatch.setattr(AG, "BLOCK_K", 4)
    q, k, v, do = (a.astype(np.float32) for a in _attn_inputs(case, None, 1))
    kw = _attn_kw(case)

    def jloss(q, k, v):
        o = JA._chunked(q, k, v, causal=kw["causal"], window=kw["window"],
                        cap=kw["softcap"], scale=0.35,
                        q_offset=kw["q_offset"], block_q=4, block_k=4)
        return jnp.sum(o * do)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = AG.flash_attention(tq, tk, tv, scale=0.35, **kw)
    assert o.grad_fn is not None
    got = torch.autograd.grad(o, (tq, tk, tv), torch.tensor(do))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.isfinite(g.numpy()).all()
        assert np.abs(g.numpy() - w).max() <= FN_TOL * np.abs(w).max()
    if case == "masked_rows":          # rows 0..2 see no key: zero gradient
        assert not got[0][:, :, :3].any()


def _wkv_inputs(dtype, state, seed=0, T=13):
    rng = np.random.default_rng(seed)
    Bw, H, d = 2, 2, 4
    r, k, v = (rng.standard_normal((Bw, H, T, d)).astype(dtype)
               for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(-3.0, 1.0, (Bw, H, T, d)))).astype(dtype)
    u = (0.5 * rng.standard_normal((H, d))).astype(dtype)
    s0 = rng.standard_normal((Bw, H, d, d)).astype(dtype) if state else None
    return r, k, v, w, u, s0


@pytest.mark.parametrize("state", [False, True])
def test_wkv6_fn_gradcheck_f64(state):
    arrs = _wkv_inputs(np.float64, state, T=6)
    ins = [None if a is None else torch.tensor(a, requires_grad=True)
           for a in arrs]

    def f(*xs):
        return AG.WKV6Fn.apply(*xs[:5], xs[5] if state else None)

    assert torch.autograd.gradcheck(f, tuple(ins[:5])
                                    + ((ins[5],) if state else ()))


@pytest.mark.parametrize("state", [False, True])
def test_wkv6_fn_matches_jax_grad(state):
    r, k, v, w, u, s0 = _wkv_inputs(np.float32, state, seed=2)
    rng = np.random.default_rng(3)
    do = rng.standard_normal(r.shape).astype(np.float32)
    ds = rng.standard_normal((r.shape[0], r.shape[1], 4, 4)).astype(
        np.float32)
    n = 6 if state else 5

    def jloss(*xs):
        o, st = JR.wkv6_chunked(*xs[:5], initial_state=xs[5] if state
                                else None, return_state=True)
        return jnp.sum(o * do) + jnp.sum(st * ds)

    arrs = (r, k, v, w, u, s0)[:n]
    want = jax.grad(jloss, argnums=tuple(range(n)))(*map(jnp.asarray, arrs))
    ins = [torch.tensor(a, requires_grad=True) for a in arrs]
    o, st = AG.wkv6(*ins[:5], initial_state=ins[5] if state else None,
                    return_state=True)
    got = torch.autograd.grad((o, st), ins, (torch.tensor(do),
                                             torch.tensor(ds)))
    for g, wnt in zip(got, want):
        wnt = np.asarray(wnt)
        assert np.abs(g.numpy() - wnt).max() <= FN_TOL * np.abs(wnt).max()


def test_functions_leave_serving_alone():
    """Without a gradient wanted, the dispatchers call the wrappers: no
    graph, the wrapper's values."""
    q, k, v, _ = (torch.tensor(a, dtype=torch.float32)
                  for a in _attn_inputs("causal", None))
    o = AG.flash_attention(q, k, v)
    assert o.grad_fn is None
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert AG.flash_attention(qg, k, v).grad_fn is None
    assert torch.equal(AG.flash_attention(qg, k, v).detach(), o)
    arrs = [torch.tensor(a) for a in _wkv_inputs(np.float32, False)[:5]]
    assert AG.wkv6(*arrs).grad_fn is None


# ---------------------------------------------------------------------------
# the model: loss and gradients against jax.value_and_grad(loss_fn)
# ---------------------------------------------------------------------------
def _batch(cfg, seed=1, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (batch, seq + 1)).astype(np.int32)
    extra = None
    if cfg.img_tokens:
        extra = {"img_embeds": 0.1 * rng.standard_normal(
            (batch, cfg.img_tokens, cfg.d_model), dtype=np.float32)}
    if cfg.enc_layers:
        extra = {"audio_embeds": 0.1 * rng.standard_normal(
            (batch, cfg.audio_ctx, cfg.d_model), dtype=np.float32)}
    return toks, extra


def _t(extra):
    return None if extra is None else {k: torch.tensor(v)
                                       for k, v in extra.items()}


def _j(extra):
    return None if extra is None else {k: jnp.asarray(v)
                                       for k, v in extra.items()}


def _port_grads(model, cfg, toks, extra):
    named = dict(model.named_parameters())
    loss = M.loss_fn(model, cfg, {"tokens": torch.tensor(toks)}, _t(extra))
    got = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return loss, {k: torch.zeros_like(p) if g is None else g
                  for (k, p), g in zip(named.items(), got)}


def _model(name, seed=0):
    cfg = ARCHS[name].reduced()
    tree = jax.tree.map(np.asarray,
                        JM.init_params(jax.random.PRNGKey(seed),
                                       JARCHS[name].reduced()))
    model = convert.lm_params_from_reference(cfg, tree, device="cpu")
    return cfg, tree, model.requires_grad_(True)


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_reference(name):
    cfg, tree, model = _model(name)
    jcfg = JARCHS[name].reduced()
    toks, extra = _batch(cfg)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, t, e: JM.loss_fn(p, jcfg, {"tokens": t}, e)))(
            tree, jnp.asarray(toks), _j(extra))
    loss, grads = _port_grads(model, cfg, toks, extra)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss.detach()) - float(jl)) <= LOSS_TOL * abs(float(jl))
    seen = set()
    for k, want in convert.lm_named_arrays(cfg, jax.tree.map(np.asarray,
                                                             jg)):
        g = grads[k].numpy()
        assert np.isfinite(g).all(), k
        assert np.abs(g - want).max() <= GRAD_TOL * max(np.abs(want).max(),
                                                        1e-30), k
        seen.add(k)
    assert seen == set(grads)
    mixing = [k for k in grads if ".attn." in k or ".xattn." in k
              or (".rwkv." in k and ".rwkv.cm_" not in k)]
    assert mixing and all(grads[k].any() for k in mixing)


def test_loss_fn_picks_the_text_tail():
    """llava: the image tokens' logits are not scored."""
    cfg, _, model = _model("llava-next-mistral-7b")
    toks, extra = _batch(cfg)
    with torch.no_grad():
        logits = M.forward(model, cfg, torch.tensor(toks[:, :-1]),
                           _t(extra))[:, cfg.img_tokens:]
        want = (torch.logsumexp(logits, -1) - torch.gather(
            logits, -1, torch.tensor(toks[:, 1:]).long()[..., None])[..., 0])
        want = want.mean() + 1e-4 * (torch.logsumexp(logits, -1) ** 2).mean()
        got = M.loss_fn(model, cfg, {"tokens": torch.tensor(toks)},
                        _t(extra))
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["qwen2.5-14b", "gemma2-27b", "rwkv6-1.6b",
                                  "whisper-large-v3", "hymba-1.5b",
                                  "qwen3-moe-30b-a3b"])
def test_remat_gives_bitwise_gradients(name):
    cfg, _, model = _model(name)
    toks, extra = _batch(cfg)
    l0, g0 = _port_grads(model, cfg, toks, extra)
    calls = []
    orig = M.checkpoint
    try:
        M.checkpoint = lambda *a, **k: calls.append(1) or orig(*a, **k)
        l1, g1 = _port_grads(model, dataclasses.replace(cfg, remat=True),
                             toks, extra)
    finally:
        M.checkpoint = orig
    groups = cfg.n_layers // len(cfg.window_pattern())
    assert len(calls) == groups * (2 if cfg.enc_layers else 1)
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_rwkv_through_wkv6_fn_on_cpu():
    """cfg.use_kernels routes the CPU through the kernel's path (ops.wkv6,
    WKV6Fn): the gradients match the chunked form's autograd."""
    cfg, _, model = _model("rwkv6-1.6b")
    toks, extra = _batch(cfg)
    calls = []
    orig = AG.WKV6Fn.apply
    try:
        AG.WKV6Fn.apply = lambda *a: calls.append(1) or orig(*a)
        l1, g1 = _port_grads(model, dataclasses.replace(cfg,
                                                        use_kernels=True),
                             toks, extra)
    finally:
        AG.WKV6Fn.apply = orig
    l0, g0 = _port_grads(model, cfg, toks, extra)
    assert len(calls) == cfg.n_layers
    l0, l1 = float(l0.detach()), float(l1.detach())
    assert abs(l1 - l0) <= LOSS_TOL * abs(l0)
    for k in g0:
        assert (g1[k] - g0[k]).abs().max() <= GRAD_TOL * max(
            float(g0[k].abs().max()), 1e-30), k


def test_moe_gradients_through_gates_and_experts():
    """Drops at capacity factor 1.0: the gradients of the input, router and
    experts against jax.grad of the reference's moe_ffn; the routing
    indices carry none."""
    name = "qwen3-moe-30b-a3b"
    jcfg = dataclasses.replace(JARCHS[name].reduced(), capacity_factor=1.0)
    cfg = dataclasses.replace(ARCHS[name].reduced(), capacity_factor=1.0)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(np.asarray, JMO.init_moe(jax.random.PRNGKey(1), jcfg))
    dy = rng.standard_normal(x.shape).astype(np.float32)
    cap = MO._capacity(48, cfg.top_k, cfg.n_experts, 1.0)
    _, _, slot = MO._route(torch.tensor(x).reshape(48, -1),
                           torch.tensor(jp["router"]), top_k=cfg.top_k,
                           capacity=cap)
    assert (slot == cfg.n_experts * cap).any()           # some dropped
    want = jax.grad(lambda x, p: jnp.sum(JMO.moe_ffn(x, p, jcfg) * dy),
                    argnums=(0, 1))(jnp.asarray(x), jp)
    p = MO.init_moe(torch.Generator().manual_seed(0), cfg)
    with torch.no_grad():
        for k, t in p.named_parameters():
            t.copy_(torch.tensor(jp[k]))
    p.requires_grad_(True)
    tx = torch.tensor(x, requires_grad=True)
    eid, gate, slot = MO._route(tx.reshape(48, -1), p.router,
                                top_k=cfg.top_k, capacity=cap)
    assert eid.grad_fn is None and slot.grad_fn is None
    assert gate.grad_fn is not None
    y = MO.moe_ffn(tx, p, cfg)
    names = ["x"] + [k for k, _ in p.named_parameters()]
    got = torch.autograd.grad(y, [tx] + list(p.parameters()),
                              torch.tensor(dy))
    wants = [want[0]] + [want[1][k] for k in names[1:]]
    for k, g, w in zip(names, got, wants):
        w = np.asarray(w)
        assert g.any(), k
        assert np.abs(g.numpy() - w).max() <= GRAD_TOL * np.abs(w).max(), k


def test_ssm_scan_with_grad_is_bitwise_and_differentiable():
    g = torch.Generator().manual_seed(0)
    Bx, T, di, n = 2, 150, 6, 4
    x, Bc, Cc = (torch.randn(Bx, T, c, generator=g) for c in (di, n, n))
    dt = 0.1 * torch.rand(Bx, T, di, generator=g)
    A = -torch.rand(di, n, generator=g)
    D, h0 = torch.rand(di, generator=g), torch.randn(Bx, di, n, generator=g)
    with torch.no_grad():
        y0, h_0 = ssm._ssm_scan(x, dt, Bc, Cc, A, D, h0)
    xr = x.clone().requires_grad_()
    y1, h_1 = ssm._ssm_scan(xr, dt, Bc, Cc, A, D, h0)
    assert torch.equal(y0, y1) and torch.equal(h_0, h_1)
    (gx,) = torch.autograd.grad(y1.sum() + h_1.sum(), xr)
    assert torch.isfinite(gx).all() and gx.any()


# ---------------------------------------------------------------------------
# the step, the state, the trainer
# ---------------------------------------------------------------------------
def test_init_helpers_match_reference_shapes():
    import repro.models.layers as JL

    g = torch.Generator().manual_seed(0)
    jl = JL.init_linear(jax.random.PRNGKey(0), 6, 5, bias=True)
    tl = L.init_linear(g, 6, 5, bias=True)
    assert tl.w.shape == jl["w"].shape and tl.b.shape == jl["b"].shape
    assert not tl.b.any() and not tl.w.requires_grad
    assert abs(float(tl.w.std()) - 6 ** -0.5) < 0.2
    jm = JL.init_mlp(jax.random.PRNGKey(0), 6, 10, gated=True)
    tm = L.init_mlp(g, 6, 10, gated=True, dtype=torch.bfloat16)
    for k in jm:
        assert getattr(tm, k).w.shape == jm[k]["w"].shape
        assert getattr(tm, k).w.dtype == torch.bfloat16
    assert L.init_mlp(g, 6, 10, gated=False).w_gate is None
    jn = JL.init_norm(7, bias=True)
    tn = L.init_norm(7, bias=True)
    assert torch.equal(tn.scale, torch.tensor(np.asarray(jn["scale"])))
    assert torch.equal(tn.bias, torch.tensor(np.asarray(jn["bias"])))


@pytest.mark.parametrize("name", ["qwen2.5-14b", "nemotron-4-340b"])
def test_make_train_state(name):
    cfg = ARCHS[name].reduced()
    st = St.make_train_state(torch.Generator().manual_seed(0), cfg)
    named = st.named()
    assert st.step == 0 and set(st.mu) == set(st.nu) == set(named)
    mdt = L.dtype_of(cfg.opt_moment_dtype)
    assert mdt == (torch.bfloat16 if name == "nemotron-4-340b"
                   else torch.float32)
    for k, p in named.items():
        assert p.requires_grad
        assert st.mu[k].dtype == mdt and not st.mu[k].any()
        assert st.nu[k].shape == p.shape


def _ref_state(name):
    jcfg = JARCHS[name].reduced()
    js = JSt.make_train_state(jax.random.PRNGKey(0), jcfg)
    return jcfg, js


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("accum,comp", [(1, "none"), (2, "none"),
                                        (1, "bf16"), (2, "int8")])
def test_train_step_matches_reference(accum, comp):
    name = "qwen2.5-14b"
    jcfg, js = _ref_state(name)
    cfg = ARCHS[name].reduced()
    kw = dict(peak_lr=1e-3, warmup=2, total_steps=20, grad_accum=accum,
              grad_compression=comp)
    toks = SyntheticLMStream(cfg.vocab, seed=0).batch(0, 4, 16)
    jstep = jax.jit(JSt.make_train_step(jcfg, **kw))
    js1, jm = jstep(js, {"tokens": jnp.asarray(toks)})
    state = convert.train_state_from_reference(
        cfg, _np(js.params), _np(js.mu), _np(js.nu), js.step, device="cpu")
    p0 = {k: p.detach().clone() for k, p in state.named().items()}
    state, m = St.make_train_step(cfg, **kw)(state,
                                             {"tokens": torch.tensor(toks)})
    assert m["step"] == state.step == int(jm["step"]) == 1
    assert abs(m["lr"] - float(jm["lr"])) <= 1e-6 * float(jm["lr"])
    for key in ("loss", "grad_norm"):
        assert abs(float(m[key]) - float(jm[key])) <= LOSS_TOL * abs(
            float(jm[key])), key
    lr = float(jm["lr"])
    mu = dict(convert.lm_named_arrays(cfg, _np(js1.mu)))
    nu = dict(convert.lm_named_arrays(cfg, _np(js1.nu)))
    ill = total = 0
    for k, want in convert.lm_named_arrays(cfg, _np(js1.params)):
        for got, ref, tol in ((state.mu[k], mu[k], 1e-4),
                              (state.nu[k], nu[k], 2e-4)):
            # bf16 compression: a gradient within round-off of a bf16
            # rounding boundary may round either way (one bf16 step)
            step = 2.0 ** -7 * np.abs(ref) if comp == "bf16" else 0.0
            assert (np.abs(got.numpy() - ref) <= tol * max(
                np.abs(ref).max(), 1e-30) + step).all(), k
        p = state.named()[k].detach().numpy()
        err = np.abs(p - want)
        # determined: |g| clear of round-off, or g exactly 0 on both sides
        # (embedding rows of tokens not in the batch)
        sure = (np.abs(mu[k]) > 1e-4 * np.abs(mu[k]).max()) | (
            (mu[k] == 0) & (state.mu[k].numpy() == 0))
        assert (err[sure] <= 1e-6 * np.abs(want).max() + 1e-3 * lr).all(), k
        step_size = 2 * lr * (1 + 0.1 * np.abs(p0[k].numpy()))
        assert (err <= step_size + 1e-6 * np.abs(want).max()).all(), k
        ill += int((~sure).sum())
        total += sure.size
    assert ill <= 0.01 * total


def test_train_state_from_reference_roundtrip():
    name = "nemotron-4-340b"          # bf16 moments
    jcfg, js = _ref_state(name)
    cfg = ARCHS[name].reduced()
    st = convert.train_state_from_reference(
        cfg, _np(js.params), _np(js.mu), _np(js.nu), js.step, device="cpu")
    assert st.step == 0
    for k, want in convert.lm_named_arrays(cfg, _np(js.params)):
        assert torch.equal(st.named()[k].detach(), torch.tensor(want))
        assert st.mu[k].dtype == torch.bfloat16


def test_train_restart_bitwise(tmp_path):
    """6 steps straight against 3 + checkpoint + restore + 3: bitwise the
    same parameters, moments and step (as tests/test_substrate.py holds
    the reference, there to 1e-5)."""
    for name in ("qwen2.5-14b", "rwkv6-1.6b"):
        cfg = ARCHS[name].reduced()
        kw = dict(batch=2, seq=16, peak_lr=1e-3, device="cpu")
        full, l_full = TR.train(cfg, steps=6, **kw)
        d = tmp_path / name
        _, l_a = TR.train(cfg, steps=3, ckpt_dir=str(d), ckpt_every=3, **kw)
        resumed, l_b = TR.train(cfg, steps=6, ckpt_dir=str(d), ckpt_every=3,
                                **kw)
        assert l_full == l_a + l_b
        assert full.step == resumed.step == 6
        a, b = full.named(), resumed.named()
        for k in a:
            assert torch.equal(a[k], b[k]), k
            assert torch.equal(full.mu[k], resumed.mu[k]), k
            assert torch.equal(full.nu[k], resumed.nu[k]), k


def test_train_sigterm_saves_at_the_step_boundary(tmp_path, monkeypatch):
    """A SIGTERM that arrives in a step (the update is in place) saves the
    state the step ends with, then exits."""
    cfg = ARCHS["qwen2.5-14b"].reduced()
    kw = dict(batch=2, seq=8, device="cpu")
    real = St.make_train_step

    def make(cfg, **k):
        step = real(cfg, **k)

        def interrupted(state, batch, extra=None):
            if state.step == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return step(state, batch, extra)

        return interrupted

    previous = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(St, "make_train_step", make)
    with pytest.raises(SystemExit):
        TR.train(cfg, steps=5, ckpt_dir=str(tmp_path), ckpt_every=10, **kw)
    assert signal.getsignal(signal.SIGTERM) == previous
    monkeypatch.setattr(St, "make_train_step", real)
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() == 2
    want, _ = TR.train(cfg, steps=2, **kw)
    step, tree = mgr.restore(want.tree())
    assert step == tree["step"] == 2
    for k, p in want.named().items():
        assert torch.equal(tree[k], p.detach()), k


def test_train_history_and_cli(capsys):
    hist = []
    cfg = ARCHS["codeqwen1.5-7b"].reduced()
    _, losses = TR.train(cfg, steps=3, batch=2, seq=8, device="cpu",
                         history=hist)
    assert [r["step"] for r in hist] == [0, 1, 2]
    assert [r["loss"] for r in hist] == losses
    assert all(r["ms"] > 0 and r["tokens_per_s"] > 0 and "mfu" not in r
               for r in hist)
    out = TR.main(["--arch", "rwkv6-1.6b", "--reduced", "--device", "cpu",
                   "--steps", "2", "--batch", "2", "--seq", "8",
                   "--grad-accum", "2", "--grad-compression", "bf16"])
    assert len(out) == 2 and all(np.isfinite(out))
    assert "loss" in capsys.readouterr().out


def test_train_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        TR.train(ARCHS["qwen2.5-14b"].reduced(), steps=1)


def test_straggler_watchdog():
    wd = TR.StragglerWatchdog(factor=2.0)
    for i in range(10):
        wd.observe(i, 1.0)
    wd.observe(10, 5.0)
    assert wd.flagged == [(10, 5.0)]


@pytest.mark.parametrize("name", ["qwen2.5-14b", "rwkv6-1.6b",
                                  "whisper-large-v3"])
def test_model_requiring_grad_serves_bitwise(name):
    cfg, _, model = _model(name)
    kw = dict(batch=2, prompt_len=12, gen=4, device="cpu")
    model.requires_grad_(False)
    t0, s0 = SV.serve(cfg, params=model, **kw)
    model.requires_grad_(True)
    t1, s1 = SV.serve(cfg, params=model, **kw)
    assert torch.equal(t0, t1) and torch.equal(s0["logits"], s1["logits"])
    assert s1["logits"].grad_fn is None and not s1["logits"].requires_grad
    prefill = St.make_serve_prefill(cfg, max_len=20)
    extra = _t(_batch(cfg, batch=2)[1])
    logits, cache = prefill(model, torch.zeros((2, 12), dtype=torch.long),
                            extra)
    leaves = [t for c in cache for t in c.values()]
    assert logits.grad_fn is None and all(t.grad_fn is None for t in leaves)
