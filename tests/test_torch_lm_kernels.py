"""The port's plain K13 and K14 and the LM layers against the JAX package.

K13 (flash attention) and K14 (WKV6): on CPU tensors the port's wrappers
(``ops.flash_attention``, ``ops.wkv6``) run their plain versions; they are
held here against the reference's Pallas kernels in interpret mode.  The
CUDA kernels are held against these plain versions on the card by
``chip_smoke.py``.  Inputs come from numpy with a seed.  Tolerances,
relative to the largest magnitude of the reference's output:

* K13 float32 1e-5 (two float32 orders of one online softmax); bfloat16
  1e-2 (both compute in float32 from the same bfloat16 inputs; the outputs
  may differ by one bfloat16 rounding, 2^-8 of max |o| at most);
* K14: 1e-5 for the sequential recurrence against the sequential body,
  1e-4 where one side is the chunked form (its cumulative decay products
  cost a few bits, the reference's own oracle test allows 1e-3);
* the layers 1e-5 (float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.wkv6 import wkv6 as jwkv6_kernel
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import rwkv6 as JR
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as R

F32_TOL, BF16_TOL = 1e-5, 1e-2
SEQ_TOL, CHUNK_TOL = 1e-5, 1e-4


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# K13
# ---------------------------------------------------------------------------
def _qkv(rng, B, Hq, Hkv, Sq, Skv, d):
    return (rng.normal(size=(B, Hq, Sq, d)), rng.normal(size=(B, Hkv, Skv, d)),
            rng.normal(size=(B, Hkv, Skv, d)))


def _flash_pair(arrays, dtype, **kw):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    want = jops.flash_attention(*(jnp.asarray(a, jdt) for a in arrays),
                                block_q=16, block_k=16, interpret=True, **kw)
    got = ops.flash_attention(*(_t(a, dtype) for a in arrays), **kw)
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    return got.float().numpy(), np.asarray(want, np.float32)


FLASH_CASES = {
    "causal": dict(causal=True),
    "noncausal": dict(causal=False),
    "window": dict(causal=True, window=16),
    "softcap": dict(causal=True, softcap=30.0),
    "window_softcap": dict(causal=True, window=8, softcap=50.0),
    "q_offset": dict(causal=True, q_offset=16),
    "scale": dict(causal=True, scale=0.3),
}


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_plain_matches_kernel(rng, case, dtype):
    arrays = _qkv(rng, 2, 4, 2, 40, 40, 16)     # 40: not a block multiple
    got, want = _flash_pair(arrays, dtype, **FLASH_CASES[case])
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2), (4, 1)])
def test_flash_plain_gqa(rng, Hq, Hkv):
    got, want = _flash_pair(_qkv(rng, 1, Hq, Hkv, 32, 32, 16),
                            torch.float32, causal=True, window=12,
                            softcap=50.0)
    assert _rel(got, want) <= F32_TOL


@pytest.mark.parametrize("Sq,Skv", [(33, 65), (8, 40), (40, 24)])
def test_flash_plain_ragged_shapes(rng, Sq, Skv):
    got, want = _flash_pair(_qkv(rng, 1, 2, 1, Sq, Skv, 16), torch.float32,
                            causal=False, softcap=50.0)
    assert _rel(got, want) <= F32_TOL


def test_flash_plain_fully_masked_rows(rng):
    """Rows with no valid key (q_offset < 0 puts the first queries before
    every key) give 0 in the kernel and its plain version, not NaN."""
    got, want = _flash_pair(_qkv(rng, 1, 2, 2, 24, 24, 16), torch.float32,
                            causal=True, q_offset=-5)
    assert np.all(want[:, :, :5] == 0.0) and np.all(got[:, :, :5] == 0.0)
    assert _rel(got, want) <= F32_TOL


def test_attention_ref_matches_reference(rng):
    arrays = _qkv(rng, 1, 4, 2, 24, 24, 16)
    kw = dict(causal=True, window=10, softcap=30.0, q_offset=3)
    want = jref.attention_ref(*(jnp.asarray(a, jnp.float32) for a in arrays),
                              **kw)
    got = ref.attention_ref(*(_t(a) for a in arrays), **kw)
    assert _rel(got.numpy(), want) <= F32_TOL


# ---------------------------------------------------------------------------
# K14
# ---------------------------------------------------------------------------
def _wkv_data(rng, B, H, T, d):
    return (rng.normal(size=(B, H, T, d)), rng.normal(size=(B, H, T, d)),
            rng.normal(size=(B, H, T, d)),
            np.exp(-np.exp(rng.uniform(-8.0, 1.0, size=(B, H, T, d)))),
            rng.normal(size=(H, d)))


@pytest.mark.parametrize("variant", ["sequential", "chunked"])
@pytest.mark.parametrize("T", [20, 1, 48])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
def test_wkv6_plain_matches_kernel(rng, variant, T, with_state):
    B, H, d = 2, 2, 16
    arrays = _wkv_data(rng, B, H, T, d)
    s0 = rng.normal(size=(B, H, d, d)) if with_state else None
    want_o, want_s = jwkv6_kernel(
        *(jnp.asarray(a, jnp.float32) for a in arrays),
        initial_state=None if s0 is None else jnp.asarray(s0, jnp.float32),
        return_state=True, block_t=16, variant=variant, interpret=True)
    args = tuple(_t(a) for a in arrays)
    kw = dict(initial_state=None if s0 is None else _t(s0),
              return_state=True)
    for fn, tol in ((ops.wkv6, SEQ_TOL), (ref.wkv6_ref, SEQ_TOL),
                    (ref.wkv6_chunked, CHUNK_TOL)):
        o, s = fn(*args, **kw)
        if variant == "chunked":
            tol = CHUNK_TOL
        assert _rel(o.numpy(), want_o) <= tol, fn
        assert _rel(s.numpy(), want_s) <= tol, fn
    # without return_state the wrapper returns o alone
    assert tuple(ops.wkv6(*args).shape) == (B, H, T, d)


def test_wkv6_ref_matches_reference_oracle(rng):
    arrays = _wkv_data(rng, 1, 2, 24, 8)
    want = jref.wkv6_chunked(*(jnp.asarray(a, jnp.float32) for a in arrays),
                             return_state=True)
    got = ref.wkv6_chunked(*(_t(a) for a in arrays), return_state=True)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= SEQ_TOL


def test_wkv6_rejects_unknown_variant(rng):
    args = tuple(_t(a) for a in _wkv_data(rng, 1, 1, 4, 16))
    with pytest.raises(ValueError, match="variant"):
        ops.wkv6(*args, variant="blocked")


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
def _model(name, seed=0):
    jcfg = JARCHS[name].reduced()
    tree = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    # perturb the zero / one initialisations so every term is exercised
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(
            np.float32), tree)
    model = convert.lm_params_from_reference(ARCHS[name].reduced(), tree,
                                             device="cpu")
    layer0 = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"])
    return jcfg, ARCHS[name].reduced(), layer0, model.layers[0]


@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm(rng, plus_one):
    x = rng.normal(size=(2, 5, 64))
    scale = rng.normal(size=(64,))
    want = JL.rms_norm(jnp.asarray(x, jnp.float32),
                       {"scale": jnp.asarray(scale, jnp.float32)},
                       eps=1e-6, plus_one=plus_one)
    p = L.Norm(64, dtype=torch.float32, device="cpu")
    p.scale.copy_(_t(scale))
    got = L.rms_norm(_t(x), p, eps=1e-6, plus_one=plus_one)
    assert _rel(got.numpy(), want) <= F32_TOL


def test_rope(rng):
    x = rng.normal(size=(2, 7, 3, 16))
    pos = rng.integers(0, 100, size=(2, 7))
    want = JL.rope(jnp.asarray(x, jnp.float32), jnp.asarray(pos), theta=1e4)
    got = L.rope(_t(x), torch.as_tensor(pos), theta=1e4)
    assert _rel(got.numpy(), want) <= F32_TOL


def test_mlp_gelu_gated(rng):
    jcfg, cfg, jlp, lp = _model("gemma2-27b")
    x = rng.normal(size=(2, 5, cfg.d_model))
    want = JL.mlp(jnp.asarray(x, jnp.float32), jlp["mlp"], act="gelu")
    got = L.mlp(_t(x), lp.mlp, act="gelu")
    assert _rel(got.numpy(), want) <= F32_TOL


def test_ddlerp_time_mix_channel_mix(rng):
    jcfg, cfg, jlp, lp = _model("rwkv6-1.6b")
    x = rng.normal(size=(2, 20, cfg.d_model))
    xp = rng.normal(size=(2, 20, cfg.d_model))
    jx, jxp = jnp.asarray(x, jnp.float32), jnp.asarray(xp, jnp.float32)
    for want, got in zip(JR._ddlerp(jx, jxp, jlp["rwkv"]),
                         R._ddlerp(_t(x), _t(xp), lp.rwkv)):
        assert _rel(got.numpy(), want) <= F32_TOL
    s0 = rng.normal(size=(2, cfg.n_heads, cfg.head_dim, cfg.head_dim))
    want, want_s = JR._time_mix(jx, jxp, jlp["rwkv"], jcfg,
                                s0=jnp.asarray(s0, jnp.float32),
                                return_state=True)
    got, got_s = R._time_mix(_t(x), _t(xp), lp.rwkv, cfg, s0=_t(s0),
                             return_state=True)
    assert _rel(got.numpy(), want) <= CHUNK_TOL
    assert _rel(got_s.numpy(), want_s) <= CHUNK_TOL
    want = JR._channel_mix(jx, jxp, jlp["rwkv"])
    got = R._channel_mix(_t(x), _t(xp), lp.rwkv)
    assert _rel(got.numpy(), want) <= F32_TOL


@pytest.mark.parametrize("window", [None, 6])
def test_decode_attention(rng, window):
    jcfg, cfg, jlp, lp = _model("gemma2-27b")
    B, S, idx = 2, 12, 9
    x = rng.normal(size=(B, 1, cfg.d_model))
    shape = (B, cfg.n_kv_heads, S, cfg.hd)
    k, v = rng.normal(size=shape), rng.normal(size=shape)
    want, want_c = JA.decode_attention(
        jnp.asarray(x, jnp.float32), jlp["attn"], jcfg,
        {"k": jnp.asarray(k, jnp.float32), "v": jnp.asarray(v, jnp.float32)},
        idx, window=window)
    cache = {"k": _t(k), "v": _t(v)}
    got, got_c = A.decode_attention(_t(x), lp.attn, cfg, cache, idx,
                                    window=window)
    assert _rel(got.numpy(), want) <= F32_TOL
    assert got_c is cache                     # written in place
    for name in ("k", "v"):
        assert _rel(got_c[name].numpy(), want_c[name]) <= F32_TOL


@pytest.mark.parametrize("impl", ["naive", "chunked", "flash"])
def test_attention_prefill_impls(rng, impl):
    jcfg, cfg, jlp, lp = _model("gemma2-27b")
    x = rng.normal(size=(2, 20, cfg.d_model))
    pos = np.broadcast_to(np.arange(20), (2, 20))
    want, (wk, wv) = JA.attention(jnp.asarray(x, jnp.float32), jlp["attn"],
                                  jcfg, positions=jnp.asarray(pos),
                                  window=16, impl=impl)
    got, (gk, gv) = A.attention(_t(x), lp.attn, cfg,
                                positions=torch.tensor(pos), window=16,
                                impl=impl)
    assert _rel(got.numpy(), want) <= F32_TOL
    assert _rel(gk.numpy(), wk) <= F32_TOL and _rel(gv.numpy(), wv) <= F32_TOL
