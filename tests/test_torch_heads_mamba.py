"""K13 at the head sizes of nemotron-4-340b (192) and hymba-1.5b (64), and
the Mamba path of hymba, against the JAX package on the CPU.

K13: the port's plain version (``ref.flash_attention_plain``, the CPU path
of ``ops.flash_attention``) and the bf16 tensor-core kernel's arithmetic
(``ref.flash_attention_tc_emulated``) against the reference's Pallas kernel
in interpret mode (``ops.flash_attention``), at GQA 5:1 with a window and
12:1 causal, ragged lengths, float32 and bfloat16.  Tolerances, relative to
the largest |o| of the reference: float32 1e-5 (two f32 orders of one
online softmax); bfloat16 1e-2 (both compute in f32 from the same bf16
inputs and round once; one bf16 rounding is 2^-8 of max |o| at most).  A
head size the kernel is not built for (96) still raises.

Mamba (``models/ssm.py``): ``mamba`` over a prompt that crosses the scan's
chunk boundary, and ``mamba_decode`` steps from the prompt's cache, against
the reference's functions with the same weights (float32): 1e-5 of the
largest |output| (float32 sums in other orders; the f32 state is carried
over 150 steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.kernels import ops as jops
from repro.models import ssm as JS
from repro_torch.configs import ARCHS
from repro_torch.kernels import flash_attn, ops, ref
from repro_torch.models import ssm

F32_TOL, BF16_TOL = 1e-5, 1e-2
MAMBA_TOL = 1e-5

HEADS = {
    "gqa5_window": dict(B=1, Hq=5, Hkv=1, Sq=45, Skv=45,
                        kw=dict(causal=True, window=13)),
    "gqa12_causal": dict(B=2, Hq=12, Hkv=1, Sq=37, Skv=37,
                         kw=dict(causal=True)),
    "gqa5_offset": dict(B=1, Hq=10, Hkv=2, Sq=21, Skv=50,
                        kw=dict(causal=True, q_offset=29)),
}


def _arrays(rng, B, Hq, Hkv, Sq, Skv, d):
    return (rng.normal(size=(B, Hq, Sq, d)), rng.normal(size=(B, Hkv, Skv, d)),
            rng.normal(size=(B, Hkv, Skv, d)))


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(a, dtype):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(HEADS))
@pytest.mark.parametrize("d", [64, 192])
def test_flash_plain_matches_kernel_new_head_sizes(d, case, dtype):
    spec = HEADS[case]
    rng = np.random.default_rng(d + len(case))
    arrays = _arrays(rng, spec["B"], spec["Hq"], spec["Hkv"], spec["Sq"],
                     spec["Skv"], d)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jops.flash_attention(*(jnp.asarray(a, jdt) for a in arrays),
                                block_q=16, block_k=16, interpret=True,
                                **spec["kw"])
    got = ops.flash_attention(*(_t(a, dtype) for a in arrays), **spec["kw"])
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert _rel(got.float().numpy(), want) <= tol


@pytest.mark.parametrize("case", sorted(HEADS))
@pytest.mark.parametrize("d", [64, 192])
def test_flash_tc_emulation_matches_kernel_new_head_sizes(d, case):
    """The bf16 kernel's arithmetic (64-key tiles, split P) at d 64 and
    192, bf16 inputs."""
    spec = HEADS[case]
    rng = np.random.default_rng(2 * d + len(case))
    arrays = _arrays(rng, spec["B"], spec["Hq"], spec["Hkv"], spec["Sq"],
                     spec["Skv"], d)
    want = jops.flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in arrays),
                                block_q=16, block_k=16, interpret=True,
                                **spec["kw"])
    kw = {"window": None, "softcap": None, "q_offset": 0, **spec["kw"],
          "scale": d ** -0.5}
    got = ref.flash_attention_tc_emulated(
        *(_t(a, torch.bfloat16) for a in arrays), **kw)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) <= BF16_TOL


def test_head_sizes_of_the_served_configs_are_built():
    """Every registered config's head size (and its reduced one) is a size
    K13 is built for; a size it is not built for raises before any launch,
    whatever the device, and a built one off the CPU and the card raises on
    the device."""
    for cfg in ARCHS.values():
        if cfg.block != "rwkv":
            assert cfg.hd in flash_attn.HEAD_DIMS, cfg.name
            assert cfg.reduced().hd in flash_attn.HEAD_DIMS, cfg.name
    assert {ARCHS["nemotron-4-340b"].hd, ARCHS["hymba-1.5b"].hd} == {192, 64}

    def meta(d):
        q = torch.empty(1, 4, 8, d, dtype=torch.bfloat16, device="meta")
        kv = torch.empty(1, 2, 8, d, dtype=torch.bfloat16, device="meta")
        return q, kv, kv

    kw = dict(causal=True, scale=0.1, window=None, softcap=None, q_offset=0)
    with pytest.raises(NotImplementedError, match="head size 96"):
        flash_attn.flash_attention_cuda(*meta(96), **kw)
    for d in (64, 192):
        with pytest.raises(ValueError, match="CUDA device"):
            flash_attn.flash_attention_cuda(*meta(d), **kw)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------
def _mamba_pair(seed=0):
    """hymba's reduced config in both packages and one set of Mamba weights
    (the reference's init, carried across by name)."""
    jcfg = JARCHS["hymba-1.5b"].reduced()
    cfg = ARCHS["hymba-1.5b"].reduced()
    tree = JS.init_mamba(jax.random.PRNGKey(seed), jcfg)
    p = ssm.init_mamba(torch.Generator("cpu").manual_seed(0), cfg)
    params = dict(p.named_parameters())
    assert set(params) == set(tree)
    for name, leaf in tree.items():
        a = np.asarray(leaf)
        assert tuple(params[name].shape) == a.shape, name
        params[name].copy_(torch.tensor(a))
    return jcfg, cfg, tree, p


def test_mamba_matches_reference():
    """The full-sequence path over 150 steps: two chunks of the scan."""
    jcfg, cfg, tree, p = _mamba_pair()
    assert 150 > ssm._SCAN_CHUNK
    x = np.random.default_rng(3).normal(size=(2, 150, cfg.d_model))
    want = np.asarray(JS.mamba(jnp.asarray(x, jnp.float32), tree, jcfg))
    got = ssm.mamba(_t(x, torch.float32), p, cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= MAMBA_TOL


def test_mamba_decode_matches_reference():
    """Prefill 20 tokens through the core (conv tail, f32 state), then 3
    decode steps, in both packages."""
    jcfg, cfg, tree, p = _mamba_pair(1)
    x = np.random.default_rng(4).normal(size=(2, 23, cfg.d_model))
    xj, xt = jnp.asarray(x, jnp.float32), _t(x, torch.float32)
    _, jtail, jh = JS._mamba_core(xj[:, :20], tree, jcfg)
    _, ttail, th = ssm._mamba_core(xt[:, :20], p, cfg)
    assert _rel(ttail.numpy(), jtail) <= MAMBA_TOL
    assert _rel(th.numpy(), jh) <= MAMBA_TOL
    jc = {"conv": jtail, "h": jh}
    tc = {"conv": ttail, "h": th}
    assert ssm.init_mamba_cache(cfg, 2, device="cpu")["h"].dtype \
        == torch.float32
    for t in range(20, 23):
        jo, jc = JS.mamba_decode(xj[:, t:t + 1], tree, jcfg, jc)
        to, tc = ssm.mamba_decode(xt[:, t:t + 1], p, cfg, tc)
        assert to.shape == (2, 1, cfg.d_model)
        assert _rel(to.numpy(), jo) <= MAMBA_TOL
        assert _rel(tc["h"].numpy(), jc["h"]) <= MAMBA_TOL
        assert tc["conv"].dtype == torch.float32


def test_mamba_decode_continues_the_full_sequence():
    """The port's own prefill + decode equals its full-sequence pass."""
    _, cfg, _, p = _mamba_pair(2)
    x = _t(np.random.default_rng(5).normal(size=(2, 12, cfg.d_model)),
           torch.float32)
    full = ssm.mamba(x, p, cfg)
    _, tail, h = ssm._mamba_core(x[:, :9], p, cfg)
    cache = {"conv": tail, "h": h}
    for t in range(9, 12):
        out, cache = ssm.mamba_decode(x[:, t:t + 1], p, cfg, cache)
        err = float((out[:, 0] - full[:, t]).abs().max())
        assert err <= MAMBA_TOL * float(full.abs().max())
