"""The arithmetic of the bf16 K13 (tensor cores) against the JAX package.

``ref.flash_attention_tc_emulated`` runs the bf16 kernel's algorithm in
torch: key tiles of the kernel's width with its tile skipping and masking
(``ref.flash_tiles``), scores from bf16 operands summed in f32, the online
softmax on ``exp2``, and P split into two bf16 terms for P·V.  It is held
here, from the same numpy inputs rounded to bfloat16, against the
reference's Pallas kernel in interpret mode, and against the port's plain
version with ``chip_smoke.py``'s value-by-value measure.  Tolerances:

* against the JAX kernel, 1e-2 of the largest |o| (both compute in f32
  from the same bf16 inputs and round once to bf16 at the end; they may
  differ by one bf16 rounding, 2^-8 of max |o| at most);
* against the plain version, ``chip_smoke._value_rel`` <= 1: every value
  within one bf16 step (2^-7 |o|) plus 1e-5 of max |o|, the card's bf16
  check.  Rounding P to bf16 once instead of splitting it must fail it.
"""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref

from test_torch_lm_kernels import FLASH_CASES

REPO = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

JAX_TOL = 1e-2
VALUE_TOL32 = chip_smoke.K13_TOL["float32"]


@pytest.fixture
def rng():
    return np.random.default_rng(17)


def _qkv(rng, B, Hq, Hkv, Sq, Skv, d):
    return (rng.normal(size=(B, Hq, Sq, d)), rng.normal(size=(B, Hkv, Skv, d)),
            rng.normal(size=(B, Hkv, Skv, d)))


def _bf16(a):
    return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)


def _against_jax(arrays, *, block_k=64, **kw):
    """max |emulation - JAX kernel| / max |JAX kernel|, bf16 inputs."""
    want = jops.flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in arrays),
                                block_q=16, block_k=16, interpret=True, **kw)
    d = arrays[0].shape[-1]
    kw.setdefault("scale", d ** -0.5)
    kw = {"window": None, "softcap": None, "q_offset": 0, **kw}
    got = ref.flash_attention_tc_emulated(*(_bf16(a) for a in arrays),
                                          block_k=block_k, **kw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max()), got, want


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_emulation_matches_kernel(rng, case, d):
    rel, _, _ = _against_jax(_qkv(rng, 2, 4, 2, 40, 40, d),
                             **FLASH_CASES[case])
    assert rel <= JAX_TOL


@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2), (4, 1)])
def test_emulation_gqa(rng, Hq, Hkv):
    rel, _, _ = _against_jax(_qkv(rng, 1, Hq, Hkv, 32, 32, 16), causal=True,
                             window=12, softcap=50.0)
    assert rel <= JAX_TOL


@pytest.mark.parametrize("Sq,Skv,kw", [
    (33, 65, dict(causal=False, softcap=50.0)),
    (8, 40, dict(causal=False, softcap=50.0)),
    (40, 24, dict(causal=False, softcap=50.0)),
    (150, 150, dict(causal=True, window=37, softcap=50.0)),
    (50, 150, dict(causal=True, q_offset=100, softcap=50.0)),
], ids=["33x65", "8x40", "40x24", "150x150-window37", "50x150-offset100"])
def test_emulation_ragged_shapes(rng, Sq, Skv, kw):
    """Partial key and query tiles; the last two cross several 64-key
    tiles, skipped, masked and unmasked."""
    rel, _, _ = _against_jax(_qkv(rng, 1, 2, 1, Sq, Skv, 128), **kw)
    assert rel <= JAX_TOL


@pytest.mark.parametrize("block_k", [64, 16])
def test_emulation_fully_masked_rows(rng, block_k):
    """q_offset < 0 puts the first five queries before every key: those
    rows give 0, not NaN, as in the JAX kernel."""
    rel, got, want = _against_jax(_qkv(rng, 1, 2, 2, 24, 24, 16),
                                  block_k=block_k, causal=True, q_offset=-5)
    assert np.all(want[:, :, :5] == 0.0) and np.all(got[:, :, :5] == 0.0)
    assert rel <= JAX_TOL


@pytest.mark.parametrize("Sq,Skv,block_q,block_k,causal,window,q_offset", [
    (200, 200, 64, 64, True, None, 0),
    (200, 200, 64, 64, True, 50, 0),
    (100, 300, 64, 64, True, 70, 200),
    (100, 300, 64, 64, False, None, 0),
    (90, 90, 64, 16, True, 20, -30),
    (40, 100, 16, 16, True, 1, 60),
])
def test_flash_tiles_cover_exactly(Sq, Skv, block_q, block_k, causal, window,
                                   q_offset):
    """Every valid (query, key) pair lies in a visited tile, and a tile
    left unmasked holds only valid pairs for every valid row."""
    mask = ref._attn_mask(Sq, Skv, causal, window, q_offset, "cpu").numpy()
    for q0 in range(0, Sq, block_q):
        rows = mask[q0:q0 + block_q]
        tiles = ref.flash_tiles(q0, block_q, block_k, Sq=Sq, Skv=Skv,
                                causal=causal, window=window,
                                q_offset=q_offset)
        seen = np.zeros(Skv, dtype=bool)
        for kt, masked in tiles:
            seen[kt:kt + block_k] = True
            if not masked:
                assert kt + block_k <= Skv
                assert rows[:, kt:kt + block_k].all()
        assert not (rows.any(axis=0) & ~seen).any()


def test_split_p_passes_value_check_where_single_rounding_fails(rng):
    """Global causal attention, 512 keys, d = 128, softcap 50: the split P
    keeps every value within the card's bf16 check; P rounded once to bf16
    (FA2's choice) moves small outputs by far more than one bf16 step."""
    arrays = _qkv(rng, 1, 2, 1, 512, 512, 128)
    q, k, v = (_bf16(a) for a in arrays)
    kw = dict(causal=True, scale=128 ** -0.5, window=None, softcap=50.0,
              q_offset=0)
    plain = ref.flash_attention_plain(q, k, v, **kw)
    split = ref.flash_attention_tc_emulated(q, k, v, **kw)
    single = ref.flash_attention_tc_emulated(q, k, v, split_p=False, **kw)
    assert chip_smoke._value_rel(split, plain, VALUE_TOL32) <= 1.0
    assert chip_smoke._value_rel(single, plain, VALUE_TOL32) > 1.0
