"""Port parity: K1 and K2 in their two bf16 operand mixes, and the bf16
``reference`` route (reference CG over K1), against the JAX package on the
CPU.

The same numpy inputs go to both packages; the JAX side runs its Pallas
kernels in interpret mode, the port the plain versions its wrappers take
for CPU tensors (the oracles ``chip_smoke.py`` holds the CUDA builds
against on the card).  Mixes: ``bf16`` (every operand bf16) and
``bf16_ir`` (bf16 vectors over an f32 operator), accumulating in f32.
Tolerances, each with its reason:

* bf16 fields: value by value, |o - p| <= 2^-7 |p| + 1e-5 max |p| (each
  side rounds one f32 result to bf16, so they may differ by one bf16 step
  plus their f32 difference);
* partials: f32 sums of the same terms in two orders, BF16_PART_TOL = 1e-5
  relative, summed;
* the bf16 reference route at n = 4 and 5 on a 2x2x2 grid, 12 iterations:
  history entries 0..6 within 2e-2 relative (every vector, scalar and norm
  is bf16: one bf16 step of w that the two f32 orders of the operator
  round apart moves the later entries; measured: 0 at n = 5, 1.4e-2 at
  n = 4, where entry 7 is 2.6e-2 off and entry 8 parts by 80%).
"""
import contextlib
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.nekbone import NekboneCase as JaxCase
from repro.kernels import nekbone_ax as jax_kernels
from repro.kernels import ops as jax_ops
from repro_torch.core.geom import random_spd_metric
from repro_torch.core.nekbone import NekboneCase as TorchCase
from repro_torch.core.sem import derivative_matrix
from repro_torch.kernels import _build
from repro_torch.kernels import nekbone_ax as torch_kernels
from repro_torch.kernels import ops as torch_ops

REPO = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

BF16_STEP = 2.0 ** -7
BF16_F32_TOL = chip_smoke.BF16_F32_TOL
PART_RTOL = chip_smoke.BF16_PART_TOL
ROUTE_RTOL, ROUTE_ENTRIES = 2e-2, 7
# (S, O): the storage of the fields and of D and the metric
MIXES = {"bf16": (jnp.bfloat16, jnp.bfloat16),
         "bf16_ir": (jnp.bfloat16, jnp.float32)}
TORCH_DTYPE = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def _np32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a, dt):
    """A jnp array as a torch tensor of the matching dtype (via f32)."""
    return torch.as_tensor(_np32(a)).to(TORCH_DTYPE[dt])


def _value_excess(got, want):
    """max |got - want| / (one bf16 step of want + 1e-5 max |want|): the
    values agree where this is <= 1."""
    got = got.float().numpy()
    want = _np32(want)
    limit = BF16_STEP * np.abs(want) + BF16_F32_TOL * np.abs(want).max()
    return float((np.abs(got - want) / limit).max())


def _sum_err(got, want):
    sg, sw = float(got.double().sum()), float(np.sum(_np32(want), dtype=float))
    return abs(sg - sw) / abs(sw)


def _operands(rng, n, E, mix):
    """Random u (p), an SPD metric, a 0/1 mask mostly 1, r and a c in
    (0, 1], as jnp arrays in the mix's dtypes."""
    S, O = MIXES[mix]
    n3 = n ** 3
    u = rng.normal(size=(E, n3))
    g = random_spd_metric(rng, E, n).reshape(E, 6, n3)
    mask = (rng.random((E, n3)) > 0.2).astype(np.float64)
    r = rng.normal(size=(E, n3))
    c = rng.uniform(0.25, 1.0, size=(E, n3))
    D = derivative_matrix(n)
    return (jnp.asarray(u, S), jnp.asarray(D, O), jnp.asarray(g, O),
            jnp.asarray(mask, S), jnp.asarray(r, S), jnp.asarray(c, S))


@pytest.mark.parametrize("n,E", [(2, 6), (4, 6), (5, 4), (10, 2)])
@pytest.mark.parametrize("mix", ["bf16", "bf16_ir"])
def test_bf16_ax_plain_matches_reference(x64, mix, n, E):
    """K1: w value by value, in S, computed in f32 and rounded once."""
    S, O = MIXES[mix]
    rng = np.random.default_rng(30 + n)
    ju, jD, jg, *_ = _operands(rng, n, E, mix)
    jw = jax_kernels.nekbone_ax_pallas(ju, jD, jD.T, jg, n=n, block_e=2,
                                       interpret=True)
    tw = torch_kernels.nekbone_ax_cuda(_t(ju, S), _t(jD, O), _t(jg, O), n=n)
    assert tw.dtype == torch.bfloat16 and jw.dtype == jnp.bfloat16
    assert _value_excess(tw, jw) <= 1.0


@pytest.mark.parametrize("n,E", [(3, 6), (5, 4), (10, 2)])
@pytest.mark.parametrize("mix", ["bf16", "bf16_ir"])
def test_bf16_ax_dots_plain_matches_reference(x64, mix, n, E):
    """K2: w value by value in S, pap and rcz per element in f32 (A),
    summed, against the reference's per-block partials."""
    S, O = MIXES[mix]
    rng = np.random.default_rng(40 + n)
    ops = _operands(rng, n, E, mix)
    ju, jD, jg, jm, jr, jc = ops
    jw, jpap, jrcz = jax_kernels.nekbone_ax_dots_pallas(
        ju, jD, jD.T, jg, jm, jr, jc, n=n, block_e=2, interpret=True)
    tw, tpap, trcz = torch_kernels.nekbone_ax_dots_cuda(
        _t(ju, S), _t(jD, O), _t(jg, O), _t(jm, S), _t(jr, S), _t(jc, S),
        n=n)
    assert tw.dtype == torch.bfloat16
    assert tpap.dtype == trcz.dtype == torch.float32
    assert jpap.dtype == jrcz.dtype == jnp.float32
    assert _value_excess(tw, jw) <= 1.0
    assert _sum_err(tpap, jpap) <= PART_RTOL
    assert _sum_err(trcz, jrcz) <= PART_RTOL


@pytest.mark.parametrize("mix", ["bf16", "bf16_ir"])
def test_ops_ax_dots_sums_in_the_accumulation_type(x64, mix):
    """``ops.nekbone_ax_dots`` on natural shapes: w value by value and the
    two summed scalars in f32 (the partials' A), as the reference's
    ``ops.nekbone_ax_dots`` returns them."""
    S, O = MIXES[mix]
    n, E = 4, 6
    rng = np.random.default_rng(47)
    ju, jD, jg, jm, jr, jc = _operands(rng, n, E, mix)
    shape = (E, n, n, n)
    jw, jpap, jrcz = jax_ops.nekbone_ax_dots(
        ju.reshape(shape), jD, jg.reshape(E, 6, n, n, n), jm.reshape(shape),
        jr.reshape(shape), jc.reshape(shape), block_e=2, interpret=True)
    tw, tpap, trcz = torch_ops.nekbone_ax_dots(
        _t(ju, S).reshape(shape), _t(jD, O),
        _t(jg, O).reshape(E, 6, n, n, n), _t(jm, S).reshape(shape),
        _t(jr, S).reshape(shape), _t(jc, S).reshape(shape))
    assert tw.shape == shape and tw.dtype == torch.bfloat16
    assert tpap.dtype == trcz.dtype == torch.float32
    assert jpap.dtype == jrcz.dtype == jnp.float32
    assert _value_excess(tw.reshape(E, -1), jw.reshape(E, -1)) <= 1.0
    for got, want in ((tpap, jpap), (trcz, jrcz)):
        assert abs(float(got) - float(want)) <= PART_RTOL * abs(float(want))


@pytest.mark.parametrize("mix", ["bf16", "bf16_ir"])
def test_stand_ins_that_skip_a_rounding_fail_the_checks(x64, mix):
    """The negative checks of ``chip_smoke.py``, on the CPU against the
    reference: K1 with D u rounded to storage before the metric fails the
    value check; K2 with its partials stored in S fails the partial check."""
    S, O = MIXES[mix]
    n, E = 10, 8
    rng = np.random.default_rng(53)
    ju, jD, jg, jm, jr, jc = _operands(rng, n, E, mix)
    targs = (_t(ju, S), _t(jD, O), _t(jg, O))
    jw = jax_kernels.nekbone_ax_pallas(ju, jD, jD.T, jg, n=n, block_e=2,
                                       interpret=True)
    bad_w = chip_smoke._k1_grad_in_storage(*targs, n=n)
    assert _value_excess(bad_w, jw) > 1.0
    jw2, jpap, jrcz = jax_kernels.nekbone_ax_dots_pallas(
        ju, jD, jD.T, jg, jm, jr, jc, n=n, block_e=2, interpret=True)
    _, bpap, brcz = chip_smoke._k2_parts_in_storage(
        *targs, _t(jm, S), _t(jr, S), _t(jc, S), n=n)
    assert bpap.dtype == brcz.dtype == torch.bfloat16
    assert max(_sum_err(bpap, jpap), _sum_err(brcz, jrcz)) > PART_RTOL


@pytest.mark.parametrize("n", [4, 5])
def test_bf16_reference_route_matches_reference(x64, n):
    """The bf16 policy on ``ax_impl="pallas"``: reference CG over K1 with
    every vector bf16, 12 iterations on a 2x2x2 grid, in both packages."""
    kw = dict(n=n, grid=(2, 2, 2), precision="bf16", ax_impl="pallas")
    jcase = JaxCase(dtype=jnp.float64, **kw)
    tcase = TorchCase(dtype=torch.float64, device="cpu", **kw)
    _, jf = jcase.manufactured()
    tf = torch.as_tensor(_np32(jf)).to(tcase.dtype)
    ref = jcase.solve(jf, niter=12)
    _build.reset_launches()
    got = tcase.solve(tf, niter=12)
    assert not any(_build.LAUNCHES.values())
    assert got.pipeline == "reference"
    assert got.x.dtype == got.history.dtype == torch.bfloat16
    h_ref = np.asarray(ref.rnorm_history.astype(jnp.float32), np.float64)
    h = got.history.double().numpy()
    assert h[0] == h_ref[0]
    rel = np.abs(h - h_ref)[:ROUTE_ENTRIES] / h_ref[:ROUTE_ENTRIES]
    assert rel.max() <= ROUTE_RTOL, rel


def test_k1_k2_wrappers_take_both_bf16_mixes():
    """K1 and K2 pick a build by operand dtype like K3 to K12: u (p, mask,
    r, c) in S, D and the metric in O; a mix of dtypes no build has raises
    and names the builds; off the card the wrappers raise before any of
    that reaches a kernel."""
    f64, f32, bf16 = torch.float64, torch.float32, torch.bfloat16

    def t(dtype):
        return torch.zeros(1, dtype=dtype)

    pick = torch_kernels.build_for
    for O, mix in ((bf16, "bf16"), (f32, "bf16_ir")):
        assert pick("nekbone_ax", u2=(t(bf16), ()), D=(t(O), (), "O"),
                    g2=(t(O), (), "O")) == mix
        assert pick("nekbone_ax_dots", p2=(t(bf16), ()), D=(t(O), (), "O"),
                    g2=(t(O), (), "O"), mask2=(t(bf16), ()),
                    r2=(t(bf16), ()), c2=(t(bf16), ())) == mix
    assert pick("nekbone_ax", u2=(t(f64), ()), D=(t(f64), (), "O"),
                g2=(t(f64), (), "O")) == "f64"
    with pytest.raises(TypeError, match="match no build"):
        pick("nekbone_ax", u2=(t(bf16), ()), D=(t(f64), (), "O"))
    with pytest.raises(NotImplementedError, match="float16"):
        pick("nekbone_ax", u2=(t(torch.float16), ()))
    assert "nekbone_ax" in _build.SOURCES
    assert set(_build.SOURCES["nekbone_ax"]) == set(_build.DTYPES)
    assert set(_build.SOURCES["nekbone_ax_dots"]) == set(_build.DTYPES)
    n, E = 3, 2
    meta = torch.empty(E, n ** 3, dtype=bf16, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        torch_kernels.nekbone_ax_cuda(
            meta, torch.empty(n, n, dtype=bf16, device="meta"),
            torch.empty(E, 6, n ** 3, dtype=bf16, device="meta"), n=n)


def test_launch_counts_each_build(monkeypatch):
    """``_build.launch`` adds one to its wrapper's count and one to its
    build's (K13's with its head size and window), and ``reset_launches``
    sets both to nothing: the counts the kernels line of ``chip_smoke.py``
    reads per build.  The C entry points are stand-ins that return 0."""
    class Entry:
        argtypes = None

        def __call__(self, *args):
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "load", lambda name: type(
        "Lib", (), {"__getattr__": lambda self, attr: Entry()})())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: Stream())
    _build.reset_launches()
    for _ in range(2):
        _build.launch("nekbone_ax_bf16", [], "cuda", ())
    _build.launch("nekbone_ax_f64", [], "cuda", ())
    _build.launch("nekbone_ax_pap_bf16_ir", [], "cuda", (),
                  library="nekbone_ax_dots_bf16_ir")
    _build.launch("flash_attn_bf16", [], "cuda", (), detail="_d64")
    _build.launch("flash_attn_bf16", [], "cuda", (),
                  detail="_d64_window1024")
    assert _build.LAUNCHES["nekbone_ax"] == 3
    assert _build.LAUNCHES["nekbone_ax_pap"] == 1
    assert _build.LAUNCHES["flash_attn"] == 2
    assert _build.BUILD_LAUNCHES == {
        "nekbone_ax_bf16": 2, "nekbone_ax_f64": 1,
        "nekbone_ax_pap_bf16_ir": 1, "flash_attn_bf16_d64": 1,
        "flash_attn_bf16_d64_window1024": 1}
    _build.reset_launches()
    assert not any(_build.LAUNCHES.values()) and not _build.BUILD_LAUNCHES
