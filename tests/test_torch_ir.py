"""Port parity: iterative refinement (the ``ir`` route), the reduced-precision
policies on v2 and v1, and the bf16 builds' plain versions of K3, K4 and K5,
against the JAX package on the CPU.

The same numpy inputs go to both packages; the JAX side runs its Pallas
kernels in interpret mode, the port the plain versions its wrappers take
for CPU tensors.  Tolerances, each with its reason:

* outer histories of ``cg_ir_fixed_iters``: entry 0 (the norm of b) to
  1e-12; each sweep's contraction ``h[k] / h[k-1]`` within SWEEP_FACTOR of
  the reference's.  A reduced-precision sweep ends at a noisy floor: the
  port and the reference differ here by up to 1.6x, and one route against
  itself with its f32 partials summed in another order by up to 3.0x
  (n = 10, grids 4x4x4 and 4x4x8).  A sweep that failed to refine would
  miss by the whole contraction (1e-1 .. 1e-6 per sweep at these sizes).
* non-refined f32 histories: 1e-4 relative over entries 0..10 (measured
  port-vs-reference spread at n = 6, grid 2x2x4: at most 4.6e-5; later
  entries reach f32's round-off floor);
* non-refined bf16 histories: v1 2e-3 over entries 0..12 (measured 7.7e-4:
  both sum the same bf16 values in f32), v2 2e-2 over entries 0..6
  (measured 6.3e-3: f32 sums in another order flip bf16 steps of p and r);
* bf16 fields of the plain kernels against the Pallas kernels: value by
  value, one bf16 step (2^-7 of the value) plus 1e-5 of the largest value
  (each side rounds one f32 result); partials, f32 sums in two orders,
  1e-5 relative.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.cg as jax_cg
import repro.core.cost as jax_cost
from repro.core import gs as jax_gs
from repro.core.cg_fused import cg_fused_fixed_iters as jax_v1
from repro.core.cg_fused import cg_fused_v2_fixed_iters as jax_v2
from repro.core.cg_fused import cg_ir_fixed_iters as jax_ir
from repro.core.nekbone import NekboneCase as JaxCase
from repro.kernels import nekbone_ax as jax_kernels
from repro.kernels import ops as jax_ops
from repro_torch.core import cg as torch_cg
from repro_torch.core import cost as torch_cost
from repro_torch.core import solvers as torch_solvers
from repro_torch.core.cg_fused import cg_fused_fixed_iters as torch_v1
from repro_torch.core.cg_fused import cg_fused_v2_fixed_iters as torch_v2
from repro_torch.core.cg_fused import cg_ir_fixed_iters as torch_ir
from repro_torch.core.geom import random_spd_metric
from repro_torch.core.nekbone import NekboneCase as TorchCase
from repro_torch.core.sem import derivative_matrix
from repro_torch.kernels import nekbone_ax as torch_kernels
from repro_torch.kernels import ops as torch_ops

SWEEP_FACTOR = 4.0
F32_RTOL, F32_ENTRIES = 1e-4, 11
BF16_STEP = 2.0 ** -7
BF16_F32_TOL = 1e-5
PART_RTOL = 1e-5
SWEEPS = {"f32_ir": 2, "bf16_ir": 5}


def _cases(n, grid):
    """The fp64 case in both packages and the reference's manufactured
    right-hand side, as numpy."""
    jcase = JaxCase(n=n, grid=grid, dtype=jnp.float64)
    tcase = TorchCase(n=n, grid=grid, dtype=torch.float64, device="cpu")
    return jcase, tcase, np.array(jcase.manufactured()[1])


def _assert_outer(got, want, factor=SWEEP_FACTOR):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert abs(got[0] - want[0]) <= 1e-12 * want[0]
    ratio = (got[1:] / got[:-1]) / (want[1:] / want[:-1])
    assert np.all(np.abs(np.log(ratio)) <= np.log(factor)), (got, want)


# ---------------------------------------------------------------------------
# cg_ir_fixed_iters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision,variant", [
    ("f32_ir", "v2"), ("f32_ir", "v1"), ("f32_ir", "sstep"),
    ("bf16_ir", "v2"), ("bf16_ir", "v1")])
def test_cg_ir_fixed_iters_matches_reference(x64, precision, variant):
    """The reference tests' size (n=5, 2x2x2, 30 inner iterations): outer
    histories within the sweep envelope, the default sweep counts (5 below
    4-byte storage, 2 otherwise), and the refined solution in f64."""
    jcase, tcase, f = _cases(5, (2, 2, 2))
    kw = dict(grid=(2, 2, 2), niter=30, precision=precision,
              variant=variant)
    ref = jax_ir(jnp.asarray(f), D=jcase.D, g=jcase.g, mask=jcase.mask,
                 c=jcase.c, **kw)
    got = torch_ir(torch.as_tensor(f), D=tcase.D, g=tcase.g,
                   mask=tcase.mask, c=tcase.c, **kw)
    sweeps = SWEEPS[precision]
    assert got.pipeline == "ir" and got.x.dtype == torch.float64
    assert int(got.iters) == int(ref.iters) == sweeps * 30
    assert got.history.shape == (sweeps + 1,)
    _assert_outer(got.history.numpy(), ref.rnorm_history)


def test_ir_builds_the_box_fields_when_omitted(x64):
    """mask and c default to the structured box's, as in the reference:
    the run is bitwise the one given the case's own fields."""
    _, tcase, f = _cases(4, (2, 2, 2))
    kw = dict(D=tcase.D, g=tcase.g, grid=(2, 2, 2), niter=10,
              precision="bf16_ir", outer_iters=2)
    a = torch_ir(torch.as_tensor(f), **kw)
    b = torch_ir(torch.as_tensor(f), mask=tcase.mask, c=tcase.c, **kw)
    assert torch.equal(a.history, b.history) and torch.equal(a.x, b.x)
    with pytest.raises(ValueError, match="variant"):
        torch_ir(torch.as_tensor(f), variant="v3", **kw)


def test_ir_recovers_f64_floor_small(x64):
    """bf16_ir on n=6, 2x2x4, 40 inner iterations: the outer residual
    reaches the fp64 floor of the same fixed-iteration budget (plain fp64
    CG, the lower of the port's and the reference's: after 40 iterations
    two fp64 orders differ by 13% here), and the refined solution is
    f64."""
    jcase, tcase, f = _cases(6, (2, 2, 4))
    niter = 40
    ref = jax_cg.cg_fixed_iters(jcase.ax_full, jnp.asarray(f), niter=niter,
                                dot=jcase.dot())
    plain = torch_cg.cg_fixed_iters(tcase.ax_full, torch.as_tensor(f),
                                    niter=niter, dot=tcase.dot())
    rel_ref = min(float(plain.rnorm / plain.history[0]),
                  float(ref.rnorm / ref.rnorm_history[0]))
    ir = torch_ir(torch.as_tensor(f), D=tcase.D, g=tcase.g, grid=(2, 2, 4),
                  niter=niter, precision="bf16_ir")
    assert ir.x.dtype == torch.float64
    assert bool(torch.isfinite(ir.history).all())
    assert float(ir.rnorm / ir.history[0]) <= rel_ref


def test_ir_monotone_outer_residuals(x64):
    """No sweep raises the true residual (x 1.05, the reference's own
    bound): the inner solves run full length, past CG's transient."""
    _, tcase, f = _cases(5, (2, 2, 2))
    ir = torch_ir(torch.as_tensor(f), D=tcase.D, g=tcase.g, grid=(2, 2, 2),
                  niter=30, precision="bf16_ir", outer_iters=3)
    hist = ir.history.numpy()
    assert hist.shape == (4,)
    assert np.all(hist[1:] <= hist[:-1] * 1.05), hist


@pytest.mark.parametrize("ax_impl,precision", [
    ("pallas_fused_cg_v2", "bf16_ir"), ("pallas_fused_cg", "f32_ir"),
    ("pallas_sstep_v3", "f32_ir")])
def test_ir_route_through_case(x64, ax_impl, precision):
    """A refined case routes a fixed-iteration solve to ``ir``, which runs
    cg_ir_fixed_iters over the case's pipeline (v2, v1 or s-step): bitwise
    the direct call."""
    case = TorchCase(n=4, grid=(2, 2, 2), dtype=torch.float64,
                     precision=precision, ax_impl=ax_impl, s=2, device="cpu")
    assert case.dtype == torch.float64           # the outer precision
    assert torch_solvers.route_name(case, niter=12) == "ir"
    _, f = case.manufactured()
    res = case.solve(f, niter=12)
    variant = {"pallas_fused_cg_v2": "v2", "pallas_fused_cg": "v1",
               "pallas_sstep_v3": "sstep"}[ax_impl]
    direct = torch_ir(f, D=case.D, g=case.g, grid=case.grid, niter=12,
                      precision=precision, mask=case.mask, c=case.c,
                      variant=variant, s=2)
    assert res.pipeline == "ir" and res.x.dtype == torch.float64
    assert torch.equal(res.history, direct.history)
    assert torch.equal(res.x, direct.x)
    assert float(res.history[-1]) < float(res.history[0])


def test_ir_solve_matches_reference(x64):
    """The generic refinement loop around a 10-iteration f32 CG: outer
    2-norm histories within the sweep envelope."""
    jcase, tcase, f = _cases(4, (2, 2, 2))

    def jax_inner(r):
        A = lambda u: jcase.ax_full(u.astype(jnp.float64)).astype(jnp.float32)
        return jax_cg.cg_fixed_iters(A, r, niter=10).x

    def torch_inner(r):
        A = lambda u: tcase.ax_full(u.to(torch.float64)).to(torch.float32)
        return torch_cg.cg_fixed_iters(A, r, niter=10).x

    ref = jax_cg.ir_solve(jcase.ax_full, jnp.asarray(f), jax_inner,
                          outer_iters=3, lo_dtype=jnp.float32)
    got = torch_cg.ir_solve(tcase.ax_full, torch.as_tensor(f), torch_inner,
                            outer_iters=3, lo_dtype=torch.float32)
    assert got.pipeline == "ir" and int(got.iters) == 3
    assert got.x.dtype == torch.float64
    _assert_outer(got.history.numpy(), ref.rnorm_history)


def test_ir_overhead_streams_matches_reference():
    for inner in (1, 12, 100):
        for hi, lo in ((8, 2), (8, 4), (4, 2)):
            assert torch_cost.ir_overhead_streams(inner, hi, lo) == \
                jax_cost.ir_overhead_streams(inner, hi, lo)
    assert torch_cost.ir_overhead_streams(12) == \
        jax_cost.ir_overhead_streams(12)


# ---------------------------------------------------------------------------
# the non-refined reduced-precision policies on v2 and v1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision,ax_impl,entries,rtol", [
    ("f32", "pallas_fused_cg_v2", F32_ENTRIES, F32_RTOL),
    ("f32", "pallas_fused_cg", F32_ENTRIES, F32_RTOL),
    ("bf16", "pallas_fused_cg_v2", 7, 2e-2),
    ("bf16", "pallas_fused_cg", 13, 2e-3)])
def test_reduced_precision_matches_reference(x64, precision, ax_impl,
                                             entries, rtol):
    """f32 and bf16 storage on v2 and v1 (n=6, 2x2x4, 12 iterations):
    the history over its pre-asymptotic entries, x in the storage dtype and
    the history in the accumulation dtype."""
    kw = dict(n=6, grid=(2, 2, 4), precision=precision, ax_impl=ax_impl)
    jcase = JaxCase(dtype=jnp.float64, **kw)
    tcase = TorchCase(dtype=torch.float64, device="cpu", **kw)
    _, jf = jcase.manufactured()
    tf = torch.as_tensor(np.asarray(jf, np.float64)).to(tcase.dtype)
    ref = jcase.solve(jf, niter=12)
    got = tcase.solve(tf, niter=12)
    storage = {"f32": torch.float32, "bf16": torch.bfloat16}[precision]
    assert got.x.dtype == storage and got.history.dtype == torch.float32
    h_ref = np.asarray(ref.rnorm_history, np.float64)[:entries]
    h = got.history.double().numpy()[:entries]
    rel = np.abs(h - h_ref) / h_ref
    assert rel.max() <= rtol, rel


@pytest.mark.parametrize("precision,storage", [("f32_ir", "f32"),
                                               ("bf16_ir", "bf16")])
def test_refined_policy_runs_as_storage_policy(x64, precision, storage):
    """A refined policy passed straight to an inner solve runs as its
    storage policy (bf16_ir keeping x, the metric and D in f32), as in the
    reference: v1 bitwise the port's own storage-policy run for f32_ir, and
    both solves within the reduced-precision envelopes of the
    reference's run of the same policy."""
    jcase, tcase, f = _cases(5, (2, 2, 2))
    kw = dict(grid=(2, 2, 2), niter=10, precision=precision)
    for jdrv, tdrv, extra in (
            (jax_v1, torch_v1, "mask"), (jax_v2, torch_v2, None)):
        jkw = dict(mask=jcase.mask, c=jcase.c) if extra else {}
        tkw = dict(mask=tcase.mask, c=tcase.c) if extra else {}
        ref = jdrv(jnp.asarray(f), D=jcase.D, g=jcase.g, **jkw, **kw)
        got = tdrv(torch.as_tensor(f), D=tcase.D, g=tcase.g, **tkw, **kw)
        assert got.x.dtype == torch.float32      # x_storage of both

        h_ref = np.asarray(ref.rnorm_history, np.float64)
        h = got.history.double().numpy()
        entries, rtol = (F32_ENTRIES, F32_RTOL) if storage == "f32" \
            else (7, 2e-2)
        rel = np.abs(h[:entries] - h_ref[:entries]) / h_ref[:entries]
        assert rel.max() <= rtol, (tdrv.__name__, rel)
    if precision == "f32_ir":
        a = torch_v1(torch.as_tensor(f), D=tcase.D, g=tcase.g,
                     mask=tcase.mask, c=tcase.c, **kw)
        b = torch_v1(torch.as_tensor(f), D=tcase.D, g=tcase.g,
                     mask=tcase.mask, c=tcase.c,
                     **dict(kw, precision=storage))
        assert torch.equal(a.history, b.history) and torch.equal(a.x, b.x)


# ---------------------------------------------------------------------------
# the plain versions of K4, K5 and K3 in the two bf16 operand mixes against
# the reference's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

MIXES = {"bf16": (jnp.bfloat16, jnp.bfloat16, jnp.bfloat16),
         "bf16_ir": (jnp.bfloat16, jnp.float32, jnp.float32)}
TORCH_DTYPE = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def _np32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a, dt):
    """A jnp array as a torch tensor of the matching dtype (via f32)."""
    return torch.as_tensor(_np32(a)).to(TORCH_DTYPE[dt])


def _assert_values(got, want):
    got = got.float().numpy()
    want = _np32(want)
    limit = BF16_STEP * np.abs(want) + BF16_F32_TOL * np.abs(want).max()
    assert np.all(np.abs(got - want) <= limit)


def _assert_sum(got, want):
    sg, sw = float(got.double().sum()), float(np.sum(_np32(want), dtype=float))
    assert abs(sg - sw) <= PART_RTOL * abs(sw), (sg, sw)


@pytest.mark.parametrize("mix", ["bf16", "bf16_ir"])
def test_bf16_slab_update_plain_match_reference(x64, mix):
    """K4 then K5 on n=5, grid 1x1x4 with one element per slab (sz=1), so
    the reference's w is unassembled like the port's: p, w, the stored x
    and r value by value; pap and rcr summed."""
    S, O, X = MIXES[mix]
    n, grid = 5, (1, 1, 4)
    E, n3 = 4, n ** 3
    rng = np.random.default_rng(16)
    jcase = JaxCase(n=n, grid=grid, dtype=jnp.float64)

    def continuous():
        u = jnp.asarray(rng.normal(size=jcase.mask.shape))
        return (jax_gs.ds_sum_local(u, grid) * jcase.mask).reshape(E, n3)

    p_prev, r = continuous().astype(S), continuous().astype(S)
    x = jnp.asarray(rng.normal(size=(E, n3))).astype(X)
    D = jcase.D.astype(O)
    g3 = jax_ops.diag_metric(jcase.g, E, n).astype(O)
    (mx, my, mz), (cx, cy, cz) = jax_ops.slab_axis_factors(grid, n, S)
    beta, alpha = 0.61, 0.37
    jp, jw, bot, top, jpap = jax_kernels.nekbone_ax_slab_pallas(
        p_prev, r, D, D.T, g3, mx, my, mz, jnp.full((1, 1), beta,
                                                    jnp.float32),
        n=n, grid=grid, sz=1, interpret=True, acc_dtype="float32")
    zero = jnp.zeros((1, bot.shape[1]), bot.dtype)
    addb = jnp.concatenate([zero, top[:-1]], axis=0)
    addt = jnp.concatenate([bot[1:], zero], axis=0)
    jx, jr, jrcr = jax_kernels.nekbone_cg_update_pallas(
        x, jp, r, jw, addb, addt, jnp.full((1, 1), alpha, jnp.float32), cx,
        cy, cz, n=n, grid=grid, sz=1, interpret=True, acc_dtype="float32")

    (tmx, tmy, tmz), (tcx, tcy, tcz) = torch_ops.slab_axis_factors(
        grid, n, TORCH_DTYPE[S], "cpu")
    tp, tw, tpap = torch_kernels.nekbone_ax_slab_cuda(
        _t(p_prev, S), _t(r, S), _t(D, O), _t(g3, O), tmx, tmy, tmz,
        torch.tensor(beta, dtype=torch.float32), n=n)
    assert tp.dtype == tw.dtype == torch.bfloat16
    assert tpap.dtype == torch.float32
    _assert_values(tp, jp)
    _assert_values(tw, jw)
    _assert_sum(tpap, jpap)
    tx, tr, trcr = torch_kernels.nekbone_cg_update_cuda(
        _t(x, X), _t(jp, S), _t(r, S), _t(jw, S),
        torch.tensor(alpha, dtype=torch.float32), tcx, tcy, tcz, n=n)
    assert tx.dtype == TORCH_DTYPE[X] and tr.dtype == torch.bfloat16
    _assert_values(tx, jx)
    _assert_values(tr, jr)
    _assert_sum(trcr, jrcr)


@pytest.mark.parametrize("mix", ["bf16", "bf16_ir"])
def test_bf16_ax_pap_plain_matches_reference(x64, mix):
    """K3 on a random SPD metric and a random 0/1 mask (n=4, E=6): w value
    by value, pap summed."""
    S, O, _ = MIXES[mix]
    n, E = 4, 6
    rng = np.random.default_rng(17)
    p = rng.normal(size=(E, n ** 3))
    g = random_spd_metric(rng, E, n).reshape(E, 6, n ** 3)
    mask = (rng.random((E, n ** 3)) > 0.2).astype(np.float64)
    D = derivative_matrix(n)
    jp, jD, jg, jm = (jnp.asarray(p, S), jnp.asarray(D, O),
                      jnp.asarray(g, O), jnp.asarray(mask, S))
    jw, jpap = jax_kernels.nekbone_ax_pap_pallas(
        jp, jD, jD.T, jg, jm, n=n, block_e=2, interpret=True,
        acc_dtype="float32")
    tw, tpap = torch_kernels.nekbone_ax_pap_cuda(
        _t(jp, S), _t(jD, O), _t(jg, O), _t(jm, S), n=n)
    assert tw.dtype == torch.bfloat16 and tpap.dtype == torch.float32
    _assert_values(tw, jw)
    _assert_sum(tpap, jpap)


def test_bf16_wrappers_pick_a_build_by_operand_dtype():
    """Each operand's dtype picks the build: K1 to K12 take both bf16
    mixes, chosen role by role (S vectors, X solution, O operator data, A
    scalars), and a mix of dtypes that no build has raises.  Off the card
    the wrappers raise before any of that."""
    f64, f32, bf16 = torch.float64, torch.float32, torch.bfloat16

    def t(dtype):
        return torch.zeros(1, dtype=dtype)

    pick = torch_kernels.build_for
    assert pick("nekbone_ax_slab", p2=(t(bf16), ()), D=(t(f32), (), "O"),
                beta=(t(f32), (), "A")) == "bf16_ir"
    assert pick("nekbone_ax_slab", p2=(t(bf16), ()), D=(t(bf16), (), "O"),
                beta=(t(f32), (), "A")) == "bf16"
    assert pick("nekbone_cg_update", x2=(t(f32), (), "X"),
                p2=(t(bf16), ()), alpha=(t(f32), (), "A")) == "bf16_ir"
    assert pick("nekbone_ax_pap", p2=(t(f64), ()), D=(t(f64), (), "O")) \
        == "f64"
    with pytest.raises(TypeError, match="match no build"):
        pick("nekbone_ax_slab", p2=(t(bf16), ()), D=(t(f64), (), "O"))
    with pytest.raises(TypeError, match="match no build"):
        pick("nekbone_ax", u2=(t(f32), ()), D=(t(f64), ()))
    for O, mix in ((bf16, "bf16"), (f32, "bf16_ir")):
        assert pick("nekbone_ax_powers", p2=(t(bf16), ()),
                    D=(t(O), (), "O"), inv_theta=(t(f32), (), "A")) == mix
        assert pick("nekbone_sstep_update", x2=(t(O), (), "X"),
                    p2=(t(bf16), ()), coef=(t(f32), (), "A")) == mix
        assert pick("nekbone_pcg_update", x2=(t(O), (), "X"),
                    p2=(t(bf16), ()), invd2=(t(O), (), "O"),
                    alpha=(t(f32), (), "A")) == mix
        assert pick("nekbone_cheb_apply", r2=(t(bf16), ()),
                    D=(t(O), (), "O"), g3=(t(O), (), "O"),
                    coef=(t(f32), (), "A")) == mix
        assert pick("nekbone_interp", u2=(t(bf16), ()),
                    mt=(t(O), (), "O")) == mix
        assert pick("nekbone_ax_slab_block", p3=(t(bf16), ()),
                    D=(t(O), (), "O"), g3=(t(O), (), "O"),
                    beta=(t(f32), (), "A")) == mix
        assert pick("nekbone_cg_update_block", x3=(t(O), (), "X"),
                    p3=(t(bf16), ()), alpha=(t(f32), (), "A")) == mix
    with pytest.raises(TypeError, match="match no build"):
        pick("nekbone_cheb_apply", r2=(t(bf16), ()), D=(t(f32), (), "O"),
             coef=(t(bf16), (), "A"))
    for stem in ("nekbone_ax_dots", "nekbone_ax"):
        assert pick(stem, p2=(t(bf16), ())) == "bf16"
        assert pick(stem, p2=(t(bf16), ()), D=(t(f32), (), "O")) == "bf16_ir"
    n, E = 3, 2
    meta = torch.empty(E, n ** 3, dtype=bf16, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        torch_kernels.nekbone_ax_pap_cuda(
            meta, torch.empty(n, n, dtype=f32, device="meta"),
            torch.empty(E, 6, n ** 3, dtype=f32, device="meta"), meta, n=n)
