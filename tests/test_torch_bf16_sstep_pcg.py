"""Port parity: the bf16 builds of K8, K9 and K10 (their plain versions in
both operand mixes) and the three routes they carry — bf16 s-step CG, the
``bf16_ir`` refinement over s-step and bf16 Jacobi-PCG — against the JAX
package on the CPU.

The same numpy inputs go to both packages, rounded once to bf16 on the JAX
side and carried to torch through f32 (exact); the JAX side runs its Pallas
kernels in interpret mode, the port the plain versions its wrappers take
for CPU tensors.  The mixes are ``kernels.nekbone_ax.MIXES``: ``bf16``
(every operand bf16) and ``bf16_ir`` (bf16 vectors; x and the operator's
data in f32), both accumulating in f32.  Tolerances, each with its reason:

* K8's basis: bitwise (both round each f32 power to bf16 once, after the
  same assembly); its summed Gram: 1e-6 relative (f32 partials summed in
  another order; measured 5.9e-8);
* K9's and K10's fields: value by value, one bf16 step (2^-7 of the value)
  plus 1e-5 of the largest value (each side rounds one f32 result); their
  partials: f32 sums in two orders, 1e-5 relative;
* bf16 s-step histories: at s = 2 every entry to 1e-5 (measured 6.2e-7);
  at s = 4 the first cycle's entries 0..4 to 1e-3 (measured 7.5e-5), since
  an f32 Gram summed in another order feeds the f64 recurrence over a bf16
  monomial basis and two valid orders fork after the first cycle (the
  reference's own f32 s-step test says so of f32);
* ``bf16_ir`` over s-step: at the reference's size the sweep envelope of
  tests/test_torch_ir.py (each contraction within 4x the reference's;
  measured ratios 1.02 and 1.24); at s = 4 the reference's own bars (the
  last outer norm below 0.1 of the first, none above 1.05 x the one
  before), since the port's contractions there lie up to 2.5x off the
  reference's, past the envelope;
* Jacobi-PCG: entries 0..6 to 1e-3 (measured 5.5e-7 for ``bf16_ir``, 3.7e-7
  for ``bf16``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import gs as jax_gs
from repro.core import precond as jax_pc
from repro.core.cg_fused import cg_ir_fixed_iters as jax_ir
from repro.core.cg_sstep import cg_sstep_fixed_iters as jax_sstep_solve
from repro.core.nekbone import NekboneCase as JaxCase
from repro.kernels import nekbone_ax as jax_kernels
from repro.kernels import ops as jax_ops
from repro_torch.convert import sstep_theta_from_reference
from repro_torch.core import precond as torch_pc
from repro_torch.core.cg_fused import cg_ir_fixed_iters as torch_ir
from repro_torch.core.cg_sstep import cg_sstep_fixed_iters as torch_sstep_solve
from repro_torch.core.nekbone import NekboneCase as TorchCase
from repro_torch.kernels import nekbone_ax as torch_kernels
from repro_torch.kernels import ops as torch_ops

BF16_STEP = 2.0 ** -7
BF16_F32_TOL = 1e-5
PART_RTOL = 1e-5
GRAM_RTOL = 1e-6
# (S, X, O) of each mix, on the JAX side
MIXES = {"bf16": (jnp.bfloat16, jnp.bfloat16, jnp.bfloat16),
         "bf16_ir": (jnp.bfloat16, jnp.float32, jnp.float32)}
TORCH_DTYPE = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def _np32(a):
    return np.array(jnp.asarray(a, jnp.float32))


def _t(a, dt):
    """A jnp array as a torch tensor of the matching dtype (via f32)."""
    return torch.as_tensor(_np32(a)).to(TORCH_DTYPE[dt])


def _assert_values(got, want):
    got = got.float().numpy()
    want = _np32(want)
    limit = BF16_STEP * np.abs(want) + BF16_F32_TOL * np.abs(want).max()
    assert np.all(np.abs(got - want) <= limit)


def _assert_sum(got, want, rtol=PART_RTOL):
    sg, sw = float(got.double().sum()), float(np.sum(_np32(want), dtype=float))
    assert abs(sg - sw) <= rtol * abs(sw), (sg, sw)


def _continuous(rng, jcase):
    """A continuous, masked field of the case, (E, n^3) in f64."""
    u = jnp.asarray(rng.normal(size=jcase.mask.shape))
    E = jcase.mesh.nelt
    return (jax_gs.ds_sum_local(u, jcase.grid) * jcase.mask).reshape(E, -1)


# ---------------------------------------------------------------------------
# K8, K9 and K10: the plain versions against the reference's kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mix", ["bf16", "bf16_ir"])
@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("n,grid,sz", [(4, (2, 2, 3), 3), (3, (1, 3, 2), 1)])
def test_bf16_powers_plain_matches_reference(x64, mix, s, n, grid, sz):
    """K8 in both mixes against the reference's halo-windowed kernel on
    the same bf16 p and r (theta = 2.25): the basis bitwise in bf16, the
    summed Gram to 1e-6 in f32."""
    S, _, O = MIXES[mix]
    rng = np.random.default_rng(50 + s)
    jcase = JaxCase(n=n, grid=grid, dtype=jnp.float64)
    E, n3 = jcase.mesh.nelt, n ** 3
    p = _continuous(rng, jcase).astype(S)
    r = _continuous(rng, jcase).astype(S)
    D = jcase.D.astype(O)
    g3 = jax_ops.diag_metric(jcase.g, E, n).astype(O)
    (mx, my, mz), (cx, cy, cz) = jax_ops.slab_axis_factors(grid, n, S)
    theta = 2.25
    jb, jg = jax_kernels.nekbone_ax_powers_pallas(
        jax_kernels.sstep_extend_field(p, grid, sz, s),
        jax_kernels.sstep_extend_field(r, grid, sz, s), D, D.T,
        jax_kernels.sstep_extend_field(g3, grid, sz, s), mx, my,
        jax_kernels.sstep_extend_zfactor(mz, sz, s), cx, cy, cz,
        jnp.full((1, 1), 1.0 / theta, jnp.float32), n=n, grid=grid, sz=sz,
        s=s, interpret=True, acc_dtype="float32")
    (tmx, tmy, tmz), (tcx, tcy, tcz) = torch_ops.slab_axis_factors(
        grid, n, torch.bfloat16, "cpu")
    tb, tg = torch_kernels.nekbone_ax_powers_cuda(
        _t(p, S), _t(r, S), _t(D, O), _t(g3, O), tmx, tmy, tmz, tcx, tcy,
        tcz, torch.full((1,), 1.0 / theta, dtype=torch.float32), n=n, s=s)
    assert tb.dtype == torch.bfloat16 and tb.shape == (E, 2 * s - 1, n3)
    assert tg.dtype == torch.float32 and tg.shape == (E, 2 * s + 1, 2 * s + 1)
    assert np.array_equal(tb.float().numpy(), _np32(jb))
    want = np.sum(_np32(jg), axis=0, dtype=np.float64)
    got = tg.double().sum(0).numpy()
    assert np.abs(got - want).max() <= GRAM_RTOL * np.abs(want).max()


@pytest.mark.parametrize("mix", ["bf16", "bf16_ir"])
@pytest.mark.parametrize("grid,n,sz,s", [((2, 3, 4), 4, 2, 2),
                                         ((1, 2, 3), 5, 1, 4)])
def test_bf16_sstep_update_plain_matches_reference(x64, mix, grid, n, sz,
                                                   s):
    """K9 in both mixes against ``nekbone_sstep_update_pallas``: x, r and
    p value by value in their storage dtypes, rcr summed in f32."""
    S, X, _ = MIXES[mix]
    rng = np.random.default_rng(60 + s)
    E, n3 = grid[0] * grid[1] * grid[2], n ** 3
    x = jnp.asarray(rng.normal(size=(E, n3))).astype(X)
    p, r = (jnp.asarray(rng.normal(size=(E, n3))).astype(S)
            for _ in range(2))
    basis = jnp.asarray(rng.normal(size=(E, 2 * s - 1, n3))).astype(S)
    coef = jnp.asarray(rng.normal(size=(3, 2 * s + 1))).astype(jnp.float32)
    _, (cx, cy, cz) = jax_ops.slab_axis_factors(grid, n, S)
    jx, jr, jp, jrcr = jax_kernels.nekbone_sstep_update_pallas(
        x, p, r, basis, coef, cx, cy, cz, n=n, grid=grid, sz=sz, s=s,
        interpret=True, acc_dtype="float32")
    _, (tcx, tcy, tcz) = torch_ops.slab_axis_factors(grid, n, torch.bfloat16,
                                                     "cpu")
    tx, tr, tp, trcr = torch_kernels.nekbone_sstep_update_cuda(
        _t(x, X), _t(p, S), _t(r, S), _t(basis, S),
        _t(coef, jnp.float32), tcx, tcy, tcz, n=n, s=s)
    assert tx.dtype == TORCH_DTYPE[X]
    assert tr.dtype == tp.dtype == torch.bfloat16
    assert trcr.dtype == torch.float32
    for got, want in ((tx, jx), (tr, jr), (tp, jp)):
        _assert_values(got, want)
    _assert_sum(trcr, jrcr)


@pytest.mark.parametrize("mix", ["bf16", "bf16_ir"])
def test_bf16_pcg_update_plain_matches_reference(x64, mix):
    """K4 then K10 on n=5, grid 1x1x4 with one element per slab (sz=1), so
    the reference's w is unassembled like the port's: the stored x and z
    value by value, rtz and rcr summed."""
    S, X, O = MIXES[mix]
    n, grid = 5, (1, 1, 4)
    E, n3 = 4, n ** 3
    rng = np.random.default_rng(70)
    jcase = JaxCase(n=n, grid=grid, dtype=jnp.float64)
    p_prev = _continuous(rng, jcase).astype(S)
    z = _continuous(rng, jcase).astype(S)
    x = jnp.asarray(rng.normal(size=(E, n3))).astype(X)
    invd = jnp.asarray(rng.uniform(0.5, 2.0, size=(E, n3))).astype(O)
    D = jcase.D.astype(O)
    g3 = jax_ops.diag_metric(jcase.g, E, n).astype(O)
    (mx, my, mz), (cx, cy, cz) = jax_ops.slab_axis_factors(grid, n, S)
    beta, alpha = 0.61, 0.37
    jp, jw, bot, top, _ = jax_kernels.nekbone_ax_slab_pallas(
        p_prev, z, D, D.T, g3, mx, my, mz,
        jnp.full((1, 1), beta, jnp.float32), n=n, grid=grid, sz=1,
        interpret=True, acc_dtype="float32")
    zero = jnp.zeros((1, bot.shape[1]), bot.dtype)
    addb = jnp.concatenate([zero, top[:-1]], axis=0)
    addt = jnp.concatenate([bot[1:], zero], axis=0)
    jx, jz, jrtz, jrcr = jax_kernels.nekbone_pcg_update_pallas(
        x, jp, z, jw, addb, addt, jnp.full((1, 1), alpha, jnp.float32),
        invd, cx, cy, cz, n=n, grid=grid, sz=1, interpret=True,
        acc_dtype="float32")
    _, (tcx, tcy, tcz) = torch_ops.slab_axis_factors(grid, n, torch.bfloat16,
                                                     "cpu")
    tx, tz, trtz, trcr = torch_kernels.nekbone_pcg_update_cuda(
        _t(x, X), _t(jp, S), _t(z, S), _t(jw, S),
        torch.tensor(alpha, dtype=torch.float32), _t(invd, O), tcx, tcy,
        tcz, n=n)
    assert tx.dtype == TORCH_DTYPE[X] and tz.dtype == torch.bfloat16
    assert trtz.dtype == trcr.dtype == torch.float32
    _assert_values(tx, jx)
    _assert_values(tz, jz)
    _assert_sum(trtz, jrtz)
    _assert_sum(trcr, jrcr)


# ---------------------------------------------------------------------------
# bf16 s-step CG through the case, and the reference's policy test
# ---------------------------------------------------------------------------

def _sstep_cases(n, grid, s, precision):
    jcase = JaxCase(n=n, grid=grid, dtype=jnp.float64, precision=precision,
                    ax_impl="pallas_sstep_v3", s=s)
    tcase = TorchCase(n=n, grid=grid, dtype=torch.float64,
                      precision=precision, ax_impl="pallas_sstep_v3", s=s,
                      device="cpu")
    return jcase, tcase


@pytest.mark.parametrize("n,grid,s,niter,entries,rtol", [
    (4, (2, 2, 2), 2, 6, 7, 1e-5),
    (5, (2, 2, 4), 4, 12, 5, 1e-3)])
def test_bf16_sstep_through_case_matches_reference(x64, n, grid, s, niter,
                                                   entries, rtol):
    """``case.solve_manufactured`` with ``precision="bf16"`` on
    ``pallas_sstep_v3`` (K8 + K9 in bf16) against the reference on one
    theta: the history's first ``entries`` entries (all of them at s = 2,
    the first cycle's at s = 4), finite and falling, x in bf16."""
    jcase, tcase = _sstep_cases(n, grid, s, "bf16")
    assert tcase.dtype == torch.bfloat16
    ref, _ = jcase.solve_manufactured(niter=niter)
    sstep_theta_from_reference(jcase, tcase)
    res, _ = tcase.solve_manufactured(niter=niter)
    assert res.pipeline == "sstep_v3" and int(res.iters) == niter
    assert res.x.dtype == torch.bfloat16
    h = res.history.double().numpy()
    h_ref = np.asarray(ref.rnorm_history, np.float64)
    assert h.shape == h_ref.shape == (niter + 1,)
    assert np.isfinite(h).all() and h[-1] < h[0]
    rel = np.abs(h[:entries] - h_ref[:entries]) / h_ref[:entries]
    assert rel.max() <= rtol, rel


def test_bf16_sstep_policy_dtypes(x64):
    """The reference's ``test_cg_sstep_precision_policy_dtypes``: the bf16
    policy keeps the basis and vectors in bf16, sums the Gram in f32 and
    carries x in bf16; the history (4 iterations at s = 2) is finite and
    its first cycle's entries 0..2 match the reference's to 1e-5 (measured
    4.3e-7; the later entries fork by up to 2.7e-3, as at s = 4 above)."""
    jcase = JaxCase(n=4, grid=(2, 2, 2), dtype=jnp.float32)
    _, jf = jcase.manufactured()
    theta = 2.5
    ref = jax_sstep_solve(jf, D=jcase.D, g=jcase.g, grid=jcase.grid,
                          niter=4, s=2, theta=theta, interpret=True,
                          precision="bf16")
    tcase = TorchCase(n=4, grid=(2, 2, 2), dtype=torch.float32,
                      device="cpu")
    f = torch.as_tensor(np.array(jf, np.float32))
    got = torch_sstep_solve(f, D=tcase.D, g=tcase.g, grid=tcase.grid,
                            niter=4, s=2, theta=theta, precision="bf16")
    assert got.x.dtype == torch.bfloat16
    assert got.history.dtype == torch.float32
    h = got.history.double().numpy()
    h_ref = np.asarray(ref.rnorm_history, np.float64)
    assert h.shape == h_ref.shape == (5,) and np.isfinite(h).all()
    np.testing.assert_allclose(h[:3], h_ref[:3], rtol=1e-5)


# ---------------------------------------------------------------------------
# bf16_ir over s-step
# ---------------------------------------------------------------------------

def test_bf16_ir_sstep_matches_reference(x64):
    """The reference's ``test_cg_sstep_ir_composition`` size (n=4, 2x2x4,
    10 inner iterations, s=2, 2 sweeps): each sweep's contraction within 4x
    the reference's, entry 0 to 1e-12, and the reference's bar (the last
    outer norm below 0.1 of the first)."""
    jcase = JaxCase(n=4, grid=(2, 2, 4), dtype=jnp.float64)
    tcase = TorchCase(n=4, grid=(2, 2, 4), dtype=torch.float64,
                      device="cpu")
    _, jf = jcase.manufactured()
    kw = dict(grid=(2, 2, 4), niter=10, precision="bf16_ir",
              outer_iters=2, variant="sstep", s=2)
    ref = jax_ir(jf, D=jcase.D, g=jcase.g, mask=jcase.mask, c=jcase.c,
                 interpret=True, **kw)
    got = torch_ir(torch.as_tensor(np.asarray(jf)), D=tcase.D, g=tcase.g,
                   mask=tcase.mask, c=tcase.c, **kw)
    h = got.history.numpy()
    h_ref = np.asarray(ref.rnorm_history, np.float64)
    assert got.pipeline == "ir" and got.x.dtype == torch.float64
    assert int(got.iters) == 20 and h.shape == (3,)
    assert abs(h[0] - h_ref[0]) <= 1e-12 * h_ref[0]
    ratio = (h[1:] / h[:-1]) / (h_ref[1:] / h_ref[:-1])
    assert np.all(np.abs(np.log(ratio)) <= np.log(4.0)), (h, h_ref)
    assert h[-1] < h[0] * 1e-1


def test_bf16_ir_sstep_s4_holds_the_reference_bars(x64):
    """n=5, 2x2x2, 30 inner iterations, s=4, the default 5 sweeps: the
    outer norms fall below 0.1 of the first and never rise (x 1.05), the
    refined x in f64."""
    tcase = TorchCase(n=5, grid=(2, 2, 2), dtype=torch.float64,
                      device="cpu")
    _, f = tcase.manufactured()
    got = torch_ir(f, D=tcase.D, g=tcase.g, grid=(2, 2, 2), niter=30,
                   precision="bf16_ir", variant="sstep", s=4,
                   mask=tcase.mask, c=tcase.c)
    h = got.history.numpy()
    assert got.x.dtype == torch.float64 and h.shape == (6,)
    assert np.isfinite(h).all()
    assert h[-1] < h[0] * 1e-1
    assert np.all(h[1:] <= h[:-1] * 1.05), h


# ---------------------------------------------------------------------------
# bf16 Jacobi-PCG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision,x_dtype", [("bf16_ir", torch.float32),
                                               ("bf16", torch.bfloat16)])
def test_bf16_jacobi_pcg_matches_reference(x64, precision, x_dtype):
    """``pcg_fused_v2_fixed_iters`` with a Jacobi preconditioner (K4 +
    K10) in a bf16 policy against the reference (n=5, 2x2x2, 10
    iterations): entries 0..6 to 1e-3, x in the policy's x storage.  A
    refined policy passed straight to it runs as its storage policy
    (bf16 vectors, x and the operator's data in f32)."""
    jcase = JaxCase(n=5, grid=(2, 2, 2), dtype=jnp.float64)
    tcase = TorchCase(n=5, grid=(2, 2, 2), dtype=torch.float64,
                      device="cpu")
    _, jf = jcase.manufactured()
    ref = jax_pc.pcg_fused_v2_fixed_iters(
        jf, D=jcase.D, g=jcase.g, grid=jcase.grid, niter=10,
        precond=jax_pc.JacobiPrecond(
            invdiag=1.0 / jcase.operator_diagonal()),
        mask=jcase.mask, c=jcase.c, interpret=True, precision=precision)
    got = torch_pc.pcg_fused_v2_fixed_iters(
        torch.as_tensor(np.asarray(jf)), D=tcase.D, g=tcase.g,
        grid=tcase.grid, niter=10,
        precond=torch_pc.JacobiPrecond(
            invdiag=1.0 / tcase.operator_diagonal()),
        mask=tcase.mask, c=tcase.c, precision=precision)
    assert got.x.dtype == x_dtype
    h = got.history.double().numpy()
    h_ref = np.asarray(ref.rnorm_history, np.float64)
    assert h.shape == h_ref.shape == (11,)
    assert np.isfinite(h).all() and h[-1] < h[0]
    rel = np.abs(h[:7] - h_ref[:7]) / h_ref[:7]
    assert rel.max() <= 1e-3, rel


# ---------------------------------------------------------------------------
# the builds the wrappers pick
# ---------------------------------------------------------------------------

def test_k8_k9_k10_pick_both_bf16_builds():
    """K8, K9 and K10 pick ``bf16`` or ``bf16_ir`` by their operands'
    dtypes, role by role."""
    f32, bf16 = torch.float32, torch.bfloat16

    def t(dtype):
        return torch.zeros(1, dtype=dtype)

    pick = torch_kernels.build_for
    for O, mix in ((bf16, "bf16"), (f32, "bf16_ir")):
        assert pick("nekbone_ax_powers", p2=(t(bf16), ()),
                    D=(t(O), (), "O"), g3=(t(O), (), "O"),
                    inv_theta=(t(f32), (), "A")) == mix
        assert pick("nekbone_pcg_update", x2=(t(O), (), "X"),
                    p2=(t(bf16), ()), alpha=(t(f32), (), "A"),
                    invd2=(t(O), (), "O")) == mix
        assert pick("nekbone_sstep_update", x2=(t(O), (), "X"),
                    p2=(t(bf16), ()), coef=(t(f32), (), "A")) == mix
    with pytest.raises(TypeError, match="match no build"):
        pick("nekbone_sstep_update", x2=(t(f32), (), "X"), p2=(t(bf16), ()),
             coef=(t(bf16), (), "A"))


def test_k8_scratch_in_the_builds_types():
    """K8's shared scratch in a bf16 build: the two input columns in bf16,
    the Gram's staged ring and sums in f32, a slice's share whole f32
    values; f64 and f32 as one type."""
    for n in torch_kernels.N_RANGE:
        for s in range(1, torch_kernels.SSTEP_MAX_S + 1):
            ring = 4 if s <= 4 else 2
            staged = ring * (2 * s + 2) * n * (n + 1)
            sums = 9 * n ** 2
            got = torch_kernels.k8_scratch_bytes(n, s, torch.bfloat16, 2,
                                                 torch.float32)
            column = -(-2 * n ** 3 * 2 // 4)
            assert got == 2 * 4 * max(column, staged, sums)
            assert torch_kernels.k8_scratch_bytes(n, s, torch.float32, 2) \
                == torch_kernels.k8_scratch_bytes(n, s, torch.float32, 2,
                                                  torch.float32)
