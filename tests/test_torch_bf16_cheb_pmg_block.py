"""Port parity: the bf16 builds of K11, K12, K6 and K7 (their plain versions
in both operand mixes) and the three routes they carry — bf16
Chebyshev-PCG, bf16 p-multigrid PCG and bf16 block CG, with their
``bf16_ir`` counterparts through the drivers — against the JAX package on
the CPU; K11's launch plan in its bf16 builds; and the four ``ops``
entries of the v2 pair and its batched sibling.

The same numpy inputs go to both packages, rounded once to bf16 (or f32)
on the JAX side and carried to torch through f32 (exact); the JAX side
runs its Pallas kernels in interpret mode, the port the plain versions its
wrappers take for CPU tensors.  The mixes are
``kernels.nekbone_ax.MIXES``: ``bf16`` (every operand bf16) and
``bf16_ir`` (bf16 vectors; x and the operator's data in f32), both
accumulating in f32.  Tolerances, each with its reason:

* stored fields (K11's z, K12's v, K6's p and w, K7's x and r): value by
  value, one bf16 step (2^-7 of the value) plus 1e-5 of the largest value,
  since each side rounds one f32 result whose sums run in another order;
* partials (K11's rtz, K6's pap, K7's rcr): f32 sums in two orders,
  1e-5 relative;
* bf16 Chebyshev- and pmg-PCG and block CG histories: the entries before
  bf16's floor, 2e-2 relative (f32 sums in another order flip bf16 steps
  of the stored vectors, as the bf16 Jacobi and Chebyshev tests of
  tests/test_torch_precond.py measure);
* the fp64 ``ops`` entries: 1e-12 relative (summation order only), as
  tests/test_torch_pcg_kernels.py holds K10's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.cg_block as jax_block
from repro.core import gs as jax_gs
from repro.core import precond as jax_pc
from repro.core.nekbone import NekboneCase as JaxCase
from repro.core.pmg import gll_interp_matrix as jax_gll_interp
from repro.kernels import nekbone_ax as jax_kernels
from repro.kernels import ops as jax_ops
from repro_torch.convert import precond_from_reference
from repro_torch.core import cg_block as torch_block
from repro_torch.core import precond as torch_pc
from repro_torch.core.cg_fused import cg_fused_v2_fixed_iters
from repro_torch.core.gs import ds_sum_local
from repro_torch.core.nekbone import NekboneCase as TorchCase
from repro_torch.kernels import nekbone_ax as torch_kernels
from repro_torch.kernels import ops as torch_ops

BF16_STEP = 2.0 ** -7
BF16_F32_TOL = 1e-5
PART_RTOL = 1e-5
HIST_RTOL = 2e-2
RTOL = 1e-12
# (S, X, O) of each mix, on the JAX side
MIXES = {"bf16": (jnp.bfloat16, jnp.bfloat16, jnp.bfloat16),
         "bf16_ir": (jnp.bfloat16, jnp.float32, jnp.float32)}
TORCH_DTYPE = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
# K11, K6 and K7 at two degrees on two small grids each
SMALL = [(5, (1, 1, 4)), (5, (2, 1, 3)), (3, (1, 1, 3)), (3, (2, 2, 2))]


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


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-300))


def _assert_head(h, h_ref, entries):
    h = np.asarray(h, np.float64)
    h_ref = np.asarray(h_ref, np.float64)
    assert np.isfinite(h).all()
    rel = np.abs(h[..., :entries] - h_ref[..., :entries]) \
        / h_ref[..., :entries]
    assert rel.max() <= HIST_RTOL, rel


# ---------------------------------------------------------------------------
# K11, K12, K6 and K7: the plain versions against the reference's kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mix", ["bf16", "bf16_ir"])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("n,grid", SMALL)
def test_bf16_cheb_apply_plain_matches_reference(x64, mix, k, n, grid):
    """K11 in both mixes against the reference's halo-windowed kernel (one
    slab a block, so its ghost slabs are exercised) on the same bf16 r: z
    value by value in bf16, rtz summed in f32."""
    S, _, O = MIXES[mix]
    rng = np.random.default_rng(80 + k + n)
    jcase = JaxCase(n=n, grid=grid, dtype=jnp.float64)
    E, sz = jcase.mesh.nelt, 1
    r = _continuous(rng, jcase).astype(S)
    D = jcase.D.astype(O)
    g3 = jax_ops.diag_metric(jcase.g, E, n).astype(O)
    (mx, my, mz), (cx, cy, cz) = jax_ops.slab_axis_factors(grid, n, S)
    coef = jnp.asarray(jax_pc.cheb_scalars(k, 0.06, 4.3), jnp.float32)
    jz, jrtz = jax_kernels.nekbone_cheb_apply_pallas(
        jax_kernels.sstep_extend_field(r, grid, sz, k), D, D.T,
        jax_kernels.sstep_extend_field(g3, grid, sz, k), mx, my,
        jax_kernels.sstep_extend_zfactor(mz, sz, k), cx, cy, cz, coef, n=n,
        grid=grid, sz=sz, k=k, interpret=True, acc_dtype="float32")
    (tm, tc) = torch_ops.slab_axis_factors(grid, n, torch.bfloat16, "cpu")
    tz, trtz = torch_kernels.nekbone_cheb_apply_cuda(
        _t(r, S), _t(D, O), _t(g3, O), *tm, *tc, _t(coef, jnp.float32), n=n,
        k=k)
    assert tz.dtype == torch.bfloat16 and trtz.dtype == torch.float32
    _assert_values(tz, jz)
    _assert_sum(trtz, jrtz)


@pytest.mark.parametrize("mix", ["bf16", "bf16_ir"])
@pytest.mark.parametrize("nin,nout", [(6, 3), (3, 6), (3, 2), (2, 3),
                                      (5, 3), (3, 5)])
def test_bf16_interp_plain_matches_reference(x64, mix, nin, nout):
    """K12 in both mixes against ``nekbone_interp_pallas`` on every ladder
    step of n=6 (6 -> 3 -> 2 and back) and n=5's first: v value by value
    in bf16, u in bf16 and the transfer matrix in O."""
    S, _, O = MIXES[mix]
    grid = (2, 1, 2)
    E = 4
    rng = np.random.default_rng(90 + nin * 7 + nout)
    u = jnp.asarray(rng.normal(size=(E, nin ** 3))).astype(S)
    J = jax_gll_interp(max(nin, nout), min(nin, nout))
    mt = jnp.asarray(J if nin > nout else J.T).astype(O)
    jv = jax_kernels.nekbone_interp_pallas(u, mt, nin=nin, nout=nout,
                                           grid=grid, sz=1, interpret=True,
                                           acc_dtype="float32")
    tv = torch_kernels.nekbone_interp_cuda(_t(u, S), _t(mt, O), nin=nin,
                                           nout=nout)
    assert tv.dtype == torch.bfloat16 and tv.shape == (E, nout ** 3)
    _assert_values(tv, jv)


def _block_operands(rng, jcase, b, mix):
    S, X, O = MIXES[mix]
    E = jcase.mesh.nelt
    n = jcase.n
    P = jnp.stack([_continuous(rng, jcase) for _ in range(b)]).astype(S)
    R = jnp.stack([_continuous(rng, jcase) for _ in range(b)]).astype(S)
    Xs = jnp.asarray(rng.normal(size=(b, E, n ** 3))).astype(X)
    beta = jnp.asarray(rng.uniform(0.2, 0.9, size=b), jnp.float32)
    alpha = jnp.asarray(rng.uniform(0.2, 0.9, size=b), jnp.float32)
    D = jcase.D.astype(O)
    g3 = jax_ops.diag_metric(jcase.g, E, n).astype(O)
    return P, R, Xs, beta, alpha, D, g3


@pytest.mark.parametrize("mix", ["bf16", "bf16_ir"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n,grid", SMALL)
def test_bf16_block_plain_matches_reference(x64, mix, b, n, grid):
    """K6 then K7 in both mixes against the reference's batched kernels:
    K6's p value by value and pap summed on every grid; on a 1 x 1 x EZ
    grid at one element a slab, where the reference's w leaves its kernel
    unassembled like the port's, also w, and K7's x and r value by value
    and rcr summed (elsewhere the reference sums w's faces in f32 before
    its one rounding, the port after, so K7 sees other inputs)."""
    S, X, O = MIXES[mix]
    rng = np.random.default_rng(100 + b + n)
    jcase = JaxCase(n=n, grid=grid, dtype=jnp.float64)
    E = jcase.mesh.nelt
    P, R, Xs, beta, alpha, D, g3 = _block_operands(rng, jcase, b, mix)
    (mx, my, mz), (cx, cy, cz) = jax_ops.slab_axis_factors(grid, n, S)
    sz = 1 if grid[:2] == (1, 1) else grid[2]
    jp, jw, bot, top, jpap = jax_kernels.nekbone_ax_slab_block_pallas(
        P, R, D, D.T, g3, mx, my, mz, beta.reshape(1, b), n=n, grid=grid,
        sz=sz, interpret=True, acc_dtype="float32")
    (tm, tc) = torch_ops.slab_axis_factors(grid, n, torch.bfloat16, "cpu")
    tp, tw, tpap = torch_kernels.nekbone_ax_slab_block_cuda(
        _t(P, S), _t(R, S), _t(D, O), _t(g3, O), *tm,
        _t(beta, jnp.float32), n=n)
    assert tp.dtype == tw.dtype == torch.bfloat16
    assert tpap.dtype == torch.float32 and tpap.shape == (b, E)
    _assert_values(tp, jp)
    for j in range(b):
        _assert_sum(tpap[j], jpap[:, j])
    if sz != 1:
        return
    _assert_values(tw, jw)
    zero = jnp.zeros((b, 1, bot.shape[2]), bot.dtype)
    addb = jnp.concatenate([zero, top[:, :-1]], axis=1)
    addt = jnp.concatenate([bot[:, 1:], zero], axis=1)
    jx, jr, jrcr = jax_kernels.nekbone_cg_update_block_pallas(
        Xs, jp, R, jw, addb, addt, alpha.reshape(1, b), cx, cy, cz, n=n,
        grid=grid, sz=1, interpret=True, acc_dtype="float32")
    tx, tr, trcr = torch_kernels.nekbone_cg_update_block_cuda(
        _t(Xs, X), _t(jp, S), _t(R, S), _t(jw, S), _t(alpha, jnp.float32),
        *tc, n=n)
    assert tx.dtype == TORCH_DTYPE[X] and tr.dtype == torch.bfloat16
    assert trcr.dtype == torch.float32 and trcr.shape == (b, E)
    _assert_values(tx, jx)
    _assert_values(tr, jr)
    for j in range(b):
        _assert_sum(trcr[j], jrcr[:, j])


@pytest.mark.parametrize("mix", ["bf16", "bf16_ir"])
def test_bf16_block_plain_lanes_are_k4_k5(mix):
    """K6's and K7's plain versions in a bf16 mix, lane by lane: bitwise
    K4's and K5's on that lane (b = 3)."""
    S, X, O = (TORCH_DTYPE[d] for d in MIXES[mix])
    n, grid, b = 5, (2, 2, 3), 3
    case = TorchCase(n=n, grid=grid, dtype=torch.float64, device="cpu")
    E = case.mesh.nelt
    rng = np.random.default_rng(110)
    P = torch.as_tensor(rng.normal(size=(b, E, n ** 3))).to(S)
    R = torch.as_tensor(rng.normal(size=(b, E, n ** 3))).to(S)
    Xs = torch.as_tensor(rng.normal(size=(b, E, n ** 3))).to(X)
    beta = torch.as_tensor(rng.normal(size=b), dtype=torch.float32)
    alpha = torch.as_tensor(rng.normal(size=b), dtype=torch.float32)
    m, c = torch_ops.slab_axis_factors(grid, n, S, "cpu")
    D = case.D.to(O)
    g3 = torch_ops.diag_metric(case.g, E, n).to(O)
    p3, w3, pap = torch_kernels.nekbone_ax_slab_block_cuda(P, R, D, g3, *m,
                                                           beta, n=n)
    x3, r3, rcr = torch_kernels.nekbone_cg_update_block_cuda(
        Xs, p3, R, w3, alpha, *c, n=n)
    for j in range(b):
        p, w, pp = torch_kernels.nekbone_ax_slab_cuda(
            P[j], R[j], D, g3, *m, beta[j:j + 1], n=n)
        x, r, rr = torch_kernels.nekbone_cg_update_cuda(
            Xs[j], p, R[j], w, alpha[j:j + 1], *c, n=n)
        for got, want in ((p3[j], p), (w3[j], w), (pap[j], pp), (x3[j], x),
                          (r3[j], r), (rcr[j], rr)):
            assert got.dtype == want.dtype and torch.equal(got, want)


# ---------------------------------------------------------------------------
# the routes: bf16 Chebyshev- and pmg-PCG, bf16 block CG
# ---------------------------------------------------------------------------

def _cases(n=5, grid=(2, 2, 2), **kw):
    return (JaxCase(n=n, grid=grid, dtype=jnp.float64, **kw),
            TorchCase(n=n, grid=grid, dtype=torch.float64, device="cpu",
                      **kw))


def test_bf16_cheb4_through_case_matches_reference(x64):
    """``case.solve`` with ``precision="bf16"`` and ``precond="cheb4"``
    (K11, K4 and K5 in bf16; n=5, 2x2x4, 10 iterations) on the reference
    case's own Lanczos interval, carried into the port case's cache of
    specs (the two bf16 Lanczos runs differ by 2e-3, which four chained
    applications amplify past the bar from entry 3 on): entries 0..3
    within 2e-2 (measured 1.1e-2; by entry 4 the residual is at 3% of r0,
    and f32 sums in another order inside four chained operators flip bf16
    steps of z enough to move it by 3%), x in bf16."""
    kw = dict(n=5, grid=(2, 2, 4), precision="bf16",
              ax_impl="pallas_fused_cg_v2")
    jcase, tcase = _cases(**kw)
    _, jf = jcase.manufactured()
    tf = torch.as_tensor(np.asarray(jf, np.float64)).to(tcase.dtype)
    spec = jcase.precond_spec("cheb4")
    tcase.__dict__.setdefault("_precond_specs", {})["cheb4"] = \
        precond_from_reference(spec, dtype=torch.float64, device="cpu")
    ref = jcase.solve(jf, niter=10, precond="cheb4")
    got = tcase.solve(tf, niter=10, precond="cheb4")
    assert got.x.dtype == torch.bfloat16 and got.precond == "cheb"
    _assert_head(got.history.double().numpy(), ref.rnorm_history, 4)


@pytest.mark.parametrize("pc", ["cheb", "pmg"])
@pytest.mark.parametrize("precision,x_dtype", [("bf16_ir", torch.float32),
                                               ("bf16", torch.bfloat16)])
def test_bf16_cheb_pmg_drivers_match_reference(x64, pc, precision, x_dtype):
    """``pcg_fused_v2_fixed_iters`` with the reference's Chebyshev(4) or
    pmg spec (carried across by ``convert.precond_from_reference``) in a
    bf16 policy (n=6, 2x2x2: pmg's ladder 6 -> 3 -> 2; 8 iterations):
    entries 0..3 within 2e-2, x in the policy's x storage.  A refined
    policy passed straight to the driver runs as its storage policy (bf16
    vectors, x and the operator's data, the pmg transfers among them, in
    f32), so ``bf16_ir`` reaches the ``bf16_ir`` builds of K11 and K12."""
    jcase, tcase = _cases(n=6)
    _, jf = jcase.manufactured()
    jspec = jcase.precond_spec("cheb4" if pc == "cheb" else "pmg")
    ref = jax_pc.pcg_fused_v2_fixed_iters(
        jf, D=jcase.D, g=jcase.g, grid=jcase.grid, niter=8, precond=jspec,
        mask=jcase.mask, c=jcase.c, interpret=True, precision=precision)
    got = torch_pc.pcg_fused_v2_fixed_iters(
        torch.as_tensor(np.asarray(jf)), D=tcase.D, g=tcase.g,
        grid=tcase.grid, niter=8,
        precond=precond_from_reference(jspec, dtype=torch.float64,
                                       device="cpu"),
        mask=tcase.mask, c=tcase.c, precision=precision)
    assert got.x.dtype == x_dtype and got.precond == pc
    h = got.history.double().numpy()
    assert h.shape == (9,) and h[-1] < h[0]
    _assert_head(h, ref.rnorm_history, 4)


def _rhs_batch(tcase, b, seed):
    rng = np.random.default_rng(seed)
    _, f0 = tcase.manufactured()
    lanes = [f0]
    for _ in range(b - 1):
        u = torch.as_tensor(rng.normal(size=tuple(f0.shape)))
        lanes.append(ds_sum_local(u, tcase.grid) * tcase.mask)
    return torch.stack(lanes).numpy()


@pytest.mark.parametrize("b", [1, 2, 3])
@pytest.mark.parametrize("precision,x_dtype", [("bf16", torch.bfloat16),
                                               ("bf16_ir", torch.float32)])
def test_bf16_block_matches_reference(x64, b, precision, x_dtype):
    """``cg_block_fixed_iters`` in a bf16 policy (K6 + K7 in bf16; n=5,
    2x2x4, 10 iterations) against the reference's on the same rhs batch:
    every lane's entries 0..6 within 2e-2, x in the policy's x storage."""
    jcase, tcase = _cases(grid=(2, 2, 4))
    B = _rhs_batch(tcase, b, seed=120 + b)
    kw = dict(niter=10, precision=precision)
    ref = jax_block.cg_block_fixed_iters(
        jnp.asarray(B), D=jcase.D, g=jcase.g, grid=jcase.grid,
        mask=jcase.mask, c=jcase.c, interpret=True, **kw)
    got = torch_block.cg_block_fixed_iters(
        torch.as_tensor(B), D=tcase.D, g=tcase.g, grid=tcase.grid,
        mask=tcase.mask, c=tcase.c, **kw)
    assert got.pipeline == f"fused_v2_rhs{b}" and got.x.dtype == x_dtype
    h = got.history.double().numpy()
    assert h.shape == (b, 11) and np.all(h[:, -1] < h[:, 0])
    _assert_head(h, np.asarray(ref.history, np.float64), 7)


@pytest.mark.parametrize("precision", ["bf16", "bf16_ir"])
def test_bf16_block_b1_is_bitwise_v2(precision):
    """A b=1 block solve in a bf16 policy is bitwise the single-RHS v2
    solve of the same policy: history and x (K6's lane is K4's, K7's is
    K5's, and the lane's scalars are v2's, operation for operation)."""
    _, tcase = _cases(grid=(2, 2, 4))
    _, f = tcase.manufactured()
    kw = dict(D=tcase.D, g=tcase.g, grid=tcase.grid, mask=tcase.mask,
              c=tcase.c, niter=12, precision=precision)
    solo = cg_fused_v2_fixed_iters(f, **kw)
    res = torch_block.cg_block_fixed_iters(f, **kw)
    assert res.x.dtype == solo.x.dtype
    assert torch.equal(res.x[0], solo.x)
    assert torch.equal(res.history[0], solo.history)


def test_bf16_block_through_case_routes_to_the_block_kernels(x64):
    """bf16 through ``case.solve`` with b = 2 takes the ``block`` route:
    pipeline ``fused_v2_rhs2``, x in bf16, each lane's history bitwise its
    own bf16 v2 solve."""
    tcase = TorchCase(n=5, grid=(2, 2, 4), dtype=torch.float64,
                      precision="bf16", ax_impl="pallas_fused_cg_v2",
                      device="cpu")
    F = torch.as_tensor(_rhs_batch(tcase, 2, seed=130)).to(torch.bfloat16)
    res = tcase.solve(F, niter=8)
    assert res.pipeline == "fused_v2_rhs2" and res.x.dtype == torch.bfloat16
    for j in range(2):
        assert torch.equal(res.history[j], tcase.solve(F[j], niter=8).history)


# ---------------------------------------------------------------------------
# K11's launch plan in its bf16 builds
# ---------------------------------------------------------------------------

def test_k11_state_in_the_accumulation_type():
    """K11 keeps d, res and z of a resident element in A whatever the
    storage: 3 n^3 f32 values in both bf16 builds, as in f32; f64 and f32
    as one type."""
    for n in torch_kernels.N_RANGE:
        got = torch_kernels.k11_state_bytes(n, torch.bfloat16, torch.float32)
        assert got == 3 * n ** 3 * 4
        assert got == torch_kernels.k11_state_bytes(n, torch.float32)
        assert torch_kernels.k11_state_bytes(n, torch.float64) \
            == 3 * n ** 3 * 8


@pytest.mark.parametrize("E", [64, 1024, 4096])
def test_k11_bf16_plan_is_f32s(E):
    """With ``accum`` the bf16 plan is the f32 plan (132 SMs, 227 KB a
    block, a residency that halves past 100 KB a block): the same variant,
    elements a block, grid and shared bytes, the state at 4 bytes a value.
    Without it the planner would size a resident element's state at 2
    bytes a value, half what the kernel stages."""
    n, slices, smem = 10, 4, 232448

    def fit(resident, dyn):
        return 2 if dyn <= 100_000 else 1

    def plan(dtype, accum=None):
        return torch_kernels.k11_plan(E, n, dtype, 132, fit, smem,
                                      slices=slices, accum=accum)

    bf16 = plan(torch.bfloat16, torch.float32)
    assert bf16 == plan(torch.float32)
    assert bf16.smem_bytes == (bf16.per_block * 3 if bf16.resident
                               else slices) * n ** 3 * 4
    unsized = plan(torch.bfloat16)
    if unsized.resident:
        assert unsized.smem_bytes == unsized.per_block * 3 * n ** 3 * 2


# ---------------------------------------------------------------------------
# the four ops entries of the v2 pair and its batched sibling (fp64)
# ---------------------------------------------------------------------------

def _ops_operands(seed, n, grid, b=None):
    rng = np.random.default_rng(seed)
    jcase = JaxCase(n=n, grid=grid, dtype=jnp.float64)
    E = jcase.mesh.nelt
    lead = () if b is None else (b,)
    fields = [np.stack([np.asarray(_continuous(rng, jcase)).reshape(
        E, n, n, n) for _ in range(b or 1)]).reshape(lead + (E, n, n, n))
        for _ in range(2)]
    x = rng.normal(size=lead + (E, n, n, n))
    return jcase, fields[0], fields[1], x


def test_ops_ax_dots_slab_and_cg_update_match_reference(x64):
    """``ops.nekbone_ax_dots_slab`` (K4, its w assembled) and
    ``ops.nekbone_cg_update`` (K5 on K4's unassembled w) against the
    reference's entries at a slab split below EZ (its w assembled in its
    kernel and by its wrapper's plane stitch): p, w, pap, x, r and rcr to
    1e-12."""
    n, grid = 4, (2, 2, 4)
    jcase, p_prev, r, x = _ops_operands(140, n, grid)
    beta, alpha = 0.37, 0.81
    jp, jw, jpap = jax_ops.nekbone_ax_dots_slab(
        jnp.asarray(p_prev), jnp.asarray(r), jcase.D, jcase.g, grid,
        beta=beta, sz=2, layout="fold", grid_order="parallel",
        interpret=True)
    jx, jr, jrcr = jax_ops.nekbone_cg_update(
        jnp.asarray(x), jp, jnp.asarray(r), jw, alpha, grid, sz=4,
        interpret=True)
    tcase = TorchCase(n=n, grid=grid, dtype=torch.float64, device="cpu")
    tp, tw, tpap = torch_ops.nekbone_ax_dots_slab(
        torch.as_tensor(p_prev), torch.as_tensor(r), tcase.D, tcase.g, grid,
        beta=beta)
    assert _rel(tp, jp) <= RTOL and _rel(tw, jw) <= RTOL
    assert abs(float(tpap) - float(jpap)) <= RTOL * abs(float(jpap))
    E = tcase.mesh.nelt
    # K5 takes K4's unassembled w: the plain K4 on the same operands
    (m, _) = torch_ops.slab_axis_factors(grid, n, torch.float64, "cpu")
    _, w2, _ = torch_kernels.nekbone_ax_slab_cuda(
        torch.as_tensor(p_prev).reshape(E, -1),
        torch.as_tensor(r).reshape(E, -1), tcase.D,
        torch_ops.diag_metric(tcase.g, E, n), *m,
        torch.tensor([beta], dtype=torch.float64), n=n)
    tx, tr, trcr = torch_ops.nekbone_cg_update(
        torch.as_tensor(x), tp, torch.as_tensor(r), w2.reshape(tp.shape),
        alpha, grid)
    assert _rel(tx, jx) <= RTOL and _rel(tr, jr) <= RTOL
    assert abs(float(trcr) - float(jrcr)) <= RTOL * abs(float(jrcr))


@pytest.mark.parametrize("b", [1, 3])
def test_ops_block_entries_match_reference(x64, b):
    """``ops.nekbone_ax_dots_slab_block`` and ``ops.nekbone_cg_update_block``
    against the reference's batched entries (a length-b beta and alpha):
    p, w, the per-RHS pap, x, r and the per-RHS rcr to 1e-12."""
    n, grid = 4, (2, 2, 4)
    jcase, p_prev, r, x = _ops_operands(150 + b, n, grid, b)
    beta = np.linspace(0.2, 0.6, b)
    alpha = np.linspace(0.5, 0.9, b)
    jp, jw, jpap = jax_ops.nekbone_ax_dots_slab_block(
        jnp.asarray(p_prev), jnp.asarray(r), jcase.D, jcase.g, grid,
        beta=jnp.asarray(beta), sz=2, layout="fold", grid_order="parallel",
        interpret=True)
    jx, jr, jrcr = jax_ops.nekbone_cg_update_block(
        jnp.asarray(x), jp, jnp.asarray(r), jw, jnp.asarray(alpha), grid,
        sz=4, interpret=True)
    tcase = TorchCase(n=n, grid=grid, dtype=torch.float64, device="cpu")
    tp, tw, tpap = torch_ops.nekbone_ax_dots_slab_block(
        torch.as_tensor(p_prev), torch.as_tensor(r), tcase.D, tcase.g, grid,
        beta=torch.as_tensor(beta))
    assert tpap.shape == (b,)
    assert _rel(tp, jp) <= RTOL and _rel(tw, jw) <= RTOL
    assert _rel(tpap, jpap) <= RTOL
    E = tcase.mesh.nelt
    (m, _) = torch_ops.slab_axis_factors(grid, n, torch.float64, "cpu")
    _, w3, _ = torch_kernels.nekbone_ax_slab_block_cuda(
        torch.as_tensor(p_prev).reshape(b, E, -1),
        torch.as_tensor(r).reshape(b, E, -1), tcase.D,
        torch_ops.diag_metric(tcase.g, E, n), *m, torch.as_tensor(beta),
        n=n)
    tx, tr, trcr = torch_ops.nekbone_cg_update_block(
        torch.as_tensor(x), tp, torch.as_tensor(r), w3.reshape(tp.shape),
        torch.as_tensor(alpha), grid)
    assert trcr.shape == (b,)
    assert _rel(tx, jx) <= RTOL and _rel(tr, jr) <= RTOL
    assert _rel(trcr, jrcr) <= RTOL
