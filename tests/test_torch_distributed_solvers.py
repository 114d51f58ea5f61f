"""Port parity, sharded: s-step CG and Jacobi/Chebyshev PCG over
``torch.distributed`` with gloo on the CPU, and their collective counts.

The worlds run as in ``tests/test_torch_distributed_gs.py`` (whose
harness this file imports): this file runs itself as

    python tests/test_torch_distributed_solvers.py <checks.json> \\
        <out_dir> <rank> <world> <init_file>

each rank running only the port and writing its arrays, the parent
computing the JAX reference in-process (fp64, Pallas in interpret mode).
The grids, ``theta``, iteration counts and bars are those of
``tests/distributed_checks.py``'s ``_sstep_sharded_parity``,
``check_pcg_*_sharded``, ``check_pcg_sharded_precision`` and
``check_sstep_collective_counts``.
"""
from __future__ import annotations

import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve()
sys.path.insert(0, str(HERE.parent))

from test_torch_distributed_gs import Worlds, child_main, load  # noqa: E402

THETA = 2.25
# (label, s, global grid, iterations): _sstep_sharded_parity's cases on 8
# ranks, and s = 4 on 2 ranks (both shards at a global end)
SSTEP_CASES = [("s1", 1, (2, 2, 16), 10, 8), ("s2", 2, (2, 2, 16), 10, 8),
               ("s4", 4, (1, 2, 32), 8, 8), ("s4w2", 4, (2, 2, 8), 8, 2)]
# check_sstep_collective_counts' (s, global grid) cases on 8 ranks
COUNT_CASES = [(1, (2, 2, 16)), (2, (2, 2, 16)), (4, (1, 2, 32)),
               (1, (1, 1, 32))]
PCG_GRID = (2, 2, 16)
PCG_NITER = 12
PRECISION_CASES = [("jacobi", "f32", 1e-4), ("jacobi", "bf16", 2e-2),
                   ("cheb2", "f32", 1e-4)]


# ---------------------------------------------------------------------------
# child checks: the port alone
# ---------------------------------------------------------------------------

def _np(t):
    return t.detach().to("cpu").to(dtype=__import__("torch").float64) \
        .numpy()


def _case(n, grid, dtype_name="f64"):
    import torch

    from repro_torch.core.nekbone import NekboneCase

    dtype = torch.float64 if dtype_name == "f64" else torch.float32
    case = NekboneCase(n=n, grid=tuple(grid), dtype=dtype, device="cpu")
    return case, case.manufactured()[1]


def _precond(spec):
    from repro_torch.core.precond import ChebyshevPrecond

    if spec == "jacobi":
        return spec
    return ChebyshevPrecond(k=int(spec[0]), lmin=spec[1], lmax=spec[2])


def c_sstep(n, grid, s, niter, theta):
    from repro_torch.distributed import sharding
    from repro_torch.distributed.sstep import cg_sstep_sharded_fixed_iters

    case, f = _case(n, grid)
    with sharding.collective_log() as log:
        res = cg_sstep_sharded_fixed_iters(
            f, D=case.D, g=case.g, grid=case.grid, niter=niter, s=s,
            mask=case.mask, c=case.c, theta=theta)
    return {"x": _np(res.x), "hist": _np(res.history),
            "iters": int(res.iters_taken),
            "counts": np.array([log.counts.get(k, 0) for k in
                                ("ppermute", "psum", "all_gather")])}


def c_sstep_tol(n, grid, s, niter, theta):
    """The fixed run, then the tolerance run stopped a little above the
    least of its entries 1..niter-1 (the history is not monotone)."""
    from repro_torch.distributed.sstep import cg_sstep_sharded_fixed_iters

    case, f = _case(n, grid)
    kw = dict(D=case.D, g=case.g, grid=case.grid, s=s, mask=case.mask,
              c=case.c, theta=theta)
    full = cg_sstep_sharded_fixed_iters(f, niter=niter, **kw)
    tol = float(full.history[1:niter].min()) * 1.01
    got = cg_sstep_sharded_fixed_iters(f, niter=niter, tol=tol, **kw)
    return {"full": _np(full.history), "hist": _np(got.history),
            "iters": int(got.iters_taken), "x": _np(got.x)}


def c_counts(n, grid, s):
    from repro_torch.distributed import sharding
    from repro_torch.distributed.sstep import cycle_collective_counts

    got = cycle_collective_counts(grid=tuple(grid), n=n, s=s,
                                  device="cpu")
    mesh = sharding.solver_mesh()
    return {"cycle": np.array([got["cycle"].get(k, 0) for k in
                               ("ppermute", "psum", "all_gather")]),
            "update": np.array(sum(got["update"].values())),
            "bytes": np.array(got["bytes"].get("ppermute", 0)),
            "shard": np.array(mesh.shard)}


def c_pcg(n, grid, niter, precond, policy):
    """Sharded PCG, and the port's single-device PCG at the same policy."""
    from repro_torch.core.precond import pcg_fused_v2_fixed_iters
    from repro_torch.distributed import sharding
    from repro_torch.distributed.pcg import pcg_sharded_fixed_iters

    case, f = _case(n, grid, "f64" if policy == "f64" else "f32")
    kw = dict(D=case.D, g=case.g, grid=case.grid, niter=niter,
              precond=_precond(precond), mask=case.mask, c=case.c,
              precision=None if policy == "f64" else policy)
    with sharding.collective_log() as log:
        res = pcg_sharded_fixed_iters(f, **kw)
    one = pcg_fused_v2_fixed_iters(f, **kw)
    return {"x": _np(res.x), "hist": _np(res.history),
            "x_one": _np(one.x), "hist_one": _np(one.history),
            "x_dtype": str(res.x.dtype), "x_one_dtype": str(one.x.dtype),
            "counts": np.array([log.counts.get(k, 0) for k in
                                ("ppermute", "psum", "all_gather")]),
            "bytes": np.array(log.bytes.get("ppermute", 0)),
            "shard": np.array(sharding.solver_mesh().shard)}


def c_pcg_tol(n, grid, precond):
    from repro_torch.distributed.pcg import (pcg_sharded_fixed_iters,
                                             pcg_sharded_tol)

    case, f = _case(n, grid)
    kw = dict(D=case.D, g=case.g, grid=case.grid,
              precond=_precond(precond), mask=case.mask, c=case.c)
    full = pcg_sharded_fixed_iters(f, niter=20, **kw)
    tol = float(full.history[12]) * 1.01
    got = pcg_sharded_tol(f, tol=tol, max_iter=20, **kw)
    return {"full": _np(full.history), "hist": _np(got.history),
            "iters": int(got.iters_taken)}


CHILD_CHECKS = {"sstep": c_sstep, "sstep_tol": c_sstep_tol,
                "counts": c_counts, "pcg": c_pcg, "pcg_tol": c_pcg_tol}


def world_checks(cheb2) -> dict:
    """The checks of each world, in run order; ``cheb2`` is the reference's
    Chebyshev(2) spec ``[k, lmin, lmax]`` on ``PCG_GRID``."""
    w = {2: [], 4: [], 8: []}
    for label, s, grid, niter, world in SSTEP_CASES:
        w[world].append([f"sstep@{label}", dict(n=4, grid=list(grid), s=s,
                                                niter=niter, theta=THETA)])
    w[8].append(["sstep_tol@s2", dict(n=4, grid=[2, 2, 16], s=2, niter=10,
                                      theta=THETA)])
    for i, (s, grid) in enumerate(COUNT_CASES):
        w[8].append([f"counts@{i}", dict(n=4, grid=list(grid), s=s)])
    for name, spec in (("jacobi", "jacobi"), ("cheb2", cheb2)):
        w[8].append([f"pcg@{name}_f64", dict(
            n=4, grid=list(PCG_GRID), niter=PCG_NITER, precond=spec,
            policy="f64")])
        w[8].append([f"pcg_tol@{name}", dict(n=4, grid=list(PCG_GRID),
                                             precond=spec)])
    for name, policy, _ in PRECISION_CASES:
        w[8].append([f"pcg@{name}_{policy}", dict(
            n=4, grid=list(PCG_GRID), niter=PCG_NITER,
            precond="jacobi" if name == "jacobi" else cheb2,
            policy=policy)])
    # 4 ranks of 4 layers: the Chebyshev ghost windows with 2-shard ends
    w[4].append(["pcg@cheb2_w4", dict(n=4, grid=list(PCG_GRID),
                                      niter=PCG_NITER, precond=cheb2,
                                      policy="f64")])
    return w


if __name__ == "__main__":
    sys.exit(child_main(sys.argv[1:], CHILD_CHECKS))


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------

import pytest  # noqa: E402


def _jax_case(grid, dtype="f64"):
    import jax.numpy as jnp

    from repro.core.nekbone import NekboneCase as JaxCase

    jcase = JaxCase(n=4, grid=tuple(grid),
                    dtype=jnp.float64 if dtype == "f64" else jnp.float32)
    return jcase, jcase.manufactured()[1]


@pytest.fixture(scope="module")
def cheb2_spec():
    import jax

    from repro.core import precond as jax_pc

    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        jcase, _ = _jax_case(PCG_GRID)
        spec = jax_pc.make_preconditioner("cheb2", D=jcase.D, g=jcase.g,
                                          grid=PCG_GRID, mask=jcase.mask,
                                          c=jcase.c)
        return [int(spec.k), float(spec.lmin), float(spec.lmax)]
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, cheb2_spec):
    return Worlds(HERE, world_checks(cheb2_spec), tmp_path_factory)


def _jax_pcg(precond_spec, grid, niter, policy="f64"):
    from repro.core.precond import ChebyshevPrecond as JaxCheb
    from repro.core.precond import pcg_fused_v2_fixed_iters

    jcase, f = _jax_case(grid, policy)
    pc = precond_spec if precond_spec == "jacobi" else JaxCheb(
        k=precond_spec[0], lmin=precond_spec[1], lmax=precond_spec[2])
    return pcg_fused_v2_fixed_iters(
        f, D=jcase.D, g=jcase.g, grid=grid, niter=niter, precond=pc,
        mask=jcase.mask, c=jcase.c, sz=2, cheb_sz=2, interpret=True,
        precision=None if policy == "f64" else policy)


@pytest.mark.parametrize("label,s,grid,niter,world", SSTEP_CASES)
def test_sstep_sharded_matches_reference(x64, worlds, label, s, grid, niter,
                                         world):
    """Sharded s-step against the reference's single-device s-step: the
    history to 1e-9 h0 (same length), x to 1e-8 of max|x|, one exchange
    and one psum a cycle, the last update's psum and one all-gather."""
    from repro.core.cg_sstep import cg_sstep_fixed_iters

    jcase, f = _jax_case(grid)
    ref = cg_sstep_fixed_iters(f, D=jcase.D, g=jcase.g, grid=grid,
                               niter=niter, s=s, mask=jcase.mask, c=jcase.c,
                               sz=2, theta=THETA, interpret=True)
    h_ref = np.asarray(ref.rnorm_history, np.float64)
    x_ref = np.asarray(ref.x, np.float64)
    cycles = -(-niter // s)
    for rank in range(world):
        got = load(worlds(world), f"sstep@{label}", rank)
        assert got["hist"].shape == h_ref.shape
        assert float(np.abs(got["hist"] - h_ref).max()) < 1e-9 * h_ref[0]
        scale = float(np.abs(x_ref).max()) + 1e-30
        assert float(np.abs(got["x"] - x_ref).max()) < 1e-8 * scale
        assert int(got["iters"]) == niter
        assert got["counts"].tolist() == [2 * cycles, cycles + 1, 1]


def test_sstep_sharded_tol_is_a_prefix(worlds):
    """The tolerance-driven sharded s-step history is bitwise a prefix of
    the fixed run's, every shard stopping at the same iteration."""
    iters = set()
    for rank in range(8):
        got = load(worlds(8), "sstep_tol@s2", rank)
        kk = int(got["iters"])
        iters.add(kk)
        assert 0 < kk < 10
        np.testing.assert_array_equal(got["hist"][:kk], got["full"][:kk])
    assert len(iters) == 1


@pytest.mark.parametrize("i", range(len(COUNT_CASES)))
def test_sstep_collective_counts(worlds, i):
    """Every shard: {"ppermute": 2, "psum": 1} per cycle and {} per update;
    the cycle's ppermute bytes are cost.sstep_collective_streams' (sent and
    received) on a shard with two neighbours and half that at a global
    end."""
    from repro_torch.core import cost

    s, grid = COUNT_CASES[i]
    ex, ey, ez = grid
    ez_l = ez // 8
    stream = ex * ey * ez_l * 4 ** 3 * 8
    for rank in range(8):
        got = load(worlds(8), f"counts@{i}", rank)
        assert got["cycle"].tolist() == [2, 1, 0]
        assert int(got["update"]) == 0
        book = cost.sstep_collective_streams(s, ez_l) * s * stream
        edge = int(got["shard"]) in (0, 7)
        assert int(got["bytes"]) == (book / 2 if edge else book)


@pytest.mark.parametrize("name,world", [("jacobi_f64", 8), ("cheb2_f64", 8),
                                        ("cheb2_w4", 4)])
def test_pcg_sharded_matches_reference(x64, worlds, cheb2_spec, name,
                                       world):
    """Sharded Jacobi and Chebyshev(2) PCG against the reference's
    pcg_fused_v2_fixed_iters: the finite history entries to 1e-10 h0, x to
    1e-9 of max|x|; the x dtype kept."""
    spec = "jacobi" if name.startswith("jacobi") else cheb2_spec
    ref = _jax_pcg(spec, PCG_GRID, PCG_NITER)
    h_ref = np.asarray(ref.rnorm_history, np.float64)
    x_ref = np.asarray(ref.x, np.float64)
    ok = np.isfinite(h_ref)
    for rank in range(world):
        got = load(worlds(world), f"pcg@{name}", rank)
        assert float(np.abs(got["hist"][ok] - h_ref[ok]).max()) < \
            1e-10 * h_ref[0]
        scale = float(np.abs(x_ref).max()) + 1e-30
        assert float(np.abs(got["x"] - x_ref).max()) < 1e-9 * scale
        assert got["x_dtype"] == "torch.float64"


@pytest.mark.parametrize("name,world", [("jacobi_f64", 8), ("cheb2_f64", 8),
                                        ("cheb2_w4", 4)])
def test_pcg_sharded_collective_counts(worlds, name, world):
    """Per iteration Jacobi issues 2 ppermutes (the planes) and 2 psums
    (pap; rtz with rcr), Chebyshev 4 ppermutes (the planes, the r ghosts)
    and 2 psums, plus the start's psum (and Chebyshev's first ghost
    exchange) and one all-gather.  The ppermute bytes are the cost books':
    v2_plane_collective_streams (+ cheb_collective_streams) an iteration,
    half on a shard at a global end."""
    from repro_torch.core import cost

    cheb = name.startswith("cheb")
    ex, ey, ez = PCG_GRID
    ez_l = ez // world
    n = 4
    stream = ex * ey * ez_l * n ** 3 * 8
    for rank in range(world):
        got = load(worlds(world), f"pcg@{name}", rank)
        per_it = 4 if cheb else 2
        assert got["counts"].tolist() == [
            per_it * PCG_NITER + (2 if cheb else 0), 2 * PCG_NITER + 1, 1]
        plane = cost.v2_plane_collective_streams(n, ez_l) * stream
        ghost = cost.cheb_collective_streams(2, ez_l) * stream if cheb else 0
        book = PCG_NITER * plane + (PCG_NITER + 1) * ghost
        edge = int(got["shard"]) in (0, world - 1)
        assert int(got["bytes"]) == pytest.approx(book / 2 if edge else book,
                                                  rel=1e-12)


@pytest.mark.parametrize("name", ["jacobi", "cheb2"])
def test_pcg_sharded_tol_is_a_prefix(worlds, name):
    """pcg_sharded_tol stops inside the run, its history a bitwise prefix
    of the fixed run's and NaN after, the same on every shard."""
    for rank in range(8):
        got = load(worlds(8), f"pcg_tol@{name}", rank)
        kk = int(got["iters"])
        assert 0 < kk < 20
        np.testing.assert_array_equal(got["hist"][:kk + 1],
                                      got["full"][:kk + 1])
        assert np.isnan(got["hist"][kk + 1:]).all()


@pytest.mark.parametrize("name,policy,tol", PRECISION_CASES)
def test_pcg_sharded_precision(worlds, name, policy, tol):
    """The f32 and bf16 policies against the port's own single-device PCG
    at the same policy, with check_pcg_sharded_precision's bars: x to tol
    of max|x|, entries 0..7 to tol of h0, a finite history with a net
    decrease, the x dtype the single-device run's."""
    for rank in range(8):
        got = load(worlds(8), f"pcg@{name}_{policy}", rank)
        assert got["x_dtype"] == got["x_one_dtype"]
        scale = float(np.abs(got["x_one"]).max()) + 1e-30
        assert float(np.abs(got["x"] - got["x_one"]).max()) < tol * scale
        h, h_one = got["hist"], got["hist_one"]
        assert np.isfinite(h).all() and h[-1] < h[0]
        assert float(np.abs(h[:8] - h_one[:8]).max()) < tol * h_one[0]


# ---------------------------------------------------------------------------
# the one-shard mesh (no process group), in-process
# ---------------------------------------------------------------------------

def _torch_case(grid, n=4):
    import torch

    from repro_torch.core.nekbone import NekboneCase

    case = NekboneCase(n=n, grid=grid, dtype=torch.float64, device="cpu")
    return case, case.manufactured()[1]


@pytest.mark.parametrize("s", [1, 2, 4])
def test_one_shard_sstep_is_the_single_device_run(s):
    """Without a process group the sharded s-step is one shard: bitwise the
    single-device driver (the reference's ndev=1 check, there to 1e-12)."""
    import torch

    from repro_torch.core.cg_sstep import cg_sstep_fixed_iters
    from repro_torch.distributed.sstep import cg_sstep_sharded_fixed_iters

    case, f = _torch_case((2, 2, 8))
    kw = dict(D=case.D, g=case.g, grid=case.grid, niter=10, s=s,
              mask=case.mask, c=case.c, theta=THETA)
    one = cg_sstep_fixed_iters(f, **kw)
    got = cg_sstep_sharded_fixed_iters(f, **kw)
    assert torch.equal(got.history, one.history)
    assert torch.equal(got.x, one.x)


@pytest.mark.parametrize("precond", ["jacobi", "cheb2"])
def test_one_shard_pcg_is_the_single_device_run(precond):
    import torch

    from repro_torch.core.precond import pcg_fused_v2_fixed_iters
    from repro_torch.distributed.pcg import pcg_sharded_fixed_iters

    case, f = _torch_case((2, 2, 8))
    kw = dict(D=case.D, g=case.g, grid=case.grid, niter=12,
              precond=case.precond_spec(precond), mask=case.mask, c=case.c)
    one = pcg_fused_v2_fixed_iters(f, **kw)
    got = pcg_sharded_fixed_iters(f, **kw)
    assert torch.equal(got.history, one.history)
    assert torch.equal(got.x, one.x)


def test_sharded_drivers_reject_what_the_reference_rejects():
    """s (or k) deeper than the shard's layers, s < 1, no preconditioner,
    and a preconditioner the sharded PCG does not take."""
    from repro_torch.distributed.pcg import pcg_sharded_fixed_iters
    from repro_torch.distributed.sstep import cg_sstep_sharded_fixed_iters

    case, f = _torch_case((1, 1, 2), n=3)
    kw = dict(D=case.D, g=case.g, grid=case.grid, mask=case.mask, c=case.c)
    with pytest.raises(ValueError, match="halo depth"):
        cg_sstep_sharded_fixed_iters(f, niter=4, s=4, theta=THETA, **kw)
    with pytest.raises(ValueError, match="s >= 1"):
        cg_sstep_sharded_fixed_iters(f, niter=4, s=0, theta=THETA, **kw)
    with pytest.raises(ValueError, match="needs a preconditioner"):
        pcg_sharded_fixed_iters(f, niter=4, precond=None, **kw)
    with pytest.raises(ValueError, match="halo depth"):
        pcg_sharded_fixed_iters(f, niter=4, precond="cheb4", **kw)
    with pytest.raises(TypeError, match="Jacobi or Chebyshev"):
        pcg_sharded_fixed_iters(f, niter=2, precond="pmg", **kw)
