"""Port parity, sharded: the gather-scatter, the ghost windows, v1 CG and
K5/K10's edge planes, over ``torch.distributed`` with gloo on the CPU.

Each world of 2, 4 or 8 ranks is a set of child processes that run only
the port: this file runs itself as

    python tests/test_torch_distributed_gs.py <checks.json> <out_dir> \\
        <rank> <world> <init_file>

and each rank writes one ``<check>_<rank>.npz`` per check of the list
under ``out_dir``.  A world is spawned once per module (all its checks in
one run, in order), with ``init_method="file://..."`` under the test's
temporary directory (no TCP port, so xdist workers never collide), a 60 s
timeout on ``init_process_group`` and a 120 s timeout on the children.
The parent computes the JAX reference in-process (fp64 on the CPU, the
Pallas kernels in interpret mode) and compares.  The bars are
``tests/distributed_checks.py``'s; the sharded gather-scatter is bitwise.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np

HERE = pathlib.Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
CHILD_TIMEOUT_S = 120
INIT_TIMEOUT_S = 60


# ---------------------------------------------------------------------------
# the world: spawn, wait, read
# ---------------------------------------------------------------------------

def spawn_world(script: pathlib.Path, world: int, checks: list,
                tmp: pathlib.Path) -> pathlib.Path:
    """Run ``checks`` (``[[name, params], ...]``) on ``world`` gloo ranks of
    ``script``; return the directory of their ``.npz`` files.  Raises if
    a rank fails or the world outlives :data:`CHILD_TIMEOUT_S`."""
    out = tmp / f"world{world}"
    out.mkdir(parents=True, exist_ok=True)
    spec = out / "checks.json"
    spec.write_text(json.dumps(checks))
    init = out / "rendezvous"
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.pop("JAX_ENABLE_X64", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(spec), str(out), str(rank),
         str(world), str(init)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    logs, failed = [], False
    for rank, proc in enumerate(procs):
        try:
            log, _ = proc.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            log, _ = proc.communicate()
            failed = True
            log += f"\nrank {rank}: killed after {CHILD_TIMEOUT_S} s"
        failed |= proc.returncode != 0
        logs.append(f"--- rank {rank} (rc {proc.returncode})\n{log[-3000:]}")
    if failed:
        raise RuntimeError(f"world of {world} failed:\n" + "\n".join(logs))
    return out


def load(out: pathlib.Path, name: str, rank: int = 0) -> dict:
    with np.load(out / f"{name}_{rank}.npz") as z:
        return {k: z[k] for k in z.files}


class Worlds:
    """Spawn each world size once per module, with every check of it."""

    def __init__(self, script, checks: dict, tmp_factory):
        self.script = script
        self.checks = checks
        self.tmp_factory = tmp_factory
        self.done: dict = {}

    def __call__(self, world: int) -> pathlib.Path:
        if world not in self.done:
            tmp = self.tmp_factory.mktemp(f"{self.script.stem}_w{world}")
            try:
                self.done[world] = spawn_world(self.script, world,
                                               self.checks[world], tmp)
            except RuntimeError as exc:
                self.done[world] = exc
        got = self.done[world]
        if isinstance(got, Exception):
            raise got
        return got


def child_main(argv, registry: dict) -> int:
    """A rank of a spawned world: run every check of the list and write
    its arrays.  Any failure ends the process with an error."""
    spec, out, rank, world, init = argv
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=int(rank), world_size=int(world),
                            timeout=timedelta(seconds=INIT_TIMEOUT_S))
    try:
        for name, params in json.loads(pathlib.Path(spec).read_text()):
            res = registry[name.split("@")[0]](**params)
            np.savez(pathlib.Path(out) / f"{name}_{rank}.npz", **res)
    finally:
        dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# child checks: the port alone (no jax, no repro)
# ---------------------------------------------------------------------------

def _np(t):
    return t.detach().to("cpu").numpy()


def c_ds_sum(n, grid_local, seed, order=None):
    """ds_sum_sharded of a random field, gathered: (global field)."""
    import torch

    from repro_torch.core.gs import ds_sum_sharded
    from repro_torch.distributed import sharding

    mesh = sharding.solver_mesh(order=order)
    ex, ey, ezl = grid_local
    E = ex * ey * ezl * mesh.ndev
    u = torch.as_tensor(np.random.default_rng(seed).normal(
        size=(E, n, n, n)))
    with sharding.collective_log() as log:
        v = ds_sum_sharded(sharding.shard_leading(u, mesh), tuple(grid_local),
                           mesh)
    got = sharding.all_gather(v.contiguous(), mesh)
    return {"v": _np(got), "u_after": _np(u), "ppermute": log.counts.get(
        "ppermute", 0), "other": sum(log.counts.values())}


def c_extend(n, grid, depth, seed):
    """A shard's extended p, g3 window and z factors."""
    import torch

    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.distributed import sharding
    from repro_torch.distributed.halo import ghost_window
    from repro_torch.distributed.sstep import exchange_ghost_slabs
    from repro_torch.kernels import ops

    mesh = sharding.solver_mesh()
    ex, ey, ez = grid
    E = ex * ey * ez
    f = torch.as_tensor(np.random.default_rng(seed).normal(size=(E, n ** 3)))
    win = ghost_window(mesh, grid, depth)
    f_l = sharding.shard_leading(f, mesh).contiguous()
    below, above = exchange_ghost_slabs(
        f_l.reshape(win.ez_local, ex * ey, -1), win.ez_local, depth, mesh)
    case = NekboneCase(n=n, grid=tuple(grid), dtype=torch.float64,
                       device="cpu")
    g3 = ops.diag_metric(case.g, E, n)
    (_, _, mz), (_, _, cz) = ops.slab_axis_factors(tuple(grid), n,
                                                   torch.float64, "cpu")
    ext = win.extend(f_l, below, above)
    return {"ext": _np(ext), "own": _np(win.own(ext)), "f_l": _np(f_l),
            "g3": _np(win.cut(g3)), "mz": _np(win.cut_z(mz)),
            "cz": _np(win.cut_z(cz)),
            "window": np.array([win.z0, win.ez_local, win.below,
                                win.above])}


def c_v1(n, grid, niter, policy):
    """v1 sharded on the manufactured case, and the port's single-device
    v1 at the same policy."""
    import torch

    from repro_torch.core.cg_fused import (cg_fused_fixed_iters,
                                           cg_fused_sharded_fixed_iters)
    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.distributed import sharding

    mesh = sharding.solver_mesh()
    dtype = torch.float64 if policy == "f64" else torch.float32
    case = NekboneCase(n=n, grid=tuple(grid), dtype=dtype, device="cpu")
    _, f = case.manufactured()
    prec = None if policy in ("f64", "none") else policy
    cut = lambda a: sharding.shard_leading(a, mesh)  # noqa: E731
    with sharding.collective_log() as log:
        res = cg_fused_sharded_fixed_iters(
            cut(f), D=case.D, g=cut(case.g), mask=cut(case.mask),
            c=cut(case.c), grid_local=case.shard_grid(mesh.ndev),
            niter=niter, mesh=mesh, precision=prec)
    x = sharding.all_gather(res.x.contiguous(), mesh)
    one = cg_fused_fixed_iters(f, D=case.D, g=case.g, mask=case.mask,
                               c=case.c, grid=case.grid, niter=niter,
                               precision=prec)
    return {"x": _np(x.to(torch.float64)), "hist": _np(res.history),
            "x_one": _np(one.x.to(torch.float64)),
            "hist_one": _np(one.history), "x_dtype": str(res.x.dtype),
            "ppermute": log.counts.get("ppermute", 0),
            "psum": log.counts.get("psum", 0),
            "all_gather": log.counts.get("all_gather", 0)}


def c_ax_full(n, grid, seed):
    """NekboneCase.sharded_ax_full on a random continuous field."""
    import torch

    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.distributed import sharding

    mesh = sharding.solver_mesh()
    case = NekboneCase(n=n, grid=tuple(grid), dtype=torch.float64,
                       device="cpu")
    u = torch.as_tensor(np.random.default_rng(seed).normal(
        size=case.mask.shape))
    cut = lambda a: sharding.shard_leading(a, mesh)  # noqa: E731
    op = case.sharded_ax_full(mesh)
    w = op(cut(u), cut(case.g), cut(case.mask), case.shard_grid(mesh.ndev))
    return {"w": _np(sharding.all_gather(w.contiguous(), mesh)),
            "w_one": _np(case.ax_full(u))}


CHILD_CHECKS = {"ds_sum": c_ds_sum, "extend": c_extend, "v1": c_v1,
                "ax_full": c_ax_full}

# The checks of each world, run in this order by every rank.
DS_GRID_LOCAL = (2, 3, 2)
EXTEND_CASES = [((2, 2, 8), 1), ((2, 2, 8), 2), ((1, 2, 16), 4)]
V1_GRID = (2, 2, 8)
V1_POLICIES = ["f64", "none", "f32", "bf16"]
WORLD_CHECKS = {
    2: [["ds_sum@2", dict(n=4, grid_local=DS_GRID_LOCAL, seed=3)]],
    4: [["ds_sum@4", dict(n=4, grid_local=DS_GRID_LOCAL, seed=3)],
        ["ds_sum@hier", dict(n=3, grid_local=(2, 2, 2), seed=4,
                             order=[[0, 2], [1, 3]])],
        *[[f"extend@{i}", dict(n=4, grid=list(g), depth=d, seed=5)]
          for i, (g, d) in enumerate(EXTEND_CASES)],
        ["ax_full@4", dict(n=4, grid=[2, 2, 8], seed=6)]],
    8: [["ds_sum@8", dict(n=4, grid_local=DS_GRID_LOCAL, seed=3)],
        *[[f"v1@{p}", dict(n=4, grid=list(V1_GRID),
                           niter=30 if p in ("f64", "none") else 20,
                           policy=p)] for p in V1_POLICIES]],
}


if __name__ == "__main__":
    sys.exit(child_main(sys.argv[1:], CHILD_CHECKS))


# ---------------------------------------------------------------------------
# the parent: the reference in-process, and the comparisons
# ---------------------------------------------------------------------------

import pytest  # noqa: E402
import torch  # noqa: E402


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return Worlds(HERE, WORLD_CHECKS, tmp_path_factory)


@pytest.mark.parametrize("world", [2, 4, 8])
def test_ds_sum_sharded_bitwise(x64, worlds, world):
    """Gathered, the sharded sum is bitwise the reference's ds_sum_local of
    the whole field (fp64); the input is untouched; one exchange."""
    import jax.numpy as jnp

    from repro.core import gs as jax_gs

    got = load(worlds(world), f"ds_sum@{world}")
    ex, ey, ezl = DS_GRID_LOCAL
    want = np.asarray(jax_gs.ds_sum_local(jnp.asarray(got["u_after"]),
                                          (ex, ey, ezl * world)))
    np.testing.assert_array_equal(got["v"], want)
    u = np.random.default_rng(3).normal(size=got["u_after"].shape)
    np.testing.assert_array_equal(got["u_after"], u)
    assert int(got["ppermute"]) == 2 and int(got["other"]) == 2


def test_ds_sum_sharded_hierarchical_order(x64, worlds):
    """A 2x2 (pod, data) world flattened in that order — shard s on rank
    order[s] of [[0, 2], [1, 3]] — gives the reference's result."""
    import jax.numpy as jnp

    from repro.core import gs as jax_gs

    out = worlds(4)
    got = load(out, "ds_sum@hier")
    want = np.asarray(jax_gs.ds_sum_local(jnp.asarray(got["u_after"]),
                                          (2, 2, 8)))
    np.testing.assert_array_equal(got["v"], want)
    for rank in (1, 2, 3):
        np.testing.assert_array_equal(load(out, "ds_sum@hier", rank)["v"],
                                      want)


@pytest.mark.parametrize("i", range(len(EXTEND_CASES)))
def test_ghost_extension_matches_reference_windows(x64, worlds, i):
    """Each shard's extended field, g3 window and z-factor windows equal
    the reference's sstep_extend_field / sstep_extend_zfactor windows with
    sz = the shard's layers, less their padding past a global end."""
    import jax.numpy as jnp

    from repro.core.nekbone import NekboneCase as JaxCase
    from repro.kernels import nekbone_ax as jax_ax
    from repro.kernels import ops as jax_ops

    grid, depth = EXTEND_CASES[i]
    ex, ey, ez = grid
    n = 4
    world = 4
    ezl = ez // world
    E = ex * ey * ez
    f = np.random.default_rng(5).normal(size=(E, n ** 3))
    wf = np.asarray(jax_ax.sstep_extend_field(jnp.asarray(f), grid, ezl,
                                              depth))
    jcase = JaxCase(n=n, grid=grid, dtype=jnp.float64)
    g3 = jax_ops.diag_metric(jcase.g, E, n)
    wg = np.asarray(jax_ax.sstep_extend_field(g3, grid, ezl, depth))
    (_, _, mz), (_, _, cz) = jax_ops.slab_axis_factors(grid, n, jnp.float64)
    wmz = np.asarray(jax_ax.sstep_extend_zfactor(mz, ezl, depth))
    wcz = np.asarray(jax_ax.sstep_extend_zfactor(cz, ezl, depth))
    L = ezl + 2 * depth
    for rank in range(world):
        got = load(worlds(world), f"extend@{i}", rank)
        z0, ez_l, below, above = got["window"].tolist()
        assert (z0, ez_l) == (rank * ezl, ezl)
        assert (below, above) == (0 if rank == 0 else depth,
                                  0 if rank == world - 1 else depth)
        lo, hi = depth - below, L - depth + above
        blk = wf[rank].reshape(L, ex * ey, n ** 3)[lo:hi]
        np.testing.assert_array_equal(got["ext"].reshape(blk.shape), blk)
        np.testing.assert_array_equal(got["own"], got["f_l"])
        gblk = wg[rank].reshape(L, ex * ey, 3, n ** 3)[lo:hi]
        np.testing.assert_allclose(got["g3"].reshape(gblk.shape), gblk,
                                   rtol=1e-14, atol=0)
        np.testing.assert_array_equal(got["mz"], wmz[rank][lo:hi])
        np.testing.assert_array_equal(got["cz"], wcz[rank][lo:hi])


def test_sharded_ax_full_matches_reference(x64, worlds):
    """NekboneCase.sharded_ax_full over 4 shards, gathered: the port's
    single-device ax_full bitwise, and the reference's to 1e-12."""
    import jax.numpy as jnp

    from repro.core.nekbone import NekboneCase as JaxCase

    got = load(worlds(4), "ax_full@4")
    np.testing.assert_array_equal(got["w"], got["w_one"])
    jcase = JaxCase(n=4, grid=(2, 2, 8), dtype=jnp.float64)
    u = np.random.default_rng(6).normal(size=jcase.mask.shape)
    want = np.asarray(jcase.ax_full(jnp.asarray(u)))
    np.testing.assert_allclose(got["w"], want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def _jax_v1(policy, niter):
    import jax.numpy as jnp

    from repro.core.cg_fused import cg_fused_fixed_iters
    from repro.core.nekbone import NekboneCase as JaxCase

    dtype = jnp.float64 if policy == "f64" else jnp.float32
    jcase = JaxCase(n=4, grid=V1_GRID, dtype=dtype)
    _, f = jcase.manufactured()
    return cg_fused_fixed_iters(f, D=jcase.D, g=jcase.g, mask=jcase.mask,
                                c=jcase.c, grid=jcase.grid, niter=niter,
                                interpret=True)


def test_v1_sharded_matches_reference(x64, worlds):
    """cg_fused_sharded_fixed_iters over 8 shards (EZ_local = 1) against the
    reference's cg_fused_fixed_iters, with check_fused_cg_sharded's bars
    (x to tol of max|x|, entries 0..9 to tol of h0): f32 at its 1e-4, and
    fp64 at 1e-10."""
    out = worlds(8)
    for policy, tol in (("f64", 1e-10), ("none", 1e-4)):
        got = load(out, f"v1@{policy}")
        ref = _jax_v1(policy, 30)
        h_ref = np.asarray(ref.rnorm_history, np.float64)
        x_ref = np.asarray(ref.x, np.float64)
        scale = max(float(np.abs(x_ref).max()), 1.0)
        assert float(np.abs(got["x"] - x_ref).max()) < tol * scale, policy
        h = got["hist"].astype(np.float64)
        assert np.isfinite(h).all()
        assert float(np.abs(h[:10] - h_ref[:10]).max()) < tol * h_ref[0]


def test_v1_sharded_collective_counts(worlds):
    """Per iteration 2 ppermutes (the plane exchange) and 2 psums (pap,
    r·c·r); one more psum for the first r·c·r."""
    for policy in V1_POLICIES:
        got = load(worlds(8), f"v1@{policy}")
        niter = 30 if policy in ("f64", "none") else 20
        assert int(got["ppermute"]) == 2 * niter
        assert int(got["psum"]) == 2 * niter + 1
        assert int(got["all_gather"]) == 0


@pytest.mark.parametrize("policy,tol", [("f32", 1e-4), ("bf16", 2e-2)])
def test_v1_sharded_precision(x64, worlds, policy, tol):
    """The f32 and bf16 policies over 8 shards (check_fused_cg_sharded_
    precision's configuration).  The reference fails its own check of it
    (ROADMAP.md queue 3), so the port is held to the fp64 reference: x no
    further from the fp64 x than tol of max|x| or twice the port's
    single-device run at the policy is, the first entry to tol of h0, a
    finite history with a net decrease, and the x dtype kept.  (Later
    entries of a storage-rounded CG part from fp64's by up to 0.3 h0 at
    entry 5 on this case, sharded or not.)"""
    got = load(worlds(8), f"v1@{policy}")
    assert got["x_dtype"] == str({"f32": torch.float32,
                                  "bf16": torch.bfloat16}[policy])
    h = got["hist"].astype(np.float64)
    assert np.isfinite(h).all() and h[-1] < h[0]
    ref = _jax_v1("f64", 20)
    h_ref = np.asarray(ref.rnorm_history, np.float64)
    x_ref = np.asarray(ref.x, np.float64)
    own = float(np.abs(got["x_one"] - x_ref).max())
    assert float(np.abs(got["x"] - x_ref).max()) <= \
        max(tol * float(np.abs(x_ref).max()), 2.0 * own)
    assert abs(h[0] - h_ref[0]) < tol * h_ref[0]


# ---------------------------------------------------------------------------
# K5 and K10 with edge planes, plain versions, in-process
# ---------------------------------------------------------------------------

def _update_operands(n, grid, mix, seed):
    from repro_torch.kernels import nekbone_ax as K
    from repro_torch.kernels import ops

    roles = K.MIXES[mix]
    ex, ey, ez = grid
    E = ex * ey * ez
    rng = np.random.default_rng(seed)

    def field(role, shape=(E, n ** 3)):
        return torch.as_tensor(rng.normal(size=shape)).to(roles[role])

    _, (cx, cy, cz) = ops.slab_axis_factors(grid, n, roles["S"], "cpu")
    invd = torch.as_tensor(rng.uniform(0.5, 2.0, size=(E, n ** 3))) \
        .to(roles["O"])
    return dict(x2=field("X"), p2=field("S"), r2=field("S"), w2=field("S"),
                alpha=torch.tensor([0.37], dtype=roles["A"]), cx=cx, cy=cy,
                cz=cz, invd2=invd)


def _split(op, grid, n, lo_layers):
    """The two shards' operands (cut at element layer ``lo_layers``) and
    their edge planes in the accumulation dtype."""
    from repro_torch.core.gs import edge_planes
    from repro_torch.kernels.ref import accum_dtype

    ex, ey, ez = grid
    cut = lo_layers * ex * ey
    acc = accum_dtype(op["x2"].dtype)
    parts = []
    for lo, hi, zlo, zhi in ((0, cut, 0, lo_layers),
                             (cut, None, lo_layers, ez)):
        q = {k: (v[lo:hi] if k in ("x2", "p2", "r2", "w2", "invd2") else v)
             for k, v in op.items()}
        q["cz"] = op["cz"][zlo:zhi]
        parts.append(q)
    grids = [(ex, ey, lo_layers), (ex, ey, ez - lo_layers)]
    planes = [edge_planes(q["w2"], g, acc) for q, g in zip(parts, grids)]
    # shard 0 takes shard 1's bottom plane from above; shard 1 takes
    # shard 0's top plane from below
    return parts, (None, planes[1][0]), (planes[0][1], None)


@pytest.mark.parametrize("mix", ["f64", "f32", "bf16", "bf16_ir"])
@pytest.mark.parametrize("n,grid,lo", [(4, (2, 3, 4), 1), (3, (1, 2, 5), 3),
                                       (5, (3, 1, 2), 1)])
def test_k5_k10_planes_split_is_bitwise(mix, n, grid, lo):
    """The plain K5 and K10 on a 2-shard split, each shard with the other's
    edge plane, reassembled: bitwise the unsplit call in every build."""
    from repro_torch.kernels import ref

    op = _update_operands(n, grid, mix, seed=n)
    parts, (b0, a0), (b1, a1) = _split(op, grid, n, lo)
    whole5 = ref.nekbone_cg_update_plain(
        op["x2"], op["p2"], op["r2"], op["w2"], op["alpha"], op["cx"],
        op["cy"], op["cz"], n=n)
    whole10 = ref.nekbone_pcg_update_plain(
        op["x2"], op["p2"], op["r2"], op["w2"], op["alpha"], op["invd2"],
        op["cx"], op["cy"], op["cz"], n=n)
    got5, got10 = [], []
    for q, below, above in ((parts[0], None, a0), (parts[1], b1, None)):
        got5.append(ref.nekbone_cg_update_plain(
            q["x2"], q["p2"], q["r2"], q["w2"], q["alpha"], q["cx"],
            q["cy"], q["cz"], n=n, from_below=below, from_above=above))
        got10.append(ref.nekbone_pcg_update_plain(
            q["x2"], q["p2"], q["r2"], q["w2"], q["alpha"], q["invd2"],
            q["cx"], q["cy"], q["cz"], n=n, from_below=below,
            from_above=above))
    for whole, got in ((whole5, got5), (whole10, got10)):
        for i, w in enumerate(whole):
            cat = torch.cat([g[i] for g in got])
            assert cat.dtype == w.dtype
            assert torch.equal(cat, w), (mix, i)


def test_k5_k10_planes_change_the_edge_only():
    """A plane adds to the bottom layer's k = 0 face (below) and the top
    layer's k = n-1 face (above) and nowhere else."""
    from repro_torch.kernels import ref

    n, grid = 3, (2, 2, 2)
    op = _update_operands(n, grid, "f64", seed=1)
    base = ref.nekbone_cg_update_plain(
        op["x2"], op["p2"], op["r2"], op["w2"], op["alpha"], op["cx"],
        op["cy"], op["cz"], n=n)[1].reshape(2, 4, n, n, n)
    plane = torch.ones(4, n, n, dtype=torch.float64)
    for side, layer, k in (("from_below", 0, 0), ("from_above", 1, n - 1)):
        r = ref.nekbone_cg_update_plain(
            op["x2"], op["p2"], op["r2"], op["w2"], op["alpha"], op["cx"],
            op["cy"], op["cz"], n=n, **{side: plane})[1] \
            .reshape(2, 4, n, n, n)
        diff = (r != base)
        assert diff[layer, :, k].all()
        diff[layer, :, k] = False
        assert not diff.any()


def test_measure_collectives_counts_a_one_shard_solve():
    """measure_collectives on the one-shard mesh (no process group): an
    s-step solve of 2 cycles issues 2 exchanges, 2 Gram psums, the last
    update's psum and one all-gather."""
    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.distributed.sstep import cg_sstep_sharded_fixed_iters
    from repro_torch.obs.metrics import measure_collectives

    case = NekboneCase(n=3, grid=(1, 1, 4), dtype=torch.float64,
                       device="cpu")
    _, f = case.manufactured()
    counts = measure_collectives(
        cg_sstep_sharded_fixed_iters, f, D=case.D, g=case.g, grid=case.grid,
        niter=4, s=2, theta=2.25)
    assert counts == {"ppermute": 4, "psum": 3, "all_gather": 1}
