"""Port parity, the LM's last distributed parts: the collective matmul, the
GPipe pipeline, the compressed gradient all-reduce, the restore onto
another mesh, the gradient pin and the trainer's restart, over
``torch.distributed`` with gloo on the CPU, against the JAX reference.

Worlds of 2 and 4 child processes run only the port (the harness of
``tests/test_torch_distributed_gs.py``: this file runs itself as the child,
a 60 s timeout on ``init_process_group`` and a 120 s timeout on the
children).  The parent computes the reference in-process: the collective
matmul and the compressions under ``jax.vmap(..., axis_name=...)``, whose
collectives run in one process.  The reference's ``pipeline_apply`` does
not run under vmap (its permutation ``[(i, i + 1)]`` is not a full one),
so one more child process runs it under ``shard_map`` on 4 fake host
devices (``XLA_FLAGS``, as ``tests/distributed_checks.py`` does):

    python tests/test_torch_lm_parallel.py --jax-pipeline <out.npz>

and writes its outputs with numpy.  Checkpoints cross between the packages
through the reference's own ``CheckpointManager``; a preemption save in a
world of 2 writes from rank 0 alone.

Bars: the collective matmul in f32 within 1e-6 of max |y| of the reference;
in fp64 within 1e-12 of max |y| of the f64 product of the gathered x, and
within the f32 bar of the reference, which accumulates in f32 even under
x64 (``preferred_element_type``); ``compressed_psum`` and
``quantized_psum`` without noise within one f32 ulp of max |sum| of the
reference, with noise within the reference's 5e-2 of max |sum| and a mean
error over 64 draws within 3 standard errors of 0; the pipeline within
1e-12 (fp64) and 1e-5 (f32) of max |y|; checkpoints bitwise; the pinned
train step and the resumed trainer bitwise.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve()
sys.path.insert(0, str(HERE.parent))

from test_torch_distributed_gs import (CHILD_TIMEOUT_S, SRC,  # noqa: E402
                                       Worlds, child_main, load)

# collective matmul: rows a shard, inner and output widths (N divides 4)
CMM_M, CMM_K, CMM_N = 4, 32, 24
# the reference check's pipeline: layers, microbatches, rows, width
PIPE_L, PIPE_M, PIPE_MB, PIPE_D = 4, 6, 3, 16
PIPE_STAGES = (2, 4)
DTYPES = ("float64", "float32")
# the reduced qwen2.5-14b's layers in the pipeline: microbatches of
# (batch, tokens)
QWEN_M, QWEN_B, QWEN_S = 3, 2, 16
DRAWS = 64
TRAIN = dict(batch=2, seq=16, ckpt_every=2, seed=3)


def _np(t):
    return t.detach().to("cpu").numpy()


def _counts(log) -> np.ndarray:
    return np.array(json.dumps([log.counts, log.bytes]))


def _cmm_inputs(P, dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(P * CMM_M, CMM_K)).astype(dtype)
    w = rng.normal(size=(CMM_K, CMM_N)).astype(dtype)
    return x, w


def _comp_inputs(P):
    return np.random.default_rng(2).normal(size=(P, 8, 64)).astype(
        np.float32)


def _pipe_inputs(dtype):
    """The reference check's weights and microbatches (seed 7)."""
    rng = np.random.default_rng(7)
    Ws = rng.normal(size=(PIPE_L, PIPE_D, PIPE_D)) * 0.3
    x = rng.normal(size=(PIPE_M, PIPE_MB, PIPE_D))
    return Ws.astype(dtype), x.astype(dtype)


def _qwen_cfg(n_layers=None):
    from repro_torch.configs import ARCHS

    cfg = ARCHS["qwen2.5-14b"].reduced()
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


def _qwen_layers(cfg, ids):
    """Layers ``ids`` of the reduced qwen2.5-14b, layer i from seed i."""
    import torch

    from repro_torch.models import model as M

    return torch.nn.ModuleList(M.Layer(torch.Generator().manual_seed(i), cfg)
                               for i in ids)


def _qwen_micro(cfg):
    return np.random.default_rng(3).normal(
        size=(QWEN_M, QWEN_B, QWEN_S, cfg.d_model)).astype(np.float32)


def _run_stack(cfg):
    from repro_torch.models import model as M

    return lambda layers, x: M._run_stack(x, layers, cfg,
                                          positions=M._positions(x))


def _grad_tree(rank):
    """The reduced qwen2.5-14b's gradients (seed 0's weights) on one
    sequence of rank ``rank``'s tokens."""
    import torch

    from repro_torch.models import model as M

    cfg = _qwen_cfg()
    model = M.init_params(torch.Generator().manual_seed(0), cfg)
    model.requires_grad_(True)
    tokens = torch.as_tensor(np.random.default_rng(20 + rank).integers(
        0, cfg.vocab, (1, 17)))
    named = dict(model.named_parameters())
    loss = M.loss_fn(model, cfg, {"tokens": tokens})
    return dict(zip(named, torch.autograd.grad(loss, list(named.values()))))


def _ckpt_tree():
    """The crossing checkpoint's tree, as numpy."""
    rng = np.random.default_rng(9)
    return {"w": rng.normal(size=(8, 6)).astype(np.float32),
            "b": rng.normal(size=(6,)).astype(np.float32),
            "e": {"k": rng.integers(-50, 50, (4, 8)).astype(np.int32)}}


def _ckpt_specs():
    """Each leaf's spec over (data 1, model 2), as a nested dict."""
    from repro_torch.distributed.sharding import P

    return {"w": P(None, "model"), "b": P("model"), "e": {"k": P("model")}}


def _map(f, *trees):
    return {k: (_map(f, *(t[k] for t in trees)) if isinstance(v, dict)
                else f(*(t[k] for t in trees)))
            for k, v in trees[0].items()}


# ---------------------------------------------------------------------------
# child checks: the port alone (no jax, no repro)
# ---------------------------------------------------------------------------

def c_cmm(world, model_parallel):
    """The collective matmul over the model axis, w replicated and cut by
    columns, fp64 and f32."""
    import torch

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.overlap import collective_matmul_allgather
    from repro_torch.launch.mesh import make_mesh_for

    line = SH.axis_mesh(make_mesh_for(world, model_parallel=model_parallel),
                        "model")
    P, i = line.ndev, line.shard
    out = {"shard": np.array(i)}
    for dt in DTYPES:
        x, w = _cmm_inputs(P, dt)
        x_l = torch.as_tensor(x[i * CMM_M:(i + 1) * CMM_M])
        n = CMM_N // P
        for layout, w_l in (("rep", w), ("col", w[:, i * n:(i + 1) * n])):
            with SH.collective_log() as log:
                y = collective_matmul_allgather(x_l, torch.as_tensor(w_l),
                                                line)
            out[f"y_{layout}_{dt}"] = _np(y)
            out[f"counts_{layout}_{dt}"] = _counts(log)
    return out


def c_compress(world):
    """compressed_psum and quantized_psum over the world, and 64 noisy
    draws of quantized_psum; whether the global RNG was touched."""
    import torch

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.compression import (compressed_psum,
                                                     quantized_psum)

    mesh = SH.solver_mesh()
    x = torch.as_tensor(_comp_inputs(mesh.ndev)[mesh.shard])
    rng0 = torch.get_rng_state()
    with SH.collective_log() as log:
        bf16 = compressed_psum(x, mesh)
    with SH.collective_log() as qlog:
        int8 = quantized_psum(x, mesh)
    draws = [quantized_psum(x, mesh, generator=torch.Generator().manual_seed(
        1000 * d + mesh.shard)) for d in range(DRAWS)]
    return {"bf16": _np(bf16), "int8": _np(int8),
            "draws": _np(torch.stack(draws)), "counts": _counts(log),
            "qcounts": _counts(qlog),
            "rng_same": np.array(torch.equal(rng0, torch.get_rng_state()))}


def c_pipe_toy():
    """pipeline_apply over the world on the reference check's tanh layers,
    in fp64 and f32: every stage's buffer."""
    import torch

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.pipeline import pipeline_apply

    mesh = SH.solver_mesh()
    S, sid = mesh.ndev, mesh.shard
    per = PIPE_L // S

    def stage_fn(W, x):
        for i in range(W.shape[0]):
            x = torch.tanh(x @ W[i])
        return x

    out = {}
    for dt in DTYPES:
        Ws, x = _pipe_inputs(dt)
        with SH.collective_log() as log:
            y = pipeline_apply(torch.as_tensor(Ws[sid * per:(sid + 1) * per]),
                               torch.as_tensor(x), stage_fn, mesh)
        out[f"out_{dt}"] = _np(y)
        out[f"counts_{dt}"] = _counts(log)
    return out


def c_pipe_qwen():
    """pipeline_apply over the world on the reduced qwen2.5-14b's four
    layers, each stage running models.model._run_stack on its slice."""
    import torch

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.pipeline import pipeline_apply

    mesh = SH.solver_mesh()
    cfg = _qwen_cfg(4)
    per = 4 // mesh.ndev
    layers = _qwen_layers(cfg, range(mesh.shard * per,
                                     (mesh.shard + 1) * per))
    with torch.no_grad():
        y = pipeline_apply(layers, torch.as_tensor(_qwen_micro(cfg)),
                           _run_stack(cfg), mesh)
    return {"out": _np(y)}


def c_psum_tree():
    """psum_tree of this rank's reduced qwen2.5-14b gradients with each
    wire format (int8 also with a generator); a format it lacks."""
    import torch

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.compression import psum_tree

    mesh = SH.solver_mesh()
    tree = _grad_tree(mesh.shard)
    out = {f"local/{k}": _np(g) for k, g in tree.items()}
    for c in ("none", "bf16", "int8"):
        for k, g in psum_tree(tree, mesh, compression=c).items():
            out[f"{c}/{k}"] = _np(g)
    gen = torch.Generator().manual_seed(5 + mesh.shard)
    for k, g in psum_tree(tree, mesh, compression="int8",
                          generator=gen).items():
        out[f"int8g/{k}"] = _np(g)
    try:
        psum_tree(tree, mesh, compression="fp8")
        raised = False
    except ValueError:
        raised = True
    out["raised"] = np.array(raised)
    return out


def c_restore_ref(ckpt_dir):
    """The reference's elastic check: arange(64).reshape(8, 8) saved from
    P("data", "model") on (data 2, model 2), restored onto a 1-D mesh of 4
    with P(None, "data"); and a dimension cut by two axes, unsharded."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh_for

    mesh = make_mesh_for(4, model_parallel=2)
    x = torch.arange(64.0).reshape(8, 8)
    spec = SH.P("data", "model")
    mgr = CheckpointManager(ckpt_dir)
    with SH.collective_log() as log:
        mgr.save(1, {"x": SH.shard_block(x, spec, mesh).clone()},
                 shardings={"x": SH.NamedSharding(mesh, spec)})
    mesh_b = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("data",))
    _, back = mgr.restore({"x": torch.zeros(8, 8)}, shardings={
        "x": SH.NamedSharding(mesh_b, SH.P(None, "data"))})
    y = torch.arange(32.0).reshape(16, 2)
    both = SH.P(("data", "model"), None)
    block = SH.shard_block(y, both, mesh)
    return {"back": _np(back["x"]), "coord": np.array(mesh.get_coordinate()),
            "block": _np(block), "whole": _np(SH.unshard(block, both, mesh)),
            "counts": _counts(log),
            "entries": np.array(sorted(p.name for p in
                                       pathlib.Path(ckpt_dir).iterdir()))}


def c_restore_cross(ref_dir, port_dir):
    """The reference's checkpoint restored onto (data 1, model 2) with
    shardings; the blocks saved back from the two ranks."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh_for

    mesh = make_mesh_for(2, model_parallel=2)
    shardings = _map(lambda s: SH.NamedSharding(mesh, s), _ckpt_specs())
    like = _map(lambda a: torch.zeros(a.shape, dtype=torch.as_tensor(a).dtype),
                _ckpt_tree())
    step, got = CheckpointManager(ref_dir).restore(like, shardings=shardings)
    CheckpointManager(port_dir).save(step + 1, got, shardings=shardings)
    return {"step": np.array(step), "w": _np(got["w"]), "b": _np(got["b"]),
            "k": _np(got["e"]["k"])}


def c_train(ckpt_dir):
    """The trainer under (data 2, model 1), its state cut over data: 4
    steps, then resumed to 6 from the step-4 checkpoint; 6 steps straight
    through under the same mesh; and 6 without a mesh."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.train import train

    cfg = _qwen_cfg()
    with SH.use_mesh(make_mesh_for(2, model_parallel=1)):
        _, first = train(cfg, steps=4, ckpt_dir=ckpt_dir, device="cpu",
                         **TRAIN)
        state, resumed = train(cfg, steps=6, ckpt_dir=ckpt_dir, device="cpu",
                               **TRAIN)
        base, meshed = train(cfg, steps=6, device="cpu", **TRAIN)
    _, straight = train(cfg, steps=6, device="cpu", **TRAIN)
    same = all(bool((a == b).all()) for a, b in
               zip(state.tree().values(), base.tree().values())
               if not isinstance(a, (int, dict)))
    cut = sum(p.shape != shp for p, shp in zip(
        state.named().values(), state.params._cut[2].values()))
    return {"first": np.array(first), "resumed": np.array(resumed),
            "meshed": np.array(meshed), "straight": np.array(straight),
            "same_params": np.array(same), "cut": np.array(cut),
            "entries": np.array(sorted(p.name for p in
                                       pathlib.Path(ckpt_dir).iterdir()))}


def c_preempt(ckpt_dir):
    """SIGTERM on both ranks of a world of 2, each holding its own state
    (rank r's values are r): the manager's handler saves and exits; then
    every rank reads the checkpoint back."""
    import os
    import signal

    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager

    rank = dist.get_rank()
    tree = {"w": torch.full((4, 3), float(rank)), "step": 5}
    mgr = CheckpointManager(ckpt_dir)
    wrote, gc = [], mgr._gc          # _gc ends each write
    mgr._gc = lambda: wrote.append(rank) or gc()
    previous = signal.getsignal(signal.SIGTERM)
    mgr.install_sigterm_handler(lambda: (5, tree), exit_code=7)
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        code = None
    except SystemExit as exc:
        code = exc.code
    finally:
        signal.signal(signal.SIGTERM, previous)
    dist.barrier()
    meta = json.loads((pathlib.Path(ckpt_dir) / "step_5" / "manifest.json")
                      .read_text())
    _, back = mgr.restore({"w": torch.zeros(4, 3), "step": 0})
    return {"code": np.array(-1 if code is None else code),
            "writes": np.array(len(wrote)),
            "w": _np(back["w"]), "preempted": np.array(
                meta["extra"].get("preempted", False)),
            "entries": np.array(sorted(p.name for p in
                                       pathlib.Path(ckpt_dir).iterdir()))}


CHILD_CHECKS = {"cmm": c_cmm, "compress": c_compress, "pipe_toy": c_pipe_toy,
                "pipe_qwen": c_pipe_qwen, "psum_tree": c_psum_tree,
                "restore_ref": c_restore_ref,
                "restore_cross": c_restore_cross, "train": c_train,
                "preempt": c_preempt}


def world_checks(dirs: dict) -> dict:
    return {
        2: [["cmm@2", dict(world=2, model_parallel=2)],
            ["compress@2", dict(world=2)],
            ["pipe_toy@2", {}],
            ["pipe_qwen@2", {}],
            ["psum_tree", {}],
            ["restore_cross", dict(ref_dir=dirs["ref"],
                                   port_dir=dirs["port"])],
            ["train", dict(ckpt_dir=dirs["train"])],
            ["preempt", dict(ckpt_dir=dirs["preempt"])]],
        4: [["cmm@4", dict(world=4, model_parallel=4)],
            ["cmm@4x2", dict(world=4, model_parallel=2)],
            ["compress@4", dict(world=4)],
            ["pipe_toy@4", {}],
            ["pipe_qwen@4", {}],
            ["restore_ref", dict(ckpt_dir=dirs["elastic"])]],
    }


def jax_pipeline_main(out: str) -> int:
    """The reference's pipeline_apply under shard_map on 4 fake host
    devices, for every stage count and dtype: every stage's buffer."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as JP

    from repro.compat import shard_map
    from repro.distributed.pipeline import pipeline_apply

    def stage_fn(W, x):
        for i in range(W.shape[0]):
            x = jnp.tanh(x @ W[i])
        return x

    res = {}
    for S in PIPE_STAGES:
        mesh = Mesh(np.array(jax.devices()[:S]), ("pod",))
        for dt in DTYPES:
            Ws, x = _pipe_inputs(dt)
            staged = jnp.asarray(Ws.reshape(S, PIPE_L // S, PIPE_D, PIPE_D))

            def body(ws_local, x_full):
                return pipeline_apply(ws_local[0], x_full, stage_fn,
                                      axis_name="pod")[None]

            got = jax.jit(shard_map(body, mesh=mesh,
                                    in_specs=(JP("pod"), JP()),
                                    out_specs=JP("pod"), check_vma=False))(
                staged, jnp.asarray(x))
            res[f"{S}_{dt}"] = np.asarray(got)
    np.savez(out, **res)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax-pipeline"]:
        sys.exit(jax_pipeline_main(sys.argv[2]))
    sys.exit(child_main(sys.argv[1:], CHILD_CHECKS))


# ---------------------------------------------------------------------------
# the parent: the reference in-process, and the comparisons
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import (  # noqa: E402
    CheckpointManager as JCheckpointManager)
from repro.distributed import compression as JC  # noqa: E402
from repro.distributed.overlap import (  # noqa: E402
    collective_matmul_allgather as jcmm)
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    compressed_psum, psum_tree, quantized_psum)
from repro_torch.distributed.overlap import (  # noqa: E402
    collective_matmul_allgather)
from repro_torch.distributed.pipeline import pipeline_apply  # noqa: E402
from repro_torch.launch import steps as St  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402

ONE = SH.SolverMesh(order=(0,), shard=0)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _ulp_ok(got, want):
    """Every element within one f32 ulp of max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    ulp = np.spacing(np.float32(np.abs(want).max()))
    return float(np.abs(got - want).max()) <= ulp


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.tobytes() == b.tobytes())


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The checkpoint directories of the worlds; the reference writes the
    crossing checkpoint first."""
    root = tmp_path_factory.mktemp("lm_parallel_ckpt")
    out = {k: str(root / k) for k in ("ref", "port", "train", "elastic",
                                      "preempt")}
    JCheckpointManager(out["ref"]).save(
        3, jax.tree.map(jnp.asarray, _ckpt_tree()), blocking=True)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, dirs):
    return Worlds(HERE, world_checks(dirs), tmp_path_factory)


@pytest.fixture(scope="module")
def jax_pipeline(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_pipeline") / "pipeline.npz"
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    env.pop("JAX_ENABLE_X64", None)
    proc = subprocess.run([sys.executable, str(HERE), "--jax-pipeline",
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=CHILD_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


# -- the collective matmul ----------------------------------------------------

CMM_CASES = {"cmm@1": (1, 1), "cmm@2": (2, 2), "cmm@4": (4, 4),
             "cmm@4x2": (4, 2)}


def _cmm_reference(P, dt, layout):
    """The reference's collective matmul under vmap: (P, P * CMM_M, n)."""
    x, w = _cmm_inputs(P, dt)
    xs = jnp.asarray(x.reshape(P, CMM_M, CMM_K))
    if layout == "rep":
        f = jax.vmap(lambda xb: jcmm(xb, jnp.asarray(w), "i"), axis_name="i")
        return np.asarray(f(xs))
    ws = jnp.asarray(w.reshape(CMM_K, P, CMM_N // P).transpose(1, 0, 2))
    f = jax.vmap(lambda xb, wb: jcmm(xb, wb, "i"), axis_name="i")
    return np.asarray(f(xs, ws))


def _cmm_port(case):
    """{rank: outputs} of the port: in-process at P = 1, else the world's."""
    world, mp = CMM_CASES[case]
    if world == 1:
        out = {"shard": np.array(0)}
        for dt in DTYPES:
            x, w = _cmm_inputs(1, dt)
            for layout in ("rep", "col"):
                with SH.collective_log() as log:
                    y = collective_matmul_allgather(
                        torch.as_tensor(x), torch.as_tensor(w), ONE)
                out[f"y_{layout}_{dt}"] = y.numpy()
                out[f"counts_{layout}_{dt}"] = _counts(log)
        return {0: out}
    return None


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["rep", "col"])
@pytest.mark.parametrize("case", list(CMM_CASES))
def test_collective_matmul_matches_reference(x64, worlds, case, layout,
                                             dtype):
    """Every rank's all_gather(x) @ w (its column block where w is cut by
    columns) against the reference's vmapped ring; fp64 also against the
    f64 product (the reference accumulates in f32)."""
    world, mp = CMM_CASES[case]
    outs = _cmm_port(case) or {r: load(worlds(world), case, r)
                               for r in range(world)}
    x, w = _cmm_inputs(mp, dtype)
    want = _cmm_reference(mp, dtype, layout)
    n = CMM_N // mp
    for r, got in outs.items():
        i = int(got["shard"])
        y = got[f"y_{layout}_{dtype}"]
        assert y.dtype == np.dtype(dtype)
        assert _rel(y, want[i]) <= 1e-6, (r, _rel(y, want[i]))
        if dtype == "float64":
            exact = x @ (w if layout == "rep" else w[:, i * n:(i + 1) * n])
            assert _rel(y, exact) <= 1e-12, (r, _rel(y, exact))


@pytest.mark.parametrize("case", list(CMM_CASES))
def test_collective_matmul_ring_collectives(worlds, case):
    """P - 1 ppermutes (the reference's last, discarded send is skipped),
    each moving a block out and a block in; nothing else."""
    world, mp = CMM_CASES[case]
    outs = _cmm_port(case) or {r: load(worlds(world), case, r)
                               for r in range(world)}
    for got in outs.values():
        for dt in DTYPES:
            counts, nbytes = json.loads(str(got[f"counts_rep_{dt}"]))
            block = CMM_M * CMM_K * np.dtype(dt).itemsize
            want = {} if mp == 1 else {"ppermute": mp - 1}
            assert counts == want
            assert nbytes == ({} if mp == 1 else
                              {"ppermute": 2 * block * (mp - 1)})


# -- compression --------------------------------------------------------------

def _comp_port(world):
    if world == 1:
        x = torch.as_tensor(_comp_inputs(1)[0])
        return {0: {"bf16": compressed_psum(x, ONE).numpy(),
                    "int8": quantized_psum(x, ONE).numpy()}}
    return None


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_compressed_psums_match_reference(worlds, world, kind):
    """compressed_psum (bf16 wire) and quantized_psum without noise, on
    every rank, within one f32 ulp of max |sum| of the reference under
    vmap; and within the reference check's bars of the exact sum."""
    x = _comp_inputs(world)
    fn = {"bf16": lambda a: JC.compressed_psum(a, "i"),
          "int8": lambda a: JC.quantized_psum(a, "i")}[kind]
    want = np.asarray(jax.vmap(fn, axis_name="i")(jnp.asarray(x)))
    outs = _comp_port(world) or {r: load(worlds(world), f"compress@{world}",
                                         r) for r in range(world)}
    exact = x.astype(np.float64).sum(0)
    for r, got in outs.items():
        assert _ulp_ok(got[kind], want[r]), (r, kind)
        assert _rel(got[kind], exact) < (2e-2 if kind == "bf16" else 5e-2)


@pytest.mark.parametrize("world", [2, 4])
def test_compression_wire_bytes(worlds, world):
    """bf16 gathers 2 bytes a value; int8 1 byte a value and a 4-byte scale
    a rank."""
    got = load(worlds(world), f"compress@{world}")
    n = 8 * 64
    assert json.loads(str(got["counts"])) == [{"all_gather": 1},
                                              {"all_gather": world * n * 2}]
    assert json.loads(str(got["qcounts"])) == [
        {"all_gather": 2}, {"all_gather": world * n + world * 4}]


@pytest.mark.parametrize("world", [2, 4])
def test_quantized_psum_stochastic_is_unbiased(worlds, world):
    """Stochastic int8 rounding: each draw within the reference's 5e-2 of
    max |sum|, finite; the mean error over 64 draws within 3 standard
    errors of 0; the ranks agree; the global RNG untouched."""
    exact = _comp_inputs(world).astype(np.float64).sum(0)
    outs = [load(worlds(world), f"compress@{world}", r) for r in range(world)]
    draws = outs[0]["draws"].astype(np.float64)
    assert np.isfinite(draws).all()
    for d in draws:
        assert _rel(d, exact) < 5e-2
    err = (draws - exact).reshape(DRAWS, -1).mean(axis=1)
    assert abs(err.mean()) <= 3 * err.std(ddof=1) / np.sqrt(DRAWS)
    for o in outs:
        assert _bitwise(o["draws"], outs[0]["draws"])
        assert bool(o["rng_same"])


# -- the pipeline -------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stages", PIPE_STAGES)
def test_pipeline_matches_reference(worlds, jax_pipeline, stages, dtype):
    """Every stage's (M, mb, d) buffer against the reference's under
    shard_map; the last stage's is the sequential application; one
    ppermute a tick."""
    want = jax_pipeline[f"{stages}_{dtype}"]
    Ws, x = _pipe_inputs(dtype)
    seq = []
    for m in range(PIPE_M):
        h = x[m].astype(np.float64)
        for W in Ws.astype(np.float64):
            h = np.tanh(h @ W)
        seq.append(h)
    tol = 1e-12 if dtype == "float64" else 1e-5
    out = worlds(stages)
    for r in range(stages):
        got = load(out, f"pipe_toy@{stages}", r)
        y = got[f"out_{dtype}"]
        assert y.dtype == np.dtype(dtype)
        assert _rel(y, want[r]) <= tol, r
        counts, _ = json.loads(str(got[f"counts_{dtype}"]))
        assert counts == {"ppermute": PIPE_M + stages - 1}
    assert _rel(load(out, f"pipe_toy@{stages}", stages - 1)[f"out_{dtype}"],
                np.stack(seq)) <= tol


@pytest.mark.parametrize("stages", PIPE_STAGES)
def test_pipeline_of_qwen_layers_matches_run_stack(worlds, stages):
    """The reduced qwen2.5-14b's four layers over 2 and 4 stages: the last
    stage's microbatches against models.model._run_stack over all four in
    one process."""
    cfg = _qwen_cfg(4)
    layers = _qwen_layers(cfg, range(4))
    x = torch.as_tensor(_qwen_micro(cfg))
    with torch.no_grad():
        want = torch.stack([_run_stack(cfg)(layers, x[m])
                            for m in range(QWEN_M)]).numpy()
    got = load(worlds(stages), f"pipe_qwen@{stages}", stages - 1)["out"]
    assert _rel(got, want) <= 1e-6


def test_pipeline_on_one_stage_is_the_stage():
    """A one-stage pipeline is stage_fn on every microbatch."""
    cfg = _qwen_cfg(2)
    layers = _qwen_layers(cfg, range(2))
    x = torch.as_tensor(_qwen_micro(cfg))
    with torch.no_grad(), SH.collective_log() as log:
        got = pipeline_apply(layers, x, _run_stack(cfg), ONE)
        want = torch.stack([_run_stack(cfg)(layers, x[m])
                            for m in range(QWEN_M)])
    assert torch.equal(got, want)
    assert log.counts == {"ppermute": QWEN_M}


# -- psum_tree ----------------------------------------------------------------

def _trees(out):
    ranks = [load(out, "psum_tree", r) for r in range(2)]
    names = [k.split("/", 1)[1] for k in ranks[0] if k.startswith("local/")]
    return ranks, names


@pytest.mark.parametrize("compression", ["none", "bf16", "int8"])
def test_psum_tree_matches_reference(worlds, compression):
    """The reduced qwen2.5-14b's gradient tree over 2 ranks, each leaf on
    each rank against the reference's psum_tree under vmap: none to 1e-6
    of max |sum|, bf16 and int8 to one f32 ulp."""
    ranks, names = _trees(worlds(2))
    stacked = {k: np.stack([o[f"local/{k}"] for o in ranks]) for k in names}
    want = jax.vmap(lambda t: JC.psum_tree(t, "i", compression=compression),
                    axis_name="i")(jax.tree.map(jnp.asarray, stacked))
    for r, o in enumerate(ranks):
        for k in names:
            got, ref = o[f"{compression}/{k}"], np.asarray(want[k][r])
            if not np.abs(ref).max():
                assert not np.abs(got).max()
            elif compression == "none":
                assert _rel(got, ref) <= 1e-6, k
            else:
                assert _ulp_ok(got, ref), (k, compression)


def test_psum_tree_int8_with_a_generator(worlds):
    """int8 with stochastic rounding: every leaf finite and within the
    reference's 5e-2 of max |sum| of the exact sum; a format the reference
    lacks raises ValueError."""
    ranks, names = _trees(worlds(2))
    for o in ranks:
        assert bool(o["raised"])
        for k in names:
            exact = sum(q[f"local/{k}"].astype(np.float64) for q in ranks)
            got = o[f"int8g/{k}"]
            assert np.isfinite(got).all()
            if np.abs(exact).max():
                assert _rel(got, exact) < 5e-2, k


def test_psum_tree_one_rank_and_unknown_format():
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones(4)}
    assert all(torch.equal(v, tree[k])
               for k, v in psum_tree(tree, ONE).items())
    with pytest.raises(ValueError):
        psum_tree(tree, ONE, compression="fp8")


# -- shard_block, unshard and the restore onto another mesh -------------------

@dataclasses.dataclass(frozen=True)
class _PlacedMesh(SH.AbstractMesh):
    """A mesh's axes and this process's coordinate (a DeviceMesh's
    ``get_coordinate``), with no process group."""

    coordinate: tuple = ()

    def get_coordinate(self):
        return list(self.coordinate)


@pytest.mark.parametrize("coord", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_shard_block_of_a_dimension_cut_by_two_axes(coord):
    """P(("data", "model")) on (data 2, model 2) keeps block
    data * 2 + model; unnamed and size-one axes cut nothing; the whole
    tensor comes back itself."""
    mesh = _PlacedMesh(("pod", "data", "model"), (1, 2, 2), (0, *coord))
    t = torch.arange(48.0).reshape(8, 6)
    i = coord[0] * 2 + coord[1]
    got = SH.shard_block(t, SH.P(("data", "model"), None), mesh)
    assert torch.equal(got, t[2 * i:2 * i + 2])
    assert SH.shard_block(t, SH.P("pod", ("expert",)), mesh) is t
    with pytest.raises(ValueError):
        SH.shard_block(t, SH.P(None, ("data", "model")), mesh)


def test_restore_reference_case_onto_another_mesh(worlds):
    """The reference's check: saved from P("data", "model") on a (2, 2)
    world, restored onto a 1-D mesh of 4 with P(None, "data"), bitwise;
    the checkpoint, read by the reference's manager, is the whole array;
    one writer; the blocks' two all-gathers."""
    out = worlds(4)
    x = np.arange(64.0).reshape(8, 8)
    y = np.arange(32.0).reshape(16, 2)
    for r in range(4):
        got = load(out, "restore_ref", r)
        assert _bitwise(got["back"], x[:, 2 * r:2 * r + 2].astype(np.float32))
        d, m = (int(c) for c in got["coord"])
        i = 2 * d + m
        assert _bitwise(got["block"], y[4 * i:4 * i + 4].astype(np.float32))
        assert _bitwise(got["whole"], y.astype(np.float32))
        assert list(got["entries"]) == ["step_1"]
        counts, _ = json.loads(str(got["counts"]))
        assert counts == {"all_gather": 2}
    ckpt = pathlib.Path(json.loads((out / "checks.json").read_text())[-1][1]
                        ["ckpt_dir"])
    _, back = JCheckpointManager(ckpt).restore({"x": jnp.zeros((8, 8))})
    assert _bitwise(np.asarray(back["x"]), x.astype(np.float32))


def test_reference_checkpoint_restores_onto_port_blocks(worlds):
    """A checkpoint the reference's manager wrote restores in the port onto
    (data 1, model 2), each rank's blocks bitwise."""
    tree = _ckpt_tree()
    for r in range(2):
        got = load(worlds(2), "restore_cross", r)
        assert int(got["step"]) == 3
        assert _bitwise(got["w"], tree["w"][:, 3 * r:3 * r + 3])
        assert _bitwise(got["b"], tree["b"][3 * r:3 * r + 3])
        assert _bitwise(got["k"], tree["e"]["k"][2 * r:2 * r + 2])


def test_port_sharded_save_restores_in_reference(worlds, dirs):
    """The blocks saved back from the two ranks, read by the reference's
    manager: the whole tree, bitwise, in one step directory."""
    worlds(2)
    like = jax.tree.map(jnp.asarray, _ckpt_tree())
    mgr = JCheckpointManager(dirs["port"])
    assert mgr.latest_step() == 4
    _, back = mgr.restore(like)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_ckpt_tree())):
        assert _bitwise(np.asarray(a), b)
    assert sorted(p.name for p in pathlib.Path(dirs["port"]).iterdir()) == [
        "step_4"]


def test_sharded_restore_and_save_in_one_process(tmp_path):
    """Without a process group the sharded save writes the whole tree and
    the restore keeps the placed rank's block, in the like's dtype."""
    mesh = _PlacedMesh(("data", "model"), (1, 2), (0, 1))
    mgr = CheckpointManager(tmp_path)
    tree = {"w": torch.arange(12.0).reshape(3, 4), "step": 5}
    mgr.save(5, tree, shardings={"w": SH.NamedSharding(mesh, SH.P())})
    like = {"w": torch.zeros(3, 4, dtype=torch.float64), "step": 0}
    step, got = mgr.restore(like, shardings={
        "w": SH.NamedSharding(mesh, SH.P(None, "model"))})
    assert step == 5 and got["step"] == 5
    assert got["w"].dtype == torch.float64 and got["w"].is_contiguous()
    assert torch.equal(got["w"], tree["w"][:, 2:].double())


# -- the gradient pin and the trainer -----------------------------------------

def _one_step(cfg, mesh):
    state = St.make_train_state(torch.Generator().manual_seed(0), cfg)
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 17)))
    step = St.make_train_step(cfg)
    if mesh is None:
        return step(state, {"tokens": tokens})[0]
    with SH.use_mesh(mesh):
        return step(state, {"tokens": tokens})[0]


def test_gradient_pin_is_bitwise(monkeypatch):
    """A train step under a mesh pins every gradient to its parameter's
    layout, the train ``param_specs`` (constrain, once a parameter), and
    gives the state of the step without one, bitwise."""
    from repro_torch.models import model as M

    cfg = _qwen_cfg()
    mesh = SH.AbstractMesh(("data", "model"), (2, 2))
    seen = []
    real = St.constrain
    monkeypatch.setattr(St, "constrain",
                        lambda g, s: seen.append(s) or real(g, s))
    pinned = _one_step(cfg, mesh)
    plain = _one_step(cfg, None)
    assert seen == list(M.param_specs(cfg, pinned.params, mesh).values())
    for a, b in zip(pinned.tree().items(), plain.tree().items()):
        if isinstance(a[1], dict):
            assert all(torch.equal(a[1][k], b[1][k]) for k in a[1])
        elif isinstance(a[1], torch.Tensor):
            assert torch.equal(a[1], b[1]), a[0]
    assert pinned.step == plain.step == 1


def test_trainer_resumes_under_a_mesh(worlds):
    """Two ranks train under (data 2, model 1), the state cut over data,
    checkpointing every 2 steps from rank 0 alone (the blocks gathered
    whole), and resume from step 4: the losses and the final state are
    bitwise those of 6 steps straight through under the mesh, and the
    losses within 1e-5 of those without a mesh."""
    for r in range(2):
        got = load(worlds(2), "train", r)
        assert len(got["first"]) == 4 and len(got["resumed"]) == 2
        losses = np.concatenate([got["first"], got["resumed"]])
        assert _bitwise(losses, got["meshed"])
        assert np.abs(losses - got["straight"]).max() <= 1e-5 * np.abs(
            got["straight"]).max()
        assert bool(got["same_params"]) and int(got["cut"]) > 0
        assert list(got["entries"]) == ["step_2", "step_4", "step_6"]


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "qwen3-moe-30b-a3b"])
def test_trainer_under_a_mesh_refuses_a_model_axis(arch):
    """A mesh of specs alone (no process group), here with a model axis of
    2, has no ranks to cut the state over or to sum the sharded branches'
    gradients over: the trainer refuses it before its first step."""
    from repro_torch.configs import ARCHS

    cfg = ARCHS[arch].reduced()
    with SH.use_mesh(_PlacedMesh(("data", "model"), (1, 2), (0, 0))):
        with pytest.raises(ValueError, match="process group"):
            train(cfg, steps=1, batch=2, seq=8, device="cpu")


def test_preemption_save_in_a_world_writes_from_rank_0(worlds):
    """SIGTERM on both ranks of a world of 2: the handler's save (no
    ``shardings``) writes from rank 0 alone, so the checkpoint holds rank
    0's state whole on every rank, marked preempted, in one step directory;
    each rank exits with the handler's code."""
    for r in range(2):
        got = load(worlds(2), "preempt", r)
        assert int(got["code"]) == 7
        assert int(got["writes"]) == (1 if r == 0 else 0)
        assert _bitwise(got["w"], np.zeros((4, 3), np.float32))
        assert bool(got["preempted"])
        assert list(got["entries"]) == ["step_5"]
