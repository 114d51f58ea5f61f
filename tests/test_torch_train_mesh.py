"""Port parity, training over a cut mesh: the train step under meshes that
cut the state (FSDP over ``data``, TP over ``model``), the sequence-sharded
attention and the expert-parallel MoE with their gradients, over
``torch.distributed`` with gloo on the CPU.

Worlds of 2 and 4 child processes run only the port (the harness of
``tests/test_torch_distributed_gs.py``: this file runs itself as the child,
a 60 s timeout on ``init_process_group`` and a 120 s timeout on the
children).  The parent runs the same steps in one process, and the
reference's ``make_train_step`` for one dense config.

* Reduced qwen2.5-14b (remat on), hymba-1.5b (5 heads, 1 KV head, a
  window of 16 over 64 tokens: the sequence-sharded attention's gathered
  and halo branches) and qwen3-moe-30b-a3b (8 experts) over (data 2, model
  1), (data 1, model 2) and (data 2, model 2), 2 steps on a global batch of
  4: the loss and grad norm within ``LOSS_TOL`` 1e-5, every gradient leaf
  (gathered whole) within ``GRAD_TOL`` 1e-4 of its largest |g|, the first
  moments within 1e-4 of their largest value, and the parameters within
  1e-6 of their largest value plus 1e-2 lr where the first moment is more
  than 1e-3 of its leaf's largest, else within AdamW's step 2 lr (1 + wd
  |p|), at most 2% of the entries so (the form of
  ``tests/test_torch_train.py``'s ``test_train_step_matches_reference``,
  whose 1e-4 and 1e-3 lr hold one step: over two, a gradient 1e-4 of its
  leaf's largest carries the f32 sum orders' 1e-7 as 1e-3 of its update,
  and entries near that floor pass 1e-3 lr).
* The reduced qwen2.5-14b's step over (data 2, model 1), restored from the
  reference's state, against the reference's ``make_train_step`` on one
  CPU device, with that test's bars.
* Each collective's backward (``sharding.all_gather_ad``, ``psum_ad``,
  ``grad_psum``, ``halo_extend``, ``mean_over``, ``gather_leaf``) against
  central finite differences in fp64 of the objective it serves: summed
  over the ranks where the consumers are partial, counted once where they
  are replicated; within 1e-6 of the largest derivative.
* A cut state saved from (data 2, model 1) and restored onto (data 1,
  model 2): every leaf gathered whole bitwise the saved one, and the
  resumed step's loss within 1e-5 of one process's.
* ``launch.train.train`` of each family over (data 2, model 2) against
  ``train`` in one process: losses and gradient norms within 1e-5, first
  moments within 1e-4, parameters within two of AdamW's steps.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve()
sys.path.insert(0, str(HERE.parent))

from test_torch_distributed_gs import Worlds, child_main, load  # noqa: E402

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4          # each leaf, relative to its largest |g|
FD_TOL = 1e-6
ARCHS_UNDER_TEST = ("qwen2.5-14b", "hymba-1.5b", "qwen3-moe-30b-a3b")
MESHES = {"d2m1": (2, 1), "d1m2": (1, 2), "d2m2": (2, 2)}
BATCH, SEQ, STEPS = 4, 64, 2
STEP_KW = dict(peak_lr=1e-3, warmup=2, total_steps=20)
FD_CASES = ("gather_partial", "gather_replicated", "psum", "grad_psum",
            "halo", "mean", "leaf")


def _np(t):
    return t.detach().to("cpu").numpy()


def _cfg(arch):
    from repro_torch.configs import ARCHS

    cfg = ARCHS[arch].reduced()
    if arch == "hymba-1.5b":        # 5 heads: the sequence-sharded branch
        return dataclasses.replace(cfg, n_heads=5, n_kv_heads=1)
    if arch == "qwen2.5-14b":       # the gathers inside the remat groups
        return dataclasses.replace(cfg, remat=True)
    return cfg


def _tokens(cfg):
    return np.random.default_rng(4).integers(0, cfg.vocab,
                                             (BATCH, SEQ + 1))


def _whole(state, tree):
    """``tree`` ({name: tensor}, the state's layout) gathered whole."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model as M

    layout = M.cut_layout(state.params)
    if layout is None:
        return {k: _np(t).copy() for k, t in tree.items()}
    mesh, specs, _ = layout
    return {k: _np(SH.unshard(t.detach().contiguous(), specs[k],
                              mesh)).copy() for k, t in tree.items()}


def run_steps(cfg, mesh=None, state=None, steps=STEPS, tokens=None):
    """``steps`` train steps of ``cfg`` from seed 0 (or ``state``) on the
    global batch ``tokens``: per step the loss, grad norm and lr, and the
    gradients, parameters and moments gathered whole."""
    import torch

    from repro_torch.launch import steps as St

    tokens = torch.as_tensor(_tokens(cfg) if tokens is None else tokens)
    if state is None:
        state = St.make_train_state(torch.Generator().manual_seed(0), cfg,
                                    mesh=mesh)
    seen = {}
    real = St.adamw_update

    def capture(named, grads, *args, **kw):
        seen["g"] = {k: g.clone() for k, g in grads.items()}
        return real(named, grads, *args, **kw)

    step = St.make_train_step(cfg, **STEP_KW)
    out = {}
    St.adamw_update = capture
    try:
        for i in range(steps):
            state, m = step(state, {"tokens": tokens})
            for key in ("loss", "grad_norm", "lr"):
                out[f"{i}/{key}"] = np.array(float(m[key]))
            for tag, tree in (("g", seen["g"]), ("p", state.named()),
                              ("mu", state.mu), ("nu", state.nu)):
                for k, a in _whole(state, tree).items():
                    out[f"{i}/{tag}/{k}"] = a
    finally:
        St.adamw_update = real
    return state, out


# ---------------------------------------------------------------------------
# child checks: the port alone (no jax, no repro)
# ---------------------------------------------------------------------------

def _mesh(data, model):
    from repro_torch.launch.mesh import make_mesh_for

    return make_mesh_for(data * model, model_parallel=model)


def c_mesh_train(arch, data, model):
    """2 steps of the reduced ``arch`` under (data, model), cut; the
    collectives the steps issued."""
    from repro_torch.distributed import sharding as SH

    mesh = _mesh(data, model)
    with SH.use_mesh(mesh), SH.collective_log() as log:
        state, out = run_steps(_cfg(arch), mesh)
    out["counts"] = np.array(json.dumps([log.counts, log.bytes]))
    out["cut"] = np.array(sum(p.shape != s for p, s in zip(
        state.named().values(), state.params._cut[2].values())))
    return out


def c_ref_step(ckpt):
    """The reduced qwen2.5-14b (f32, no remat) under (data 2, model 1),
    its state restored cut from the whole state in ``ckpt``; one step."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ARCHS
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import steps as St

    cfg = ARCHS["qwen2.5-14b"].reduced()
    mesh = _mesh(2, 1)
    with SH.use_mesh(mesh):
        state = St.make_train_state(torch.Generator().manual_seed(1), cfg,
                                    mesh=mesh)
        _, tree = CheckpointManager(ckpt).restore(
            state.like(), shardings=state.shardings())
        state.load(tree)
        toks = np.load(pathlib.Path(ckpt) / "tokens.npy")
        _, out = run_steps(cfg, mesh, state=state, steps=1, tokens=toks)
    return out


def _fd(fwd, x, objective, *, shared=False, eps=1e-6):
    """(analytic, central-difference) derivatives of the global objective
    ``objective(fwd(x))`` with respect to this rank's ``x``, perturbing
    one rank at a time (every rank at once where ``x`` is ``shared``)."""
    import torch
    import torch.distributed as dist

    x = x.detach().requires_grad_(True)
    (analytic,) = torch.autograd.grad(fwd(x), x)
    numeric = torch.zeros_like(x)
    me = dist.get_rank()
    for r0 in [None] if shared else range(dist.get_world_size()):
        for i in range(x.numel()):
            vals = []
            for sign in (1.0, -1.0):
                xp = x.detach().clone()
                if shared or me == r0:
                    xp.view(-1)[i] += sign * eps
                with torch.no_grad():
                    vals.append(float(objective(fwd(xp))))
            if shared or me == r0:
                numeric.view(-1)[i] = (vals[0] - vals[1]) / (2 * eps)
    return _np(analytic), _np(numeric)


def c_fd(world):
    """Each collective's backward against finite differences (module
    docstring); ``leaf`` on (data 2, model 2) at a world of 4."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import sharding as SH

    torch.manual_seed(0)
    line = SH.solver_mesh()
    me = line.shard
    gen = torch.Generator().manual_seed(7)
    x_own = torch.randn(3, 4, 2, generator=gen, dtype=torch.float64)
    x_own = x_own + me                    # each rank its own values
    w_all = torch.randn(world, 3, 4 * world, 2, generator=gen,
                        dtype=torch.float64)
    w_same = w_all[0]

    def summed(f):
        return SH.psum(f.reshape(1), line)[0]

    def once(f):
        return f

    out = {}
    if world == 2:
        cases = {
            "gather_partial": (lambda x: (w_all[me] * SH.all_gather_ad(
                x, line, 1, partial=True)).sum(), x_own, summed, False),
            "gather_replicated": (lambda x: (w_same * SH.all_gather_ad(
                x, line, 1, partial=False)).sum(), x_own, once, False),
            "psum": (lambda x: (w_same[:, :4] * SH.psum_ad(x, line)).sum(),
                     x_own, once, False),
            "grad_psum": (lambda x: (w_all[me][:, :4] * torch.sin(
                SH.grad_psum(x, line))).sum(), x_own - me, summed, True),
            "halo": (lambda x: (w_all[me][:, :6] * torch.tanh(
                SH.halo_extend(x, 2, line) if not line.first else
                torch.cat([torch.zeros_like(x[:, :2]),
                           SH.halo_extend(x, 2, line)], 1))).sum(),
                     x_own, summed, False),
            "mean": (lambda x: w_same[0, 0, 0] * SH.mean_over(
                (x * x).sum(), [line]), x_own, once, False),
        }
    else:
        from repro_torch.launch.mesh import make_mesh_for

        mesh = make_mesh_for(4, model_parallel=2)
        data = SH.axis_mesh(mesh, "data")
        spec = SH.P("data", "model")
        whole = torch.randn(4, 6, generator=gen, dtype=torch.float64)
        w = torch.randn(2, 4, 6, generator=gen, dtype=torch.float64)
        cases = {"leaf": (
            lambda x: (w[data.shard] * torch.sin(SH.gather_leaf(
                x, spec, mesh, ("data",)))).sum(),
            SH.shard_block(whole, spec, mesh).clone(),
            lambda f: SH.psum(f.reshape(1), data)[0], False)}
    for name, (fwd, x, objective, shared) in cases.items():
        a, n = _fd(fwd, x, objective, shared=shared)
        out[f"{name}/analytic"], out[f"{name}/numeric"] = a, n
    dist.barrier()
    return out


def c_ckpt_cross(ckpt_dir, other_dir):
    """The trainer under (data 2, model 1) to step 2, saving; the saved
    state restored onto (data 1, model 2) and one more step there."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.train import train

    cfg = _cfg("qwen2.5-14b")
    kw = dict(batch=BATCH, seq=SEQ, seed=3, ckpt_every=2, device="cpu")
    with SH.use_mesh(_mesh(2, 1)):
        saved, first = train(cfg, steps=2, ckpt_dir=ckpt_dir, **kw)
        saved_whole = _whole(saved, saved.named())
    if dist.get_rank() == 0:
        shutil.copytree(ckpt_dir, other_dir)
    dist.barrier()
    with SH.use_mesh(_mesh(1, 2)):
        back, none = train(cfg, steps=2, ckpt_dir=other_dir, **kw)
        back_whole = _whole(back, back.named())
        _, more = train(cfg, steps=3, ckpt_dir=other_dir, **kw)
    same = all(np.array_equal(saved_whole[k].view(np.uint8),
                              back_whole[k].view(np.uint8))
               for k in saved_whole)
    return {"first": np.array(first), "none": np.array(len(none)),
            "more": np.array(more), "same": np.array(same),
            "cut_back": np.array(sum(p.shape != s for p, s in zip(
                back.named().values(), back.params._cut[2].values())))}


TRAINER = dict(steps=2, batch=BATCH, seq=SEQ, seed=3, peak_lr=1e-3,
               device="cpu")


def c_trainer(arch):
    """``launch.train.train`` of the reduced ``arch`` under (data 2, model
    2): its history, and its parameters and first moments gathered
    whole."""
    from repro_torch.distributed import sharding as SH

    history = []
    with SH.use_mesh(_mesh(2, 2)):
        from repro_torch.launch.train import train

        state, _ = train(_cfg(arch), history=history, **TRAINER)
        out = {f"p/{k}": a for k, a in _whole(state, state.named()).items()}
        out.update({f"mu/{k}": a for k, a in _whole(state,
                                                    state.mu).items()})
    out["history"] = np.array([[h["loss"], h["grad_norm"], h["lr"]]
                               for h in history])
    return out


CHILD_CHECKS = {"mesh_train": c_mesh_train, "ref_step": c_ref_step,
                "fd": c_fd, "ckpt_cross": c_ckpt_cross, "trainer": c_trainer}


def world_checks(dirs: dict) -> dict:
    checks = {2: [], 4: []}
    for arch in ARCHS_UNDER_TEST:
        for tag, (data, model) in MESHES.items():
            checks[data * model].append(
                [f"mesh_train@{arch}-{tag}",
                 dict(arch=arch, data=data, model=model)])
    checks[2] += [["ref_step", dict(ckpt=dirs["ref"])],
                  ["fd@2", dict(world=2)],
                  ["ckpt_cross", dict(ckpt_dir=dirs["cross"],
                                      other_dir=dirs["other"])]]
    checks[4] += [["fd@4", dict(world=4)]]
    checks[4] += [[f"trainer@{arch}", dict(arch=arch)]
                  for arch in ARCHS_UNDER_TEST]
    return checks


if __name__ == "__main__":
    sys.exit(child_main(sys.argv[1:], CHILD_CHECKS))


# ---------------------------------------------------------------------------
# the parent: one process, the reference, and the comparisons
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.launch import steps as JSt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.data import SyntheticLMStream  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import steps as St  # noqa: E402
from repro_torch.models import model as M  # noqa: E402


def _ref_tree(js):
    return jax.tree.map(np.asarray, js)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The reference's initial qwen2.5-14b state, carried into the port
    and saved whole, with the batch of its step; the crossing
    checkpoints' directories."""
    root = tmp_path_factory.mktemp("train_mesh")
    jcfg = JARCHS["qwen2.5-14b"].reduced()
    js = JSt.make_train_state(jax.random.PRNGKey(0), jcfg)
    cfg = ARCHS["qwen2.5-14b"].reduced()
    state = convert.train_state_from_reference(
        cfg, _ref_tree(js.params), _ref_tree(js.mu), _ref_tree(js.nu),
        js.step, device="cpu")
    ref = root / "ref"
    CheckpointManager(ref).save(0, state.tree())
    np.save(ref / "tokens.npy", SyntheticLMStream(cfg.vocab, seed=0).batch(
        0, BATCH, 16))
    return {"ref": str(ref), "cross": str(root / "cross"),
            "other": str(root / "other"), "js": js, "jcfg": jcfg}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, dirs):
    return Worlds(HERE, world_checks(dirs), tmp_path_factory)


_ONE: dict = {}


def _one(arch):
    """The steps in one process, once per arch."""
    if arch not in _ONE:
        _ONE[arch] = run_steps(_cfg(arch))[1]
    return _ONE[arch]


def _rel(got, want):
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else float(
        np.abs(got).max())


def _check_params(got, want, p0, mu, mu_got, lr, *, floor=1e-4,
                  frac=1e-3, ill_share=0.01):
    """The parameters after a step: within 1e-6 of their largest value
    plus ``frac`` lr where the first moment is more than ``floor`` of its
    leaf's largest (clear of round-off) or 0 on both sides; else within
    AdamW's step; at most ``ill_share`` of the entries so."""
    ill = total = 0
    for k, w in want.items():
        err = np.abs(got[k] - w)
        sure = (np.abs(mu[k]) > floor * np.abs(mu[k]).max()) | (
            (mu[k] == 0) & (mu_got[k] == 0))
        assert (err[sure] <= 1e-6 * np.abs(w).max() + frac * lr).all(), k
        step = 2 * lr * (1 + 0.1 * np.abs(p0[k]))
        assert (err <= step + 1e-6 * np.abs(w).max()).all(), k
        ill += int((~sure).sum())
        total += sure.size
    assert ill <= ill_share * total, (ill, total)


def _tree(out, step, tag):
    pre = f"{step}/{tag}/"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS_UNDER_TEST)
def test_mesh_train_matches_one_process(worlds, arch, tag):
    """Every rank's loss, grad norm, gathered gradients, moments and
    parameters after each of 2 steps against one process's on the same
    global batch (module docstring's bars)."""
    data, model = MESHES[tag]
    want = _one(arch)
    init = St.make_train_state(torch.Generator().manual_seed(0), _cfg(arch))
    p0 = {k: _np(p) for k, p in init.named().items()}
    for r in range(data * model):
        got = load(worlds(data * model), f"mesh_train@{arch}-{tag}", r)
        assert int(got["cut"]) > 0
        prev = p0
        for i in range(STEPS):
            for key in ("loss", "grad_norm"):
                g, w = float(got[f"{i}/{key}"]), float(want[f"{i}/{key}"])
                assert abs(g - w) <= LOSS_TOL * abs(w), (r, i, key)
            for k, w in _tree(want, i, "g").items():
                g = got[f"{i}/g/{k}"]
                assert g.shape == w.shape
                assert np.abs(g - w).max() <= GRAD_TOL * max(
                    np.abs(w).max(), 1e-30), (r, i, k)
            mu, mu_got = _tree(want, i, "mu"), _tree(got, i, "mu")
            for k, w in mu.items():
                assert _rel(mu_got[k], w) <= 1e-4, (r, i, k)
            _check_params(_tree(got, i, "p"), _tree(want, i, "p"), prev, mu,
                          mu_got, float(want[f"{i}/lr"]), floor=1e-3,
                          frac=1e-2, ill_share=0.02)
            prev = _tree(want, i, "p")


@pytest.mark.parametrize("arch", ARCHS_UNDER_TEST)
def test_mesh_train_collectives(worlds, arch):
    """The cut meshes issue what their layouts need: FSDP gathers and
    reduce-scatters over data; the model axis's branches their own."""
    for tag, (data, model) in MESHES.items():
        got = load(worlds(data * model), f"mesh_train@{arch}-{tag}")
        counts, nbytes = json.loads(str(got["counts"]))
        assert counts.get("all_gather", 0) > 0, tag
        if data > 1:
            assert counts.get("reduce_scatter", 0) > 0, tag
        if arch == "hymba-1.5b" and model > 1:
            assert counts.get("ppermute", 0) > 0, tag      # the halo
        if arch == "qwen3-moe-30b-a3b" and model > 1:
            assert counts.get("psum", 0) > 0, tag          # the experts
        assert all(nbytes[k] > 0 for k in counts)


def test_mesh_train_step_matches_reference(worlds, dirs):
    """The reduced qwen2.5-14b's step over (data 2, model 1), from the
    reference's state, against the reference's make_train_step on one
    CPU device: loss and grad norm within 1e-5, the moments within 1e-4
    (mu) and 2e-4 (nu) of their largest value, the parameters as in
    ``tests/test_torch_train.py``."""
    jcfg, js = dirs["jcfg"], dirs["js"]
    cfg = ARCHS["qwen2.5-14b"].reduced()
    toks = np.load(pathlib.Path(dirs["ref"]) / "tokens.npy")
    js1, jm = jax.jit(JSt.make_train_step(jcfg, **STEP_KW))(
        js, {"tokens": jnp.asarray(toks)})
    want_p = dict(convert.lm_named_arrays(cfg, _ref_tree(js1.params)))
    mu = dict(convert.lm_named_arrays(cfg, _ref_tree(js1.mu)))
    nu = dict(convert.lm_named_arrays(cfg, _ref_tree(js1.nu)))
    p0 = dict(convert.lm_named_arrays(cfg, _ref_tree(js.params)))
    for r in range(2):
        got = load(worlds(2), "ref_step", r)
        for key in ("loss", "grad_norm"):
            assert abs(float(got[f"0/{key}"]) - float(jm[key])) <= \
                LOSS_TOL * abs(float(jm[key])), (r, key)
        mu_got = _tree(got, 0, "mu")
        for k in mu:
            assert _rel(mu_got[k], mu[k]) <= 1e-4, k
            assert _rel(got[f"0/nu/{k}"], nu[k]) <= 2e-4, k
        _check_params(_tree(got, 0, "p"), want_p, p0, mu, mu_got,
                      float(jm["lr"]))


@pytest.mark.parametrize("case", FD_CASES)
def test_collective_backward_matches_finite_differences(worlds, case):
    """Each collective's backward against central differences of the
    objective it serves, on every rank (module docstring)."""
    world = 4 if case == "leaf" else 2
    for r in range(world):
        got = load(worlds(world), f"fd@{world}", r)
        a, n = got[f"{case}/analytic"], got[f"{case}/numeric"]
        assert np.abs(n).max() > 0
        assert np.abs(a - n).max() <= FD_TOL * np.abs(n).max() + 1e-9, (
            case, r, np.abs(a - n).max())


def test_cut_state_restores_onto_another_mesh(worlds):
    """A state saved cut over (data 2, model 1) restores onto (data 1,
    model 2) with every leaf bitwise the saved one, and its next step's
    loss is one process's, within 1e-5."""
    cfg = _cfg("qwen2.5-14b")
    from repro_torch.launch.train import train

    _, losses = train(cfg, steps=3, batch=BATCH, seq=SEQ, seed=3,
                      device="cpu")
    for r in range(2):
        got = load(worlds(2), "ckpt_cross", r)
        assert bool(got["same"]) and int(got["cut_back"]) > 0
        assert int(got["none"]) == 0 and len(got["more"]) == 1
        assert np.abs(got["first"] - losses[:2]).max() <= LOSS_TOL * max(
            losses)
        assert abs(float(got["more"][0]) - losses[2]) <= LOSS_TOL * losses[2]


@pytest.mark.parametrize("arch", ARCHS_UNDER_TEST)
def test_trainer_over_a_cut_mesh_matches_one_process(worlds, arch):
    """``launch.train.train`` over (data 2, model 2), the state cut, against
    ``train`` in one process: every rank's losses and gradient norms within
    1e-5, the first moments within 1e-4 of their largest value, and the
    parameters after 2 steps within two of AdamW's steps, 2 lr (1 + wd
    |p0|) each."""
    from repro_torch.launch.train import train

    history = []
    state, _ = train(_cfg(arch), history=history, **TRAINER)
    p0 = {k: _np(p) for k, p in St.make_train_state(
        torch.Generator().manual_seed(3), _cfg(arch)).named().items()}
    lr = max(h["lr"] for h in history)
    for r in range(4):
        got = load(worlds(4), f"trainer@{arch}", r)
        want = np.array([[h["loss"], h["grad_norm"], h["lr"]]
                         for h in history])
        assert np.all(np.abs(got["history"] - want) <= LOSS_TOL * np.abs(
            want)), (r, got["history"], want)
        for k, p in state.named().items():
            w = _np(p)
            bound = 2 * 2 * lr * (1 + 0.1 * np.abs(p0[k])) + 1e-6 * np.abs(
                w).max()
            assert (np.abs(got[f"p/{k}"] - w) <= bound).all(), (r, k)
            assert _rel(got[f"mu/{k}"], _np(state.mu[k])) <= 1e-4, (r, k)


def test_loss_in_chunks_matches_the_whole(monkeypatch):
    """Past ``LOSS_CHUNK_BYTES`` the loss is made a chunk of tokens at a
    time under checkpoint: the same loss and gradients as the whole
    logits' (another summation order), within 1e-6."""
    cfg = _cfg("qwen2.5-14b")
    model = M.init_params(torch.Generator().manual_seed(0), cfg)
    model.requires_grad_(True)
    tokens = torch.as_tensor(_tokens(cfg)[:, :33])
    named = dict(model.named_parameters())

    def run():
        loss = M.loss_fn(model, cfg, {"tokens": tokens})
        return loss, torch.autograd.grad(loss, list(named.values()))

    whole, g_whole = run()
    monkeypatch.setattr(M, "LOSS_CHUNK_BYTES", cfg.vocab * 4 * 4 * 20)
    chunked, g_chunked = run()             # 20 tokens a chunk: 7 chunks
    chunked, whole = float(chunked.detach()), float(whole.detach())
    assert abs(chunked - whole) <= 1e-6 * abs(whole)
    for k, a, b in zip(named, g_chunked, g_whole):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max().clamp_min(1e-30), k


@dataclasses.dataclass(frozen=True)
class _PlacedMesh(SH.AbstractMesh):
    coordinate: tuple = ()

    def get_coordinate(self):
        return list(self.coordinate)


@pytest.mark.parametrize("arch", ARCHS_UNDER_TEST)
def test_hold_cut_holds_train_spec_blocks(arch):
    """``hold_cut`` holds each leaf as its block of the train
    ``param_specs`` (a numpy reckoning of the block's shape), gathers the
    axes ``run_specs`` does not keep, and keeps the whole shapes."""
    cfg = _cfg(arch)
    mesh = _PlacedMesh(("data", "model"), (2, 2), (1, 0))
    model = M.init_params(torch.Generator().manual_seed(0), cfg)
    whole = {k: tuple(p.shape) for k, p in model.named_parameters()}
    specs = M.param_specs(cfg, model, mesh)
    use = M.run_specs(cfg, model, mesh)
    held = M.hold_cut(model, cfg, mesh)
    assert held == specs and M.cut_layout(model)[2] == whole
    sizes = {"data": 2, "model": 2}
    for k, p in model.named_parameters():
        want = list(whole[k])
        for d, entry in enumerate(specs[k]):
            for a in (entry,) if isinstance(entry, str) else entry or ():
                want[d] //= sizes.get(a, 1)
        assert tuple(p.shape) == tuple(want), k
        parts = k.split(".")
        if parts[0] in ("layers", "enc_layers"):
            mod, rel = model.get_submodule(".".join(parts[:2])), \
                ".".join(parts[2:])
        else:
            mod, rel = model, k
        gather = {} if mod._gather is None else mod._gather[1]
        cut = any(e is not None and u is None
                  for e, u in zip(specs[k], use[k])
                  if SH._cuts(SH.P(e), mesh))
        assert (rel in gather) == cut, k
