"""The training substrate of the port against the JAX package, on the CPU:
the schedules, AdamW, the data pipeline, the checkpoint manager and the
analytic cost model.

Inputs are numpy arrays from a seed.  Tolerances: the schedules relative
1e-6 (the reference computes in f32, the port in Python floats); one AdamW
step relative 1e-6 of each leaf's largest value in f32 (two f32 evaluation
orders of the same formula; bf16 moments within one bf16 step); data
batches and the cost model exact.
"""
import json
import os
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ShapeCell as JShapeCell
from repro.data import pipeline as JD
from repro.launch import analytic as JA
from repro.optim import adamw as JO
from repro.optim import schedule as JS
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS
from repro_torch.data import pipeline as D
from repro_torch.launch import analytic as A
from repro_torch.optim import adamw as O
from repro_torch.optim import schedule as S

SCHED_TOL = 1e-6
ADAMW_TOL = 1e-6
BF16_STEP = 2.0 ** -7      # one bf16 rounding of a value, relative


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 10, 100),
                                               (1e-3, 1, 100),
                                               (6e-4, 0, 50),
                                               (2e-4, 100, 110)])
def test_cosine_schedule_matches_reference(peak, warmup, total):
    for step in range(121):
        want = float(JS.cosine_schedule(jnp.asarray(step, jnp.int32),
                                        peak=peak, warmup_steps=warmup,
                                        total_steps=total))
        got = S.cosine_schedule(step, peak=peak, warmup_steps=warmup,
                                total_steps=total)
        assert isinstance(got, float)
        assert abs(got - want) <= SCHED_TOL * peak, (step, got, want)


def test_linear_warmup_matches_reference():
    for step in range(40):
        want = float(JS.linear_warmup(jnp.asarray(step), 16, 3e-4))
        assert abs(S.linear_warmup(step, 16, 3e-4) - want) <= SCHED_TOL * 3e-4


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def _adamw_inputs(seed, gscale):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": (13,), "c": (3, 4, 6), "d": ()}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = {k: (gscale * rng.standard_normal(s)).astype(np.float32)
             for k, s in shapes.items()}
    mu = {k: (0.01 * rng.standard_normal(s)).astype(np.float32)
          for k, s in shapes.items()}
    nu = {k: (1e-4 * rng.random(s)).astype(np.float32)
          for k, s in shapes.items()}
    return params, grads, mu, nu


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max(initial=0.0) <= tol * max(
        np.abs(want).max(initial=0.0), 1e-30)


@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
@pytest.mark.parametrize("gscale,clipped", [(1.0, True), (0.01, False)])
@pytest.mark.parametrize("step", [0, 7])
def test_adamw_update_matches_reference(moment, gscale, clipped, step):
    params, grads, mu, nu = _adamw_inputs(step, gscale)
    jdt = jnp.dtype(moment)
    tdt = getattr(torch, moment)
    jstate = JO.AdamWState(
        step=jnp.asarray(step, jnp.int32),
        mu={k: jnp.asarray(v).astype(jdt) for k, v in mu.items()},
        nu={k: jnp.asarray(v).astype(jdt) for k, v in nu.items()})
    jp, js, jm = JO.adamw_update(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in grads.items()}, jstate, lr=1e-3)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    state = O.AdamWState(step=step,
                         mu={k: torch.tensor(v).to(tdt)
                             for k, v in mu.items()},
                         nu={k: torch.tensor(v).to(tdt)
                             for k, v in nu.items()})
    tp2, ts, tm = O.adamw_update(tp, {k: torch.tensor(v)
                                      for k, v in grads.items()}, state,
                                 lr=1e-3)
    gnorm = float(jm["grad_norm"])
    assert (gnorm > 1.0) == clipped
    assert abs(float(tm["grad_norm"]) - gnorm) <= ADAMW_TOL * gnorm
    assert ts.step == int(js.step) == step + 1
    assert tp2 is tp                                    # in place
    mtol = ADAMW_TOL if moment == "float32" else BF16_STEP
    for k in params:
        assert tp[k].dtype == torch.float32
        assert _close(tp[k].numpy(), np.asarray(jp[k]), ADAMW_TOL), k
        assert ts.mu[k].dtype == ts.nu[k].dtype == tdt
        for got, want in ((ts.mu[k], js.mu[k]), (ts.nu[k], js.nu[k])):
            assert _close(got.float().numpy(),
                          np.asarray(want).astype(np.float32), mtol), k


def test_adamw_update_bf16_params_and_slices(monkeypatch):
    """bf16 parameters round their update once, as the reference casts
    back; a leaf updated a slice at a time gives the whole leaf's values."""
    params, grads, mu, nu = _adamw_inputs(3, 1.0)
    jp, _, _ = JO.adamw_update(
        {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in grads.items()},
        JO.adamw_init({k: jnp.asarray(v) for k, v in params.items()}),
        lr=1e-2)
    monkeypatch.setattr(O, "_SLICE", 4)
    tp = {k: torch.tensor(v).bfloat16() for k, v in params.items()}
    O.adamw_update(tp, {k: torch.tensor(v) for k, v in grads.items()},
                   O.adamw_init(tp), lr=1e-2)
    for k in params:
        assert tp[k].dtype == torch.bfloat16
        assert _close(tp[k].float().numpy(),
                      np.asarray(jp[k]).astype(np.float32), BF16_STEP), k


def test_adamw_init_and_global_norm():
    params, grads, _, _ = _adamw_inputs(1, 1.0)
    st = O.adamw_init({k: torch.tensor(v) for k, v in params.items()},
                      moment_dtype=torch.bfloat16)
    assert st.step == 0
    for k, v in params.items():
        assert st.mu[k].shape == v.shape and st.mu[k].dtype == torch.bfloat16
        assert not st.mu[k].any() and not st.nu[k].any()
    want = float(JO.global_norm({k: jnp.asarray(v) for k, v in grads.items()}))
    got = float(O.global_norm({k: torch.tensor(v) for k, v in grads.items()}))
    assert abs(got - want) <= ADAMW_TOL * want


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,step,shard,n_shards", [
    (0, 0, 0, 1), (0, 5, 0, 1), (3, 2, 1, 4), (11, 1000, 3, 4),
    (7, 17, 0, 2)])
def test_synthetic_batches_bitwise_reference(seed, step, shard, n_shards):
    for vocab in (512, 65536):
        want = JD.SyntheticLMStream(vocab=vocab, seed=seed).batch(
            step, 3, 40, shard, n_shards)
        got = D.SyntheticLMStream(vocab=vocab, seed=seed).batch(
            step, 3, 40, shard, n_shards)
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_memmap_reader_matches_reference(tmp_path, dtype):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(4).integers(0, 60000, 5000).astype(dtype).tofile(
        path)
    a = JD.MemmapTokenReader(path, dtype=dtype)
    b = D.MemmapTokenReader(path, dtype=dtype)
    for step, shard, n in ((0, 0, 1), (3, 1, 2), (40, 2, 3)):
        assert np.array_equal(a.batch(step, 4, 63, shard, n),
                              b.batch(step, 4, 63, shard, n))
    with pytest.raises(ValueError):
        b.batch(0, 1, 5000)


def test_batch_iterator_matches_reference():
    src_j = JD.SyntheticLMStream(vocab=300, seed=2)
    src_t = D.SyntheticLMStream(vocab=300, seed=2)
    it_j = JD.make_batch_iterator(src_j, batch_size=2, seq_len=9,
                                  start_step=4)
    it_t = D.make_batch_iterator(src_t, batch_size=2, seq_len=9,
                                 start_step=4)
    for _ in range(3):
        (sj, bj), (st, bt) = next(it_j), next(it_t)
        assert sj == st and np.array_equal(bj["tokens"], bt["tokens"])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(4, 3, generator=g),
            "layers.0.b": torch.randn(5, generator=g).bfloat16(),
            "mu": {"w": torch.randn(4, 3, generator=g)},
            "step": 7}


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return type(a) is type(b) and a == b


def test_checkpoint_roundtrip_layout(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    mgr.save(3, tree, extra_meta={"note": 1})
    d = tmp_path / "step_3"
    meta = json.loads((d / "manifest.json").read_text())
    assert meta["step"] == 3 and meta["extra"] == {"note": 1}
    assert meta["leaves"]["layers.0.b"] == {"shape": [5], "dtype": "bfloat16"}
    assert meta["leaves"]["mu/w"] == {"shape": [4, 3], "dtype": "float32"}
    assert sorted(np.load(d / "arrays.npz").files) == [
        "layers.0.b", "mu/w", "step", "w"]
    like = _tree(1)
    step, got = mgr.restore(like)
    assert step == 3 and _same(got, tree)


def test_checkpoint_restore_places_on_like_dtype(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"x": torch.arange(6.0).reshape(2, 3)})
    _, got = mgr.restore({"x": torch.zeros(2, 3, dtype=torch.float64)})
    assert got["x"].dtype == torch.float64
    assert torch.equal(got["x"], torch.arange(6.0,
                                              dtype=torch.float64).reshape(2, 3))


def test_checkpoint_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.zeros(3)})
    assert [s for s, _ in mgr._step_dirs()] == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_async_snapshots_first(tmp_path):
    """The async save writes the values at save time: the tensors may be
    updated in place while the writer runs."""
    mgr = CheckpointManager(tmp_path)
    x = torch.ones(256, 256)
    mgr.save(1, {"x": x}, blocking=False)
    x.mul_(3.0)
    mgr.wait()
    assert mgr.latest_step() == 1
    _, got = mgr.restore({"x": torch.zeros(256, 256)})
    assert torch.equal(got["x"], torch.ones(256, 256))


def test_checkpoint_atomicity(tmp_path):
    """A tmp dir (a write cut short) never counts as a checkpoint, and a
    save replaces it."""
    mgr = CheckpointManager(tmp_path)
    (tmp_path / "tmp.9").mkdir()
    (tmp_path / "tmp.9" / "arrays.npz").write_bytes(b"partial")
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore({"x": torch.zeros(1)})
    mgr.save(9, {"x": torch.ones(1)})
    assert not (tmp_path / "tmp.9").exists()
    assert mgr.latest_step() == 9


def test_checkpoint_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"x": torch.zeros(3, 4)})
    with pytest.raises(ValueError, match="x"):
        mgr.restore({"x": torch.zeros(4, 3)})
    with pytest.raises(KeyError):
        mgr.restore({"y": torch.zeros(3, 4)})


def test_checkpoint_sigterm_saves_and_exits(tmp_path):
    mgr = CheckpointManager(tmp_path)
    previous = signal.getsignal(signal.SIGTERM)
    try:
        mgr.install_sigterm_handler(lambda: (5, {"x": torch.ones(2)}),
                                    exit_code=3)
        with pytest.raises(SystemExit) as exc:
            os.kill(os.getpid(), signal.SIGTERM)
        assert exc.value.code == 3
    finally:
        signal.signal(signal.SIGTERM, previous)
    meta = json.loads((tmp_path / "step_5" / "manifest.json").read_text())
    assert meta["extra"] == {"preempted": True}


# ---------------------------------------------------------------------------
# analytic cost model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(JARCHS))
def test_train_flops_match_reference(name):
    """Bitwise the reference's train-cell MODEL_FLOPS: its train cell,
    chip_smoke.py's two training shapes, and one past gemma2's and
    hymba's windows."""
    cells = [c for c in JSHAPES.values() if c.kind == "train"]
    assert cells
    cells += [JShapeCell("t", S, B, "train")
              for B, S in ((2, 2048), (4, 1024), (1, 8192))]
    for cell in cells:
        want = JA.cell_cost(JARCHS[name], cell, 1).model_flops_total
        got = A.train_model_flops(ARCHS[name], batch=cell.global_batch,
                                  seq=cell.seq_len)
        assert got == want


def test_train_mfu():
    cfg = ARCHS["qwen2.5-14b"]
    flops = JA.cell_cost(JARCHS["qwen2.5-14b"],
                         JShapeCell("t", 2048, 2, "train"),
                         1).model_flops_total
    got = A.train_mfu(cfg, batch=2, seq=2048, step_s=0.5)
    assert got == flops / 0.5 / A.H100_BF16_PEAK
