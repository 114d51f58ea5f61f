"""Port parity, the dry run and the roofline (``launch/analytic.py``,
``launch/roofline.py``, ``launch/dryrun.py``) against the JAX reference and
against real runs of the same programs, on the CPU.

* ``cell_cost`` bitwise the reference's for all 10 archs x 4 shapes x
  n_devices {1, 256, 512} x ``param_shards`` {None, 16}.
* ``roofline.terms`` and ``table`` equal the reference's on the same
  records, with the reference module's constants set to the port's (the
  port's table has one more column, the collective time at NVLink, and
  its own "what would move it" notes); no TPU constant in the port.
* Per-rank parameter bytes (``dryrun.tree_device_bytes`` over the port's
  ``param_specs``) equal a numpy reckoning from the reference's
  ``param_specs`` on the production meshes, train and serve.  The
  reference's ``launch/dryrun.py`` is not imported: its import sets
  ``XLA_FLAGS`` for the whole process.
* In a child process (the fake process group must not share a process
  with gloo: ``python tests/test_torch_dryrun.py --fake <out.json>``), the
  meta dry run of small cells of the reduced qwen2.5-14b, hymba-1.5b and
  qwen3-moe-30b-a3b (train, prefill, decode) against a real 2-rank gloo
  run of the same programs on the CPU (``dryrun.program``; the harness of
  ``tests/test_torch_distributed_gs.py``): the same ``dot_flops``
  (``FlopCounterMode`` over the real step of the same rank) and the same
  collective counts and bytes; the Nekbone cells' records; one
  production-size cell that must fit 80 GB.
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

SMALL = {"train": (32, 4), "prefill": (32, 4), "decode": (32, 4)}
# each arch's small mesh: (data, model); hymba's 5 heads and the MoE's 8
# experts over a model axis of 2 turn on the sharded branches
SMALL_MESH = {"qwen2.5-14b": (2, 1), "hymba-1.5b": (1, 2),
              "qwen3-moe-30b-a3b": (1, 2)}


def _cfg(arch):
    from repro_torch.configs import ARCHS

    cfg = ARCHS[arch].reduced()
    if arch == "hymba-1.5b":
        return dataclasses.replace(cfg, n_heads=5, n_kv_heads=1)
    return dataclasses.replace(cfg, remat=True)


def _cell(kind):
    from repro_torch.configs import ShapeCell

    S, B = SMALL[kind]
    return ShapeCell(f"small_{kind}", S, B, kind)


# ---------------------------------------------------------------------------
# the fake group's child (no jax, no repro, no gloo)
# ---------------------------------------------------------------------------

def fake_main(out: str) -> int:
    import torch

    from repro_torch.launch import dryrun as D

    torch.set_num_threads(2)
    recs = {}
    for arch, (data, model) in SMALL_MESH.items():
        for kind in SMALL:
            recs[f"{arch}/{kind}"] = D.run_cell(
                arch, f"small_{kind}", "single", verbose=False,
                cfg=_cfg(arch), cell=_cell(kind),
                axes={"data": data, "model": model})
    for dt in (torch.float32, torch.bfloat16):
        rec = D.run_nekbone("single", dtype=dt)
        recs[rec["arch"]] = rec
    recs["qwen2.5-14b/decode_32k"] = D.run_cell(
        "qwen2.5-14b", "decode_32k", "single", verbose=False)
    pathlib.Path(out).write_text(json.dumps(recs))
    return 0


# ---------------------------------------------------------------------------
# the gloo world's check: the same programs on real CPU tensors
# ---------------------------------------------------------------------------

def c_real(arch, kind, data, model):
    """Rank 1's step of the small cell on real tensors (weights from seed
    0, held cut as the dry run holds them): its dot FLOPs and
    collectives."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import model as M

    cfg, cell = _cfg(arch), _cell(kind)
    mesh = make_mesh_for(data * model, model_parallel=model)
    with SH.use_mesh(mesh):
        params = M.init_params(torch.Generator().manual_seed(0), cfg)
        specs = M.param_specs(cfg, params, mesh,
                              serve=D.serve_mode(cfg, cell))
        M.hold_cut(params, cfg, mesh, specs)
        rows, cut = D._local_batch(mesh, cell.global_batch)
        run, _ = D.program(cfg, cell, params, rows, cut, device="cpu")
        flops = FlopCounterMode(display=False)
        with SH.collective_log() as log, flops:
            run()
    return {"dot_flops": np.array(float(flops.get_total_flops())),
            "counts": np.array(json.dumps([log.counts, log.bytes]))}


CHILD_CHECKS = {"real": c_real}


def world_checks() -> dict:
    return {2: [[f"real@{arch}-{kind}",
                 dict(arch=arch, kind=kind, data=d, model=m)]
                for arch, (d, m) in SMALL_MESH.items() for kind in SMALL]}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fake"]:
        sys.exit(fake_main(sys.argv[2]))
    sys.exit(child_main(sys.argv[1:], CHILD_CHECKS))


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.launch import analytic as JA  # noqa: E402
from repro.launch import roofline as JR  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.launch import analytic as A  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import roofline as R  # noqa: E402
from repro_torch.launch.mesh import production_mesh_shape  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_fake") / "records.json"
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, str(HERE), "--fake", str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=CHILD_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return Worlds(HERE, world_checks(), tmp_path_factory)


# -- the analytic model -------------------------------------------------------

@pytest.mark.parametrize("n_dev", [1, 256, 512])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_cell_cost_matches_reference(arch, shape, n_dev):
    for shards in (None, 16):
        want = JA.cell_cost(JARCHS[arch], JSHAPES[shape], n_dev,
                            param_shards=shards)
        got = A.cell_cost(ARCHS[arch], SHAPES[shape], n_dev,
                          param_shards=shards)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


# -- the roofline -------------------------------------------------------------

def _records():
    """Records that make each term dominant, in both compute dtypes, and
    a skipped and a failed cell."""
    coll = {"all_gather": {"bytes": 4.0e9, "count": 3},
            "psum": {"bytes": 1.0e9, "count": 2}}
    base = dict(mesh="single", collectives=coll, model_flops_per_dev=2e13,
                analytic_hbm_bytes_per_dev=1e9)
    return [
        dict(base, arch="a", shape="train_4k", dot_flops=3e14,
             compute_dtype="bfloat16"),
        dict(base, arch="b", shape="prefill_32k", dot_flops=1e12,
             analytic_hbm_bytes_per_dev=9e11, compute_dtype="bfloat16"),
        dict(base, arch="c", shape="decode_32k", dot_flops=1e12,
             compute_dtype="float32"),
        dict(base, arch="d", shape="train_4k", dot_flops=4e13,
             compute_dtype="float32"),
        dict(base, arch="e", shape="long_500k", skipped="pure full attention"),
        dict(base, arch="f", shape="train_4k", error="RuntimeError: boom"),
    ]


def _patched(monkeypatch, rec):
    monkeypatch.setattr(JR, "PEAK_FLOPS", R.peak_flops(rec))
    monkeypatch.setattr(JR, "HBM_BW", R.HBM_BW)
    monkeypatch.setattr(JR, "LINK_BW", R.LINK_BW)


@pytest.mark.parametrize("i", range(6))
def test_roofline_terms_match_reference(monkeypatch, i):
    rec = _records()[i]
    _patched(monkeypatch, rec)
    want, got = JR.terms(rec), R.terms(rec)
    if want is None:
        assert got is None
        return
    for key in ("compute_s", "memory_s", "collective_s", "dominant",
                "roofline_frac", "model_ratio"):
        assert got[key] == want[key], key
    assert got["collective_nvlink_s"] == sum(
        v["bytes"] for v in rec["collectives"].values()) / R.NVLINK_BW
    assert "MXU" not in got["move"]
    assert R.fmt_row(rec).rsplit(" |", 2)[0] == JR.fmt_row(rec).rsplit(
        " |", 1)[0] or "skipped" in R.fmt_row(rec) or "ERROR" in \
        R.fmt_row(rec)


def test_roofline_table_matches_reference(monkeypatch):
    """One dtype's records: the port's table less its NVLink column is the
    reference's (its FLOPs column named for counted FLOPs, not HLO's); its
    constants are the H100's, none a TPU's."""
    recs = [r for r in _records() if r.get("compute_dtype",
                                           "bfloat16") == "bfloat16"]
    _patched(monkeypatch, recs[0])
    want = JR.table(recs).splitlines()
    got = R.table(recs).splitlines()
    assert len(got) == len(want)
    # the header: the port's FLOPs are counted, not HLO's
    assert got[0].rsplit(" |", 2)[0] + " |" == want[0].replace(
        "MODEL/HLO", "MODEL/counted")
    assert got[1] == want[1] + "---|"
    for g, w in zip(got[2:], want[2:]):
        assert g.rsplit(" |", 2)[0] + " |" == w
    assert (R.PEAK_FLOPS["bfloat16"], R.PEAK_FLOPS["float32"], R.HBM_BW,
            R.LINK_BW, R.NVLINK_BW) == (989e12, 67e12, 3.35e12, 50e9, 450e9)
    src = pathlib.Path(R.__file__).read_text()
    for tpu in ("197e12", "819e9", "MXU", "ICI"):
        assert tpu not in src


def test_roofline_cli_reads_records(tmp_path, capsys):
    for i, rec in enumerate(_records()):
        (tmp_path / f"{i}.json").write_text(json.dumps(rec))
    R.main(["--art-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("\n| ") == len(_records())
    assert "dominant=compute" in out and "dominant=memory" in out


def test_roofline_compact_table():
    """One row an arch and one column a shape; each cell's three terms,
    its dominant term, MODEL/counted flops and peak bytes, marked where
    the peak passes 80 GB."""
    recs = [dict(r, live_bytes={"peak": 9e10 if i == 0 else 1e9},
                 fits_80gb=i != 0) for i, r in enumerate(_records())]
    lines = R.compact(recs).splitlines()
    assert lines[0] == ("| arch | train_4k | prefill_32k | decode_32k | "
                        "long_500k |")
    assert len(lines) == 2 + len({r["arch"] for r in recs})
    row_a = next(ln for ln in lines if ln.startswith("| a |"))
    t = R.terms(recs[0])
    assert f"C {t['compute_s']:.2g} / M {t['memory_s']:.2g}" in row_a
    assert "→ compute; " in row_a and "90.0 GB ✗" in row_a
    assert "skipped" in next(ln for ln in lines if ln.startswith("| e |"))
    assert "ERROR" in next(ln for ln in lines if ln.startswith("| f |"))


# -- per-rank bytes from the specs --------------------------------------------

def _reckon(arch, mesh_kind, serve):
    """Per-device parameter bytes from the reference's param_specs, in
    numpy: each stacked leaf's bytes over its spec's named axes."""
    names, sizes = (production_mesh_shape(multi_pod=mesh_kind == "multi")
                    .axis_names, production_mesh_shape(
                        multi_pod=mesh_kind == "multi").axis_sizes)
    shape = dict(zip(names, sizes))
    avals = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                  JARCHS[arch]))
    jmesh = jax.sharding.AbstractMesh(sizes, names)
    specs = JM.param_specs(JARCHS[arch], avals, jmesh, serve=serve)
    total = 0
    for a, s in zip(jax.tree.leaves(avals), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))):
        denom = 1
        for entry in s:
            for ax in (entry,) if isinstance(entry, str) else entry or ():
                denom *= shape.get(ax, 1)
        total += int(np.prod(a.shape, dtype=np.int64)
                     * np.dtype(a.dtype).itemsize // denom)
    return total


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_bytes_match_reference_specs(monkeypatch, arch, mesh_kind):
    pod = mesh_kind == "multi" and ARCHS[arch].param_count() > 1e11
    monkeypatch.setattr(SH.RULES, "fsdp_pod", pod)
    monkeypatch.setattr(JSH.RULES, "fsdp_pod", pod)
    mesh = production_mesh_shape(multi_pod=mesh_kind == "multi")
    model = M.init_params(L.MetaGen(), ARCHS[arch])
    whole = dict(model.named_parameters())
    for serve in (False, True):
        specs = M.param_specs(ARCHS[arch], model, mesh, serve=serve)
        got = D.tree_device_bytes(whole, specs, SH.mesh_axes(mesh))
        assert got == _reckon(arch, mesh_kind, serve), serve


# -- meta kernels and live bytes, in this process -----------------------------

def test_kernels_run_their_plain_versions_on_meta():
    """K13 and K14 on meta tensors: the plain versions' shapes, counted in
    PLAIN_ON_META, no launch; the kernel wrappers themselves refuse meta."""
    from repro_torch.kernels import flash_attn

    _build.PLAIN_ON_META.clear()
    launches = dict(_build.LAUNCHES)
    q = torch.empty(2, 4, 64, 16, device="meta")
    kv = torch.empty(2, 2, 64, 16, device="meta")
    o = ops.flash_attention(q, kv, kv, window=8)
    r = torch.empty(2, 4, 48, 16, device="meta")
    y, s = ops.wkv6(r, r, r, r, torch.empty(4, 16, device="meta"),
                    return_state=True)
    assert o.shape == q.shape and o.device.type == "meta"
    assert y.shape == r.shape and s.shape == (2, 4, 16, 16)
    assert _build.PLAIN_ON_META == {"flash_attn": 1, "wkv6": 1}
    assert _build.LAUNCHES == launches
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attn.flash_attention_cuda(q, kv, kv, causal=True, scale=1.0,
                                        window=None, softcap=None,
                                        q_offset=0)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("T", [16, 48, 64])
@pytest.mark.parametrize("state", [False, True])
def test_batched_wkv_counts_the_chunked_forms_flops(state, T, grad):
    """K14's form on meta, the chunked form's products batched over the
    chunks: the FLOPs of ``ref.wkv6_chunked`` on real tensors, forward and
    backward, with and without an initial state; the outputs' shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import ref

    B, H, d = 2, 3, 8

    def flops(device, fn):
        g = torch.Generator().manual_seed(0)
        ins = [torch.rand(B, H, T, d, generator=g) for _ in range(4)]
        ins.append(torch.rand(H, d, generator=g))
        ins = [t.to(device).requires_grad_(grad) for t in ins]
        s0 = (torch.rand(B, H, d, d, generator=g).to(device)
              .requires_grad_(grad) if state else None)
        count = FlopCounterMode(display=False)
        with count:
            o, S = fn(*ins, initial_state=s0, chunk=16, return_state=True)
            if grad:
                torch.autograd.grad(o.sum() + S.sum(),
                                    ins + ([s0] if state else []))
        assert o.shape == (B, H, T, d) and S.shape == (B, H, d, d)
        return count.get_total_flops()

    assert flops("meta", ref.wkv6_chunked_batched) == flops(
        "cpu", ref.wkv6_chunked) > 0


def test_live_bytes_tracks_meta_storages():
    """Live bytes follow the storages ops make (views share them) and the
    peak inside a kernel scope is taken on the way out."""
    live = D.LiveBytes(base=100)
    with live:
        x = torch.empty(1000, device="meta")           # 4000 B
        v = x.view(10, 100)
        assert live.now == 4100
        with live.kernel():
            t = torch.empty(10_000, device="meta")     # 40000 B, temporary
            out = torch.empty(10, device="meta")       # 40 B, returned
            del t
        assert live.peak == 4140 and live.now == 4140
        del x
        assert live.now == 4140                        # v holds the storage
        del v, out
        assert live.now == 100


# -- the dry run against a real run -------------------------------------------

@pytest.mark.parametrize("kind", list(SMALL))
@pytest.mark.parametrize("arch", list(SMALL_MESH))
def test_dry_run_matches_a_real_run(fake, worlds, arch, kind):
    """The fake-group meta dry run of rank 1 against rank 1 of a real gloo
    world of 2 running the same program: the same dot FLOPs and the same
    collectives, counts and bytes; the record names the meta device and
    the kernels' plain versions."""
    rec = fake[f"{arch}/{kind}"]
    assert "error" not in rec and rec["device"] == "meta"
    assert rec["rank"] == 1 and rec["n_devices"] == 2
    got = load(worlds(2), f"real@{arch}-{kind}", 1)
    assert rec["dot_flops"] == float(got["dot_flops"]) > 0
    counts, nbytes = json.loads(str(got["counts"]))
    assert {k: v["count"] for k, v in rec["collectives"].items()} == counts
    assert {k: v["bytes"] for k, v in rec["collectives"].items()} == nbytes
    # decode attends its cache in plain torch, as the reference does
    assert (rec["kernels_on_meta"] == {} if kind == "decode" else
            rec["kernels_on_meta"]["flash_attn"]["calls"] > 0)
    assert rec["fits_80gb"] and rec["live_bytes"]["peak"] >= \
        rec["live_bytes"]["base"] > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nekbone_dry_run_record(fake, dtype):
    """The n=10 CG iteration on a rank of 256: (16, 16, 4) elements, one
    plane exchange each way and one psum, the paper's Eq. 1 / Eq. 2."""
    rec = fake[f"nekbone-{dtype}"]
    n, E_loc = 10, 1024
    item = 4 if dtype == "float32" else 2
    assert "error" not in rec and rec["n_devices"] == 256
    assert rec["model_flops_per_dev"] == E_loc * n ** 3 * (12 * n + 34)
    assert rec["analytic_hbm_bytes_per_dev"] == 30 * E_loc * n ** 3 * item
    plane = 16 * 16 * n * n * item
    assert rec["collectives"] == {
        "ppermute": {"bytes": 2 * plane, "count": 2},   # the last rank
        "psum": {"bytes": item, "count": 1}}
    assert rec["dot_flops"] > 0 and rec["fits_80gb"]


def test_production_decode_cell_fits(fake):
    """qwen2.5-14b decode_32k on the 256-rank mesh: TP-replicated
    parameters, the cache's sequence over 'model' (8 KV heads < 16),
    fitting 80 GB."""
    rec = fake["qwen2.5-14b/decode_32k"]
    assert "error" not in rec and rec["serve_param_mode"] == "tp-replicated"
    assert rec["fits_80gb"] and rec["kernels_on_meta"] == {}
    assert rec["live_bytes"]["base"] < rec["live_bytes"]["peak"] < 80e9
    assert rec["param_bytes_per_device"] == _reckon("qwen2.5-14b", "single",
                                                    True)
