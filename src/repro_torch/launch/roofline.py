"""Roofline analysis from the dry run's records, at the H100's peaks.

The port of the reference's ``launch/roofline.py``.  Per (arch x shape)
cell of one mesh, from ``launch/dryrun.py``'s records, one rank's times:

    compute    = FLOPs / peak(compute dtype)
    memory     = HBM bytes / bw              bw   = 3.35e12 B/s (HBM3)
    collective = coll bytes / link           link = 50e9 B/s a GPU
    (NVLink)   = coll bytes / nvlink         nvlink = 450e9 B/s one way

The constants are the NVIDIA H100 SXM5 data sheet's: the dense tensor-core
peak of the cell's compute dtype, 989e12 flop/s in bf16; 67e12 flop/s for
f32 and fp64 (the f32 CUDA-core and fp64 tensor-core peaks, the figure
PERF.md's K8/K11 bounds use); HBM3 at 3.35e12 B/s; and a per-GPU network
link of 50e9 B/s, one 400 Gb/s NDR InfiniBand port a GPU.  A 16-rank
``data`` or ``model`` axis spans two 8-GPU NVLink nodes, so that link
binds a ring over it; NVLink 4's 450e9 B/s one way a GPU is its own column,
the time if the axis stayed inside a node.  These are data-sheet peaks,
not a measurement.

FLOPs: the dry run's ``dot_flops``, counted per rank by
``torch.utils.flop_counter.FlopCounterMode`` — reported next to
MODEL_FLOPS = 6·N(_active)·D, so the useful-work ratio is visible (the
port computes dense layers whole on every rank of the ``model`` axis, so
that ratio reads about 1/16 on the production meshes).  HBM bytes: the
analytic per-device floor (``launch/analytic.py``).  Collective bytes: the
rank's sum over the collectives it issued (``sharding.collective_log``).

Output: a markdown table, the dominant term and a one-line "what would
move it" note per cell.

  python -m repro_torch.launch.roofline [--art-dir DIR] [--mesh single]
      [--compact]
"""
from __future__ import annotations

import argparse
import json
import pathlib

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "float64": 67e12}
HBM_BW = 3.35e12             # B/s a GPU (HBM3)
LINK_BW = 50e9               # B/s a GPU (one 400 Gb/s NDR port)
NVLINK_BW = 450e9            # B/s a GPU, one way (NVLink 4)

ART_DIR = (pathlib.Path(__file__).resolve().parents[3] / "artifacts"
           / "dryrun_torch")

_MOVE_NOTES = {
    "compute": "raise tensor-core utilization: cut each dense layer over "
               "'model' (tensor-parallel compute, ROADMAP item 19), larger "
               "per-rank batch, wgmma-sized (64-multiple) head and ffn tiles",
    "memory": "cut HBM traffic: bf16/fp8 streams, fuse passes, keep tiles "
              "in shared memory (TMA), ring-buffer windowed KV",
    "collective": "cut/overlap comm: reduce-scatter instead of all-reduce, "
                  "collective-matmul overlap, keep FSDP inside an 8-GPU "
                  "NVLink node",
}


def peak_flops(rec: dict) -> float:
    """The dense peak of the record's compute dtype (bf16 where absent)."""
    return PEAK_FLOPS[rec.get("compute_dtype", "bfloat16")]


def load_records(art_dir=ART_DIR, mesh: str = "single"):
    recs = []
    for p in sorted(pathlib.Path(art_dir).glob("*.json")):
        r = json.loads(p.read_text())
        if r.get("mesh") == mesh:
            recs.append(r)
    return recs


def terms(rec: dict) -> dict | None:
    if "error" in rec or rec.get("skipped"):
        return None
    peak = peak_flops(rec)
    flops_dev = rec.get("dot_flops", 0.0)          # already per device
    hbm_dev = rec.get("analytic_hbm_bytes_per_dev", 0.0)
    coll_dev = sum(v["bytes"] for v in rec.get("collectives", {}).values())
    t_c = flops_dev / peak
    t_m = hbm_dev / HBM_BW
    t_x = coll_dev / LINK_BW
    dom = max((("compute", t_c), ("memory", t_m), ("collective", t_x)),
              key=lambda kv: kv[1])[0]
    total = max(t_c, t_m, t_x)
    model_dev = rec.get("model_flops_per_dev", 0.0)
    # fraction of the physics-mandated time (useful compute OR the memory
    # floor, whichever binds) that the port's program achieves
    useful = max(model_dev / peak, t_m)
    return {
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
        "collective_nvlink_s": coll_dev / NVLINK_BW,
        "dominant": dom,
        "roofline_frac": min(useful / total, 1.0) if total else 0.0,
        "model_ratio": model_dev / flops_dev if flops_dev else 0.0,
        "move": _MOVE_NOTES[dom],
    }


def fmt_row(rec: dict) -> str:
    cellname = f"{rec['arch']} × {rec['shape']}"
    if rec.get("skipped"):
        return (f"| {cellname} | — | — | — | skipped: {rec['skipped']} | — "
                "| — | — |")
    if "error" in rec:
        return (f"| {cellname} | — | — | — | ERROR: {rec['error'][:60]} | — "
                "| — | — |")
    t = terms(rec)
    return ("| {c} | {t[compute_s]:.2e} | {t[memory_s]:.2e} | "
            "{t[collective_s]:.2e} | **{t[dominant]}** | {t[model_ratio]:.2f} "
            "| {t[roofline_frac]:.1%} | {t[collective_nvlink_s]:.2e} |"
            ).format(c=cellname, t=t)


def table(recs) -> str:
    hdr = ("| cell | compute (s) | memory (s) | collective (s) | dominant | "
           "MODEL/counted flops | roofline frac | collective at NVLink (s) |"
           "\n|---|---|---|---|---|---|---|---|")
    return "\n".join([hdr] + [fmt_row(r) for r in recs])


def _compact_cell(rec: dict) -> str:
    if rec.get("skipped"):
        return "skipped"
    if "error" in rec:
        return "ERROR"
    t = terms(rec)
    peak = rec.get("live_bytes", {}).get("peak")
    fits = "" if peak is None else (f"; {peak / 1e9:.1f} GB"
                                    + ("" if rec.get("fits_80gb") else " ✗"))
    return (f"C {t['compute_s']:.2g} / M {t['memory_s']:.2g} / X "
            f"{t['collective_s']:.2g} → {t['dominant']}; "
            f"{t['model_ratio']:.2f}{fits}")


def compact(recs) -> str:
    """One row an arch, one column a shape: each cell's compute, memory and
    collective seconds (C / M / X), the dominant term, MODEL/counted flops
    and the peak of live bytes a rank (✗ where it passes 80 GB)."""
    shapes = list(dict.fromkeys(r["shape"] for r in recs))
    archs = list(dict.fromkeys(r["arch"] for r in recs))
    by = {(r["arch"], r["shape"]): r for r in recs}
    lines = ["| arch | " + " | ".join(shapes) + " |",
             "|---" * (len(shapes) + 1) + "|"]
    for a in archs:
        lines.append(f"| {a} | " + " | ".join(
            _compact_cell(by[a, s]) if (a, s) in by else "—"
            for s in shapes) + " |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--art-dir", default=str(ART_DIR))
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--compact", action="store_true",
                    help="one row an arch, one column a shape")
    args = ap.parse_args(argv)
    recs = load_records(args.art_dir, args.mesh)
    if args.compact:
        print(compact(recs))
        return
    print(table(recs))
    print()
    for r in recs:
        t = terms(r)
        if t:
            print(f"- {r['arch']} × {r['shape']}: dominant={t['dominant']}; "
                  f"move it down: {t['move']}")


if __name__ == "__main__":
    main()
