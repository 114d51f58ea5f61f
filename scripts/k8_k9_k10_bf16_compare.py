#!/usr/bin/env python3
"""K8, K9 and K10 with their bf16 builds beside the commit before them, on
one NVIDIA card.

Run from the root of a checkout, with the earlier kernels' sources beside
it (a ``git archive`` of the commit before the bf16 builds, unpacked into a
directory that ``.gitignore`` lists)::

    mkdir -p build/parent_k8k9k10
    git archive 8f55f7f src/repro_torch/kernels/csrc | tar -x -C build/parent_k8k9k10
    python3 scripts/k8_k9_k10_bf16_compare.py --parent build/parent_k8k9k10

It builds the port's ``nekbone_ax_powers``, ``nekbone_sstep_update`` and
``nekbone_pcg_update`` libraries in all four builds (with the ``f64`` and
bf16 ``nekbone_ax_slab`` that Jacobi-PCG and the checks need) and prints
their registers and spills at n = 10, and the earlier sources' ``f64`` and
``f32`` builds into ``build/k8k9k10_parent/``, then:

* SASS: shows whether ``cuobjdump -sass`` gives each ``f64`` and ``f32``
  kernel instantiation the same instructions in both (paired by kernel
  and n; the tree's names carry the new type parameters);
* shows whether the fp64 s-step route (s = 4) and Jacobi-PCG, 100
  iterations on the paper case, give bitwise the same history and x over
  the earlier ``f64`` K8, K9 and K10 (loaded in place of the tree's) as
  over the tree's;
* runs ``chip_smoke.phase_bf16_sstep_pcg_parity`` (the bf16 builds against
  their plain versions, with K8's launch plans).
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from scripts.k4_k3_compare import _sass  # noqa: E402  (one SASS reader)

OUT = ROOT / "build/k8k9k10_parent"
MIXES = ("f64", "f32", "bf16", "bf16_ir")
STEMS = ("nekbone_ax_powers", "nekbone_sstep_update", "nekbone_pcg_update")


def start_parent(parent: pathlib.Path) -> dict:
    """One ``nvcc`` per earlier library, started; :func:`wait_parent`
    collects them."""
    from repro_torch.kernels import _build

    csrc = parent / "src/repro_torch/kernels/csrc"
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in STEMS:
        for mix in ("f64", "f32"):
            so = OUT / f"{stem}_{mix}.so"
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS,
                   f"-DNEKBONE_REAL_{mix.upper()}", "-o", str(so),
                   str(csrc / f"{stem}.cu")]
            procs[(stem, mix)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    return procs


def wait_parent(procs: dict) -> dict:
    built = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {key}:\n{log[-4000:]}")
        built[key] = so
    return built


def compare_sass(parent: dict, tree: dict) -> bool:
    print("== SASS of the f64 and f32 builds, beside the earlier sources",
          flush=True)
    ok = True
    for stem in STEMS:
        for mix in ("f64", "f32"):
            old = _sass(parent[(stem, mix)])
            new = _sass(tree[f"{stem}_{mix}"])
            same = old.keys() == new.keys() and all(old[k] == new[k]
                                                    for k in old)
            ok &= same
            print(f"  {stem}_{mix}: {len(old)} kernels, "
                  f"{sum(map(len, old.values()))} instructions; the same "
                  f"SASS: {same}", flush=True)
    return ok


def compare_histories(parent: dict) -> bool:
    """The fp64 s-step and Jacobi routes over the tree's K8, K9, K10, then
    over the earlier ones loaded in their place."""
    import torch

    import chip_smoke as cs
    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import _build

    print("== fp64 s-step (s = 4) and Jacobi-PCG, paper case, 100 "
          "iterations, over the tree's and the earlier K8, K9 and K10",
          flush=True)
    sstep = NekboneCase(n=10, grid=cs.PAPER_GRID, dtype=torch.float64,
                        ax_impl="pallas_sstep_v3", s=cs.SSTEP_S)
    v2 = NekboneCase(n=10, grid=cs.PAPER_GRID, dtype=torch.float64,
                     ax_impl="pallas_fused_cg_v2")
    _, f = v2.manufactured()
    runs = {"sstep": lambda: sstep.solve(f, niter=cs.NITER),
            "jacobi": lambda: v2.solve(f, niter=cs.NITER, precond="jacobi")}
    tree = {k: fn() for k, fn in runs.items()}
    saved = {}
    for stem in STEMS:
        name = f"{stem}_f64"
        saved[name] = _build._LIBS[name]
        _build._LIBS[name] = ctypes.CDLL(str(parent[(stem, "f64")]))
    try:
        earlier = {k: fn() for k, fn in runs.items()}
    finally:
        _build._LIBS.update(saved)
    ok = True
    for key in runs:
        a, b = tree[key], earlier[key]
        same = torch.equal(a.history, b.history) and torch.equal(a.x, b.x)
        ok &= same
        print(f"  {key}: history[{cs.NITER}] {float(a.history[-1]):.6e} "
              f"(earlier {float(b.history[-1]):.6e}); history and x bitwise "
              f"the earlier kernels': {same}", flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True,
                    help="a checkout (or archive) of the commit before the "
                         "bf16 builds of K8, K9 and K10")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k8_k9_k10_bf16_compare.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    # only the libraries this script needs
    _build.SOURCES = {**{stem: MIXES for stem in STEMS},
                      "nekbone_ax_slab": MIXES}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    import chip_smoke as cs

    procs = start_parent(args.parent.resolve())
    tree = _build.build_all()
    for name, path in tree.items():
        report = cs._ptxas_report(path.with_suffix(".log").read_text())
        print(f"  {name}: (registers, spill store bytes) at n = 10: "
              + str({k: v for k, v in report.items()
                     if re.search(r"<10(,|>)", k)})
              + "; spills elsewhere: "
              + str({k: v[1] for k, v in report.items()
                     if v[1] and not re.search(r"<10(,|>)", k)} or "none"),
              flush=True)
    parent = wait_parent(procs)
    ok = compare_sass(parent, tree)
    ok &= compare_histories(parent)
    try:
        cs.phase_bf16_sstep_pcg_parity()
    except cs.CheckFailed as exc:
        print(f"FAILED: {exc}", flush=True)
        ok = False
    print(f"k8_k9_k10_bf16_compare: "
          f"{'every check held' if ok else 'A CHECK FAILED'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
