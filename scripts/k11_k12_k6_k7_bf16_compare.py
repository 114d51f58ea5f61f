#!/usr/bin/env python3
"""K11, K12, K6 and K7 with their bf16 builds beside the commit before them,
on one NVIDIA card.

Run from the root of a checkout, with the earlier kernels' sources beside
it (a ``git archive`` of the commit before the bf16 builds, unpacked into a
directory that ``.gitignore`` lists)::

    mkdir -p build/parent_k11k12k6k7
    git archive b8fd8d8 src/repro_torch/kernels/csrc | tar -x -C build/parent_k11k12k6k7
    python3 scripts/k11_k12_k6_k7_bf16_compare.py --parent build/parent_k11k12k6k7

It builds the port's ``nekbone_cheb_apply``, ``nekbone_interp``,
``nekbone_ax_slab_block`` and ``nekbone_cg_update_block`` libraries in all
four builds (with the ``nekbone_ax_slab`` and ``nekbone_cg_update`` that
the routes and the lane checks need) and prints their registers and
spills at n = 10, and the earlier sources' ``f64`` and ``f32`` builds into
``build/k11k12k6k7_parent/``, then:

* SASS: shows whether ``cuobjdump -sass`` gives each ``f64`` and ``f32``
  kernel instantiation the same instructions in both (paired by kernel
  and its integer template arguments; the tree's names carry the new type
  parameters);
* shows whether the fp64 Chebyshev-PCG(4) and pmg-PCG solves to their
  tolerances and the block CG solve at b = 4 (100 iterations), on the
  paper case, give bitwise the same history and x over the earlier
  ``f64`` K11, K12, K6 and K7 (loaded in place of the tree's) as over the
  tree's;
* runs ``chip_smoke.phase_bf16_cheb_pmg_block_parity`` (the bf16 builds
  against their plain versions, with K11's launch plans).
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

OUT = ROOT / "build/k11k12k6k7_parent"
MIXES = ("f64", "f32", "bf16", "bf16_ir")
STEMS = ("nekbone_cheb_apply", "nekbone_interp", "nekbone_ax_slab_block",
         "nekbone_cg_update_block")


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


class _EarlierK11:
    """The earlier K11 library behind the tree's C signature: the tree's
    entry takes one more pointer after rtz (the device variant's running z
    where it is not stored in A; null in f64), dropped here."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        fn = lib.nekbone_cheb_apply_f64
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call(*args):
            return fn(*args[:16], *args[17:])

        call.argtypes = fn.argtypes
        self.nekbone_cheb_apply_f64 = call

    def __getattr__(self, name):
        return getattr(self._lib, name)


def compare_histories(parent: dict) -> bool:
    """The fp64 Chebyshev, pmg and block routes over the tree's K11, K12,
    K6 and K7, then over the earlier ones loaded in their place."""
    import torch

    import chip_smoke as cs
    from repro_torch.core.gs import ds_sum_local
    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import _build

    print("== fp64 Chebyshev-PCG(4) and pmg-PCG to their tolerances and "
          f"block CG (b = {cs.BLOCK_B}, {cs.NITER} iterations), paper case, "
          "over the tree's and the earlier K11, K12, K6 and K7", flush=True)
    v2 = NekboneCase(n=10, grid=cs.PAPER_GRID, dtype=torch.float64,
                     ax_impl="pallas_fused_cg_v2")
    _, f = v2.manufactured()
    r0 = float(torch.sqrt(torch.abs(torch.sum(f * v2.c * f))))
    gen = torch.Generator(device="cuda").manual_seed(9)
    F = torch.stack([f] + [
        ds_sum_local(torch.randn(tuple(f.shape), dtype=f.dtype,
                                 device="cuda", generator=gen), v2.grid)
        * v2.mask for _ in range(cs.BLOCK_B - 1)])
    runs = {
        "cheb": lambda: v2.solve(f, tol=cs.CHEB_TOL, max_iter=cs.NITER,
                                 precond=f"cheb{cs.CHEB_K}"),
        "pmg": lambda: v2.solve(f, tol=cs.PMG_RTOL * r0, max_iter=cs.NITER,
                                precond="pmg"),
        "block": lambda: v2.solve(F, niter=cs.NITER)}
    tree = {k: fn() for k, fn in runs.items()}
    saved = {}
    for stem in STEMS:
        name = f"{stem}_f64"
        saved[name] = _build._LIBS[name]
        lib = ctypes.CDLL(str(parent[(stem, "f64")]))
        _build._LIBS[name] = (_EarlierK11(lib)
                              if stem == "nekbone_cheb_apply" else lib)
    try:
        earlier = {k: fn() for k, fn in runs.items()}
    finally:
        _build._LIBS.update(saved)
    ok = True
    for key in runs:
        a, b = tree[key], earlier[key]
        same = (torch.equal(a.history.nan_to_num(-1.0),
                            b.history.nan_to_num(-1.0))
                and torch.equal(a.x, b.x))
        ok &= same
        last = a.history.reshape(-1, a.history.shape[-1])[0]
        print(f"  {key}: {int(a.iters.max())} iterations, history[-1] "
              f"{float(last[int(a.iters.max())]):.6e}; history and x "
              f"bitwise the earlier kernels': {same}", flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True,
                    help="a checkout (or archive) of the commit before the "
                         "bf16 builds of K11, K12, K6 and K7")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k11_k12_k6_k7_bf16_compare.py: no CUDA device",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    # only the libraries this script needs
    _build.SOURCES = {stem: MIXES for stem in STEMS
                      + ("nekbone_ax_slab", "nekbone_cg_update")}
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
        cs.phase_bf16_cheb_pmg_block_parity()
    except cs.CheckFailed as exc:
        print(f"FAILED: {exc}", flush=True)
        ok = False
    print(f"k11_k12_k6_k7_bf16_compare: "
          f"{'every check held' if ok else 'A CHECK FAILED'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
