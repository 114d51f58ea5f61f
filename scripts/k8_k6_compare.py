#!/usr/bin/env python3
"""K8 and K6 beside the versions they replaced, and where their time goes,
on one NVIDIA card.

Run from the root of a checkout, with the earlier kernels' sources beside
it (a ``git archive`` of the commit before the redesign, unpacked into a
directory that ``.gitignore`` lists)::

    mkdir -p build/parent_k8k6
    git archive 16bb7ea src/repro_torch/kernels/csrc | tar -x -C build/parent_k8k6
    python3 scripts/k8_k6_compare.py --parent build/parent_k8k6 [--ablation]

or, for the ablations alone, ``python3 scripts/k8_k6_compare.py
--ablation``.  It builds the port's ``nekbone_ax_powers`` and
``nekbone_ax_slab_block`` libraries (f64, f32) and prints their registers
and spills, and, with ``--parent``, the earlier ``nekbone_ax_powers.cu`` (a
chain of s + 2 launches) and ``nekbone_ax_slab_block.cu`` (one element and
one lane at a time) into ``build/k8_k6_parent/``, then:

* K8: prints the launch plan at E = 1024 and 4096 (n = 10, s = 1, 2, 4,
  fp64 and fp32); on ``chip_smoke.py``'s s-step inputs shows whether the
  basis is bitwise the chain's and the Gram partials bitwise
  ``ref.sstep_gram_emulated`` of it, each one's max abs error against the
  plain version, 5 repeated calls bitwise, and times both in turns
  (earlier, new, new, earlier) at s = 1, 2, 4: fp64 on both grids, fp32 on
  the paper grid;
* K6: on b lanes (b = 1, 3, 4) shows whether p, w and pap are bitwise the
  earlier kernel's, and times both in turns on both grids, fp64 and fp32;
* SASS: builds K1, K4, K5, K10 and K11 (f64) from ``--parent`` and from the
  tree and shows whether ``cuobjdump -sass`` gives each the same
  instructions (the tree's ``common.cuh`` helpers that they share).

``--ablation`` edits copies of the tree's sources (f64, n = 10 only; into
``build/k8_k6_ablation/``), builds them in parallel, prints each one's
registers, spills and SASS opcode counts (local loads and stores, shared
and global loads, barriers, fp64 arithmetic) and times each at the paper
grid: K8 at s = 4 with ``built``, ``no operator`` (A_loc replaced by the
identity on the columns), ``no assembly`` (each node's own copy in place
of the gather-scatter sum), ``no grid sync``, ``no Gram``, and the block
shapes ``4 elements a block`` at one block an SM (128 registers) or two
(72); K6 at b = 4 and 1 with ``built`` (lanes in pairs, one element a
block), ``no operator`` (w = p: what is left is the traffic), ``lone
lane's metric through L2`` (read layer by layer, as a pair reads it),
``lanes in fours``, ``single lanes`` (every lane through its own layer
sweep, as K4's operator) and ``at 80 registers`` (a register cap for six
blocks an SM, not four), b = 1 also on the 16x16x16 grid.  A variant that computes another function says so; only
``built`` is held against the plain version.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from scripts.k4_k3_compare import _sass  # noqa: E402  (one SASS reader)

CSRC = ROOT / "src/repro_torch/kernels/csrc"
OUT = ROOT / "build/k8_k6_parent"
ABL = ROOT / "build/k8_k6_ablation"
_P, _I = ctypes.c_void_p, ctypes.c_int
SASS_STEMS = ("nekbone_ax", "nekbone_ax_slab", "nekbone_cg_update",
              "nekbone_pcg_update", "nekbone_cheb_apply")


def _nvcc(cu: pathlib.Path, so: pathlib.Path, dtype: str, *include):
    from repro_torch.kernels import _build

    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-DNEKBONE_REAL_{dtype}",
           *(f"-I{d}" for d in include), "-o", str(so), str(cu)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(procs: dict) -> dict:
    """{key: (proc, so)} -> {key: (so, ptxas log)}; exits on a failed
    build."""
    out = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {key}:\n{log[-4000:]}")
        out[key] = (so, log)
    return out


def build_parent(parent: pathlib.Path) -> dict:
    csrc = parent / "src/repro_torch/kernels/csrc"
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in ("nekbone_ax_powers", "nekbone_ax_slab_block"):
        for dtype in ("F64", "F32"):
            so = OUT / f"{stem}_{dtype.lower()}.so"
            procs[(stem, dtype.lower())] = (_nvcc(csrc / f"{stem}.cu", so,
                                                  dtype), so)
    libs = {}
    for (stem, dt), (so, _) in _wait(procs).items():
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, f"{stem}_{dt}")
        fn.restype = ctypes.c_int
        fn.argtypes = ([_P] * 17 + [_I] * 5 + [_P]
                       if stem == "nekbone_ax_powers"
                       else [_P] * 11 + [_I] * 5 + [_P])
        libs[(stem, dt)] = fn
    return libs


def chain_k8(fn, p2, r2, D, g3, mx, my, mz, cx, cy, cz, inv_theta, *, n, s):
    """The earlier K8: s + 2 launches on the current stream."""
    import torch

    E = p2.shape[0]
    K = 2 * s + 1
    basis = torch.empty(E, 2 * s - 1, n ** 3, dtype=p2.dtype,
                        device=p2.device)
    gram = torch.empty(E, K, K, dtype=p2.dtype, device=p2.device)
    scratch = torch.empty(4, E, n ** 3, dtype=p2.dtype, device=p2.device)
    err = fn(*(t.data_ptr() for t in (p2, r2, D, g3, mx, my, mz, cx, cy, cz,
                                      inv_theta, basis, gram, *scratch)),
             mx.shape[0], my.shape[0], mz.shape[0], n, s,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier K8: CUDA error {err}")
    return basis, gram


def planned_k8(fn, plan, p2, r2, D, g3, mx, my, mz, cx, cy, cz, inv_theta, *,
               n, s):
    """A K8 build launched with a given plan (the wrapper's own call)."""
    import torch

    E = p2.shape[0]
    K = 2 * s + 1
    basis = torch.empty(E, 2 * s - 1, n ** 3, dtype=p2.dtype,
                        device=p2.device)
    gram = torch.empty(E, K, K, dtype=p2.dtype, device=p2.device)
    scratch = torch.empty(4, E, n ** 3, dtype=p2.dtype, device=p2.device)
    err = fn(*(t.data_ptr() for t in (p2, r2, D, g3, mx, my, mz, cx, cy, cz,
                                      inv_theta, basis, gram, *scratch)),
             mx.shape[0], my.shape[0], mz.shape[0], n, s, plan.per_block,
             plan.grid, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K8 with plan {plan}: CUDA error {err}")
    return basis, gram


def block_k6(fn, P, R, D, g3, mx, my, mz, beta, *, n):
    """A K6 build (the earlier one, or an ablation variant)."""
    import torch

    b, E = P.shape[0], P.shape[1]
    p_out, w = torch.empty_like(P), torch.empty_like(P)
    pap = torch.empty(b, E, dtype=P.dtype, device=P.device)
    err = fn(*(t.data_ptr() for t in (P, R, D, g3, mx, my, mz, beta, p_out, w,
                                      pap)),
             mx.shape[0], my.shape[0], mz.shape[0], n, b,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K6 build: CUDA error {err}")
    return p_out, w, pap


def _sstep_case(grid, dtype, seed=7):
    import numpy as np

    import chip_smoke as cs
    from repro_torch.core.nekbone import NekboneCase

    case = NekboneCase(n=10, grid=grid, dtype=dtype)
    o = cs._sstep_inputs(case, np.random.default_rng(seed))
    return case, (o["p"], o["r"], case.D, o["g3"], *o["m"], *o["c"],
                  o["inv_theta"])


def compare_k8(libs, smi):
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import nekbone_ax as K
    from repro_torch.kernels import ref

    print(f"== K8: one cooperative launch beside the chain ({smi})",
          flush=True)
    n = 10
    for E, dtype in ((1024, torch.float64), (4096, torch.float64),
                     (1024, torch.float32)):
        for s in (1, 2, 4):
            plan, info = K.nekbone_ax_powers_plan(
                E, n, s, "f64" if dtype == torch.float64 else "f32")
            print(f"  plan E={E} {dtype} s={s}: grid "
                  f"{plan.grid}, {plan.per_block} elements per block, "
                  f"{plan.blocks_per_sm} blocks per SM, {plan.smem_bytes} "
                  f"bytes dynamic + {info['static_smem']} static shared, "
                  f"{info['registers']} registers, {info['slices']} elements "
                  f"side by side, {info['sm_count']} SMs", flush=True)
    for grid, dtype in ((cs.PAPER_GRID, torch.float64),
                        (cs.BIG_GRID, torch.float64),
                        (cs.PAPER_GRID, torch.float32)):
        case, args = _sstep_case(grid, dtype)
        E = case.mesh.nelt
        chain = libs[("nekbone_ax_powers", "f64" if dtype == torch.float64
                      else "f32")]
        for s in (1, 2, 4):
            nb, ng = K.nekbone_ax_powers_cuda(*args, n=n, s=s)
            cb, cg_ = chain_k8(chain, *args, n=n, s=s)
            pb, pg = K.nekbone_ax_powers_plain(*args, n=n, s=s)
            em = ref.sstep_gram_emulated(args[0], args[1], nb, *args[7:10],
                                         n=n, s=s)
            reps = [K.nekbone_ax_powers_cuda(*args, n=n, s=s)
                    for _ in range(5)]
            torch.cuda.synchronize()
            same = all(torch.equal(b, nb) and torch.equal(g, ng)
                       for b, g in reps)
            gk, gc, gp = ng.sum(0), cg_.sum(0), pg.sum(0)
            print(f"  E={E} {dtype} s={s}: basis bitwise the chain's "
                  f"{torch.equal(nb, cb)}; Gram bitwise the emulated order "
                  f"{torch.equal(ng, em)}; basis max abs err vs plain: new "
                  f"{float((nb - pb).abs().max()):.6e}, chain "
                  f"{float((cb - pb).abs().max()):.6e}; summed Gram max rel "
                  f"err vs plain: new "
                  f"{float((gk - gp).abs().max() / gp.abs().max()):.3e}, "
                  f"chain {float((gc - gp).abs().max() / gp.abs().max()):.3e}"
                  f"; 5 repeats bitwise {same}", flush=True)
            fns = {"chain": lambda: chain_k8(chain, *args, n=n, s=s),
                   "new": lambda: K.nekbone_ax_powers_cuda(*args, n=n, s=s)}
            times = [(lb, cs.device_ms(fns[lb]) * 1e3)
                     for lb in ("chain", "new", "new", "chain")]
            print(f"  E={E} {dtype} s={s} us, in turns: "
                  + ", ".join(f"{lb} {t:.1f}" for lb, t in times),
                  flush=True)
        del args
        torch.cuda.empty_cache()


def compare_k6(libs, smi):
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import nekbone_ax as K
    from repro_torch.kernels import ops

    print(f"== K6: lanes in pairs beside the kernel of one lane at a time "
          f"({smi})", flush=True)
    n = 10
    rng = np.random.default_rng(5)
    for grid in (cs.PAPER_GRID, cs.BIG_GRID):
        for dtype in (torch.float64, torch.float32):
            case = NekboneCase(n=n, grid=grid, dtype=dtype)
            E = case.mesh.nelt
            m, _ = ops.slab_axis_factors(case.grid, n, dtype, "cuda")
            g3 = ops.diag_metric(case.g, E, n)
            old = libs[("nekbone_ax_slab_block",
                        "f64" if dtype == torch.float64 else "f32")]
            for b in (1, 3, 4):
                o = [cs._v2_operands(case, rng) for _ in range(b)]
                P = torch.stack([q["p"] for q in o])
                R = torch.stack([q["r"] for q in o])
                beta = torch.as_tensor(rng.normal(size=b), dtype=dtype,
                                       device="cuda")
                args = (P, R, case.D, g3, *m, beta)
                new = K.nekbone_ax_slab_block_cuda(*args, n=n)
                was = block_k6(old, *args, n=n)
                torch.cuda.synchronize()
                same = all(torch.equal(a, z) for a, z in zip(new, was))
                fns = {"earlier": lambda: block_k6(old, *args, n=n),
                       "new": lambda: K.nekbone_ax_slab_block_cuda(*args,
                                                                   n=n)}
                times = [(lb, cs.device_ms(fns[lb]) * 1e3)
                         for lb in ("earlier", "new", "new", "earlier")]
                print(f"  E={E} {dtype} b={b}: p, w, pap bitwise the earlier "
                      f"K6 {same}; us, in turns: "
                      + ", ".join(f"{lb} {t:.1f}" for lb, t in times),
                      flush=True)
                del o, P, R, args, new, was
            torch.cuda.empty_cache()


def compare_sass(parent: pathlib.Path) -> None:
    print("== SASS of the kernels that share common.cuh, beside the earlier "
          "build (f64)", flush=True)
    procs = {}
    for stem in SASS_STEMS:
        for side, csrc in (("earlier", parent / "src/repro_torch/kernels/csrc"),
                           ("tree", CSRC)):
            so = OUT / f"sass_{side}_{stem}.so"
            procs[(stem, side)] = (_nvcc(csrc / f"{stem}.cu", so, "F64"), so)
    built = {key: _sass(so) for key, (so, _) in _wait(procs).items()}
    for stem in SASS_STEMS:
        old, new = built[(stem, "earlier")], built[(stem, "tree")]
        same = old.keys() == new.keys() and all(old[f] == new[f] for f in old)
        print(f"  {stem}: {len(old)} functions, {sum(map(len, old.values()))} "
              f"instructions; the same SASS: {same}", flush=True)


# --- ablations --------------------------------------------------------------

def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"k8_k6_compare: the source no longer holds {old!r}")
    return src.replace(old, new)


CP_ASYNC = """  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(static_cast<int>(sizeof(T))));"""


def k8_variants(src: str) -> dict[str, str]:
    src = _edit(src, "    NEKBONE_FOR_EACH_N(NEKBONE_CASE)",
                "    NEKBONE_CASE(10)")
    gram = src[src.index("  // the Gram of the owned elements"):
               src.index("template <int N, typename T>\n"
                         "size_t dyn_bytes(")]
    copy = ("#pragma unroll\n    for (int k = 0; k < N; ++k) {{ {0} }}")
    no_op = _edit(
        src, "    ax_diag_columns_lanes(sh, nd.gm, cols, w, i, j);",
        copy.format("w[0][k] = nd.colp[k * N * N]; "
                    "w[1][k] = nd.colr[k * N * N];"))
    no_op = _edit(
        no_op, "    ax_diag_columns(sh.one, nd.gm, SharedColumn<N, T>{nd.colp}, "
               "wp, i, j);",
        copy.format("wp[k] = nd.colp[k * N * N];"))
    four = _edit(src, "kWideMinBlocks<N>", "1").replace("kWideSlices<N>",
                                                         "kSlices<N>")
    return {
        "built": src,
        "no operator": no_op,
        "no assembly": _edit(
            src, "sum_xyz_cg<N>(ad_in, nd.e, k, j, i, nd.ix, nd.iy,\n"
                 "                                     nd.iz, a.ex, a.ey, "
                 "a.ez)",
            "ld_cg(true, ad_in + nd.e * (N * N * N) + (k * N + j) * N + i)"),
        "no grid sync": _edit(src, "    grid.sync();", "    (void)grid;"),
        "no Gram": src.replace(gram, "}\n\n"),
        "4 elements a block, 1 block an SM": four,
        "4 elements a block, 2 blocks an SM": _edit(
            src, "kWideMinBlocks<N>", "kMinBlocks<N>").replace(
                "kWideSlices<N>", "kSlices<N>"),
    }


def k6_variants(src: str) -> dict[str, str]:
    src = _edit(src, "    NEKBONE_FOR_EACH_N(NEKBONE_CASE)",
                "    NEKBONE_CASE(10)")
    start = src.index("  if constexpr (W == 1) {\n    ax_diag_columns_g(")
    end = src.index("ax_diag_columns_lanes(*a.sh, ge, uc, wc, i, j);\n  }\n",
                    start) + len("ax_diag_columns_lanes(*a.sh, ge, uc, wc, i, "
                                 "j);\n  }\n")
    return {
        "built": src,
        "no operator": src[:start] + (
            "#pragma unroll\n  for (int q = 0; q < W; ++q)\n#pragma unroll\n"
            "    for (int k = 0; k < N; ++k)\n"
            "      wc[q][k] = W == 1 ? pc[k] : col[q][k * N2];\n")
        + src[end:],
        "lone lane's metric through L2": _edit(
            src, "    ax_diag_columns_g(\n        a.sh->one, [&gc](int c, int k) "
                 "{ return gc[c][k]; }, pc, wc[0], i,\n        j);",
            "    ax_diag_columns(a.sh->one, ge, pc, wc[0], i, j);"),
        "lanes in fours": _edit(src, "constexpr int kLanes = 2;",
                                "constexpr int kLanes = 4;"),
        "single lanes": _edit(src, "constexpr int kLanes = 2;",
                              "constexpr int kLanes = 1;"),
        "at 80 registers": _edit(src, "min_blocks(N * N, 128)",
                                 "min_blocks(N * N, 80)"),
    }


def _opcodes(so: pathlib.Path) -> dict:
    """Counts of a few SASS opcodes over the library's kernels."""
    import re

    ops = ("LDL", "STL", "LDS", "STS", "LDG", "STG", "LDGSTS", "BAR", "DFMA",
           "DMUL", "DADD")
    body = sum(_sass(so).values(), [])
    return {op: sum(1 for line in body
                    if re.match(rf"(@!?P[T\d]+ )?{op}(\.|\s|$)", line))
            for op in ops}


def build_variants(stem: str, srcs: dict[str, str]) -> dict:
    import chip_smoke as cs

    ABL.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(srcs.items()):
        cu = ABL / f"{stem}_v{i}.cu"
        cu.write_text(text)
        procs[name] = (_nvcc(cu, cu.with_suffix(".so"), "F64", CSRC),
                       cu.with_suffix(".so"))
    libs = {}
    for name, (so, log) in _wait(procs).items():
        report = cs._ptxas_report(log)
        print(f"  {stem} {name}: " + "; ".join(
            f"{key} {regs} registers, {spill} bytes spilled"
            for key, (regs, spill) in sorted(report.items())), flush=True)
        print(f"  {stem} {name} SASS: {_opcodes(so)}", flush=True)
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, f"{stem}_f64")
        fn.restype = ctypes.c_int
        libs[name] = (fn, lib)
    return libs


def variant_plan(lib, E: int, n: int, s: int):
    """The plan a K8 build's own occupancy query gives (k8_plan)."""
    import torch

    from repro_torch.kernels import nekbone_ax as K

    fn = lib.nekbone_ax_powers_query_f64
    fn.argtypes = [_I, _I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int

    def query(resident, dyn):
        out = (ctypes.c_int * 7)()
        if fn(n, int(resident), dyn, out):
            raise RuntimeError("K8 variant: occupancy query failed")
        return tuple(out)

    info = query(False, 0)
    return K.k8_plan(E, n, torch.float64, info[4],
                     lambda res, dyn: query(res, dyn)[0], info[3], s=s,
                     slices=info[6])


def ablate(smi):
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import nekbone_ax as K
    from repro_torch.kernels import ops

    print(f"== K8 and K6 ablations ({smi}); fp64, n = 10, the paper grid",
          flush=True)
    n, s = 10, cs.SSTEP_S
    libs = build_variants("nekbone_ax_powers", k8_variants(
        (CSRC / "nekbone_ax_powers.cu").read_text()))
    case, args = _sstep_case(cs.PAPER_GRID, torch.float64)
    want, _ = K.nekbone_ax_powers_plain(*args, n=n, s=s)
    for name, (fn, lib) in libs.items():
        fn.argtypes = K._ARGTYPES["nekbone_ax_powers"]
        plan = variant_plan(lib, case.mesh.nelt, n, s)
        b, _ = planned_k8(fn, plan, *args, n=n, s=s)
        torch.cuda.synchronize()
        us = cs.device_ms(lambda: planned_k8(fn, plan, *args, n=n, s=s)) * 1e3
        print(f"  K8 E={case.mesh.nelt} s={s} (grid "
              f"{plan.grid}, {plan.blocks_per_sm} blocks an SM), "
              f"{name}: {us:.1f} us; basis max rel err vs plain "
              f"{cs.rel_err(b, want):.2e}", flush=True)
    del args
    libs = build_variants("nekbone_ax_slab_block", k6_variants(
        (CSRC / "nekbone_ax_slab_block.cu").read_text()))
    rng = np.random.default_rng(5)
    E = case.mesh.nelt
    m, _ = ops.slab_axis_factors(case.grid, n, torch.float64, "cuda")
    g3 = ops.diag_metric(case.g, E, n)
    b = cs.BLOCK_B
    o = [cs._v2_operands(case, rng) for _ in range(b)]
    P = torch.stack([q["p"] for q in o])
    R = torch.stack([q["r"] for q in o])
    beta = torch.full((b,), 0.37, dtype=torch.float64, device="cuda")
    k6 = (P, R, case.D, g3, *m, beta)
    _, want, _ = K.nekbone_ax_slab_block_plain(*k6, n=n)
    # one lane on the 16x16x16 grid, where the metric is past L2
    big = NekboneCase(n=n, grid=cs.BIG_GRID, dtype=torch.float64)
    bo = cs._v2_operands(big, rng)
    bm, _ = ops.slab_axis_factors(big.grid, n, torch.float64, "cuda")
    one_big = (bo["p"][None], bo["r"][None], big.D,
               ops.diag_metric(big.g, big.mesh.nelt, n), *bm, beta[:1])
    for name, (fn, _) in libs.items():
        fn.argtypes = [_P] * 11 + [_I] * 5 + [_P]
        _, w, _ = block_k6(fn, *k6, n=n)
        torch.cuda.synchronize()
        us = cs.device_ms(lambda: block_k6(fn, *k6, n=n)) * 1e3
        one = (P[:1], R[:1], case.D, g3, *m, beta[:1])
        us1 = cs.device_ms(lambda: block_k6(fn, *one, n=n)) * 1e3
        us1b = cs.device_ms(lambda: block_k6(fn, *one_big, n=n)) * 1e3
        print(f"  K6 E={E} b={b}, {name}: {us:.1f} us (b=1: {us1:.1f} us; "
              f"b=1 at E={big.mesh.nelt}: {us1b:.1f} us); w max rel err vs "
              f"plain {cs.rel_err(w, want):.2e}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=pathlib.Path,
                    help="a checkout (or archive) of the commit before the "
                         "redesign")
    ap.add_argument("--ablation", action="store_true",
                    help="time edited copies of the tree's K8 and K6")
    args = ap.parse_args()
    if args.parent is None and not args.ablation:
        ap.error("give --parent, --ablation or both")
    import torch

    if not torch.cuda.is_available():
        print("k8_k6_compare.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    # only the libraries this script needs
    _build.SOURCES = {"nekbone_ax_powers": ("f64", "f32"),
                      "nekbone_ax_slab_block": ("f64", "f32")}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    import chip_smoke as cs

    for name, path in _build.build_all().items():
        report = cs._ptxas_report(path.with_suffix(".log").read_text())
        print(f"  {name}: (registers, spill store bytes) at n = 10: "
              + str({key: v for key, v in report.items() if "<10" in key})
              + "; spills elsewhere: "
              + str({key: v[1] for key, v in report.items()
                     if v[1] and "<10" not in key} or "none"), flush=True)
    if args.parent is not None:
        parent = args.parent.resolve()
        libs = build_parent(parent)
        compare_k8(libs, smi)
        compare_k6(libs, smi)
        compare_sass(parent)
    if args.ablation:
        ablate(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
