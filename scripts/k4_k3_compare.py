#!/usr/bin/env python3
"""K4 and K3 (with K2) beside the versions they replaced, and where their
time goes, on one NVIDIA card.

Run from the root of a checkout, with the earlier kernels' sources beside
it (a ``git archive`` of the commit before the redesign, unpacked into a
directory that ``.gitignore`` lists)::

    mkdir -p build/parent_k4k3
    git archive 31327fe src/repro_torch/kernels/csrc | tar -x -C build/parent_k4k3
    python3 scripts/k4_k3_compare.py --parent build/parent_k4k3 [--ablation]

or, for the ablations alone, ``python3 scripts/k4_k3_compare.py
--ablation``.  It builds the port's ``nekbone_ax_slab`` and
``nekbone_ax_dots`` libraries (f64, f32, bf16, bf16_ir) and prints their
registers and spills, and, with ``--parent``, the earlier sources (one
block per element) into ``build/k4_k3_parent/``, then:

* prints the launch plans of K4, K3 and K2 at E = 1024 and 4096 (n = 10) in
  every build;
* shows whether K4's p, w and pap, K3's w and pap and K2's w, pap and rcz
  are bitwise the earlier kernels' in every build at n = 10, 5 and 3 on the
  paper grid, the 16x16x16 grid and a 3x3x5 grid (E = 45), and whether the
  v2 route's 100-iteration history on the paper case (fp64) is bitwise the
  one the earlier K4 gives;
* times both in turns (earlier, new, new, earlier) at n = 10 in every
  build on both grids;
* SASS: builds K1, K5, K6, K8, K10 and K11 (f64) from ``--parent`` and from
  the tree and shows whether ``cuobjdump -sass`` gives each the same
  instructions (the ``common.cuh`` helpers they share).

``--ablation`` splits the time of K4 and K3 (fp64 and bf16, n = 10, both
grids): the built kernel; the same library run with other plans (``no
staging``: every operand read from device memory, prefetched to L2 an
element ahead; ``one stage``: the next element's copy starts only after
the current one's sweep; ``cp.async path``: the per-thread copy in place
of TMA's); and edited copies of the tree's sources (into
``build/k4_k3_ablation/``, n = 10 only, with their registers, spills and
SASS opcode counts): ``no operator`` (w = mask p times the sum of the
node's metric values: what is left is the traffic and the pipeline; run
with its own plan and with the built kernel's), ``D from shared memory`` (the thread's rows and
columns of D read from shared memory as the earlier kernel read them) and
``no staging, no prefetch`` (the loads as the earlier kernel made them, in
the persistent grid), ``at R registers`` (the register cap of 2 to 6 blocks
an SM) and ``D from shared memory at 128 registers``.  A variant that computes another function says so;
only the built kernel is held against the plain version.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "src/repro_torch/kernels/csrc"
OUT = ROOT / "build/k4_k3_parent"
ABL = ROOT / "build/k4_k3_ablation"
_P, _I = ctypes.c_void_p, ctypes.c_int
MIXES = ("f64", "f32", "bf16", "bf16_ir")
# the kernels whose SASS must not move: K1, K5, K6, K8, K10, K11
SASS_STEMS = ("nekbone_ax", "nekbone_cg_update", "nekbone_ax_slab_block",
              "nekbone_ax_powers", "nekbone_pcg_update", "nekbone_cheb_apply")
# the earlier C signatures: the pointers, then E (or ex, ey, ez) and n
PARENT_ARGTYPES = {"nekbone_ax_slab": [_P] * 11 + [_I] * 4 + [_P],
                   "nekbone_ax_pap": [_P] * 6 + [_I] * 2 + [_P],
                   "nekbone_ax_dots": [_P] * 9 + [_I] * 2 + [_P]}
GRID_45 = (3, 3, 5)   # E = 45: no block count divides it evenly


def _nvcc(cu: pathlib.Path, so: pathlib.Path, dtype: str, *include):
    from repro_torch.kernels import _build

    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS,
           f"-DNEKBONE_REAL_{dtype.upper()}", *(f"-I{d}" for d in include),
           "-o", str(so), str(cu)]
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


def _stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream


# --- calls of a library's entry point --------------------------------------

def call_k4(fn, plan, p2, r2, D, g3, mx, my, mz, beta, *, n):
    """K4 through ``fn``: the tree's entry with ``plan`` (a WalkPlan), or
    the earlier one with ``plan`` None."""
    import torch

    E = p2.shape[0]
    p_out, w = torch.empty_like(p2), torch.empty_like(p2)
    pap = torch.empty(E, dtype=beta.dtype, device=p2.device)
    ptrs = (t.data_ptr() for t in (p2, r2, D, g3, mx, my, mz, beta, p_out, w,
                                   pap))
    ints = (mx.shape[0], my.shape[0], mz.shape[0], n)
    ints += plan.launch_ints if plan is not None else ()
    err = fn(*ptrs, *ints, _stream())
    if err:
        raise RuntimeError(f"K4 ({plan}): CUDA error {err}")
    return p_out, w, pap


def call_k3(fn, plan, p2, D, g2, mask2, *rc, n):
    """K3 (or K2, with r and c) through ``fn``, as :func:`call_k4`."""
    import torch

    from repro_torch.kernels import nekbone_ax as K

    E = p2.shape[0]
    acc = K.MIXES[next(m for m, dt in K.MIXES.items()
                       if dt["S"] == p2.dtype and dt["O"] == g2.dtype)]["A"]
    w = torch.empty_like(p2)
    parts = torch.empty(1 + len(rc) // 2, E, dtype=acc, device=p2.device)
    ints = (E, n) + (plan.launch_ints if plan is not None else ())
    err = fn(*(t.data_ptr() for t in (p2, D, g2, mask2, *rc, w, *parts)),
             *ints, _stream())
    if err:
        raise RuntimeError(f"K3 ({plan}): CUDA error {err}")
    return (w, *parts)


def _fn(lib, name: str, argtypes):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _query(lib, stem: str, mix: str):
    """The occupancy query of a walker's entry (common.cuh coop_query)."""
    q = getattr(lib, f"{stem}_query_{mix}")
    q.argtypes = [_I, _I, _I, ctypes.POINTER(ctypes.c_int)]
    q.restype = ctypes.c_int

    def info(n, dyn):
        out = (ctypes.c_int * 7)()
        if q(n, 0, dyn, out):
            raise RuntimeError(f"{stem}_{mix}: occupancy query failed")
        return tuple(out)
    return info


def lib_plan(lib, stem: str, E: int, n: int, mix: str):
    """The plan the tree's planner makes from this library's own
    occupancy (an edited copy may use other registers)."""
    from repro_torch.kernels import nekbone_ax as K

    info = _query(lib, stem, mix)
    base = info(n, 0)
    planner = K.k4_plan if stem == "nekbone_ax_slab" else K.k3_plan
    return planner(E, n, mix, base[4], lambda dyn: info(n, dyn)[0], base[3])


# --- operands ----------------------------------------------------------------

def k4_args(case, rng, mix):
    import chip_smoke as cs

    o = cs._mix_operands(case, rng, mix)
    return (o["p"], o["r"], o["D"], o["g3"], *o["m"], o["beta"])


def k3_args(case, rng, mix, *, dots=False):
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import nekbone_ax as K

    E, n = case.mesh.nelt, case.n
    dt = K.MIXES[mix]
    u, D, g = cs._operator_data(rng, E, n, torch.float64)
    mask = case.mask.reshape(E, n ** 3).contiguous()
    args = (u.to(dt["S"]), D.to(dt["O"]), g.to(dt["O"]), mask.to(dt["S"]))
    if dots:
        r = torch.as_tensor(rng.normal(size=(E, n ** 3)), device="cuda")
        c = case.c.reshape(E, n ** 3).contiguous()
        args += (r.to(dt["S"]), c.to(dt["S"]))
    return args


def _case(n, grid):
    import torch

    from repro_torch.core.nekbone import NekboneCase

    return NekboneCase(n=n, grid=grid, dtype=torch.float64)


# --- earlier beside new --------------------------------------------------------

def build_parent(parent: pathlib.Path) -> dict:
    csrc = parent / "src/repro_torch/kernels/csrc"
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in ("nekbone_ax_slab", "nekbone_ax_dots"):
        for mix in MIXES:
            so = OUT / f"{stem}_{mix}.so"
            procs[(stem, mix)] = (_nvcc(csrc / f"{stem}.cu", so, mix), so)
    for stem in SASS_STEMS:
        for side, src in (("earlier", csrc), ("tree", CSRC)):
            so = OUT / f"sass_{side}_{stem}.so"
            procs[(stem, side)] = (_nvcc(src / f"{stem}.cu", so, "f64"), so)
    built = _wait(procs)
    fns = {}
    for stem in ("nekbone_ax_slab", "nekbone_ax_dots"):
        for mix in MIXES:
            lib = ctypes.CDLL(str(built[(stem, mix)][0]))
            names = (("nekbone_ax_slab",) if stem == "nekbone_ax_slab"
                     else ("nekbone_ax_pap",)
                     + (("nekbone_ax_dots",) if mix in ("f64", "f32")
                        else ()))
            for name in names:
                fns[(name, mix)] = (_fn(lib, f"{name}_{mix}",
                                        PARENT_ARGTYPES[name]), lib)
    return {"fns": fns, "sass": {key: so for key, (so, _) in built.items()
                                 if key[1] in ("earlier", "tree")}}


def print_plans(smi):
    from repro_torch.kernels import nekbone_ax as K

    print(f"== launch plans, n = 10 ({smi})", flush=True)
    for name in ("nekbone_ax_slab", "nekbone_ax_pap", "nekbone_ax_dots"):
        for mix in MIXES:
            if name == "nekbone_ax_dots" and mix not in ("f64", "f32"):
                continue
            for E in (1024, 4096):
                plan, info = K.walk_launch_info(name, E, 10, mix)
                print(f"  {name} {mix} E={E}: grid {plan.grid}, "
                      f"{plan.per_block} elements a block, "
                      f"{plan.blocks_per_sm} blocks an SM on "
                      f"{info['sm_count']} SMs, {plan.stages} stages of "
                      f"{', '.join(plan.staged)} by {plan.copy}, "
                      f"{plan.smem_bytes} bytes dynamic + "
                      f"{info['static_smem']} static shared, "
                      f"{info['registers']} registers", flush=True)


def compare(parent: dict, smi):
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import nekbone_ax as K

    print(f"== K4, K3 and K2 beside the earlier kernels ({smi})", flush=True)
    rng = np.random.default_rng(20)
    old = parent["fns"]
    ok = True
    for n, grid in ((10, cs.PAPER_GRID), (10, cs.BIG_GRID), (5, cs.PAPER_GRID),
                    (3, cs.PAPER_GRID), (5, cs.BIG_GRID), (3, cs.BIG_GRID),
                    (10, GRID_45), (5, GRID_45), (3, GRID_45)):
        case = _case(n, grid)
        E = case.mesh.nelt
        for mix in MIXES:
            a4 = k4_args(case, rng, mix)
            new = K.nekbone_ax_slab_cuda(*a4, n=n)
            was = call_k4(old[("nekbone_ax_slab", mix)][0], None, *a4, n=n)
            same4 = all(torch.equal(a, b) for a, b in zip(new, was))
            a3 = k3_args(case, rng, mix)
            new3 = K.nekbone_ax_pap_cuda(*a3, n=n)
            was3 = call_k3(old[("nekbone_ax_pap", mix)][0], None, *a3, n=n)
            same3 = all(torch.equal(a, b) for a, b in zip(new3, was3))
            line = (f"  n={n} E={E} {mix}: K4 p, w, pap bitwise the earlier "
                    f"{same4}; K3 w, pap {same3}")
            ok &= same4 and same3
            if mix in ("f64", "f32"):
                a2 = k3_args(case, rng, mix, dots=True)
                new2 = K.nekbone_ax_dots_cuda(*a2, n=n)
                was2 = call_k3(old[("nekbone_ax_dots", mix)][0], None, *a2,
                               n=n)
                same2 = all(torch.equal(a, b) for a, b in zip(new2, was2))
                line += f"; K2 w, pap, rcz {same2}"
                if not same2:
                    again = K.nekbone_ax_dots_cuda(*a2, n=n)
                    again_old = call_k3(old[("nekbone_ax_dots", mix)][0],
                                        None, *a2, n=n)
                    line += " (" + ", ".join(
                        f"{nm}: {int((a != b).sum())} of {a.numel()} differ, "
                        f"max abs {float((a - b).abs().max()):.3e}"
                        for nm, a, b in zip(("w", "pap", "rcz"), new2, was2)
                    ) + "; repeated: new " + str(all(
                        torch.equal(a, b) for a, b in zip(again, new2)))
                    line += ", earlier " + str(all(
                        torch.equal(a, b) for a, b in zip(again_old, was2)))
                    line += f"; K2's w, pap bitwise K3's on the same inputs: "
                    line += str(all(torch.equal(a, b) for a, b in zip(
                        new2[:2], K.nekbone_ax_pap_cuda(*a2[:4], n=n))))
                    line += ")"
                ok &= same2
            print(line, flush=True)
        del case
        torch.cuda.empty_cache()
    # the v2 route on the paper case with either K4
    from repro_torch.core.nekbone import NekboneCase

    v2 = NekboneCase(n=10, grid=cs.PAPER_GRID, dtype=torch.float64,
                     ax_impl="pallas_fused_cg_v2")
    _, f = v2.manufactured()
    res = v2.solve(f, niter=cs.NITER)
    fn = old[("nekbone_ax_slab", "f64")][0]
    saved = K.nekbone_ax_slab_cuda
    K.nekbone_ax_slab_cuda = lambda *a, n: call_k4(fn, None, *a, n=n)
    try:
        was = v2.solve(f, niter=cs.NITER)
    finally:
        K.nekbone_ax_slab_cuda = saved
    same = (torch.equal(res.history, was.history)
            and torch.equal(res.x, was.x))
    ok &= same
    print(f"  v2, paper case, {cs.NITER} iterations (fp64): history and x "
          f"bitwise the earlier K4's {same} (history[{cs.NITER}] "
          f"{float(res.history[-1]):.6e})", flush=True)
    print(f"  every output bitwise the earlier kernels': {ok}", flush=True)
    # times in turns, n = 10
    for grid in (cs.PAPER_GRID, cs.BIG_GRID):
        case = _case(10, grid)
        E = case.mesh.nelt
        for mix in MIXES:
            a4 = k4_args(case, rng, mix)
            a3 = k3_args(case, rng, mix)
            o4, o3 = (old[("nekbone_ax_slab", mix)][0],
                      old[("nekbone_ax_pap", mix)][0])
            for label, fns in (
                    ("K4", {"earlier": lambda: call_k4(o4, None, *a4, n=10),
                            "new": lambda: K.nekbone_ax_slab_cuda(*a4,
                                                                  n=10)}),
                    ("K3", {"earlier": lambda: call_k3(o3, None, *a3, n=10),
                            "new": lambda: K.nekbone_ax_pap_cuda(*a3,
                                                                 n=10)})):
                times = [(lb, cs.device_ms(fns[lb]) * 1e3)
                         for lb in ("earlier", "new", "new", "earlier")]
                print(f"  {label} {mix} E={E} us, in turns: "
                      + ", ".join(f"{lb} {t:.1f}" for lb, t in times),
                      flush=True)
            if mix in ("f64", "f32"):
                a2 = k3_args(case, rng, mix, dots=True)
                o2 = old[("nekbone_ax_dots", mix)][0]
                fns = {"earlier": lambda: call_k3(o2, None, *a2, n=10),
                       "new": lambda: K.nekbone_ax_dots_cuda(*a2, n=10)}
                times = [(lb, cs.device_ms(fns[lb]) * 1e3)
                         for lb in ("earlier", "new", "new", "earlier")]
                print(f"  K2 {mix} E={E} us, in turns: "
                      + ", ".join(f"{lb} {t:.1f}" for lb, t in times),
                      flush=True)
        del case
        torch.cuda.empty_cache()
    return ok


def _sass_key(name: str):
    """A kernel's SASS name without its type arguments: (name, its integer
    and bool template arguments), so that an instantiation keeps its key
    when a source gains type parameters."""
    m = re.match(r"_ZN\d+nekbone\d+([A-Za-z_0-9]+?)I", name)
    if m is None:
        return name
    return m.group(1), tuple(re.findall(r"L[ib](\d+)E", name))


def _sass(so: pathlib.Path) -> dict[str, list[str]]:
    """{function: its instructions} from ``cuobjdump -sass``, addresses and
    encodings dropped."""
    from repro_torch.kernels import _build

    cuobjdump = pathlib.Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, timeout=300).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        out[_sass_key(name.strip())] = [
            re.sub(r"/\*[^*]*\*/", "", line).strip()
            for line in body.splitlines() if re.match(r"\s+/\*[0-9a-f]{4}\*/",
                                                       line)]
    return out


def compare_sass(parent: dict) -> bool:
    print("== SASS of the kernels that share common.cuh, beside the earlier "
          "build (f64)", flush=True)
    ok = True
    for stem in SASS_STEMS:
        old = _sass(parent["sass"][(stem, "earlier")])
        new = _sass(parent["sass"][(stem, "tree")])
        same = old.keys() == new.keys() and all(old[f] == new[f] for f in old)
        ok &= same
        print(f"  {stem}: {len(old)} functions, {sum(map(len, old.values()))} "
              f"instructions; the same SASS: {same}", flush=True)
    return ok


# --- ablations --------------------------------------------------------------

def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"k4_k3_compare: the source no longer holds {old!r}")
    return src.replace(old, new)


# thread (i, j)'s rows and columns of D read from shared memory, as the
# kernel of one block per element read them
D_SHARED = """
namespace nekbone {
template <int N, typename T>
struct DShared {
  const AxShared<N, T>* sh;
  int i, j;
  __device__ __forceinline__ T ri(int l) const { return sh->Dt[l][i]; }
  __device__ __forceinline__ T rj(int l) const { return sh->D[j][l]; }
  __device__ __forceinline__ T ci(int l) const { return sh->D[l][i]; }
  __device__ __forceinline__ T cj(int l) const { return sh->D[l][j]; }
};
}  // namespace nekbone
"""


def variants(stem: str, src: str) -> dict[str, str]:
    src = _edit(src, "    NEKBONE_FOR_EACH_N(NEKBONE_CASE)",
                "    NEKBONE_CASE(10)")
    call = "    ax_columns_dregs(\n        sh, dr,"
    start = src.index(call)
    end = src.index("        pc, wc, i, j);\n", start) + len(
        "        pc, wc, i, j);\n")
    # w = p scaled by the sum of the node's metric values: the operator's
    # reads of the metric stay, its layer sweep goes
    comps = 3 if stem == "nekbone_ax_slab" else 6
    metric = " + ".join(f"convert<A>(ge[{c} * N3 + k * N2])"
                        for c in range(comps))
    identity = ("#pragma unroll\n    for (int k = 0; k < N; ++k) "
                f"wc[k] = pc[k] * ({metric});\n")
    d_shared = _edit(
        src, '#include "common.cuh"\n', '#include "common.cuh"\n' + D_SHARED)
    d_shared = _edit(d_shared, "  DRegs<N, A> dr;\n  dr.load(a.D, i, j);\n",
                     "  const DShared<N, A> dr{&sh, i, j};\n")
    start_p = src.index("    if (t + 1 < count)")
    end_p = src.index("    const size_t base = e * N3 + tid;", start_p) \
        if stem == "nekbone_ax_dots" else \
        src.index("    const int ix = ", start_p)
    out = {
        "built": src,
        "no operator": src[:start] + identity + src[end:],
        "D from shared memory": d_shared,
        "no staging, no prefetch": src[:start_p] + src[end_p:],
    }
    # register caps: the blocks an SM __launch_bounds__ asks for (at most
    # 65536 / (blocks x 128) registers a thread)
    for blocks, regs in ((2, 255), (3, 168), (4, 128), (5, 96), (6, 80)):
        out[f"at {regs} registers"] = _edit(
            src, "__launch_bounds__(N * N, kWalkMinBlocks<N, A>)",
            f"__launch_bounds__(N * N, {blocks})")
    out["D from shared memory at 128 registers"] = _edit(
        d_shared, "__launch_bounds__(N * N, kWalkMinBlocks<N, A>)",
        "__launch_bounds__(N * N, 4)")
    return out


def _opcodes(so: pathlib.Path) -> dict:
    """Counts of a few SASS opcodes over the library's kernels."""
    ops = ("LDL", "STL", "LDS", "STS", "LDG", "STG", "LDGSTS", "UBLKCP",
           "SYNCS", "BAR", "DFMA", "FFMA")
    body = sum(_sass(so).values(), [])
    return {"all": len(body)} | {
        op: sum(1 for line in body
                if re.match(rf"(@!?U?P[T\d]+ )?{op}(\.|\s|$)", line))
        for op in ops}


def build_variants() -> dict:
    import chip_smoke as cs

    ABL.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in ("nekbone_ax_slab", "nekbone_ax_dots"):
        texts = variants(stem, (CSRC / f"{stem}.cu").read_text())
        for v, (name, text) in enumerate(texts.items()):
            cu = ABL / f"{stem}_v{v}.cu"
            cu.write_text(text)
            for mix in ("f64", "bf16"):
                so = ABL / f"{stem}_v{v}_{mix}.so"
                procs[(stem, name, mix)] = (_nvcc(cu, so, mix, CSRC), so)
    libs = {}
    for key, (so, log) in _wait(procs).items():
        stem, name, mix = key
        report = cs._ptxas_report(log)
        print(f"  {stem} {mix} {name}: " + "; ".join(
            f"{k} {regs} registers, {spill} bytes spilled"
            for k, (regs, spill) in sorted(report.items())), flush=True)
        print(f"  {stem} {mix} {name} SASS: {_opcodes(so)}", flush=True)
        libs[key] = ctypes.CDLL(str(so))
    return libs


def ablate(smi):
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import nekbone_ax as K

    print(f"== K4 and K3 ablations ({smi}); n = 10", flush=True)
    libs = build_variants()
    variant_names = list(dict.fromkeys(name for _, name, _ in libs))
    rng = np.random.default_rng(21)
    for grid in (cs.PAPER_GRID, cs.BIG_GRID):
        case = _case(10, grid)
        E = case.mesh.nelt
        for mix in ("f64", "bf16"):
            a4 = k4_args(case, rng, mix)
            a3 = k3_args(case, rng, mix)
            _, want4, _ = K.nekbone_ax_slab_plain(*a4, n=10)
            want3, _ = K.nekbone_ax_pap_plain(*a3, n=10)
            for stem, name, call, args, want in (
                    ("nekbone_ax_slab", "nekbone_ax_slab", call_k4, a4,
                     want4),
                    ("nekbone_ax_dots", "nekbone_ax_pap", call_k3, a3,
                     want3)):
                runs = []
                for variant in variant_names:
                    lib = libs[(stem, variant, mix)]
                    fn = _fn(lib, f"{name}_{mix}", K._ARGTYPES[name])
                    plan = lib_plan(lib, name, E, 10, mix)
                    if variant == "no staging, no prefetch":
                        plan = dataclasses.replace(plan, staged=(),
                                                   smem_bytes=0)
                    runs.append((variant, fn, plan))
                    if variant == "no operator":
                        # the same traffic under the built kernel's plan
                        runs.append(("no operator, the built plan", fn,
                                     built))
                    if variant == "built":
                        built = plan
                        none = dataclasses.replace(plan, staged=(),
                                                   smem_bytes=0)
                        one = dataclasses.replace(
                            plan, stages=1, smem_bytes=plan.smem_bytes // 2)
                        runs += [("no staging", fn, none),
                                 ("one stage", fn, one)]
                        if plan.bulk:
                            slot = K.walk_slot_bytes
                            ops = (K.k4_operands(10, mix)
                                   if name == "nekbone_ax_slab"
                                   else K.k3_operands(10, mix))
                            asyn = dataclasses.replace(
                                plan, bulk=False, smem_bytes=plan.stages * sum(
                                    slot(ops[k], False) for k in plan.staged))
                            runs.append(("cp.async path", fn, asyn))
                for variant, fn, plan in runs:
                    out = call(fn, plan, *args, n=10)
                    torch.cuda.synchronize()
                    us = cs.device_ms(lambda: call(fn, plan, *args,
                                                   n=10)) * 1e3
                    w = out[1] if name == "nekbone_ax_slab" else out[0]
                    err = cs.rel_err(w.double(), want.double())
                    print(f"  {name} {mix} E={E}, {variant}: {us:.1f} us "
                          f"(grid {plan.grid}, {plan.blocks_per_sm} blocks "
                          f"an SM, {plan.stages} stages of "
                          f"{', '.join(plan.staged) or 'nothing'} by "
                          f"{plan.copy}); w max rel err vs plain {err:.2e}",
                          flush=True)
        del case
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=pathlib.Path,
                    help="a checkout (or archive) of the commit before the "
                         "redesign")
    ap.add_argument("--ablation", action="store_true",
                    help="time other plans and edited copies of the tree's "
                         "K4 and K3")
    args = ap.parse_args()
    if args.parent is None and not args.ablation:
        ap.error("give --parent, --ablation or both")
    import torch

    if not torch.cuda.is_available():
        print("k4_k3_compare.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    # only the libraries this script needs
    _build.SOURCES = {"nekbone_ax_slab": MIXES, "nekbone_ax_dots": MIXES,
                      "nekbone_cg_update": ("f64",)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    import chip_smoke as cs

    for name, path in _build.build_all().items():
        report = cs._ptxas_report(path.with_suffix(".log").read_text())
        print(f"  {name}: (registers, spill store bytes) at n = 10, 5, 3: "
              + str({key: v for key, v in report.items()
                     if re.search(r"<(10|5|3)(,|>)", key)})
              + "; spills elsewhere: "
              + str({key: v[1] for key, v in report.items()
                     if v[1] and not re.search(r"<(10|5|3)(,|>)", key)}
                    or "none"), flush=True)
    print_plans(smi)
    ok = True
    if args.parent is not None:
        parent = build_parent(args.parent.resolve())
        ok &= compare(parent, smi)
        ok &= compare_sass(parent)
    if args.ablation:
        ablate(smi)
    print(f"k4_k3_compare: {'every check held' if ok else 'A CHECK FAILED'}",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
