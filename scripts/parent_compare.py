#!/usr/bin/env python3
"""The port's kernels beside an earlier commit's, on one NVIDIA card.

Run from the root of a checkout, with the earlier kernels' sources beside
it (a ``git archive`` of the earlier commit, unpacked into a directory that
``.gitignore`` lists)::

    mkdir -p build/parent
    git archive 95e9697 src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 scripts/parent_compare.py --parent build/parent --builds \\
        nekbone_ax_f64 nekbone_ax_f32 nekbone_ax_dots_f64 \\
        nekbone_ax_dots_f32 flash_attn_f32 flash_attn_bf16

It builds the earlier sources' libraries named by ``--builds``
(``<stem>_<dtype>``) into ``build/parent_compare/`` and the tree's
libraries of the same stems (every build of each), one ``nvcc`` each, all
in parallel, then:

* SASS: for each earlier Nekbone library, shows whether ``cuobjdump
  -sass`` gives it the same instructions as the tree's (paired by kernel
  and its integer template arguments, so a source that gains type
  parameters keeps its keys);
* for the stems that have one, the stem's check below, with the earlier
  library loaded in place of the tree's (:func:`swapped`):

  - ``nekbone_ax`` (K1): the fp64 reference CG on the paper case
    (``ax_impl="pallas"``, 100 iterations) gives bitwise the same history
    and x over the earlier K1;
  - ``nekbone_ax_dots`` (K2): K2's fp64 w, pap and rcz at E = 1024, n = 10
    are bitwise the earlier K2's;
  - ``flash_attn`` (K13): the outputs at d = 16 and 128 (gemma2-27b's
    heads, batch 1, 2048 tokens, global and window 1024, softcap 50) in
    both builds are bitwise the earlier kernels'; each build is timed in
    turns (:func:`in_turns`) at gemma2's global layer; and the bf16 build
    at nemotron-4-340b's global layer (batch 2, 4096 tokens, d 192) is
    timed in turns with an edited copy that loads Q's fragments again for
    each key tile in place of keeping them in registers, each held to the
    plain version by ``chip_smoke.py``'s bf16 value check, with the
    registers, spills and shared memory of every K13 instantiation.

It exits 1 if a check fails.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build/parent_compare"
# K13's edited copy: Q's fragments loaded for each 16-deep step of Q K^T
Q_LOAD = """      ldmatrix_x4(qf[0], smem_addr(qs + (warp * 16 + (lane & 15)) * S +
                                   kk * 16 + (lane >> 4) * 8));
"""
Q_RELOAD = (
    ("  uint32_t qf[DK][4];\n", "  uint32_t qf[1][4];\n"),
    ("""    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        ldmatrix_x4(qf[kk], smem_addr(qs + (warp * 16 + (lane & 15)) * S +
                                      kk * 16 + (lane >> 4) * 8));
    }
""", ""),
    ("""    for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
""", """    for (int kk = 0; kk < DK; ++kk) {
""" + Q_LOAD + """#pragma unroll
      for (int j = 0; j < NT; j += 2) {
"""),
    ("mma(s[j], qf[kk], bk[0], bk[1]);", "mma(s[j], qf[0], bk[0], bk[1]);"),
    ("mma(s[j + 1], qf[kk], bk[2], bk[3]);",
     "mma(s[j + 1], qf[0], bk[2], bk[3]);"))


# --- the machinery ----------------------------------------------------------

def start_build(cu: pathlib.Path, so: pathlib.Path, dtype: str):
    """One ``nvcc`` of ``cu`` for ``dtype`` with the package's flags,
    started; :func:`wait_builds` collects it."""
    from repro_torch.kernels import _build

    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS,
           f"-DNEKBONE_REAL_{dtype.upper()}", "-o", str(so), str(cu)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def wait_builds(procs: dict) -> dict:
    """``{key: (proc, so)}`` -> ``{key: so}``, the ptxas log beside each
    library; exits on a failed build."""
    built = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {key}:\n{log[-4000:]}")
        so.with_suffix(".log").write_text(log)
        built[key] = so
    return built


def edited(stem: str, edits, tag: str) -> pathlib.Path:
    """A copy of the tree's ``<stem>.cu`` with each ``(old, new)`` of
    ``edits`` made (each ``old`` must occur once), written beside the tree's
    headers' copies in ``OUT``."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / f"{stem}.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"{stem}.cu no longer holds {old!r} once")
        src = src.replace(old, new)
    for header in _build.CSRC.glob("*.cuh"):
        (OUT / header.name).write_text(header.read_text())
    path = OUT / f"{stem}_{tag}.cu"
    path.write_text(src)
    return path


@contextlib.contextmanager
def swapped(libs: dict):
    """The libraries ``{tree library name: path}`` loaded in place of the
    tree's ones of those names, for the ``with`` block."""
    from repro_torch.kernels import _build

    saved = {name: _build._LIBS[name] for name in libs}
    for name, path in libs.items():
        _build._LIBS[name] = ctypes.CDLL(str(path))
    try:
        yield
    finally:
        _build._LIBS.update(saved)


def in_turns(fn, other, *, labels=("earlier", "tree")) -> dict:
    """Device ms of ``fn()`` in turns: under ``other`` (a context manager
    factory), as it is, as it is, under ``other``; ``{label: [ms, ms]}``."""
    import chip_smoke as cs

    times = {label: [] for label in labels}
    for turn in (0, 1, 1, 0):
        with other() if turn == 0 else contextlib.nullcontext():
            times[labels[turn]].append(cs.device_ms(fn, calls=3, reps=3))
    return times


def _sass_key(name: str):
    """A kernel's SASS name without its type arguments: (name, its integer
    and bool template arguments)."""
    m = re.match(r"_ZN\d+nekbone\d+([A-Za-z_0-9]+?)I", name)
    if m is None:
        return name
    return m.group(1), tuple(re.findall(r"L[ib](\d+)E", name))


def sass(so: pathlib.Path) -> dict:
    """{kernel: its instructions} from ``cuobjdump -sass``, addresses and
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
            for line in body.splitlines()
            if re.match(r"\s+/\*[0-9a-f]{4}\*/", line)]
    return out


def compare_sass(earlier: dict, tree: dict) -> bool:
    print("== SASS beside the earlier sources", flush=True)
    ok = True
    for name, so in earlier.items():
        old, new = sass(so), sass(tree[name])
        same = old.keys() == new.keys() and all(old[k] == new[k] for k in old)
        ok &= same
        print(f"  {name}: {len(old)} kernels, "
              f"{sum(map(len, old.values()))} instructions; the same SASS: "
              f"{same}", flush=True)
    return ok


# --- the checks of one stem -------------------------------------------------

def check_k1(earlier: dict, tree: dict, extra: dict) -> bool:
    import torch

    import chip_smoke as cs
    from repro_torch.core.nekbone import NekboneCase

    case = NekboneCase(n=10, grid=cs.PAPER_GRID, dtype=torch.float64,
                       ax_impl="pallas")
    _, f = case.manufactured()
    tree = case.solve(f, niter=cs.NITER)
    with swapped({"nekbone_ax_f64": earlier["nekbone_ax_f64"]}):
        old = case.solve(f, niter=cs.NITER)
    same = (torch.equal(tree.history, old.history)
            and torch.equal(tree.x, old.x))
    print(f"== K1: fp64 reference CG ({cs.NITER} iterations, paper case): "
          f"history[{cs.NITER}] {float(tree.history[cs.NITER]):.6e}; "
          f"history and x bitwise the earlier K1's: {same}", flush=True)
    return same


def check_k2(earlier: dict, tree: dict, extra: dict) -> bool:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import nekbone_ax as K

    case = NekboneCase(n=10, grid=cs.PAPER_GRID, dtype=torch.float64)
    rng = np.random.default_rng(5)
    E, n3 = case.mesh.nelt, 1000
    u, D, g = cs._operator_data(rng, E, 10, torch.float64)
    r = torch.as_tensor(rng.normal(size=(E, n3)), device="cuda")
    args = (u, D, g, case.mask.reshape(E, n3).contiguous(), r,
            case.c.reshape(E, n3).contiguous())
    tree = K.nekbone_ax_dots_cuda(*args, n=10)
    with swapped({"nekbone_ax_dots_f64": earlier["nekbone_ax_dots_f64"]}):
        old = K.nekbone_ax_dots_cuda(*args, n=10)
    same = all(torch.equal(a, b) for a, b in zip(tree, old))
    print(f"== K2 fp64 (E={E}, n=10): w, pap and rcz bitwise the earlier "
          f"K2's: {same}", flush=True)
    return same


def _k13_report(tree: dict, reload: pathlib.Path) -> None:
    import chip_smoke as cs

    print("== K13 instantiations: registers, spill stores, dynamic shared "
          "memory", flush=True)
    libs = {f"tree {name}": path for name, path in tree.items()
            if name.startswith("flash_attn")}
    libs["Q reloaded per key tile (edited copy)"] = reload
    for label, path in libs.items():
        report = cs._ptxas_report(path.with_suffix(".log").read_text())
        lib = ctypes.CDLL(str(path))
        mix = "bf16" if "bf16" in path.name else "f32"
        smem = getattr(lib, f"flash_attn_{mix}_smem_bytes")
        smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
        print(f"  {label}: " + "; ".join(
            f"{key} {regs} registers, {spill} B spilled, "
            f"{smem(int(key.split('<')[1][:-1]))} B shared"
            for key, (regs, spill) in sorted(report.items())), flush=True)


def check_k13(earlier: dict, tree: dict, extra: dict) -> bool:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import ref

    _k13_report(tree, extra["qreload"])
    print("== K13 at d = 16 and 128 beside the earlier kernels; d = 192 "
          "with Q kept in registers or reloaded", flush=True)
    gen = torch.Generator("cuda").manual_seed(11)
    Hq, Hkv, d = (cs.GEMMA_HEADS[key] for key in ("Hq", "Hkv", "d"))
    old = {name: so for name, so in earlier.items()
           if name.startswith("flash_attn")}
    ok = True
    for dtype in (torch.bfloat16, torch.float32):
        for dd, shape in ((d, dict(B=1, Hq=Hq, Hkv=Hkv, Sq=2048, Skv=2048)),
                          (16, dict(B=2, Hq=4, Hkv=2, Sq=300, Skv=300))):
            q, k, v = cs._k13_inputs(gen, d=dd, dtype=dtype, **shape)
            for window in (None, 1024):
                kw = dict(causal=True, window=window, softcap=50.0,
                          q_offset=0, scale=dd ** -0.5)
                new = FA.flash_attention_cuda(q, k, v, **kw)
                with swapped(old):
                    same = torch.equal(new, FA.flash_attention_cuda(q, k, v,
                                                                    **kw))
                ok &= same
                print(f"  {dtype} d={dd} window {window}: bitwise the "
                      f"earlier kernel's: {same}", flush=True)
    kw = dict(causal=True, window=None, softcap=50.0, q_offset=0,
              scale=d ** -0.5)
    for dtype, B, S in ((torch.bfloat16, 2, 6144), (torch.float32, 1, 2048)):
        q, k, v = cs._k13_inputs(gen, B, Hq, Hkv, S, S, d, dtype)
        times = in_turns(lambda: FA.flash_attention_cuda(q, k, v, **kw),
                         lambda: swapped(old))
        print(f"  {dtype} gemma2 global layer (B={B}, S={S}): "
              + "; ".join(f"{label} " + ", ".join(f"{t:.4f}" for t in ts)
                          + " ms" for label, ts in times.items()),
              flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    Hq, Hkv, d = (cs.NEMOTRON_HEADS[key] for key in ("Hq", "Hkv", "d"))
    B, S = 2, 4096
    q, k, v = cs._k13_inputs(gen, B, Hq, Hkv, S, S, d, torch.bfloat16)
    kw = dict(causal=True, window=None, softcap=None, q_offset=0,
              scale=d ** -0.5)
    want = ref.flash_attention_plain(q, k, v, **kw)
    reload = {"flash_attn_bf16": extra["qreload"]}
    for label, ctx in (("in registers", contextlib.nullcontext),
                       ("reloaded", lambda: swapped(reload))):
        with ctx():
            val = cs._value_rel(FA.flash_attention_cuda(q, k, v, **kw),
                                want, cs.K13_TOL["float32"])
        ok &= val <= 1.0
        print(f"  bf16 nemotron global layer (B=2, S=4096, d 192), Q "
              f"{label}: value check {val:.2f} of its limit", flush=True)
    flops = 4 * d * B * Hq * cs._attn_pairs(S, S, True, None)
    times = in_turns(lambda: FA.flash_attention_cuda(q, k, v, **kw),
                     lambda: swapped(reload),
                     labels=("reloaded", "in registers"))
    print("  bf16 nemotron global layer, Q " + "; ".join(
        f"{label} " + ", ".join(f"{t:.4f} ms ({flops / t / 1e9:.1f} TF/s)"
                                for t in ts)
        for label, ts in times.items()), flush=True)
    return ok


# {stem: (its check, {tag: (dtype, edits of the tree's source)})}
CHECKS = {"nekbone_ax": (check_k1, {}),
          "nekbone_ax_dots": (check_k2, {}),
          "flash_attn": (check_k13, {"qreload": ("bf16", Q_RELOAD)})}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True,
                    help="a checkout (or archive) of the earlier commit")
    ap.add_argument("--builds", nargs="+", required=True,
                    help="the earlier libraries to build and compare, "
                         "<stem>_<dtype> (nekbone_ax_f64, flash_attn_bf16)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("parent_compare.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    builds = [_build.split_name(name) for name in args.builds]
    stems = list(dict.fromkeys(stem for stem, _ in builds))
    unknown = [f"{stem}_{dtype}" for stem, dtype in builds
               if dtype not in _build.SOURCES.get(stem, ())]
    if unknown:
        raise SystemExit(f"the package builds none of {unknown}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    # only the libraries compared
    _build.SOURCES = {stem: _build.SOURCES[stem] for stem in stems}
    csrc = args.parent.resolve() / "src/repro_torch/kernels/csrc"
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {f"{stem}_{dtype}": start_build(
        csrc / f"{stem}.cu", OUT / f"{stem}_{dtype}.so", dtype)
        for stem, dtype in builds}
    for stem in stems:
        for tag, (dtype, edits) in CHECKS.get(stem, (None, {}))[1].items():
            procs[tag] = start_build(edited(stem, edits, tag),
                                     OUT / f"{stem}_{tag}_{dtype}.so", dtype)
    tree = _build.build_all()
    built = wait_builds(procs)
    earlier = {name: so for name, so in built.items() if name in tree}
    extra = {tag: so for tag, so in built.items() if tag not in tree}
    ok = compare_sass({name: so for name, so in earlier.items()
                       if name.startswith("nekbone_")}, tree)
    for stem in stems:
        if stem in CHECKS:
            ok &= CHECKS[stem][0](earlier, tree, extra)
    print(f"parent_compare: {'every check held' if ok else 'A CHECK FAILED'}",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
