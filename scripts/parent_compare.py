#!/usr/bin/env python3
"""The port's kernels beside an earlier commit's, on one NVIDIA card.

Run from the root of a checkout, with the earlier kernels' sources beside
it (a ``git archive`` of the earlier commit, unpacked into a directory that
``.gitignore`` lists)::

    mkdir -p build/parent
    git archive 3b06939 src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 scripts/parent_compare.py --parent build/parent --builds \\
        nekbone_pcg_update nekbone_interp nekbone_ax nekbone_sstep_update \\
        nekbone_ax_slab nekbone_cg_update nekbone_cheb_apply \\
        nekbone_ax_slab_block nekbone_cg_update_block nekbone_ax_dots \\
        nekbone_ax_powers --changed nekbone_pcg_update nekbone_interp

(3b06939 is the commit before K10's and K12's redesigns, whose stems are
``--changed`` here; a98a22e the one before K1's and K9's.)

It builds the earlier sources' libraries named by ``--builds``
(``<stem>_<dtype>``, or a stem alone for every build of it) into
``build/parent_compare/`` and the tree's
libraries of the same stems (every build of each), one ``nvcc`` each, all
in parallel, then:

* SASS: for each earlier Nekbone library, shows whether ``cuobjdump
  -sass`` gives it the same instructions as the tree's (paired by kernel
  and its integer template arguments, so a source that gains type
  parameters keeps its keys); it must, but for the stems named by
  ``--changed`` (kernels the tree redesigned), which are only reported;
* for the stems of ``--changed`` that have one, the stem's check below,
  with the earlier library loaded in place of the tree's (:func:`swapped`)
  or called through its own C signature (each check's ``earlier_*``):

  - ``nekbone_ax`` (K1): w at E = 1024 and 4096, n = 10 and 5, bitwise
    the earlier kernel's in every build compared (the earlier library
    called through its own C signature, ``earlier_k1``); the fp64
    reference CG on the paper case (``ax_impl="pallas"``, 100 iterations)
    gives bitwise the same history and x over the earlier K1; each build
    timed in turns against the earlier library at n = 10, E = 1024 and
    4096, with its launch plan, registers and spills, and held to at most
    1.03 times the earlier time; and the sweep ablations, edited copies of
    ``nekbone_ax.cu`` each timed in turns with the tree's, its w bitwise
    the tree's: the same walker with K3's scalar sweep
    (``ax_columns_dregs``, ``SCALAR_SWEEP``), and with a sweep that also
    reads the strided u[l][i] and s[l][i] as vectors, from transposed
    copies of the layers (``TRANSPOSED_SWEEP``); and the tree's K1 on the
    plan of the scalar copy, whose larger static shared memory may stage
    less, which parts the plan's share from the sweep's;
  - ``nekbone_ax_dots`` (K2): K2's fp64 w, pap and rcz at E = 1024, n = 10
    are bitwise the earlier K2's;
  - ``nekbone_cg_update`` (K5) and ``nekbone_cg_update_block`` (K7, b =
    1..4): x, r and rcr at E = 1024 and 4096, n = 10 and 5, bitwise the
    earlier kernels' in every build compared (the earlier libraries called
    through their own C signatures, one block an element); for K5 also the
    fp64 v2 CG on the paper case (100 iterations) over the earlier K5,
    history and x bitwise; each build timed in turns against the earlier
    library at E = 1024 and 4096 (K7 at b = 4), with the launch plan and
    registers, and held to at most 1.03 times the earlier time (the bf16
    K7 at E = 1024 to at most half of it); and the ring-off ablation timed
    in turns with the walker:
    the same library launched with this script's planner, which stages
    nothing, so that the walker reads x, p, r and w from device memory at
    the residency its registers allow;
  - ``nekbone_sstep_update`` (K9): x, r, p and rcr at s = 1, 2, 4, E =
    1024 and 4096, n = 10 and 5, bitwise the earlier kernel's in every
    build compared (``earlier_k9``); the fp64 s-step CG on the paper case
    (s = 4, 100 iterations) over the earlier K9, history and x bitwise;
    each build timed in turns against the earlier library at s = 1, 2, 4,
    10, n = 10, E = 1024 and 4096, held to at most 1.03 times the earlier
    time, and beside an edited copy whose column loop is rolled
    (``ROLLED_COLUMNS``: the pointer picked in the loop, its trip count
    2s + 1), outputs bitwise; and, in fp64 at s = 4, the chosen plan timed
    in turns against the ring-off plan and against a plan that stages x, p
    and r only (``xpr_plan``), outputs bitwise; and for the stems of
    ``--changed`` the CPU seconds of each library's ``nvcc``, the earlier,
    the tree's and the edited copies';
  - ``nekbone_pcg_update`` (K10): x, z, rtz and rcr bitwise the earlier
    kernel's in every build compared (``earlier_k10``) at E = 1024 and
    4096, n = 10 and 5, n = 3 and E = 45, and with every operand 1 value
    off its allocation's start (the cp.async path); the fp64 Jacobi-PCG on
    the paper case (100 iterations) over the earlier K10, history and x
    bitwise; each build timed in turns against the earlier library at
    n = 10, E = 1024 and 4096, and against a ring of one stage
    (``k10_one_stage_plan``), in fp64 also against an edited copy under
    K9's register cap of three blocks an SM (``K10_K9_CAP``), on the
    chosen plan and on the residency-first plan (``k10_residency_plan``:
    invd read through L2), outputs bitwise; and the static SASS
    instructions of K10's n = 10 kernel beside the earlier one's;
  - ``nekbone_interp`` (K12): v bitwise the earlier kernel's in every
    build compared (``earlier_k12``) at all 28 ladder pairs and E = 1, 7,
    1024, 4096, and with u 1 value off its allocation's start at E =
    1024; the fp64 pmg-PCG on the paper case (to 1e-8 r0) over the
    earlier K12, history and x bitwise; each build timed in turns at the
    paper ladder's six steps, E = 1024 and 4096, against the earlier
    library, in f64 and bf16 an edited copy with a ring of two stages
    (``K12_TWO_STAGES``, planned with ``K12_STAGES`` = 2), the other group
    sizes the planner would weigh at other thread floors
    (``K12_GROUP_FLOORS``, through ``K12_MIN_THREADS``), at 10 -> 5 and
    5 -> 10 an edited copy that contracts along i and j layer by layer
    (``K12_LAYERED``) and in fp64 at 10 -> 5 one that reads the rows as
    16-byte vectors (``K12_VECTOR_ROWS``), outputs bitwise; with an empty
    kernel timed on each plan's grid (``nekbone_ax.nekbone_interp_floor``, the
    launch floor), and the static SASS instructions at 10 -> 5 and
    5 -> 10;
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
import os
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


def wait_builds(procs: dict) -> tuple[dict, dict]:
    """``{key: (proc, so)}`` -> ``({key: so}, {key: CPU seconds of its
    nvcc})``, the ptxas log beside each library; exits on a failed
    build."""
    built, cpu = {}, {}
    for key, (proc, so) in procs.items():
        log = proc.stdout.read()
        _, status, usage = os.wait4(proc.pid, 0)
        proc.returncode = os.waitstatus_to_exitcode(status)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {key}:\n{log[-4000:]}")
        so.with_suffix(".log").write_text(log)
        built[key] = so
        cpu[key] = usage.ru_utime + usage.ru_stime
    return built, cpu


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

    from repro_torch.kernels import nekbone_ax as K

    caches = (K._coop_query, K._walk_device_plan, K._interp_query,
              K._interp_device_plan)
    saved = {name: _build._LIBS[name] for name in libs}
    for name, path in libs.items():
        _build._LIBS[name] = ctypes.CDLL(str(path))
    # a walker's plan rests on its library's occupancy query
    for cache in caches:
        cache.cache_clear()
    try:
        yield
    finally:
        _build._LIBS.update(saved)
        for cache in caches:
            cache.cache_clear()


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


def compare_sass(earlier: dict, tree: dict, changed=()) -> bool:
    """Whether every earlier library's SASS is the tree's, but for the
    stems in ``changed``, which are reported.  Kernels the tree adds beside
    the earlier ones (K5's and K10's planes instantiations) are listed;
    every earlier kernel must keep its instructions."""
    from repro_torch.kernels import _build

    print("== SASS beside the earlier sources", flush=True)
    ok = True
    for name, so in earlier.items():
        old, new = sass(so), sass(tree[name])
        same = all(k in new and old[k] == new[k] for k in old)
        added = sorted({k[0] if isinstance(k, tuple) else k
                        for k in new.keys() - old.keys()})
        held = _build.split_name(name)[0] not in changed
        ok &= same or not held
        print(f"  {name}: {len(old)} kernels, "
              f"{sum(map(len, old.values()))} instructions; the same SASS: "
              f"{same}" + ("" if held else " (redesigned: reported)")
              + (f"; {len(new) - len(old)} kernels added: {added}"
                 if added else ""), flush=True)
    return ok


# --- the checks of one stem -------------------------------------------------

# K1's edited copies: the same walker with K3's scalar sweep, and with a
# sweep that also reads the strided u[l][i] and s[l][i] as 16-byte vectors,
# from transposed copies of the layers that every thread stores beside them
SCALAR_SWEEP = (("__shared__ __align__(16) AxVecShared<N, A> sh;",
                 "__shared__ __align__(16) AxShared<N, A> sh;"),
                ("ax_columns_vec(sh, dr, metric, uc, wc, i, j);",
                 "ax_columns_dregs(sh, dr, metric, uc, wc, i, j);"))
TRANSPOSED_HELPER = """
template <int N, typename T>
struct AxTrShared {
  static constexpr int kPitch = kVecPitch<N, T>;
  __align__(16) T D[N][kPitch];
  __align__(16) T u[N][kPitch];
  __align__(16) T ut[N][kPitch];
  __align__(16) T r[N][kPitch];
  __align__(16) T st[N][kPitch];
};

template <int N, typename T, typename O>
__device__ __forceinline__ void load_D(AxTrShared<N, T>& sh,
                                       const O* __restrict__ D, int i, int j) {
  sh.D[j][i] = convert<T>(D[j * N + i]);
}

template <int N, typename T, typename DR, typename Metric, typename U>
__device__ __forceinline__ void ax_columns_tr(AxTrShared<N, T>& sh,
                                              const DR& dr, Metric metric,
                                              const U& uc, T (&wc)[N], int i,
                                              int j) {
#pragma unroll
  for (int k = 0; k < N; ++k) wc[k] = T(0);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    sh.u[j][i] = uc[k];
    sh.ut[i][j] = uc[k];
    __syncthreads();
    T row[N], col[N], dk[N];
    ld_row<N>(sh.u[j], row);
    ld_row<N>(sh.ut[i], col);
    ld_row<N>(sh.D[k], dk);
    T wr = T(0), ws = T(0), wt = T(0);
#pragma unroll
    for (int l = 0; l < N; ++l) {
      wr += dr.ri(l) * row[l];
      ws += dr.rj(l) * col[l];
      wt += dk[l] * uc[l];
    }
    T ur, us, ut;
    metric(k, wr, ws, wt, ur, us, ut);
    sh.r[j][i] = ur;
    sh.st[i][j] = us;
#pragma unroll
    for (int m = 0; m < N; ++m)
      if (m != k) wc[m] += dk[m] * ut;
    const T dkk = dk[k];
    __syncthreads();
    ld_row<N>(sh.r[j], row);
    ld_row<N>(sh.st[i], col);
    T acc = T(0);
#pragma unroll
    for (int l = 0; l < N; ++l) {
      acc += dr.ci(l) * row[l];
      acc += dr.cj(l) * col[l];
    }
    wc[k] += acc;
    wc[k] += dkk * ut;
  }
}
"""
TRANSPOSED_SWEEP = (
    ("namespace nekbone {\n", "namespace nekbone {\n" + TRANSPOSED_HELPER),
    ("__shared__ __align__(16) AxVecShared<N, A> sh;",
     "__shared__ __align__(16) AxTrShared<N, A> sh;"),
    ("ax_columns_vec(sh, dr, metric, uc, wc, i, j);",
     "ax_columns_tr(sh, dr, metric, uc, wc, i, j);"))
# (grid, n) of the bitwise checks of K1 and K9
PARITY_CASES = (((8, 8, 16), 10), ((16, 16, 16), 10), ((8, 8, 16), 5),
                ((16, 16, 16), 5))


def _ctypes_fn(path: pathlib.Path, name: str, pointers: int, ints: int):
    fn = getattr(ctypes.CDLL(str(path)), name)
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _call(fn, name, tensors, ints):
    import torch

    err = fn(*(t.data_ptr() for t in tensors), *ints,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"earlier {name}: CUDA error {err}")


def earlier_k1(path: pathlib.Path, mix: str):
    """The earlier library's K1 (one block an element, C signature (u, D,
    g, w, E, n, stream)) as a function of the wrapper's operands."""
    import torch

    fn = _ctypes_fn(path, f"nekbone_ax_{mix}", 4, 2)

    def call(u2, D, g2, *, n):
        w2 = torch.empty_like(u2)
        _call(fn, f"nekbone_ax_{mix}", (u2, D, g2, w2), (u2.shape[0], n))
        return w2
    return call


def _k1_operands(rng, E, n, mix):
    """u, D and a random SPD metric (chip_smoke's operator data) in the
    build's roles."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import nekbone_ax as K

    dt = K.MIXES[mix]
    u, D, g = cs._operator_data(rng, E, n, torch.float64)
    return u.to(dt["S"]), D.to(dt["O"]), g.to(dt["O"])


def _plan_text(stem, E, n, mix, tree, kernel, **kw) -> str:
    import chip_smoke as cs
    from repro_torch.kernels import nekbone_ax as K

    plan, info = K.walk_launch_info(stem, E, n, mix, **kw)
    regs, spill = cs._ptxas_report(tree[f"{stem}_{mix}"].with_suffix(
        ".log").read_text())[kernel]
    return (f"grid {plan.grid} x {plan.per_block}, {plan.blocks_per_sm} "
            f"blocks an SM, {', '.join(plan.staged) or 'nothing'} staged "
            f"({plan.smem_bytes} B, {plan.copy}), {regs} registers, "
            f"{spill} B spilled")


def _best(times: dict) -> dict:
    return {label: min(ts) for label, ts in times.items()}


def _fmt(times: dict) -> str:
    return "; ".join(f"{label} " + ", ".join(f"{t:.4f}" for t in ts)
                     + " ms" for label, ts in times.items())


# the label of the tree's K1 timed on its scalar-sweep copy's plan
SAME_PLAN = "tree on the scalar sweep's plan"


def check_k1(earlier: dict, tree: dict, extra: dict) -> bool:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import nekbone_ax as K

    mixes = [m for m in K.MIXES if f"nekbone_ax_{m}" in earlier]
    old = {m: earlier_k1(earlier[f"nekbone_ax_{m}"], m) for m in mixes}
    rng = np.random.default_rng(25)
    ok = True
    print("== K1 beside the earlier kernel: w bitwise", flush=True)
    for mix in mixes:
        bad = []
        for grid, n in PARITY_CASES:
            E = grid[0] * grid[1] * grid[2]
            args = _k1_operands(rng, E, n, mix)
            if not torch.equal(K.nekbone_ax_cuda(*args, n=n),
                               old[mix](*args, n=n)):
                bad.append((E, n))
        ok &= not bad
        print(f"  {mix}: E = 1024 and 4096, n = 10 and 5: bitwise "
              f"{'every case' if not bad else f'NOT {bad}'}", flush=True)
    if "f64" in mixes:
        case = NekboneCase(n=10, grid=cs.PAPER_GRID, dtype=torch.float64,
                           ax_impl="pallas")
        _, f = case.manufactured()
        new = case.solve(f, niter=cs.NITER)
        with patched(K, nekbone_ax_cuda=old["f64"]):
            prev = case.solve(f, niter=cs.NITER)
        same = (torch.equal(new.history, prev.history)
                and torch.equal(new.x, prev.x))
        ok &= same
        print(f"  fp64 reference CG ({cs.NITER} iterations, paper case): "
              f"history[{cs.NITER}] {float(new.history[cs.NITER]):.6e}; "
              f"history and x bitwise over the earlier K1: {same}",
              flush=True)
    print("== K1: device ms in turns (CUDA events, 3 calls, median of 3) "
          "beside the earlier library, and beside the same walker with "
          "K3's scalar sweep and with the strided reads from transposed "
          "copies", flush=True)
    kernel = "nekbone_ax_kernel<10>"
    for mix in mixes:
        forms = {form: {f"nekbone_ax_{mix}": extra[f"k1{form}_{mix}"]}
                 for form in ("scalar", "transposed")}
        for grid in ((8, 8, 16), (16, 16, 16)):
            E = grid[0] * grid[1] * grid[2]
            args = _k1_operands(rng, E, 10, mix)

            def run():
                return K.nekbone_ax_cuda(*args, n=10)
            times = in_turns(run, lambda: patched(K, nekbone_ax_cuda=old[
                mix]))
            want = run()
            notes = []
            for form, libs in forms.items():
                times.update(in_turns(run, lambda: swapped(libs),
                                      labels=(f"{form} sweep",
                                              f"tree ({form})")))
                with swapped(libs):
                    same = torch.equal(run(), want)
                    notes.append(f"{form}: " + _plan_text(
                        "nekbone_ax", E, 10, mix,
                        {f"nekbone_ax_{mix}": extra[f"k1{form}_{mix}"]},
                        kernel) + f", w bitwise the tree's: {same}")
                    their = K._walk_device_plan(
                        "nekbone_ax", K.k1_plan, E, 10, mix,
                        torch.cuda.current_device(), True)
                ok &= same
                if form == "scalar":
                    # the tree's sweep on the scalar form's plan (its
                    # larger static shared memory may stage less): the
                    # plan's share apart from the sweep's
                    times.update(in_turns(
                        run, lambda: patched(K, k1_plan=lambda *a, **k:
                                             their),
                        labels=(SAME_PLAN, "tree (plan)")))
            best = _best(times)
            ratio = best["tree"] / best["earlier"]
            ok &= ratio <= 1.03
            print(f"  {mix} E={E}: plan " + _plan_text(
                "nekbone_ax", E, 10, mix, tree, kernel)
                + f"; {_fmt(times)}; tree / earlier {ratio:.3f} (at most "
                f"1.03: {ratio <= 1.03}); tree / scalar sweep "
                f"{best['tree (scalar)'] / best['scalar sweep']:.3f} (on "
                f"one plan {best[SAME_PLAN] / best['scalar sweep']:.3f}), "
                "tree / transposed "
                f"{best['tree (transposed)'] / best['transposed sweep']:.3f}"
                + "".join(f"; {note}" for note in notes), flush=True)
            del args
    return ok


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


# --- K5 and K7, the CG update walkers ------------------------------------

# The earlier K5's and K7's C signatures: pointers, (ex, ey, ez, n[, b]),
# the stream; one block an element, no plan.
_EARLIER_INTS = {"nekbone_cg_update": 4, "nekbone_cg_update_block": 5}
UPDATE_CASES = (((8, 8, 16), 10), ((16, 16, 16), 10), ((8, 8, 16), 5),
                ((16, 16, 16), 5))


def earlier_update(path: pathlib.Path, stem: str, mix: str):
    """The earlier library's K5 or K7 as a function of the wrapper's
    operands, returning ``(x, r, rcr)`` as the wrapper does."""
    import torch

    from repro_torch.kernels import nekbone_ax as K

    fn = getattr(ctypes.CDLL(str(path)), f"{stem}_{mix}")
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * \
        _EARLIER_INTS[stem] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(x, p, r, w, alpha, cx, cy, cz, *, n):
        lanes = (x.shape[0],) if stem.endswith("_block") else ()
        x_out, r_out = torch.empty_like(x), torch.empty_like(r)
        rcr = torch.empty(x.shape[:-1], dtype=K.MIXES[mix]["A"],
                          device=x.device)
        err = fn(*(t.data_ptr() for t in (x, p, r, w, alpha, cx, cy, cz,
                                          x_out, r_out, rcr)),
                 cx.shape[0], cy.shape[0], cz.shape[0], n, *lanes,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"earlier {stem}_{mix}: CUDA error {err}")
        return x_out, r_out, rcr
    return call


@contextlib.contextmanager
def patched(module, **attrs):
    """``module``'s attributes replaced for the ``with`` block (the
    wrappers look their kernels and planners up at call time)."""
    saved = {name: getattr(module, name) for name in attrs}
    for name, value in attrs.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(module, name, value)


def ring_off_plan(E, n, mix, sm_count, blocks_per_sm, smem_per_block, *,
                  aligned=True, b=1):
    """The ablation's planner: the walker with nothing staged (every
    operand read from device memory, prefetched to L2 one item ahead), its
    grid in one wave at the residency the registers allow."""
    from repro_torch.kernels import nekbone_ax as K

    return _fixed_plan(K.k5_operands(n, mix), (), b * E, sm_count,
                       blocks_per_sm, aligned)


def _update_operands(gen, grid, n, mix, lanes):
    """Random x, p, r, w ((lanes, E, n^3), or (E, n^3) for None) in the
    build's roles, alpha in A, and the c factors."""
    import torch

    from repro_torch.kernels import nekbone_ax as K
    from repro_torch.kernels import ops

    dt = K.MIXES[mix]
    E = grid[0] * grid[1] * grid[2]
    shape = (lanes or 1, E, n ** 3)

    def field(dtype):
        t = torch.randn(shape, generator=gen, dtype=torch.float64,
                        device="cuda").to(dtype)
        return t if lanes else t[0]

    alpha = (torch.rand(lanes or 1, generator=gen, dtype=torch.float64,
                        device="cuda") + 0.5).to(dt["A"])
    _, c = ops.slab_axis_factors(grid, n, dt["S"], "cuda")
    return (field(dt["X"]), field(dt["S"]), field(dt["S"]), field(dt["S"]),
            alpha, *c)


def _check_update(stem: str, earlier: dict) -> bool:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import nekbone_ax as K

    block = stem.endswith("_block")
    key, wrapper = (("K7", "nekbone_cg_update_block_cuda") if block
                    else ("K5", "nekbone_cg_update_cuda"))
    planner = "k7_plan" if block else "k5_plan"
    mixes = [m for m in K.MIXES if f"{stem}_{m}" in earlier]
    old = {m: earlier_update(earlier[f"{stem}_{m}"], stem, m) for m in mixes}
    gen = torch.Generator("cuda").manual_seed(24)
    ok = True
    print(f"== {key} ({stem}) beside the earlier kernels: x, r and rcr "
          "bitwise" + (", b = 1..4" if block else ""), flush=True)
    for mix in mixes:
        bad = []
        for grid, n in UPDATE_CASES:
            for lanes in ((1, 2, 3, 4) if block else (None,)):
                args = _update_operands(gen, grid, n, mix, lanes)
                new = getattr(K, wrapper)(*args, n=n)
                same = all(torch.equal(a, b) for a, b in
                           zip(new, old[mix](*args, n=n)))
                if not same:
                    bad.append((grid, n, lanes))
        ok &= not bad
        print(f"  {mix}: E = 1024 and 4096, n = 10 and 5: bitwise "
              f"{'every case' if not bad else f'NOT {bad}'}", flush=True)
    if not block and "f64" in mixes:
        from repro_torch.core.nekbone import NekboneCase

        case = NekboneCase(n=10, grid=cs.PAPER_GRID, dtype=torch.float64,
                           ax_impl="pallas_fused_cg_v2")
        _, f = case.manufactured()
        tree = case.solve(f, niter=cs.NITER)
        with patched(K, nekbone_cg_update_cuda=old["f64"]):
            prev = case.solve(f, niter=cs.NITER)
        same = (torch.equal(tree.history, prev.history)
                and torch.equal(tree.x, prev.x))
        ok &= same
        print(f"  fp64 v2 CG ({cs.NITER} iterations, paper case): "
              f"history[{cs.NITER}] {float(tree.history[cs.NITER]):.6e}; "
              f"history and x bitwise over the earlier K5: {same}",
              flush=True)
    print(f"== {key}: device ms in turns (CUDA events, 3 calls, median of "
          "3) beside the earlier library, and beside the walker with its "
          "ring off (same library, nothing staged)", flush=True)
    b = 4 if block else None
    for mix in mixes:
        for grid in ((8, 8, 16), (16, 16, 16)):
            E = grid[0] * grid[1] * grid[2]
            args = _update_operands(gen, grid, 10, mix, b)
            kw = dict(b=b) if block else {}
            plan, info = K.walk_launch_info(stem, E, 10, mix, **kw)
            off_plan = K._walk_device_plan(stem, ring_off_plan, E, 10, mix,
                                           torch.cuda.current_device(),
                                           True, **kw)

            def run():
                return getattr(K, wrapper)(*args, n=10)
            times = in_turns(run, lambda: patched(K, **{wrapper:
                                                        old[mix]}))
            off = in_turns(run, lambda: patched(K, **{planner:
                                                      ring_off_plan}),
                           labels=("ring off", "ring"))
            want = run()
            with patched(K, **{planner: ring_off_plan}):
                same = all(torch.equal(a, z) for a, z in zip(run(), want))
            ok &= same
            best = {label: min(ts) for label, ts in {**times, **off}.items()}
            ratio = best["tree"] / best["earlier"]
            limit = 0.5 if block and mix.startswith("bf16") and E == 1024 \
                else 1.03
            ok &= ratio <= limit
            print(f"  {mix} E={E}" + (f" b={b}" if block else "")
                  + f": plan grid {plan.grid} x {plan.per_block}, "
                  f"{plan.blocks_per_sm} blocks an SM, {plan.smem_bytes} B "
                  f"ring ({plan.copy}), {info['registers']} registers; "
                  + "; ".join(f"{label} " + ", ".join(f"{t:.4f}" for t in ts)
                              + " ms" for label, ts in
                              {**times, **off}.items())
                  + f"; tree / earlier {ratio:.3f} (at most {limit:g}: "
                  f"{ratio <= limit}), ring / ring off "
                  f"{best['ring'] / best['ring off']:.3f}"
                  f" (ring off: grid {off_plan.grid} x "
                  f"{off_plan.per_block}, {off_plan.blocks_per_sm} blocks "
                  f"an SM; outputs bitwise the ring's: {same})", flush=True)
            del args
    return ok


def check_k5(earlier: dict, tree: dict, extra: dict) -> bool:
    return _check_update("nekbone_cg_update", earlier)


def check_k7(earlier: dict, tree: dict, extra: dict) -> bool:
    return _check_update("nekbone_cg_update_block", earlier)


# --- K9, the s-step update walker ------------------------------------------

def earlier_k9(path: pathlib.Path, mix: str):
    """The earlier library's K9 (one block an element, C signature (x, p,
    r, basis, coef, cx, cy, cz, x_out, r_out, p_out, rcr, ex, ey, ez, n, s,
    stream)) as a function of the wrapper's operands."""
    import torch

    from repro_torch.kernels import nekbone_ax as K

    name = f"nekbone_sstep_update_{mix}"
    fn = _ctypes_fn(path, name, 12, 5)

    def call(x2, p2, r2, basis, coef, cx, cy, cz, *, n, s):
        x_out, r_out, p_out = (torch.empty_like(t) for t in (x2, r2, p2))
        rcr = torch.empty(x2.shape[0], dtype=K.MIXES[mix]["A"],
                          device=x2.device)
        _call(fn, name, (x2, p2, r2, basis, coef, cx, cy, cz, x_out, r_out,
                         p_out, rcr),
              (cx.shape[0], cy.shape[0], cz.shape[0], n, s))
        return x_out, r_out, p_out, rcr
    return call


def _k9_operands(gen, grid, n, s, mix):
    """Random x, p, r, basis and coefficients in the build's roles, and the
    c factors of ``grid``."""
    import torch

    from repro_torch.kernels import nekbone_ax as K
    from repro_torch.kernels import ops

    dt = K.MIXES[mix]
    E, n3 = grid[0] * grid[1] * grid[2], n ** 3

    def field(shape, dtype):
        return torch.randn(shape, generator=gen, dtype=torch.float64,
                           device="cuda").to(dtype)

    _, c = ops.slab_axis_factors(grid, n, dt["S"], "cuda")
    return (field((E, n3), dt["X"]), field((E, n3), dt["S"]),
            field((E, n3), dt["S"]), field((E, 2 * s - 1, n3), dt["S"]),
            field((3, 2 * s + 1), dt["A"]), *c)


def _fixed_plan(operands: dict, staged: tuple, E, sm_count, blocks_per_sm,
                aligned):
    """A walker's plan that stages ``staged`` of ``operands``, its grid in
    one wave at the residency that ring allows."""
    from repro_torch.kernels import nekbone_ax as K

    bulk = aligned and all(v % 16 == 0 for v in operands.values())
    dyn = K.STAGES * sum(K.walk_slot_bytes(operands[k], bulk)
                         for k in staged)
    fit = blocks_per_sm(dyn)
    base = K.device_memory_plan(E, sm_count, fit, 1, dyn)
    return K.WalkPlan(base.per_block, base.grid, fit, dyn, K.STAGES, staged,
                      tuple(operands), bulk)


def k9_ring_off_plan(E, n, mix, sm_count, blocks_per_sm, smem_per_block, *,
                     s, aligned=True):
    """The ablation's planner: K9's walker with nothing staged."""
    from repro_torch.kernels import nekbone_ax as K

    return _fixed_plan(K.k9_operands(n, s, mix), (), E, sm_count,
                       blocks_per_sm, aligned)


def xpr_plan(E, n, mix, sm_count, blocks_per_sm, smem_per_block, *, s,
             aligned=True):
    """The other planner: K9's walker with x, p and r staged and the basis
    read from device memory, at the residency that ring allows."""
    from repro_torch.kernels import nekbone_ax as K

    return _fixed_plan(K.k9_operands(n, s, mix), ("x", "p", "r"), E,
                       sm_count, blocks_per_sm, aligned)


# K9's edited copy: the column loop rolled (its run-time trip count 2s + 1,
# each column's pointer picked in the loop) in place of the table of
# pointers and the loop unrolled to kSstepMaxK
ROLLED_COLUMNS = (
    ("""  // V's columns: p, basis[0..s-1], r, basis[s..2s-2]
  const S* col[kSstepMaxK];
#pragma unroll
  for (int m = 0; m < kSstepMaxK; ++m)
    col[m] = m == 0 ? ps
                    : m == s + 1 ? rs : bs + (m <= s ? m - 1 : m - 2) * N3;
""", ""),
    ("""#pragma unroll
  for (int m = 0; m < kSstepMaxK; ++m) {
    if (m < K) {
      A c0, c1, c2;
      coef3(sco[m], c0, c1, c2);
      A v[N];
#pragma unroll
      for (int k = 0; k < N; ++k) v[k] = convert<A>(col[m][k * N2]);""",
     """#pragma unroll 1
  for (int m = 0; m < K; ++m) {
    {
      const S* cm = m == 0 ? ps
                           : m == s + 1 ? rs
                                        : bs + (m <= s ? m - 1 : m - 2) * N3;
      A c0, c1, c2;
      coef3(sco[m], c0, c1, c2);
      A v[N];
#pragma unroll
      for (int k = 0; k < N; ++k) v[k] = convert<A>(cm[k * N2]);"""))


def check_k9(earlier: dict, tree: dict, extra: dict) -> bool:
    import torch

    import chip_smoke as cs
    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import nekbone_ax as K

    stem = "nekbone_sstep_update"
    mixes = [m for m in K.MIXES if f"{stem}_{m}" in earlier]
    old = {m: earlier_k9(earlier[f"{stem}_{m}"], m) for m in mixes}
    gen = torch.Generator("cuda").manual_seed(25)
    ok = True
    print("== K9 beside the earlier kernel: x, r, p and rcr bitwise",
          flush=True)
    for mix in mixes:
        bad = []
        for grid, n in PARITY_CASES:
            for s in (1, 2, 4):
                args = _k9_operands(gen, grid, n, s, mix)
                new = K.nekbone_sstep_update_cuda(*args, n=n, s=s)
                if not all(torch.equal(a, b) for a, b in
                           zip(new, old[mix](*args, n=n, s=s))):
                    bad.append((grid, n, s))
        ok &= not bad
        print(f"  {mix}: E = 1024 and 4096, n = 10 and 5, s = 1, 2, 4: "
              f"bitwise {'every case' if not bad else f'NOT {bad}'}",
              flush=True)
    if "f64" in mixes:
        case = NekboneCase(n=10, grid=cs.PAPER_GRID, dtype=torch.float64,
                           ax_impl="pallas_sstep_v3", s=cs.SSTEP_S)
        _, f = case.manufactured()
        new = case.solve(f, niter=cs.NITER)
        with patched(K, nekbone_sstep_update_cuda=old["f64"]):
            prev = case.solve(f, niter=cs.NITER)
        same = (torch.equal(new.history, prev.history)
                and torch.equal(new.x, prev.x))
        ok &= same
        print(f"  fp64 s-step CG (s={cs.SSTEP_S}, {cs.NITER} iterations, "
              f"paper case): history[{cs.NITER}] "
              f"{float(new.history[cs.NITER]):.6e}; history and x bitwise "
              f"over the earlier K9: {same}", flush=True)
    print("== K9: device ms in turns (CUDA events, 3 calls, median of 3) "
          "beside the earlier library and an edited copy with the column "
          "loop rolled; in fp64 at s = 4 also beside the ring off and x, p, "
          "r staged alone", flush=True)
    kernel = "nekbone_sstep_update_kernel<10>"
    for mix in mixes:
        for grid in ((8, 8, 16), (16, 16, 16)):
            E = grid[0] * grid[1] * grid[2]
            for s in (1, 2, cs.SSTEP_S, K.SSTEP_MAX_S):
                args = _k9_operands(gen, grid, 10, s, mix)

                def run():
                    return K.nekbone_sstep_update_cuda(*args, n=10, s=s)
                times = in_turns(run, lambda: patched(
                    K, nekbone_sstep_update_cuda=old[mix]))
                rolled = {f"{stem}_{mix}": extra[f"k9rolled_{mix}"]}
                others = in_turns(run, lambda: swapped(rolled),
                                  labels=("rolled columns", "tree (rolled)"))
                want = run()
                with swapped(rolled):
                    same = all(torch.equal(a, b) for a, b in zip(run(), want))
                ok &= same
                notes = [f"rolled columns' outputs bitwise the tree's: {same}"]
                if mix == "f64" and s == cs.SSTEP_S:
                    for label, planner in (("ring off", k9_ring_off_plan),
                                           ("x, p, r staged", xpr_plan)):
                        others.update(in_turns(
                            run, lambda: patched(K, k9_plan=planner),
                            labels=(label, f"chosen ({label})")))
                        with patched(K, k9_plan=planner):
                            same = all(torch.equal(a, b)
                                       for a, b in zip(run(), want))
                            index = torch.cuda.current_device()
                            alt = K._walk_device_plan(
                                stem, planner, E, 10, mix, index, True, s=s)
                        ok &= same
                        notes.append(f"{label}: grid {alt.grid} x "
                                     f"{alt.per_block}, {alt.blocks_per_sm} "
                                     "blocks an SM, outputs bitwise the "
                                     f"chosen plan's: {same}")
                best = _best(times)
                ratio = best["tree"] / best["earlier"]
                ok &= ratio <= 1.03
                print(f"  {mix} E={E} s={s}: plan " + _plan_text(
                    stem, E, 10, mix, tree, kernel, s=s)
                    + f"; {_fmt({**times, **others})}; tree / earlier "
                    f"{ratio:.3f} (at most 1.03: {ratio <= 1.03})"
                    + "".join(f"; {note}" for note in notes), flush=True)
                del args
    return ok


# --- K10 and K12 ------------------------------------------------------------

# (grid, n) of the bitwise checks of K10: both copy paths (n = 5 and 3 take
# cp.async) and a grid no block count divides
K10_CASES = (((8, 8, 16), 10), ((16, 16, 16), 10), ((8, 8, 16), 5),
             ((16, 16, 16), 5), ((8, 8, 16), 3), ((3, 3, 5), 10))
# the element counts of K12's bitwise checks
K12_ES = (1, 7, 1024, 4096)
# the steps of the paper case's ladder (10 -> 5 -> 3 -> 2 and back)
K12_LADDER = ((10, 5), (5, 10), (5, 3), (3, 5), (3, 2), (2, 3))
# K12's group sizes timed at each step: the least count a bulk copy takes
# (min_threads 1), and the counts that keep 64, 128 (the planner's) and
# 256 threads a block busy
K12_GROUP_FLOORS = (1, 64, 128, 256)
# K12's edited copies: the rows along i read as 16-byte vectors where they
# are 16-byte aligned (the bulk path with nin * sizeof(S) a multiple of
# 16); and the contractions along i and j layer by layer, one barrier a
# layer, through two layer buffers (G nin nout values each) inside the
# group's buffer
K12_VECTOR_ROWS = (
    ("""template <int N, typename S, typename A>
__device__ __forceinline__ void interp_row(const S* row, A (&v)[N]) {
#pragma unroll
  for (int l = 0; l < N; ++l) v[l] = convert<A>(row[l]);
}""", """template <int N, bool kVec, typename S, typename A>
__device__ __forceinline__ void interp_row(const S* row, A (&v)[N]) {
  if constexpr (kVec) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(S));
#pragma unroll
    for (int c = 0; c < N / kPer; ++c) {
      const uint4 q = reinterpret_cast<const uint4*>(row)[c];
      S vals[kPer];
      memcpy(vals, &q, 16);
#pragma unroll
      for (int m = 0; m < kPer; ++m) v[c * kPer + m] = convert<A>(vals[m]);
    }
  } else {
#pragma unroll
    for (int l = 0; l < N; ++l) v[l] = convert<A>(row[l]);
  }
}"""),
    ("interp_row<NIN>(in + row * NIN, uv);",
     "interp_row<NIN, kBulk && (NIN * static_cast<int>(sizeof(S))) % 16 "
     "== 0>(in + row * NIN, uv);"),
    ('#include "common.cuh"', '#include <cstring>\n\n#include "common.cuh"'))
K12_LAYERED = (("""    // along i, every layer: v1[el'][k][j][io] = sum_i u[el'][k][j][i]
    // mt[i][io], the rows (el', k, j) contiguous in the stage
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int row = row0 + m * rows_step;
      if (row < ne * NIN2) {
        A uv[NIN];
        interp_row<NIN>(in + row * NIN, uv);
        A acc = A(0);
#pragma unroll
        for (int l = 0; l < NIN; ++l) acc = add_rn(acc, mul_rn(uv[l], mi[l]));
        v1[row * NOUT + io] = acc;
      }
    }
    __syncthreads();
    // no thread reads this group's stage any more
    if (t + kInterpStages < count)
      interp_fill<kBulk, NIN3>(ring, s, a.u, (g + kInterpStages) * G,
                               elements(g + kInterpStages), tid, threads);
    // along j, every layer: v2[k] = sum_j v1[el][k][j][io] mt[j][jo]
    if (el < ne) {
      A v2[NIN];
      const A* b = v1 + el * NIN2 * NOUT + io;
#pragma unroll
      for (int k = 0; k < NIN; ++k) {
        A acc = A(0);
#pragma unroll
        for (int l = 0; l < NIN; ++l)
          acc = add_rn(acc, mul_rn(b[(k * NIN + l) * NOUT], mj[l]));
        v2[k] = acc;
      }
""", """    A v2[NIN];
#pragma unroll
    for (int k = 0; k < NIN; ++k) {
      A* buf = v1 + (k & 1) * G * NIN * NOUT;
      for (int row = tid / NOUT; row < ne * NIN; row += rows_step) {
        const int e = row / NIN;
        const S* r = in + e * NIN3 + k * NIN * NIN + (row - e * NIN) * NIN;
        A uv[NIN];
        interp_row<NIN>(r, uv);
        A acc = A(0);
#pragma unroll
        for (int l = 0; l < NIN; ++l) acc = add_rn(acc, mul_rn(uv[l], mi[l]));
        buf[row * NOUT + io] = acc;
      }
      __syncthreads();
      if (k == NIN - 1 && t + kInterpStages < count)
        interp_fill<kBulk, NIN3>(ring, s, a.u, (g + kInterpStages) * G,
                                 elements(g + kInterpStages), tid, threads);
      const A* b = buf + (el < ne ? el : 0) * NIN * NOUT + io;
      A acc = A(0);
#pragma unroll
      for (int l = 0; l < NIN; ++l) acc = add_rn(acc, mul_rn(b[l * NOUT], mj[l]));
      v2[k] = acc;
    }
    if (el < ne) {
"""),)


# K12's ring of two stages: the next group's copy issued a group ahead
# (timed with nekbone_ax.K12_STAGES = 2, so that the plan sizes the ring)
K12_TWO_STAGES = (("constexpr int kInterpStages = 1;",
                   "constexpr int kInterpStages = 2;"),)
# K10 under K9's register cap (common.cuh kWalkMinBlocks with 384 threads
# in place of 256 at 8-byte accumulation): three fp64 blocks of 128 threads
# an SM at n = 10
K10_K9_CAP = (("__launch_bounds__(N * N, kWalkMinBlocks<N, A>)",
               "__launch_bounds__(N * N, kSstepMinBlocks<N, A>)"),
              ("namespace nekbone {\n", """namespace nekbone {

template <int N, typename A>
constexpr int kSstepMinBlocks =
    (sizeof(A) == 8 ? 384 : 512) / ((N * N + 31) / 32 * 32) > 1
        ? (sizeof(A) == 8 ? 384 : 512) / ((N * N + 31) / 32 * 32)
        : 1;
"""))


def earlier_k10(path: pathlib.Path, mix: str):
    """The earlier library's K10 (one block an element, C signature (x, p,
    z, w, alpha, invd, cx, cy, cz, x_out, z_out, rtz, rcr, ex, ey, ez, n,
    stream)) as a function of the wrapper's operands."""
    import torch

    from repro_torch.kernels import nekbone_ax as K

    name = f"nekbone_pcg_update_{mix}"
    fn = _ctypes_fn(path, name, 13, 4)

    def call(x2, p2, z2, w2, alpha, invd2, cx, cy, cz, *, n):
        x_out, z_out = torch.empty_like(x2), torch.empty_like(z2)
        parts = torch.empty(2, x2.shape[0], dtype=K.MIXES[mix]["A"],
                            device=x2.device)
        _call(fn, name, (x2, p2, z2, w2, alpha, invd2, cx, cy, cz, x_out,
                         z_out, parts[0], parts[1]),
              (cx.shape[0], cy.shape[0], cz.shape[0], n))
        return x_out, z_out, parts[0], parts[1]
    return call


def earlier_k12(path: pathlib.Path, mix: str):
    """The earlier library's K12 (blocks of a few elements, C signature
    (u, mt, v, E, nin, nout, stream))."""
    import torch

    name = f"nekbone_interp_{mix}"
    fn = _ctypes_fn(path, name, 3, 3)

    def call(u2, mt, *, nin, nout):
        v2 = torch.empty(u2.shape[0], nout ** 3, dtype=u2.dtype,
                         device=u2.device)
        _call(fn, name, (u2, mt, v2), (u2.shape[0], nin, nout))
        return v2
    return call


def _k10_operands(gen, grid, n, mix):
    """Random x, p, z, w, alpha, a positive invd in the build's roles, and
    the c factors of ``grid``."""
    import torch

    from repro_torch.kernels import nekbone_ax as K
    from repro_torch.kernels import ops

    dt = K.MIXES[mix]
    E, n3 = grid[0] * grid[1] * grid[2], n ** 3

    def field(dtype, lo=None):
        t = (torch.rand if lo is not None else torch.randn)(
            (E, n3), generator=gen, dtype=torch.float64, device="cuda")
        return (t * 1.5 + lo if lo is not None else t).to(dtype)

    alpha = (torch.rand(1, generator=gen, dtype=torch.float64,
                        device="cuda") + 0.5).to(dt["A"])
    _, c = ops.slab_axis_factors(grid, n, dt["S"], "cuda")
    return (field(dt["X"]), field(dt["S"]), field(dt["S"]), field(dt["S"]),
            alpha, field(dt["O"], lo=0.5), *c)


def _off16(t):
    """``t`` copied into a view one value past its allocation's start: the
    cp.async path at any n."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


def k10_residency_plan(E, n, mix, sm_count, blocks_per_sm, smem_per_block,
                       *, aligned=True):
    """The other planner: :func:`walk_plan`'s rule over K10's operands,
    residency first (n = 10, fp64: x, p, z and w staged at three blocks an
    SM, invd read through L2)."""
    from repro_torch.kernels import nekbone_ax as K

    return K.walk_plan(f"k10_residency_plan (n={n}, {mix})", E,
                       K.k10_operands(n, mix), sm_count, blocks_per_sm,
                       smem_per_block, aligned=aligned)


def k10_one_stage_plan(E, n, mix, sm_count, blocks_per_sm, smem_per_block,
                       *, aligned=True):
    """The other ring: all five operands staged in a ring of one stage, at
    the residency that allows (n = 10, fp64: 40,000 bytes, three blocks an
    SM by registers), the next element's copy issued once the current one
    is done."""
    from repro_torch.kernels import nekbone_ax as K

    ops = K.k10_operands(n, mix)
    bulk = aligned and all(v % 16 == 0 for v in ops.values())
    dyn = sum(K.walk_slot_bytes(v, bulk) for v in ops.values())
    fit = blocks_per_sm(dyn)
    base = K.device_memory_plan(E, sm_count, fit, 1, dyn)
    return K.WalkPlan(base.per_block, base.grid, fit, dyn, 1, tuple(ops),
                      tuple(ops), bulk)


def check_k10(earlier: dict, tree: dict, extra: dict) -> bool:
    import torch

    import chip_smoke as cs
    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import nekbone_ax as K

    stem = "nekbone_pcg_update"
    mixes = [m for m in K.MIXES if f"{stem}_{m}" in earlier]
    old = {m: earlier_k10(earlier[f"{stem}_{m}"], m) for m in mixes}
    gen = torch.Generator("cuda").manual_seed(26)
    ok = True
    print("== K10 beside the earlier kernel: x, z, rtz and rcr bitwise "
          "(E = 1024 and 4096 at n = 10 and 5, n = 3, E = 45; every "
          "operand 1 value off its allocation's start)", flush=True)
    for mix in mixes:
        bad = []
        for grid, n in K10_CASES:
            args = _k10_operands(gen, grid, n, mix)
            want = old[mix](*args, n=n)
            if not all(torch.equal(a, b) for a, b in zip(
                    K.nekbone_pcg_update_cuda(*args, n=n), want)):
                bad.append((grid, n))
            if grid == (8, 8, 16):
                moved = [_off16(t) for t in args[:4]] + [args[4],
                                                         _off16(args[5])]
                if not all(torch.equal(a, b) for a, b in zip(
                        K.nekbone_pcg_update_cuda(*moved, *args[6:], n=n),
                        want)):
                    bad.append((grid, n, "misaligned"))
        ok &= not bad
        print(f"  {mix}: bitwise {'every case' if not bad else f'NOT {bad}'}",
              flush=True)
    if "f64" in mixes:
        case = NekboneCase(n=10, grid=cs.PAPER_GRID, dtype=torch.float64,
                           ax_impl="pallas_fused_cg_v2")
        _, f = case.manufactured()
        new = case.solve(f, niter=cs.NITER, precond="jacobi")
        with patched(K, nekbone_pcg_update_cuda=old["f64"]):
            prev = case.solve(f, niter=cs.NITER, precond="jacobi")
        same = (torch.equal(new.history, prev.history)
                and torch.equal(new.x, prev.x))
        ok &= same
        print(f"  fp64 Jacobi-PCG ({cs.NITER} iterations, paper case): "
              f"history[{cs.NITER}] {float(new.history[cs.NITER]):.6e}; "
              f"history and x bitwise over the earlier K10: {same}",
              flush=True)
    print("== K10: device ms in turns (CUDA events, 3 calls, median of 3) "
          "beside the earlier library and a ring of one stage; in fp64 also "
          "beside the chosen plan under K9's register cap (three blocks an "
          "SM) and the residency-first plan under that cap (invd read "
          "through L2)", flush=True)
    kernel = "nekbone_pcg_update_kernel<10>"
    for mix in mixes:
        for grid in (cs.PAPER_GRID, cs.BIG_GRID):
            E = grid[0] * grid[1] * grid[2]
            args = _k10_operands(gen, grid, 10, mix)

            def run():
                return K.nekbone_pcg_update_cuda(*args, n=10)
            times = in_turns(run, lambda: patched(
                K, nekbone_pcg_update_cuda=old[mix]))
            notes = []
            want = run()
            cap = {f"{stem}_{mix}": extra.get(f"k10cap_{mix}")}
            variants = [("one stage", k10_one_stage_plan, False)]
            if mix == "f64":
                variants = [("K9's cap", K.k10_plan, True),
                            ("residency first, K9's cap",
                             k10_residency_plan, True), *variants]

            def variant(planner, capped):
                stack = contextlib.ExitStack()
                if capped:
                    stack.enter_context(swapped(cap))
                stack.enter_context(patched(K, k10_plan=planner))
                return stack
            for label, planner, capped in variants:
                times.update(in_turns(
                    run, lambda: variant(planner, capped),
                    labels=(label, f"chosen ({label})")))
                with variant(planner, capped):
                    same = all(torch.equal(a, b)
                               for a, b in zip(run(), want))
                    alt = K._walk_device_plan(
                        stem, planner, E, 10, mix,
                        torch.cuda.current_device(), True)
                    regs = K.walk_launch_info(stem, E, 10, mix)[1][
                        "registers"]
                ok &= same
                notes.append(
                    f"{label}: grid {alt.grid} x {alt.per_block}, "
                    f"{alt.blocks_per_sm} blocks an SM, {alt.stages} "
                    f"stage(s) of {', '.join(alt.staged)} "
                    f"({alt.smem_bytes} B), {regs} registers, outputs "
                    f"bitwise the chosen plan's: {same}")
            best = _best(times)
            print(f"  {mix} E={E}: plan " + _plan_text(
                stem, E, 10, mix, tree, kernel) + f"; {_fmt(times)}; tree / "
                f"earlier {best['tree'] / best['earlier']:.3f}"
                + "".join(f"; {note}" for note in notes), flush=True)
            del args
    _sass_counts(earlier, tree, stem, (("nekbone_pcg_update_kernel", (10,)),))
    return ok


def _sass_counts(earlier: dict, tree: dict, stem: str, kernels):
    """Static SASS instructions of the kernels' instantiations ``(name,
    leading integer template arguments)``, the earlier library's beside the
    tree's, in every build compared."""
    print(f"== {stem}: SASS instructions (static, whole kernel)", flush=True)
    for name, so in earlier.items():
        if not name.startswith(stem + "_"):
            continue
        old, new = sass(so), sass(tree[name])
        for kname, lead in kernels:
            def count(table):
                return sum(len(body) for key, body in table.items()
                           if isinstance(key, tuple) and key[0] == kname
                           and tuple(int(v) for v in key[1][:len(lead)])
                           == lead)
            print(f"  {name} {kname}<{', '.join(map(str, lead))}>: earlier "
                  f"{count(old)}, tree {count(new)}", flush=True)


@contextlib.contextmanager
def k12_variant(**consts):
    """K12's planner under the module constants ``consts``
    (``K12_MIN_THREADS``, ``K12_STAGES``) for the ``with`` block."""
    from repro_torch.kernels import nekbone_ax as K

    K._interp_device_plan.cache_clear()
    with patched(K, **consts):
        try:
            yield
        finally:
            K._interp_device_plan.cache_clear()


@contextlib.contextmanager
def k12_two_stages(path: pathlib.Path, mix: str):
    """The edited copy of K12 with a ring of two stages
    (``K12_TWO_STAGES``) in place of the tree's library, planned for it."""
    with swapped({f"nekbone_interp_{mix}": path}), \
            k12_variant(K12_STAGES=2):
        yield


def check_k12(earlier: dict, tree: dict, extra: dict) -> bool:
    import torch

    import chip_smoke as cs
    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import nekbone_ax as K

    stem = "nekbone_interp"
    mixes = [m for m in K.MIXES if f"{stem}_{m}" in earlier]
    old = {m: earlier_k12(earlier[f"{stem}_{m}"], m) for m in mixes}
    gen = torch.Generator("cuda").manual_seed(27)
    ok = True
    pairs = sorted(K.INTERP_PAIRS)
    print(f"== K12 beside the earlier kernel: v bitwise at every ladder pair "
          f"({len(pairs)}) and E = {K12_ES}; u 1 value off its allocation's "
          "start at E = 1024", flush=True)
    for mix in mixes:
        dt = K.MIXES[mix]
        bad = []
        for nin, nout in pairs:
            mt = cs._ladder_matrix(nin, nout, torch.float64).to(dt["O"])
            for E in K12_ES:
                u = torch.randn(E, nin ** 3, generator=gen,
                                dtype=torch.float64,
                                device="cuda").to(dt["S"])
                want = old[mix](u, mt, nin=nin, nout=nout)
                if not torch.equal(K.nekbone_interp_cuda(u, mt, nin=nin,
                                                         nout=nout), want):
                    bad.append((nin, nout, E))
                if E == 1024 and not torch.equal(K.nekbone_interp_cuda(
                        _off16(u), mt, nin=nin, nout=nout), want):
                    bad.append((nin, nout, E, "misaligned"))
        ok &= not bad
        print(f"  {mix}: bitwise {'every case' if not bad else f'NOT {bad}'}",
              flush=True)
    if "f64" in mixes:
        case = NekboneCase(n=10, grid=cs.PAPER_GRID, dtype=torch.float64,
                           ax_impl="pallas_fused_cg_v2")
        _, f = case.manufactured()
        r0 = float(torch.sqrt(torch.abs(torch.sum(f * case.c * f))))
        kw = dict(tol=cs.PMG_RTOL * r0, max_iter=cs.NITER, precond="pmg")
        new = case.solve(f, **kw)
        with patched(K, nekbone_interp_cuda=old["f64"]):
            prev = case.solve(f, **kw)
        # the history is NaN past the last iteration
        same = (torch.equal(new.history.nan_to_num(-1.0),
                            prev.history.nan_to_num(-1.0))
                and torch.equal(new.x, prev.x))
        ok &= same
        print(f"  fp64 pmg-PCG (paper case, to {cs.PMG_RTOL:g} r0): "
              f"{int(new.iters)} iterations, rnorm {float(new.rnorm):.6e}; "
              f"history and x bitwise over the earlier K12: {same}",
              flush=True)
    print("== K12: device ms in turns (CUDA events, 3 calls, median of 3) "
          "beside the earlier library, a ring of two stages (f64, bf16), "
          "other group sizes, layer by layer and (fp64) rows read as "
          "16-byte vectors; the empty kernel on each plan's grid",
          flush=True)
    for mix in mixes:
        dt = K.MIXES[mix]
        for grid in (cs.PAPER_GRID, cs.BIG_GRID):
            E = grid[0] * grid[1] * grid[2]
            for nin, nout in K12_LADDER:
                mt = cs._ladder_matrix(nin, nout, torch.float64).to(dt["O"])
                u = torch.randn(E, nin ** 3, generator=gen,
                                dtype=torch.float64,
                                device="cuda").to(dt["S"])

                def run():
                    return K.nekbone_interp_cuda(u, mt, nin=nin, nout=nout)
                plan, info = K.nekbone_interp_plan(E, nin, nout, mix)
                times = in_turns(run, lambda: patched(
                    K, nekbone_interp_cuda=old[mix]))
                two = extra.get(f"k12twostage_{mix}")
                if two is not None:
                    times.update(in_turns(
                        run, lambda: k12_two_stages(two, mix),
                        labels=("two stages", "tree (stages)")))
                floor = cs.device_ms(lambda: K.nekbone_interp_floor(plan,
                                                                    mix))
                want = run()
                notes = []
                for low in K12_GROUP_FLOORS:
                    if low == K.K12_MIN_THREADS:
                        continue
                    with k12_variant(K12_MIN_THREADS=low):
                        alt, _ = K.nekbone_interp_plan(E, nin, nout, mix)
                        same = torch.equal(run(), want)
                    if alt.group == plan.group:
                        continue
                    ok &= same
                    label = f"G={alt.group}"
                    times.update(in_turns(
                        run, lambda: k12_variant(K12_MIN_THREADS=low),
                        labels=(label, f"tree ({label})")))
                    notes.append(f"{label}: grid {alt.grid} x "
                                 f"{alt.per_block}, {alt.threads} threads, "
                                 f"{alt.blocks_per_sm} blocks an SM, "
                                 f"{alt.copy}, v bitwise: {same}")
                if (nin, nout) in ((10, 5), (5, 10)):
                    layered = {f"{stem}_{mix}": extra[f"k12layered_{mix}"]}
                    times.update(in_turns(run, lambda: swapped(layered),
                                          labels=("layer by layer",
                                                  "tree (layers)")))
                    with swapped(layered):
                        same = torch.equal(run(), want)
                    ok &= same
                    notes.append(f"layer by layer: v bitwise: {same}")
                if mix == "f64" and (nin, nout) == (10, 5):
                    vector = {f"{stem}_{mix}": extra[f"k12vector_{mix}"]}
                    times.update(in_turns(run, lambda: swapped(vector),
                                          labels=("vector rows",
                                                  "tree (rows)")))
                    with swapped(vector):
                        same = torch.equal(run(), want)
                    ok &= same
                    notes.append(f"vector rows' v bitwise: {same}")
                stages = "no copy"
                if two is not None:
                    with k12_two_stages(two, mix):
                        alt, _ = K.nekbone_interp_plan(E, nin, nout, mix)
                        same = torch.equal(run(), want)
                    ok &= same
                    stages = (f"G={alt.group}, grid {alt.grid} x "
                              f"{alt.per_block}, {alt.blocks_per_sm} blocks "
                              f"an SM, {alt.smem_bytes} B, v bitwise: {same}")
                best = _best(times)
                regs, spill = cs._ptxas_report(
                    tree[f"{stem}_{mix}"].with_suffix(".log").read_text())[
                    f"nekbone_interp_kernel<{nin},{nout}>"]
                print(f"  {mix} {nin}->{nout} E={E}: plan G={plan.group}, "
                      f"grid {plan.grid} x {plan.per_block} groups, "
                      f"{plan.threads} threads, {plan.blocks_per_sm} blocks "
                      f"an SM, {plan.smem_bytes} B ({plan.copy}), {regs} "
                      f"registers, {spill} B spilled; {_fmt(times)}; tree / "
                      f"earlier {best['tree'] / best['earlier']:.3f}; empty "
                      f"kernel on this grid {floor:.4f} ms; two stages: "
                      f"{stages}"
                      + "".join(f"; {note}" for note in notes), flush=True)
                del u
    _sass_counts(earlier, tree, stem, (("nekbone_interp_kernel", (10, 5)),
                                       ("nekbone_interp_kernel", (5, 10))))
    return ok


# The tree's other stems a check's solve launches (K9's s-step CG: K8;
# K10's Jacobi-PCG: K4; K12's pmg-PCG: K4, K5 and K11).
ROUTE_STEMS = {"nekbone_sstep_update": ("nekbone_ax_powers",),
               "nekbone_pcg_update": ("nekbone_ax_slab",),
               "nekbone_interp": ("nekbone_ax_slab", "nekbone_cg_update",
                                  "nekbone_cheb_apply")}
# {stem: (its check, {tag: (dtype, edits of the tree's source)})}
CHECKS = {"nekbone_ax": (check_k1, {
              f"k1{form}_{m}": (m, edits)
              for form, edits in (("scalar", SCALAR_SWEEP),
                                  ("transposed", TRANSPOSED_SWEEP))
              for m in ("f64", "f32", "bf16", "bf16_ir")}),
          "nekbone_sstep_update": (check_k9, {
              f"k9rolled_{m}": (m, ROLLED_COLUMNS)
              for m in ("f64", "f32", "bf16", "bf16_ir")}),
          "nekbone_pcg_update": (check_k10, {
              "k10cap_f64": ("f64", K10_K9_CAP)}),
          "nekbone_interp": (check_k12, {
              **{f"k12vector_{m}": (m, K12_VECTOR_ROWS) for m in ("f64",)},
              **{f"k12twostage_{m}": (m, K12_TWO_STAGES)
                 for m in ("f64", "bf16")},
              **{f"k12layered_{m}": (m, K12_LAYERED)
                 for m in ("f64", "f32", "bf16", "bf16_ir")}}),
          "nekbone_ax_dots": (check_k2, {}),
          "nekbone_cg_update": (check_k5, {}),
          "nekbone_cg_update_block": (check_k7, {}),
          "flash_attn": (check_k13, {"qreload": ("bf16", Q_RELOAD)})}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True,
                    help="a checkout (or archive) of the earlier commit")
    ap.add_argument("--changed", nargs="*", default=(),
                    help="stems whose kernels the tree redesigned: their "
                         "SASS is reported, not held, and their checks "
                         "run")
    ap.add_argument("--builds", nargs="+", required=True,
                    help="the earlier libraries to build and compare, "
                         "<stem>_<dtype> (nekbone_ax_f64, flash_attn_bf16) "
                         "or a stem (every build of it)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("parent_compare.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    builds = [pair for name in args.builds for pair in (
        [(name, dtype) for dtype in _build.SOURCES.get(name, ())]
        if name in _build.SOURCES else [_build.split_name(name)])]
    stems = list(dict.fromkeys(stem for stem, _ in builds))
    unknown = [f"{stem}_{dtype}" for stem, dtype in builds
               if dtype not in _build.SOURCES.get(stem, ())]
    if unknown:
        raise SystemExit(f"the package builds none of {unknown}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    # the stems checked: those redesigned; the others are held by their SASS
    checked = [stem for stem in stems if stem in args.changed]
    # only the libraries compared, and those the checks' routes launch
    _build.SOURCES = {stem: _build.SOURCES[stem] for stem in [
        *stems, *(need for stem in checked for need in ROUTE_STEMS.get(
            stem, ()) if need not in stems)]}
    csrc = args.parent.resolve() / "src/repro_torch/kernels/csrc"
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {f"{stem}_{dtype}": start_build(
        csrc / f"{stem}.cu", OUT / f"{stem}_{dtype}.so", dtype)
        for stem, dtype in builds}
    for stem in checked:
        for tag, (dtype, edits) in CHECKS.get(stem, (None, {}))[1].items():
            procs[tag] = start_build(edited(stem, edits, tag),
                                     OUT / f"{stem}_{tag}_{dtype}.so", dtype)
        # the tree's own libraries of a redesigned stem, for their compile
        # time beside the earlier ones'
        for dtype in _build.SOURCES[stem]:
            procs[f"tree {stem}_{dtype}"] = start_build(
                _build.CSRC / f"{stem}.cu", OUT / f"tree_{stem}_{dtype}.so",
                dtype)
    tree = _build.build_all()
    built, cpu = wait_builds(procs)
    unchecked = {f"{stem}_{dtype}" for stem, dtype in builds
                 if stem not in checked}
    print("== nvcc CPU seconds (one library each, all started together): "
          + "; ".join(f"{key} {t:.1f}" for key, t in cpu.items()
                      if key not in unchecked), flush=True)
    earlier = {name: so for name, so in built.items() if name in tree}
    extra = {tag: so for tag, so in built.items() if tag not in tree}
    ok = compare_sass({name: so for name, so in earlier.items()
                       if name.startswith("nekbone_")}, tree, args.changed)
    for stem in checked:
        if stem in CHECKS:
            ok &= CHECKS[stem][0](earlier, tree, extra)
    print(f"parent_compare: {'every check held' if ok else 'A CHECK FAILED'}",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
