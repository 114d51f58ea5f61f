#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc``, imports neither ``jax`` nor the
reference package ``repro``, and, in order:

1. prints the card, its power limit, and the torch / CUDA / nvcc versions;
2. builds the three CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. measures device-to-device copy bandwidth on a 1 GiB buffer (the
   measured roofline);
4. holds K1 (the operator kernel) against its plain PyTorch version, n=2..16
   at small E and n=10 at E=1024, fp64 and fp32;
5. holds K4 and K5 (the v2 CG iteration) against their plain versions for
   one iteration of the paper case, fp64 and fp32;
6. solves the paper case (n=10, E=1024, fp64, 100 CG iterations) through
   ``NekboneCase.solve`` with ``ax_impl='pallas'`` (K1 in the reference CG
   loop) and ``'pallas_fused_cg_v2'`` (K4 + K5), each against the plain
   ``'fused'`` route on the card, and shows from the launch counters that
   each route ran through its kernels;
7. times every kernel and its plain version (device time by CUDA events)
   at E=1024 and E=4096, and the solves per iteration (host clock);
8. profiles 20 iterations of each kernel route (device time per
   iteration, by kernel, and the device's busy share);
9. prints the ``kernels`` JSON line, the card line, and last the result line
   ``{"ok": true, "device": {...}}``.

Any failed check exits with status 1 and prints no result line.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data sheet: device-memory rate, and peak fp64 / fp32 rates outside
# the tensor cores.  bound_ms = max(bytes / BW_PEAK, flops / FLOPS_PEAK).
BW_PEAK = 3.35e12
FLOPS_PEAK = {"float64": 34e12, "float32": 67e12}

PAPER_GRID = (8, 8, 16)       # E = 1024, PAPER_CASES[1024]
BIG_GRID = (16, 16, 16)       # E = 4096, the paper's largest case
NITER = 100
HIST_RTOL_HEAD = 1e-12        # first 10 history entries
# All 101 entries: over 100 iterations CG amplifies round-off, and the plain
# route itself, evaluated on the CPU and on the card, differs by about 1e-2
# at its worst entry.  A kernel route must stay within this factor of that
# spread.
ENVELOPE_FACTOR = 10.0
# about 10 ms of spin at the H100's clock: longer than the host takes to
# enqueue the calls that device_ms times after it.
SPIN_CYCLES = 20_000_000


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)
    print(f"  ok  {what}", flush=True)


def device_ms(fn, *, calls: int = 20, reps: int = 5,
              warmup: int = 3) -> float:
    """Device time of one call of ``fn``: CUDA events around ``calls``
    back-to-back calls, median over ``reps``.  A spin kernel queued first
    lets the host enqueue all the calls before the first one runs, so the
    host's own time per call (wrapper checks, launch) stays out of it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def wall_ms(fn, *, reps: int = 5, warmup: int = 1) -> float:
    """Host-clock time of one call of ``fn`` that ends in a synchronize,
    median over ``reps`` (what a caller of ``fn`` waits)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def phase_device():
    import torch

    print("== device", flush=True)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    from repro_torch.kernels import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()
    print(f"  device {name}, count {torch.cuda.device_count()}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {nvcc[-1] if nvcc else '?'}", flush=True)
    return name, smi[0] if smi else "nvidia-smi: no output"


def phase_build():
    from repro_torch.kernels import _build

    print("== build", flush=True)
    t0 = time.perf_counter()
    paths = _build.build_all()
    seconds = time.perf_counter() - t0
    for stem, path in paths.items():
        log = path.with_suffix(".log").read_text()
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line
                  and "0 bytes spill stores, 0 bytes spill loads" not in line]
        print(f"  {stem}: {path.name}, instantiations with spills: "
              f"{len(spills)}")
    print(f"  build seconds {seconds:.1f} (0 when cached)", flush=True)
    return seconds


def phase_copy_bandwidth():
    import torch

    print("== copy bandwidth (measured roofline)", flush=True)
    nbytes = 2 ** 30
    src = torch.ones(nbytes // 8, dtype=torch.float64, device="cuda")
    dst = torch.empty_like(src)
    ms = device_ms(lambda: dst.copy_(src), calls=5)
    bw = 2 * nbytes / (ms * 1e-3)           # read once + written once
    print(f"  1 GiB copy: {ms:.3f} ms, {bw / 1e9:.1f} GB/s "
          f"(read + write bytes / time)", flush=True)
    del src, dst
    return bw


def _operator_data(rng, E, n, dtype):
    import torch

    from repro_torch.core.geom import random_spd_metric
    from repro_torch.core.sem import derivative_matrix

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device="cuda")

    u = dev(rng.normal(size=(E, n ** 3)))
    g = dev(random_spd_metric(rng, E, n).reshape(E, 6, n ** 3))
    D = dev(derivative_matrix(n))
    return u, D, g


def phase_k1_parity():
    import numpy as np
    import torch

    from repro_torch.kernels import nekbone_ax as K

    print("== K1 parity (kernel vs plain, random SPD metric)", flush=True)
    rng = np.random.default_rng(0)
    main_err = None
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        errs = {}
        for n in K.N_RANGE:
            u, D, g = _operator_data(rng, 8, n, dtype)
            w = K.nekbone_ax_cuda(u, D, g, n=n)
            errs[n] = rel_err(w, K.nekbone_ax_plain(u, D, g, n=n))
        print(f"  K1 {dtype} E=8, max rel err by n: "
              + " ".join(f"{n}:{e:.1e}" for n, e in errs.items()))
        check(max(errs.values()) <= tol,
              f"K1 {dtype} n=2..16, E=8: every n within {tol:g}")
        u, D, g = _operator_data(rng, 1024, 10, dtype)
        w = K.nekbone_ax_cuda(u, D, g, n=10)
        wp = K.nekbone_ax_plain(u, D, g, n=10)
        err = rel_err(w, wp)
        check(err <= tol, f"K1 {dtype} n=10, E=1024: max rel err "
                          f"{err:.2e} <= {tol:g}")
        if dtype == torch.float64:
            main_err = float((w - wp).abs().max())
    torch.cuda.synchronize()
    return main_err


def _v2_operands(case, rng):
    """Continuous p_prev, r; random x; the factors and diagonal metric."""
    import torch

    from repro_torch.core.gs import ds_sum_local
    from repro_torch.kernels import ops

    E, n = case.mesh.nelt, case.n
    dt = case.dtype

    def continuous():
        u = torch.as_tensor(rng.normal(size=(E, n, n, n)), dtype=dt,
                            device="cuda")
        return (ds_sum_local(u, case.grid) * case.mask).reshape(E, n ** 3)

    (mx, my, mz), (cx, cy, cz) = ops.slab_axis_factors(case.grid, n, dt,
                                                       "cuda")
    return dict(
        p=continuous().contiguous(), r=continuous().contiguous(),
        x=torch.as_tensor(rng.normal(size=(E, n ** 3)), dtype=dt,
                          device="cuda"),
        g3=ops.diag_metric(case.g, E, n), m=(mx, my, mz), c=(cx, cy, cz),
        beta=torch.tensor(0.37, dtype=dt, device="cuda"),
        alpha=torch.tensor(0.81, dtype=dt, device="cuda"))


def phase_v2_parity():
    import numpy as np
    import torch

    from repro_torch.core.gs import ds_sum_local
    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import nekbone_ax as K

    print("== K4/K5 parity (one v2 iteration, paper case)", flush=True)
    rng = np.random.default_rng(1)
    errs = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        case = NekboneCase(n=10, grid=PAPER_GRID, dtype=dtype)
        o = _v2_operands(case, rng)
        E, n = case.mesh.nelt, case.n
        kp, kw, kpap = K.nekbone_ax_slab_cuda(o["p"], o["r"], case.D,
                                              o["g3"], *o["m"], o["beta"],
                                              n=n)
        pp, pw, ppap = K.nekbone_ax_slab_plain(o["p"], o["r"], case.D,
                                               o["g3"], *o["m"], o["beta"],
                                               n=n)
        check(torch.equal(kp, pp), f"K4 {dtype}: p = r + beta p bitwise")
        check(rel_err(kw, pw) <= tol,
              f"K4 {dtype}: w max rel err {rel_err(kw, pw):.2e} <= {tol:g}")
        pap_err = abs(float(kpap.sum() - ppap.sum())) / abs(float(ppap.sum()))
        check(pap_err <= tol, f"K4 {dtype}: pap rel err {pap_err:.2e}")
        # K5 on K4's own outputs, both sides: x and r bitwise
        kx, kr, krcr = K.nekbone_cg_update_cuda(o["x"], kp, o["r"], kw,
                                                o["alpha"], *o["c"], n=n)
        px, pr, prcr = K.nekbone_cg_update_plain(o["x"], kp, o["r"], kw,
                                                 o["alpha"], *o["c"], n=n)
        check(torch.equal(kx, px) and torch.equal(kr, pr),
              f"K5 {dtype}: x += alpha p, r -= alpha gs(w) bitwise")
        rcr_err = abs(float(krcr.sum() - prcr.sum())) / abs(float(prcr.sum()))
        check(rcr_err <= tol, f"K5 {dtype}: rcr rel err {rcr_err:.2e}")
        # with r = 0, alpha = -1 the stored r is the assembled w itself
        zero = torch.zeros_like(o["x"])
        _, wa, _ = K.nekbone_cg_update_cuda(
            zero, zero, zero, kw, torch.tensor(-1.0, dtype=dtype,
                                               device="cuda"), *o["c"], n=n)
        want = ds_sum_local(kw.reshape(E, n, n, n), case.grid)
        check(torch.equal(wa, want.reshape(E, n ** 3)),
              f"K5 {dtype}: assembly bitwise ds_sum_local")
        if dtype == torch.float64:
            errs["K4"] = float((kw - pw).abs().max())
            errs["K5"] = float((kr - pr).abs().max())
    torch.cuda.synchronize()
    return errs


def phase_routes():
    import numpy as np
    import torch

    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import nekbone_ax as K

    print(f"== paper case, both routes: n=10, E=1024, fp64, {NITER} "
          "iterations", flush=True)
    want_launches = {
        "fused": {"nekbone_ax": 0, "nekbone_ax_slab": 0,
                  "nekbone_cg_update": 0},
        "pallas": {"nekbone_ax": NITER, "nekbone_ax_slab": 0,
                   "nekbone_cg_update": 0},
        "pallas_fused_cg_v2": {"nekbone_ax": 0, "nekbone_ax_slab": NITER,
                               "nekbone_cg_update": NITER},
    }
    hist, launches, cases = {}, {}, {}
    for impl in want_launches:
        case = NekboneCase(n=10, grid=PAPER_GRID, dtype=torch.float64,
                           ax_impl=impl)
        u_ex, f = case.manufactured()
        K.reset_launches()
        res = case.solve(f, niter=NITER)
        torch.cuda.synchronize()
        launches[impl] = dict(K.LAUNCHES)
        h = res.history.cpu().numpy()
        check(h.shape == (NITER + 1,) and bool(np.isfinite(h).all())
              and tuple(res.x.shape) == tuple(f.shape)
              and bool(torch.isfinite(res.x).all()),
              f"{impl}: finite x of shape {tuple(res.x.shape)}, "
              f"history of {h.size}")
        err = float(case.solution_error(res.x, u_ex))
        print(f"  {impl}: history[0]={h[0]:.6e} history[{NITER}]="
              f"{h[NITER]:.6e} solution_error={err:.6e} launches="
              f"{launches[impl]}", flush=True)
        check(launches[impl] == want_launches[impl],
              f"{impl}: launches {launches[impl]}")
        hist[impl] = h
        cases[impl] = (case, f)
    # the round-off envelope: the same plain route on the CPU, a second
    # valid fp64 evaluation order of the same algorithm
    cpu_case = NekboneCase(n=10, grid=PAPER_GRID, dtype=torch.float64,
                           ax_impl="fused", device="cpu")
    hist["fused on the CPU"] = cpu_case.solve(
        cpu_case.manufactured()[1], niter=NITER).history.numpy()
    base = hist["fused"]
    dev = {}
    for impl in ("fused on the CPU", "pallas", "pallas_fused_cg_v2"):
        dev[impl] = np.abs(hist[impl] - base) / base
        k = int(dev[impl].argmax())
        print(f"  {impl} vs fused: largest rel deviation, entries 0..10: "
              f"{float(dev[impl][:11].max()):.2e}; 0..{NITER}: "
              f"{float(dev[impl].max()):.2e} at entry {k} (fused "
              f"{base[k]:.6e}, {impl} {hist[impl][k]:.6e}); max over "
              "0..k by k: " + " ".join(
                  f"{j}:{float(dev[impl][:j + 1].max()):.1e}"
                  for j in range(10, NITER + 1, 10)), flush=True)
    envelope = float(dev["fused on the CPU"].max())
    for impl in ("pallas", "pallas_fused_cg_v2"):
        check(float(dev[impl][:11].max()) <= HIST_RTOL_HEAD,
              f"{impl}: history entries 0..10 within rtol "
              f"{HIST_RTOL_HEAD:g} of fused")
        check(float(dev[impl].max())
              <= max(HIST_RTOL_HEAD, ENVELOPE_FACTOR * envelope),
              f"{impl}: all {NITER + 1} entries within {ENVELOPE_FACTOR:g}x "
              f"the plain route's own CPU-vs-card spread ({envelope:.2e}) "
              f"or {HIST_RTOL_HEAD:g}")
    return launches, cases


def phase_times(bw_copy, cases):
    import numpy as np
    import torch

    from repro_torch.core import cost
    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import nekbone_ax as K

    print("== times (fp64, n=10; kernels and plain versions: device time per "
          "call, CUDA events around 20 queued calls, median of 5; solves: "
          "host clock to synchronize, median of 5)", flush=True)
    rng = np.random.default_rng(2)
    n = 10
    rows = {}
    for grid in (PAPER_GRID, BIG_GRID):
        case = NekboneCase(n=n, grid=grid, dtype=torch.float64)
        E = case.mesh.nelt
        field = E * n ** 3 * 8
        u, D, g = _operator_data(rng, E, n, torch.float64)
        o = _v2_operands(case, rng)
        kp, kw, _ = K.nekbone_ax_slab_cuda(o["p"], o["r"], case.D, o["g3"],
                                           *o["m"], o["beta"], n=n)
        work = {
            "K1": (lambda: K.nekbone_ax_cuda(u, D, g, n=n),
                   lambda: K.nekbone_ax_plain(u, D, g, n=n),
                   8 * field, cost.ax_local_flops(E, n)),
            "K4": (lambda: K.nekbone_ax_slab_cuda(
                       o["p"], o["r"], case.D, o["g3"], *o["m"], o["beta"],
                       n=n),
                   lambda: K.nekbone_ax_slab_plain(
                       o["p"], o["r"], case.D, o["g3"], *o["m"], o["beta"],
                       n=n),
                   7 * field, E * n ** 3 * (12 * n + 10)),
            "K5": (lambda: K.nekbone_cg_update_cuda(
                       o["x"], kp, o["r"], kw, o["alpha"], *o["c"], n=n),
                   lambda: K.nekbone_cg_update_plain(
                       o["x"], kp, o["r"], kw, o["alpha"], *o["c"], n=n),
                   6 * field, E * n ** 3 * 8),
        }
        for name, (kern, plain, nbytes, flops) in work.items():
            ms = device_ms(kern)
            plain_ms = device_ms(plain)
            t_bytes = nbytes / BW_PEAK * 1e3
            t_ops = flops / FLOPS_PEAK["float64"] * 1e3
            rows[(name, grid)] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_copy_ms=nbytes / bw_copy * 1e3, bytes=nbytes)
            print(f"  {name} E={E}: kernel {ms:.4f} ms "
                  f"({nbytes / ms / 1e6:.0f} GB/s, "
                  f"{nbytes / ms / 1e6 / (bw_copy / 1e9):.2f} of copy BW); "
                  f"plain {plain_ms:.4f} ms; bound {max(t_bytes, t_ops):.4f}"
                  f" ms at 3.35 TB/s, {nbytes / bw_copy * 1e3:.4f} ms at "
                  f"measured copy BW; {nbytes / 1e6:.1f} MB", flush=True)
        del u, D, g, o, kp, kw
    # whole solves per iteration, paper case (the cases of phase_routes)
    for impl, (case, f) in cases.items():
        ndof = case.mesh.ndof
        book = sum(cost.fused_v2_cg_iter_bytes(ndof, 8)
                   if impl == "pallas_fused_cg_v2"
                   else cost.cg_iter_bytes(ndof, 8))
        ms = wall_ms(lambda: case.solve(f, niter=NITER)) / NITER
        print(f"  solve {impl} E={case.mesh.nelt}: {ms:.4f} ms/iteration; "
              f"book {book / 1e6:.1f} MB/iteration -> "
              f"{book / ms / 1e6:.0f} GB/s", flush=True)
    return rows


def phase_profile(cases, niter: int = 20):
    """Device time per iteration of each solve, by kernel, from
    torch.profiler; the busy share is device time over the span from the
    first to the last device event (the profiler slows the host, so the
    idle share it shows is an upper bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    print(f"== profile ({niter}-iteration solves under torch.profiler)",
          flush=True)
    for impl in ("pallas", "pallas_fused_cg_v2"):
        case, f = cases[impl]
        case.solve(f, niter=2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            case.solve(f, niter=niter)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if not kernels:
            print(f"  {impl}: the profiler saw no device time")
            continue
        busy = sum(e.time_range.elapsed_us() for e in kernels)
        span = (max(e.time_range.end for e in kernels)
                - min(e.time_range.start for e in kernels))
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        print(f"  {impl}: device {busy / niter:.1f} us/iteration in "
              f"{len(kernels) / niter:.1f} device ops/iteration; busy "
              f"{busy / span:.2f} of the device span; top: " + "; ".join(
                  f"{name[:48]} {t / niter:.1f} us" for name, t in top),
              flush=True)


def main() -> int:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "false); this smoke test runs only on the card",
              file=sys.stderr)
        return 2
    if shutil.which("nvidia-smi") is None:
        print("chip_smoke.py: nvidia-smi not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        name, smi_line = phase_device()
        phase_build()
        bw = phase_copy_bandwidth()
        err = {"K1": phase_k1_parity()}
        err.update(phase_v2_parity())
        launches, cases = phase_routes()
        rows = phase_times(bw, cases)
        phase_profile(cases)
    except CheckFailed as exc:
        print(f"FAILED: {exc}", flush=True)
        return 1

    meta = {
        "K1": ("nekbone_ax", "src/repro_torch/kernels/csrc/nekbone_ax.cu",
               "src/repro/kernels/nekbone_ax.py:240", "pallas"),
        "K4": ("nekbone_ax_slab",
               "src/repro_torch/kernels/csrc/nekbone_ax_slab.cu",
               "src/repro/kernels/nekbone_ax.py:476", "pallas_fused_cg_v2"),
        "K5": ("nekbone_cg_update",
               "src/repro_torch/kernels/csrc/nekbone_cg_update.cu",
               "src/repro/kernels/nekbone_ax.py:625", "pallas_fused_cg_v2"),
    }
    kernels = []
    for key, (kname, source, replaces, route) in meta.items():
        row = rows[(key, PAPER_GRID)]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[route][kname],
            "max_abs_err": err[key], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
