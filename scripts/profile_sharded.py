#!/usr/bin/env python3
"""Where an iteration of the sharded Jacobi-PCG spends its time, on one card.

Run from the root of a checkout, on a machine with an NVIDIA card::

    python3 scripts/profile_sharded.py [--iters 100] [--out FILE.json]

It builds the f64 Nekbone libraries (one ``nvcc`` each, all in parallel)
and solves the paper case (n = 10, grid 8x8x16, E = 1024, fp64) with
Jacobi-PCG for a fixed number of iterations in four configurations, each
in processes of its own:

* ``single``: one process, ``core/precond.pcg_fused_v2_fixed_iters``;
* ``nccl1``: an NCCL world of one rank, ``distributed/pcg.
  pcg_sharded_fixed_iters`` (no peer; the collectives stay on the card);
* ``gloo1``: a gloo world of one rank (no peer; the psums go through the
  host);
* ``gloo2``: a gloo world of two ranks sharing the card (the planes and
  the psums go through the host; rank 0 is reported).

For each: a warm solve, a timed solve (ms per iteration, host clock around
a synchronised solve), and the same solve under ``torch.profiler`` (host
and device activity; set-up included in both): the device time per
iteration (the union of the device
activity intervals) beside the timed solve's, which gives the card's busy
share, and the host's self time by op per iteration.  In the sharded
configurations it also times the driver's own steps alone at the paper
shapes, each called 200 times back to back and synchronised once: K4's and
K10's wrappers, ``core/gs.edge_planes``, ``sharding.ppermute_pair`` and the
two psums.  It prints one line per configuration and writes everything
as JSON to ``--out``.  Times are of processes that share one card: not a
scaling figure.
"""
from __future__ import annotations

import argparse
import datetime
import json
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CONFIGS = {"single": (None, 1), "nccl1": ("nccl", 1), "gloo1": ("gloo", 1),
           "gloo2": ("gloo", 2)}
REPEATS = 200
CHILD_TIMEOUT_S = 300
INIT_TIMEOUT_S = 60


def _f64_only():
    """Limit the build to the f64 Nekbone libraries (the routes run no
    other)."""
    from repro_torch.kernels import _build

    _build.SOURCES = {stem: ("f64",) for stem in _build._NEKBONE}
    return _build


def _device_us(prof) -> float:
    """The union of the profiled device activity's intervals, in µs."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _host_ops(prof, iters: int, top: int = 14) -> list:
    rows = [(e.key, e.count / iters, e.self_cpu_time_total / iters)
            for e in prof.key_averages()]
    rows.sort(key=lambda r: -r[2])
    return [{"op": k, "calls_per_iter": c, "self_cpu_us_per_iter": t}
            for k, c, t in rows[:top]]


def _timed(fn, reps: int) -> float:
    """ms per call of ``reps`` back-to-back calls, synchronised once."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _steps(case, f, jac, mesh) -> dict:
    """The sharded Jacobi iteration's steps, each timed alone."""
    import torch

    from repro_torch.core.cg_fused import _prepare
    from repro_torch.core.gs import edge_planes
    from repro_torch.distributed import sharding
    from repro_torch.distributed.pcg import _Shard
    from repro_torch.kernels import nekbone_ax as _ax

    policy, b, n, grid, op = _prepare(f, case.D, case.g, case.grid,
                                      case.mask, case.c, None)
    sh = _Shard(op, grid, mesh, policy)
    E = b.shape[0]
    b2 = sharding.shard_leading(b.reshape(E, n ** 3), mesh).contiguous()
    invd2 = sharding.shard_leading(
        jac.invdiag.to(b.dtype).reshape(E, n ** 3), mesh).contiguous()
    beta = torch.zeros((), dtype=b.dtype, device=b.device)
    p2, w2, pap = sh.ax(torch.zeros_like(b2), b2, beta)
    alpha = 1.0 / pap
    below, above = sh.planes(w2)
    o = sh.op
    bottom, top = edge_planes(w2, sh.grid_local, sh.acc)
    rtz_e = torch.rand(b2.shape[0], dtype=b.dtype, device=b.device)

    def k4():
        _ax.nekbone_ax_slab_cuda(p2, b2, o["D"], o["g3"], o["mx"], o["my"],
                                 o["mz"], beta, n=n)

    def k10():
        _ax.nekbone_pcg_update_cuda(
            b2, p2, b2, w2, alpha, invd2, o["cx"], o["cy"], o["cz"], n=n,
            from_below=below, from_above=above)

    return {
        "K4 wrapper (nekbone_ax_slab_cuda)": _timed(k4, REPEATS),
        "K10 wrapper (nekbone_pcg_update_cuda)": _timed(k10, REPEATS),
        "pap psum (torch.sum + psum)": _timed(
            lambda: sharding.psum(torch.sum(rtz_e).reshape(1), mesh),
            REPEATS),
        "edge_planes": _timed(
            lambda: edge_planes(w2, sh.grid_local, sh.acc), REPEATS),
        "ppermute_pair": _timed(
            lambda: sharding.ppermute_pair(top, bottom, mesh), REPEATS),
        "psum2 (2 torch.sum + stack + psum)": _timed(
            lambda: sh.psum2(rtz_e, rtz_e), REPEATS),
    }


def child(config: str, rank: int, init: str, out: str, iters: int) -> int:
    import torch
    import torch.distributed as dist

    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.core.precond import pcg_fused_v2_fixed_iters
    from repro_torch.distributed import pcg, sharding

    _f64_only()
    backend, world = CONFIGS[config]
    torch.cuda.set_device(0)
    if backend is not None:
        dist.init_process_group(
            backend, init_method=f"file://{init}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    try:
        case = NekboneCase(n=10, grid=(8, 8, 16), dtype=torch.float64)
        f = case.manufactured()[1]
        jac = case.precond_spec("jacobi")
        common = dict(D=case.D, g=case.g, grid=case.grid, mask=case.mask,
                      c=case.c, precond=jac)
        mesh = sharding.solver_mesh() if backend else None

        def solve(k):
            if backend is None:
                return pcg_fused_v2_fixed_iters(f, niter=k, **common)
            return pcg.pcg_sharded_fixed_iters(f, niter=k, mesh=mesh,
                                               **common)

        solve(iters)                                   # warm
        torch.cuda.synchronize()
        if backend:
            dist.barrier()
        t0 = time.perf_counter()
        solve(iters)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / iters
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        if backend:
            dist.barrier()
        with torch.profiler.profile(activities=acts) as prof:
            solve(iters)
            torch.cuda.synchronize()
        dev_ms = _device_us(prof) / 1e3 / iters
        report = dict(config=config, rank=rank, ms_per_iter=ms,
                      device_ms_per_iter=dev_ms, busy=dev_ms / ms,
                      host_ops=_host_ops(prof, iters))
        if backend:
            dist.barrier()
            report["steps_ms"] = _steps(case, f, jac, mesh)
        pathlib.Path(out).write_text(json.dumps(report))
    finally:
        if backend is not None:
            dist.destroy_process_group()
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        cfg, rank, init, out, iters = sys.argv[2:7]
        return child(cfg, int(rank), init, out, int(iters))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "chiprun_out" / "profile_sharded.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_sharded.py: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _f64_only().build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s ({smi})", flush=True)
    reports = {}
    with tempfile.TemporaryDirectory(prefix="profile-sharded-") as tmp:
        for cfg, (_, world) in CONFIGS.items():
            init = pathlib.Path(tmp) / f"{cfg}.rendezvous"
            outs = [pathlib.Path(tmp) / f"{cfg}.{r}.json"
                    for r in range(world)]
            procs = [subprocess.Popen(
                [sys.executable, __file__, "--child", cfg, str(r), str(init),
                 str(outs[r]), str(args.iters)]) for r in range(world)]
            deadline = time.perf_counter() + CHILD_TIMEOUT_S
            ok = True
            for p in procs:
                try:
                    p.wait(timeout=max(deadline - time.perf_counter(), 1.0))
                except subprocess.TimeoutExpired:
                    for q in procs:
                        q.kill()
                    p.wait()
                ok &= p.returncode == 0
            if not ok:
                print(f"{cfg}: a rank failed", flush=True)
                return 1
            reports[cfg] = json.loads(outs[0].read_text())
            r = reports[cfg]
            print(f"{cfg}: {r['ms_per_iter']:.4f} ms per iteration, device "
                  f"{r['device_ms_per_iter']:.4f} ms (busy {r['busy']:.3f}); "
                  "host self time per iteration by op: "
                  + "; ".join(f"{h['op']} x{h['calls_per_iter']:g} "
                              f"{h['self_cpu_us_per_iter']:.1f} us"
                              for h in r["host_ops"][:8]), flush=True)
            if "steps_ms" in r:
                print(f"  {cfg} steps alone, ms per call: "
                      + "; ".join(f"{k} {v:.4f}"
                                  for k, v in r["steps_ms"].items()),
                      flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(device=smi, iters=args.iters,
                                        reports=reports), indent=1))
    print(f"wrote {args.out} ({smi}); {time.perf_counter() - t0:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
