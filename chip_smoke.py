#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc``, imports neither ``jax`` nor the
reference package ``repro``, and, in order:

1. prints the card, its power limit, and the torch / CUDA / nvcc versions;
2. builds the CUDA kernels from the thirteen sources of
   ``src/repro_torch/kernels/csrc``, one ``nvcc`` per source and dtype (48
   libraries: f64, f32 and the two bf16 operand mixes ``bf16`` and
   ``bf16_ir`` for the Nekbone kernels K1 to K12; f32 and bf16 for K13 and
   K14), in parallel, prints its wall time, K13's registers, spills and
   shared memory at every head size (16, 64, 128, 192), and shows from
   the bf16 K13's machine code (``cuobjdump -sass``) that it runs
   tensor-core MMAs (HMMA) on operands copied by cp.async (LDGSTS);
3. measures device-to-device copy bandwidth on a 1 GiB buffer (the
   measured roofline);
4. holds K1 (the operator kernel) against its plain PyTorch version, n=2..16
   at small E and n=10 at E=1024, fp64 and fp32; then K1's walker: its
   launch plans at n = 10, E = 1024 and 4096 in every build (grid,
   elements a block, stages, staged operands, copy path, shared memory,
   registers and spills), every build at n = 2, 3, 5, 10, 16 over E = 1,
   7, 131, 133, 1024, 4096 (f64 and f32 relative, bf16 value by value),
   and u and the metric 1 value off their allocations' start (the
   cp.async path) with w bitwise the aligned call's;
5. holds K4 and K5 (the v2 CG iteration) against their plain versions for
   one iteration of the paper case, fp64 and fp32, at n = 10, 5 and 3 (the
   degrees of the p-multigrid ladder);
6. solves the paper case (n=10, E=1024, fp64, 100 CG iterations) through
   ``NekboneCase.solve`` with ``ax_impl='pallas'`` (K1 in the reference CG
   loop) and ``'pallas_fused_cg_v2'`` (K4 + K5), each against the plain
   ``'fused'`` route on the card, and shows from the launch counters that
   each route ran through its kernels;
7. holds K10 (the Jacobi-PCG update) and K11 (the Chebyshev apply, one
   cooperative launch per call) against their plain versions: the paper
   grid at n = 10, 5 and 3, n=6, and the 16x16x16 grid (E=4096) at n=10,
   fp64 and fp32, k = 1, 2, 4; prints K11's launch plan for each (variant,
   grid, blocks per SM, shared memory, registers), shows that the
   shared-memory variant ran at E=1024 and the device-memory variant at
   E=4096, that 5 repeated calls give bitwise the same z and rtz, and K11's
   max abs error beside the earlier chain's;
8. solves the paper case through the three routes this slice added, each
   with the launch counters reset just before it: Jacobi-PCG over K4 + K10
   (100 iterations, against the plain route with the same preconditioner),
   Chebyshev-PCG(4) to rnorm <= 1e-8 over K11 + K4 + K5 (at most 34
   iterations), and the tolerance-driven v2 solve (its history bitwise a
   prefix of the fixed run's);
9. holds K12 (the p-multigrid interpolation) against its plain version for
   every step of the ladder at E=1024 (bitwise, fp64 and fp32) with face
   values kept bitwise, and K6 and K7 (the multi-RHS block kernels)
   against K4 and K5 lane by lane (bitwise at b = 1, 2, 3 and 4, n = 10, 5,
   3 on the paper grid and n = 10 on the 16x16x16 grid), with 5 repeated K6
   calls bitwise the same;
10. solves the paper case through the two routes of this slice, each with
   the launch counters reset just before it: p-multigrid PCG to
   rnorm <= 1e-8 r0 beside Chebyshev-PCG(4) to the same tolerance, and
   multi-RHS block CG at b = 4 (100 iterations, each lane bitwise its own
   v2 solve), plus the tolerance-driven block solve and the per-RHS
   ``block_loop`` route at b = 2;
11. times every kernel and its plain version (device time by CUDA events)
   at E=1024 and E=4096 (with the fields K11's variant moves; beside each
   K12 step an empty kernel launched on that step's grid, the launch
   floor), the solves
   per iteration and to tolerance (host clock), and the Chebyshev and pmg
   intervals' one-time set-up;
12. holds K3 and K2 (the v1 operator) and K8 and K9 (the s-step cycle)
   against their plain versions at n=10, E=1024, fp64 and fp32, K8/K9 at
   s = 1, 2, 4; K8 also on the 16x16x16 grid (E=4096) at s = 1, 2, 4 and
   at s = SSTEP_MAX_S with n = 4, with its launch plan printed (grid,
   blocks per SM, shared memory, registers), its Gram partials bitwise
   ``ref.sstep_gram_emulated`` of its basis and 5 repeated calls bitwise
   the same; then K9's walker in f64 and f32: its plans at n = 10, E =
   1024 and 4096, s = 1, 2, 4, 10, and n = 3, 5, 10 at s = 1, 2, 4, 10
   over K1's element counts, x, r and p bitwise the plain version, rcr
   summed, relative;
13. solves the paper case through the two routes of this slice, each with
   the launch counters reset just before it: v1 over K3 (100 iterations,
   against the plain route) and s-step over K8 + K9 at s = 4 and 1 (100
   iterations) and 2 (99, a remainder cycle), against v2, and s-step at
   s = 4 to a tolerance it crosses inside a cycle (K8 one cooperative
   launch per cycle);
14. times K2, K3, K8 and K9 (K8 and K9 at s = 1, 2, 4) beside their plain
   versions at E=1024 and E=4096, and v1 and s-step per iteration beside
   v2, in turns;
15. holds K4, K5 and K3 in their bf16 builds (``bf16``: every operand
   bf16; ``bf16_ir``: bf16 vectors, x, the metric and D in f32) against
   their plain versions at n=10, E=1024 and 4096: fields value by value,
   partials relatively; a K4 that skips rounding p through storage must
   fail the same check; then K4, K3, K2, K5 and K7, the persistent
   walkers: their launch plans at E = 1024 and 4096 in every build (grid,
   elements or work items a block, stages, staged operands, TMA bulk or
   cp.async path, shared memory, registers and spills from ``ptxas -v``;
   K7 at b = 4), and every build against its plain version at n = 10, 5
   and 3 (both copy paths) on the paper grid, the 16x16x16 grid and a
   3x3x5 grid (E = 45, which no block count divides), with 5 repeated
   calls bitwise the same, K2's w and pap bitwise K3's and K7's lanes (b =
   3, lane-major work items) bitwise K5's; and K8, K9 and K10 in both
   bf16 builds at n=10, E = 1024 and 4096, K8 and K9 at s = 4, 2, 1: each of K8's stored powers
   value by value against one plain application to its previous stored
   power, its Gram partials bitwise ``ref.sstep_gram_emulated`` of its own
   vectors (a K8 that skips rounding the powers through storage must fail
   the power check), K9's x, r, p and K10's x, z value by value, their
   partials summed, every output's dtype its role's, and K9's walker at
   K9's plans and edge cases above, x, r and p value by value; and K1 and
   K2 in
   both bf16 builds at n = 2..16 (E = 8) and n = 10 (E = 1024 and 4096),
   fields value by value, partials summed, 5 repeated calls bitwise (a K1
   that rounds D u to bf16 before the metric and a K2 whose partials are
   stored in bf16 must fail the same checks), and K2 among the walkers in
   every build, its w and pap bitwise K3's; K10's walker among them, its
   plans at E = 1024 and 4096 printed, every build at n = 10, 5, 3 on the
   three grids (x and z bitwise the plain version in f64 and f32, value by
   value in bf16; rtz and rcr summed; 5 repeated calls bitwise) and every
   operand 1 value off its allocation's start (cp.async) bitwise the
   aligned call; and K12's walker: its plans on the paper ladder at E =
   1024 and 4096 in every build (group, grid, threads, copy path, shared
   memory, registers; no spills), v bitwise the plain version at every ladder
   pair n = 3..16 and E = 1, 7, 1024, 4096, and on the paper ladder at
   E = 1024 5 repeated calls and u 1 value off its allocation's start
   bitwise the aligned call;
16. solves the paper case (b in fp64, 100 inner iterations per sweep)
   through the ``ir`` route — ``f32_ir`` and ``bf16_ir`` over v2, v1 and
   s-step (s=4) — the non-refined ``bf16`` policy over v2, v1 and s-step,
   and bf16 Jacobi-PCG over K4 + K10 (``bf16`` through the case,
   ``bf16_ir`` through ``precond.pcg_fused_v2_fixed_iters``), each with the
   launch counters reset just before it: launches exact, the history
   against the same route over the plain versions on the card (bf16
   s-step over its first cycle, where two valid Gram orders agree),
   ``f32_ir`` over v2 and v1 at or below fp64 v2's 100-iteration rnorm,
   ``bf16_ir``'s outer rnorms never rising; times each solve; and solves
   it through bf16 ``reference`` (reference CG over the bf16 K1, 100
   iterations, the plain versions made to raise meanwhile): K1 launched
   100 times, entries 0..10 against the same route over the plain
   versions, within 1e-2 or 10x the plain route's own spread under
   another valid f32 order of its operator;
17. holds K11, K12, K6 and K7 in both bf16 builds against their plain
   versions value by value: K11 at n = 10, 5, 3 (its shared-memory
   variant at E=1024, its device-memory variant at E=4096; the planner's
   shared bytes those the kernel stages; 5 repeated calls bitwise), K12 on
   every step of the n = 10 ladder (bitwise) and every other pair, K6 and
   K7 at b = 1, 3, 4 with every lane bitwise the bf16 K4's and K5's; a
   stand-in that keeps K11's recurrence in storage, one that keeps K12's
   intermediate stages in storage, a K6 that skips rounding p and a K7
   that rounds the assembled w must each fail the value check;
18. solves the paper case through bf16 Chebyshev-PCG(4) and pmg-PCG and
   bf16 block CG at b = 4 (``bf16`` through the case, ``bf16_ir`` through
   ``precond.pcg_fused_v2_fixed_iters`` and
   ``cg_block.cg_block_fixed_iters``), and f32 block CG at b = 4 through
   the case (K6's and K7's f32 builds), each with the launch counters reset
   just before it and the plain versions of its kernels made to raise:
   launches exact, the history's entries 0..10 against the same route
   over the plain versions on the card, within 1e-2 or, where the plain
   route itself moves further under another valid f32 order of its
   operator, within 10x that spread (whether 1e-2 held is reported), the
   block lanes bitwise their own bf16 (f32) v2 solves; times each solve;
19. serves the paper case (n=10, E=1024, fp64, ``pallas_fused_cg_v2``,
   uncut) through ``launch.solver_service.SolverService`` at ``max_b`` 4,
   right-hand sides from a seed: 8 requests at 100 iterations (two
   ``block`` dispatches over K6 + K7), 2 Jacobi requests (one
   ``block_loop`` dispatch over K4 + K10) and 1 to a tolerance (one
   ``v2_tol`` dispatch over K4 + K5), with the launch counters reset just
   before the drain: results in submission order, dispatches of 4, 4, 2
   and 1 that never mix buckets, launches exact, every answer bitwise the
   direct ``solve_case`` of the same batch and stopping rule, the block
   histories against single-RHS v2 solves by the route rule (entries 0..10
   to 1e-12, then 10x the plain route's spread); drains again under
   ``obs.trace.recording`` (a valid trace file with the
   ``service.dispatch``, ``solve`` and ``block.dispatch`` spans, telemetry
   on every result, every answer bitwise the untraced drain's) and once
   more untraced (the pair the tracing cost is read from); times v1
   against v2 an iteration through ``autotune.pick_pipeline``'s measure at
   E = 1, 8, 64, 512 and 1024 and prints the crossover, holds the pick at
   E = 1024 (and ``NekboneCase(ax_impl="auto")``) to the faster of v1 and
   v2 in the 100-iteration solves timed in turns in item 15 (a pick slower
   by more than those rounds' spread fails), resolves ``auto`` with the f32
   and bf16_ir policies (keyed by the policy) and solves with each; and
   runs ``bench_service`` (16 requests of 25 iterations at b = 1, 2, 4, 8,
   3 repeats), printing each b's request latency (p50, p99) and its
   throughput over the whole window beside the card's name and power
   limit; all within 60 s, with ``$REPRO_CACHE_DIR`` a fresh temporary
   directory for the whole script;
20. times the f32 K4, K5, K3, K8, K9, K10, K6 and K7 and the bf16 K1,
   K2, K4, K5, K3, K8, K9, K10, K11, K12, K6 and K7 (both builds; K9 also
   beside one ``torch.matmul``, K12 beside one ``torch.einsum``) beside
   their plain versions at E=1024 and E=4096, each with the bytes it
   moves and its share of the bound;
21. profiles each kernel route (device time per iteration, by kernel, and
   the device's busy share), ``bf16_ir`` v2 and bf16 block CG at b = 4
   among them;
22. holds K13 (flash attention; in bf16 on the tensor cores) and K14 (the
   RWKV6 recurrence) against their plain versions in bf16 and f32, at
   gemma2-27b's heads (Hq 32, Hkv 16, d 128: 2048 tokens with window 1024,
   global, and a q_offset case; two ragged cases across partial tiles,
   1000 tokens with window 333 and 300 queries at q_offset 700 over 1000
   keys) and rwkv6-1.6b's (H 32, d 64: T = 1024 from a zero and a random
   state, T = 1, and T = 1000, which ends in a partial pass of K14's
   staged steps; 5 repeated calls bitwise the same; K14's blocks per call
   printed and more than B x H), plus d = 16 with fully masked rows (K13),
   d = 64 and 192 (GQA 5:1 with window 333 over 1000 tokens, 12:1 causal
   over 777), whisper-large-v3's non-causal encoder (batch 4, 20:20,
   d 64, 1500 x 1500 frames, not a whole number of key tiles) and
   cross-attention (64 queries over 1500 keys), arctic-480b's GQA 7:1
   and codeqwen1.5-7b's 32:32 at d 128 (causal over 2048), and T = 37
   (K14); bf16 outputs also
   value by value (one bf16 step of each value); shows that the same
   value check fails the bf16 kernel's arithmetic with P rounded once to
   bf16 (``ref.flash_attention_tc_emulated(split_p=False)``) at the global
   shape and passes it with P split; then holds qwen3-moe-30b-a3b's MoE
   layer at full width (128 experts, top 8, d 2048, f 768, f32, 512
   tokens at capacity factor 1.0) on the card against the CPU: the same
   kept (token, expert) pairs, some dropped, outputs within 1e-5 of max
   |y|, 3 calls bitwise the same;
23. serves rwkv6-1.6b (24 layers, batch 4, prompt 1024, 32 new tokens),
   gemma2-27b (2 of its 46 layers, batch 2, prompt 6144, 16 new),
   nemotron-4-340b (2 of its 96 layers, batch 2, prompt 4096, 16 new),
   hymba-1.5b (32 layers, batch 4, prompt 2048, 32 new),
   qwen3-moe-30b-a3b (8 of 48 layers, batch 4, prompt 2048, 16 new),
   arctic-480b (2 of 35 layers, bf16 weights, batch 2, prompt 2048, 16
   new), whisper-large-v3 (32 encoder and 32 decoder layers, batch 4,
   1500 audio frames, prompt 64, 64 new), llava-next-mistral-7b (32
   layers, batch 2, 2880 image tokens and a prompt of 128, 32 new),
   qwen2.5-14b (8 of 48 layers) and codeqwen1.5-7b (8 of 32), both at
   batch 4, prompt 2048, 16 new, three times each through
   ``launch.serve.serve`` at full width (the image and audio stubs 0.1 x
   N(0, 1) from a seed), with every plain attention / WKV function and
   SDPA made to raise meanwhile: the tokens are in range, the runs agree
   bitwise, the launch counts are K14 = layers x tokens and K13 = layers
   in each (whisper: 32 encoder + 32 decoder + 32 cross-attention), by
   build too (K13 one per layer at its head size and window, non-causal
   launches apart); the third run is profiled, its device time read
   against the second's wall clock; and times hymba's selective scan
   (plain PyTorch) a layer at its serve shape;
24. times K13 and K14 at the serve shapes beside their plain versions
   and, for K13 on global layers, SDPA; holds K13 there in bf16 and f32
   (gemma2: batch 2, 6144 tokens, global and window 4096), in bf16 at
   nemotron-4's global layer (batch 2, 4096 tokens, d 192), hymba's
   global and window-1024 layers (batch 4, 2048 tokens, d 64) and the
   global layers of qwen3-moe, arctic, qwen2.5, codeqwen and llava and
   whisper's encoder, cross-attention and decoder at their serve shapes,
   and shows that these checks fail a K13 that ignores the window or cuts
   it one key short;
25. prints the whole script's time beside the card's name and power
   limit, the ``kernels`` JSON line (each row's launches are its own
   build's count in a measured run: ``_build.BUILD_LAUNCHES``, one K13
   row per served layer kind, whisper's encoder and cross-attention
   apart), the card line, and last the result line
   ``{"ok": true, "device": {...}}``.

Any failed check exits with status 1 and prints no result line.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
sys.path.insert(0, str(SRC))
try:
    # the kernel and solve timers (CUDA events behind a spin kernel; host
    # clock to a synchronize) live in the port
    from repro_torch.kernels.timing import device_ms, wall_ms
except ImportError:     # no checkout beside this script: main() says so
    pass

# H100 SXM data sheet: device-memory rate, and peak fp64 rates outside and
# on the tensor cores.  bound_ms is the larger of bytes / BW_PEAK and the
# operations' time: contraction flops (the n-long products with D) at the
# tensor cores' rate, the rest outside them.
BW_PEAK = 3.35e12
FP64_PEAK = 34e12
FP64_TENSOR_PEAK = 67e12

PAPER_GRID = (8, 8, 16)       # E = 1024, PAPER_CASES[1024]
BIG_GRID = (16, 16, 16)       # E = 4096, the paper's largest case
NITER = 100
HIST_RTOL_HEAD = 1e-12        # first 10 history entries
# All 101 entries: over 100 iterations CG amplifies round-off, and the plain
# route itself, evaluated on the CPU and on the card, differs by about 1e-2
# at its worst entry.  A kernel route must stay within this factor of that
# spread.
ENVELOPE_FACTOR = 10.0
PCG_HIST_TOL_HEAD = 1e-10     # PCG routes: first 10 history entries
CHEB_K = 4
# K11's max abs error against its plain version at the paper grid (fp64,
# n = 10, k = CHEB_K, phase_pcg_parity's first inputs) as the chain of k + 1
# launches that the cooperative kernel replaced computed it: 5.684342e-14
# by scripts/k11_k14_compare.py on an H100 80GB HBM3 at 700 W (the two give
# bitwise the same z there).
K11_CHAIN_MAX_ABS_ERR = 5.684342e-14
CHEB_TOL = 1e-8
CHEB_MAX_ITERS = 34           # the reference's acceptance at the paper case
PMG_RTOL = 1e-8               # pmg: solve to 1e-8 r0 (benchmarks/pmg_smoke.py)
PMG_MAX_ITERS = 15
BLOCK_B = 4
SSTEP_S = 4                   # the reference's default cycle length
SSTEP_HIST_TOL_HEAD = 1e-9    # s-step vs v2, entries 0..10 (the Gram forms)
SSTEP1_HIST_TOL_HEAD = 1e-10  # s=1 vs v2, entries 0..10
# the steps of the p-multigrid ladder of the paper case, both directions
LADDER_PAIRS = ((10, 5), (5, 10), (5, 3), (3, 5), (3, 2), (2, 3))


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)
    print(f"  ok  {what}", flush=True)


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


def _ptxas_report(log: str) -> dict:
    """``{kernel<template arguments>: (registers, spill store bytes)}`` for
    every kernel instantiation in an ``nvcc -Xptxas -v`` log; the integer
    and bool template arguments are joined by ``,`` (n first, or nin, nout
    for the interpolation kernel)."""
    import re

    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            # _ZN <length><namespace> ... <length><name> I<arguments>E ...
            name, at = mangled, 3
            while mangled.startswith("_ZN") and at < len(mangled):
                nl = re.match(r"\d+", mangled[at:])
                if not nl:
                    break
                at += nl.end()
                name = mangled[at:at + int(nl.group(0))]
                at += int(nl.group(0))
            args = re.findall(r"L[ib](\d+)E", mangled)
            key = f"{name}<{','.join(args)}>"
            out[key] = [0, 0]
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out[key][1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[key][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def phase_build():
    from repro_torch.kernels import _build

    print("== build", flush=True)
    t0 = time.perf_counter()
    paths = _build.build_all()
    seconds = time.perf_counter() - t0
    for stem, path in paths.items():
        report = _ptxas_report(path.with_suffix(".log").read_text())
        spills = {key: v[1] for key, v in report.items() if v[1]}
        # the n=10 instantiations (and K12's 10 -> 5); every one for K13/K14
        main = {key: v[0] for key, v in report.items()
                if re.search(r"<10(,|>)", key)
                or stem.startswith(("flash_attn", "wkv6"))}
        print(f"  {stem}: {path.name}; registers {main}; spill "
              f"bytes by instantiation: {spills or 'none'}")
    from repro_torch.kernels.flash_attn import HEAD_DIMS

    for lib in (K13_BF16, "flash_attn_f32"):
        report = _ptxas_report(paths[lib].with_suffix(".log").read_text())
        smem = getattr(_build.load(lib), f"{lib}_smem_bytes")
        smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
        for key, (regs, spill) in sorted(report.items()):
            d = int(re.search(r"<(\d+)>", key).group(1))
            print(f"  {lib} {key}: {regs} registers, {spill} bytes spill "
                  f"stores, {smem(d)} bytes dynamic shared memory")
    # the machine code: tensor-core MMAs (HMMA) and cp.async copies (LDGSTS)
    cuobjdump = pathlib.Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(paths[K13_BF16])],
                          capture_output=True, text=True, timeout=120).stdout
    kernels = [f for f in sass.split("Function : ")[1:]
               if "flash_attn_tc_kernel" in f.split("\n", 1)[0]]
    check(len(kernels) == len(HEAD_DIMS),
          f"{K13_BF16}: SASS of every head size {HEAD_DIMS}")
    for f in kernels:
        d = re.search(r"ILi(\d+)E", f).group(1)
        ops = {op: len(re.findall(rf"\b{op}\b", f))
               for op in ("HMMA", "LDSM", "LDGSTS", "MUFU")}
        check(ops["HMMA"] > 0 and ops["LDGSTS"] > 0,
              f"{K13_BF16} flash_attn_tc_kernel<{d}> SASS: {ops}")
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
    _k1_walk_parity()
    torch.cuda.synchronize()
    return main_err


# The element counts and degrees K1's and K9's walkers are held at: one
# element, a few, counts no block count divides, and the paper's E = 1024
# and 4096; the element grids of K9 (z-major over (EX, EY, EZ))
EDGE_GRIDS = {1: (1, 1, 1), 7: (1, 7, 1), 131: (131, 1, 1),
              133: (7, 1, 19), 1024: PAPER_GRID, 4096: BIG_GRID}
K1_EDGE_NS = (2, 3, 5, 10, 16)
K9_EDGE_NS = (3, 5, 10)
K9_EDGE_S = (1, 2, 4, 10)


def _walker_line(stem, E, n, mix, **kw):
    """A walker's launch plan on this card, with its instantiation's
    registers and spills from ptxas, as one line; and whether its grid is
    one wave."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import nekbone_ax as K

    plan, info = K.walk_launch_info(stem, E, n, mix, **kw)
    log = _build.build_all()[f"{stem}_{mix}"].with_suffix(".log").read_text()
    regs, spill = _ptxas_report(log)[f"{stem}_kernel<{n}>"]
    wave = plan.grid <= info["sm_count"] * plan.blocks_per_sm
    return plan, wave, (
        f"grid {plan.grid} ({plan.per_block} elements a block, one wave at "
        f"{plan.blocks_per_sm} blocks an SM on {info['sm_count']} SMs), "
        f"{plan.stages} stages of {', '.join(plan.staged) or 'nothing'} by "
        f"{plan.copy}, {plan.smem_bytes} bytes dynamic + "
        f"{info['static_smem']} static shared, {regs} registers "
        f"({info['registers']} by the runtime), {spill} bytes spilled")


def _k1_walk_parity():
    """K1's walker in every build: its launch plans at n = 10, E = 1024 and
    4096; every n of K1_EDGE_NS at every E of EDGE_GRIDS against the plain
    version (f64 and f32 relative, bf16 value by value); and a view 1 value
    past its allocation's start (off 16-byte alignment: the cp.async path)
    bitwise the aligned call's w."""
    import numpy as np
    import torch

    from repro_torch.kernels import nekbone_ax as K

    print(f"  K1 walker: plans at n=10 and every build at n = {K1_EDGE_NS} "
          f"over E = {tuple(EDGE_GRIDS)} (f64 and f32 relative, bf16 value "
          "by value)", flush=True)
    for mix in WALK_MIXES:
        for E in (1024, 4096):
            plan, wave, line = _walker_line("nekbone_ax", E, 10, mix)
            check(plan.bulk and plan.stages >= 2 and wave,
                  f"K1 {mix} E={E} plan: {line}")
    rng = np.random.default_rng(15)
    for n in K1_EDGE_NS:
        worst = {mix: "" for mix in WALK_MIXES}
        bad = []
        for E in EDGE_GRIDS:
            u64, D64, g64 = _operator_data(rng, E, n, torch.float64)
            for mix in WALK_MIXES:
                dt = K.MIXES[mix]
                args = (u64.to(dt["S"]), D64.to(dt["O"]), g64.to(dt["O"]))
                ok, txt = _walk_field_ok(K.nekbone_ax_cuda(*args, n=n),
                                         K.nekbone_ax_plain(*args, n=n), mix)
                if not ok:
                    bad.append((mix, E, txt))
                if E == 4096:
                    worst[mix] = txt
            del u64, g64
        check(not bad, f"K1 n={n}: every build at every E within its "
                       "tolerance (at E=4096: "
              + "; ".join(f"{m} {t}" for m, t in worst.items()) + ")"
              + (f"; FAILED {bad}" if bad else ""))
    # a misaligned view: the cp.async path, w bitwise the aligned call's
    E, n = 1024, 10
    u64, D64, g64 = _operator_data(rng, E, n, torch.float64)
    for mix in WALK_MIXES:
        dt = K.MIXES[mix]
        u, D, g = u64.to(dt["S"]), D64.to(dt["O"]), g64.to(dt["O"])
        ub = torch.empty(u.numel() + 1, dtype=u.dtype, device="cuda")
        gb = torch.empty(g.numel() + 1, dtype=g.dtype, device="cuda")
        ub[1:] = u.reshape(-1)
        gb[1:] = g.reshape(-1)
        uv, gv = ub[1:].view(u.shape), gb[1:].view(g.shape)
        plan = K._walk_launch_plan("nekbone_ax", K.k1_plan, E, n, mix,
                                   uv.device, (uv, gv), any_head=True)
        w = K.nekbone_ax_cuda(uv, D, gv, n=n)
        check(not plan.bulk and torch.equal(w, K.nekbone_ax_cuda(u, D, g,
                                                                 n=n)),
              f"K1 {mix} n={n} E={E}, u and the metric 1 value off their "
              f"allocations' start ({plan.copy}, {', '.join(plan.staged)} "
              "staged): w bitwise the aligned call's")


def _k9_edge_parity(mixes):
    """K9's walker in ``mixes``: its launch plans at n = 10, E = 1024 and
    4096, every s of K9_EDGE_S; and every n of K9_EDGE_NS and s at every E
    of EDGE_GRIDS against its plain version on random x, p, r, basis and
    coefficients: x, r and p bitwise in f64 and f32, value by value in
    bf16, the rcr partials summed, relative."""
    import torch

    from repro_torch.kernels import nekbone_ax as K
    from repro_torch.kernels import ops

    print(f"  K9 walker ({', '.join(mixes)}): plans at n=10 and parity at "
          f"n = {K9_EDGE_NS}, s = {K9_EDGE_S} over E = {tuple(EDGE_GRIDS)}",
          flush=True)
    for mix in mixes:
        for E in (1024, 4096):
            for s in K9_EDGE_S:
                plan, wave, line = _walker_line("nekbone_sstep_update", E,
                                                10, mix, s=s)
                check(plan.bulk and plan.stages >= 2 and wave,
                      f"K9 {mix} E={E} s={s} plan: {line}")
    gen = torch.Generator("cuda").manual_seed(9)
    for n in K9_EDGE_NS:
        n3 = n ** 3
        bad = []
        for E, grid in EDGE_GRIDS.items():
            for s in K9_EDGE_S:
                x64, p64, r64 = (torch.randn(E, n3, generator=gen,
                                             dtype=torch.float64,
                                             device="cuda")
                                 for _ in range(3))
                b64 = torch.randn(E, 2 * s - 1, n3, generator=gen,
                                  dtype=torch.float64, device="cuda")
                c64 = torch.randn(3, 2 * s + 1, generator=gen,
                                  dtype=torch.float64, device="cuda")
                for mix in mixes:
                    dt = K.MIXES[mix]
                    _, c = ops.slab_axis_factors(grid, n, dt["S"], "cuda")
                    args = (x64.to(dt["X"]), p64.to(dt["S"]),
                            r64.to(dt["S"]), b64.to(dt["S"]),
                            c64.to(dt["A"]), *c)
                    got = K.nekbone_sstep_update_cuda(*args, n=n, s=s)
                    want = K.nekbone_sstep_update_plain(*args, n=n, s=s)
                    if mix in BF16_MIXES:
                        fields = max(_value_rel(a, b, BF16_F32_TOL) for a, b
                                     in zip(got[:3], want[:3])) <= 1.0
                        tol = BF16_PART_TOL
                    else:
                        fields = all(torch.equal(a, b) for a, b in
                                     zip(got[:3], want[:3]))
                        tol = WALK_TOL[mix]
                    rerr = _part_err(got[3], want[3])
                    roles = (got[0].dtype == dt["X"]
                             and got[1].dtype == got[2].dtype == dt["S"]
                             and got[3].dtype == dt["A"])
                    if not (fields and rerr <= tol and roles):
                        bad.append((mix, E, s, fields, rerr))
                del x64, p64, r64, b64
        check(not bad, f"K9 n={n}, s = {K9_EDGE_S}, E = {tuple(EDGE_GRIDS)}"
              f" in {', '.join(mixes)}: x, r, p "
              + ("value by value" if mixes == BF16_MIXES else "bitwise")
              + " the plain version, rcr within its tolerance"
              + (f"; FAILED {bad}" if bad else ""))
    torch.cuda.empty_cache()


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

    print("== K4/K5 parity (one v2 iteration, paper grid, n = 10, 5, 3)",
          flush=True)
    rng = np.random.default_rng(1)
    errs = {}
    for n in (10, 5, 3):
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            case = NekboneCase(n=n, grid=PAPER_GRID, dtype=dtype)
            o = _v2_operands(case, rng)
            E = case.mesh.nelt
            tag = f"{dtype} n={n}"
            kp, kw, kpap = K.nekbone_ax_slab_cuda(o["p"], o["r"], case.D,
                                                  o["g3"], *o["m"],
                                                  o["beta"], n=n)
            pp, pw, ppap = K.nekbone_ax_slab_plain(o["p"], o["r"], case.D,
                                                   o["g3"], *o["m"],
                                                   o["beta"], n=n)
            check(torch.equal(kp, pp), f"K4 {tag}: p = r + beta p bitwise")
            check(rel_err(kw, pw) <= tol,
                  f"K4 {tag}: w max rel err {rel_err(kw, pw):.2e} <= "
                  f"{tol:g}")
            pap_err = abs(float(kpap.sum() - ppap.sum())) \
                / abs(float(ppap.sum()))
            check(pap_err <= tol, f"K4 {tag}: pap rel err {pap_err:.2e}")
            # K5 on K4's own outputs, both sides: x and r bitwise
            kx, kr, krcr = K.nekbone_cg_update_cuda(o["x"], kp, o["r"], kw,
                                                    o["alpha"], *o["c"], n=n)
            px, pr, prcr = K.nekbone_cg_update_plain(o["x"], kp, o["r"], kw,
                                                     o["alpha"], *o["c"],
                                                     n=n)
            check(torch.equal(kx, px) and torch.equal(kr, pr),
                  f"K5 {tag}: x += alpha p, r -= alpha gs(w) bitwise")
            rcr_err = abs(float(krcr.sum() - prcr.sum())) \
                / abs(float(prcr.sum()))
            check(rcr_err <= tol, f"K5 {tag}: rcr rel err {rcr_err:.2e}")
            # with r = 0, alpha = -1 the stored r is the assembled w itself
            zero = torch.zeros_like(o["x"])
            _, wa, _ = K.nekbone_cg_update_cuda(
                zero, zero, zero, kw, torch.tensor(-1.0, dtype=dtype,
                                                   device="cuda"), *o["c"],
                n=n)
            want = ds_sum_local(kw.reshape(E, n, n, n), case.grid)
            check(torch.equal(wa, want.reshape(E, n ** 3)),
                  f"K5 {tag}: assembly bitwise ds_sum_local")
            if dtype == torch.float64 and n == 10:
                errs["K4"] = float((kw - pw).abs().max())
                errs["K5"] = float((kr - pr).abs().max())
    torch.cuda.synchronize()
    return errs


def phase_routes():
    import numpy as np
    import torch

    from repro_torch.core.nekbone import NekboneCase

    print(f"== paper case, both routes: n=10, E=1024, fp64, {NITER} "
          "iterations", flush=True)
    want_launches = {
        "fused": _zero_but(),
        "pallas": _zero_but(nekbone_ax=NITER),
        "pallas_fused_cg_v2": _zero_but(nekbone_ax_slab=NITER,
                                        nekbone_cg_update=NITER),
    }
    hist, launches, cases = {}, {}, {}
    for impl in want_launches:
        case = NekboneCase(n=10, grid=PAPER_GRID, dtype=torch.float64,
                           ax_impl=impl)
        u_ex, f = case.manufactured()
        res, launches[impl] = _launch_run(
            lambda: case.solve(f, niter=NITER))
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
    return launches, cases, hist


def _pcg_operands(case, rng):
    """v2 operands plus a continuous z, the assembled inverse diagonal and
    Chebyshev scalars for k = 1, 2, 4."""
    import torch

    from repro_torch.core.precond import cheb_scalars, estimate_interval

    E, n = case.mesh.nelt, case.n
    o = _v2_operands(case, rng)
    o["z"] = o.pop("p")
    o["p"] = _v2_operands(case, rng)["p"]
    o["invd"] = (1.0 / case.operator_diagonal()).reshape(E, n ** 3) \
        .contiguous()
    o["D"] = case.D
    # the case's own Lanczos interval (about [0.005, 0.78] at n=10)
    lmin, lmax = estimate_interval(case.D, case.g, case.grid, case.mask,
                                   case.c)
    o["coef"] = {k: torch.as_tensor(cheb_scalars(k, lmin, lmax),
                                    dtype=case.dtype, device="cuda")
                 for k in (1, 2, 4)}
    return o


def phase_pcg_parity():
    import numpy as np
    import torch

    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import nekbone_ax as K

    print("== K10/K11 parity (kernel vs plain; n = 10, 5, 3 on the paper "
          "grid, n = 6 on 4x4x4, n = 10 on the 16x16x16 grid)", flush=True)
    rng = np.random.default_rng(3)
    errs = {}
    variants = set()
    for dtype, part_tol, z_tol in ((torch.float64, 1e-13, 1e-12),
                                   (torch.float32, 1e-5, 1e-4)):
        for n, grid in ((10, PAPER_GRID), (6, (4, 4, 4)), (5, PAPER_GRID),
                        (3, PAPER_GRID), (10, BIG_GRID)):
            case = NekboneCase(n=n, grid=grid, dtype=dtype)
            o = _pcg_operands(case, rng)
            tag = f"{dtype} n={n} E={case.mesh.nelt}"
            # K10 on K4's own output, z in K4's residual slot
            kp, kw, _ = K.nekbone_ax_slab_cuda(o["p"], o["z"], o["D"],
                                               o["g3"], *o["m"], o["beta"],
                                               n=n)
            args = (o["x"], kp, o["z"], kw, o["alpha"], o["invd"], *o["c"])
            kx, kz, krtz, krcr = K.nekbone_pcg_update_cuda(*args, n=n)
            px, pz, prtz, prcr = K.nekbone_pcg_update_plain(*args, n=n)
            check(torch.equal(kx, px) and torch.equal(kz, pz),
                  f"K10 {tag}: x += alpha p, z -= alpha invd gs(w) bitwise")
            if dtype == torch.float64 and n == 10:
                errs["K10"] = float((kz - pz).abs().max())
            for name, a, b in (("rtz", krtz, prtz), ("rcr", krcr, prcr)):
                err = abs(float(a.sum() - b.sum())) / abs(float(b.sum()))
                check(err <= part_tol, f"K10 {tag}: {name} rel err "
                                       f"{err:.2e} <= {part_tol:g}")
            plan, info = K.nekbone_cheb_apply_plan(
                case.mesh.nelt, n, "f64" if dtype == torch.float64 else "f32")
            variants.add(plan.variant)
            print(f"  K11 {tag}: {plan.variant}-memory variant, one "
                  f"cooperative launch of {plan.grid} blocks ({info['slices']}"
                  f" elements side by side, {plan.per_block} owned), "
                  f"{plan.blocks_per_sm} blocks per SM on {info['sm_count']} "
                  f"SMs, {plan.smem_bytes} bytes dynamic + "
                  f"{info['static_smem']} static shared memory, "
                  f"{info['registers']} registers", flush=True)
            if n == 10:
                want = "shared" if grid == PAPER_GRID else "device"
                check(plan.variant == want,
                      f"K11 {tag}: the {want}-memory variant")
            for k in (1, 2, 4):
                args = (o["z"], o["D"], o["g3"], *o["m"], *o["c"],
                        o["coef"][k])
                kz, krtz = K.nekbone_cheb_apply_cuda(*args, n=n, k=k)
                pz, prtz = K.nekbone_cheb_apply_plain(*args, n=n, k=k)
                err = rel_err(kz, pz)
                rtz_err = abs(float(krtz.sum() - prtz.sum())) \
                    / abs(float(prtz.sum()))
                check(err <= z_tol and rtz_err <= z_tol,
                      f"K11 {tag} k={k}: z max rel err {err:.2e}, rtz rel "
                      f"err {rtz_err:.2e} <= {z_tol:g}")
                if (dtype == torch.float64 and grid == PAPER_GRID and n == 10
                        and k == CHEB_K):
                    errs["K11"] = float((kz - pz).abs().max())
                    print(f"  K11 {tag} k={k}: max abs err "
                          f"{errs['K11']:.6e}; the chain of k + 1 launches it "
                          f"replaced: {K11_CHAIN_MAX_ABS_ERR:.6e}", flush=True)
                if n == 10 and k == CHEB_K:
                    # a missing grid sync or a stale read of a neighbour's
                    # A d shows as calls that disagree
                    reps = [K.nekbone_cheb_apply_cuda(*args, n=n, k=k)
                            for _ in range(5)]
                    check(all(torch.equal(z, kz) and torch.equal(t, krtz)
                              for z, t in reps),
                          f"K11 {tag} k={k}: 5 more calls give bitwise the "
                          "same z and rtz")
    check(variants == {"shared", "device"},
          f"K11: both variants ran ({sorted(variants)})")
    torch.cuda.synchronize()
    return errs


def _ladder_matrix(nin: int, nout: int, dtype):
    """K12's ``mt`` (nin, nout) for one ladder step: ``J`` restricts
    (nin > nout), ``J^T`` prolongs."""
    import torch

    from repro_torch.core.pmg import gll_interp_matrix

    J = gll_interp_matrix(max(nin, nout), min(nin, nout))
    return torch.as_tensor(J if nin > nout else J.T, dtype=dtype,
                           device="cuda").contiguous()


def phase_interp_block_parity():
    """K12 against its plain version for every ladder step, with the face
    property; K6 and K7 against K4 and K5 lane by lane."""
    import numpy as np
    import torch

    from repro_torch.core.gs import ds_sum_local
    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import nekbone_ax as K
    from repro_torch.kernels import ops

    print("== K12 parity (kernel vs plain, every ladder step) and K6/K7 "
          "parity (lane by lane against K4/K5)", flush=True)
    rng = np.random.default_rng(5)
    errs = {}
    E = PAPER_GRID[0] * PAPER_GRID[1] * PAPER_GRID[2]
    for dtype in (torch.float64, torch.float32):
        worst = 0.0
        for nin, nout in LADDER_PAIRS:
            u = torch.as_tensor(rng.normal(size=(E, nin ** 3)), dtype=dtype,
                                device="cuda")
            mt = _ladder_matrix(nin, nout, dtype)
            v = K.nekbone_interp_cuda(u, mt, nin=nin, nout=nout)
            want = K.nekbone_interp_plain(u, mt, nin=nin, nout=nout)
            err = rel_err(v, want)
            worst = max(worst, err)
            check(torch.equal(v, want) and err <= 1e-15,
                  f"K12 {dtype} {nin}->{nout} E={E}: bitwise the plain "
                  f"version (max rel err {err:.1e} <= 1e-15)")
            if dtype == torch.float64 and (nin, nout) == (10, 5):
                errs["K12"] = float((v - want).abs().max())
        others = sorted(K.INTERP_PAIRS - set(LADDER_PAIRS))
        bad = []
        for nin, nout in others:
            u = torch.as_tensor(rng.normal(size=(9, nin ** 3)), dtype=dtype,
                                device="cuda")
            mt = _ladder_matrix(nin, nout, dtype)
            if not torch.equal(
                    K.nekbone_interp_cuda(u, mt, nin=nin, nout=nout),
                    K.nekbone_interp_plain(u, mt, nin=nin, nout=nout)):
                bad.append((nin, nout))
        check(not bad, f"K12 {dtype}: the other {len(others)} instantiated "
                       f"pairs, E=9, bitwise (failing: {bad})")
        # prolongation keeps element faces: a continuous coarse field on the
        # paper grid prolongs to coincident copies that are bitwise equal,
        # and element corners keep the coarse corner values
        for nc, nf in ((5, 10), (3, 5), (2, 3)):
            ec = ds_sum_local(torch.as_tensor(
                rng.normal(size=(E, nc, nc, nc)), dtype=dtype,
                device="cuda"), PAPER_GRID)
            up = K.nekbone_interp_cuda(ec.reshape(E, -1),
                                       _ladder_matrix(nc, nf, dtype),
                                       nin=nc, nout=nf).reshape(E, nf, nf,
                                                                nf)
            ex, ey, ez = PAPER_GRID
            v = up.reshape(ez, ey, ex, nf, nf, nf)
            corners = all(torch.equal(up[:, a, b, c], ec[:, a, b, c])
                          for a in (0, -1) for b in (0, -1)
                          for c in (0, -1))
            faces = (torch.equal(v[:, :, :-1, :, :, -1], v[:, :, 1:, :, :, 0])
                     and torch.equal(v[:, :-1, :, :, -1, :],
                                     v[:, 1:, :, :, 0, :])
                     and torch.equal(v[:-1, :, :, -1, :, :],
                                     v[1:, :, :, 0, :, :]))
            check(corners and faces,
                  f"K12 {dtype} {nc}->{nf}: prolongated corners bitwise the "
                  "coarse values, coincident face copies bitwise equal")
        print(f"  K12 {dtype}: largest rel err over the ladder {worst:.1e}",
              flush=True)

    # K6 / K7: every output bitwise K4's / K5's on each lane, for every
    # width of K6's lane groups (b = 1..4: one group of b lanes)
    print(f"  K6 lanes by layer sweep (b = 1..{BLOCK_B}): "
          + "; ".join(f"b={b} {K.k6_lane_groups(b)}"
                      for b in range(1, BLOCK_B + 1)), flush=True)
    for dtype in (torch.float64, torch.float32):
        for n, grid in ((10, PAPER_GRID), (5, PAPER_GRID), (3, PAPER_GRID),
                        (10, BIG_GRID)):
            case = NekboneCase(n=n, grid=grid, dtype=dtype)
            E = case.mesh.nelt
            m, c = ops.slab_axis_factors(case.grid, n, dtype, "cuda")
            g3 = ops.diag_metric(case.g, E, n)
            for b in (1, 2, 3, BLOCK_B):
                o = [_v2_operands(case, rng) for _ in range(b)]
                P = torch.stack([q["p"] for q in o])
                R = torch.stack([q["r"] for q in o])
                X = torch.stack([q["x"] for q in o])
                beta = torch.as_tensor(rng.normal(size=b), dtype=dtype,
                                       device="cuda")
                alpha = torch.as_tensor(rng.normal(size=b), dtype=dtype,
                                        device="cuda")
                p3, w3, pap = K.nekbone_ax_slab_block_cuda(
                    P, R, case.D, g3, *m, beta, n=n)
                x3, r3, rcr = K.nekbone_cg_update_block_cuda(
                    X, p3, R, w3, alpha, *c, n=n)
                same = True
                for j in range(b):
                    p, w, pp = K.nekbone_ax_slab_cuda(
                        P[j], R[j], case.D, g3, *m, beta[j:j + 1], n=n)
                    x, r, rr = K.nekbone_cg_update_cuda(
                        X[j], p, R[j], w, alpha[j:j + 1], *c, n=n)
                    same &= all(torch.equal(a, z) for a, z in (
                        (p3[j], p), (w3[j], w), (pap[j], pp), (x3[j], x),
                        (r3[j], r), (rcr[j], rr)))
                check(same, f"K6/K7 {dtype} n={n} E={E} b={b}: p, w, pap, "
                            "x, r, rcr of every lane bitwise K4's and K5's")
                if n == 10:
                    # a stale read of a lane's p column or of the block's
                    # layers shows as calls that disagree
                    reps = [K.nekbone_ax_slab_block_cuda(
                        P, R, case.D, g3, *m, beta, n=n) for _ in range(5)]
                    check(all(torch.equal(a, z) for rep in reps
                              for a, z in zip(rep, (p3, w3, pap))),
                          f"K6 {dtype} n={n} E={E} b={b}: 5 more calls give "
                          "bitwise the same p, w and pap")
                if n == 10 and b == BLOCK_B and grid == PAPER_GRID:
                    _, pw, _ = K.nekbone_ax_slab_block_plain(
                        P, R, case.D, g3, *m, beta, n=n)
                    _, pr, _ = K.nekbone_cg_update_block_plain(
                        X, p3, R, w3, alpha, *c, n=n)
                    if dtype == torch.float64:
                        errs["K6"] = float((w3 - pw).abs().max())
                        errs["K7"] = float((r3 - pr).abs().max())
                    else:
                        errs[("K6", "f32")] = float((w3 - pw).abs().max())
    torch.cuda.synchronize()
    return errs


class _Launches(dict):
    """Launches per wrapper (``_build.LAUNCHES``), with the same run's
    launches per build in ``builds`` (``_build.BUILD_LAUNCHES``)."""

    def __init__(self, per_wrapper, builds):
        super().__init__(per_wrapper)
        self.builds = dict(builds)

    def of(self, build):
        """Launches of ``build`` (``<stem>_<dtype>``, K13 with its detail)
        in this run: 0 where it was not launched."""
        return self.builds.get(build, 0)


def _launch_run(fn):
    """``fn()`` with every launch count set to 0 just before it; returns
    its result and the counts read just after."""
    import torch

    from repro_torch.kernels import _build

    _build.reset_launches()
    res = fn()
    torch.cuda.synchronize()
    return res, _Launches(_build.LAUNCHES, _build.BUILD_LAUNCHES)


def _zero_but(**want):
    from repro_torch.kernels import _build

    counts = dict.fromkeys(_build.LAUNCHES, 0)
    counts.update(want)
    return counts


def _rel_dev(h, base):
    import numpy as np

    return np.abs(h - base) / base


def phase_pcg_routes():
    """The three routes of this slice through ``case.solve``."""
    import numpy as np
    import torch

    from repro_torch.core.cg import cg_fixed_iters
    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.core.precond import chebyshev_preconditioner

    print("== paper case, PCG and tolerance routes: n=10, E=1024, fp64",
          flush=True)
    out = {"launches": {}, "cases": {}}

    def case_of(impl, device=None):
        return NekboneCase(n=10, grid=PAPER_GRID, dtype=torch.float64,
                           ax_impl=impl, device=device)

    # --- Jacobi-PCG, 100 iterations, against the plain route ------------
    v2 = case_of("pallas_fused_cg_v2")
    u_ex, f = v2.manufactured()
    fixed = v2.solve(f, niter=NITER)
    v2_hist = fixed.history.cpu().numpy()
    v2_err = float(v2.solution_error(fixed.x, u_ex))
    res, launches = _launch_run(
        lambda: v2.solve(f, niter=NITER, precond="jacobi"))
    out["launches"]["jacobi"] = launches
    h = res.history.cpu().numpy()
    check(h.shape == (NITER + 1,) and bool(np.isfinite(h).all())
          and bool(torch.isfinite(res.x).all()),
          f"jacobi: finite x, history of {h.size}")
    check(launches == _zero_but(nekbone_ax_slab=NITER,
                                nekbone_pcg_update=NITER),
          f"jacobi: launches {launches}")
    plain = case_of("fused")
    h_plain = plain.solve(f, niter=NITER, precond="jacobi").history \
        .cpu().numpy()
    cpu = case_of("fused", device="cpu")
    h_cpu = cpu.solve(cpu.manufactured()[1], niter=NITER,
                      precond="jacobi").history.numpy()
    dev, envelope = _rel_dev(h, h_plain), float(_rel_dev(h_cpu, h_plain).max())
    k = int(dev.argmax())
    print(f"  jacobi: history[0]={h[0]:.6e} history[{NITER}]={h[NITER]:.6e} "
          f"solution_error={float(v2.solution_error(res.x, u_ex)):.6e}; vs "
          f"plain jacobi route: entries 0..10 {float(dev[:11].max()):.2e}, "
          f"all {float(dev.max()):.2e} at entry {k}; plain route CPU vs "
          f"card {envelope:.2e}", flush=True)
    check(float(dev[:11].max()) <= PCG_HIST_TOL_HEAD,
          f"jacobi: history entries 0..10 within {PCG_HIST_TOL_HEAD:g} of "
          "the plain jacobi route")
    check(float(dev.max()) <= max(PCG_HIST_TOL_HEAD, ENVELOPE_FACTOR
                                  * envelope),
          f"jacobi: all {NITER + 1} entries within {ENVELOPE_FACTOR:g}x the "
          f"plain route's own CPU-vs-card spread ({envelope:.2e})")
    out["cases"]["jacobi"] = (v2, f, dict(niter=NITER, precond="jacobi"))

    # --- Chebyshev-PCG(k), solve to CHEB_TOL --------------------------------
    name = f"cheb{CHEB_K}"
    spec = v2.precond_spec(name)          # the one-time Lanczos set-up
    res, launches = _launch_run(
        lambda: v2.solve(f, tol=CHEB_TOL, max_iter=NITER, precond=name))
    out["launches"]["cheb"] = launches
    it = int(res.iters)
    h = res.history.cpu().numpy()
    err = float(v2.solution_error(res.x, u_ex))
    print(f"  {name}: interval [{spec.lmin:.6e}, {spec.lmax:.6e}]; "
          f"{it} iterations to rnorm {float(res.rnorm):.6e}; "
          f"solution_error={err:.6e} (v2, {NITER} iterations: "
          f"{v2_err:.6e}, rnorm {v2_hist[NITER]:.6e}, least "
          f"{v2_hist.min():.6e})", flush=True)
    check(0 < it <= CHEB_MAX_ITERS and float(res.rnorm) <= CHEB_TOL
          and bool(np.isfinite(h[:it + 1]).all())
          and bool(np.isnan(h[it + 1:]).all()),
          f"{name}: rnorm {float(res.rnorm):.3e} <= {CHEB_TOL:g} in {it} <= "
          f"{CHEB_MAX_ITERS} iterations, history NaN after")
    check(launches == _zero_but(nekbone_cheb_apply=it + 1,
                                nekbone_ax_slab=it, nekbone_cg_update=it),
          f"{name}: launches {launches} (K11 = iters + 1)")
    # the reference route's driver on v2's interval
    M = chebyshev_preconditioner(plain.ax_full, spec.k, spec.lmin, spec.lmax)
    h_ref = cg_fixed_iters(plain.ax_full, f, niter=10, dot=plain.dot(),
                           precond=M).history.cpu().numpy()
    dev = _rel_dev(h[:11], h_ref)
    check(float(dev.max()) <= PCG_HIST_TOL_HEAD,
          f"{name}: history entries 0..10 within {PCG_HIST_TOL_HEAD:g} of "
          f"the plain {name} route ({float(dev.max()):.2e})")
    check(float(v2_hist.min()) > CHEB_TOL,
          f"v2 without a preconditioner stays above {CHEB_TOL:g} in {NITER} "
          "iterations")
    out["cases"]["cheb"] = (v2, f, dict(tol=CHEB_TOL, max_iter=NITER,
                                        precond=name))

    # --- tolerance-driven v2 without a preconditioner ---------------------
    tol = float(v2_hist[NITER // 2]) * (1.0 + 1e-12)
    first = int(np.nonzero(v2_hist <= tol)[0][0])
    res, launches = _launch_run(
        lambda: v2.solve(f, tol=tol, max_iter=NITER))
    out["launches"]["v2_tol"] = launches
    it = int(res.iters)
    h = res.history.cpu().numpy()
    print(f"  v2_tol: tol {tol:.6e} (fixed run first at or below it at "
          f"entry {first}); {it} iterations, launches {launches}",
          flush=True)
    check(it == first and np.array_equal(h[:it + 1], v2_hist[:it + 1])
          and bool(np.isnan(h[it + 1:]).all()),
          f"v2_tol: {it} iterations, history bitwise the fixed run's prefix, "
          "NaN after")
    check(launches == _zero_but(nekbone_ax_slab=it, nekbone_cg_update=it),
          f"v2_tol: launches {launches}")
    out["cases"]["v2_tol"] = (v2, f, dict(tol=tol, max_iter=NITER))
    return out


def phase_pmg_block_routes():
    """The two routes of this slice through ``case.solve``: p-multigrid
    PCG to 1e-8 r0 beside Chebyshev-PCG(4), and block CG."""
    import numpy as np
    import torch

    from repro_torch.core.cg import cg_fixed_iters
    from repro_torch.core.gs import ds_sum_local
    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.core.pmg import pmg_vcycle_reference

    print("== paper case, p-multigrid and block routes: n=10, E=1024, fp64",
          flush=True)
    out = {"launches": {}, "cases": {}}
    v2 = NekboneCase(n=10, grid=PAPER_GRID, dtype=torch.float64,
                     ax_impl="pallas_fused_cg_v2")
    u_ex, f = v2.manufactured()
    r0 = float(torch.sqrt(torch.abs(torch.sum(f * v2.c * f))))
    tol = PMG_RTOL * r0

    # --- p-multigrid PCG to 1e-8 r0, beside Chebyshev-PCG(4) -------------
    t0 = time.perf_counter()
    spec = v2.precond_spec("pmg")        # the one-time per-level Lanczos
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    res, launches = _launch_run(
        lambda: v2.solve(f, tol=tol, max_iter=NITER, precond="pmg"))
    out["launches"]["pmg"] = launches
    it = int(res.iters)
    h = res.history.cpu().numpy()
    cheb = v2.solve(f, tol=tol, max_iter=NITER, precond=f"cheb{CHEB_K}")
    it_cheb = int(cheb.iters)
    print(f"  pmg: ladder {spec.ns}, k={spec.k}, intervals "
          + ", ".join(f"[{a:.6e}, {b:.6e}]" for a, b in spec.intervals)
          + f" (set-up {setup_ms:.1f} ms); r0 {r0:.6e}, tol {tol:.6e}; "
          f"{it} iterations to rnorm {float(res.rnorm):.6e}, solution_error "
          f"{float(v2.solution_error(res.x, u_ex)):.6e}; cheb{CHEB_K}: "
          f"{it_cheb} iterations to rnorm {float(cheb.rnorm):.6e}; "
          f"launches {launches}", flush=True)
    check(0 < it <= min(it_cheb // 2, PMG_MAX_ITERS)
          and float(res.rnorm) <= tol
          and bool(np.isfinite(h[:it + 1]).all())
          and bool(np.isnan(h[it + 1:]).all()),
          f"pmg: rnorm {float(res.rnorm):.3e} <= tol {tol:.3e} in {it} <= "
          f"min(cheb{CHEB_K}'s {it_cheb} // 2, {PMG_MAX_ITERS}) iterations, "
          "history NaN after")
    L1 = len(spec.ns) - 1                # smoothed levels
    check(launches == _zero_but(
        nekbone_interp=2 * L1 * (it + 1),
        nekbone_cheb_apply=2 * L1 * (it + 1),
        nekbone_ax_slab=it + 2 * L1 * (it + 1),
        nekbone_cg_update=it + 2 * L1 * (it + 1)),
        f"pmg: launches {launches} (K12 = K11 = {2 * L1} x (iters + 1); K4 "
        f"= K5 = iters + {2 * L1} x (iters + 1))")
    # the plain V-cycle (reference route) on the same spec, on the card
    plain = NekboneCase(n=10, grid=PAPER_GRID, dtype=torch.float64,
                        ax_impl="fused")
    M = pmg_vcycle_reference(spec, D=plain.D, g=plain.g, grid=plain.grid,
                             mask=plain.mask, c=plain.c)
    h_ref = cg_fixed_iters(plain.ax_full, f, niter=10, dot=plain.dot(),
                           precond=M).history.cpu().numpy()
    dev = _rel_dev(h[:11], h_ref)
    check(float(np.abs(h[:11] - h_ref).max()) <= PCG_HIST_TOL_HEAD * h_ref[0],
          f"pmg: history entries 0..10 within {PCG_HIST_TOL_HEAD:g} of the "
          f"plain V-cycle route (largest rel deviation {float(dev.max()):.2e})")
    out["cases"]["pmg"] = (v2, f, dict(tol=tol, max_iter=NITER,
                                       precond="pmg"))
    out["cases"]["cheb_r0"] = (v2, f, dict(tol=tol, max_iter=NITER,
                                           precond=f"cheb{CHEB_K}"))
    out["pmg_setup_ms"] = setup_ms
    out["pmg_iters"], out["cheb_r0_iters"] = it, it_cheb

    # --- block CG, b = 4, 100 fixed iterations --------------------------
    rng = np.random.default_rng(9)
    F = torch.stack([f] + [
        ds_sum_local(torch.as_tensor(rng.normal(size=tuple(f.shape)),
                                     dtype=f.dtype, device="cuda"),
                     v2.grid) * v2.mask for _ in range(BLOCK_B - 1)])
    res, launches = _launch_run(lambda: v2.solve(F, niter=NITER))
    out["launches"]["block"] = launches
    h = res.history.cpu().numpy()
    check(res.pipeline == f"fused_v2_rhs{BLOCK_B}"
          and h.shape == (BLOCK_B, NITER + 1)
          and bool(np.isfinite(h).all())
          and tuple(res.x.shape) == tuple(F.shape),
          f"block b={BLOCK_B}: finite x of shape {tuple(res.x.shape)}, "
          f"history {h.shape}")
    check(launches == _zero_but(nekbone_ax_slab_block=NITER,
                                nekbone_cg_update_block=NITER),
          f"block b={BLOCK_B}: launches {launches}")
    same = []
    for j in range(BLOCK_B):
        solo = v2.solve(F[j], niter=NITER)
        same.append(torch.equal(res.history[j], solo.history)
                    and torch.equal(res.x[j], solo.x))
    print(f"  block b={BLOCK_B}: history[:, {NITER}] = "
          + " ".join(f"{x:.6e}" for x in h[:, NITER])
          + f"; lanes bitwise their own v2 solves: {same}", flush=True)
    check(all(same), f"block b={BLOCK_B}: every lane's history and x "
                     "bitwise its own v2 solve")
    out["cases"]["block"] = (v2, F, dict(niter=NITER))

    # --- block_tol and block_loop at b = 2 ------------------------------
    F2 = F[:2].contiguous()
    fixed = v2.solve(F2, niter=NITER).history.cpu().numpy()
    btol = float(fixed[:, NITER // 2].max()) * (1.0 + 1e-12)
    res, launches = _launch_run(lambda: v2.solve(F2, tol=btol,
                                                  max_iter=NITER))
    it = int(res.iters)
    h = res.history.cpu().numpy()
    first = int(np.nonzero((fixed <= btol).all(axis=0))[0][0])
    print(f"  block tol, b=2: tol {btol:.6e}; {it} iterations (the fixed "
          f"run first has both lanes at or below it at entry {first}); "
          f"launches {launches}", flush=True)
    check(it == first and np.array_equal(h[:, :it + 1], fixed[:, :it + 1])
          and bool(np.isnan(h[:, it + 1:]).all())
          and bool((res.rnorm.cpu().numpy() <= btol).all()),
          "block tol, b=2: every lane at or below tol, histories bitwise "
          "the fixed run's prefix, NaN after")
    check(launches == _zero_but(nekbone_ax_slab_block=it,
                                nekbone_cg_update_block=it),
          f"block tol, b=2: launches {launches}")
    # block_loop: the manufactured rhs and the weak-form rhs of a second
    # smooth solution, sin(2 pi x) sin(pi y) sin(pi z) (a random rhs is far
    # rougher: Chebyshev-PCG(4) leaves it at 2e-2 after 100 iterations)
    name = f"cheb{CHEB_K}"
    xyz = v2.mesh.coords()
    u2 = (np.sin(2 * np.pi * xyz[..., 0]) * np.sin(np.pi * xyz[..., 1])
          * np.sin(np.pi * xyz[..., 2]))
    f2 = ds_sum_local(torch.as_tensor(6 * np.pi ** 2 * u2, device="cuda")
                      * v2.bmass, v2.grid) * v2.mask
    F2 = torch.stack([f, f2])
    res, launches = _launch_run(
        lambda: v2.solve(F2, tol=CHEB_TOL, max_iter=NITER, precond=name))
    its = [int(x) for x in res.iters.cpu()]
    # NaN-padded histories: equal bitwise, NaN where NaN
    same = all(torch.allclose(res.history[j], v2.solve(
        F2[j], tol=CHEB_TOL, max_iter=NITER, precond=name).history, rtol=0,
        atol=0, equal_nan=True) for j in range(2))
    print(f"  block_loop {name}, b=2: iterations {its}, rnorm "
          f"{res.rnorm.cpu().numpy()}; launches {launches}", flush=True)
    check(res.history.shape == (2, NITER + 1)
          and bool((res.rnorm.cpu() <= CHEB_TOL).all()) and same,
          f"block_loop {name}, b=2: every lane at rnorm <= {CHEB_TOL:g}, "
          "histories bitwise the single-RHS solves")
    check(launches == _zero_but(nekbone_cheb_apply=sum(its) + 2,
                                nekbone_ax_slab=sum(its),
                                nekbone_cg_update=sum(its)),
          f"block_loop {name}, b=2: launches {launches}")
    return out


def _sstep_inputs(case, rng, theta=None):
    """Continuous p, r and K8/K9's operands on ``case``; ``inv_theta`` from
    ``theta`` (default: the case's own power-iteration estimate)."""
    import torch

    from repro_torch.core.cg_sstep import estimate_theta

    o = _v2_operands(case, rng)
    if theta is None:
        theta = estimate_theta(case.D, case.g, case.grid, case.mask)
    o["theta"] = theta
    o["inv_theta"] = torch.full((1,), 1.0 / theta, dtype=case.dtype,
                                device="cuda")
    return o


def phase_v1_sstep_parity():
    """K3 and K2 (the v1 operator) and K8 and K9 (the s-step cycle) against
    their plain versions at the paper case's width, fp64 and fp32."""
    import numpy as np
    import torch

    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import nekbone_ax as K
    from repro_torch.kernels import ref

    print("== K2/K3 and K8/K9 parity (kernel vs plain; n=10, E=1024; K8/K9 "
          "at s = 1, 2, 4; K8 also at E=4096 and at s = SSTEP_MAX_S, n = 4)",
          flush=True)
    rng = np.random.default_rng(7)
    errs = {}
    n = 10
    for dtype, tol, basis_tol in ((torch.float64, 1e-12, 1e-12),
                                  (torch.float32, 1e-5, 1e-4)):
        case = NekboneCase(n=n, grid=PAPER_GRID, dtype=dtype)
        E = case.mesh.nelt
        n3 = n ** 3
        tag = f"{dtype} n={n} E={E}"
        # K3 / K2: a random SPD metric, the box's mask and weight
        u, D, g = _operator_data(rng, E, n, dtype)
        r = torch.as_tensor(rng.normal(size=(E, n3)), dtype=dtype,
                            device="cuda")
        mask = case.mask.reshape(E, n3).contiguous()
        c = case.c.reshape(E, n3).contiguous()
        kw3, kpap3 = K.nekbone_ax_pap_cuda(u, D, g, mask, n=n)
        pw3, ppap3 = K.nekbone_ax_pap_plain(u, D, g, mask, n=n)
        kw2, kpap2, krcz = K.nekbone_ax_dots_cuda(u, D, g, mask, r, c, n=n)
        pw2, ppap2, prcz = K.nekbone_ax_dots_plain(u, D, g, mask, r, c, n=n)
        for name, kw, pw, parts in (
                ("K3", kw3, pw3, (("pap", kpap3, ppap3),)),
                ("K2", kw2, pw2, (("pap", kpap2, ppap2),
                                  ("rcz", krcz, prcz)))):
            err = rel_err(kw, pw)
            check(err <= tol, f"{name} {tag}: w max rel err {err:.2e} <= "
                              f"{tol:g}")
            for pname, a, b in parts:
                perr = abs(float(a.sum() - b.sum())) / abs(float(b.sum()))
                check(perr <= tol, f"{name} {tag}: {pname} rel err "
                                   f"{perr:.2e} <= {tol:g}")
            if dtype == torch.float64:
                errs[name] = float((kw - pw).abs().max())
        check(torch.equal(kw2, kw3) and torch.equal(kpap2, kpap3),
              f"K2/K3 {tag}: K2's w and pap bitwise K3's")
        # K8 / K9 on continuous p, r at the case's own theta
        o = _sstep_inputs(case, rng)
        g3 = o["g3"]
        for s in (1, 2, 4):
            args = (o["p"], o["r"], case.D, g3, *o["m"], *o["c"],
                    o["inv_theta"])
            kb, kg = K.nekbone_ax_powers_cuda(*args, n=n, s=s)
            pb, pg = K.nekbone_ax_powers_plain(*args, n=n, s=s)
            berr = max(rel_err(kb[:, m], pb[:, m]) for m in range(2 * s - 1))
            gk, gp = kg.sum(0), pg.sum(0)
            gerr = float((gk - gp).abs().max() / gp.abs().max())
            check(berr <= basis_tol and gerr <= 10 * basis_tol
                  and torch.equal(kg, kg.transpose(1, 2)),
                  f"K8 {tag} s={s}: basis max rel err {berr:.2e} <= "
                  f"{basis_tol:g}, summed Gram rel err {gerr:.2e} <= "
                  f"{10 * basis_tol:g}, partials symmetric")
            coef = torch.as_tensor(rng.normal(size=(3, 2 * s + 1)),
                                   dtype=dtype, device="cuda")
            uargs = (o["x"], o["p"], o["r"], kb, coef, *o["c"])
            kx, kr, kp, krcr = K.nekbone_sstep_update_cuda(*uargs, n=n, s=s)
            px, pr, pp, prcr = K.nekbone_sstep_update_plain(*uargs, n=n, s=s)
            rerr = abs(float(krcr.sum() - prcr.sum())) / abs(float(prcr.sum()))
            check(torch.equal(kx, px) and torch.equal(kr, pr)
                  and torch.equal(kp, pp) and rerr <= tol,
                  f"K9 {tag} s={s}: x, r, p bitwise the plain version, rcr "
                  f"rel err {rerr:.2e} <= {tol:g}")
            if s == SSTEP_S:
                k8, k9 = (("K8", "K9") if dtype == torch.float64
                          else (("K8", "f32"), ("K9", "f32")))
                errs[k8] = float((kb - pb).abs().max())
                errs[k9] = float((kr - pr).abs().max())
        print(f"  theta ({dtype}) {o['theta']:.6e}", flush=True)
    # K8's launch plan on every size it runs here, the Gram partials in the
    # kernel's order of terms, and repeats (a missing grid sync or a stale
    # read of a neighbour's A_loc v shows as calls that disagree)
    for dtype, basis_tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        for n, grid, ss in ((10, PAPER_GRID, (1, 2, SSTEP_S)),
                            (10, BIG_GRID, (1, 2, SSTEP_S)),
                            (4, PAPER_GRID, (K.SSTEP_MAX_S,))):
            case = NekboneCase(n=n, grid=grid, dtype=dtype)
            E = case.mesh.nelt
            o = _sstep_inputs(case, rng)
            args = (o["p"], o["r"], case.D, o["g3"], *o["m"], *o["c"],
                    o["inv_theta"])
            for s in ss:
                tag = f"{dtype} n={n} E={E} s={s}"
                plan, info = K.nekbone_ax_powers_plan(
                    E, n, s, "f64" if dtype == torch.float64 else "f32")
                print(f"  K8 {tag}: one cooperative launch of {plan.grid} "
                      f"blocks ({info['slices']} elements side by side, "
                      f"{plan.per_block} owned), {plan.blocks_per_sm} blocks "
                      f"per SM on {info['sm_count']} SMs, {plan.smem_bytes} "
                      f"bytes dynamic + {info['static_smem']} static shared "
                      f"memory, {info['registers']} registers", flush=True)
                kb, kg = K.nekbone_ax_powers_cuda(*args, n=n, s=s)
                if (n, grid) != (10, PAPER_GRID):   # held above
                    pb, pg = K.nekbone_ax_powers_plain(*args, n=n, s=s)
                    berr = max(rel_err(kb[:, m], pb[:, m])
                               for m in range(2 * s - 1))
                    gk, gp = kg.sum(0), pg.sum(0)
                    gerr = float((gk - gp).abs().max() / gp.abs().max())
                    check(berr <= basis_tol and gerr <= 10 * basis_tol,
                          f"K8 {tag}: basis max rel err {berr:.2e} <= "
                          f"{basis_tol:g}, summed Gram rel err {gerr:.2e} <= "
                          f"{10 * basis_tol:g}")
                    del pb, pg
                em = ref.sstep_gram_emulated(o["p"], o["r"], kb, *o["c"],
                                             n=n, s=s)
                check(torch.equal(kg, em),
                      f"K8 {tag}: Gram partials bitwise "
                      "ref.sstep_gram_emulated of the basis")
                reps = [K.nekbone_ax_powers_cuda(*args, n=n, s=s)
                        for _ in range(5)]
                check(all(torch.equal(b, kb) and torch.equal(g, kg)
                          for b, g in reps),
                      f"K8 {tag}: 5 more calls give bitwise the same basis "
                      "and Gram partials")
                del kb, kg, em, reps
            del o, args
            torch.cuda.empty_cache()
    _k9_edge_parity(("f64", "f32"))
    torch.cuda.synchronize()
    return errs


def phase_v1_sstep_routes(hist):
    """The v1 and s-step routes of the paper case through ``case.solve``,
    each with the launch counters set to 0 just before it."""
    import numpy as np
    import torch

    from repro_torch.core.nekbone import NekboneCase

    print(f"== paper case, v1 and s-step routes: n=10, E=1024, fp64, "
          f"{NITER} iterations", flush=True)
    out = {"launches": {}, "cases": {}}

    def case_of(impl, **kw):
        return NekboneCase(n=10, grid=PAPER_GRID, dtype=torch.float64,
                           ax_impl=impl, **kw)

    base, v2_hist = hist["fused"], hist["pallas_fused_cg_v2"]
    envelope = float(_rel_dev(hist["fused on the CPU"], base).max())

    # --- v1 (K3), 100 iterations, against the plain route on the card ---
    v1 = case_of("pallas_fused_cg")
    u_ex, f = v1.manufactured()
    res, launches = _launch_run(lambda: v1.solve(f, niter=NITER))
    out["launches"]["v1"] = launches
    h = res.history.cpu().numpy()
    check(res.pipeline == "fused_v1" and h.shape == (NITER + 1,)
          and bool(np.isfinite(h).all())
          and bool(torch.isfinite(res.x).all()),
          f"v1: pipeline {res.pipeline}, finite x and history of {h.size}")
    check(launches == _zero_but(nekbone_ax_pap=NITER),
          f"v1: launches {launches}")
    dev = _rel_dev(h, base)
    k = int(dev.argmax())
    print(f"  v1: history[{NITER}]={h[NITER]:.6e} solution_error="
          f"{float(v1.solution_error(res.x, u_ex)):.6e}; vs fused: entries "
          f"0..10 {float(dev[:11].max()):.2e}, all {float(dev.max()):.2e} at "
          f"entry {k} (plain route CPU vs card {envelope:.2e})", flush=True)
    check(float(dev[:11].max()) <= HIST_RTOL_HEAD,
          f"v1: history entries 0..10 within {HIST_RTOL_HEAD:g} of fused")
    check(float(dev.max()) <= max(HIST_RTOL_HEAD, ENVELOPE_FACTOR * envelope),
          f"v1: all {NITER + 1} entries within {ENVELOPE_FACTOR:g}x the "
          f"plain route's own CPU-vs-card spread ({envelope:.2e})")
    out["cases"]["v1"] = (v1, f, dict(niter=NITER))

    # --- s-step at s = 4, 1 (100 iterations) and 2 (99: a remainder) ----
    fixed = {}
    for s, niter, head_tol in ((SSTEP_S, NITER, SSTEP_HIST_TOL_HEAD),
                               (1, NITER, SSTEP1_HIST_TOL_HEAD),
                               (2, NITER - 1, SSTEP_HIST_TOL_HEAD)):
        case = case_of("pallas_sstep_v3", s=s)
        t0 = time.perf_counter()
        res, launches = _launch_run(lambda: case.solve(f, niter=niter))
        first_ms = (time.perf_counter() - t0) * 1e3
        out["launches"][f"sstep{s}"] = launches
        cycles = -(-niter // s)
        h = res.history.cpu().numpy()
        check(res.pipeline == "sstep_v3" and int(res.iters) == niter
              and h.shape == (niter + 1,) and bool(np.isfinite(h).all())
              and bool(torch.isfinite(res.x).all()),
              f"sstep s={s}: {niter} iterations, finite x and history of "
              f"{h.size}")
        check(launches == _zero_but(nekbone_ax_powers=cycles,
                                    nekbone_sstep_update=cycles),
              f"sstep s={s}: launches {launches} (K8 = K9 = {cycles} "
              f"cycles; K8 is 1 device launch per cycle, a cooperative "
              f"launch, so {cycles} device launches)")
        dev = _rel_dev(h, v2_hist[:niter + 1])
        k = int(dev.argmax())
        print(f"  sstep s={s}: theta {case._sstep_theta:.6e} (first solve "
              f"with its estimate {first_ms:.1f} ms); history[{niter}]="
              f"{h[niter]:.6e} solution_error="
              f"{float(case.solution_error(res.x, u_ex)):.6e}; vs v2: "
              f"entries 0..10 {float(dev[:11].max()):.2e}, worst over all "
              f"{niter + 1} {float(dev.max()):.2e} at entry {k} (v2 "
              f"{v2_hist[k]:.6e}, sstep {h[k]:.6e}); max over 0..k by k: "
              + " ".join(f"{j}:{float(dev[:j + 1].max()):.1e}"
                         for j in range(10, niter + 1, 10)), flush=True)
        check(float(dev[:11].max()) <= head_tol,
              f"sstep s={s}: history entries 0..10 within {head_tol:g} of v2")
        fixed[s] = (case, h)
        out["cases"][f"sstep{s}"] = (case, f, dict(niter=NITER))

    # --- s-step to a tolerance, stopping inside a cycle -----------------
    case, h4 = fixed[SSTEP_S]
    for j in range(NITER // 2, NITER):
        tol = float(h4[j]) * (1.0 + 1e-12)
        first = int(np.nonzero(h4 <= tol)[0][0])
        if first % SSTEP_S:
            break
    res, launches = _launch_run(lambda: case.solve(f, tol=tol,
                                                   max_iter=NITER))
    it = int(res.iters)
    h = res.history.cpu().numpy()
    cycles = first // SSTEP_S + 1
    print(f"  sstep s={SSTEP_S} tol {tol:.6e} (the fixed run first at or "
          f"below it at entry {first}, inside cycle {cycles}); {it} "
          f"iterations, last entry {h[-1]:.6e} (fixed run {h4[first]:.6e}); "
          f"launches {launches}", flush=True)
    check(it == first and h.shape == (it + 1,)
          and np.array_equal(h[:it], h4[:it])
          and abs(h[it] - h4[it]) <= SSTEP_HIST_TOL_HEAD * h4[0],
          f"sstep tol: {it} iterations, history bitwise the fixed run's "
          f"prefix but for the last entry (the stored residual after the "
          f"shortened cycle, within {SSTEP_HIST_TOL_HEAD:g} h0)")
    check(launches == _zero_but(nekbone_ax_powers=cycles,
                                nekbone_sstep_update=cycles),
          f"sstep tol: launches {launches}")
    return out


def _time_row(label, kern, plain, nbytes, mma_flops, rest_flops, bw_copy,
              lib=None, mma_peak=FP64_TENSOR_PEAK, rest_peak=FP64_PEAK):
    """Device time of a kernel, its plain version and, where one PyTorch
    call computes the same function, that call; the bound from the bytes
    (each input read once, each output written once) and the operations
    (contraction flops at ``mma_peak``, by default the fp64 tensor cores'
    rate, the rest at ``rest_peak``), at the data sheet's peaks."""
    ms = device_ms(kern)
    plain_ms = device_ms(plain)
    lib_ms = device_ms(lib) if lib is not None else None
    t_bytes = nbytes / BW_PEAK * 1e3
    t_ops = (mma_flops / mma_peak + rest_flops / rest_peak) * 1e3
    bound = max(t_bytes, t_ops)
    print(f"  {label}: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s, "
          f"{nbytes / ms / 1e6 / (bw_copy / 1e9):.2f} of copy BW, "
          f"{bound / ms:.2f} of the bound); plain "
          f"{plain_ms:.4f} ms; "
          + (f"library {lib_ms:.4f} ms; " if lib is not None else "")
          + f"bound {bound:.4f} ms (bytes at 3.35 TB/s {t_bytes:.4f}, "
          f"operations {t_ops:.4f}), {nbytes / bw_copy * 1e3:.4f} ms at "
          f"measured copy BW; {nbytes / 1e6:.2f} MB", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_copy_ms=nbytes / bw_copy * 1e3, bytes=nbytes)


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
        # name: (kernel, plain version, bytes, (contraction, other) flops
        # per point)
        work = {
            "K1": (lambda: K.nekbone_ax_cuda(u, D, g, n=n),
                   lambda: K.nekbone_ax_plain(u, D, g, n=n),
                   8 * field, (12 * n, 17)),
            "K4": (lambda: K.nekbone_ax_slab_cuda(
                       o["p"], o["r"], case.D, o["g3"], *o["m"], o["beta"],
                       n=n),
                   lambda: K.nekbone_ax_slab_plain(
                       o["p"], o["r"], case.D, o["g3"], *o["m"], o["beta"],
                       n=n),
                   7 * field, (12 * n, 10)),
            "K5": (lambda: K.nekbone_cg_update_cuda(
                       o["x"], kp, o["r"], kw, o["alpha"], *o["c"], n=n),
                   lambda: K.nekbone_cg_update_plain(
                       o["x"], kp, o["r"], kw, o["alpha"], *o["c"], n=n),
                   6 * field, (0, 8)),
        }
        q = _pcg_operands(case, rng)
        k10 = (q["x"], kp, q["z"], kw, q["alpha"], q["invd"], *q["c"])
        k11 = (q["z"], q["D"], q["g3"], *q["m"], *q["c"], q["coef"][CHEB_K])
        work.update({
            # 5 reads + 2 writes; about 14 flops per node
            "K10": (lambda: K.nekbone_pcg_update_cuda(*k10, n=n),
                    lambda: K.nekbone_pcg_update_plain(*k10, n=n),
                    7 * field, (0, 14)),
            # the book: r and 3 metric diagonals in, z out
            "K11": (lambda: K.nekbone_cheb_apply_cuda(*k11, n=n, k=CHEB_K),
                    lambda: K.nekbone_cheb_apply_plain(*k11, n=n, k=CHEB_K),
                    5 * field, cost.cheb_apply_flops(n, CHEB_K)),
        })
        for name, (kern, plain, nbytes, (f_mma, f_rest)) in work.items():
            rows[(name, grid)] = _time_row(
                f"{name} E={E}", kern, plain, nbytes,
                E * n ** 3 * f_mma, E * n ** 3 * f_rest, bw_copy)
        # K12 on every ladder step, K6 and K7 at b = 1 and 4
        for nin, nout in LADDER_PAIRS:
            u2 = torch.as_tensor(rng.normal(size=(E, nin ** 3)),
                                 device="cuda")
            mt = _ladder_matrix(nin, nout, torch.float64)
            row = _time_row(
                f"K12 {nin}->{nout} E={E}",
                lambda: K.nekbone_interp_cuda(u2, mt, nin=nin, nout=nout),
                lambda: K.nekbone_interp_plain(u2, mt, nin=nin, nout=nout),
                E * (nin ** 3 + nout ** 3) * 8,
                2 * E * (nin * nin * nout + nin * nout * nout + nout ** 3),
                0, bw_copy,
                lib=lambda: torch.einsum(
                    "ekji,ia,jb,kc->ecba", u2.view(E, nin, nin, nin), mt, mt,
                    mt))
            rows[(f"K12 {nin}->{nout}", grid)] = row
            if (nin, nout) == (10, 5):
                rows[("K12", grid)] = row
            # the launch floor: an empty kernel on this step's grid, block
            # size and shared memory, timed by the same harness
            plan, _ = K.nekbone_interp_plan(E, nin, nout, "f64")
            row["floor_ms"] = device_ms(
                lambda: K.nekbone_interp_floor(plan, "f64"))
            print(f"  K12 {nin}->{nout} E={E}: plan G={plan.group}, grid "
                  f"{plan.grid} x {plan.per_block} groups of "
                  f"{plan.threads} threads ({plan.copy}); the empty kernel "
                  f"on this grid {row['floor_ms']:.4f} ms, the kernel "
                  f"{row['ms'] / row['floor_ms']:.2f} of it", flush=True)
        m, c = o["m"], o["c"]
        for b in (1, 3, BLOCK_B):
            ops_b = [_v2_operands(case, rng) for _ in range(b)]
            P, R, X = (torch.stack([q[key] for q in ops_b])
                       for key in ("p", "r", "x"))
            beta = torch.full((b,), 0.37, dtype=torch.float64, device="cuda")
            alpha = torch.full((b,), 0.81, dtype=torch.float64,
                               device="cuda")
            p3, w3, _ = K.nekbone_ax_slab_block_cuda(P, R, case.D, o["g3"],
                                                     *m, beta, n=n)
            k6 = (P, R, case.D, o["g3"], *m, beta)
            k7 = (X, p3, R, w3, alpha, *c)
            for name, kern, plain, fields, flops in (
                    ("K6", K.nekbone_ax_slab_block_cuda,
                     K.nekbone_ax_slab_block_plain, 4 * b + 3,
                     (12 * n, 10)),
                    ("K7", K.nekbone_cg_update_block_cuda,
                     K.nekbone_cg_update_block_plain, 6 * b, (0, 8))):
                args = k6 if name == "K6" else k7
                row = _time_row(
                    f"{name} b={b} E={E}",
                    lambda: kern(*args, n=n), lambda: plain(*args, n=n),
                    fields * field, b * E * n ** 3 * flops[0],
                    b * E * n ** 3 * flops[1], bw_copy)
                rows[(f"{name} b={b}", grid)] = row
                if b == BLOCK_B:
                    rows[(name, grid)] = row
            # K6 reads the metric once per pair of lanes
            # (csrc/nekbone_ax_slab_block.cu)
            moved = 4 * b + 3 * len(K.k6_lane_groups(b))
            print(f"  K6 b={b} E={E}: moves {moved} fields "
                  f"({moved * field / 1e6:.1f} MB) against the book's "
                  f"{4 * b + 3}; {moved * field / rows[(f'K6 b={b}', grid)]['ms'] / 1e6:.0f}"
                  " GB/s moved", flush=True)
            del P, R, X, p3, w3, ops_b
        # the fields K11's variant actually moves (csrc/nekbone_cheb_apply.cu):
        # with the state resident, r and the metric in and A d out at the
        # start, A d and the metric in and A d out at each middle step, A d
        # and r in and z out at the last; in device memory, d, res and z too
        plan, _ = K.nekbone_cheb_apply_plan(E, n, "f64")
        fields = 5 * CHEB_K + 3 if plan.resident else 11 * CHEB_K
        moved = fields * field
        print(f"  K11 E={E} ({plan.variant}-memory variant): moves "
              f"{moved / 1e6:.1f} MB ({fields} fields) against the book's "
              f"{5 * field / 1e6:.1f} MB; "
              f"{moved / rows[('K11', grid)]['ms'] / 1e6:.0f} GB/s moved",
              flush=True)
        rows[("K11", grid)]["moved_bytes"] = moved
        del u, D, g, o, kp, kw, q
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
        if impl == "pallas_fused_cg_v2":
            v2_solve_ms = ms * NITER
    return rows, v2_solve_ms


def phase_pcg_times(pcg, v2_solve_ms):
    """Solves of the PCG and tolerance routes (host clock to synchronize,
    median of 5), the cost of the per-iteration stop check, and the
    Chebyshev interval's one-time set-up."""
    from repro_torch.core import cost
    from repro_torch.core.precond import estimate_interval

    print("== times of this slice's routes (host clock to synchronize, "
          "median of 5)", flush=True)
    case, f, _ = pcg["cases"]["jacobi"]
    ndof = case.mesh.ndof
    books = {"jacobi": (cost.JACOBI_V2_READ_STREAMS
                        + cost.JACOBI_V2_WRITE_STREAMS),
             "cheb": cost.CHEB_V2_READ_STREAMS + cost.CHEB_V2_WRITE_STREAMS,
             "v2_tol": (cost.FUSED_V2_READ_STREAMS
                        + cost.FUSED_V2_WRITE_STREAMS)}
    out = {}
    for label, (case, f, kw) in pcg["cases"].items():
        iters = int(case.solve(f, **kw).iters)
        ms = wall_ms(lambda: case.solve(f, **kw))
        book = books[label] * ndof * 8
        out[label] = ms
        print(f"  {label} {kw}: {ms:.3f} ms for {iters} iterations, "
              f"{ms / iters:.4f} ms/iteration; book {book / 1e6:.1f} "
              f"MB/iteration -> {book * iters / ms / 1e6:.0f} GB/s",
              flush=True)
    case, f, kw = pcg["cases"]["cheb"]
    iters = int(case.solve(f, **kw).iters)
    fixed = wall_ms(lambda: case.solve(f, niter=iters,
                                       precond=kw["precond"]))
    print(f"  time to rnorm <= {CHEB_TOL:g}: cheb{CHEB_K} "
          f"{out['cheb']:.3f} ms; the same {iters} iterations fixed, with no "
          f"host read of the stop rule: {fixed:.3f} ms; v2 without a "
          f"preconditioner never gets there ({NITER} iterations: "
          f"{v2_solve_ms:.3f} ms)", flush=True)
    # the stop check: the same 100 iterations, the host reading the stop
    # condition before each or never, in turns (the host clock drifts)
    case, f, _ = pcg["cases"]["v2_tol"]
    runs = {"checked": lambda: case.solve(f, tol=0.0, max_iter=NITER),
            "unchecked": lambda: case.solve(f, niter=NITER)}
    times = {key: [] for key in runs}
    for _ in range(9):
        for key, fn in runs.items():
            times[key].append(wall_ms(fn, reps=1, warmup=0))
    med = {key: statistics.median(t) for key, t in times.items()}
    low = {key: min(t) for key, t in times.items()}
    print(f"  stop check, v2 {NITER} iterations in 9 alternating pairs: "
          f"median {med['checked']:.3f} ms with the host reading "
          f"|rtz| > tol^2 before each iteration, {med['unchecked']:.3f} ms "
          f"without ({(med['checked'] - med['unchecked']) / NITER * 1e3:.1f}"
          f" us per iteration); fastest {low['checked']:.3f} vs "
          f"{low['unchecked']:.3f} ms "
          f"({(low['checked'] - low['unchecked']) / NITER * 1e3:.1f} us per "
          "iteration)", flush=True)
    setup = wall_ms(lambda: estimate_interval(case.D, case.g, case.grid,
                                              case.mask, case.c), reps=3)
    print(f"  Chebyshev interval set-up (16 Lanczos steps, plain torch, "
          f"once per case): {setup:.3f} ms", flush=True)


def phase_slice3_times(routes, v2_solve_ms):
    """The pmg and block solves (host clock to synchronize, median of 5)."""
    from repro_torch.core import cost
    from repro_torch.core.cg_block import cg_block_fixed_iters

    print("== times of the pmg and block routes (host clock to synchronize, "
          "median of 5)", flush=True)
    out = {}
    case, f, kw = routes["cases"]["pmg"]
    ndof = case.mesh.ndof
    for label in ("pmg", "cheb_r0"):
        case, f, kw = routes["cases"][label]
        iters = int(case.solve(f, **kw).iters)
        ms = wall_ms(lambda: case.solve(f, **kw))
        out[label] = (ms, iters)
        print(f"  {kw['precond']} to rnorm <= {kw['tol']:.6e} (1e-8 r0): "
              f"{ms:.3f} ms for {iters} iterations, {ms / iters:.4f} "
              "ms/iteration", flush=True)
    case, f, kw = routes["cases"]["pmg"]
    iters = out["pmg"][1]
    fixed = wall_ms(lambda: case.solve(f, niter=iters, precond="pmg"))
    reads, writes = cost.pmg_streams(10)
    print(f"  pmg: the same {iters} iterations fixed, with no host read of "
          f"the stop rule: {fixed:.3f} ms; book {reads + writes:.2f} streams "
          f"= {(reads + writes) * ndof * 8 / 1e6:.1f} MB per iteration; "
          f"one-time set-up (3 Lanczos estimates) "
          f"{routes['pmg_setup_ms']:.1f} ms", flush=True)
    case, F, _ = routes["cases"]["block"]
    v2_ms = v2_solve_ms / NITER
    kw = dict(D=case.D, g=case.g, grid=case.grid, niter=NITER,
              mask=case.mask, c=case.c)
    for b in (1, BLOCK_B):
        ms = wall_ms(lambda: cg_block_fixed_iters(F[:b], **kw)) / NITER
        reads, writes = cost.multi_rhs_streams(b)
        book = (reads + writes) * ndof * 8
        out[f"block{b}"] = ms
        print(f"  block b={b}, {NITER} iterations: {ms:.4f} ms/iteration, "
              f"{ms / b:.4f} ms/iteration per RHS (v2: {v2_ms:.4f}); book "
              f"{reads + writes:.3f} streams per RHS -> "
              f"{book * b / ms / 1e6:.0f} GB/s", flush=True)
    return out


def _k8_moved_fields(s: int) -> int:
    """Fields one K8 call moves through L2 or device memory
    (csrc/nekbone_ax_powers.cu): p (and r when s >= 2) at the start; the
    metric once per step with an application; per application its
    unassembled output; per assembly its input and its basis vector; the
    Gram's 2s + 1 vectors once per pass (n = 10: 3 x 3 tiles of pairs, ten a
    pass)."""
    K = 2 * s + 1
    apps = 2 * s - 1
    tiles = -(-K // 3) * (-(-K // 3) + 1) // 2
    return ((2 if s >= 2 else 1) + 3 * s + apps + 2 * apps
            + K * -(-tiles // 10))


def phase_slice4_times(bw_copy, routes, rows):
    """Device time of K2, K3, K8 and K9 beside their plain versions (and
    K9 beside one ``torch.matmul``) at E=1024 and E=4096; then ms per
    iteration of v1 and s-step (s = 1, 2, 4) beside v2, in turns."""
    import numpy as np
    import torch

    from repro_torch.core import cost
    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import nekbone_ax as K

    print("== times of the v1 and s-step kernels and routes (fp64, n=10; "
          "kernels: device time per call; solves: host clock to "
          "synchronize, median of 5)", flush=True)
    rng = np.random.default_rng(8)
    n = 10
    for grid in (PAPER_GRID, BIG_GRID):
        case = NekboneCase(n=n, grid=grid, dtype=torch.float64)
        E = case.mesh.nelt
        n3 = n ** 3
        field = E * n3 * 8
        u, D, g = _operator_data(rng, E, n, torch.float64)
        r = torch.as_tensor(rng.normal(size=(E, n3)), device="cuda")
        mask = case.mask.reshape(E, n3).contiguous()
        c = case.c.reshape(E, n3).contiguous()
        k3 = (u, D, g, mask)
        k2 = (u, D, g, mask, r, c)
        # bytes: K3 p, 6 metric, mask in, w out; K2 also r and c in.
        # operations per point: 12n contraction flops; the metric (15),
        # the mask (1), pap (2) and for K2 rcz (3)
        for name, kern, plain, fields, other in (
                ("K3", K.nekbone_ax_pap_cuda, K.nekbone_ax_pap_plain, 9, 18),
                ("K2", K.nekbone_ax_dots_cuda, K.nekbone_ax_dots_plain, 11,
                 21)):
            args = k3 if name == "K3" else k2
            rows[(name, grid)] = _time_row(
                f"{name} E={E}", lambda: kern(*args, n=n),
                lambda: plain(*args, n=n), fields * field,
                E * n3 * 12 * n, E * n3 * other, bw_copy)
        o = _sstep_inputs(case, rng)
        for s in (1, 2, SSTEP_S):
            K_ = 2 * s + 1
            k8 = (o["p"], o["r"], case.D, o["g3"], *o["m"], *o["c"],
                  o["inv_theta"])
            basis, _ = K.nekbone_ax_powers_cuda(*k8, n=n, s=s)
            coef = torch.as_tensor(rng.normal(size=(3, K_)), device="cuda")
            k9 = (o["x"], o["p"], o["r"], basis, coef, *o["c"])
            # K8: p, r, 3 metric diagonals in, 2s-1 basis vectors and the
            # E (2s+1)^2 Gram partials out; 2s-1 applications of 12n
            # contraction and 6 other flops (metric 4, mask, scale) per
            # point, and 3 per Gram pair and point
            gram_bytes = E * K_ * K_ * 8
            row8 = _time_row(
                f"K8 s={s} E={E}", lambda: K.nekbone_ax_powers_cuda(
                    *k8, n=n, s=s),
                lambda: K.nekbone_ax_powers_plain(*k8, n=n, s=s),
                (5 + 2 * s - 1) * field + gram_bytes,
                (2 * s - 1) * E * n3 * 12 * n,
                E * n3 * (6 * (2 * s - 1) + 3 * K_ * (K_ + 1) // 2), bw_copy)
            plan, info = K.nekbone_ax_powers_plan(E, n, s, "f64")
            fields = _k8_moved_fields(s)
            moved = fields * field + gram_bytes
            row8["moved_bytes"] = moved
            print(f"  K8 s={s} E={E}: one cooperative launch (grid "
                  f"{plan.grid}, {plan.blocks_per_sm} blocks per SM, "
                  f"{plan.smem_bytes} + "
                  f"{info['static_smem']} bytes shared, {info['registers']} "
                  f"registers), moves {fields} fields ({moved / 1e6:.1f} MB "
                  f"with the Gram partials) against the book's "
                  f"{5 + 2 * s - 1} "
                  f"({((5 + 2 * s - 1) * field + gram_bytes) / 1e6:.1f} MB) "
                  f"and the chain's {11 * s if s >= 2 else 10}; "
                  f"{moved / row8['ms'] / 1e6:.0f} GB/s moved", flush=True)
            # K9: x, p, r and 2s-1 basis vectors in, x, r, p out; 6 flops
            # per term and point, 3 for rcr.  Library: the three
            # combinations as one matmul over a stacked (2s+1, E n^3) V
            # (no rcr partial)
            V = torch.stack([o["p"]] + [basis[:, m] for m in range(s)]
                            + [o["r"]]
                            + [basis[:, s + m] for m in range(s - 1)]
                            ).reshape(K_, E * n3)
            row9 = _time_row(
                f"K9 s={s} E={E}",
                lambda: K.nekbone_sstep_update_cuda(*k9, n=n, s=s),
                lambda: K.nekbone_sstep_update_plain(*k9, n=n, s=s),
                (3 + 2 * s - 1 + 3) * field, 0, E * n3 * (6 * K_ + 3),
                bw_copy, lib=lambda: torch.matmul(coef, V))
            rows[(f"K8 s={s}", grid)] = row8
            rows[(f"K9 s={s}", grid)] = row9
            if s == SSTEP_S:
                rows[("K8", grid)] = row8
                rows[("K9", grid)] = row9
            del basis, V
        del u, D, g, r, o
    # whole solves per iteration, paper case, in turns
    f = routes["cases"]["v1"][1]
    v2 = NekboneCase(n=10, grid=PAPER_GRID, dtype=torch.float64,
                     ax_impl="pallas_fused_cg_v2")
    ndof = v2.mesh.ndof
    solves = {"v2": (v2, sum(cost.fused_v2_cg_iter_bytes(ndof, 8))),
              "v1": (routes["cases"]["v1"][0],
                     sum(cost.fused_cg_iter_bytes(ndof, 8)))}
    for s in (SSTEP_S, 2, 1):
        reads, writes = cost.sstep_streams(s)
        solves[f"sstep s={s}"] = (routes["cases"][f"sstep{s}"][0],
                                  (reads + writes) * ndof * 8)
    times = {key: [] for key in solves}
    for _ in range(3):
        for key, (case, _) in solves.items():
            times[key].append(wall_ms(
                lambda: case.solve(f, niter=NITER), reps=3) / NITER)
    for key, (case, book) in solves.items():
        ms = statistics.median(times[key])
        print(f"  solve {key}, {NITER} iterations: {ms:.4f} ms/iteration "
              f"(median of 3 rounds in turns: "
              + ", ".join(f"{t:.4f}" for t in times[key])
              + f"); book {book / 1e6:.1f} MB/iteration -> "
              f"{book / ms / 1e6:.0f} GB/s", flush=True)
    return times


def phase_profile(cases, pcg, routes, slice4, ir, slice12,
                  niter: int = 20):
    """Device time per iteration of each solve, by kernel, from
    torch.profiler; the busy share is device time over the span from the
    first to the last device event (the profiler slows the host, so the
    idle share it shows is an upper bound).  The reduced-precision solves
    (``bf16_ir`` over v2, ``bf16`` block CG at b = 4) count their
    iterations as their CG update kernel's launches (K5's, K7's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build

    print(f"== profile ({niter}-iteration solves under torch.profiler)",
          flush=True)
    runs = {impl: (*cases[impl], dict(niter=niter))
            for impl in ("pallas", "pallas_fused_cg_v2")}
    for label, (case, f, kw) in pcg["cases"].items():
        if "niter" in kw:
            kw = dict(kw, niter=niter)
        else:                           # v2_tol: all niter, each checked
            kw = dict(kw, max_iter=niter,
                      tol=0.0 if label == "v2_tol" else kw["tol"])
        runs[label] = (case, f, kw)
    runs["pmg"] = routes["cases"]["pmg"]             # its whole solve
    case, F, _ = routes["cases"]["block"]
    runs[f"block b={BLOCK_B}"] = (case, F, dict(niter=niter))
    for label in ("v1", f"sstep{SSTEP_S}"):
        case, f, _ = slice4["cases"][label]
        runs[label] = (case, f, dict(niter=niter))
    solves = {impl: (lambda case=case, f=f, kw=kw:
                     int(case.solve(f, **kw).iters))
              for impl, (case, f, kw) in runs.items()}

    def counted(fn, stem):
        def run():
            _build.reset_launches()
            fn()
            return _build.LAUNCHES[stem]
        return run

    case, f = ir["cases"]["bf16_ir v2"]
    solves["bf16_ir v2"] = counted(lambda: case.solve(f, niter=niter),
                                   "nekbone_cg_update")
    bcase, F16 = slice12["block_case"]
    solves[f"bf16 block b={BLOCK_B}"] = counted(
        lambda: bcase.solve(F16, niter=niter), "nekbone_cg_update_block")
    for impl, solve in solves.items():
        solve()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            iters = solve()
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
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        print(f"  {impl}: {iters} iterations, device {busy / iters:.1f} "
              f"us/iteration in {len(kernels) / iters:.1f} device "
              f"ops/iteration; busy {busy / span:.2f} of the device span; "
              "top: " + "; ".join(f"{name[:48]} {t / iters:.1f} us"
                                  for name, t in top), flush=True)


# ---------------------------------------------------------------------------
# Slice 6: iterative refinement (the ir route) and the bf16 builds of K4, K5
# and K3
# ---------------------------------------------------------------------------
BF16_MIXES = ("bf16", "bf16_ir")
# bf16 fields are held value by value (_value_rel): kernel and plain version
# each round one f32 result to bf16, so they may differ by one bf16 step
# plus their f32 difference (this tolerance of the largest value).  The
# partials are f32 sums of the same terms in two orders, held relatively.
BF16_F32_TOL = 1e-5
BF16_PART_TOL = 1e-5
# The ir and bf16 routes against the same route over the plain versions on
# the card (the kernel wrappers swapped for their plain versions).  Entry 0
# is the same torch sum on both sides.  A reduced-precision sweep ends at a
# noisy floor: two valid f32 orders of the partials changed one sweep's
# contraction by up to 3.0x (the plain route against itself with its
# partials reordered and scaled by 1 +- 2e-7, on the CPU at n = 10, grids
# 4x4x4 and 4x4x8, 100 inner iterations), and the kernel route against the
# plain one on the card by up to 8.3x (f32_ir over v1, second sweep).  So
# outer entry k must lie within IR_SWEEP_FACTOR^k of the plain route's:
# each sweep may add one such factor.  (Python code shared by both sides is
# held to the reference by the CPU tests, tests/test_torch_ir.py.)
IR_SWEEP_FACTOR = 10.0
# non-refined bf16: the first 10 entries, relative (bf16 storage: 2^-7)
BF16_HEAD_TOL = 1e-2
# bf16_ir's outer norms must not rise (x 1.05: the reference's own test)
IR_MONOTONE = 1.05
IR_ROUTES = (("f32_ir", "v2"), ("f32_ir", "v1"), ("f32_ir", "sstep"),
             ("bf16_ir", "v2"), ("bf16_ir", "v1"), ("bf16_ir", "sstep"),
             ("bf16", "v2"), ("bf16", "v1"), ("bf16", "sstep"))
IR_IMPL = {"v2": "pallas_fused_cg_v2", "v1": "pallas_fused_cg",
           "sstep": "pallas_sstep_v3"}


def _mix_operands(case, rng, mix):
    """K4/K5 operands of ``case`` (an fp64 case on the card) in the dtypes
    of one bf16 build: p, r, the factors in S, x in X, D and the metric
    diagonal in O, beta and alpha in A."""
    from repro_torch.kernels import nekbone_ax as K

    dt = K.MIXES[mix]
    o = _v2_operands(case, rng)
    return dict(p=o["p"].to(dt["S"]), r=o["r"].to(dt["S"]),
                x=o["x"].to(dt["X"]), D=case.D.to(dt["O"]),
                g3=o["g3"].to(dt["O"]),
                m=tuple(f.to(dt["S"]) for f in o["m"]),
                c=tuple(f.to(dt["S"]) for f in o["c"]),
                beta=o["beta"].to(dt["A"]), alpha=o["alpha"].to(dt["A"]))


def _k4_unrounded(p2, r2, D, g3, mx, my, mz, beta, *, n):
    """A wrong K4 for the negative check: K4's plain version
    (kernels/ref.nekbone_ax_slab_plain) with the one line that rounds p
    through storage before the operator removed."""
    from repro_torch.core.geom import box_outer
    from repro_torch.kernels.ref import _masked_ax_diag, accum_dtype

    acc = accum_dtype(p2.dtype)
    E = p2.shape[0]
    p = r2.to(acc) + beta.reshape(()).to(acc) * p2.to(acc)
    p4 = p.reshape(E, n, n, n)
    g = g3.to(acc).reshape(E, 3, n, n, n)
    mask = box_outer(mz.to(acc), my.to(acc), mx.to(acc)).reshape(E, n, n, n)
    v = _masked_ax_diag(p4, D.to(acc), g, mask)
    pap = (p4 * v).reshape(E, -1).sum(dim=1)
    return (p.to(p2.dtype).reshape(E, n ** 3),
            v.to(p2.dtype).reshape(E, n ** 3), pap)


def _part_err(a, b) -> float:
    """Summed partials, relative."""
    sa, sb = float(a.double().sum()), float(b.double().sum())
    return abs(sa - sb) / abs(sb)


def phase_bf16_parity():
    """K4, K5 and K3 in their bf16 builds (both operand mixes) against their
    plain versions, on the paper grid and at E=4096; and a K4 that skips
    rounding p through storage, which must fail."""
    import numpy as np
    import torch

    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import nekbone_ax as K

    print("== bf16 K4/K5/K3 parity (kernel vs plain; n=10, E = 1024 and "
          f"4096; builds {', '.join(BF16_MIXES)}; fields value by value: "
          f"|o - p| <= 2^-7 |p| + {BF16_F32_TOL:g} max |p|; partials summed, "
          f"relative, <= {BF16_PART_TOL:g})", flush=True)
    rng = np.random.default_rng(11)
    errs = {}
    n = 10
    for grid in (PAPER_GRID, BIG_GRID):
        case = NekboneCase(n=n, grid=grid, dtype=torch.float64)
        E = case.mesh.nelt
        n3 = n ** 3
        u64, D64, g64 = _operator_data(rng, E, n, torch.float64)
        mask64 = case.mask.reshape(E, n3).contiguous()
        for mix in BF16_MIXES:
            dt = K.MIXES[mix]
            tag = f"{mix} E={E}"
            o = _mix_operands(case, rng, mix)
            k4 = (o["p"], o["r"], o["D"], o["g3"], *o["m"], o["beta"])
            kp, kw, kpap = K.nekbone_ax_slab_cuda(*k4, n=n)
            pp, pw, ppap = K.nekbone_ax_slab_plain(*k4, n=n)
            wval = _value_rel(kw, pw, BF16_F32_TOL)
            perr = _part_err(kpap, ppap)
            check(kp.dtype == kw.dtype == dt["S"] and kpap.dtype == dt["A"]
                  and torch.equal(kp, pp),
                  f"K4 {tag}: p and w in {dt['S']}, pap in {dt['A']}; the "
                  "stored p = r + beta p bitwise the plain version's")
            check(wval <= 1.0 and perr <= BF16_PART_TOL,
                  f"K4 {tag}: w value by value (worst {wval:.2f} of the "
                  f"limit; {int((kw != pw).sum())} of {kw.numel()} values "
                  f"differ), pap rel err {perr:.2e}")
            # K5 on K4's own outputs, both sides
            k5 = (o["x"], kp, o["r"], kw, o["alpha"], *o["c"])
            kx, kr, krcr = K.nekbone_cg_update_cuda(*k5, n=n)
            px, pr, prcr = K.nekbone_cg_update_plain(*k5, n=n)
            xval = _value_rel(kx, px, BF16_F32_TOL)
            rval = _value_rel(kr, pr, BF16_F32_TOL)
            rerr = _part_err(krcr, prcr)
            check(kx.dtype == dt["X"] and kr.dtype == dt["S"]
                  and krcr.dtype == dt["A"] and xval <= 1.0 and rval <= 1.0
                  and rerr <= BF16_PART_TOL,
                  f"K5 {tag}: x in {dt['X']}, r in {dt['S']}, value by value "
                  f"(worst {xval:.2f} and {rval:.2f} of the limit; bitwise: "
                  f"x {torch.equal(kx, px)}, r {torch.equal(kr, pr)}), rcr "
                  f"rel err {rerr:.2e}")
            # K3 on a random SPD metric and the box's mask
            k3 = (u64.to(dt["S"]), D64.to(dt["O"]), g64.to(dt["O"]),
                  mask64.to(dt["S"]))
            kw3, kpap3 = K.nekbone_ax_pap_cuda(*k3, n=n)
            pw3, ppap3 = K.nekbone_ax_pap_plain(*k3, n=n)
            w3val = _value_rel(kw3, pw3, BF16_F32_TOL)
            p3err = _part_err(kpap3, ppap3)
            check(kw3.dtype == dt["S"] and kpap3.dtype == dt["A"]
                  and w3val <= 1.0 and p3err <= BF16_PART_TOL,
                  f"K3 {tag}: w value by value (worst {w3val:.2f} of the "
                  f"limit), pap rel err {p3err:.2e}")
            if grid == PAPER_GRID:
                # the negative check: p unrounded before the operator
                _, bw, _ = _k4_unrounded(*k4, n=n)
                bad = _value_rel(bw, pw, BF16_F32_TOL)
                check(bad > 1.0,
                      f"K4 {tag}: a stand-in that skips rounding p through "
                      f"storage fails the w check ({bad:.1f}x the limit)")
                errs[("K4", mix)] = float((kw.float() - pw.float()).abs()
                                          .max())
                errs[("K5", mix)] = float((kr.float() - pr.float()).abs()
                                          .max())
                errs[("K3", mix)] = float((kw3.float() - pw3.float()).abs()
                                          .max())
            del o, k4, k5, k3, kp, kw, pp, pw, kx, kr, px, pr, kw3, pw3
        del u64, D64, g64, mask64
    torch.cuda.synchronize()
    return errs


def _k1_grad_in_storage(u2, D, g2, *, n):
    """A wrong K1 for the negative check: K1's plain version
    (kernels/ref.nekbone_ax_plain) with the reference-space gradient D u
    rounded to storage before the metric, where the kernel keeps it in A."""
    from repro_torch.core.ax import apply_metric, local_grad3, local_grad3_t
    from repro_torch.kernels.ref import accum_dtype

    acc = accum_dtype(u2.dtype)
    E = u2.shape[0]
    Da = D.to(acc)
    grad = [t.to(u2.dtype).to(acc)
            for t in local_grad3(u2.to(acc).reshape(E, n, n, n), Da)]
    w = local_grad3_t(*apply_metric(
        *grad, g2.to(acc).reshape(E, 6, n, n, n)), Da)
    return w.reshape(E, n ** 3).to(u2.dtype)


def _k2_parts_in_storage(p2, D, g2, mask2, r2, c2, *, n):
    """A wrong K2 for the negative check: K2's plain version with its
    per-element partials stored in the storage dtype S (the wrapper's
    allocation before they moved to A), as the sum then reads them."""
    from repro_torch.kernels.ref import nekbone_ax_dots_plain

    w, pap, rcz = nekbone_ax_dots_plain(p2, D, g2, mask2, r2, c2, n=n)
    return w, pap.to(p2.dtype), rcz.to(p2.dtype)


def phase_bf16_k1_k2_parity():
    """K1 and K2 in their bf16 builds (both operand mixes) against their
    plain versions: n = 2..16 at E = 8 and n = 10 at E = 1024 and 4096
    (random SPD metric, the box's mask and c), fields value by value,
    partials summed, relatively; outputs in their roles' dtypes; at n = 10
    5 repeated calls bitwise the same; and, at E = 1024, a K1 that rounds
    D u to storage and a K2 whose partials are stored in S must fail the
    same checks."""
    import numpy as np
    import torch

    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import nekbone_ax as K

    print("== bf16 K1/K2 parity (kernel vs plain; builds "
          f"{', '.join(BF16_MIXES)}; n = 2..16 at E=8, n=10 at E = 1024 and "
          f"4096; fields value by value: |o - p| <= 2^-7 |p| + "
          f"{BF16_F32_TOL:g} max |p|; partials summed, relative, <= "
          f"{BF16_PART_TOL:g})", flush=True)
    rng = np.random.default_rng(23)
    errs = {}
    cases = [(n, (2, 2, 2)) for n in K.N_RANGE] + [(10, PAPER_GRID),
                                                   (10, BIG_GRID)]
    for n, grid in cases:
        case = NekboneCase(n=n, grid=grid, dtype=torch.float64)
        E = case.mesh.nelt
        n3 = n ** 3
        u64, D64, g64 = _operator_data(rng, E, n, torch.float64)
        r64 = torch.as_tensor(rng.normal(size=(E, n3)), device="cuda")
        # at E = 8 no mask, so that each element's pap = p^T A_loc p >= 0
        # and the sum of 8 does not cancel
        mask64 = (case.mask if E > 8 else torch.ones_like(case.mask)
                  ).reshape(E, n3).contiguous()
        c64 = case.c.reshape(E, n3).contiguous()
        for mix in BF16_MIXES:
            dt = K.MIXES[mix]
            k1 = (u64.to(dt["S"]), D64.to(dt["O"]), g64.to(dt["O"]))
            k2 = k1 + tuple(t.to(dt["S"]) for t in (mask64, r64, c64))
            kw = K.nekbone_ax_cuda(*k1, n=n)
            pw = K.nekbone_ax_plain(*k1, n=n)
            kw2, kpap, krcz = K.nekbone_ax_dots_cuda(*k2, n=n)
            pw2, ppap, prcz = K.nekbone_ax_dots_plain(*k2, n=n)
            v1 = _value_rel(kw, pw, BF16_F32_TOL)
            v2 = _value_rel(kw2, pw2, BF16_F32_TOL)
            perr = max(_part_err(kpap, ppap), _part_err(krcz, prcz))
            roles = (kw.dtype == kw2.dtype == dt["S"]
                     and kpap.dtype == krcz.dtype == dt["A"])
            if E == 8:
                check(roles and v1 <= 1.0 and v2 <= 1.0
                      and perr <= BF16_PART_TOL,
                      f"K1/K2 {mix} n={n} E=8: w in {dt['S']}, partials in "
                      f"{dt['A']}; K1 w {v1:.2f}, K2 w {v2:.2f} of the "
                      f"value limit, partials rel err {perr:.1e}")
                continue
            tag = f"{mix} n={n} E={E}"
            reps = [(K.nekbone_ax_cuda(*k1, n=n),
                     K.nekbone_ax_dots_cuda(*k2, n=n)) for _ in range(5)]
            same = all(torch.equal(a, kw) and all(
                torch.equal(x, y) for x, y in zip(b, (kw2, kpap, krcz)))
                for a, b in reps)
            check(roles and v1 <= 1.0 and same,
                  f"K1 {tag}: w in {dt['S']}, value by value (worst "
                  f"{v1:.2f} of the limit; {int((kw != pw).sum())} of "
                  f"{kw.numel()} values differ); 5 more calls of K1 and K2 "
                  "bitwise the same")
            check(v2 <= 1.0 and perr <= BF16_PART_TOL,
                  f"K2 {tag}: w value by value (worst {v2:.2f} of the "
                  f"limit), pap and rcz in {dt['A']}, rel err "
                  f"{_part_err(kpap, ppap):.2e} and "
                  f"{_part_err(krcz, prcz):.2e}")
            if grid == PAPER_GRID:
                bad = _value_rel(_k1_grad_in_storage(*k1, n=n), pw,
                                 BF16_F32_TOL)
                check(bad > 1.0,
                      f"K1 {tag}: a stand-in that rounds D u to storage "
                      f"before the metric fails the w check ({bad:.1f}x the "
                      "limit)")
                _, bpap, brcz = _k2_parts_in_storage(*k2, n=n)
                bad = max(_part_err(bpap, ppap), _part_err(brcz, prcz))
                check(bad > BF16_PART_TOL,
                      f"K2 {tag}: a stand-in whose partials are stored in "
                      f"{dt['S']} fails the partial check (rel err "
                      f"{bad:.2e}, {bad / BF16_PART_TOL:.1f}x the limit)")
                errs[("K1", mix)] = float((kw.float() - pw.float()).abs()
                                          .max())
                errs[("K2", mix)] = float((kw2.float() - pw2.float()).abs()
                                          .max())
            del k1, k2, kw, pw, kw2, pw2, reps
        del case, u64, D64, g64, r64, mask64, c64
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return errs


# K8 and K9 at these cycle lengths in the bf16 builds
BF16_SSTEP_S = (SSTEP_S, 2, 1)


def _k8_unrounded(p2, r2, D, g3, mx, my, mz, cx, cy, cz, inv_theta, *, n,
                  s):
    """A wrong K8 for the negative check: K8's plain version
    (kernels/ref.nekbone_ax_powers_plain) without the rounding of each
    power through storage before the next application; the stored basis
    is still rounded once.  Returns the basis alone."""
    import torch

    from repro_torch.core.geom import box_outer
    from repro_torch.core.gs import ds_sum_local
    from repro_torch.kernels.ref import _masked_ax_diag, accum_dtype

    acc = accum_dtype(p2.dtype)
    E = p2.shape[0]
    grid = (mx.shape[0], my.shape[0], mz.shape[0])
    g = g3.to(acc).reshape(E, 3, n, n, n)
    mask = box_outer(mz.to(acc), my.to(acc), mx.to(acc)).reshape(E, n, n, n)
    ith = inv_theta.reshape(()).to(acc)

    def chain(v, napps):
        out = []
        for _ in range(napps):
            v = ds_sum_local(_masked_ax_diag(v, D.to(acc), g, mask),
                             grid) * ith
            out.append(v)
        return out

    new = (chain(p2.to(acc).reshape(E, n, n, n), s)
           + chain(r2.to(acc).reshape(E, n, n, n), s - 1))
    return torch.stack(new, dim=1).reshape(E, 2 * s - 1, n ** 3) \
        .to(p2.dtype)


def _k8_power_check(basis, p2, r2, args, *, n, s):
    """K8's stored powers each against one plain application
    (``nekbone_ax_powers_plain`` at s = 1) to the same basis's previous
    stored power (p or r for the first).  Returns, by power (the p
    chain's j = 1..s, then the r chain's j = 1..s-1), the value-by-value
    figure (_value_rel; <= 1 passes), and the largest absolute difference
    over all powers."""
    from repro_torch.kernels import nekbone_ax as K

    figures, worst = [], 0.0
    for chain, start, count in ((0, p2, s), (s, r2, s - 1)):
        prev = start
        for j in range(count):
            got = basis[:, chain + j]
            want = K.nekbone_ax_powers_plain(prev, prev, *args, n=n,
                                             s=1)[0][:, 0]
            figures.append(_value_rel(got, want, BF16_F32_TOL))
            worst = max(worst, float((got.float() - want.float()).abs()
                                     .max()))
            prev = got.contiguous()
    return figures, worst


def phase_bf16_sstep_pcg_parity():
    """K8, K9 and K10 in their bf16 builds (both operand mixes) against
    their plain versions, n = 10 on the paper grid and at E = 4096, K8 and
    K9 at s = 4, 2 and 1.  K8's stored powers are held each against one
    plain application to the kernel's own previous power (one bf16 step of
    difference in power j moves power j + 1 by more than a step, so the
    whole chain against the plain chain would test round-off), its Gram
    partials bitwise ``ref.sstep_gram_emulated`` of f32 upcasts of its own
    p, r and basis; a K8 that skips rounding the powers through storage
    must fail the power check at some power from the second on.  K9's x, r
    and p and K10's x and z are held value by value, their partials
    summed.  K9's and K10's roundings of r and z to storage feed only
    summed partials, which BF16_PART_TOL does not resolve, so they get no
    negative check."""
    import numpy as np
    import torch

    from repro_torch.core.cg_sstep import estimate_theta
    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import nekbone_ax as K
    from repro_torch.kernels import ref

    print("== bf16 K8/K9/K10 parity (kernel vs plain; n=10, E = 1024 and "
          f"4096; builds {', '.join(BF16_MIXES)}; K8/K9 at s = "
          f"{', '.join(map(str, BF16_SSTEP_S))}; fields value by value: "
          f"|o - p| <= 2^-7 |p| + {BF16_F32_TOL:g} max |p|; partials summed, "
          f"relative, <= {BF16_PART_TOL:g})", flush=True)
    rng = np.random.default_rng(21)
    errs = {}
    n = 10
    for grid in (PAPER_GRID, BIG_GRID):
        case = NekboneCase(n=n, grid=grid, dtype=torch.float64)
        E = case.mesh.nelt
        inv_theta = 1.0 / estimate_theta(case.D, case.g, case.grid,
                                         case.mask)
        invd64 = (1.0 / case.operator_diagonal()).reshape(E, n ** 3) \
            .contiguous()
        for mix in BF16_MIXES:
            dt = K.MIXES[mix]
            tag = f"{mix} E={E}"
            o = _mix_operands(case, rng, mix)
            ith = torch.full((1,), inv_theta, dtype=dt["A"], device="cuda")
            k8 = (o["D"], o["g3"], *o["m"], *o["c"], ith)
            for s in BF16_SSTEP_S:
                plan, info = K.nekbone_ax_powers_plan(E, n, s, mix)
                kb, kg = K.nekbone_ax_powers_cuda(o["p"], o["r"], *k8, n=n,
                                                  s=s)
                figs, k8_err = _k8_power_check(kb, o["p"], o["r"], k8,
                                               n=n, s=s)
                em = ref.sstep_gram_emulated(
                    o["p"].float(), o["r"].float(), kb.float(),
                    *(f.float() for f in o["c"]), n=n, s=s)
                check(kb.dtype == dt["S"] and kg.dtype == dt["A"]
                      and max(figs) <= 1.0 and torch.equal(kg, em),
                      f"K8 {tag} s={s} (grid {plan.grid}, "
                      f"{plan.blocks_per_sm} blocks per SM, "
                      f"{plan.smem_bytes} + {info['static_smem']} bytes "
                      f"shared, {info['registers']} registers): basis in "
                      f"{dt['S']}, each power value by value against one "
                      "plain application to the previous stored power "
                      "(worst by power "
                      + " ".join(f"{v:.2f}" for v in figs)
                      + f" of the limit); Gram partials in {dt['A']} "
                      "bitwise ref.sstep_gram_emulated of the kernel's own "
                      "vectors")
                if grid == PAPER_GRID and s == SSTEP_S:
                    bad = _k8_unrounded(o["p"], o["r"], *k8, n=n, s=s)
                    bfigs, _ = _k8_power_check(bad, o["p"], o["r"], k8,
                                               n=n, s=s)
                    later = bfigs[1:s] + bfigs[s + 1:]
                    check(max(later) > 1.0,
                          f"K8 {tag} s={s}: a stand-in that skips rounding "
                          "the powers through storage fails the power check "
                          "from the second power on (worst by power "
                          + " ".join(f"{v:.2f}" for v in bfigs) + ")")
                # K9 on K8's basis, random coefficients in A
                coef = torch.as_tensor(rng.normal(size=(3, 2 * s + 1)),
                                       dtype=dt["A"], device="cuda")
                k9 = (o["x"], o["p"], o["r"], kb, coef, *o["c"])
                kx, kr, kp, krcr = K.nekbone_sstep_update_cuda(*k9, n=n,
                                                               s=s)
                px, pr, pp, prcr = K.nekbone_sstep_update_plain(*k9, n=n,
                                                                s=s)
                vals = [_value_rel(a, b, BF16_F32_TOL)
                        for a, b in ((kx, px), (kr, pr), (kp, pp))]
                rerr = _part_err(krcr, prcr)
                check(kx.dtype == dt["X"] and kr.dtype == kp.dtype == dt["S"]
                      and krcr.dtype == dt["A"] and max(vals) <= 1.0
                      and rerr <= BF16_PART_TOL,
                      f"K9 {tag} s={s}: x in {dt['X']}, r and p in "
                      f"{dt['S']}, value by value (worst "
                      + " ".join(f"{v:.2f}" for v in vals)
                      + f" of the limit; bitwise: x {torch.equal(kx, px)}, "
                      f"r {torch.equal(kr, pr)}, p {torch.equal(kp, pp)}), "
                      f"rcr in {dt['A']} rel err {rerr:.2e}")
                if grid == PAPER_GRID and s == SSTEP_S:
                    errs[("K8", mix)] = k8_err
                    errs[("K9", mix)] = float((kr.float() - pr.float())
                                              .abs().max())
                del kb, kg, em, kx, kr, kp, px, pr, pp
            # K10 on K4's own output, z in K4's residual slot
            z = _v2_operands(case, rng)["p"].to(dt["S"])
            invd = invd64.to(dt["O"])
            kp4, kw4, _ = K.nekbone_ax_slab_cuda(
                o["p"], z, o["D"], o["g3"], *o["m"], o["beta"], n=n)
            k10 = (o["x"], kp4, z, kw4, o["alpha"], invd, *o["c"])
            kx, kz, krtz, krcr = K.nekbone_pcg_update_cuda(*k10, n=n)
            px, pz, prtz, prcr = K.nekbone_pcg_update_plain(*k10, n=n)
            xval = _value_rel(kx, px, BF16_F32_TOL)
            zval = _value_rel(kz, pz, BF16_F32_TOL)
            terr, rerr = _part_err(krtz, prtz), _part_err(krcr, prcr)
            check(kx.dtype == dt["X"] and kz.dtype == dt["S"]
                  and krtz.dtype == krcr.dtype == dt["A"] and xval <= 1.0
                  and zval <= 1.0 and max(terr, rerr) <= BF16_PART_TOL,
                  f"K10 {tag}: x in {dt['X']}, z in {dt['S']}, invd in "
                  f"{dt['O']}, value by value (worst {xval:.2f} and "
                  f"{zval:.2f} of the limit; bitwise: x {torch.equal(kx, px)}"
                  f", z {torch.equal(kz, pz)}), rtz and rcr in {dt['A']} "
                  f"rel err {terr:.2e} and {rerr:.2e}")
            if grid == PAPER_GRID:
                errs[("K10", mix)] = float((kz.float() - pz.float()).abs()
                                           .max())
            del o, k8, kx, kz, px, pz, kp4, kw4
        del invd64
        torch.cuda.empty_cache()
    _k9_edge_parity(BF16_MIXES)
    torch.cuda.synchronize()
    return errs


# ---------------------------------------------------------------------------
# Slice 12: the bf16 builds of K11, K12, K6 and K7
# ---------------------------------------------------------------------------
# K11 and K12 at these degrees, K6 and K7 at these widths, in the bf16 builds
BF16_CHEB_NS = (10, 5, 3)
BF16_BLOCK_BS = (1, 3, BLOCK_B)
# fixed pmg iterations of the bf16 pmg routes (fp64 pmg reaches 1e-8 r0 in
# 13); Chebyshev and block run NITER
BF16_PMG_ITERS = PMG_MAX_ITERS


def _k11_in_storage(r2, D, g3, mx, my, mz, cx, cy, cz, coef, *, n, k):
    """A wrong K11 for the negative check: K11's plain version
    (kernels/ref.nekbone_cheb_apply_plain) with the recurrence's d, res and
    z rounded to storage after every update, as one type for every field
    would keep them (the TPU kernel keeps them in the accumulation type and
    rounds only z, once)."""
    from repro_torch.core.geom import box_outer
    from repro_torch.core.gs import ds_sum_local
    from repro_torch.kernels.ref import _masked_ax_diag, accum_dtype

    acc, st = accum_dtype(r2.dtype), r2.dtype
    E = r2.shape[0]
    grid = (mx.shape[0], my.shape[0], mz.shape[0])
    g = g3.to(acc).reshape(E, 3, n, n, n)
    mask = box_outer(mz.to(acc), my.to(acc), mx.to(acc)).reshape(E, n, n, n)
    coef = coef.to(acc)

    def stored(v):
        return v.to(st).to(acc)

    r = r2.to(acc).reshape(E, n, n, n)
    d = stored(coef[0, 0] * r)
    z = d
    res = r
    for i in range(1, k + 1):
        res = stored(res - ds_sum_local(_masked_ax_diag(d, D.to(acc), g,
                                                        mask), grid))
        d = stored(coef[i, 0] * d + coef[i, 1] * res)
        z = stored(z + d)
    return z.reshape(E, n ** 3).to(st)


def _k12_in_storage(u2, mt, *, nin, nout):
    """A wrong K12 for the negative check: K12's plain version
    (kernels/ref.nekbone_interp_plain) with its two intermediate stages
    rounded to storage, as buffers of the storage type would hold them."""
    import torch

    from repro_torch.kernels.ref import accum_dtype

    acc, st = accum_dtype(u2.dtype), u2.dtype
    E = u2.shape[0]
    m = mt.to(acc)
    u = u2.to(acc).reshape(E, nin, nin, nin)
    v1 = torch.zeros(E, nin, nin, nout, dtype=acc, device=u2.device)
    for l in range(nin):
        v1 = v1 + u[..., l, None] * m[l]
    v1 = v1.to(st).to(acc)
    v2 = torch.zeros(E, nin, nout, nout, dtype=acc, device=u2.device)
    for l in range(nin):
        v2 = v2 + v1[:, :, l, None, :] * m[l, :, None]
    v2 = v2.to(st).to(acc)
    v3 = torch.zeros(E, nout, nout, nout, dtype=acc, device=u2.device)
    for l in range(nin):
        v3 = v3 + v2[:, l, None] * m[l, :, None, None]
    return v3.reshape(E, nout ** 3).to(st)


def _k5_unrounded_rcr(x2, p2, r2, w2, alpha, cx, cy, cz, *, n):
    """A wrong K7 lane for the negative check: K5's plain version
    (kernels/ref.nekbone_cg_update_plain) with r.c.r taken over the
    unrounded residual.  Returns the rcr partials alone."""
    from repro_torch.core.geom import box_outer
    from repro_torch.core.gs import ds_sum_local
    from repro_torch.kernels.ref import accum_dtype

    acc = accum_dtype(r2.dtype)
    E = x2.shape[0]
    grid = (cx.shape[0], cy.shape[0], cz.shape[0])
    w = ds_sum_local(w2.to(acc).reshape(E, n, n, n), grid).reshape(E, -1)
    r = r2.to(acc) - alpha.reshape(()).to(acc) * w
    c = box_outer(cz.to(acc), cy.to(acc), cx.to(acc)).reshape(E, n ** 3)
    return (r * c * r).sum(dim=1)


def _k7_lane_w_in_storage(x2, p2, r2, w2, alpha, cx, cy, cz, *, n):
    """A wrong K7 lane for the negative check: K5's plain version
    (kernels/ref.nekbone_cg_update_plain) with the assembled w rounded to
    storage before the axpy, as an assembly in the storage type would
    leave it.  Returns the stored r alone."""
    from repro_torch.core.gs import ds_sum_local
    from repro_torch.kernels.ref import accum_dtype

    acc = accum_dtype(r2.dtype)
    E = x2.shape[0]
    grid = (cx.shape[0], cy.shape[0], cz.shape[0])
    w = ds_sum_local(w2.to(acc).reshape(E, n, n, n), grid).reshape(E, -1)
    w = w.to(r2.dtype).to(acc)
    return (r2.to(acc) - alpha.reshape(()).to(acc) * w).to(r2.dtype)


def phase_bf16_cheb_pmg_block_parity():
    """K11, K12, K6 and K7 in their bf16 builds (both operand mixes)
    against their plain versions, value by value, with one stand-in of
    each that skips a load-bearing rounding, which must fail the same
    check.  K11 at n = 10, 5, 3 on the paper grid (its shared-memory
    variant) and n = 10 at E = 4096 (its device-memory variant), k = 1 and
    4, its planner's shared bytes those the kernel stages; K12 on every
    step of the n = 10 ladder at E = 1024 (bitwise, as in f64 and f32) and
    every other instantiated pair at E = 9; K6 and K7 at b = 1, 3, 4, n =
    10, 5, 3, every lane bitwise the bf16 K4's and K5's."""
    import numpy as np
    import torch

    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import nekbone_ax as K

    print("== bf16 K11/K12/K6/K7 parity (kernel vs plain; builds "
          f"{', '.join(BF16_MIXES)}; fields value by value: |o - p| <= "
          f"2^-7 |p| + {BF16_F32_TOL:g} max |p|; partials summed, relative, "
          f"<= {BF16_PART_TOL:g})", flush=True)
    rng = np.random.default_rng(41)
    errs = {}
    variants = set()

    def cast(o, mix):
        dt = K.MIXES[mix]
        return dict(S=dt["S"], X=dt["X"], O=dt["O"], A=dt["A"],
                    D=o["D"].to(dt["O"]), g3=o["g3"].to(dt["O"]),
                    m=tuple(f.to(dt["S"]) for f in o["m"]),
                    c=tuple(f.to(dt["S"]) for f in o["c"]))

    # --- K11: both variants -----------------------------------------------
    for n, grid in [(n, PAPER_GRID) for n in BF16_CHEB_NS] + [(10, BIG_GRID)]:
        case = NekboneCase(n=n, grid=grid, dtype=torch.float64)
        E = case.mesh.nelt
        o64 = _pcg_operands(case, rng)
        for mix in BF16_MIXES:
            o = cast(o64, mix)
            tag = f"{mix} n={n} E={E}"
            r = o64["z"].to(o["S"])
            plan, info = K.nekbone_cheb_apply_plan(E, n, mix)
            variants.add(plan.variant)
            # what the kernel stages (nekbone_cheb_apply.cu cheb_dyn_bytes)
            staged = ((plan.per_block * 3 if plan.resident
                       else info["slices"]) * n ** 3 * o["A"].itemsize)
            print(f"  K11 {tag}: {plan.variant}-memory variant, grid "
                  f"{plan.grid} ({info['slices']} elements side by side, "
                  f"{plan.per_block} owned), {plan.blocks_per_sm} blocks per "
                  f"SM, {plan.smem_bytes} bytes dynamic + "
                  f"{info['static_smem']} static shared memory, "
                  f"{info['registers']} registers", flush=True)
            check(plan.smem_bytes == staged
                  and (not plan.resident or plan.smem_bytes == plan.per_block
                       * K.k11_state_bytes(n, o["S"], o["A"])),
                  f"K11 {tag}: the planner's {plan.smem_bytes} shared bytes "
                  f"are the {staged} the kernel stages (its state in "
                  f"{o['A']})")
            if n == 10:
                want = "shared" if grid == PAPER_GRID else "device"
                check(plan.variant == want,
                      f"K11 {tag}: the {want}-memory variant")
            for k in (1, CHEB_K):
                args = (r, o["D"], o["g3"], *o["m"], *o["c"],
                        o64["coef"][k].to(o["A"]))
                kz, krtz = K.nekbone_cheb_apply_cuda(*args, n=n, k=k)
                pz, prtz = K.nekbone_cheb_apply_plain(*args, n=n, k=k)
                zval = _value_rel(kz, pz, BF16_F32_TOL)
                terr = _part_err(krtz, prtz)
                check(kz.dtype == o["S"] and krtz.dtype == o["A"]
                      and zval <= 1.0 and terr <= BF16_PART_TOL,
                      f"K11 {tag} k={k}: z in {o['S']} value by value (worst "
                      f"{zval:.2f} of the limit; {int((kz != pz).sum())} of "
                      f"{kz.numel()} values differ), rtz in {o['A']} rel err "
                      f"{terr:.2e}")
                if n == 10 and k == CHEB_K:
                    reps = [K.nekbone_cheb_apply_cuda(*args, n=n, k=k)
                            for _ in range(5)]
                    check(all(torch.equal(z, kz) and torch.equal(t, krtz)
                              for z, t in reps),
                          f"K11 {tag} k={k}: 5 more calls give bitwise the "
                          "same z and rtz")
                if grid == PAPER_GRID and n == 10 and k == CHEB_K:
                    errs[("K11", mix)] = float((kz.float() - pz.float())
                                               .abs().max())
                    bad = _value_rel(_k11_in_storage(*args, n=n, k=k), pz,
                                     BF16_F32_TOL)
                    check(bad > 1.0,
                          f"K11 {tag} k={k}: a stand-in that keeps the "
                          "recurrence in storage fails the z check "
                          f"({bad:.1f}x the limit)")
            del o, r
        del o64
    check(variants == {"shared", "device"},
          f"K11 bf16: both variants ran ({sorted(variants)})")

    # --- K12: every step of the n = 10 ladder, and the other pairs ---------
    E = PAPER_GRID[0] * PAPER_GRID[1] * PAPER_GRID[2]
    for mix in BF16_MIXES:
        dt = K.MIXES[mix]
        worst = 0.0
        for nin, nout in LADDER_PAIRS:
            u = torch.as_tensor(rng.normal(size=(E, nin ** 3)),
                                device="cuda").to(dt["S"])
            mt = _ladder_matrix(nin, nout, dt["O"])
            v = K.nekbone_interp_cuda(u, mt, nin=nin, nout=nout)
            want = K.nekbone_interp_plain(u, mt, nin=nin, nout=nout)
            val = _value_rel(v, want, BF16_F32_TOL)
            worst = max(worst, val)
            check(v.dtype == dt["S"] and torch.equal(v, want),
                  f"K12 {mix} {nin}->{nout} E={E}: v in {dt['S']} bitwise "
                  f"the plain version (value figure {val:.2f})")
            if (nin, nout) == (10, 5):
                errs[("K12", mix)] = float((v.float() - want.float()).abs()
                                           .max())
                bad = _value_rel(_k12_in_storage(u, mt, nin=nin, nout=nout),
                                 want, BF16_F32_TOL)
                check(bad > 1.0,
                      f"K12 {mix} {nin}->{nout}: a stand-in that keeps its "
                      f"two intermediate stages in storage fails the v check "
                      f"({bad:.1f}x the limit)")
        others = sorted(K.INTERP_PAIRS - set(LADDER_PAIRS))
        failing = []
        for nin, nout in others:
            u = torch.as_tensor(rng.normal(size=(9, nin ** 3)),
                                device="cuda").to(dt["S"])
            mt = _ladder_matrix(nin, nout, dt["O"])
            if not torch.equal(
                    K.nekbone_interp_cuda(u, mt, nin=nin, nout=nout),
                    K.nekbone_interp_plain(u, mt, nin=nin, nout=nout)):
                failing.append((nin, nout))
        check(not failing, f"K12 {mix}: the other {len(others)} instantiated "
                           f"pairs, E=9, bitwise (failing: {failing})")

    # --- K6 / K7: b = 1, 3, 4, every lane bitwise the bf16 K4's / K5's ----
    for n in BF16_CHEB_NS:
        case = NekboneCase(n=n, grid=PAPER_GRID, dtype=torch.float64)
        E = case.mesh.nelt
        for mix in BF16_MIXES:
            dt = K.MIXES[mix]
            for b in BF16_BLOCK_BS:
                lanes = [_mix_operands(case, rng, mix) for _ in range(b)]
                o = lanes[0]
                tag = f"{mix} n={n} E={E} b={b}"
                P = torch.stack([q["p"] for q in lanes])
                R = torch.stack([q["r"] for q in lanes])
                X = torch.stack([q["x"] for q in lanes])
                beta = torch.as_tensor(rng.uniform(0.2, 0.9, size=b),
                                       dtype=dt["A"], device="cuda")
                alpha = torch.as_tensor(rng.uniform(0.2, 0.9, size=b),
                                        dtype=dt["A"], device="cuda")
                k6 = (P, R, o["D"], o["g3"], *o["m"], beta)
                kp, kw, kpap = K.nekbone_ax_slab_block_cuda(*k6, n=n)
                pp, pw, ppap = K.nekbone_ax_slab_block_plain(*k6, n=n)
                wval = _value_rel(kw, pw, BF16_F32_TOL)
                perr = max(_part_err(kpap[j], ppap[j]) for j in range(b))
                check(kp.dtype == kw.dtype == dt["S"]
                      and kpap.dtype == dt["A"] and torch.equal(kp, pp)
                      and wval <= 1.0 and perr <= BF16_PART_TOL,
                      f"K6 {tag}: p bitwise the plain version's, w value by "
                      f"value (worst {wval:.2f} of the limit), pap rel err "
                      f"{perr:.2e}")
                k7 = (X, kp, R, kw, alpha, *o["c"])
                kx, kr, krcr = K.nekbone_cg_update_block_cuda(*k7, n=n)
                px, pr, prcr = K.nekbone_cg_update_block_plain(*k7, n=n)
                xval = _value_rel(kx, px, BF16_F32_TOL)
                rval = _value_rel(kr, pr, BF16_F32_TOL)
                rerr = max(_part_err(krcr[j], prcr[j]) for j in range(b))
                check(kx.dtype == dt["X"] and kr.dtype == dt["S"]
                      and krcr.dtype == dt["A"] and xval <= 1.0
                      and rval <= 1.0 and rerr <= BF16_PART_TOL,
                      f"K7 {tag}: x in {dt['X']}, r in {dt['S']}, value by "
                      f"value (worst {xval:.2f} and {rval:.2f} of the limit; "
                      f"bitwise: x {torch.equal(kx, px)}, r "
                      f"{torch.equal(kr, pr)}), rcr rel err {rerr:.2e}")
                same = True
                for j in range(b):
                    p, w, pap = K.nekbone_ax_slab_cuda(
                        P[j], R[j], o["D"], o["g3"], *o["m"],
                        beta[j:j + 1], n=n)
                    x, r, rcr = K.nekbone_cg_update_cuda(
                        X[j], p, R[j], w, alpha[j:j + 1], *o["c"], n=n)
                    same &= all(torch.equal(a, z) for a, z in (
                        (kp[j], p), (kw[j], w), (kpap[j], pap), (kx[j], x),
                        (kr[j], r), (krcr[j], rcr)))
                check(same, f"K6/K7 {tag}: p, w, pap, x, r, rcr of every "
                            "lane bitwise the bf16 K4's and K5's")
                if n == 10 and b == BLOCK_B:
                    errs[("K6", mix)] = float((kw.float() - pw.float()).abs()
                                              .max())
                    errs[("K7", mix)] = float((kr.float() - pr.float()).abs()
                                              .max())
                    bad6 = min(_value_rel(_k4_unrounded(
                        P[j], R[j], o["D"], o["g3"], *o["m"], beta[j:j + 1],
                        n=n)[1], pw[j], BF16_F32_TOL) for j in range(b))
                    bad7 = min(_value_rel(_k7_lane_w_in_storage(
                        X[j], kp[j], R[j], kw[j], alpha[j:j + 1], *o["c"],
                        n=n), pr[j], BF16_F32_TOL) for j in range(b))
                    rcr_fig = max(_part_err(_k5_unrounded_rcr(
                        X[j], kp[j], R[j], kw[j], alpha[j:j + 1], *o["c"],
                        n=n), prcr[j]) for j in range(b)) / BF16_PART_TOL
                    check(bad6 > 1.0,
                          f"K6 {tag}: a stand-in that skips rounding p "
                          "through storage fails the w check on every lane "
                          f"(least {bad6:.1f}x the limit)")
                    check(bad7 > 1.0,
                          f"K7 {tag}: a stand-in that rounds the assembled w "
                          "to storage fails the r check on every lane "
                          f"(least {bad7:.1f}x the limit)")
                    print(f"  K7 {tag}: r.c.r over the unrounded r (its "
                          "other rounding, which feeds only the partials): "
                          f"{rcr_fig:.2f} of BF16_PART_TOL at most (reported: "
                          "the partial check does not resolve it)",
                          flush=True)
                del lanes, P, R, X, kp, kw, kx, kr, pp, pw, px, pr
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return errs


@contextlib.contextmanager
def _operator_rounded_once(name="_masked_ax_diag"):
    """The plain versions' local operator ``kernels/ref.<name>``
    (``_masked_ax_diag``, in K4, K6 and K11; ``ax_local_fused``, the full
    metric's, in K1) evaluated in f64 and rounded to f32 once: another
    valid f32 evaluation of the same function, the correctly rounded one.
    A route over the plain versions run under it measures how far two
    valid f32 orders of the operator move that route's history."""
    import torch

    from repro_torch.kernels import ref

    saved = getattr(ref, name)

    def once(*fields):
        if fields[0].dtype != torch.float32:
            return saved(*fields)
        return saved(*(t.double() for t in fields)).float()

    setattr(ref, name, once)
    try:
        yield
    finally:
        setattr(ref, name, saved)


@contextlib.contextmanager
def _forbid(targets):
    """While active, every function ``name`` of ``module`` in ``targets``
    (pairs ``(module, names)``) raises: the path run meanwhile on the card
    must not call any of them."""
    def forbidden(*args, **kwargs):
        raise AssertionError("a plain version ran on the card's path")

    saved = [(mod, name, getattr(mod, name))
             for mod, names in targets for name in names]
    for mod, name, _ in saved:
        setattr(mod, name, forbidden)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _forbid_plain_nekbone():
    """The plain versions of the kernels the bf16 reference, Chebyshev, pmg
    and block routes run (K1, K4, K5, K6, K7, K11, K12), where the wrappers
    look them up and in kernels/ref.py."""
    from repro_torch.kernels import nekbone_ax, ref

    names = ("nekbone_ax_plain", "nekbone_ax_slab_plain",
             "nekbone_cg_update_plain",
             "nekbone_ax_slab_block_plain", "nekbone_cg_update_block_plain",
             "nekbone_cheb_apply_plain", "nekbone_interp_plain")
    return _forbid(((nekbone_ax, names), (ref, names)))


def phase_bf16_cheb_pmg_block_routes(hist, v2_solve_ms):
    """bf16 Chebyshev-PCG(4) (K11, K4, K5), pmg-PCG (K11, K12, K4, K5) and
    block CG at b = 4 (K6, K7) on the paper case: ``bf16`` through
    ``case.solve``, ``bf16_ir`` through the drivers (a refined case with a
    preconditioner or b > 1 routes elsewhere, as the reference's does), and
    f32 block CG through ``case.solve`` (K6's and K7's f32 builds), each
    with the launch counters set to 0 just before it and the plain
    versions of its kernels made to raise meanwhile; launches exact; bf16
    and f32 block's lanes each bitwise their own v2 solve in that policy.
    The history is held to the same route over the plain versions on the
    card: entry 0 equal, and entries 0..10 within BF16_HEAD_TOL or, where
    the route itself moves further under another valid f32 order of its
    operator (the plain route again with the operator rounded once,
    :func:`_operator_rounded_once`), within ENVELOPE_FACTOR times that
    spread, as the fp64 routes are held to the plain route's own spread.
    Whether entries 0..10 lie within BF16_HEAD_TOL is reported for each.
    Chebyshev's and pmg's residuals fall by orders of magnitude within
    those entries while they are stored in bf16, so there two valid orders
    part by about 1e-2 (ROADMAP.md queue 3)."""
    import numpy as np
    import torch

    from repro_torch.core import cg_block as cb
    from repro_torch.core import precond as pc
    from repro_torch.core.gs import ds_sum_local
    from repro_torch.core.nekbone import NekboneCase

    v2_last = float(hist["pallas_fused_cg_v2"][NITER])
    print(f"== paper case, bf16 Chebyshev, pmg and block routes and f32 "
          f"block: n=10, E=1024, b in fp64 (bf16 and f32: cast by the "
          f"case), Chebyshev and block "
          f"{NITER} iterations, pmg {BF16_PMG_ITERS}; fp64 v2 for "
          f"comparison: history[{NITER}]={v2_last:.6e}, "
          f"{v2_solve_ms / NITER:.4f} ms/iteration", flush=True)
    out = {"launches": {}, "ms": {}, "hist": {}, "head": {}}
    case = NekboneCase(n=10, grid=PAPER_GRID, dtype=torch.float64)
    u_ex, f = case.manufactured()
    bf16_case = NekboneCase(n=10, grid=PAPER_GRID, dtype=torch.float64,
                            precision="bf16", ax_impl="pallas_fused_cg_v2")
    f16 = bf16_case.manufactured()[1]
    f32_case = NekboneCase(n=10, grid=PAPER_GRID, dtype=torch.float64,
                           precision="f32", ax_impl="pallas_fused_cg_v2")
    rng = np.random.default_rng(9)
    F = torch.stack([f] + [
        ds_sum_local(torch.as_tensor(rng.normal(size=tuple(f.shape)),
                                     dtype=f.dtype, device="cuda"),
                     case.grid) * case.mask for _ in range(BLOCK_B - 1)])
    F16 = F.to(torch.bfloat16)
    F32 = F.to(torch.float32)
    cheb = f"cheb{CHEB_K}"
    spec = {"cheb": case.precond_spec(cheb), "pmg": case.precond_spec("pmg")}
    L1 = len(spec["pmg"].ns) - 1          # smoothed levels
    kw = dict(D=case.D, g=case.g, grid=case.grid, mask=case.mask, c=case.c,
              precision="bf16_ir")
    it_p = BF16_PMG_ITERS
    vc = 2 * L1 * (it_p + 1)              # K11 and K12 calls, and residuals
    want = {
        "cheb": (NITER, _zero_but(nekbone_cheb_apply=NITER + 1,
                                  nekbone_ax_slab=NITER,
                                  nekbone_cg_update=NITER)),
        "pmg": (it_p, _zero_but(nekbone_interp=vc, nekbone_cheb_apply=vc,
                                nekbone_ax_slab=it_p + vc,
                                nekbone_cg_update=it_p + vc)),
        "block": (NITER, _zero_but(nekbone_ax_slab_block=NITER,
                                   nekbone_cg_update_block=NITER)),
    }
    routes = {
        "bf16 cheb": lambda: bf16_case.solve(f16, niter=NITER, precond=cheb),
        "bf16_ir cheb": lambda: pc.pcg_fused_v2_fixed_iters(
            f, niter=NITER, precond=spec["cheb"], **kw),
        "bf16 pmg": lambda: bf16_case.solve(f16, niter=it_p, precond="pmg"),
        "bf16_ir pmg": lambda: pc.pcg_fused_v2_fixed_iters(
            f, niter=it_p, precond=spec["pmg"], **kw),
        "bf16 block": lambda: bf16_case.solve(F16, niter=NITER),
        "bf16_ir block": lambda: cb.cg_block_fixed_iters(F, niter=NITER,
                                                         **kw),
        "f32 block": lambda: f32_case.solve(F32, niter=NITER),
    }
    lane_cases = {"bf16": (bf16_case, F16), "f32": (f32_case, F32)}
    for label, fn in routes.items():
        prec, kind = label.split()
        iters, launches_want = want[kind]
        x_dtype = torch.bfloat16 if prec == "bf16" else torch.float32
        shape = ((BLOCK_B, iters + 1) if kind == "block" else (iters + 1,))
        with _forbid_plain_nekbone():
            res, launches = _launch_run(fn)
        out["launches"][label] = launches
        h = res.history.double().cpu().numpy()
        check(h.shape == shape and bool(np.isfinite(h).all())
              and bool(torch.isfinite(res.x.float()).all())
              and res.x.dtype == x_dtype
              and (kind != "block" or res.pipeline
                   == f"fused_v2_rhs{BLOCK_B}"),
              f"{label}: pipeline {res.pipeline}, x {res.x.dtype}, finite, "
              f"history {h.shape}")
        check(launches == launches_want, f"{label}: launches {launches}")
        with _plain_kernels():
            pres, plaunch = _launch_run(fn)
            with _operator_rounded_once():
                tres, _ = _launch_run(fn)
        ph = pres.history.double().cpu().numpy()
        th = tres.history.double().cpu().numpy()
        check(plaunch == _zero_but(), f"{label} over plain versions: no "
                                      "kernel launched")

        def by_entry(a, b):
            return _rel_dev(a, b)[..., :11].reshape(-1, 11).max(axis=0)

        head, spread = by_entry(h, ph), by_entry(th, ph)
        bar = max(BF16_HEAD_TOL, ENVELOPE_FACTOR * float(spread.max()))
        worst = float(np.abs(np.log(h / ph)).max())
        out["head"][label] = (float(head.max()), float(spread.max()))
        check(np.array_equal(h[..., 0], ph[..., 0])
              and float(head.max()) <= bar,
              f"{label}: history entry 0 equal and entries 0..10 within "
              f"{bar:.3g} of the plain route's ({float(head.max()):.2e}; by "
              "entry " + " ".join(f"{v:.1e}" for v in head) + "); the plain "
              f"route under another valid f32 order of its operator moves by "
              f"{float(spread.max()):.2e} (by entry "
              + " ".join(f"{v:.1e}" for v in spread) + "); within "
              f"{BF16_HEAD_TOL:g}: {'yes' if head.max() <= BF16_HEAD_TOL else 'NO'}"
              f" (reported); all {iters + 1} within {np.exp(worst):.2f}x "
              "(reported)")
        if kind == "block" and prec in lane_cases:
            lane_case, FL = lane_cases[prec]
            same = [torch.equal(res.history[j], lane_case.solve(
                FL[j], niter=NITER).history) for j in range(BLOCK_B)]
            check(all(same), f"{label}: every lane's history bitwise its own "
                             f"{prec} v2 solve ({same})")
        ms = wall_ms(fn, reps=3)
        out["ms"][label] = ms
        out["hist"][label] = h
        lane0 = h[0] if kind == "block" else h
        x0 = res.x[0] if kind == "block" else res.x
        err = float(case.solution_error(x0.to(torch.float64), u_ex))
        print(f"  {label}: history[0, 10, {iters}] "
              + " ".join(f"{v:.6e}" for v in lane0[[0, 10, iters]])
              + f" (plain route {ph.reshape(-1, iters + 1)[0, iters]:.6e}); "
              f"last / fp64 v2's history[{NITER}] {lane0[-1] / v2_last:.3e}; "
              f"solution_error {err:.6e}; {ms:.3f} ms to completion, "
              f"{ms / iters:.4f} ms per iteration; launches "
              f"{({k: v for k, v in launches.items() if v})}", flush=True)
    out["block_case"] = (bf16_case, F16)
    return out


def phase_bf16_slice12_times(bw_copy, rows):
    """Device time of K11 (k = 4), K12 (every step of the n = 10 ladder),
    K6 and K7 (b = 4) in both bf16 builds, and of K6 and K7 in f32, beside
    their plain versions (K12 also beside one ``torch.einsum``) at E = 1024
    and 4096."""
    import numpy as np
    import torch

    from repro_torch.core import cost
    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import nekbone_ax as K

    print("== times of the bf16 K11, K12, K6 and K7 (builds "
          f"{', '.join(BF16_MIXES)}; K6 and K7 also f32; n=10, K11 at "
          f"k={CHEB_K}, "
          "K6 and K7 at "
          f"b={BLOCK_B}; device time per call, CUDA events around 20 queued "
          "calls, median of 5; operations at the fp32 rate, 67 TF/s)",
          flush=True)
    rng = np.random.default_rng(43)
    n = 10
    for grid in (PAPER_GRID, BIG_GRID):
        case = NekboneCase(n=n, grid=grid, dtype=torch.float64)
        E = case.mesh.nelt
        nodes = E * n ** 3
        q = _pcg_operands(case, rng)
        for mix in ("f32",) + BF16_MIXES:
            dt = K.MIXES[mix]
            S, X, O = (dt[r].itemsize for r in "SXO")
            D, g3 = q["D"].to(dt["O"]), q["g3"].to(dt["O"])
            m = tuple(f.to(dt["S"]) for f in q["m"])
            c = tuple(f.to(dt["S"]) for f in q["c"])
            k11 = (q["z"].to(dt["S"]), D, g3, *m, *c,
                   q["coef"][CHEB_K].to(dt["A"]))
            lanes = [_mix_operands(case, rng, mix) for _ in range(BLOCK_B)]
            P, R, Xs = (torch.stack([o[key] for o in lanes])
                        for key in ("p", "r", "x"))
            beta = torch.full((BLOCK_B,), 0.37, dtype=dt["A"], device="cuda")
            alpha = torch.full((BLOCK_B,), 0.81, dtype=dt["A"],
                               device="cuda")
            k6 = (P, R, D, g3, *m, beta)
            p3, w3, _ = K.nekbone_ax_slab_block_cuda(*k6, n=n)
            k7 = (Xs, p3, R, w3, alpha, *c)
            # bytes per node: K11 r, 3 metric diagonals in, z out; K6 per
            # lane p_prev, r in, p, w out and the metric once; K7 per lane
            # x in and out, p, r, w in, r out.  Flops as for fp64.
            work = {
                "K11": (K.nekbone_cheb_apply_cuda, K.nekbone_cheb_apply_plain,
                        k11, dict(n=n, k=CHEB_K), 2 * S + 3 * O,
                        cost.cheb_apply_flops(n, CHEB_K)),
                "K6": (K.nekbone_ax_slab_block_cuda,
                       K.nekbone_ax_slab_block_plain, k6, dict(n=n),
                       4 * BLOCK_B * S + 3 * O,
                       (BLOCK_B * 12 * n, BLOCK_B * 10)),
                "K7": (K.nekbone_cg_update_block_cuda,
                       K.nekbone_cg_update_block_plain, k7, dict(n=n),
                       BLOCK_B * (2 * X + 4 * S), (0, BLOCK_B * 8)),
            }
            if mix == "f32":    # K6 and K7: K11's f32 row is fp64's
                work = {"K6": work["K6"], "K7": work["K7"]}
            for name, (kern, plain, args, kw_, per_node, (fm, fr)) in \
                    work.items():
                rows[(f"{name} {mix}", grid)] = _time_row(
                    f"{name} {mix} E={E} ({per_node:.4g} B/node)",
                    lambda: kern(*args, **kw_), lambda: plain(*args, **kw_),
                    per_node * nodes, nodes * fm, nodes * fr, bw_copy,
                    mma_peak=FP32_PEAK, rest_peak=FP32_PEAK)
            for nin, nout in LADDER_PAIRS if mix != "f32" else ():
                u2 = torch.as_tensor(rng.normal(size=(E, nin ** 3)),
                                     device="cuda").to(dt["S"])
                mt = _ladder_matrix(nin, nout, dt["O"])
                u32, mt32 = u2.float(), mt.float()
                row = _time_row(
                    f"K12 {mix} {nin}->{nout} E={E} (library: torch.einsum "
                    "in f32 on the upcast operands)",
                    lambda: K.nekbone_interp_cuda(u2, mt, nin=nin, nout=nout),
                    lambda: K.nekbone_interp_plain(u2, mt, nin=nin,
                                                   nout=nout),
                    E * (nin ** 3 + nout ** 3) * S,
                    2 * E * (nin * nin * nout + nin * nout * nout + nout ** 3),
                    0, bw_copy,
                    lib=lambda: torch.einsum(
                        "ekji,ia,jb,kc->ecba", u32.view(E, nin, nin, nin),
                        mt32, mt32, mt32),
                    mma_peak=FP32_PEAK, rest_peak=FP32_PEAK)
                rows[(f"K12 {mix} {nin}->{nout}", grid)] = row
                if (nin, nout) == (10, 5):
                    rows[(f"K12 {mix}", grid)] = row
            del k11, k6, k7, lanes, P, R, Xs, p3, w3, work
        del q
        torch.cuda.empty_cache()


# K4, K3 and K2 (the persistent walkers): the grids their plans run on, both
# copy paths (bulk at n = 10, cp.async at n = 5 and 3), and an element count
# that no block count divides
WALK_CASES = ((10, PAPER_GRID), (5, PAPER_GRID), (3, PAPER_GRID),
              (10, BIG_GRID), (5, BIG_GRID), (3, BIG_GRID),
              (10, (3, 3, 5)), (5, (3, 3, 5)), (3, (3, 3, 5)))
WALK_MIXES = ("f64", "f32") + BF16_MIXES
# per-element partials, summed, relative: f64 and f32 as phase_v2_parity
WALK_TOL = {"f64": 1e-12, "f32": 1e-5, "bf16": BF16_PART_TOL,
            "bf16_ir": BF16_PART_TOL}


def _walk_field_ok(k, p, mix):
    """A field of a walker against its plain version: relative (f64, f32)
    or value by value (bf16 storage), and the figure printed."""
    if mix in BF16_MIXES:
        v = _value_rel(k, p, BF16_F32_TOL)
        return v <= 1.0, f"value by value {v:.2f} of the limit"
    v = rel_err(k, p)
    return v <= WALK_TOL[mix], f"max rel err {v:.2e}"


def phase_walk_parity():
    """K4, K3, K2, K5 and K7, the persistent walkers: their launch plans at
    E = 1024 and 4096 in every build (with registers and spills; K7 at b =
    4), and every build against its plain version on WALK_CASES, 5 repeated
    calls bitwise the same, K7's lanes (b = 3, lane-major items) each
    bitwise K5's."""
    import numpy as np
    import torch

    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import _build
    from repro_torch.kernels import nekbone_ax as K

    print("== K4/K3/K2/K5/K7/K10 walkers: launch plans (n = 10) and parity "
          "in every build (n = 10, 5, 3 on the paper grid, the 16x16x16 grid "
          "and 3x3x5; fields relative in f64 and f32 (K10's bitwise), value "
          "by value in bf16; partials summed, relative)", flush=True)
    logs = {name: _ptxas_report(path.with_suffix(".log").read_text())
            for name, path in _build.build_all().items()}
    walkers = (("K4", "nekbone_ax_slab", "nekbone_ax_slab",
                "nekbone_ax_slab_kernel<10>"),
               ("K3", "nekbone_ax_pap", "nekbone_ax_dots",
                "nekbone_ax_dots_kernel<10,0>"),
               ("K2", "nekbone_ax_dots", "nekbone_ax_dots",
                "nekbone_ax_dots_kernel<10,1>"),
               ("K5", "nekbone_cg_update", "nekbone_cg_update",
                "nekbone_cg_update_kernel<10>"),
               ("K7", "nekbone_cg_update_block", "nekbone_cg_update_block",
                "nekbone_cg_update_block_kernel<10>"),
               ("K10", "nekbone_pcg_update", "nekbone_pcg_update",
                "nekbone_pcg_update_kernel<10>"))
    for key, stem, lib, kernel in walkers:
        lanes = dict(b=BLOCK_B) if key == "K7" else {}
        for mix in WALK_MIXES:
            regs, spill = logs[f"{lib}_{mix}"][kernel]
            for E in (1024, 4096):
                plan, info = K.walk_launch_info(stem, E, 10, mix, **lanes)
                check(plan.grid <= info["sm_count"] * plan.blocks_per_sm
                      and plan.bulk and plan.stages >= 2,
                      f"{key} {mix} E={E}"
                      + (f" b={BLOCK_B}" if lanes else "")
                      + f" plan: grid {plan.grid} "
                      f"({plan.per_block} {'items' if lanes else 'elements'}"
                      " a block, one wave at "
                      f"{plan.blocks_per_sm} blocks an SM on "
                      f"{info['sm_count']} SMs), {plan.stages} stages of "
                      f"{', '.join(plan.staged)} by {plan.copy}, "
                      f"{plan.smem_bytes} bytes dynamic + "
                      f"{info['static_smem']} static shared, {regs} "
                      f"registers ({info['registers']} by the runtime), "
                      f"{spill} bytes spilled")
    rng = np.random.default_rng(20)
    errs = {}
    for n, grid in WALK_CASES:
        case = NekboneCase(n=n, grid=grid, dtype=torch.float64)
        E = case.mesh.nelt
        n3 = n ** 3
        u64, D64, g64 = _operator_data(rng, E, n, torch.float64)
        mask64 = case.mask.reshape(E, n3).contiguous()
        c64 = case.c.reshape(E, n3).contiguous()
        invd64 = (1.0 / case.operator_diagonal()).reshape(E, n3)
        for mix in WALK_MIXES:
            dt = K.MIXES[mix]
            tag = f"{mix} n={n} E={E}"
            plan4, _ = K.walk_launch_info("nekbone_ax_slab", E, n, mix)
            plan3, _ = K.walk_launch_info("nekbone_ax_pap", E, n, mix)
            o = _mix_operands(case, rng, mix)
            k4 = (o["p"], o["r"], o["D"], o["g3"], *o["m"], o["beta"])
            kp, kw, kpap = K.nekbone_ax_slab_cuda(*k4, n=n)
            pp, pw, ppap = K.nekbone_ax_slab_plain(*k4, n=n)
            wok, wtxt = _walk_field_ok(kw, pw, mix)
            perr = _part_err(kpap, ppap)
            reps = [K.nekbone_ax_slab_cuda(*k4, n=n) for _ in range(5)]
            same = all(torch.equal(a, b) for rep in reps
                       for a, b in zip(rep, (kp, kw, kpap)))
            check(torch.equal(kp, pp) and wok and perr <= WALK_TOL[mix]
                  and same and plan4.bulk == (n % 2 == 0),
                  f"K4 {tag} ({plan4.copy}, grid {plan4.grid} x "
                  f"{plan4.per_block}, {', '.join(plan4.staged)} staged): p "
                  f"bitwise, w {wtxt}, pap rel err {perr:.2e}; 5 more calls "
                  "bitwise the same")
            k3 = (u64.to(dt["S"]), D64.to(dt["O"]), g64.to(dt["O"]),
                  mask64.to(dt["S"]))
            kw3, kpap3 = K.nekbone_ax_pap_cuda(*k3, n=n)
            pw3, ppap3 = K.nekbone_ax_pap_plain(*k3, n=n)
            wok3, wtxt3 = _walk_field_ok(kw3, pw3, mix)
            perr3 = _part_err(kpap3, ppap3)
            reps = [K.nekbone_ax_pap_cuda(*k3, n=n) for _ in range(5)]
            same3 = all(torch.equal(a, b) for rep in reps
                        for a, b in zip(rep, (kw3, kpap3)))
            check(wok3 and perr3 <= WALK_TOL[mix] and same3
                  and plan3.bulk == (n % 2 == 0),
                  f"K3 {tag} ({plan3.copy}, grid {plan3.grid} x "
                  f"{plan3.per_block}, {', '.join(plan3.staged)} staged): w "
                  f"{wtxt3}, pap rel err {perr3:.2e}; 5 more calls bitwise "
                  "the same")
            r = torch.as_tensor(rng.normal(size=(E, n3)), dtype=dt["S"],
                                device="cuda")
            k2 = k3 + (r, c64.to(dt["S"]))
            kw2, kpap2, krcz = K.nekbone_ax_dots_cuda(*k2, n=n)
            _, _, prcz = K.nekbone_ax_dots_plain(*k2, n=n)
            rerr = _part_err(krcz, prcz)
            check(torch.equal(kw2, kw3) and torch.equal(kpap2, kpap3)
                  and rerr <= WALK_TOL[mix],
                  f"K2 {tag}: w and pap bitwise K3's, rcz rel err "
                  f"{rerr:.2e}")
            # K5 on K4's outputs; K7 over three lanes of other operands
            k5 = (o["x"], kp, o["r"], kw, o["alpha"], *o["c"])
            kx, kr, krcr = K.nekbone_cg_update_cuda(*k5, n=n)
            px, pr, prcr = K.nekbone_cg_update_plain(*k5, n=n)
            xok, xtxt = _walk_field_ok(kx, px, mix)
            rok, rtxt = _walk_field_ok(kr, pr, mix)
            cerr = _part_err(krcr, prcr)
            reps = [K.nekbone_cg_update_cuda(*k5, n=n) for _ in range(5)]
            same5 = all(torch.equal(a, b) for rep in reps
                        for a, b in zip(rep, (kx, kr, krcr)))
            plan5, _ = K.walk_launch_info("nekbone_cg_update", E, n, mix)
            check(xok and rok and cerr <= WALK_TOL[mix] and same5
                  and plan5.bulk == (n % 2 == 0),
                  f"K5 {tag} ({plan5.copy}, grid {plan5.grid} x "
                  f"{plan5.per_block}, {', '.join(plan5.staged)} staged): x "
                  f"{xtxt}, r {rtxt}, rcr rel err {cerr:.2e}; 5 more calls "
                  "bitwise the same")
            # K10 on K4's outputs, z in K4's residual slot
            k10 = (o["x"], kp, o["r"], kw, o["alpha"], invd64.to(dt["O"]),
                   *o["c"])
            _k10_walk_check(k10, n, E, mix, tag,
                            misaligned=n == 10 and grid == PAPER_GRID)
            X3 = torch.stack([o["x"], -o["x"], o["x"]])
            P3 = torch.stack([kp, o["r"], o["p"]])
            R3 = torch.stack([o["r"], kp, o["p"]])
            W3 = torch.stack([kw, kp, o["r"]])
            al3 = torch.as_tensor(rng.normal(size=3), dtype=dt["A"],
                                  device="cuda")
            k7 = (X3, P3, R3, W3, al3, *o["c"])
            x3, r3, rcr3 = K.nekbone_cg_update_block_cuda(*k7, n=n)
            lanes_ok = all(
                all(torch.equal(a, b) for a, b in zip(
                    (x3[j], r3[j], rcr3[j]), K.nekbone_cg_update_cuda(
                        X3[j], P3[j], R3[j], W3[j], al3[j:j + 1], *o["c"],
                        n=n)))
                for j in range(3))
            plan7, _ = K.walk_launch_info("nekbone_cg_update_block", E, n,
                                          mix, b=3)
            check(lanes_ok, f"K7 {tag} b=3 (grid {plan7.grid} x "
                            f"{plan7.per_block} items, lane-major): x, r, rcr "
                            "of every lane bitwise K5's")
            if n == 10 and grid == PAPER_GRID and mix == "f32":
                errs[("K4", mix)] = float((kw - pw).abs().max())
                errs[("K3", mix)] = float((kw3 - pw3).abs().max())
                errs[("K5", mix)] = float((kr - pr).abs().max())
                _, pr3, _ = K.nekbone_cg_update_block_plain(*k7, n=n)
                errs[("K7", mix)] = float((r3 - pr3).abs().max())
            del o, k4, k3, kp, kw, pp, pw, kw3, pw3, reps, k5, k7, X3, P3, \
                R3, W3
        del case, u64, D64, g64, mask64, c64, invd64
        torch.cuda.empty_cache()
    _k12_walk_parity(logs)
    torch.cuda.synchronize()
    return errs


def _k10_walk_check(k10, n, E, mix, tag, *, misaligned):
    """K10's walker against its plain version (x and z bitwise in f64 and
    f32, value by value in bf16; rtz and rcr summed, relative), 5 repeated
    calls bitwise the same; with ``misaligned`` also every operand 1 value
    off its allocation's start (the cp.async path), bitwise the aligned
    call's."""
    import torch

    from repro_torch.kernels import nekbone_ax as K

    got = K.nekbone_pcg_update_cuda(*k10, n=n)
    want = K.nekbone_pcg_update_plain(*k10, n=n)
    if mix in BF16_MIXES:
        fields = [_walk_field_ok(a, b, mix) for a, b in zip(got, want[:2])]
    else:
        fields = [(torch.equal(a, b), "bitwise" if torch.equal(a, b)
                   else f"NOT bitwise ({rel_err(a, b):.2e})")
                  for a, b in zip(got, want[:2])]
    perr = [_part_err(a, b) for a, b in zip(got[2:], want[2:])]
    reps = [K.nekbone_pcg_update_cuda(*k10, n=n) for _ in range(5)]
    same = all(torch.equal(a, b) for rep in reps for a, b in zip(rep, got))
    plan, _ = K.walk_launch_info("nekbone_pcg_update", E, n, mix)
    check(all(ok for ok, _ in fields) and max(perr) <= WALK_TOL[mix]
          and same and plan.bulk == (n % 2 == 0),
          f"K10 {tag} ({plan.copy}, grid {plan.grid} x {plan.per_block}, "
          f"{', '.join(plan.staged)} staged): x {fields[0][1]}, z "
          f"{fields[1][1]}, rtz rel err {perr[0]:.2e}, rcr {perr[1]:.2e}; 5 "
          "more calls bitwise the same")
    if misaligned:
        moved = [_off_start(t) for t in k10[:4]] + [k10[4],
                                                    _off_start(k10[5])]
        plan = K._walk_launch_plan("nekbone_pcg_update", K.k10_plan, E, n,
                                   mix, moved[0].device,
                                   (*moved[:4], moved[5]), any_head=True)
        off = K.nekbone_pcg_update_cuda(*moved, *k10[6:], n=n)
        check(not plan.bulk and all(torch.equal(a, b)
                                    for a, b in zip(off, got)),
              f"K10 {tag}, x, p, z, w and invd 1 value off their "
              f"allocations' start ({plan.copy}, "
              f"{', '.join(plan.staged)} staged): x, z, rtz, rcr bitwise "
              "the aligned call's")


def _off_start(t):
    """``t`` copied into a view one value past its allocation's start (off
    16-byte alignment: a walker's cp.async path)."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


# K12's element counts: one element, a few, and the paper's E = 1024 and
# 4096
K12_WALK_ES = (1, 7, 1024, 4096)


def _k12_walk_parity(logs):
    """K12's walker in every build: its plans on the paper case's ladder
    (10 -> 5 -> 3 -> 2 and back) at E = 1024 and 4096 (group, grid,
    threads, copy path, shared memory, registers and spills); v bitwise
    its plain version at every ladder pair n = 3..16 and every E of
    K12_WALK_ES; on the paper case's ladder at E = 1024, 5 repeated calls
    bitwise the same and u 1 value off its allocation's start (the cp.async
    path) bitwise the aligned call's."""
    import torch

    from repro_torch.kernels import nekbone_ax as K

    print(f"  K12 walker: plans on the paper ladder and every build at "
          f"every ladder pair over E = {K12_WALK_ES}, bitwise", flush=True)
    gen = torch.Generator("cuda").manual_seed(26)
    pairs = sorted(K.INTERP_PAIRS)
    for mix in WALK_MIXES:
        dt = K.MIXES[mix]
        for E in (1024, 4096):
            for nin, nout in LADDER_PAIRS:
                plan, info = K.nekbone_interp_plan(E, nin, nout, mix)
                regs, spill = logs[f"nekbone_interp_{mix}"][
                    f"nekbone_interp_kernel<{nin},{nout}>"]
                check(plan.grid <= info["sm_count"] * plan.blocks_per_sm
                      and plan.bulk and spill == 0,
                      f"K12 {mix} {nin}->{nout} E={E} plan: G={plan.group}, "
                      f"grid {plan.grid} ({plan.per_block} groups a block, "
                      f"one wave at {plan.blocks_per_sm} blocks an SM on "
                      f"{info['sm_count']} SMs), {plan.threads} threads, "
                      f"{K.K12_STAGES} stage by {plan.copy}, "
                      f"{plan.smem_bytes} bytes dynamic + "
                      f"{info['static_smem']} static shared, {regs} "
                      f"registers ({info['registers']} by the runtime), "
                      f"{spill} bytes spilled")
        bad, paths = [], set()
        for nin, nout in pairs:
            mt = _ladder_matrix(nin, nout, torch.float64).to(dt["O"])
            for E in K12_WALK_ES:
                u = torch.randn(E, nin ** 3, generator=gen,
                                dtype=torch.float64, device="cuda") \
                    .to(dt["S"])
                v = K.nekbone_interp_cuda(u, mt, nin=nin, nout=nout)
                paths.add(K.nekbone_interp_plan(E, nin, nout, mix)[0].copy)
                if not torch.equal(v, K.nekbone_interp_plain(
                        u, mt, nin=nin, nout=nout)):
                    bad.append((nin, nout, E))
                if E == 1024 and (nin, nout) in LADDER_PAIRS:
                    reps = [K.nekbone_interp_cuda(u, mt, nin=nin, nout=nout)
                            for _ in range(5)]
                    uo = _off_start(u)
                    plan, _ = K.nekbone_interp_plan(E, nin, nout, mix,
                                                    aligned=False)
                    if (not all(torch.equal(r, v) for r in reps)
                            or plan.bulk or not torch.equal(
                                K.nekbone_interp_cuda(uo, mt, nin=nin,
                                                      nout=nout), v)):
                        bad.append((nin, nout, E, "repeats or misaligned"))
                del u, v
        check(not bad,
              f"K12 {mix}: v bitwise the plain version at all "
              f"{len(pairs)} ladder pairs, E = {K12_WALK_ES} (copy paths "
              f"{sorted(paths)}); on the paper ladder at E=1024, 5 more "
              "calls bitwise the same and u 1 value off its allocation's "
              "start (cp.async) bitwise the aligned call"
              + (f"; FAILED {bad}" if bad else ""))


@contextlib.contextmanager
def _plain_kernels():
    """The kernel wrappers of the ir and bf16 routes (K1, K3 to K12)
    replaced by their plain versions, which run on the card's tensors: the
    same route over plain versions."""
    from repro_torch.kernels import nekbone_ax as K

    names = ("nekbone_ax", "nekbone_ax_slab", "nekbone_cg_update",
             "nekbone_ax_pap", "nekbone_ax_powers", "nekbone_sstep_update",
             "nekbone_pcg_update", "nekbone_cheb_apply", "nekbone_interp",
             "nekbone_ax_slab_block", "nekbone_cg_update_block")
    saved = {name: getattr(K, f"{name}_cuda") for name in names}
    try:
        for name in names:
            setattr(K, f"{name}_cuda", getattr(K, f"{name}_plain"))
        yield
    finally:
        for name, fn in saved.items():
            setattr(K, f"{name}_cuda", fn)


def _ir_launches(prec, variant):
    """The launches one solve of NITER iterations per sweep must make."""
    sweeps = {"f32_ir": 2, "bf16_ir": 5, "bf16": 1}[prec]
    inner = sweeps * NITER
    k1 = sweeps if prec != "bf16" else 0
    if variant == "v2":
        return sweeps, _zero_but(nekbone_ax=k1, nekbone_ax_slab=inner,
                                 nekbone_cg_update=inner)
    if variant == "v1":
        return sweeps, _zero_but(nekbone_ax=k1, nekbone_ax_pap=inner)
    cycles = sweeps * -(-NITER // SSTEP_S)
    return sweeps, _zero_but(nekbone_ax=k1, nekbone_ax_powers=cycles,
                             nekbone_sstep_update=cycles)


def phase_ir_routes(hist, v2_solve_ms):
    """The ir route (f32_ir and bf16_ir over v2, v1 and s-step) and the
    non-refined bf16 policy (v2, v1, s-step) on the paper case, through
    ``case.solve``, and bf16 Jacobi-PCG (``bf16`` through ``case.solve``,
    ``bf16_ir`` through ``precond.pcg_fused_v2_fixed_iters``, where a
    refined policy runs as its storage policy), each with the launch
    counters set to 0 just before it, against the same route over the plain
    versions on the card; then bf16 on ``reference`` (reference CG over
    K1's bf16 build) with the plain versions made to raise meanwhile,
    launches exact, against the same route over the plain versions: entry
    0 equal and entries 0..10 within BF16_HEAD_TOL or, where the plain
    route itself moves further under another valid f32 order of its
    operator (:func:`_operator_rounded_once` on ``ax_local_fused``), within
    ENVELOPE_FACTOR times that spread, as the bf16 Chebyshev, pmg and block
    routes are held."""
    import numpy as np
    import torch

    from repro_torch.core import precond as pc
    from repro_torch.core.nekbone import NekboneCase

    v2_last = float(hist["pallas_fused_cg_v2"][NITER])
    print(f"== paper case, ir and bf16 routes: n=10, E=1024, b in fp64, "
          f"{NITER} inner iterations per sweep; fp64 v2 for comparison: "
          f"history[{NITER}]={v2_last:.6e}, {v2_solve_ms:.3f} ms "
          f"({v2_solve_ms / NITER:.4f} ms/iteration)", flush=True)
    out = {"launches": {}, "ms": {}, "hist": {}, "cases": {}}
    for prec, variant in IR_ROUTES:
        label = f"{prec} {variant}"
        case = NekboneCase(n=10, grid=PAPER_GRID, dtype=torch.float64,
                           precision=prec, ax_impl=IR_IMPL[variant],
                           s=SSTEP_S)
        u_ex, f = case.manufactured()
        sweeps, want = _ir_launches(prec, variant)
        refined = prec != "bf16"
        res, launches = _launch_run(lambda: case.solve(f, niter=NITER))
        out["launches"][label] = launches
        h = res.history.double().cpu().numpy()
        want_len = sweeps + 1 if refined else NITER + 1
        check(res.pipeline == ("ir" if refined else
                               {"v2": "fused_v2", "v1": "fused_v1",
                                "sstep": "sstep_v3"}[variant])
              and h.shape == (want_len,) and bool(np.isfinite(h).all())
              and bool(torch.isfinite(res.x).all())
              and res.x.dtype == (torch.float64 if refined
                                  else torch.bfloat16),
              f"{label}: pipeline {res.pipeline}, x {res.x.dtype}, finite, "
              f"history of {h.size}")
        check(launches == want, f"{label}: launches {launches}")
        with _plain_kernels():
            pres, plaunch = _launch_run(lambda: case.solve(f, niter=NITER))
        ph = pres.history.double().cpu().numpy()
        check(plaunch == _zero_but(), f"{label} over plain versions: no "
                                      "kernel launched")
        if refined:
            dev = np.abs(np.log(h / ph))
            check(h[0] == ph[0] and bool(np.all(
                      dev[1:] <= np.arange(1, h.size)
                      * np.log(IR_SWEEP_FACTOR))),
                  f"{label}: history[0] equal to the plain route's, entry k "
                  f"within {IR_SWEEP_FACTOR:g}^k of it (ratios "
                  + " ".join(f"{v:.2f}" for v in h / ph) + "; plain route "
                  + " ".join(f"{v:.3e}" for v in ph) + ")")
        else:
            # s-step: the first cycle's entries (0..s, the Gram's quadratic
            # forms, entry 0 too: f32 partials summed in another order);
            # two valid f32 orders of the Gram fork after it
            head = SSTEP_S + 1 if variant == "sstep" else 11
            dev = _rel_dev(h, ph)
            worst = float(np.abs(np.log(h / ph)).max())
            first = (dev[0] <= BF16_PART_TOL if variant == "sstep"
                     else h[0] == ph[0])
            check(first and float(dev[:head].max()) <= BF16_HEAD_TOL,
                  f"{label}: history entry 0 "
                  + (f"within {BF16_PART_TOL:g} ({dev[0]:.2e})"
                     if variant == "sstep" else "equal")
                  + f" and entries 0..{head - 1} within "
                  f"{BF16_HEAD_TOL:g} of the plain route's "
                  f"({float(dev[:head].max()):.2e}); entries 0..10 within "
                  f"{float(dev[:11].max()):.2e}, all {NITER + 1} within "
                  f"{np.exp(worst):.2f}x (reported)")
        ms = wall_ms(lambda: case.solve(f, niter=NITER), reps=3)
        out["ms"][label] = ms
        out["hist"][label] = h
        out["cases"][label] = (case, f)
        shown = h if refined else h[[0, 10, 50, NITER]]
        what = "outer history" if refined else "history[0, 10, 50, 100]"
        print(f"  {label}: {what} " + " ".join(f"{v:.6e}" for v in shown)
              + f"; last / fp64 v2's history[{NITER}] {h[-1] / v2_last:.3e}; "
              f"solution_error {float(case.solution_error(res.x, u_ex)):.6e}; "
              f"{ms:.3f} ms to completion, {ms / (sweeps * NITER):.4f} ms per "
              f"inner iteration (fp64 v2 {v2_solve_ms / NITER:.4f}); "
              f"launches {({k: v for k, v in launches.items() if v})}",
              flush=True)
        if prec == "f32_ir" and variant != "sstep":
            check(h[-1] <= v2_last,
                  f"{label}: last outer rnorm {h[-1]:.6e} reaches fp64 v2's "
                  f"{NITER}-iteration {v2_last:.6e}")
        elif prec == "f32_ir":
            # f32 s-step (a monomial basis of 4 powers, its Gram summed in
            # f32) contracts far less per sweep than v2; the reference
            # fails its own f32 s-step test (ROADMAP.md queue 3)
            print(f"  {label}: reaches fp64 v2's {NITER}-iteration rnorm: "
                  f"{'yes' if h[-1] <= v2_last else 'NO'} ({h[-1]:.6e} "
                  f"against {v2_last:.6e}; reported, not gated)", flush=True)
        if prec == "bf16_ir":
            plain_falls = bool(np.all(ph[1:] <= ph[:-1] * IR_MONOTONE))
            if variant == "sstep" and not plain_falls:
                # a limit of the formulation, not of the kernels: the
                # kernel route is then held to the plain route alone
                print(f"  {label}: the plain route's outer rnorms rise too "
                      f"(x {IR_MONOTONE:g}); held to the plain route alone",
                      flush=True)
            else:
                check(bool(np.all(h[1:] <= h[:-1] * IR_MONOTONE)),
                      f"{label}: outer rnorms never rise (x "
                      f"{IR_MONOTONE:g}; the plain route's: {plain_falls})")
            print(f"  {label}: reaches fp64 v2's {NITER}-iteration rnorm: "
                  f"{'yes' if h[-1] <= v2_last else 'NO'} ({h[-1]:.6e} "
                  f"against {v2_last:.6e}; reported, not gated)", flush=True)
    # --- bf16 Jacobi-PCG (K4 + K10): bf16 through the case, bf16_ir (x
    # and the operator's data in f32) through pcg_fused_v2_fixed_iters ----
    case = NekboneCase(n=10, grid=PAPER_GRID, dtype=torch.float64)
    u_ex, f = case.manufactured()
    invd = 1.0 / case.operator_diagonal()
    bf16_case = NekboneCase(n=10, grid=PAPER_GRID, dtype=torch.float64,
                            precision="bf16",
                            ax_impl="pallas_fused_cg_v2")
    f16 = bf16_case.manufactured()[1]

    def jacobi(prec):
        if prec == "bf16":
            return bf16_case.solve(f16, niter=NITER, precond="jacobi")
        return pc.pcg_fused_v2_fixed_iters(
            f, D=case.D, g=case.g, grid=case.grid, niter=NITER,
            precond=pc.JacobiPrecond(invdiag=invd), mask=case.mask,
            c=case.c, precision=prec)

    for prec, x_dtype in (("bf16", torch.bfloat16),
                          ("bf16_ir", torch.float32)):
        label = f"{prec} jacobi"
        res, launches = _launch_run(lambda: jacobi(prec))
        out["launches"][label] = launches
        h = res.history.double().cpu().numpy()
        check(h.shape == (NITER + 1,) and bool(np.isfinite(h).all())
              and bool(torch.isfinite(res.x).all())
              and res.x.dtype == x_dtype,
              f"{label}: x {res.x.dtype}, finite, history of {h.size}")
        check(launches == _zero_but(nekbone_ax_slab=NITER,
                                    nekbone_pcg_update=NITER),
              f"{label}: launches {launches}")
        with _plain_kernels():
            pres, plaunch = _launch_run(lambda: jacobi(prec))
        ph = pres.history.double().cpu().numpy()
        check(plaunch == _zero_but(), f"{label} over plain versions: no "
                                      "kernel launched")
        dev = _rel_dev(h, ph)
        worst = float(np.abs(np.log(h / ph)).max())
        check(h[0] == ph[0] and float(dev[:11].max()) <= BF16_HEAD_TOL,
              f"{label}: history entries 0..10 within {BF16_HEAD_TOL:g} of "
              f"the plain route's ({float(dev[:11].max()):.2e}); all "
              f"{NITER + 1} within {np.exp(worst):.2f}x (reported)")
        ms = wall_ms(lambda: jacobi(prec), reps=3)
        out["ms"][label] = ms
        out["hist"][label] = h
        err = float(case.solution_error(res.x.to(torch.float64), u_ex))
        print(f"  {label}: history[0, 10, 50, 100] "
              + " ".join(f"{v:.6e}" for v in h[[0, 10, 50, NITER]])
              + f"; last / fp64 v2's history[{NITER}] {h[-1] / v2_last:.3e};"
              f" solution_error {err:.6e}; {ms:.3f} ms to completion, "
              f"{ms / NITER:.4f} ms per iteration (fp64 v2 "
              f"{v2_solve_ms / NITER:.4f})", flush=True)

    # --- bf16 reference CG over K1: the case's bf16 policy on `pallas` ---
    label = "bf16 reference"
    ref_case = NekboneCase(n=10, grid=PAPER_GRID, dtype=torch.float64,
                           precision="bf16", ax_impl="pallas")
    f_ref = ref_case.manufactured()[1]

    def reference():
        return ref_case.solve(f_ref, niter=NITER)

    with _forbid_plain_nekbone():
        res, launches = _launch_run(reference)
    out["launches"][label] = launches
    h = res.history.double().cpu().numpy()
    check(res.pipeline == "reference" and h.shape == (NITER + 1,)
          and bool(np.isfinite(h).all())
          and bool(torch.isfinite(res.x.float()).all())
          and res.x.dtype == torch.bfloat16,
          f"{label}: pipeline {res.pipeline}, x {res.x.dtype}, finite, "
          f"history of {h.size}")
    check(launches == _zero_but(nekbone_ax=NITER),
          f"{label}: launches {launches}")
    with _plain_kernels():
        pres, plaunch = _launch_run(reference)
        with _operator_rounded_once("ax_local_fused"):
            tres, _ = _launch_run(reference)
    ph = pres.history.double().cpu().numpy()
    th = tres.history.double().cpu().numpy()
    check(plaunch == _zero_but(), f"{label} over plain versions: no kernel "
                                  "launched")
    head, spread = _rel_dev(h, ph)[:11], _rel_dev(th, ph)[:11]
    bar = max(BF16_HEAD_TOL, ENVELOPE_FACTOR * float(spread.max()))
    worst = float(np.abs(np.log(h / ph)).max())
    out["head"] = {label: (float(head.max()), float(spread.max()))}
    check(h[0] == ph[0] and float(head.max()) <= bar,
          f"{label}: history entry 0 equal and entries 0..10 within "
          f"{bar:.3g} of the plain route's ({float(head.max()):.2e}; by "
          "entry " + " ".join(f"{v:.1e}" for v in head) + "); the plain "
          "route under another valid f32 order of its operator moves by "
          f"{float(spread.max()):.2e} (by entry "
          + " ".join(f"{v:.1e}" for v in spread) + f"); within "
          f"{BF16_HEAD_TOL:g}: "
          f"{'yes' if head.max() <= BF16_HEAD_TOL else 'NO'} (reported); "
          f"all {NITER + 1} within {np.exp(worst):.2f}x (reported)")
    ms = wall_ms(reference, reps=3)
    out["ms"][label] = ms
    out["hist"][label] = h
    err = float(case.solution_error(res.x.to(torch.float64), u_ex))
    print(f"  {label}: history[0, 10, 50, 100] "
          + " ".join(f"{v:.6e}" for v in h[[0, 10, 50, NITER]])
          + f" (plain route {ph[NITER]:.6e}); last / fp64 v2's "
          f"history[{NITER}] {h[-1] / v2_last:.3e}; solution_error "
          f"{err:.6e}; {ms:.3f} ms to completion, {ms / NITER:.4f} ms per "
          f"iteration (fp64 v2 {v2_solve_ms / NITER:.4f})", flush=True)
    return out


def phase_bf16_times(bw_copy, rows):
    """Device time of the f32 K4, K5, K3, K8 and K9 (s=4) and K10, and the
    bf16 K1, K2, K4, K5, K3, K8 (s=4), K9 (s=4; K9 beside one
    ``torch.matmul`` in its storage type) and K10 (both builds) beside
    their plain versions at E=1024 and E=4096."""
    import numpy as np
    import torch

    from repro_torch.core.cg_sstep import estimate_theta
    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import nekbone_ax as K

    print("== times of the reduced-precision builds (K4, K5, K3, K8, K9 and "
          "K10 in f32, K1, K2, K4, K5, K3, K8, K9 and K10 in bf16 and "
          "bf16_ir; "
          "n=10, K8 and K9 "
          f"at s={SSTEP_S}; device time per call, CUDA events around 20 "
          "queued calls, median of 5; operations at the fp32 rate, 67 "
          "TF/s)", flush=True)
    rng = np.random.default_rng(12)
    n = 10
    for grid in (PAPER_GRID, BIG_GRID):
        case = NekboneCase(n=n, grid=grid, dtype=torch.float64)
        E = case.mesh.nelt
        nodes = E * n ** 3
        u64, D64, g64 = _operator_data(rng, E, n, torch.float64)
        mask64 = case.mask.reshape(E, n ** 3).contiguous()
        for mix in ("f32",) + BF16_MIXES:
            dt = K.MIXES[mix]
            S, X, O = (dt[r].itemsize for r in "SXO")
            o = _mix_operands(case, rng, mix)
            k4 = (o["p"], o["r"], o["D"], o["g3"], *o["m"], o["beta"])
            kp, kw, _ = K.nekbone_ax_slab_cuda(*k4, n=n)
            k5 = (o["x"], kp, o["r"], kw, o["alpha"], *o["c"])
            k3 = (u64.to(dt["S"]), D64.to(dt["O"]), g64.to(dt["O"]),
                  mask64.to(dt["S"]))
            # bytes per node: K4 p, r, 3 metric diagonals in, p, w out; K5
            # x, p, r, w in, x, r out; K3 p, 6 metric fields, mask in, w
            # out.  (contraction, other) flops per node as for fp64.
            work = {
                "K4": (K.nekbone_ax_slab_cuda, K.nekbone_ax_slab_plain, k4,
                       4 * S + 3 * O, (12 * n, 10)),
                "K5": (K.nekbone_cg_update_cuda, K.nekbone_cg_update_plain,
                       k5, 2 * X + 4 * S, (0, 8)),
                "K3": (K.nekbone_ax_pap_cuda, K.nekbone_ax_pap_plain, k3,
                       3 * S + 6 * O, (12 * n, 18)),
            }
            # K8: p, r, 3 metric diagonals in, 2s - 1 basis vectors and the
            # Gram partials (A) out; K9: x in and out, p, r and the basis
            # in, r, p out.  Flops as for fp64.
            s, K_ = SSTEP_S, 2 * SSTEP_S + 1
            ith = torch.full((1,), 1.0 / estimate_theta(
                case.D, case.g, case.grid, case.mask), dtype=dt["A"],
                device="cuda")
            k8 = (o["p"], o["r"], o["D"], o["g3"], *o["m"], *o["c"], ith)
            basis, _ = K.nekbone_ax_powers_cuda(*k8, n=n, s=s)
            coef = torch.as_tensor(rng.normal(size=(3, K_)), dtype=dt["A"],
                                   device="cuda")
            k9 = (o["x"], o["p"], o["r"], basis, coef, *o["c"])
            gram_bytes = E * K_ * K_ * dt["A"].itemsize
            work.update({
                "K8": (K.nekbone_ax_powers_cuda, K.nekbone_ax_powers_plain,
                       k8, (2 * s + 1) * S + 3 * O + gram_bytes / nodes,
                       ((2 * s - 1) * 12 * n,
                        6 * (2 * s - 1) + 3 * K_ * (K_ + 1) // 2)),
                "K9": (K.nekbone_sstep_update_cuda,
                       K.nekbone_sstep_update_plain, k9,
                       2 * X + (2 * s + 3) * S, (0, 6 * K_ + 3)),
            })
            V = torch.stack([o["p"]] + [basis[:, m] for m in range(s)]
                            + [o["r"]]
                            + [basis[:, s + m] for m in range(s - 1)]
                            ).reshape(K_, nodes)
            coef_s = coef.to(dt["S"])
            # K10: x in and out, p, z, w in, z out, invd in
            invd = (1.0 / case.operator_diagonal()).reshape(
                E, n ** 3).to(dt["O"])
            k10 = (o["x"], kp, o["r"], kw, o["alpha"], invd, *o["c"])
            work["K10"] = (K.nekbone_pcg_update_cuda,
                           K.nekbone_pcg_update_plain, k10,
                           2 * X + 4 * S + O, (0, 14))
            if mix != "f32":
                r2 = torch.as_tensor(rng.normal(size=(E, n ** 3)),
                                     dtype=dt["S"], device="cuda")
                k2 = k3 + (r2, case.c.reshape(E, n ** 3).to(dt["S"]))
                work.update({
                    # K1: u, 6 metric fields in, w out; K2: K3's and r, c
                    "K1": (K.nekbone_ax_cuda, K.nekbone_ax_plain, k3[:3],
                           2 * S + 6 * O, (12 * n, 17)),
                    "K2": (K.nekbone_ax_dots_cuda, K.nekbone_ax_dots_plain,
                           k2, 5 * S + 6 * O, (12 * n, 21)),
                })
            for name, (kern, plain, args, per_node, (fm, fr)) in work.items():
                kw_s = dict(n=n, s=SSTEP_S) if name in ("K8", "K9") \
                    else dict(n=n)
                lib = (lambda: torch.matmul(coef_s, V)) if name == "K9" \
                    else None
                row = _time_row(
                    f"{name} {mix} E={E} ({per_node:.4g} B/node"
                    + (f"; library: torch.matmul of the {dt['S']} "
                       "coefficients and V" if lib else "") + ")",
                    lambda: kern(*args, **kw_s),
                    lambda: plain(*args, **kw_s), per_node * nodes,
                    nodes * fm, nodes * fr, bw_copy, lib=lib,
                    mma_peak=FP32_PEAK, rest_peak=FP32_PEAK)
                rows[(f"{name} {mix}", grid)] = row
            del o, k4, k5, k3, kp, kw, work, basis, V
        del u64, D64, g64, mask64
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The LM serving slice: K13 (flash attention) and K14 (WKV6)
# ---------------------------------------------------------------------------
# H100 SXM data sheet: dense bf16 tensor-core rate and fp32 rate outside the
# tensor cores (K13's and K14's operation bounds).
BF16_TENSOR_PEAK = 989e12
FP32_PEAK = 67e12
# gemma2-27b's, nemotron-4-340b's and hymba-1.5b's attention shapes and
# rwkv6-1.6b's WKV shapes
GEMMA_HEADS = dict(Hq=32, Hkv=16, d=128)
NEMOTRON_HEADS = dict(Hq=96, Hkv=8, d=192)
HYMBA_HEADS = dict(Hq=25, Hkv=5, d=64)
RWKV_HEADS = dict(H=32, d=64)
# Kernel against plain version, relative to the plain version's max |.|:
# float32 is two summation orders; bfloat16 outputs (o) may differ by one
# bfloat16 rounding (2^-8 of the largest value at most); K14's f32 state
# is float32 in both dtypes, over 1024 steps.
K13_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
K14_O_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
K14_S_TOL = 1e-4
# bfloat16 outputs are also held value by value, so that rows far smaller
# than the largest value are checked too: kernel and plain version each
# round one f32 result to bfloat16, so they may differ by one bfloat16 step
# (at most 2^-7 of the value) plus their f32 difference (the float32
# tolerance of the largest value).
BF16_STEP = 2.0 ** -7
# serve runs: (arch, depth kept, batch, prompt, generated tokens); depth
# None keeps every layer (whisper: 32 encoder and 32 decoder layers).
# llava's 2880 image tokens come before its prompt; whisper's decoder
# reads 1500 audio frames (its decoder context is 448 tokens).
SERVE_RUNS = (("rwkv6-1.6b", None, 4, 1024, 32),
              ("gemma2-27b", 2, 2, 6144, 16),
              ("nemotron-4-340b", 2, 2, 4096, 16),
              ("hymba-1.5b", None, 4, 2048, 32),
              ("qwen3-moe-30b-a3b", 8, 4, 2048, 16),
              ("arctic-480b", 2, 2, 2048, 16),
              ("whisper-large-v3", None, 4, 64, 64),
              ("llava-next-mistral-7b", None, 2, 128, 32),
              ("qwen2.5-14b", 8, 4, 2048, 16),
              ("codeqwen1.5-7b", 8, 4, 2048, 16))
# the MoE layer on the card against the CPU: qwen3-moe-30b-a3b's width, f32,
# 1 x 512 tokens at capacity factor 1.0 (some assignments dropped); outputs
# within MOE_TOL of max |y| (two f32 orders of the router and the expert
# products, over d 2048 and f 768)
MOE_TOKENS = 512
MOE_TOL = 1e-5
# K13's bf16 build (the tensor-core kernel), for its ptxas and shared-memory
# report
K13_BF16 = "flash_attn_bf16"


def _attn_pairs(Sq, Skv, causal, window, q_offset=0):
    """Unmasked (query, key) pairs of one head."""
    import numpy as np

    qpos = q_offset + np.arange(Sq)
    hi = np.minimum(Skv, qpos + 1) if causal else np.full(Sq, Skv)
    lo = (np.maximum(0, qpos - window + 1) if window is not None
          else np.zeros(Sq, dtype=np.int64))
    return int(np.clip(hi - lo, 0, None).sum())


def _k13_inputs(gen, B, Hq, Hkv, Sq, Skv, d, dtype):
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return rnd(B, Hq, Sq, d), rnd(B, Hkv, Skv, d), rnd(B, Hkv, Skv, d)


def _k14_inputs(gen, B, H, T, d, dtype, state: bool):
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    r, k, v = (rnd(B, H, T, d).to(dtype) for _ in range(3))
    # the model's decay range: w = exp(-exp(w~)), w~ in [-8, 1]
    wt = torch.rand((B, H, T, d), generator=gen, device="cuda") * 9.0 - 8.0
    w = torch.exp(-torch.exp(wt))
    u = 0.1 * rnd(H, d)
    s0 = rnd(B, H, d, d) if state else None
    return r, k, v, w, u, s0


def _max_rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def _value_rel(a, b, tol32: float) -> float:
    """max over values of |a - b| / (2^-7 |b| + tol32 max |b|): a bfloat16
    output a agrees with b value by value where this is <= 1."""
    bf = b.float()
    atol = tol32 * float(bf.abs().max())
    return float(((a.float() - bf).abs()
                  / (BF16_STEP * bf.abs() + max(atol, 1e-30))).max())


def _check_k13(label, o, p):
    """K13's output o against the plain version's p (q's dtype)."""
    import torch

    kind = str(o.dtype).split(".")[1]
    rel = _max_rel(o, p)
    check(rel <= K13_TOL[kind] and bool(torch.isfinite(o).all()),
          f"K13 {kind} {label}: max rel err {rel:.2e} <= {K13_TOL[kind]:g}")
    if o.dtype == torch.bfloat16:
        val = _value_rel(o, p, K13_TOL["float32"])
        check(val <= 1.0, f"K13 {kind} {label}: every value within one "
              f"bfloat16 step + {K13_TOL['float32']:g} max |o| (worst "
              f"{val:.2f} of that)")


def phase_lm_parity():
    """K13 and K14 against their plain versions on the card."""
    import torch

    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as WK

    print("== K13/K14 parity (kernel vs plain; gemma2-27b's Hq 32, Hkv 16, "
          "d 128, hymba-1.5b's d 64 and nemotron-4-340b's d 192, "
          "whisper-large-v3's non-causal encoder and cross-attention, "
          "arctic-480b's and codeqwen1.5-7b's heads, and rwkv6-1.6b's H 32, "
          "d 64)", flush=True)
    gen = torch.Generator("cuda").manual_seed(5)
    err = {}
    Hq, Hkv, d = GEMMA_HEADS["Hq"], GEMMA_HEADS["Hkv"], GEMMA_HEADS["d"]
    k13_cases = (
        ("window 1024", dict(B=1, Hq=Hq, Hkv=Hkv, Sq=2048, Skv=2048, d=d),
         dict(causal=True, window=1024, softcap=50.0, q_offset=0)),
        ("global", dict(B=1, Hq=Hq, Hkv=Hkv, Sq=2048, Skv=2048, d=d),
         dict(causal=True, window=None, softcap=50.0, q_offset=0)),
        ("q_offset 1536", dict(B=1, Hq=Hq, Hkv=Hkv, Sq=512, Skv=2048, d=d),
         dict(causal=True, window=None, softcap=50.0, q_offset=1536)),
        ("S=1000, window 333", dict(B=1, Hq=Hq, Hkv=Hkv, Sq=1000, Skv=1000,
                                    d=d),
         dict(causal=True, window=333, softcap=50.0, q_offset=0)),
        ("Sq=300, Skv=1000, q_offset 700",
         dict(B=1, Hq=Hq, Hkv=Hkv, Sq=300, Skv=1000, d=d),
         dict(causal=True, window=None, softcap=50.0, q_offset=700)),
        ("d=16, rows 0..4 masked", dict(B=2, Hq=4, Hkv=2, Sq=40, Skv=40,
                                        d=16),
         dict(causal=True, window=16, softcap=50.0, q_offset=-5)),
        # hymba's and nemotron's head sizes, GQA 5:1 with a window and 12:1
        # causal, across partial tiles
        ("d=64, GQA 5:1, S=1000, window 333",
         dict(B=1, Hq=25, Hkv=5, Sq=1000, Skv=1000, d=64),
         dict(causal=True, window=333, softcap=None, q_offset=0)),
        ("d=64, GQA 12:1, S=777", dict(B=2, Hq=24, Hkv=2, Sq=777, Skv=777,
                                       d=64),
         dict(causal=True, window=None, softcap=None, q_offset=0)),
        ("d=192, GQA 5:1, S=1000, window 333",
         dict(B=1, Hq=10, Hkv=2, Sq=1000, Skv=1000, d=192),
         dict(causal=True, window=333, softcap=None, q_offset=0)),
        ("d=192, GQA 12:1, S=777", dict(B=2, Hq=24, Hkv=2, Sq=777,
                                        Skv=777, d=192),
         dict(causal=True, window=None, softcap=None, q_offset=0)),
        # whisper-large-v3's encoder and cross-attention, non-causal over
        # its 1500 audio frames (not a whole number of 64-key tiles), and
        # arctic-480b's GQA 7:1 and codeqwen1.5-7b's MHA at d 128
        ("whisper encoder: d=64, 20:20, S=1500, non-causal",
         dict(B=4, Hq=20, Hkv=20, Sq=1500, Skv=1500, d=64),
         dict(causal=False, window=None, softcap=None, q_offset=0)),
        ("whisper cross-attention: d=64, 20:20, Sq=64, Skv=1500, "
         "non-causal", dict(B=4, Hq=20, Hkv=20, Sq=64, Skv=1500, d=64),
         dict(causal=False, window=None, softcap=None, q_offset=0)),
        ("arctic: d=128, GQA 7:1, S=2048",
         dict(B=1, Hq=56, Hkv=8, Sq=2048, Skv=2048, d=128),
         dict(causal=True, window=None, softcap=None, q_offset=0)),
        ("codeqwen: d=128, MHA 32:32, S=2048",
         dict(B=1, Hq=32, Hkv=32, Sq=2048, Skv=2048, d=128),
         dict(causal=True, window=None, softcap=None, q_offset=0)))
    for dtype in (torch.bfloat16, torch.float32):
        for label, shape, kw in k13_cases:
            q, k, v = _k13_inputs(gen, dtype=dtype, **shape)
            kw = dict(kw, scale=shape["d"] ** -0.5)
            o = FA.flash_attention_cuda(q, k, v, **kw)
            p = ref.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            _check_k13(label, o, p)
            if label.startswith("d=16"):
                check(bool((o[:, :, :5] == 0).all()),
                      f"K13 {dtype} {label}: masked rows are 0")
            if dtype == torch.bfloat16 and label == "global":
                err["K13"] = float((o.float() - p.float()).abs().max())
                _check_k13_split(q, k, v, kw, o, p)
    H, d = RWKV_HEADS["H"], RWKV_HEADS["d"]
    k14_cases = (("T=1024, zero state", 4, H, 1024, d, False),
                 ("T=1024, random state", 4, H, 1024, d, True),
                 ("T=1, random state", 4, H, 1, d, True),
                 ("d=16, T=37", 2, 2, 37, 16, True),
                 # T not a whole number of the kernel's passes
                 ("T=1000, random state", 2, H, 1000, d, True))
    for T, tiles in ((1024, WK.TILES[d]), (1, WK.DECODE_TILES[d])):
        col_tile, groups, per_thread, steps = tiles
        blocks = 4 * H * (d // col_tile)
        print(f"  K14 rwkv6-1.6b serve shape (B=4, H={H}, d={d}), T={T}: "
              f"{blocks} blocks of {col_tile // per_thread * groups} threads "
              f"({d // col_tile} column tiles of {col_tile} per head, "
              f"{groups} row groups, {per_thread} columns a thread, "
              f"{steps} steps a pass)", flush=True)
        check(blocks > 4 * H, f"K14 T={T}: {blocks} blocks > B*H = {4 * H}")
    check(1000 % WK.TILES[d][3] != 0, f"K14: T=1000 ends in a partial "
          f"pass of the {WK.TILES[d][3]}-step passes")
    for dtype in (torch.bfloat16, torch.float32):
        otol = K14_O_TOL[str(dtype).split(".")[1]]
        for label, B, H_, T, d_, state in k14_cases:
            r, k, v, w, u, s0 = _k14_inputs(gen, B, H_, T, d_, dtype, state)
            o, s = WK.wkv6_cuda(r, k, v, w, u, initial_state=s0)
            po, ps = ref.wkv6_ref(r, k, v, w, u, initial_state=s0,
                                  return_state=True)
            torch.cuda.synchronize()
            oe, se = _max_rel(o, po), _max_rel(s, ps)
            check(oe <= otol and se <= K14_S_TOL
                  and o.dtype == dtype and s.dtype == torch.float32,
                  f"K14 {dtype} {label}: o max rel err {oe:.2e} <= "
                  f"{otol:g}, state {se:.2e} <= {K14_S_TOL:g}")
            if dtype == torch.bfloat16:
                val = _value_rel(o, po, K14_O_TOL["float32"])
                check(val <= 1.0, f"K14 {dtype} {label}: every value of o "
                      f"within one bfloat16 step + "
                      f"{K14_O_TOL['float32']:g} max |o| (worst {val:.2f} "
                      "of that)")
            if dtype == torch.bfloat16 and label == "T=1024, zero state":
                err["K14"] = float((o.float() - po.float()).abs().max())
            if label.startswith(("T=1024, zero", "T=1,", "T=1000")):
                reps = [WK.wkv6_cuda(r, k, v, w, u, initial_state=s0)
                        for _ in range(5)]
                check(all(torch.equal(a, o) and torch.equal(b, s)
                          for a, b in reps),
                      f"K14 {dtype} {label}: 5 more calls give bitwise the "
                      "same o and state")
    return err


def phase_moe_parity():
    """qwen3-moe-30b-a3b's MoE layer (``models/moe.moe_ffn``) at full width
    (128 experts, top 8, d 2048, f 768) in float32 on the card against the
    same layer on the CPU: 1 x MOE_TOKENS tokens at capacity factor 1.0,
    so that some assignments are dropped.  The kept (token, expert) pairs
    must be the same, the outputs within MOE_TOL of max |y|, and 3 calls on
    the card bitwise the same (the combine sums each token's k rows; it
    adds nothing with atomics)."""
    import dataclasses

    import torch

    from repro_torch.configs import get
    from repro_torch.models import moe as MO

    cfg = dataclasses.replace(get("qwen3-moe-30b-a3b"),
                              compute_dtype="float32", capacity_factor=1.0)
    T, k, E = MOE_TOKENS, cfg.top_k, cfg.n_experts
    cap = MO._capacity(T, k, E, cfg.capacity_factor)
    print(f"== MoE layer, card against CPU ({cfg.name}: {E} experts, top "
          f"{k}, d {cfg.d_model}, f {cfg.d_ff_expert}, f32; 1 x {T} tokens, "
          f"capacity factor 1.0: {cap} slots an expert)", flush=True)
    moe = MO.init_moe(torch.Generator("cuda").manual_seed(11), cfg)
    x = torch.randn((1, T, cfg.d_model), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(12))

    def kept_pairs(eid, slot):
        kept = (slot < E * cap).cpu()
        tok = torch.arange(T * k) // k
        return set(zip(tok[kept].tolist(), eid.cpu()[kept].tolist()))

    got = [MO.moe_ffn(x, moe, cfg) for _ in range(3)]
    eid, _, slot = MO._route(x[0], moe.router, top_k=k, capacity=cap)
    pairs = kept_pairs(eid, slot)
    ms = device_ms(lambda: MO.moe_ffn(x, moe, cfg), calls=3, reps=3,
                   warmup=1)
    torch.cuda.synchronize()
    moe, x = moe.cpu(), x.cpu()
    want = MO.moe_ffn(x, moe, cfg)
    eid_c, _, slot_c = MO._route(x[0], moe.router, top_k=k, capacity=cap)
    pairs_c = kept_pairs(eid_c, slot_c)
    err = float((got[0].cpu() - want).abs().max())
    rel = err / float(want.abs().max())
    print(f"  kept {len(pairs)} of {T * k} assignments on the card, "
          f"{len(pairs_c)} on the CPU; max |card - CPU| {err:.3e}, "
          f"{rel:.2e} of max |y|; {ms:.3f} ms a call on the card (device "
          "time)", flush=True)
    check(pairs == pairs_c and len(pairs) < T * k,
          "MoE: the card keeps the CPU's (token, expert) pairs, and drops "
          "some")
    check(rel <= MOE_TOL and bool(torch.isfinite(got[0]).all()),
          f"MoE: card within {MOE_TOL:g} of max |y| of the CPU")
    check(all(_same_bits(g, got[0]) for g in got[1:]),
          "MoE: 3 calls on the card give bitwise the same output")
    del moe, x, got
    torch.cuda.empty_cache()
    return err


def _check_k13_split(q, k, v, kw, o, p):
    """The bf16 K13's arithmetic in torch (``ref.flash_attention_tc_emulated``)
    beside the kernel's output o and the plain version's p: with P split
    into two bf16 terms it passes the bf16 value check, with P rounded once
    to bf16 it must fail it."""
    from repro_torch.kernels import ref

    for split in (True, False):
        e = ref.flash_attention_tc_emulated(q, k, v, split_p=split, **kw)
        val = _value_rel(e, p, K13_TOL["float32"])
        diff = float((e.float() - o.float()).abs().max())
        how = "split" if split else "rounded once"
        print(f"  the bf16 K13's arithmetic, P {how}: worst value {val:.2f} "
              f"of the bf16 limit; max |. - kernel| {diff:.2e}", flush=True)
        check(val <= 1.0 if split else val > 1.0,
              "the bf16 value check " + ("passes the split P" if split else
                                         "fails P rounded once to bf16"))


def _forbid_plain_lm():
    """Every plain attention / WKV formulation and PyTorch's fused
    attention: the serving path on the card must run K13/K14."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn, ref, wkv6
    from repro_torch.models import attention, rwkv6

    return _forbid(((flash_attn, ("flash_attention_plain",)),
                    (ref, ("flash_attention_tc_emulated",)),
                    (wkv6, ("wkv6_ref",)), (attention, ("attention_ref",)),
                    (rwkv6, ("wkv6_ref", "wkv6_chunked")),
                    (F, ("scaled_dot_product_attention",))))


def _serve_profile(tag, prof, wall_s):
    """Device time of the profiled serve run, by kernel, beside the host
    clock of an unprofiled warm run (the profiler slows the host, so its own
    span would understate the busy share)."""
    import torch

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"  {tag}: the profiler saw no device time")
        return
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"  {tag}: device {busy:.1f} ms in {len(kernels)} device ops; "
          f"{busy / (wall_s * 1e3):.2f} of run 1's {wall_s * 1e3:.1f} ms "
          "(warm, unprofiled; prefill + decode); top: " + "; ".join(
              f"{name[:40]} {t:.1f} ms" for name, t in top), flush=True)


def _hymba_scan_ms(cfg, B, T):
    """Host-clock time of one layer's selective scan (``models/ssm._ssm_scan``,
    plain PyTorch as in the reference) at the serve shape, inputs in bf16,
    median of 3: the Mamba path's host-bound share of a hymba prefill."""
    import torch

    from repro_torch.models import ssm

    gen = torch.Generator("cuda").manual_seed(7)
    di, n = 2 * cfg.d_model, cfg.ssm_state

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    x, Bc, Cc = rnd(B, T, di), rnd(B, T, n), rnd(B, T, n)
    dt = (torch.rand((B, T, di), generator=gen, device="cuda") * 0.1
          ).bfloat16()
    A = -torch.arange(1, n + 1, dtype=torch.float32,
                      device="cuda").expand(di, n)
    D = torch.ones(di, device="cuda")
    h0 = torch.zeros((B, di, n), device="cuda")
    return wall_ms(lambda: ssm._ssm_scan(x, dt, Bc, Cc, A, D, h0), reps=3)


def _stubs(cfg, B):
    """The modality stubs of a served run (llava's image embeddings,
    whisper's audio frames): 0.1 x N(0, 1) from a seeded generator on the
    card, in the compute dtype, as the reference's tests/test_models.py
    makes them, so that the image rows and the encoder carry data; None
    for a text-only model."""
    import torch

    from repro_torch.configs.specs import extra_specs

    spec = extra_specs(cfg, B)
    if spec is None:
        return None
    gen = torch.Generator("cuda").manual_seed(2)
    return {key: (0.1 * torch.randn(t.shape, generator=gen, device="cuda"))
            .to(t.dtype) for key, t in spec.items()}


def phase_serve():
    """Serve each of SERVE_RUNS at full width through
    ``launch.serve.serve`` (depth cut where it says), three times each: run
    0 cold, run 1 warm (the busy share's wall clock), run 2 profiled; and
    the time of hymba's selective scan (plain PyTorch) per prefill."""
    import dataclasses

    import torch

    from repro_torch.configs import get
    from repro_torch.kernels import _build
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M

    print("== serve (full width, random weights from seed 0, greedy)",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    out = {"launches": {}, "stats": {}}
    for arch, layers, B, P, G in SERVE_RUNS:
        cfg = get(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        # what earlier phases and runs leave on the card; each peak is also
        # printed less it, the serve run's own (its stubs included)
        base = torch.cuda.memory_allocated()
        extra = _stubs(cfg, B)
        runs = []
        for rep in range(3):
            _build.reset_launches()
            # the last run is profiled (device kernels only), with the same
            # seed's weights made before it, so that the profile holds the
            # serving alone
            last = rep == 2
            params = (M.init_params(torch.Generator("cuda").manual_seed(0),
                                    cfg) if last else None)
            prof = (profile(activities=[ProfilerActivity.CUDA]) if last
                    else contextlib.nullcontext())
            with _forbid_plain_lm(), prof:
                tokens, stats = serve(cfg, batch=B, prompt_len=P, gen=G,
                                      seed=0, params=params, extra=extra)
                torch.cuda.synchronize()
            del params
            runs.append((tokens, stats,
                         _Launches(_build.LAUNCHES, _build.BUILD_LAUNCHES),
                         torch.cuda.max_memory_allocated()))
            torch.cuda.empty_cache()
        tokens, stats, launches, _ = runs[0]
        logits = stats["logits"]
        tag = (f"{arch} ({cfg.n_layers} layers, batch {B}, prompt {P}, "
               f"{G} new" + (f", {cfg.img_tokens} image tokens first"
                             if cfg.img_tokens else "")
               + (f", {cfg.enc_layers} encoder layers over "
                  f"{cfg.audio_ctx} audio frames" if cfg.enc_layers else "")
               + ")")
        check(tuple(tokens.shape) == (B, G) and tokens.dtype == torch.long
              and bool(((tokens >= 0) & (tokens < cfg.vocab)).all())
              and bool(torch.isfinite(logits).all()),
              f"{tag}: {tuple(tokens.shape)} tokens in [0, {cfg.vocab}), "
              "finite logits")
        check(all(torch.equal(tokens, t) and torch.equal(logits, st["logits"])
                  for t, st, _, _ in runs[1:]),
              f"{tag}: runs 1 and 2 give the same tokens and bitwise the "
              "same logits as run 0")
        want = dict.fromkeys(_build.LAUNCHES, 0)
        if cfg.block == "rwkv":
            want["wkv6"] = cfg.n_layers * G      # prefill + G - 1 steps
            want_builds = {"wkv6_bf16": want["wkv6"]}
        else:
            # one bf16 launch a prefill layer, by its head size and window;
            # whisper adds a non-causal one for each encoder layer and a
            # non-causal cross one (Sq != Skv) for each decoder layer
            pattern = cfg.window_pattern()
            builds = [f"flash_attn_bf16_d{cfg.hd}"
                      + ("" if w is None else f"_window{w}")
                      for w in (pattern[i % len(pattern)]
                                for i in range(cfg.n_layers))]
            if cfg.enc_layers:
                builds += ([f"flash_attn_bf16_d{cfg.hd}_noncausal"]
                           * cfg.enc_layers
                           + [f"flash_attn_bf16_d{cfg.hd}_noncausal_cross"]
                           * cfg.n_layers)
            want["flash_attn"] = len(builds)
            want_builds = collections.Counter(builds)
        check(all(ln == want and ln.builds == want_builds
                  for _, _, ln, _ in runs),
              f"{tag}: launches flash_attn {launches['flash_attn']}, wkv6 "
              f"{launches['wkv6']} (want {want['flash_attn']}, "
              f"{want['wkv6']}), by build {launches.builds} (want "
              f"{dict(want_builds)}) in every run, no other kernel")
        for i, (_, st, _, pk) in enumerate(runs):
            print(f"  {tag} run {i}: prefill {st['prefill_s'] * 1e3:.1f} ms, "
                  f"decode {st['decode_s'] * 1e3 / (G - 1):.2f} ms per token "
                  f"step, {st['tok_per_s']:.1f} tokens/s decoded, "
                  f"{B * (P + cfg.img_tokens) / st['prefill_s']:.0f} "
                  f"prompt tokens/s (image tokens counted); peak "
                  f"memory {pk / 2 ** 30:.2f} GiB, {(pk - base) / 2 ** 30:.2f} "
                  f"GiB above the {base / 2 ** 30:.2f} GiB held before the "
                  "run", flush=True)
        print(f"  {tag}: first tokens {tokens[0, :8].tolist()}", flush=True)
        warm = runs[1][1]
        _serve_profile(tag, prof, warm["prefill_s"] + warm["decode_s"])
        if cfg.block == "hymba":
            scan = _hymba_scan_ms(cfg, B, P)
            out["scan_ms"] = scan
            print(f"  {tag}: the selective scan alone (plain PyTorch, 2 "
                  f"device ops a step) takes {scan:.1f} ms a layer, "
                  f"{scan * cfg.n_layers:.0f} ms for {cfg.n_layers} layers, "
                  "beside prefills of " + ", ".join(
                      f"{st['prefill_s'] * 1e3:.0f}" for _, st, _, _ in runs)
                  + " ms (runs 0, 1, 2; host clocks)", flush=True)
        out["launches"][arch] = launches
        out["stats"][arch] = [st for _, st, _, _ in runs]
        del runs, tokens, stats, logits, warm, extra
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return out


def _lm_row(label, kern, plain, nbytes, flops, peak, bw_copy, *, calls,
            lib=None):
    """Device times of a kernel, its plain version and a library call; the
    bound from bytes at the data sheet's 3.35 TB/s and operations at
    ``peak``."""
    ms = device_ms(kern, calls=calls, reps=3, warmup=1)
    plain_ms = device_ms(plain, calls=1, reps=3, warmup=1)
    lib_ms = (device_ms(lib, calls=calls, reps=3, warmup=1)
              if lib is not None else None)
    t_bytes = nbytes / BW_PEAK * 1e3
    t_ops = flops / peak * 1e3
    bound = max(t_bytes, t_ops)
    print(f"  {label}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TF/s); "
          f"plain {plain_ms:.4f} ms; "
          + (f"library {lib_ms:.4f} ms; " if lib is not None else "")
          + f"bound {bound:.4f} ms (bytes at 3.35 TB/s {t_bytes:.4f}, "
          f"{nbytes / bw_copy * 1e3:.4f} at measured copy BW; operations "
          f"{t_ops:.4f}); kernel / bound {ms / bound:.1f}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def phase_lm_times(bw_copy):
    """K13 at gemma2's serve shapes (batch 2, 6144 tokens), nemotron-4's
    (batch 2, 4096), hymba's (batch 4, 2048) and those of qwen3-moe,
    arctic, qwen2.5, codeqwen, llava and whisper's three layer kinds, and
    K14 at rwkv6's (batch 4, 1024 tokens; and one decode step)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as WK

    print("== times of K13 and K14 at the serve shapes (device time per "
          "call, CUDA events, median of 3)", flush=True)
    gen = torch.Generator("cuda").manual_seed(6)
    rows = {}
    B, S = 2, 6144
    Hq, Hkv, d = GEMMA_HEADS["Hq"], GEMMA_HEADS["Hkv"], GEMMA_HEADS["d"]
    q, k, v = _k13_inputs(gen, B, Hq, Hkv, S, S, d, torch.bfloat16)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    q32, k32, v32 = q.float(), k.float(), v.float()
    plain32 = {}
    for label, window in (("global", None), ("window 4096", 4096)):
        kw = dict(causal=True, window=window, softcap=50.0, q_offset=0,
                  scale=d ** -0.5)
        flops = 4 * d * B * Hq * _attn_pairs(S, S, True, window)
        lib = None
        if window is None:
            # same function but for the softcap, which SDPA lacks
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=True, scale=d ** -0.5, enable_gqa=True)
        rows[f"K13 {label}"] = _lm_row(
            f"K13 bf16 {label}, B={B} S={S}",
            lambda: FA.flash_attention_cuda(q, k, v, **kw),
            lambda: ref.flash_attention_plain(q, k, v, **kw),
            nbytes, flops, BF16_TENSOR_PEAK, bw_copy, calls=3, lib=lib)
        # parity at the serve shape, in bfloat16 and in float32 (the same
        # values upcast), over every row: the window cuts in past row 4096
        _check_k13(f"{label} at the serve shape",
                   FA.flash_attention_cuda(q, k, v, **kw),
                   ref.flash_attention_plain(q, k, v, **kw))
        plain32[label] = ref.flash_attention_plain(q32, k32, v32, **kw)
        _check_k13(f"{label} at the serve shape",
                   FA.flash_attention_cuda(q32, k32, v32, **kw),
                   plain32[label])
        torch.cuda.empty_cache()
    # What a wrong kernel would read on the window layer: the plain version
    # with the window dropped, or one key short, held to the same measures.
    want = plain32["window 4096"]
    kw = dict(causal=True, window=4095, softcap=50.0, q_offset=0,
              scale=d ** -0.5)
    for wrong, got in (("window ignored", plain32["global"]),
                       ("window 4095", ref.flash_attention_plain(
                           q32, k32, v32, **kw))):
        rel = _max_rel(got, want)
        val = _value_rel(got.bfloat16(), want.bfloat16(), K13_TOL["float32"])
        print(f"  a K13 with the {wrong} would read: float32 max rel err "
              f"{rel:.2e}; bfloat16 worst value {val:.2f} of its limit",
              flush=True)
        check(rel > K13_TOL["float32"] and val > 1.0,
              f"the serve-shape checks fail a K13 with the {wrong}")
    del q32, k32, v32, plain32, want, got
    torch.cuda.empty_cache()
    del q, k, v
    # nemotron-4-340b's global layer (d 192, GQA 12:1) and hymba-1.5b's
    # global and window-1024 layers (d 64, GQA 5:1), neither soft-capped:
    # on the global layers SDPA computes the same function
    for arch, heads, B, S, windows in (
            ("nemotron-4-340b", NEMOTRON_HEADS, 2, 4096, (None,)),
            ("hymba-1.5b", HYMBA_HEADS, 4, 2048, (None, 1024))):
        Hq, Hkv, d = heads["Hq"], heads["Hkv"], heads["d"]
        q, k, v = _k13_inputs(gen, B, Hq, Hkv, S, S, d, torch.bfloat16)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        for window in windows:
            label = f"K13 d={d} " + ("global" if window is None
                                     else f"window {window}")
            kw = dict(causal=True, window=window, softcap=None, q_offset=0,
                      scale=d ** -0.5)
            flops = 4 * d * B * Hq * _attn_pairs(S, S, True, window)
            lib = None
            if window is None:
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q, k, v, is_causal=True, scale=d ** -0.5,
                    enable_gqa=True)
            rows[label] = _lm_row(
                f"{label} bf16 ({arch}: B={B}, Hq {Hq}, Hkv {Hkv}, S={S})",
                lambda: FA.flash_attention_cuda(q, k, v, **kw),
                lambda: ref.flash_attention_plain(q, k, v, **kw),
                nbytes, flops, BF16_TENSOR_PEAK, bw_copy, calls=3, lib=lib)
            o = FA.flash_attention_cuda(q, k, v, **kw)
            want = ref.flash_attention_plain(q, k, v, **kw)
            _check_k13(f"{arch} {label} at the serve shape", o, want)
            rows[label]["max_abs_err"] = float((o.float() - want.float())
                                               .abs().max())
            del o, want
            torch.cuda.empty_cache()
        del q, k, v
        torch.cuda.empty_cache()
    # qwen3-moe, arctic, qwen2.5, codeqwen, llava and whisper at their
    # serve shapes (SERVE_RUNS: batch, and prompt after llava's image
    # tokens): one global causal layer each, and whisper's three kinds, its
    # encoder over the 1500 audio frames, its cross-attention from the
    # prompt to them and its decoder's self-attention.  None is soft-capped
    # or windowed, so SDPA computes the same function on each.
    from repro_torch.configs import get

    runs = {arch: (B, P + get(arch).img_tokens)
            for arch, _, B, P, _ in SERVE_RUNS}
    shapes = [(f"K13 {arch}", arch, runs[arch][1], runs[arch][1], True)
              for arch in ("qwen3-moe-30b-a3b", "arctic-480b", "qwen2.5-14b",
                           "codeqwen1.5-7b", "llava-next-mistral-7b")]
    wcfg = get("whisper-large-v3")
    text = runs[wcfg.name][1]
    shapes += [("K13 whisper encoder", wcfg.name, wcfg.audio_ctx,
                wcfg.audio_ctx, False),
               ("K13 whisper cross", wcfg.name, text, wcfg.audio_ctx, False),
               ("K13 whisper decoder", wcfg.name, text, text, True)]
    for key, arch, Sq, Skv, causal in shapes:
        cfg = get(arch)
        B = runs[arch][0]
        Hq, Hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q, k, v = _k13_inputs(gen, B, Hq, Hkv, Sq, Skv, d, torch.bfloat16)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        kw = dict(causal=causal, window=None, softcap=None, q_offset=0,
                  scale=d ** -0.5)
        flops = 4 * d * B * Hq * _attn_pairs(Sq, Skv, causal, None)
        rows[key] = _lm_row(
            f"{key} bf16 ({arch}: B={B}, Hq {Hq}, Hkv {Hkv}, d {d}, "
            f"Sq={Sq}, Skv={Skv}, " + ("causal" if causal else "non-causal")
            + ")",
            lambda: FA.flash_attention_cuda(q, k, v, **kw),
            lambda: ref.flash_attention_plain(q, k, v, **kw),
            nbytes, flops, BF16_TENSOR_PEAK, bw_copy, calls=3,
            lib=lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=d ** -0.5,
                enable_gqa=True))
        o = FA.flash_attention_cuda(q, k, v, **kw)
        want = ref.flash_attention_plain(q, k, v, **kw)
        _check_k13(f"{key} at the serve shape", o, want)
        rows[key]["max_abs_err"] = float((o.float() - want.float())
                                         .abs().max())
        del q, k, v, o, want
        torch.cuda.empty_cache()
    H, d = RWKV_HEADS["H"], RWKV_HEADS["d"]
    for label, T, state in (("prefill T=1024", 1024, False),
                            ("decode T=1", 1, True)):
        r, k, v, w, u, s0 = _k14_inputs(gen, 4, H, T, d, torch.bfloat16,
                                        state)
        nbytes = (r.numel() * (2 + 2 + 2 + 4 + 2)
                  + (2 if state else 1) * 4 * 4 * H * d * d)
        flops = 4 * d * d * 4 * H * T
        rows[f"K14 {label}"] = _lm_row(
            f"K14 bf16 {label}, B=4 H={H}",
            lambda: WK.wkv6_cuda(r, k, v, w, u, initial_state=s0),
            lambda: ref.wkv6_ref(r, k, v, w, u, initial_state=s0,
                                 return_state=True),
            nbytes, flops, FP32_PEAK, bw_copy, calls=10 if T > 1 else 50)
    torch.cuda.empty_cache()
    return rows

# the service phase: the paper case through launch/solver_service.py
SERVICE_MAX_B = 4
SERVICE_TOL = 1e-6
SERVICE_MAX_ITER = 1000
# ax_impl="auto": v1 against v2 through pick_pipeline's measure at n = 10
AUTO_GRIDS = ((1, 1, 1), (2, 2, 2), (4, 4, 4), (8, 8, 8), PAPER_GRID)
# the policies NekboneCase(ax_impl="auto") is resolved with on the card
AUTO_POLICIES = ("f32", "bf16_ir")
BENCH_REQUESTS = 16
BENCH_NITER = 25


def _service_requests(cfg, fs):
    """The service phase's 11 requests: 8 at NITER (two block dispatches
    at SERVICE_MAX_B), 2 Jacobi at NITER (one block_loop dispatch), 1 to
    SERVICE_TOL (one v2_tol dispatch)."""
    from repro_torch.launch.solver_service import SolveRequest

    return ([SolveRequest(f=f, config=cfg, niter=NITER) for f in fs[:8]]
            + [SolveRequest(f=f, config=cfg, niter=NITER, precond="jacobi")
               for f in fs[8:10]]
            + [SolveRequest(f=fs[10], config=cfg, tol=SERVICE_TOL,
                            max_iter=SERVICE_MAX_ITER)])


def phase_service(hist, smi_line, solve_rounds):
    """The solver service on the card at the paper case: scheduling,
    answers bitwise the direct solves of the same batch, the route rule on
    the block histories, a traced drain bitwise the untraced one,
    ``ax_impl="auto"`` (v1 against v2 by E, the pick held to
    ``solve_rounds``: phase_slice4_times' 100-iteration solves in turns, ms
    an iteration), and ``bench_service``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.nekbone import PAPER_CASES
    from repro_torch.core.gs import ds_sum_local
    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import autotune
    from repro_torch.launch.solver_service import (SolverService,
                                                   _bucket_key,
                                                   bench_service)
    from repro_torch.obs import trace

    t_phase = time.perf_counter()
    print("== solver service: paper case, n=10, E=1024, fp64, "
          f"pallas_fused_cg_v2, max_b={SERVICE_MAX_B}", flush=True)
    cfg = dataclasses.replace(PAPER_CASES[1024], dtype="float64",
                              ax_impl="pallas_fused_cg_v2")
    svc = SolverService(max_b=SERVICE_MAX_B)
    case = svc._case_for(cfg)
    _, f0 = case.manufactured()
    gen = torch.Generator(device=case.device).manual_seed(27)
    fs = [f0] + [ds_sum_local(torch.randn(
        tuple(f0.shape), generator=gen, dtype=f0.dtype, device=f0.device),
        case.grid) * case.mask for _ in range(10)]

    # --- scheduling, launches, answers --------------------------------
    reqs = _service_requests(cfg, fs)
    ids = [svc.submit(r) for r in reqs]
    t0 = time.perf_counter()
    results, launches = _launch_run(svc.drain)
    drain_ms = (time.perf_counter() - t0) * 1e3
    log = svc.dispatch_log
    print("  dispatches: " + "; ".join(
        f"b={d.batch_size} {d.pipeline} ids {d.request_ids} "
        f"{d.wall_us / 1e3:.3f} ms" for d in log)
        + f"; drain {drain_ms:.3f} ms; launches {launches}", flush=True)
    check([r.request_id for r in results] == ids,
          "service: results in submission order")
    check([d.batch_size for d in log] == [4, 4, 2, 1]
          and [d.request_ids for d in log] == [ids[0:4], ids[4:8],
                                               ids[8:10], ids[10:]],
          "service: 4 dispatches of 4, 4, 2 and 1, in submission order")
    check(all(len({_bucket_key(reqs[i]) for i in d.request_ids}) == 1
              for d in log) and len({d.bucket for d in log}) == 3,
          "service: no dispatch mixes buckets (3 buckets)")
    k_tol = int(results[10].iters_taken)
    check(launches == _zero_but(
        nekbone_ax_slab_block=2 * NITER, nekbone_cg_update_block=2 * NITER,
        nekbone_ax_slab=2 * NITER + k_tol, nekbone_pcg_update=2 * NITER,
        nekbone_cg_update=k_tol),
          f"service: launches K6 = K7 = {2 * NITER}, K4 = {2 * NITER} + "
          f"{k_tol}, K10 = {2 * NITER}, K5 = {k_tol}")
    direct = [case.solve(torch.stack(fs[0:4]), b=4, niter=NITER),
              case.solve(torch.stack(fs[4:8]), b=4, niter=NITER),
              case.solve(torch.stack(fs[8:10]), b=2, niter=NITER,
                         precond="jacobi"),
              case.solve(fs[10][None], b=1, tol=SERVICE_TOL,
                         max_iter=SERVICE_MAX_ITER)]
    lanes = [(direct[0], j) for j in range(4)] + \
        [(direct[1], j) for j in range(4)] + \
        [(direct[2], 0), (direct[2], 1), (direct[3], 0)]
    same = [_same_bits(r.x, d.x[j]) and _same_bits(r.history, d.history[j])
            for r, (d, j) in zip(results, lanes)]
    check(all(same), "service: every x and history bitwise the direct "
          "solve of the same batch and stopping rule (b = 4, 4, 2, 1)")
    h_tol = results[10].history.cpu().numpy()
    check(0 < k_tol < SERVICE_MAX_ITER
          and float(results[10].rnorm) <= SERVICE_TOL
          and bool(np.isnan(h_tol[k_tol + 1:]).all()),
          f"service: the tol request stops in {k_tol} iterations at rnorm "
          f"{float(results[10].rnorm):.3e} <= {SERVICE_TOL:g}")
    envelope = float(_rel_dev(hist["fused on the CPU"], hist["fused"]).max())
    worst_head = worst_all = 0.0
    for j in range(8):
        single = case.solve(fs[j], niter=NITER).history.cpu().numpy()
        dev = _rel_dev(results[j].history.cpu().numpy(), single)
        worst_head = max(worst_head, float(dev[:11].max()))
        worst_all = max(worst_all, float(dev.max()))
    print(f"  block lanes vs single-RHS v2: entries 0..10 {worst_head:.2e}, "
          f"all {worst_all:.2e} (plain route's spread {envelope:.2e})",
          flush=True)
    check(worst_head <= HIST_RTOL_HEAD
          and worst_all <= max(HIST_RTOL_HEAD, ENVELOPE_FACTOR * envelope),
          f"service: block histories within {HIST_RTOL_HEAD:g} (0..10) and "
          f"{ENVELOPE_FACTOR:g}x the plain route's spread of their single-"
          "RHS v2 solves")

    # --- the same drain, traced ----------------------------------------
    path = pathlib.Path(tempfile.mkdtemp(prefix="repro-trace-")) / \
        "service.trace.jsonl"
    for r in _service_requests(cfg, fs):
        svc.submit(r)
    t0 = time.perf_counter()
    with trace.recording(path) as rec:
        traced = svc.drain()
    traced_ms = (time.perf_counter() - t0) * 1e3
    problems = trace.validate_trace_file(path)
    spans = collections.Counter(r["name"] for r in rec.records
                                if r["type"] == "span")
    # the same drain untraced once more, after the traced one: the pair
    # the instrumentation's cost is read from
    for r in _service_requests(cfg, fs):
        svc.submit(r)
    t0 = time.perf_counter()
    svc.drain()
    again_ms = (time.perf_counter() - t0) * 1e3
    print(f"  traced drain: {traced_ms:.3f} ms (untraced again "
          f"{again_ms:.3f} ms); spans {dict(spans)}, counters "
          f"{rec.counters}, trace file {path.stat().st_size} B", flush=True)
    shutil.rmtree(path.parent)
    check(problems == [], f"service: trace file valid ({problems[:3]})")
    check({"service.dispatch", "solve", "block.dispatch"} <= set(spans),
          "service: spans service.dispatch, solve and block.dispatch")
    check(all(r.telemetry is not None for r in traced),
          "service: every traced result carries telemetry")
    check(all(_same_bits(a.x, b.x) and _same_bits(a.history, b.history)
              for a, b in zip(results, traced)),
          "service: every x and history bitwise the same with tracing on "
          "and off")

    # --- ax_impl="auto": v1 against v2 by E -----------------------------
    pairs = {}
    for grid in AUTO_GRIDS:
        measure = autotune._default_measure_pipeline(grid, 10,
                                                     torch.float64, "cuda")
        pairs[grid] = {p: measure(p) * 1e3 for p in autotune.PIPELINES}
        e = grid[0] * grid[1] * grid[2]
        print(f"  auto E={e}: v1 {pairs[grid]['pallas_fused_cg']:.4f} ms, "
              f"v2 {pairs[grid]['pallas_fused_cg_v2']:.4f} ms an iteration "
              f"({smi_line})", flush=True)
    v2_wins = [g[0] * g[1] * g[2] for g in AUTO_GRIDS
               if pairs[g]["pallas_fused_cg_v2"] < pairs[g]["pallas_fused_cg"]]
    all_e = [g[0] * g[1] * g[2] for g in AUTO_GRIDS]
    cross = next((e for i, e in enumerate(all_e)
                  if set(all_e[i:]) <= set(v2_wins)), None)
    print(f"  auto crossover: v2 faster from E={cross} on (v2 faster at "
          f"{v2_wins})", flush=True)
    autotune.clear_cache()
    pick = autotune.pick_pipeline(PAPER_GRID, 10, torch.float64)
    auto_case = NekboneCase(n=10, grid=PAPER_GRID, dtype=torch.float64,
                            ax_impl="auto")
    # the pick against the solves phase_slice4_times timed in turns, a
    # measurement the pick's own measure does not make
    rounds = {"pallas_fused_cg": solve_rounds["v1"],
              "pallas_fused_cg_v2": solve_rounds["v2"]}
    med = {p: statistics.median(r) for p, r in rounds.items()}
    spread = max(max(r) - min(r) for r in rounds.values())
    other = next(p for p in autotune.PIPELINES if p != pick)
    print(f"  auto pick at E=1024: {pick}; {NITER}-iteration solves in "
          "turns: " + ", ".join(
              f"{p} {med[p]:.4f} ms/iteration (rounds "
              + ", ".join(f"{t:.4f}" for t in rounds[p]) + ")"
              for p in autotune.PIPELINES)
          + f"; spread {spread:.4f}", flush=True)
    check(med[pick] - med[other] <= spread,
          f"auto: the pick at E=1024 ({pick}, {med[pick]:.4f} ms) is not "
          f"slower than {other} ({med[other]:.4f} ms) by more than the "
          f"rounds' spread ({spread:.4f} ms)")
    for policy in AUTO_POLICIES:
        pc = NekboneCase(n=10, grid=PAPER_GRID, dtype=torch.float64,
                         precision=policy, ax_impl="auto")
        out = pc.solve(pc.manufactured()[1], niter=NITER)
        print(f"  auto {policy}: {pc.ax_impl}, route {out.pipeline}, "
              f"history[{NITER}] {float(out.history[-1]):.6e}", flush=True)
        check(pc.ax_impl in autotune.PIPELINES
              and pc.ax_impl == autotune.cache_info().get(
                  ("pipeline", 10, *PAPER_GRID, str(pc.dtype).removeprefix(
                      "torch."), policy, torch.cuda.get_device_name(0)))
              and bool(torch.isfinite(out.x).all()),
              f"auto {policy}: resolved by a pick keyed by the policy, and "
              "solves to finite values")
    keys = [e["key"] for e in json.loads(
        autotune.cache_path().read_text())["entries"]]
    print(f"  auto cache {autotune.cache_path().name} keys {keys}",
          flush=True)
    check(auto_case.ax_impl == pick and auto_case.ax_impl_requested == "auto"
          and ["pipeline", 10, *PAPER_GRID, "float64", "float64",
               torch.cuda.get_device_name(0)] in keys
          and len(keys) == 1 + len(AUTO_POLICIES),
          "auto: NekboneCase(ax_impl='auto') resolves to the cached, "
          "measured pick, keyed by the card's name")

    # --- bench_service ----------------------------------------------------
    bench = bench_service(nelt=1024, requests=BENCH_REQUESTS,
                          max_b=8, niter=BENCH_NITER, warm=True,
                          dtype="float64")
    rows = bench["rows"]
    check(set(rows) == {"1", "2", "4", "8"} and all(
        rows[b]["dispatches"] == BENCH_REQUESTS // int(b) for b in rows),
          "bench_service: b = 1, 2, 4, 8 with 16 / b dispatches")
    print("  bench_service (E=1024, n=10, fp64, 16 requests, niter "
          f"{BENCH_NITER}, {bench['repeats']} repeats): " + "; ".join(
              f"b={b} latency p50 {r['latency_ms_p50']:.4f} ms p99 "
              f"{r['latency_ms_p99']:.4f} ms, {r['ms_per_request']:.4f} "
              f"ms/request {r['throughput_req_s']:.2f} req/s"
              for b, r in rows.items())
          + f" | {bench['device']} | {smi_line}", flush=True)
    seconds = time.perf_counter() - t_phase
    print(f"  service phase: {seconds:.1f} s", flush=True)
    check(seconds <= 60.0, f"service phase within 60 s ({seconds:.1f} s)")
    return {"launches": launches, "pairs": pairs, "rows": rows}


def _same_bits(a, b) -> bool:
    """Bitwise equality that holds NaN padding equal to itself."""
    import torch

    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).contiguous().view(torch.uint8),
        b.reshape(-1).contiguous().view(torch.uint8)))


def main() -> int:
    t_start = time.perf_counter()
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a fresh autotune cache for the whole run: no pick left by an earlier
    # run can change one of this run's
    cache_dir = tempfile.mkdtemp(prefix="repro-cache-")
    os.environ["REPRO_CACHE_DIR"] = cache_dir
    try:
        return _run_phases(t_start)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


def _run_phases(t_start) -> int:
    import torch

    try:
        device_name, smi_line = phase_device()
        phase_build()
        bw = phase_copy_bandwidth()
        err = {"K1": phase_k1_parity()}
        err.update(phase_v2_parity())
        launches, cases, hist = phase_routes()
        err.update(phase_pcg_parity())
        err.update(phase_interp_block_parity())
        pcg = phase_pcg_routes()
        launches.update(pcg["launches"])
        routes = phase_pmg_block_routes()
        launches.update(routes["launches"])
        rows, v2_solve_ms = phase_times(bw, cases)
        phase_pcg_times(pcg, v2_solve_ms)
        phase_slice3_times(routes, v2_solve_ms)
        err.update(phase_v1_sstep_parity())
        slice4 = phase_v1_sstep_routes(hist)
        launches.update(slice4["launches"])
        solve_rounds = phase_slice4_times(bw, slice4, rows)
        err.update(phase_bf16_parity())
        err.update(phase_bf16_sstep_pcg_parity())
        err.update(phase_bf16_k1_k2_parity())
        err.update(phase_walk_parity())
        ir = phase_ir_routes(hist, v2_solve_ms)
        err.update(phase_bf16_cheb_pmg_block_parity())
        slice12 = phase_bf16_cheb_pmg_block_routes(hist, v2_solve_ms)
        phase_service(hist, smi_line, solve_rounds)
        phase_bf16_times(bw, rows)
        phase_bf16_slice12_times(bw, rows)
        phase_profile(cases, pcg, routes, slice4, ir, slice12)
        err.update(phase_lm_parity())
        err["MoE"] = phase_moe_parity()
        served = phase_serve()
        lm_rows = phase_lm_times(bw)
    except CheckFailed as exc:
        print(f"FAILED: {exc}", flush=True)
        return 1
    print(f"== whole script: {time.perf_counter() - t_start:.1f} s "
          f"({smi_line})", flush=True)

    meta = {
        "K1": ("nekbone_ax", "src/repro_torch/kernels/csrc/nekbone_ax.cu",
               "src/repro/kernels/nekbone_ax.py:240", "pallas"),
        "K4": ("nekbone_ax_slab",
               "src/repro_torch/kernels/csrc/nekbone_ax_slab.cu",
               "src/repro/kernels/nekbone_ax.py:476", "pallas_fused_cg_v2"),
        "K5": ("nekbone_cg_update",
               "src/repro_torch/kernels/csrc/nekbone_cg_update.cu",
               "src/repro/kernels/nekbone_ax.py:625", "pallas_fused_cg_v2"),
        "K10": ("nekbone_pcg_update",
                "src/repro_torch/kernels/csrc/nekbone_pcg_update.cu",
                "src/repro/kernels/nekbone_ax.py:1322", "jacobi"),
        "K11": ("nekbone_cheb_apply",
                "src/repro_torch/kernels/csrc/nekbone_cheb_apply.cu",
                "src/repro/kernels/nekbone_ax.py:1434", "cheb"),
        "K12": ("nekbone_interp",
                "src/repro_torch/kernels/csrc/nekbone_interp.cu",
                "src/repro/kernels/nekbone_ax.py:1596", "pmg"),
        "K6": ("nekbone_ax_slab_block",
               "src/repro_torch/kernels/csrc/nekbone_ax_slab_block.cu",
               "src/repro/kernels/nekbone_ax.py:741", "block"),
        "K7": ("nekbone_cg_update_block",
               "src/repro_torch/kernels/csrc/nekbone_cg_update_block.cu",
               "src/repro/kernels/nekbone_ax.py:859", "block"),
        # K2 has no route: its launches on the v1 route are 0
        "K2": ("nekbone_ax_dots",
               "src/repro_torch/kernels/csrc/nekbone_ax_dots.cu",
               "src/repro/kernels/nekbone_ax.py:305", "v1"),
        "K3": ("nekbone_ax_pap",
               "src/repro_torch/kernels/csrc/nekbone_ax_dots.cu",
               "src/repro/kernels/nekbone_ax.py:404", "v1"),
        "K8": ("nekbone_ax_powers",
               "src/repro_torch/kernels/csrc/nekbone_ax_powers.cu",
               "src/repro/kernels/nekbone_ax.py:1026", f"sstep{SSTEP_S}"),
        "K9": ("nekbone_sstep_update",
               "src/repro_torch/kernels/csrc/nekbone_sstep_update.cu",
               "src/repro/kernels/nekbone_ax.py:1198", f"sstep{SSTEP_S}"),
    }
    kernels = []
    for key, (kname, source, replaces, route) in meta.items():
        row = rows[(key, PAPER_GRID)]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[route].of(f"{kname}_f64"),
            "max_abs_err": err[key], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms")})
    for mix in BF16_MIXES:
        for key, kname, cu, line, variant in (
                ("K4", "nekbone_ax_slab", "nekbone_ax_slab.cu", 476, "v2"),
                ("K5", "nekbone_cg_update", "nekbone_cg_update.cu", 625,
                 "v2"),
                ("K3", "nekbone_ax_pap", "nekbone_ax_dots.cu", 404, "v1"),
                ("K8", "nekbone_ax_powers", "nekbone_ax_powers.cu", 1026,
                 "sstep"),
                ("K9", "nekbone_sstep_update", "nekbone_sstep_update.cu",
                 1198, "sstep"),
                ("K10", "nekbone_pcg_update", "nekbone_pcg_update.cu", 1322,
                 "jacobi")):
            row = rows[(f"{key} {mix}", PAPER_GRID)]
            kernels.append({
                "name": f"{kname}_{mix}", "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{cu}",
                "replaces": f"src/repro/kernels/nekbone_ax.py:{line}",
                "launches": ir["launches"][f"{mix} {variant}"].of(
                    f"{kname}_{mix}"),
                "max_abs_err": err[(key, mix)], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row.get("library_ms")})
    for mix in BF16_MIXES:
        for key, kname, cu, line, route in (
                ("K11", "nekbone_cheb_apply", "nekbone_cheb_apply.cu", 1434,
                 "cheb"),
                ("K12", "nekbone_interp", "nekbone_interp.cu", 1596, "pmg"),
                ("K6", "nekbone_ax_slab_block", "nekbone_ax_slab_block.cu",
                 741, "block"),
                ("K7", "nekbone_cg_update_block",
                 "nekbone_cg_update_block.cu", 859, "block")):
            row = rows[(f"{key} {mix}", PAPER_GRID)]
            kernels.append({
                "name": f"{kname}_{mix}", "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{cu}",
                "replaces": f"src/repro/kernels/nekbone_ax.py:{line}",
                "launches": slice12["launches"][f"{mix} {route}"].of(
                    f"{kname}_{mix}"),
                "max_abs_err": err[(key, mix)], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row.get("library_ms")})
    # the f32 builds: K4, K5 and K3 from the f32_ir v2 and v1 routes, K8
    # and K9 from f32_ir over s-step, K6 and K7 from f32 block CG
    for key, kname, cu, line, run in (
            ("K4", "nekbone_ax_slab", "nekbone_ax_slab.cu", 476,
             ir["launches"]["f32_ir v2"]),
            ("K5", "nekbone_cg_update", "nekbone_cg_update.cu", 625,
             ir["launches"]["f32_ir v2"]),
            ("K3", "nekbone_ax_pap", "nekbone_ax_dots.cu", 404,
             ir["launches"]["f32_ir v1"]),
            ("K8", "nekbone_ax_powers", "nekbone_ax_powers.cu", 1026,
             ir["launches"]["f32_ir sstep"]),
            ("K9", "nekbone_sstep_update", "nekbone_sstep_update.cu", 1198,
             ir["launches"]["f32_ir sstep"]),
            ("K6", "nekbone_ax_slab_block", "nekbone_ax_slab_block.cu", 741,
             slice12["launches"]["f32 block"]),
            ("K7", "nekbone_cg_update_block", "nekbone_cg_update_block.cu",
             859, slice12["launches"]["f32 block"])):
        row = rows[(f"{key} f32", PAPER_GRID)]
        kernels.append({
            "name": f"{kname}_f32", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{cu}",
            "replaces": f"src/repro/kernels/nekbone_ax.py:{line}",
            "launches": run.of(f"{kname}_f32"),
            "max_abs_err": err[(key, "f32")], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms")})
    # K1 and K2 in bf16: K1's bf16 build from the bf16 reference route (100
    # launches); K1's bf16_ir build and K2's from the bf16 and bf16_ir v1
    # routes (no route runs them, as in the reference: the ir route's K1
    # is the fp64 build)
    for mix in BF16_MIXES:
        for key, kname, cu, line, label in (
                ("K1", "nekbone_ax", "nekbone_ax.cu", 240,
                 "bf16 reference" if mix == "bf16" else f"{mix} v1"),
                ("K2", "nekbone_ax_dots", "nekbone_ax_dots.cu", 305,
                 f"{mix} v1")):
            row = rows[(f"{key} {mix}", PAPER_GRID)]
            kernels.append({
                "name": f"{kname}_{mix}", "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{cu}",
                "replaces": f"src/repro/kernels/nekbone_ax.py:{line}",
                "launches": ir["launches"][label].of(f"{kname}_{mix}"),
                "max_abs_err": err[(key, mix)], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row.get("library_ms")})
    flash = ("src/repro_torch/kernels/csrc/flash_attn.cu",
             "src/repro/kernels/flash_attn.py:32")
    # each K13 row is one layer kind of a served model, with its own launches
    lm = (("K13 global", "flash_attn", *flash, "gemma2-27b",
           "flash_attn_bf16_d128", err["K13"]),
          ("K13 window 4096", "flash_attn_window4096", *flash, "gemma2-27b",
           "flash_attn_bf16_d128_window4096", err["K13"]),
          ("K13 d=192 global", "flash_attn_d192", *flash, "nemotron-4-340b",
           "flash_attn_bf16_d192", None),
          ("K13 d=64 global", "flash_attn_d64", *flash, "hymba-1.5b",
           "flash_attn_bf16_d64", None),
          ("K13 d=64 window 1024", "flash_attn_d64_window1024", *flash,
           "hymba-1.5b", "flash_attn_bf16_d64_window1024", None),
          ("K14 prefill T=1024", "wkv6",
           "src/repro_torch/kernels/csrc/wkv6.cu",
           "src/repro/kernels/wkv6.py:89", "rwkv6-1.6b", "wkv6_bf16",
           err["K14"]))
    # qwen3-moe, arctic, qwen2.5, codeqwen, llava and whisper: one row per
    # model and layer kind, named by the build and the model (whisper's
    # encoder, cross-attention and decoder self-attention each their own)
    for arch in ("qwen3-moe-30b-a3b", "arctic-480b", "qwen2.5-14b",
                 "codeqwen1.5-7b", "llava-next-mistral-7b"):
        lm += ((f"K13 {arch}", f"flash_attn_d128@{arch}", *flash, arch,
                "flash_attn_bf16_d128", None),)
    lm += (("K13 whisper decoder", "flash_attn_d64@whisper-large-v3",
            *flash, "whisper-large-v3", "flash_attn_bf16_d64", None),
           ("K13 whisper encoder",
            "flash_attn_d64_noncausal@whisper-large-v3", *flash,
            "whisper-large-v3", "flash_attn_bf16_d64_noncausal", None),
           ("K13 whisper cross",
            "flash_attn_d64_noncausal_cross@whisper-large-v3", *flash,
            "whisper-large-v3", "flash_attn_bf16_d64_noncausal_cross", None))
    for key, kname, source, replaces, arch, build, max_err in lm:
        row = lm_rows[key]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": served["launches"][arch].of(build),
            "max_abs_err": (max_err if max_err is not None
                            else row["max_abs_err"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
