#!/usr/bin/env python3
"""K11 and K14 beside the versions they replaced, on one NVIDIA card.

Run from the root of a checkout, with the earlier kernels' sources beside
it (a ``git archive`` of the commit before the redesign, unpacked into a
directory that ``.gitignore`` lists)::

    mkdir -p build/parent
    git archive 421402e src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 scripts/k11_k14_compare.py --parent build/parent

It builds the port's ``nekbone_cheb_apply`` (f64, f32) and ``wkv6`` (f32,
bf16) libraries, and the earlier ``nekbone_cheb_apply.cu`` (a chain of
k + 1 launches, f64) and ``wkv6.cu`` (one 64-thread block per head, bf16)
from ``--parent`` into ``build/k11_k14_parent/``, then:

* K11: prints the launch plan at E = 1024 and 4096 (fp64, n = 10) and
  1024 (f32, n = 10), runs both kernels on ``chip_smoke.py``'s K11 inputs
  (the paper grid, fp64, n = 10, k = 1, 2, 4: the first case of its
  K10/K11 parity phase) and on E = 4096, shows whether their z and rtz
  agree bitwise, prints each one's max abs error against the plain
  version, and times both at k = 4 in turns (earlier, new, new, earlier);
* K14: builds the tilings of ``K14_CANDIDATES`` in an edited copy of
  ``wkv6.cu``, holds each against the plain version with
  ``chip_smoke.py``'s checks (bf16, rwkv6-1.6b's heads at T = 1024 and
  T = 1; d = 16 on 128 heads) and times each beside the earlier kernel, at
  prefill (T = 1024; tilings of one step per pass left out) and one decode
  step: the measurement that picked kernels/wkv6.py's tilings;
* serve: rwkv6-1.6b (24 layers, batch 4, prompt 1024, 32 new tokens,
  weights from seed 0, greedy) through ``launch.serve.serve`` with K14,
  with the earlier kernel in its place and with the plain version, and
  shows where the greedy tokens differ and how close the two largest
  logits were there;
* SASS: builds K1, K4, K5, K6 and K8 (f64) from ``--parent`` and from the
  tree and shows whether ``cuobjdump -sass`` gives each the same
  instructions (the tree's ``common.cuh`` helpers that they share).
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

OUT = ROOT / "build/k11_k14_parent"
_P, _I = ctypes.c_void_p, ctypes.c_int


def build_parent(parent: pathlib.Path) -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import _build

    csrc = parent / "src/repro_torch/kernels/csrc"
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem, dtype in (("nekbone_cheb_apply", "F64"), ("wkv6", "BF16")):
        so = OUT / f"{stem}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS,
               f"-DNEKBONE_REAL_{dtype}", "-o", str(so),
               str(csrc / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for stem, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on the earlier {stem}:\n{log}")
        libs[stem] = ctypes.CDLL(str(so))
    fn = libs["nekbone_cheb_apply"].nekbone_cheb_apply_f64
    fn.argtypes, fn.restype = [_P] * 16 + [_I] * 5 + [_P], ctypes.c_int
    fn = libs["wkv6"].wkv6_bf16
    fn.argtypes, fn.restype = [_P] * 8 + [_I] * 4 + [_P], ctypes.c_int  # earlier ABI
    return libs


def chain_k11(lib, r2, D, g3, mx, my, mz, cx, cy, cz, coef, *, n, k):
    """The earlier K11: k + 1 launches on the current stream."""
    import torch

    E = r2.shape[0]
    z = torch.empty_like(r2)
    scratch = torch.empty(4, E, n ** 3, dtype=r2.dtype, device=r2.device)
    rtz = torch.empty(E, dtype=r2.dtype, device=r2.device)
    err = lib.nekbone_cheb_apply_f64(
        *(t.data_ptr() for t in (r2, D, g3, mx, my, mz, cx, cy, cz, coef, z,
                                 *scratch, rtz)),
        mx.shape[0], my.shape[0], mz.shape[0], n, k,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier K11: CUDA error {err}")
    return z, rtz


def parent_k14(lib, r, k, v, w, u, s0):
    import torch

    B, H, T, d = r.shape
    o = torch.empty_like(r)
    state = torch.empty((B, H, d, d), dtype=torch.float32, device=r.device)
    err = lib.wkv6_bf16(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        0 if s0 is None else s0.data_ptr(), o.data_ptr(), state.data_ptr(),
        B, H, T, d, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier K14: CUDA error {err}")
    return o, state


def compare_serve(lib) -> None:
    """rwkv6-1.6b served three times: with K14, with the earlier kernel in
    its place, and with the plain version (kernels/ref.py, on the card).
    Greedy tokens of random weights can differ where two logits nearly tie:
    for each pair, the first step where a row's token differs, the gap
    between that row's two largest logits there, and the largest logit
    difference over the steps before it (the same context on both sides)."""
    import torch

    from repro_torch.configs import get
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as WK
    from repro_torch.launch.serve import serve

    print("== rwkv6-1.6b served with K14, with the earlier kernel and with "
          "the plain version (24 layers, batch 4, prompt 1024, 32 new, seed "
          "0)", flush=True)
    cfg = get("rwkv6-1.6b")

    def earlier(r, k, v, w, u, *, initial_state=None):
        if r.dtype != torch.bfloat16:
            raise TypeError("the earlier K14 is built here in bf16 only")
        s0 = None if initial_state is None else initial_state.contiguous()
        return parent_k14(lib, *(t.contiguous() for t in (r, k, v, w, u)),
                          s0)

    def plain(r, k, v, w, u, *, initial_state=None):
        return ref.wkv6_ref(r, k, v, w, u, initial_state=initial_state,
                            return_state=True)

    built = WK.wkv6_cuda
    runs = {}
    for name, fn in (("K14", built), ("earlier", earlier), ("plain", plain)):
        WK.wkv6_cuda = fn
        try:
            runs[name] = serve(cfg, batch=4, prompt_len=1024, gen=32, seed=0)
        finally:
            WK.wkv6_cuda = built
    for a, b in (("K14", "earlier"), ("K14", "plain"), ("earlier", "plain")):
        (ta, sa), (tb, sb) = runs[a], runs[b]
        same = ta == tb
        first = [int((~row).nonzero()[0]) if not bool(row.all()) else None
                 for row in same]
        print(f"  {a} vs {b}: {int(same.sum())} of {same.numel()} tokens "
              f"the same; first differing step by row {first}", flush=True)
        for row, step in enumerate(first):
            if step is None:
                continue
            la, lb = sa["logits"][row, step], sb["logits"][row, step]
            top_a = la.topk(2).values
            top_b = lb.topk(2).values
            before = float((sa["logits"][row, :step + 1]
                            - sb["logits"][row, :step + 1]).abs().max())
            print(f"    row {row}, step {step}: top-2 logits {a} "
                  f"{top_a.tolist()}, {b} {top_b.tolist()}; max |logit "
                  f"difference| up to this step {before:.3e}", flush=True)


SASS_STEMS = ("nekbone_ax", "nekbone_ax_slab", "nekbone_cg_update",
              "nekbone_ax_slab_block", "nekbone_ax_powers")


def compare_sass(parent: pathlib.Path) -> None:
    from repro_torch.kernels import _build

    print("== SASS of the kernels that share common.cuh, beside the earlier "
          "build (f64)", flush=True)
    procs = {}
    for stem in SASS_STEMS:
        for side, csrc in (("earlier", parent / "src/repro_torch/kernels/csrc"),
                           ("tree", _build.CSRC)):
            so = OUT / f"sass_{side}_{stem}.so"
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS,
                   "-DNEKBONE_REAL_F64", "-o", str(so), str(csrc / f"{stem}.cu")]
            procs[(stem, side)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    built = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {key}:\n{log[-3000:]}")
        built[key] = _sass(so)
    for stem in SASS_STEMS:
        old, new = built[(stem, "earlier")], built[(stem, "tree")]
        same = old.keys() == new.keys() and all(old[f] == new[f] for f in old)
        print(f"  {stem}: {len(old)} functions, {sum(map(len, old.values()))} "
              f"instructions; the same SASS: {same}", flush=True)


def compare_k11(lib, smi):
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import nekbone_ax as K

    print(f"== K11: one cooperative launch beside the chain ({smi})",
          flush=True)
    for E, grid, dtype in ((1024, cs.PAPER_GRID, torch.float64),
                           (4096, cs.BIG_GRID, torch.float64),
                           (1024, cs.PAPER_GRID, torch.float32)):
        plan, info = K.nekbone_cheb_apply_plan(
            E, 10, "f64" if dtype == torch.float64 else "f32")
        print(f"  plan E={E} {dtype}: {plan.variant} variant, grid "
              f"{plan.grid}, {plan.per_block} elements per block, "
              f"{plan.blocks_per_sm} blocks per SM, {plan.smem_bytes} bytes "
              f"dynamic + {info['static_smem']} static shared, "
              f"{info['registers']} registers, {info['slices']} elements "
              f"side by side, {info['sm_count']} SMs",
              flush=True)
    rng = np.random.default_rng(3)
    n = 10
    for grid in (cs.PAPER_GRID, cs.BIG_GRID):
        case = NekboneCase(n=n, grid=grid, dtype=torch.float64)
        o = cs._pcg_operands(case, rng)
        E = case.mesh.nelt
        for k in (1, 2, 4):
            args = (o["z"], o["D"], o["g3"], *o["m"], *o["c"], o["coef"][k])
            nz, nrtz = K.nekbone_cheb_apply_cuda(*args, n=n, k=k)
            cz, crtz = chain_k11(lib, *args, n=n, k=k)
            pz, _ = K.nekbone_cheb_apply_plain(*args, n=n, k=k)
            reps = [K.nekbone_cheb_apply_cuda(*args, n=n, k=k)
                    for _ in range(5)]
            torch.cuda.synchronize()
            same = all(torch.equal(z, nz) and torch.equal(t, nrtz)
                       for z, t in reps)
            print(f"  E={E} k={k}: z bitwise the chain's "
                  f"{torch.equal(nz, cz)}, rtz {torch.equal(nrtz, crtz)}; "
                  f"max abs err vs plain: new "
                  f"{float((nz - pz).abs().max()):.6e}, chain "
                  f"{float((cz - pz).abs().max()):.6e}; 5 repeats bitwise "
                  f"{same}", flush=True)
        args = (o["z"], o["D"], o["g3"], *o["m"], *o["c"], o["coef"][4])
        fns = {"chain": lambda: chain_k11(lib, *args, n=n, k=4),
               "new": lambda: K.nekbone_cheb_apply_cuda(*args, n=n, k=4)}
        times = [(label, cs.device_ms(fns[label]) * 1e3)
                 for label in ("chain", "new", "new", "chain")]
        print(f"  E={E} k=4 us, in turns: "
              + ", ".join(f"{lb} {t:.1f}" for lb, t in times), flush=True)
        del o
        torch.cuda.empty_cache()


# K14 tilings (d, column tile, row groups, columns per thread, steps per
# pass) measured in an edited copy of csrc/wkv6.cu; the wrapper's
# (kernels/wkv6.py TILES, DECODE_TILES) are among them
K14_CANDIDATES = ((64, 32, 8, 2, 32), (64, 32, 16, 2, 32), (64, 16, 8, 2, 32),
                  (64, 32, 4, 1, 32), (64, 32, 16, 2, 1), (64, 32, 8, 2, 1),
                  (64, 16, 16, 1, 1), (16, 16, 4, 1, 32), (16, 16, 8, 1, 32),
                  (16, 16, 8, 1, 1), (16, 16, 4, 1, 1))


def build_k14_candidates() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    src = (_build.CSRC / "wkv6.cu").read_text()
    cut = src[src.index("#define WKV6_FOR_EACH_TILING(X)"):
              src.index("template <typename T>\nint dispatch(")]
    src = src.replace(cut, "#define WKV6_FOR_EACH_TILING(X) " + " ".join(
        f"X({', '.join(map(str, t))})" for t in K14_CANDIDATES) + "\n\n")
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / "wkv6_candidates.cu"
    cu.write_text(src)
    so = cu.with_suffix(".so")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                           "-DNEKBONE_REAL_BF16", "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on the K14 candidates:\n"
                         f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(so))
    lib.wkv6_bf16.argtypes = [_P] * 8 + [_I] * 8 + [_P]
    lib.wkv6_bf16.restype = ctypes.c_int
    return lib


def candidate_k14(lib, tiles, r, k, v, w, u, s0):
    import torch

    B, H, T, d = r.shape
    o = torch.empty_like(r)
    state = torch.empty((B, H, d, d), dtype=torch.float32, device=r.device)
    err = lib.wkv6_bf16(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        0 if s0 is None else s0.data_ptr(), o.data_ptr(), state.data_ptr(),
        B, H, T, d, *tiles, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K14 tiling {tiles}: CUDA error {err}")
    return o, state


def compare_k14(lib, smi):
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as WK

    print(f"== K14: candidate tilings beside the one-block-per-head kernel "
          f"({smi}); bf16; * marks the wrapper's", flush=True)
    cand = build_k14_candidates()
    gen = torch.Generator("cuda").manual_seed(7)
    for d, H in ((64, 32), (16, 128)):
        for label, T, state in (("prefill T=1024", 1024, False),
                                ("decode T=1", 1, True)):
            r, k, v, w, u, s0 = cs._k14_inputs(gen, 4, H, T, d,
                                               torch.bfloat16, state)
            po, ps = ref.wkv6_ref(r, k, v, w, u, initial_state=s0,
                                  return_state=True)
            calls = 10 if T > 1 else 50
            flops = 4 * d * d * 4 * H * T
            wrapper = (WK.DECODE_TILES if T == 1 else WK.TILES)[d]
            row = []
            if d == 64:
                ms = cs.device_ms(lambda: parent_k14(lib, r, k, v, w, u, s0),
                                  calls=calls, reps=3, warmup=1)
                row.append(f"one block per head {ms * 1e3:.1f}")
            for dd, *tiles in K14_CANDIDATES:
                if dd != d or (T > 1 and tiles[-1] == 1):
                    continue
                o, s = candidate_k14(cand, tiles, r, k, v, w, u, s0)
                torch.cuda.synchronize()
                oe, se = cs._max_rel(o, po), cs._max_rel(s, ps)
                val = cs._value_rel(o, po, cs.K14_O_TOL["float32"])
                ok = (oe <= cs.K14_O_TOL["bfloat16"] and se <= cs.K14_S_TOL
                      and val <= 1.0)
                ms = cs.device_ms(
                    lambda: candidate_k14(cand, tiles, r, k, v, w, u, s0),
                    calls=calls, reps=3, warmup=1)
                mark = "*" if tuple(tiles) == wrapper else ""
                row.append(f"{mark}C, G, CPT, steps {tuple(tiles)} "
                           f"{ms * 1e3:.1f} ({flops / ms / 1e9:.1f} TF/s, "
                           f"checks {'pass' if ok else 'FAIL'}: o {oe:.1e}, "
                           f"state {se:.1e}, value {val:.2f})")
            print(f"  d={d} B=4 H={H} {label}, us: " + "; ".join(row),
                  flush=True)
            del r, k, v, w, u, s0, po, ps
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True,
                    help="a checkout (or archive) of the commit before the "
                         "redesign")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k11_k14_compare.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    # only the two libraries this script needs
    _build.SOURCES = {"nekbone_cheb_apply": ("f64", "f32"),
                      "wkv6": ("f32", "bf16")}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    import chip_smoke as cs

    for name, path in _build.build_all().items():
        report = cs._ptxas_report(path.with_suffix(".log").read_text())
        print(f"  {name}: (registers, spill store bytes) "
              + str({key: v for key, v in report.items()
                     if "<10," in key or name.startswith("wkv6")}),
              flush=True)
    libs = build_parent(args.parent.resolve())
    compare_k11(libs["nekbone_cheb_apply"], smi)
    compare_k14(libs["wkv6"], smi)
    compare_serve(libs["wkv6"])
    compare_sass(args.parent.resolve())
    return 0


if __name__ == "__main__":
    sys.exit(main())
