#!/usr/bin/env python3
"""Where K11's and K14's time goes: ablations on one NVIDIA card.

Run from the root of a checkout:

    python3 scripts/k11_k14_ablation.py

Like ``scripts/k13_ablation.py``, it copies
``src/repro_torch/kernels/csrc/nekbone_cheb_apply.cu`` (f64, n = 10 only)
and ``wkv6.cu`` (bf16, the tilings named below only), edits each copy into
one variant, builds the variants with ``nvcc`` in parallel (into
``build/k11_k14_ablation/``), prints their registers and spills, and times
each at the main path's shapes: K11 at the paper grid (E = 1024, fp64,
n = 10, k = 4) with the launch plan of the port's wrapper; K14 at
rwkv6-1.6b's prefill (batch 4, 32 heads, T = 1024, d = 64, bf16).  A
variant that computes another function says so; only ``built`` is held
against the plain version.

K11 variants: ``built``; ``state in device memory`` (the built kernel's
device-memory variant at E = 1024); ``no grid sync`` (the k barriers
dropped); ``no operator`` (A_loc replaced by the identity on the column,
in every application);
``no assembly`` (each node's own copy in place of the gather-scatter sum).

K14 variants, at two tilings (column tile, row groups, columns per
thread, steps per pass): ``built``; ``no state update`` (S held fixed, so only r S is
formed); ``no group sums`` (the bonus and the sum over groups dropped: o is
group 0's partial); ``no staging loads`` (each pass stores the registers of
the first pass again: no device-memory reads after the first).
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "src/repro_torch/kernels/csrc"
OUT = ROOT / "build/k11_k14_ablation"
K14_TILES = ((32, 8, 2, 32), (32, 16, 2, 32))
_P, _I = ctypes.c_void_p, ctypes.c_int


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"k11_k14_ablation: the source no longer holds "
                         f"{old!r}")
    return src.replace(old, new)


def k11_variants(src: str) -> dict[str, str]:
    src = _edit(src, "    NEKBONE_FOR_EACH_N(NEKBONE_CASE)",
                "    NEKBONE_CASE(10)")
    return {
        "built": src,
        "no grid sync": _edit(src, "    grid.sync();", "    (void)grid;"),
        "no operator": _edit(
            src, "  ax_diag_columns(sh, a.g3 + e * 3 * N3 + tid, "
                 "SharedColumn<N, T>{col}, wc,\n                  i, j);",
            "#pragma unroll\n  for (int k = 0; k < N; ++k) wc[k] = "
            "col[k * N2];"),
        "no assembly": _edit(
            src, "sum_xyz_cg<N>(ad_in, nd.e, k, j, i, nd.ix, nd.iy, nd.iz,\n"
                 "                                 a.ex, a.ey, a.ez)",
            "ld_cg(true, ad_in + nd.e * (N * N * N) + (k * N + j) * N + i)"),
    }


K14_FMA = """          out[b] = fmaf(rr[a], S[a][b], out[b]);
          S[a][b] = fmaf(ww[a], S[a][b], kk[a] * vj[b]);"""
K14_BONUS = "    // the bonus's group partials, one (step, group) pair per thread"
K14_SUM = """      float acc = sh.part[0][t][cc];
      float b = sh.bpart[0][t];
#pragma unroll
      for (int gg = 1; gg < G; ++gg) {
        acc += sh.part[gg][t][cc];
        b += sh.bpart[gg][t];
      }
      acc = fmaf(b, sh.v[t][cc], acc);"""
K14_PREFETCH = """    if (t0 + KC < T_len)  // the next pass's loads fly while this one runs
      stage.load("""


def k14_variants(src: str) -> dict[str, str]:
    cut = src[src.index("#define WKV6_FOR_EACH_TILING(X)"):
              src.index("template <typename T>\nint dispatch(")]
    src = src.replace(cut, "#define WKV6_FOR_EACH_TILING(X) " + " ".join(
        f"X(64, {', '.join(map(str, tiles))})" for tiles in K14_TILES)
        + "\n\n")
    bonus_end = src.index("    __syncthreads();", src.index(K14_BONUS))
    no_sums = src[:src.index(K14_BONUS)] + src[bonus_end:]
    no_sums = _edit(no_sums, K14_SUM, "      float acc = sh.part[0][t][cc];")
    return {
        "built": src,
        "no state update": _edit(src, K14_FMA,
                                 "          out[b] = fmaf(rr[a], S[a][b], "
                                 "out[b]);"),
        "no group sums": no_sums,
        "no staging loads": _edit(src, K14_PREFETCH,
                                  "    if (false)\n      stage.load("),
    }


def build(stem: str, dtype: str, srcs: dict[str, str]) -> dict:
    import chip_smoke as C
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(srcs.items()):
        cu = OUT / f"{stem}_v{i}.cu"
        cu.write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS,
               f"-DNEKBONE_REAL_{dtype}", "-I", str(CSRC), "-o",
               str(cu.with_suffix(".so")), str(cu)]
        procs[name] = (cu, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (cu, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {stem} {name}:\n{log[-3000:]}")
        report = C._ptxas_report(log)
        print(f"  {stem} {name}: " + "; ".join(
            f"{key} {regs} registers, {spill} bytes spilled"
            for key, (regs, spill) in sorted(report.items())), flush=True)
        libs[name] = ctypes.CDLL(str(cu.with_suffix(".so")))
    return libs


def k11_run(lib, o, plan, *, n, k, resident):
    import torch

    fn = lib.nekbone_cheb_apply_f64
    fn.argtypes, fn.restype = [_P] * 16 + [_I] * 8 + [_P], ctypes.c_int
    r2 = o["z"]
    E = r2.shape[0]
    z = torch.empty_like(r2)
    scratch = torch.empty(4, E, n ** 3, dtype=r2.dtype, device=r2.device)
    rtz = torch.empty(E, dtype=r2.dtype, device=r2.device)
    mx, my, mz = o["m"]
    err = fn(*(t.data_ptr() for t in (r2, o["D"], o["g3"], mx, my, mz,
                                      *o["c"], o["coef"][k], z)),
             *((0, 0) if resident else (scratch[2].data_ptr(),
                                        scratch[3].data_ptr())),
             scratch[0].data_ptr(), scratch[1].data_ptr(), rtz.data_ptr(),
             mx.shape[0], my.shape[0], mz.shape[0], n, k, int(resident),
             plan.per_block, plan.grid,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K11 variant: CUDA error {err}")
    return z


def ablate_k11():
    import numpy as np
    import torch

    import chip_smoke as C
    from repro_torch.core.nekbone import NekboneCase
    from repro_torch.kernels import nekbone_ax as K

    libs = build("nekbone_cheb_apply", "F64",
                 k11_variants((CSRC / "nekbone_cheb_apply.cu").read_text()))
    n, k = 10, C.CHEB_K
    case = NekboneCase(n=n, grid=C.PAPER_GRID, dtype=torch.float64)
    o = C._pcg_operands(case, np.random.default_rng(3))
    args = (o["z"], o["D"], o["g3"], *o["m"], *o["c"], o["coef"][k])
    plan, _ = K.nekbone_cheb_apply_plan(case.mesh.nelt, n, "f64")
    want, _ = K.nekbone_cheb_apply_plain(*args, n=n, k=k)
    runs = {name: (lib, plan, plan.resident) for name, lib in libs.items()}
    # the device-memory variant of the built kernel on the same E
    runs["state in device memory"] = (libs["built"], K.CoopPlan(
        False, plan.per_block, plan.grid, plan.blocks_per_sm, 0), False)
    for name, (lib, p, resident) in runs.items():
        z = k11_run(lib, o, p, n=n, k=k, resident=resident)
        torch.cuda.synchronize()
        err = C.rel_err(z, want)
        us = C.device_ms(lambda: k11_run(lib, o, p, n=n, k=k,
                                         resident=resident)) * 1e3
        print(f"  K11 E={case.mesh.nelt} k={k}, {name}: {us:.1f} us; z max "
              f"rel err vs plain {err:.2e}", flush=True)


def ablate_k14():
    import torch

    import chip_smoke as C
    from repro_torch.kernels import ref

    libs = build("wkv6", "BF16", k14_variants((CSRC / "wkv6.cu").read_text()))
    gen = torch.Generator("cuda").manual_seed(7)
    H, d, T = C.RWKV_HEADS["H"], C.RWKV_HEADS["d"], 1024
    r, k, v, w, u, _ = C._k14_inputs(gen, 4, H, T, d, torch.bfloat16, False)
    want = ref.wkv6_ref(r, k, v, w, u)
    flops = 4 * d * d * 4 * H * T

    def run(lib, tiles):
        fn = lib.wkv6_bf16
        fn.argtypes, fn.restype = [_P] * 8 + [_I] * 8 + [_P], ctypes.c_int
        o = torch.empty_like(r)
        state = torch.empty((4, H, d, d), dtype=torch.float32,
                            device=r.device)
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), 0, o.data_ptr(), state.data_ptr(), 4, H, T, d,
                 *tiles, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"K14 variant: CUDA error {err}")
        return o

    for tiles in K14_TILES:
        for name, lib in libs.items():
            o = run(lib, tiles)
            torch.cuda.synchronize()
            err = C._max_rel(o, want)
            us = C.device_ms(lambda: run(lib, tiles), calls=10, reps=3,
                             warmup=1) * 1e3
            print(f"  K14 bf16 prefill B=4 H={H} T={T}, tiles {tiles}, "
                  f"{name}: {us:.1f} us ({flops / us / 1e6:.1f} TF/s); o max "
                  f"rel err vs plain {err:.2e}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k11_k14_ablation.py: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"== K11 and K14 ablations on {smi}", flush=True)
    from repro_torch.kernels import _build

    # only K11's library (its plan's occupancy query) is built from the tree
    _build.SOURCES = {"nekbone_cheb_apply": ("f64",)}
    ablate_k11()
    ablate_k14()
    return 0


if __name__ == "__main__":
    sys.exit(main())
