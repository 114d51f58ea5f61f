#!/usr/bin/env python3
"""Ablations of K13's bf16 build (the tensor-core kernel) on one NVIDIA card.

Run from the root of a checkout:

    python3 scripts/k13_ablation.py

It copies ``src/repro_torch/kernels/csrc/flash_attn.cu``, edits each copy
into one variant, builds the variants with ``nvcc`` in parallel (into
``build/k13_ablation/``), prints each one's registers and spills, and
times each at gemma2-27b's serve shape (batch 2, 32 query heads over 16 kv
heads, 6144 tokens, d = 128, causal, softcap 50; the global layer, the
window-4096 layer, and the global layer without softcap) beside SDPA,
holding each against the plain version with ``chip_smoke.py``'s bf16
value check.  The variants:

* ``built``: the source as it is;
* ``bounds unstated``: ``__launch_bounds__`` without the two blocks per
  SM, so ptxas picks its own register budget;
* ``P once``: P rounded once to bf16 (the p_lo MMAs dropped): fails the
  value check, by design;
* ``no softmax``: scores times 1e-3 in place of the softmax (a wrong
  function; the time of the MMAs and the tile loads alone);
* ``no softmax, P once``: both;
* ``32-key tiles`` and ``8 warps`` (128 query rows a block): other tile
  shapes of the same function.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SRC = ROOT / "src/repro_torch/kernels/csrc/flash_attn.cu"
OUT = ROOT / "build/k13_ablation"

BOUNDS = "__launch_bounds__(kThreads, kMinBlocks<D>)\nflash_attn_tc_kernel"
P_LO = """        mma(acc[j], pl, bv[0], bv[1]);
        mma(acc[j + 1], pl, bv[2], bv[3]);
"""
SOFTMAX = ("    // the online softmax", "    // O += (P_hi")
NO_SOFTMAX = """#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= 1e-3f;
        l[e >> 1] += s[j][e];
      }
"""
WARPS = "constexpr int kWarps = 4;\nconstexpr int kThreads = kWarps * 32;"


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"k13_ablation: the source no longer holds {old!r}")
    return src.replace(old, new)


def variants(src: str) -> dict[str, str]:
    cut = src[src.index(SOFTMAX[0]):src.index(SOFTMAX[1])]
    no_softmax = _edit(src, cut, NO_SOFTMAX)
    return {
        "built": src,
        "bounds unstated": _edit(src, BOUNDS, BOUNDS.replace(
            ", kMinBlocks<D>", "")),
        "P once": _edit(src, P_LO, ""),
        "no softmax": no_softmax,
        "no softmax, P once": _edit(no_softmax, P_LO, ""),
        "32-key tiles": _edit(src, "constexpr int kBK = 64;",
                              "constexpr int kBK = 32;"),
        "8 warps": _edit(_edit(src, WARPS, WARPS.replace("4", "8")),
                         "constexpr int kMinBlocks = D <= 128 ? 2 : 1;",
                         "constexpr int kMinBlocks = 1;"),
    }


def build(srcs: dict[str, str]) -> dict[str, ctypes.CDLL]:
    import chip_smoke as C
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import _ARGTYPES

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(srcs.items()):
        cu = OUT / f"v{i}.cu"
        cu.write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-DNEKBONE_REAL_BF16",
               "-I", str(_build.CSRC), "-o", str(cu.with_suffix(".so")),
               str(cu)]
        procs[name] = (cu, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (cu, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log[-3000:]}")
        report = C._ptxas_report(log)
        print(f"  {name}: " + "; ".join(
            f"{key} {regs} registers, {spill} bytes spilled"
            for key, (regs, spill) in sorted(report.items())), flush=True)
        lib = ctypes.CDLL(str(cu.with_suffix(".so")))
        lib.flash_attn_bf16.argtypes = _ARGTYPES
        lib.flash_attn_bf16.restype = ctypes.c_int
        libs[name] = lib
    return libs


def run(lib, q, k, v, *, window, softcap):
    import torch

    B, Hq, Sq, d = q.shape
    _, Hkv, Skv, _ = k.shape
    o = torch.empty_like(q)
    err = lib.flash_attn_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Hq, Hkv,
        Sq, Skv, d, float(d ** -0.5), 1, int(window is not None),
        int(window or 0), int(softcap is not None), float(softcap or 0.0), 0,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attn_bf16 returned CUDA error {err}")
    return o


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k13_ablation.py: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    import chip_smoke as C
    from repro_torch.kernels import ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"== K13 bf16 ablations on {smi}", flush=True)
    libs = build(variants(SRC.read_text()))
    gen = torch.Generator("cuda").manual_seed(6)
    B, S = 2, 6144
    Hq, Hkv, d = (C.GEMMA_HEADS[key] for key in ("Hq", "Hkv", "d"))
    q, k, v = C._k13_inputs(gen, B, Hq, Hkv, S, S, d, torch.bfloat16)
    for label, window, cap in (("global", None, 50.0),
                               ("window 4096", 4096, 50.0),
                               ("global, no softcap", None, None)):
        kw = dict(window=window, softcap=cap)
        want = ref.flash_attention_plain(q, k, v, causal=True,
                                         scale=d ** -0.5, q_offset=0, **kw)
        flops = 4 * d * B * Hq * C._attn_pairs(S, S, True, window)
        for name, lib in libs.items():
            o = run(lib, q, k, v, **kw)
            torch.cuda.synchronize()
            val = C._value_rel(o, want, C.K13_TOL["float32"])
            ms = C.device_ms(lambda: run(lib, q, k, v, **kw), calls=5,
                             reps=5)
            print(f"  {label}, {name}: {ms:.4f} ms, {flops / ms / 1e9:.1f} "
                  f"TF/s; bf16 value check {val:.2f} of its limit", flush=True)
        if cap is None:
            ms = C.device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=d ** -0.5, enable_gqa=True),
                calls=5, reps=5)
            print(f"  {label}, SDPA: {ms:.4f} ms", flush=True)
        del want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
