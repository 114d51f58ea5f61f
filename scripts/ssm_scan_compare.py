#!/usr/bin/env python3
"""Hymba-1.5b's selective scan in two plain-PyTorch forms, on one NVIDIA
card: the port's chunked form (``models/ssm._ssm_scan``: each chunk's
decays and inputs at once, then two device operations a step) and the
reference's step taken one time step at a time.

Run from the root of a checkout::

    python3 scripts/ssm_scan_compare.py [--batch 4] [--tokens 2048]

At hymba-1.5b's width (d_inner 3200, 16 state channels) and the serve
shape of ``chip_smoke.py`` (batch 4, 2048 tokens), inputs in bf16, it
prints whether the two forms give bitwise the same outputs and final
states, and the host-clock time of one layer's scan in each form, in
turns (direct, chunked, chunked, direct), each the median of 3 calls
that end in a synchronize.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def scan_direct(x, dt, Bc, Cc, A, D, h0):
    """The reference's ``_ssm_scan`` step, one time step at a time."""
    import torch

    xf, dtf, bf, cf = (t.float() for t in (x, dt, Bc, Cc))
    h, ys = h0, []
    for t in range(x.shape[1]):
        da = torch.exp(dtf[:, t, :, None] * A)
        h = da * h + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    return torch.stack(ys, 1) + D * x, h


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=2048)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ssm_scan_compare.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get
    from repro_torch.models import ssm

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    cfg = get("hymba-1.5b")
    B, T, di, n = args.batch, args.tokens, 2 * cfg.d_model, cfg.ssm_state
    gen = torch.Generator("cuda").manual_seed(7)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    x, Bc, Cc = rnd(B, T, di), rnd(B, T, n), rnd(B, T, n)
    dt = (torch.rand((B, T, di), generator=gen, device="cuda") * 0.1
          ).bfloat16()
    A = -torch.arange(1, n + 1, dtype=torch.float32,
                      device="cuda").expand(di, n)
    D = torch.ones(di, device="cuda")
    h0 = torch.zeros((B, di, n), device="cuda")
    args_ = (x, dt, Bc, Cc, A, D, h0)
    forms = {"direct": scan_direct, "chunked": ssm._ssm_scan}
    (yd, hd), (yc, hc) = (fn(*args_) for fn in forms.values())
    print(f"  direct and chunked (models/ssm._ssm_scan): y bitwise equal "
          f"{torch.equal(yd, yc)} (max rel err "
          f"{float((yd - yc).abs().max() / yd.abs().max()):.2e}), h_T "
          f"bitwise equal {torch.equal(hd, hc)} (max rel err "
          f"{float((hd - hc).abs().max() / hd.abs().max()):.2e})", flush=True)
    times = {"direct": [], "chunked": []}
    for name in ("direct", "chunked", "chunked", "direct"):
        fn = forms[name]
        times[name].append(cs.wall_ms(lambda: fn(*args_), reps=3))
    print(f"  one layer's scan (batch {B}, {T} tokens, d_inner {di}, state "
          f"{n}; host clock): " + "; ".join(
              f"{name} " + ", ".join(f"{t:.1f}" for t in ts) + " ms"
              for name, ts in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
