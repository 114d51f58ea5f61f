"""Training launcher: fault-tolerant loop around ``steps.make_train_step``.

The port of the reference's ``launch/train.py``:

  * checkpoint/restart — atomic async checkpoints every ``ckpt_every``
    steps, auto-resume from the latest on startup (restart-safe data
    pipeline: batches are a pure function of the step index),
  * preemption — SIGTERM triggers a synchronous save + clean exit, at the
    end of the step it arrives in (the update is in place, so a state
    saved mid-step would be half updated),
  * straggler watchdog — per-step wall time against the running median;
    steps slower than ``factor`` x median are logged with the step index,
  * elastic restarts — checkpoints hold whole arrays, so a run resumes
    whatever mesh wrote them.  Under an active mesh (``distributed.
    sharding.use_mesh``, a ``DeviceMesh``) each rank holds its blocks of
    the state, cut by the train ``models.model.param_specs`` (FSDP over
    ``data``, TP over ``model``: ``models.model.hold_cut``), and trains on
    its rows of each global batch (``steps.make_train_step``); it saves
    and restores them through the checkpoint's sharded save and restore
    (``shardings=``), the writes from rank 0 alone
    (``checkpoint/manager.py``),
  * gradient accumulation (``grad_accum``) and gradient compression
    (``grad_compression``, ``steps.make_train_step``).

Each logged step prints the loss, the gradient norm, the step's wall time
(host clock, to the read of its loss), tokens/s and, on the card, the MFU:
``analytic.train_mfu``, MODEL_FLOPS against the H100's dense bf16 peak.
The run is on the card unless ``device`` says otherwise, and raises where
there is no CUDA device and no ``device``.

  python -m repro_torch.launch.train --arch qwen2.5-14b --reduced \\
      --device cpu --steps 30 --batch 8 --seq 128 --ckpt-dir /tmp/ck
"""
from __future__ import annotations

import argparse
import contextlib
import signal
import statistics
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get
from repro_torch.data import SyntheticLMStream
from repro_torch.distributed import sharding as SH
from repro_torch.launch import steps as St
from repro_torch.launch.analytic import train_mfu
from repro_torch.launch.serve import _device, _sync

__all__ = ["StragglerWatchdog", "train", "main"]


class StragglerWatchdog:
    """Flags steps whose wall time exceeds ``factor`` x running median."""

    def __init__(self, factor: float = 2.0, window: int = 32):
        self.factor = factor
        self.window = window
        self.times: list[float] = []
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float):
        if len(self.times) >= 8:
            med = statistics.median(self.times[-self.window:])
            if dt > self.factor * med:
                self.flagged.append((step, dt))
                print(f"[watchdog] step {step} took {dt:.3f}s "
                      f"(median {med:.3f}s) — straggler suspected")
        self.times.append(dt)


class _StepBoundary:
    """Holds SIGTERM back while a step runs: the manager's handler (which
    saves and exits) runs at once between steps, else when the step ends."""

    def __init__(self, handler):
        self.handler = handler
        self.inside = False
        self.pending = None
        signal.signal(signal.SIGTERM, self._on_signal)

    def _on_signal(self, signum, frame):
        if self.inside:
            self.pending = (signum, frame)
        else:
            self.handler(signum, frame)

    def __enter__(self):
        self.inside = True

    def __exit__(self, *exc):
        self.inside = False
        if self.pending is not None and exc[0] is None:
            self.handler(*self.pending)


def train(cfg, *, steps: int = 30, batch: int = 8, seq: int = 128,
          ckpt_dir: str | None = None, ckpt_every: int = 10,
          peak_lr: float = 3e-4, grad_accum: int = 1,
          grad_compression: str = "none", seed: int = 0,
          log_every: int = 1, device=None, history: list | None = None):
    """Train ``cfg`` from seed ``seed`` on ``SyntheticLMStream(cfg.vocab,
    seed)`` batches of ``batch`` x ``seq`` tokens, up to step ``steps``
    (resuming from the latest checkpoint under ``ckpt_dir``).  Returns
    ``(state, losses)``; where ``history`` is a list, each step appends
    its ``step``, ``loss``, ``grad_norm``, ``lr``, ``ms``, ``tokens_per_s``
    and (on the card) ``mfu`` to it."""
    device = _device(device)
    mesh = SH.current_mesh()
    if mesh is not None and not SH.has_group(mesh):
        raise ValueError("train runs over a DeviceMesh; an AbstractMesh has "
                         "no process group to train over")
    state = St.make_train_state(torch.Generator(device).manual_seed(seed),
                                cfg, mesh=mesh)
    step_fn = St.make_train_step(
        cfg, peak_lr=peak_lr, total_steps=max(steps, 100),
        warmup=max(steps // 10, 1), grad_accum=grad_accum,
        grad_compression=grad_compression)

    start = 0
    mgr = None
    boundary = None
    shardings = state.shardings()
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir)
        if mgr.latest_step() is not None:
            start, tree = mgr.restore(state.like(), shardings=shardings)
            state.load(tree)
            print(f"[train] resumed from step {start}")
        previous = signal.getsignal(signal.SIGTERM)
        mgr.install_sigterm_handler(lambda: (state.step, state.tree()),
                                    shardings=shardings)
        boundary = _StepBoundary(signal.getsignal(signal.SIGTERM))

    data = SyntheticLMStream(vocab=cfg.vocab, seed=seed)
    wd = StragglerWatchdog()
    losses = []
    try:
        for step in range(start, steps):
            batch_np = data.batch(step, batch, seq)
            _sync(device)
            t0 = time.perf_counter()
            with boundary or contextlib.nullcontext():
                state, metrics = step_fn(
                    state, {"tokens": torch.from_numpy(batch_np).to(device)})
                loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            wd.observe(step, dt)
            losses.append(loss)
            gnorm = float(metrics["grad_norm"])
            rec = {"step": step, "loss": loss, "grad_norm": gnorm,
                   "lr": metrics["lr"], "ms": dt * 1e3,
                   "tokens_per_s": batch * seq / dt}
            if device.type == "cuda":
                rec["mfu"] = train_mfu(cfg, batch=batch, seq=seq, step_s=dt)
            if history is not None:
                history.append(rec)
            if step % log_every == 0:
                print(f"[train] step {step:5d} loss {loss:.4f} gnorm "
                      f"{gnorm:.3f} {rec['ms']:.1f} ms "
                      f"{rec['tokens_per_s']:.0f} tok/s"
                      + (f" MFU {rec['mfu']:.3f}" if "mfu" in rec else ""),
                      flush=True)
            if mgr and (step + 1) % ckpt_every == 0:
                mgr.save(step + 1, state.tree(), blocking=False,
                         shardings=shardings)
        if mgr:
            mgr.save(steps, state.tree(), blocking=True, shardings=shardings)
    finally:
        if mgr:
            mgr.wait()
            signal.signal(signal.SIGTERM, previous)
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=list(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' for the plain path")
    args = ap.parse_args(argv)

    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    _, losses = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                      ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                      peak_lr=args.lr, grad_accum=args.grad_accum,
                      grad_compression=args.grad_compression, seed=args.seed,
                      device=args.device)
    if losses:
        print(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"over {len(losses)} steps")
    return losses


if __name__ == "__main__":
    main()
