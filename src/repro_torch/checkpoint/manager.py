"""Fault-tolerant checkpointing.

The port of the reference's ``checkpoint/manager.py``, with its guarantees
and its on-disk layout (``<dir>/step_<k>/arrays.npz`` and
``manifest.json``):

  * **Atomicity** — writes go to ``<dir>/tmp.<step>`` and are renamed to
    ``<dir>/step_<k>`` only after the manifest is written and flushed; a
    crash mid-write never corrupts the latest checkpoint.
  * **Async** — ``save(..., blocking=False)`` snapshots the tensors to host
    memory first, then writes on one background thread; the train loop
    continues.
  * **Restore** — ``restore`` checks each leaf's shape and places it on the
    device (and in the dtype) of the matching leaf of ``tree_like``.
  * **Retention** — ``keep`` newest checkpoints are retained.
  * **Preemption** — ``install_sigterm_handler`` saves synchronously and
    exits cleanly on SIGTERM.

A tree is a nested dict of tensors or numbers; its leaves are
keyed by their dict keys joined with ``/`` (the train state: the parameter
names, ``mu/<name>``, ``nu/<name>`` and ``step``).  numpy has no bfloat16:
a bfloat16 leaf is stored as its bits (uint16) and the manifest keeps its
dtype.  The reference's mesh re-sharding on restore (``shardings=``) waits
for ROADMAP.md queue 1 item 14.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import signal
import sys
import threading
import time

import numpy as np
import torch

__all__ = ["CheckpointManager"]

_SEP = "/"


def _flatten(tree, prefix: str = "") -> dict:
    flat = {}
    for key, sub in tree.items():
        name = f"{prefix}{key}"
        if isinstance(sub, dict):
            flat.update(_flatten(sub, name + _SEP))
        else:
            flat[name] = sub
    return flat


def _unflatten(flat: dict, like: dict, prefix: str = "") -> dict:
    return {key: (_unflatten(flat, sub, f"{prefix}{key}{_SEP}")
                  if isinstance(sub, dict) else flat[f"{prefix}{key}"])
            for key, sub in like.items()}


def _to_host(v) -> tuple[np.ndarray, str]:
    """(numpy copy, dtype name) of a leaf."""
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.array(v)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str, like):
    """The stored leaf as the type, dtype and device of ``like`` (a tensor,
    else a number)."""
    if not isinstance(like, torch.Tensor):
        return type(like)(a.item())
    t = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
         if dtype == "bfloat16" else torch.from_numpy(a))
    return t.to(device=like.device, dtype=like.dtype)


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, *, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    def _step_dirs(self) -> list[tuple[int, pathlib.Path]]:
        out = []
        for p in self.dir.glob("step_*"):
            try:
                out.append((int(p.name.split("_")[1]), p))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> int | None:
        ds = self._step_dirs()
        return ds[-1][0] if ds else None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: dict, *, blocking: bool = True,
             extra_meta: dict | None = None):
        """Checkpoint ``tree`` at ``step``.  Async unless ``blocking``."""
        self.wait()                       # one in-flight save at a time
        # Snapshot to host memory first, so the background writer never
        # touches live device buffers (which the next step updates in place).
        host, dtypes = {}, {}
        for k, v in _flatten(tree).items():
            host[k], dtypes[k] = _to_host(v)
        meta = {
            "step": step,
            "time": time.time(),
            "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                       for k, v in host.items()},
            "extra": extra_meta or {},
        }

        def write():
            tmp = self.dir / f"tmp.{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "arrays.npz", **host)
            with open(tmp / "manifest.json", "w") as f:
                json.dump(meta, f)
                f.flush()
            final = self.dir / f"step_{step}"
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        ds = self._step_dirs()
        for _, p in ds[:-self.keep] if self.keep else []:
            shutil.rmtree(p, ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, tree_like: dict, step: int | None = None):
        """Restore into the structure of ``tree_like``: each leaf comes back
        as the type, dtype and device of its counterpart there, after its
        shape is checked.  Returns (step, tree)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step}"
        meta = json.loads((d / "manifest.json").read_text())["leaves"]
        out = {}
        with np.load(d / "arrays.npz") as data:
            for key, like in _flatten(tree_like).items():
                if key not in meta:
                    raise KeyError(f"{key}: not in the checkpoint at {d}")
                arr = data[key]
                shape = tuple(getattr(like, "shape", ()))
                if tuple(arr.shape) != shape:
                    raise ValueError(f"{key}: ckpt {arr.shape} != {shape}")
                out[key] = _from_host(arr, meta[key]["dtype"], like)
        return step, _unflatten(out, tree_like)

    # ------------------------------------------------------------------
    def install_sigterm_handler(self, get_state, *, exit_code: int = 0):
        """On SIGTERM (preemption), save synchronously and exit.
        ``get_state()`` returns ``(step, tree)``."""

        def handler(signum, frame):
            step, tree = get_state()
            self.save(step, tree, blocking=True,
                      extra_meta={"preempted": True})
            sys.exit(exit_code)

        signal.signal(signal.SIGTERM, handler)
