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
  * **Elastic restore** — arrays are saved whole, so a checkpoint restores
    onto any mesh: with ``shardings`` (a tree of
    ``distributed.sharding.NamedSharding``) each rank keeps only its block
    of each leaf (``sharding.shard_block``), whatever mesh wrote it.
  * **Retention** — ``keep`` newest checkpoints are retained.
  * **Preemption** — ``install_sigterm_handler`` saves synchronously and
    exits cleanly on SIGTERM.

A tree is a nested dict of tensors or numbers; its leaves are
keyed by their dict keys joined with ``/`` (the train state: the parameter
names, ``mu/<name>``, ``nu/<name>`` and ``step``).  numpy has no bfloat16:
a bfloat16 leaf is stored as its bits (uint16) and the manifest keeps its
dtype.

Saving from a process group.  The reference's save gathers each array
(``np.asarray`` of a sharded array is the whole array).  Here a rank holds
plain tensors, so ``save(..., shardings=)`` says how each leaf is cut, and
every rank gathers the cut leaves (``sharding.unshard``, collectives issued
in the caller's thread).  Whenever a process group is initialised, every
rank calls ``save`` (the trainer's saves and its preemption save alike), only
rank 0 writes, and the others wait on a barrier until the write is done (at
once for a blocking save, else in :meth:`CheckpointManager.wait`, which
every rank calls).  Otherwise several processes would race on the same
``tmp.<step>`` and the atomic rename would no longer hold.  The layout on
disk is the same either way, so a checkpoint restores in either package.
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

from repro_torch.distributed.sharding import shard_block, unshard

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


def _from_host(a: np.ndarray, dtype: str, like, sharding=None):
    """The stored leaf as the type, dtype and device of ``like`` (a tensor,
    else a number); with ``sharding``, this rank's block of it, copied."""
    if not isinstance(like, torch.Tensor):
        return type(like)(a.item())
    t = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
         if dtype == "bfloat16" else torch.from_numpy(a))
    if sharding is None:
        return t.to(device=like.device, dtype=like.dtype)
    return shard_block(t, sharding.spec, sharding.mesh).to(
        device=like.device, dtype=like.dtype, copy=True,
        memory_format=torch.contiguous_format)


def _rank() -> int | None:
    """This process's rank in the process group, or None outside one."""
    import torch.distributed as dist

    return (dist.get_rank() if dist.is_available() and dist.is_initialized()
            else None)


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, *, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._barrier_due = False

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
             extra_meta: dict | None = None, shardings: dict | None = None):
        """Checkpoint ``tree`` at ``step``.  Async unless ``blocking``.

        ``shardings``: a tree of ``NamedSharding`` matching ``tree`` (a leaf
        it lacks is whole on every rank): ``tree``'s leaves are this rank's
        blocks, gathered whole before the write.  In a process group every
        rank calls it and only rank 0 writes (module docstring)."""
        self.wait()                       # one in-flight save at a time
        flat = _flatten(tree)
        if shardings is not None:
            sflat = _flatten(shardings)
            flat = {k: (v if sflat.get(k) is None else
                        unshard(v, sflat[k].spec, sflat[k].mesh))
                    for k, v in flat.items()}
        rank = _rank()
        writes = rank in (None, 0)
        self._barrier_due = rank is not None
        # Snapshot to host memory first, so the background writer never
        # touches live device buffers (which the next step updates in place).
        host, dtypes = {}, {}
        for k, v in flat.items() if writes else ():
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

        if writes and blocking:
            write()
        elif writes:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        """Wait for the save in flight; in a process group, also for rank
        0's write on every rank."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier_due:
            import torch.distributed as dist

            self._barrier_due = False
            dist.barrier()

    def _gc(self):
        ds = self._step_dirs()
        for _, p in ds[:-self.keep] if self.keep else []:
            shutil.rmtree(p, ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, tree_like: dict, step: int | None = None, *,
                shardings: dict | None = None):
        """Restore into the structure of ``tree_like``: each leaf comes back
        as the type, dtype and device of its counterpart there, after its
        shape is checked against that leaf's (the whole leaf's shape).

        ``shardings``: a tree of ``NamedSharding`` matching ``tree_like`` (a
        leaf it lacks comes back whole): each such leaf comes back as this
        rank's block of it, onto whatever mesh the restarted job has.
        Returns (step, tree)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step}"
        meta = json.loads((d / "manifest.json").read_text())["leaves"]
        sflat = {} if shardings is None else _flatten(shardings)
        out = {}
        with np.load(d / "arrays.npz") as data:
            for key, like in _flatten(tree_like).items():
                if key not in meta:
                    raise KeyError(f"{key}: not in the checkpoint at {d}")
                arr = data[key]
                shape = tuple(getattr(like, "shape", ()))
                if tuple(arr.shape) != shape:
                    raise ValueError(f"{key}: ckpt {arr.shape} != {shape}")
                out[key] = _from_host(arr, meta[key]["dtype"], like,
                                      sflat.get(key))
        return step, _unflatten(out, tree_like)

    # ------------------------------------------------------------------
    def install_sigterm_handler(self, get_state, *, exit_code: int = 0,
                                shardings: dict | None = None):
        """On SIGTERM (preemption), save synchronously and exit.
        ``get_state()`` returns ``(step, tree)``; ``shardings`` as in
        :meth:`save`.  In a process group every rank must get the signal:
        the save writes from rank 0 alone and waits for it on every
        rank."""

        def handler(signum, frame):
            step, tree = get_state()
            self.save(step, tree, blocking=True,
                      extra_meta={"preempted": True}, shardings=shardings)
            sys.exit(exit_code)

        signal.signal(signal.SIGTERM, handler)
