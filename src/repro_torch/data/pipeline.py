"""Deterministic, restart-safe data pipeline.

The port's own copy of the reference's ``data/pipeline.py`` (numpy only, so
that the port imports nothing of the reference): its batches are bitwise the
reference's for every ``(seed, step, shard)``.  Batches are numpy int32
arrays on the host; the trainer moves them to the device.

Fault-tolerance contract: every batch is a pure function of
``(seed, step, shard)``.  A restarted job that resumes from step k produces
the exact same batch sequence — no iterator state needs checkpointing, and a
re-sharded (elastic) restart keeps per-host determinism because sharding is
by position, not by host identity.

Two sources:
  * :class:`SyntheticLMStream` — hash-based token stream with learnable
    bigram structure (a model can visibly reduce loss on it).
  * :class:`MemmapTokenReader` — flat binary uint16/uint32 token files
    (the production path), read with zero-copy memmap windows.
"""
from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

__all__ = ["SyntheticLMStream", "MemmapTokenReader", "make_batch_iterator"]


@dataclasses.dataclass(frozen=True)
class SyntheticLMStream:
    """Deterministic synthetic LM batches with structure worth learning.

    Token t+1 depends on token t through a fixed random permutation with
    noise: ``x[t+1] = perm[x[t]]`` with prob (1 - noise) else uniform.  A
    model that learns the permutation reaches loss ~= -log(1 - noise).
    """

    vocab: int
    seed: int = 0
    noise: float = 0.1

    def _perm(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed ^ 0x5EED)
        return rng.permutation(self.vocab)

    def batch(self, step: int, batch_size: int, seq_len: int,
              shard: int = 0, n_shards: int = 1) -> np.ndarray:
        """(batch_size, seq_len + 1) int32 tokens for ``step``/``shard``."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + shard)
        perm = self._perm()
        toks = np.empty((batch_size, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, batch_size)
        flip = rng.random((batch_size, seq_len)) < self.noise
        rand = rng.integers(0, self.vocab, (batch_size, seq_len))
        for t in range(seq_len):
            nxt = perm[toks[:, t]]
            toks[:, t + 1] = np.where(flip[:, t], rand[:, t], nxt)
        return toks


class MemmapTokenReader:
    """Reads fixed-length windows from a flat binary token file.

    Deterministic addressing: window ``i`` for step s, shard h of H is at
    offset ``((s * H + h) * batch + row) * stride mod usable``.
    """

    def __init__(self, path: str | pathlib.Path, *, dtype=np.uint16):
        self.path = pathlib.Path(path)
        self.tokens = np.memmap(self.path, dtype=dtype, mode="r")

    def batch(self, step: int, batch_size: int, seq_len: int,
              shard: int = 0, n_shards: int = 1) -> np.ndarray:
        stride = seq_len + 1
        usable = len(self.tokens) - stride
        if usable <= 0:
            raise ValueError(f"{self.path} too small for seq_len={seq_len}")
        base = (step * n_shards + shard) * batch_size
        out = np.empty((batch_size, stride), np.int32)
        for row in range(batch_size):
            off = ((base + row) * stride * 7919) % usable
            out[row] = self.tokens[off:off + stride]
        return out


def make_batch_iterator(source, *, batch_size: int, seq_len: int,
                        start_step: int = 0, shard: int = 0,
                        n_shards: int = 1):
    """Infinite iterator of ``{"tokens": (B, S+1) int32}`` from ``start_step``."""
    step = start_step
    while True:
        yield step, {"tokens": source.batch(step, batch_size, seq_len,
                                            shard, n_shards)}
        step += 1
