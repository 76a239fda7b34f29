"""Deterministic sharded LM loader with exact checkpoint-resume (numpy, as
the reference's: its batches are bit-equal to the reference's, and the model
moves them to its device).

Design (multi-host ready):
  * The token stream is packed into fixed ``(seq_len + 1)`` windows; window
    ``i`` of epoch ``e`` is drawn by a stateless shuffle ``perm(e, i)``
    (Feistel-style bijective hash), so any step's batch is a pure function
    of ``(seed, step)`` — no iterator state to snapshot beyond the step.
  * Each host materializes only its slice: ``global_batch`` rows split by
    ``(host_id, n_hosts)``; on one process the host-local batch is the
    global batch.
  * ``LoaderState`` is a tiny NamedTuple (step counter) — checkpointing the
    data pipeline is checkpointing one integer, which is what makes
    restart-exactness trivial to test.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class LoaderState(NamedTuple):
    step: int


def _feistel_perm(i: np.ndarray, n: int, seed: int, rounds: int = 4):
    """Bijective pseudo-random permutation of [0, n) (cycle-walking Feistel).

    Stateless shuffle: perm(e, i) gives window order for epoch e without
    materializing an index array (n can be billions of windows).
    """
    # next power-of-two split into two half-words
    bits = max(int(np.ceil(np.log2(max(n, 2)))), 2)
    half = (bits + 1) // 2
    mask = (1 << half) - 1
    out = np.asarray(i, dtype=np.uint64).copy()

    def mix(v, k):
        v = (v * np.uint64(0x9E3779B97F4A7C15) + np.uint64(k)) & np.uint64(
            0xFFFFFFFFFFFFFFFF
        )
        v ^= v >> np.uint64(29)
        v = (v * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
        v ^= v >> np.uint64(32)
        return v

    domain = np.uint64(1) << np.uint64(2 * half)

    def one_pass(x):
        left = x >> np.uint64(half)
        right = x & np.uint64(mask)
        for r in range(rounds):
            left, right = right, left ^ (
                mix(right, seed * 1315423911 + r) & np.uint64(mask)
            )
        return (left << np.uint64(half)) | right

    # cycle-walk until inside [0, n)
    out = one_pass(out)
    for _ in range(64):  # bounded walk; domain < 4n so ~2 expected steps
        bad = out >= np.uint64(n)
        if not bad.any():
            break
        out[bad] = one_pass(out[bad])
    return out.astype(np.int64)


class LMLoader:
    """Packs a flat token stream into shuffled (tokens, labels) batches."""

    def __init__(
        self,
        stream: np.ndarray,
        seq_len: int,
        global_batch: int,
        seed: int = 0,
        host_id: int = 0,
        n_hosts: int = 1,
        drop_last: bool = True,
    ):
        assert global_batch % n_hosts == 0, (global_batch, n_hosts)
        self.stream = np.asarray(stream, dtype=np.int32)
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // n_hosts
        self.seed = seed
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.n_windows = (len(self.stream) - 1) // seq_len
        if self.n_windows < 1:
            raise ValueError(
                f"stream too short: {len(self.stream)} tokens < "
                f"seq_len+1 = {seq_len + 1}"
            )
        self.steps_per_epoch = max(self.n_windows // global_batch, 1)

    # ------------------------------------------------------------------ api
    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """The host-local batch for global step ``step`` (pure function)."""
        epoch = step // self.steps_per_epoch
        within = step % self.steps_per_epoch
        # rows owned by this host for this step
        row0 = within * self.global_batch + self.host_id * self.local_batch
        rows = np.arange(row0, row0 + self.local_batch)
        wins = _feistel_perm(rows % self.n_windows, self.n_windows,
                             self.seed + epoch)
        starts = wins * self.seq_len
        idx = starts[:, None] + np.arange(self.seq_len + 1)[None]
        chunk = self.stream[idx]  # (local_batch, seq+1)
        return {
            "tokens": chunk[:, :-1].astype(np.int32),
            "labels": chunk[:, 1:].astype(np.int32),
        }

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    # ------------------------------------------------------- resume support
    def state_at(self, step: int) -> LoaderState:
        return LoaderState(step=step)

    def resume(self, state: LoaderState):
        """Iterator starting from a checkpointed state."""
        step = int(state.step)
        while True:
            yield self.batch_at(step)
            step += 1


def eval_batches(stream: np.ndarray, seq_len: int, batch: int,
                 max_batches: int | None = None):
    """Sequential non-shuffled eval batches over the whole stream."""
    stream = np.asarray(stream, dtype=np.int32)
    n_windows = (len(stream) - 1) // seq_len
    n_batches = n_windows // batch
    if max_batches is not None:
        n_batches = min(n_batches, max_batches)
    for b in range(n_batches):
        starts = (np.arange(batch) + b * batch) * seq_len
        idx = starts[:, None] + np.arange(seq_len + 1)[None]
        chunk = stream[idx]
        yield {
            "tokens": chunk[:, :-1].astype(np.int32),
            "labels": chunk[:, 1:].astype(np.int32),
        }
