"""CheckpointManager: cadence, retention, async writes, preemption save.

  * save every ``interval`` steps and keep the last ``keep`` checkpoints;
  * async: serialization runs on a worker thread off the train loop
    (``wait()`` joins before the next save or shutdown — one in flight);
  * preemption: ``install_sigterm_handler`` sets a flag the loop polls, so
    a SIGTERM triggers save-then-exit;
  * restore picks the newest COMMITTED step, so a death mid-write falls
    back to the previous good checkpoint.

The snapshot is taken on the caller's thread: every tensor is copied to
the host before ``save`` returns, so the train step, which then
overwrites the parameters and moments in place, cannot reach what the
writer thread serializes.
"""

from __future__ import annotations

import dataclasses
import signal
import threading

import torch

from repro_torch.checkpoint import store
from repro_torch.tree import tree_map


@dataclasses.dataclass
class CheckpointConfig:
    directory: str = "checkpoints"
    interval: int = 100
    keep: int = 3
    async_write: bool = True


def _host_copy(leaf):
    if isinstance(leaf, torch.Tensor):  # a copy even of a CPU tensor
        return leaf.detach().to("cpu", copy=True)
    return leaf


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.preempted = threading.Event()

    # ----------------------------------------------------------- cadence
    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.cfg.interval == 0

    # ------------------------------------------------------------- saving
    def _write(self, step: int, trees: dict, metadata: dict):
        try:
            for name, tree in trees.items():
                store.save_pytree(self.cfg.directory, step, tree,
                                  metadata=metadata, name=name)
            store.mark_committed(self.cfg.directory, step)
            self._gc()
        except BaseException as e:  # surfaced on next wait()
            self._error = e

    def save(self, step: int, trees: dict, metadata: dict | None = None,
             blocking: bool | None = None):
        """``trees``: {'params': ..., 'opt': ...}.  Host copies are taken
        here, then written by the worker (or here when blocking)."""
        self.wait()
        snapshot = {name: tree_map(_host_copy, tree)
                    for name, tree in trees.items()}
        meta = dict(metadata or {})
        blocking = (not self.cfg.async_write) if blocking is None else blocking
        if blocking:
            self._write(step, snapshot, meta)
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, snapshot, meta), daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from e

    def _gc(self):
        steps = store.list_steps(self.cfg.directory)
        for s in steps[: -self.cfg.keep]:
            store.delete_step(self.cfg.directory, s)

    # ------------------------------------------------------------ restore
    def latest_step(self) -> int | None:
        steps = store.list_steps(self.cfg.directory)
        return steps[-1] if steps else None

    def restore(self, step: int, examples: dict,
                shardings: dict | None = None):
        """``{name: tree}`` at ``step``; ``shardings[name]`` (optional) lays
        that tree out on a mesh (``store.restore_pytree``)."""
        return {name: store.restore_pytree(
                    self.cfg.directory, step, ex, name=name,
                    shardings=(shardings or {}).get(name))
                for name, ex in examples.items()}

    def metadata(self, step: int, name: str = "params") -> dict:
        return store.load_metadata(self.cfg.directory, step, name=name)

    # --------------------------------------------------------- preemption
    def install_sigterm_handler(self):
        def handler(signum, frame):
            self.preempted.set()

        signal.signal(signal.SIGTERM, handler)
        return self.preempted
