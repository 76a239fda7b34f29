"""Fault-tolerant training loop.

  * checkpoint/restart — resume is exact: params, optimizer state and the
    data position restore from the newest committed step (the loader's
    batches are a pure function of the step), and a restarted run's
    parameters are bit-identical to an uninterrupted run's;
  * preemption — SIGTERM sets a flag; the loop checkpoints and exits;
  * straggler detection — per-step wall time feeds an EWMA; steps slower
    than ``straggler_factor`` x the EWMA are recorded with their index;
  * metrics — one JSON line per logged step (loss, grad norm, step time,
    tokens/s).

A step's time is taken between two synchronizations of the device its
loss is on, as the reference blocks until the loss is ready.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable

import torch

from repro_torch.checkpoint.manager import CheckpointConfig, CheckpointManager


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    log_every: int = 10
    metrics_path: str | None = None
    checkpoint: CheckpointConfig | None = None
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.1
    eval_every: int = 0
    handle_sigterm: bool = False


@dataclasses.dataclass
class LoopResult:
    last_step: int
    last_metrics: dict
    history: list
    resumed_from: int | None
    preempted: bool = False
    stragglers: list = dataclasses.field(default_factory=list)


def _ready(t) -> None:
    """Block until ``t`` is computed (its device's queue drained)."""
    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def run(
    train_step: Callable,
    params,
    opt_state,
    batches,
    cfg: LoopConfig,
    eval_fn: Callable | None = None,
):
    """Drive ``train_step(params, opt_state, batch) -> (params, opt,
    metrics)``; returns ``(LoopResult, params, opt_state)``.

    ``batches`` must expose ``batch_at(step)`` (pure indexed access) — that
    is what makes restart exactness a one-integer problem.
    """
    mgr = None
    start_step = 0
    resumed_from = None
    if cfg.checkpoint is not None:
        mgr = CheckpointManager(cfg.checkpoint)
        if cfg.handle_sigterm:
            mgr.install_sigterm_handler()
        latest = mgr.latest_step()
        if latest is not None:
            restored = mgr.restore(latest, {"params": params,
                                            "opt": opt_state})
            params, opt_state = restored["params"], restored["opt"]
            start_step = int(mgr.metadata(latest, "params").get("step",
                                                                latest))
            resumed_from = start_step

    mfile = None
    if cfg.metrics_path:
        os.makedirs(os.path.dirname(cfg.metrics_path) or ".", exist_ok=True)
        mfile = open(cfg.metrics_path, "a")

    history: list[dict] = []
    stragglers: list[int] = []
    ewma = None
    preempted = False
    metrics = {}
    step = start_step
    try:
        for step in range(start_step, cfg.total_steps):
            batch = batches.batch_at(step)
            t0 = time.perf_counter()
            params, opt_state, metrics = train_step(params, opt_state, batch)
            _ready(metrics["loss"])
            dt = time.perf_counter() - t0

            # --- straggler detection (EWMA of step time) ------------------
            if ewma is None:
                ewma = dt
            else:
                if dt > cfg.straggler_factor * ewma:
                    stragglers.append(step)
                ewma = (1 - cfg.ewma_alpha) * ewma + cfg.ewma_alpha * dt

            rec = {"step": step, "time_s": round(dt, 5),
                   **{k: float(v) for k, v in metrics.items()}}
            ntok = getattr(batches, "tokens_per_step", None)
            if ntok:
                rec["tokens_per_s"] = round(ntok / dt, 1)
            history.append(rec)
            if mfile and (step % cfg.log_every == 0
                          or step == cfg.total_steps - 1):
                mfile.write(json.dumps(rec) + "\n")
                mfile.flush()

            if cfg.eval_every and eval_fn and (step + 1) % cfg.eval_every == 0:
                ev = eval_fn(params)
                history[-1]["eval"] = ev
                if mfile:
                    mfile.write(json.dumps({"step": step, "eval": ev}) + "\n")
                    mfile.flush()

            next_step = step + 1
            if mgr is not None and (
                    mgr.should_save(next_step) or next_step == cfg.total_steps):
                mgr.save(next_step, {"params": params, "opt": opt_state},
                         metadata={"step": next_step})
            if mgr is not None and mgr.preempted.is_set():
                mgr.save(next_step, {"params": params, "opt": opt_state},
                         metadata={"step": next_step}, blocking=True)
                preempted = True
                break
    finally:
        if mgr is not None:
            mgr.wait()
        if mfile:
            mfile.close()

    return LoopResult(
        last_step=step,
        last_metrics={k: float(v) for k, v in metrics.items()},
        history=history,
        resumed_from=resumed_from,
        preempted=preempted,
        stragglers=stragglers,
    ), params, opt_state


class ArrayBatches:
    """batch_at() adapter over a fixed list of batches (tests/benchmarks)."""

    def __init__(self, batches: list, tokens_per_step: int | None = None):
        self._b = batches
        self.tokens_per_step = tokens_per_step

    def batch_at(self, step: int):
        return self._b[step % len(self._b)]
