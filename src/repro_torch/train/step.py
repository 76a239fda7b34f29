"""train_step factory: loss -> grads (microbatched) -> clip -> AdamW.

``jax.value_and_grad`` becomes ``torch.autograd.grad`` over the parameter
leaves (each taken as a fresh leaf that requires grad, so the caller's
tensors never do); the reference's ``lax.scan`` over microbatches becomes
a Python loop over equal splits of the batch, gradients summed in f32 and
divided by their number, the metrics those of the last microbatch.

The step overwrites the parameters and the optimizer's moments in place
(the reference launcher donates both buffers): the numbers are the
reference's functional ``update`` + ``apply_updates``, and no second copy
of the parameters, gradients or moments is held at the step's peak.  A
caller that needs the old parameters clones them first.

The kernel wrappers have no backward and raise under grad mode, as the
reference's Pallas kernels raise under ``jax.grad``: a fused policy cannot
train (QAT trains through the plain QDQ and its straight-through
estimator; the fused kernels evaluate the trained weights).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.policy import Policy, QuantPolicy
from repro_torch.core.quantize import div_by_constant
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.tree import leaves, unflatten


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    max_grad_norm: float = 1.0


def _split(x, n: int, i: int):
    b = x.shape[0]
    assert b % n == 0, (b, n)
    m = b // n
    return x[i * m:(i + 1) * m]


def make_loss_and_grads(model, policy: Policy = QuantPolicy(),
                        microbatches: int = 1) -> Callable:
    """``loss_and_grads(params, batch) -> (loss, metrics, [grad per leaf in
    JAX's leaf order])``: the train step's first half, before clipping."""

    def grad_fn(params, batch):
        flat = leaves(params)
        req = [p.detach().requires_grad_() if p.is_floating_point() else p
               for p in flat]
        loss, metrics = model.loss(unflatten(params, req), batch, policy)
        wrt = [r for r in req if r.requires_grad]
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
        grads = []
        for r in req:
            g = next(got) if r.requires_grad else None
            grads.append(torch.zeros_like(r) if g is None else g)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, grads

    def loss_and_grads(params, batch):
        n = microbatches
        if n <= 1:
            return grad_fn(params, batch)
        loss_acc = 0.0
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves(params)]
        for i in range(n):
            mb = {k: _split(v, n, i) for k, v in batch.items()}
            loss, metrics, grads = grad_fn(params, mb)
            acc = [a + g.to(a.dtype) for a, g in zip(acc, grads)]
            loss_acc = loss_acc + loss
        return (div_by_constant(loss_acc, n), metrics,
                [div_by_constant(g, n) for g in acc])

    return loss_and_grads


def make_train_step(
    model,
    optimizer: AdamW,
    policy: Policy = QuantPolicy(),
    cfg: TrainStepConfig = TrainStepConfig(),
) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``params`` and ``opt_state``'s moments are overwritten in
    place and returned."""
    loss_and_grads = make_loss_and_grads(model, policy, cfg.microbatches)

    def train_step(params, opt_state: AdamWState, batch):
        loss, metrics, grads = loss_and_grads(params, batch)
        grads, gnorm = clip_by_global_norm(grads, cfg.max_grad_norm)
        opt_state = optimizer.step_(grads, opt_state, params)
        out = {"loss": loss.to(torch.float32), "grad_norm": gnorm,
               **{k: v.to(torch.float32) for k, v in metrics.items()}}
        return params, opt_state, out

    return train_step
