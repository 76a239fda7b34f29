"""AdamW, written out op for op as the reference writes it: f32 moments over
any parameter dtype, ``mu / (1 - b1 ** count)`` bias corrections,
``mu_hat / (sqrt(nu_hat) + eps)``, weight decay added to the step, then
``-lr * step``.  (``torch.optim.AdamW`` decays the parameter first and folds
the corrections into the step size: other numbers.)

``update`` is functional, as the reference's; ``step_`` applies the same
per-leaf arithmetic in place (moments and parameters overwritten leaf by
leaf), the port's form of the reference launcher's donated buffers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor  # int32 scalar on the parameters' device


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float | Callable = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params) -> AdamWState:
        zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
        first = leaves(params)
        dev = first[0].device if first else "cpu"
        return AdamWState(mu=tree_map(zeros32, params),
                          nu=tree_map(zeros32, params),
                          count=torch.zeros((), dtype=torch.int32,
                                            device=dev))

    def _prepare(self, state: AdamWState):
        count = state.count + 1
        lr = self.lr(count) if callable(self.lr) else self.lr
        c = count.to(torch.float32)
        return count, lr, 1 - self.b1 ** c, 1 - self.b2 ** c

    def _leaf(self, g, mu, nu, p, lr, c1, c2):
        """(update, new mu, new nu) of one leaf."""
        b1, b2 = self.b1, self.b2
        g32 = g.to(torch.float32)
        mu = b1 * mu + (1 - b1) * g32
        nu = b2 * nu + (1 - b2) * g32 * g32
        mu_hat = mu / c1
        nu_hat = nu / c2
        step = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        if self.weight_decay:
            step = step + self.weight_decay * p.to(torch.float32)
        return (-lr * step).to(p.dtype), mu, nu

    def update(self, grads, state: AdamWState, params):
        """(updates, new state); nothing is written in place."""
        count, lr, c1, c2 = self._prepare(state)
        flat = [self._leaf(g, m, v, p, lr, c1, c2) for g, m, v, p in zip(
            leaves(grads), leaves(state.mu), leaves(state.nu),
            leaves(params))]
        return (unflatten(params, [f[0] for f in flat]),
                AdamWState(mu=unflatten(params, [f[1] for f in flat]),
                           nu=unflatten(params, [f[2] for f in flat]),
                           count=count))

    @torch.no_grad()
    def step_(self, grads, state: AdamWState, params) -> AdamWState:
        """``update`` then ``apply_updates`` with the moments and parameters
        overwritten leaf by leaf: the same numbers (``p + u``), one leaf's
        temporaries at a time.  Returns the new state (its ``mu`` / ``nu``
        are ``state``'s tensors)."""
        count, lr, c1, c2 = self._prepare(state)
        for g, m, v, p in zip(leaves(grads), leaves(state.mu),
                              leaves(state.nu), leaves(params)):
            u, mu, nu = self._leaf(g, m, v, p, lr, c1, c2)
            m.copy_(mu)
            v.copy_(nu)
            p.add_(u.to(p.dtype))
        return AdamWState(mu=state.mu, nu=state.nu, count=count)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)

