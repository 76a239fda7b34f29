"""Serving step factory and sampling.

Sampling contract: every slot owns a ``torch.Generator`` (seeded from its
request); a sampling step draws that row's Gumbel noise from it, so a
request's stream depends on its seed and on nothing else in the batch.
``temperature = 0`` rows take the plain argmax and draw nothing — mixing
greedy and stochastic requests in one batch costs the greedy ones nothing.
The streams are PyTorch's, not the reference package's: only greedy output
is comparable across the two.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core.policy import Policy, QuantPolicy

NEG_INF = -1e9  # matches the vocab-padding mask in head_logits


def make_paged_step(model, policy: Policy = QuantPolicy()) -> Callable:
    """Unified paged serving step (chunked prefill AND decode).

    ``tokens`` is (B, S): S = prefill_chunk streams one prompt tile per
    prefilling row, S = 1 is a decode tick; rows not participating carry
    ``n_valid = 0`` and an unmapped (-1) page-table row.  An engine calls
    this with exactly two shapes.
    """
    def paged_step(params, tokens, state, n_valid):
        logits, state = model.paged_step(params, tokens, state,
                                         n_valid=n_valid, policy=policy)
        return logits, state

    return paged_step


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------
def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


def top_k_filter(logits: torch.Tensor, k) -> torch.Tensor:
    """Mask all but each row's top-k logits to NEG_INF.

    ``k`` is a scalar or (B,) int tensor; ``k <= 0`` means no filtering
    for that row (the full distribution survives).  The threshold is the
    k-th largest value per row, found by sorting, so k can differ per row.
    """
    k = torch.as_tensor(k, dtype=torch.int64, device=logits.device)
    V = logits.shape[-1]
    kb = torch.atleast_1d(k).expand(logits.shape[:-1])
    kc = torch.clamp(kb, 1, V)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    thresh = torch.gather(sorted_desc, -1, (kc - 1)[..., None])
    filtered = torch.where(logits >= thresh, logits,
                           torch.full_like(logits, NEG_INF))
    return torch.where((kb > 0)[..., None], filtered, logits)


def sample_tokens(logits: torch.Tensor, gens: Sequence[torch.Generator],
                  temperature, top_k=None) -> torch.Tensor:
    """Per-row temperature/top-k sampling, (B, V) -> (B, 1) int32.

    Rows with ``temperature <= 0`` take the argmax — identical to
    ``greedy_sample``.  Stochastic rows add Gumbel noise drawn from their
    own generator ``gens[row]`` and take the argmax (no CDF).
    """
    temps = [float(t) for t in torch.as_tensor(temperature).reshape(-1)]
    if len(temps) == 1:
        temps = temps * logits.shape[0]
    if top_k is not None:
        logits = top_k_filter(logits, top_k)
    out = torch.argmax(logits, dim=-1)
    for row, temp in enumerate(temps):
        if temp <= 0:
            continue
        u = torch.rand(logits.shape[-1], generator=gens[row],
                       device=logits.device, dtype=torch.float32)
        g = -torch.log(-torch.log(u.clamp_min(1e-20)))
        out[row] = torch.argmax(logits[row] / max(temp, 1e-6) + g)
    return out.to(torch.int32)[:, None]


def sample_step(logits, gens, temps, topk):
    """One sampling tick.  The generators advance in place, so — unlike
    the functional reference — there are no new keys to return."""
    return sample_tokens(logits, gens, temps, topk)
