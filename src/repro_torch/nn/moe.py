"""Mixture-of-Experts FFN: GShard/Switch-style top-k einsum dispatch.

Tokens are bucketed into groups (static shapes), routed top-k with a
capacity factor, dispatched to experts via one-hot einsums, processed by
per-expert gated FFNs, and combined with router weights — op for op as the
reference's ``nn/moe.py``, with its sharding hints (``dist.sharding``).

The expert matmuls go through the same INT-FP-QSim QDQ hooks as Dense: ABFP
groups run along each expert's contraction dim (batched over the expert
dim).  They are plain f32 ``torch.einsum`` on QDQ'd weights: the reference
computes them outside any Pallas kernel too, so no fused kernel serves
them, under any backend.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.policy import Policy, has_expert_rules, resolve_policy
from repro_torch.core.simulate import qdq_activation, qdq_weight
from repro_torch.dist import sharding as shd
from repro_torch.nn.ffn import _ACTS, GATED
from repro_torch.nn.module import truncated_normal


def contract(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One f32 contraction of the block (the router's, an expert stack's):
    ``torch.einsum(spec, a, b)``, the one place where they are formed, so
    that a caller can add their terms in another order (``chip_smoke.py``'s
    last-bit control splits each in two halves of its contracted axis)."""
    return torch.einsum(spec, a, b)


@dataclasses.dataclass(frozen=True)
class MoE:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    group_tokens: int = 1024  # routing group size (static dispatch shapes)
    act: str = "swiglu"
    param_dtype: str = "float32"
    dtype: str = "float32"
    name: str = "moe"

    @property
    def gated(self) -> bool:
        return self.act in GATED

    def init(self, gen: torch.Generator, device="cuda") -> dict:
        pdt = getattr(torch, self.param_dtype)
        E, D, F = self.n_experts, self.d_model, self.d_ff
        p = {
            "router": truncated_normal(gen, (D, E), pdt, D**-0.5, device),
            "wi": truncated_normal(gen, (E, D, F), pdt, D**-0.5, device),
            "wo": truncated_normal(gen, (E, F, D), pdt, F**-0.5, device),
        }
        if self.gated:
            p["wg"] = truncated_normal(gen, (E, D, F), pdt, D**-0.5, device)
        return p

    def axes(self) -> dict:
        """The logical axes of ``init``'s tree, leaf for leaf."""
        p = {"router": ("embed", "experts"),
             "wi": ("experts", "embed", "moe_mlp"),
             "wo": ("experts", "moe_mlp", "embed")}
        if self.gated:
            p["wg"] = ("experts", "embed", "moe_mlp")
        return p

    def capacity(self, tokens_per_group: int) -> int:
        c = int(
            tokens_per_group * self.top_k * self.capacity_factor
            / self.n_experts
        )
        return max(c, 4)

    def route(self, router: torch.Tensor, xg: torch.Tensor):
        """Top-k routing of ``xg`` (G, T, D) by the ``router`` kernel (D, E)
        with GShard's sequential capacity fill: (probs (G, T, E), dispatch
        and combine (G, T, E, C), fill (G, E): the tokens each expert
        accepted)."""
        G, T, _ = xg.shape
        E, C = self.n_experts, self.capacity(T)
        logits = contract("gtd,de->gte", xg.to(torch.float32),
                          router.to(torch.float32))
        probs = torch.softmax(logits, dim=-1)  # (G, T, E)
        dt = getattr(torch, self.dtype)
        dispatch = torch.zeros((G, T, E, C), dtype=dt, device=xg.device)
        combine = torch.zeros((G, T, E, C), dtype=torch.float32,
                              device=xg.device)
        remaining = probs
        # how many tokens each expert has accepted so far (per group)
        fill = torch.zeros((G, E), dtype=torch.int32, device=xg.device)
        slots = torch.arange(C, device=xg.device)
        for _ in range(self.top_k):
            idx = torch.argmax(remaining, dim=-1)  # (G, T)
            onehot = torch.nn.functional.one_hot(idx, E).to(torch.float32)
            gate = (probs * onehot).sum(-1)  # (G, T)
            # position of each token within its chosen expert's buffer
            pos_in_e = (torch.cumsum(onehot, dim=1) - onehot
                        + fill[:, None, :])
            pos = (pos_in_e * onehot).sum(-1).to(torch.int32)  # (G, T)
            keep = pos < C
            # one_hot of a position past the buffer is all zeros, as
            # jax.nn.one_hot gives it
            poh = (pos[..., None] == slots).to(torch.float32)  # (G, T, C)
            d = onehot[..., None] * poh[:, :, None, :]  # (G, T, E, C)
            d = d * keep[:, :, None, None]
            dispatch = dispatch + d.to(dt)
            combine = combine + d * gate[:, :, None, None]
            fill = fill + (onehot * keep[..., None]).sum(dim=1).to(
                torch.int32)
            remaining = remaining * (1.0 - onehot)
        return probs, dispatch, combine, fill

    def apply(
        self, params: dict, x: torch.Tensor, policy: Policy,
        q: dict | None = None,
    ) -> tuple[torch.Tensor, dict]:
        """Returns (output, metrics) — metrics carries the aux load loss
        and the per-expert routed-token load (``expert_load``, shape (E,)).

        Activations resolve once at the block site (``self.name``).  The
        expert *weights* additionally honor per-expert sub-sites
        ``{self.name}/experts.{e}``: expert-indexed map rules QDQ each
        expert against its own rule, and offline-compressed ``ExpertBank``
        params are consumed per entry — dense entries skip the dequant.
        ``q`` is accepted for the layer interface; the reference reads no
        static scale here either.
        """
        # every contraction in full f32 (the one-hot dispatch is then exact)
        torch.backends.cuda.matmul.allow_tf32 = False
        pmap = policy
        policy = resolve_policy(policy, self.name)
        B, S, D = x.shape
        E = self.n_experts
        T = min(self.group_tokens, B * S)
        assert (B * S) % T == 0, (B, S, T)
        G = B * S // T
        xg = x.reshape(G, T, D)
        xg = shd.constrain(xg, ("batch", None, "embed"))

        # --- routing, then the aux load-balancing loss (Switch) ----------
        probs, dispatch, combine, fill = self.route(params["router"], xg)
        density = (dispatch.sum(-1) > 0).to(torch.float32).mean(dim=1)
        router_prob_per_e = probs.mean(dim=1)
        aux_loss = (density * router_prob_per_e).mean() * E * E

        # --- dispatch -> expert FFN -> combine ---------------------------
        xin = torch.einsum("gtec,gtd->gecd", dispatch.to(torch.float32),
                           xg.to(torch.float32)).to(x.dtype)
        xin = shd.constrain(xin, (None, "experts", None, "embed"))
        xin_q = qdq_activation(xin, policy.input if policy.enabled else None,
                               axis=-1, site=self.name + "/in")

        per_expert = has_expert_rules(pmap)

        def expert_weights(w):
            # serving-transform storage arrives as leaves; import lazily to
            # keep nn -> models import-order-free
            from repro_torch.models.serving_transforms import (
                CompressedKernel, ExpertBank, decompress_kernel)
            if isinstance(w, ExpertBank):
                # offline-compressed store: each entry dequants per its own
                # stored format; dense entries pass through
                return w.dense(torch.float32)
            if isinstance(w, CompressedKernel):
                return decompress_kernel(w, torch.float32)
            if per_expert:
                cols = []
                for e in range(E):
                    pe = resolve_policy(pmap, f"{self.name}/experts.{e}")
                    tq = pe.weight if pe.enabled else None
                    cols.append(qdq_weight(w[e], tq, contract_axis=0))
                return torch.stack(cols, dim=0)
            return qdq_weight(w, policy.weight if policy.enabled else None,
                              contract_axis=1)

        def expert_mm(h, w, spec):
            return contract(spec, h.to(torch.float32),
                            expert_weights(w).to(torch.float32))

        hi = expert_mm(xin_q, params["wi"], "gecd,edf->gecf")
        if self.gated:
            hg = expert_mm(xin_q, params["wg"], "gecd,edf->gecf")
            h = _ACTS[GATED[self.act]](hg) * hi
        else:
            h = _ACTS[self.act](hi)
        h = shd.constrain(h, (None, "experts", None, "moe_mlp"))
        h = h.to(x.dtype)
        h_q = qdq_activation(h, policy.input if policy.enabled else None,
                             axis=-1, site=self.name + "/mid")
        eout = expert_mm(h_q, params["wo"], "gecf,efd->gecd")
        eout = shd.constrain(eout, (None, "experts", None, "embed"))

        y = torch.einsum("gtec,gecd->gtd", combine, eout)
        y = y.reshape(B, S, D).to(getattr(torch, self.dtype))
        y = shd.constrain(y, ("batch", "seq_res", "embed"))
        metrics = {"moe_aux_loss": aux_loss,
                   "expert_load": fill.sum(dim=0).to(torch.float32)}
        return y, metrics
