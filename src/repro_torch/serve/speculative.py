"""Self-speculative serving: a low-precision draft minted from the SAME
weights accelerates the full-precision target.

``SpeculativeServeEngine`` holds ONE param tree and two policies.  The
draft side serves a compressed low-precision variant (weights compressed
once against the draft policy; the ``compressed`` backend contracts the
stored codes directly); the target side serves the original params under
the target policy.  Every decode round runs draft-k / verify-accept:

1. **Draft**: k + 1 batched S = 1 decode steps.  Step 0 consumes the
   pending token ``cur`` (sampled last round, not yet in any KV); step i
   consumes the previous draft sample.  The first k outputs are the
   drafts d_1..d_k; the (k+1)-th step's OUTPUT is discarded — the step
   exists to write d_k's KV, so after a full acceptance the draft cache
   is never behind and no catch-up bookkeeping ever runs.
2. **Verify**: the target scores the whole ``[cur, d_1..d_k]`` chunk in
   ONE pass (``chunk_step`` on the fixed-slot cache, ``paged_step`` with
   ``all_logits=True`` on pages) of S = k + 1 tokens, not k decode steps.
   Position i of the returned logits is the target's distribution for
   the token AFTER ``[cur, d_1..d_i]``.
3. **Accept**: greedy requests take the longest prefix where the
   target's argmax reproduces each draft, then the target's argmax at
   the first disagreement (a correction if a < k, the free bonus token
   if a = k) — by construction the emitted stream is token-identical to
   target-only greedy decoding.  Stochastic requests run standard
   rejection sampling: accept d_i with prob min(1, p_t(d_i)/p_d(d_i)),
   resample the first rejection from norm(max(p_t - p_d, 0)), bonus-
   sample from p_t on full acceptance — the emitted distribution is
   exactly the target's.  Sampling and acceptance are numpy on the host
   with a ``np.random.Generator`` a request (seeded from ``req.seed`` or
   ``req.uid``), the reference package's code: the same logits give the
   same tokens.

**KV rollback is a host-side position reset.**  The engine tracks one
``ctx`` array (tokens actually IN the committed context); every round
starts by uploading ``ctx`` once, and both sides take that tensor as
their ``DecodeState.position``.  Entries past the reset position are invisible
to attention (the ring validity mask / paged ``n_ctx`` mask) and get
overwritten by the next round's writes, so a rejection at position j
needs no cache surgery — and on the paged side no page ever moves: pages
are reserved once at admission (worst case ``prompt + max_new +
draft_k``: verify can overshoot the natural end by up to k tokens) and
freed once at eviction, which keeps the page accounting (allocs ==
frees, zero in use after drain) intact by construction.

Quantized KV pages are rejected: the paged cache's S > 1 write path
requires page-aligned chunks and its per-(page, head) scales only
ratchet upward — a k+1 verify chunk is rarely aligned and a rollback
could never lower the scales.  The fixed-slot INT8 ring cache (per-token
scales, overwrite-in-place) is fully supported.

The engine runs on ``device`` (default the card), where the model and
params must live; the steps are eager calls on it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.messages import (spec_draft_k_message,
                                           spec_kv_mismatch_message,
                                           spec_quantized_pages_message)
from repro_torch.core.policy import Policy, QuantPolicy, kv_cache_mode
from repro_torch.serve import steps as serve_steps
from repro_torch.serve.engine import Request, _EngineBase, copy_into_slot
from repro_torch.serve.kv_pages import (PageGeometry, PagePool,
                                        check_geometry, pages_for)


# ---------------------------------------------------------------------------
# Host-side sampling / acceptance (numpy; per-request np.random streams)
# ---------------------------------------------------------------------------
def _probs(logits: np.ndarray, temperature: float, top_k: int) -> np.ndarray:
    """Temperature/top-k transformed distribution, (V,) -> (V,).

    The SAME transform is applied to draft and target logits before the
    acceptance test — rejection sampling is exact w.r.t. the transformed
    target distribution, which is what a target-only sampler would draw
    from."""
    x = np.asarray(logits, np.float64)
    if top_k and top_k > 0:
        kth = np.sort(x)[-min(top_k, x.size)]
        x = np.where(x >= kth, x, -np.inf)
    x = x / max(float(temperature), 1e-6)
    x = x - x.max()
    p = np.exp(x)
    return p / p.sum()


def _host_sample(rng: np.random.Generator, logits: np.ndarray,
                 temperature: float, top_k: int) -> int:
    if temperature <= 0:
        return int(np.argmax(logits))
    p = _probs(logits, temperature, top_k)
    return int(rng.choice(p.size, p=p))


def greedy_accept(drafts: np.ndarray, vlogits: np.ndarray) -> tuple[int, int]:
    """Longest-prefix exact-match acceptance.

    ``drafts``: (k,) proposed tokens; ``vlogits``: (k+1, V) target logits
    (row i = distribution after ``[cur, d_1..d_i]``).  Returns
    ``(a, next_token)``: a in [0, k] drafts accepted, plus the target's
    argmax at the first disagreement (correction) or past the last draft
    (bonus) — always exactly a + 1 tokens emitted per target step.
    """
    k = len(drafts)
    a = 0
    while a < k and int(np.argmax(vlogits[a])) == int(drafts[a]):
        a += 1
    return a, int(np.argmax(vlogits[a]))


def rejection_accept(rng: np.random.Generator, drafts: np.ndarray,
                     dlogits: np.ndarray, vlogits: np.ndarray,
                     temperature: float, top_k: int) -> tuple[int, int]:
    """Standard speculative rejection sampling (Leviathan et al.).

    Accept d_i with probability min(1, p_t(d_i) / p_d(d_i)); on the
    first rejection resample from norm(max(p_t - p_d, 0)); on full
    acceptance bonus-sample from the target's next distribution.  The
    emitted tokens are distributed exactly as target-only sampling.
    """
    k = len(drafts)
    for i in range(k):
        pt = _probs(vlogits[i], temperature, top_k)
        pd = _probs(dlogits[i], temperature, top_k)
        d = int(drafts[i])
        if rng.random() * pd[d] <= pt[d]:
            continue
        resid = np.maximum(pt - pd, 0.0)
        tot = resid.sum()
        if tot <= 0:  # distributions identical at machine precision
            return i, int(rng.choice(pt.size, p=pt))
        return i, int(rng.choice(resid.size, p=resid / tot))
    pt = _probs(vlogits[k], temperature, top_k)
    return k, int(rng.choice(pt.size, p=pt))


def _host(logits: torch.Tensor) -> np.ndarray:
    return logits.float().cpu().numpy()


# ---------------------------------------------------------------------------
# Per-policy sides: each owns params, a DecodeState and its steps
# ---------------------------------------------------------------------------
class _FixedSide:
    """Fixed-slot ring-buffer KV for one policy (draft or target)."""

    def __init__(self, model, params, policy: Policy, *, n_slots: int,
                 max_len: int, prefill_bucket: int, device):
        self.model = model
        self.params = params
        self.policy = policy
        self.n_slots = n_slots
        self.max_len = max_len
        self.prefill_bucket = prefill_bucket
        self.device = device
        mode = kv_cache_mode(policy)
        state = model.init_decode_state(n_slots, max_len,
                                        kv_quant=(mode == "int8"))
        if getattr(state, "ssm", None) is not None:
            raise TypeError(
                "speculative serving is attention-family only; SSM "
                "recurrent state cannot roll back a rejected suffix")
        self.state = state._replace(position=torch.zeros(
            (n_slots,), dtype=torch.int32, device=device))
        self._decode = serve_steps.make_draft_step(model, policy)
        self._verify = serve_steps.make_verify_step(model, policy)

    # -- admission -----------------------------------------------------
    def can_admit(self, slot: int, need_tokens: int) -> bool:
        return True

    def reserve(self, slot: int, need_tokens: int):
        pass

    def release(self, slot: int):
        pass

    def prefill_into(self, slot: int, prompt: np.ndarray) -> np.ndarray:
        """Bucketed batch-1 prefill copied into the slot's cache rows;
        returns the last-token logits (V,)."""
        S = len(prompt)
        b = self.prefill_bucket
        padded = min(-(-S // b) * b, self.max_len)
        tokens = np.zeros((1, padded), np.int32)
        tokens[0, :S] = prompt
        dev = self.device
        logits, sub = self.model.prefill(
            self.params, {"tokens": torch.as_tensor(tokens, device=dev)},
            self.policy, max_len=self.max_len,
            n_valid=torch.tensor([S], dtype=torch.int32, device=dev))
        copy_into_slot(self.state.kv, sub.kv, slot)
        position = self.state.position.clone()
        position[slot] = S
        self.state = self.state._replace(position=position)
        return _host(logits[0])

    # -- stepping ------------------------------------------------------
    def decode(self, tokens: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """One S = 1 step over all slots -> (B, V) logits."""
        del mask  # fixed-slot rows are independent; garbage rows ignored
        logits, self.state = self._decode(
            self.params, torch.as_tensor(tokens, device=self.device),
            self.state)
        return _host(logits)

    def verify(self, chunk: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Score a (B, S) chunk -> (B, S, V) all-position logits."""
        n_valid = mask.astype(np.int32) * chunk.shape[1]
        logits, self.state = self._verify(
            self.params, torch.as_tensor(chunk, device=self.device),
            self.state, torch.as_tensor(n_valid, device=self.device))
        return _host(logits)

    def set_positions(self, ctx: torch.Tensor):
        """``ctx``: the committed positions, already on the device (one
        upload serves both sides; no step changes it in place)."""
        self.state = self.state._replace(position=ctx)

    def stats(self) -> dict:
        return {}


class _PagedSide:
    """Paged KV (own PagePool + page table) for one policy."""

    def __init__(self, model, params, policy: Policy, *, n_slots: int,
                 max_len: int, geometry: PageGeometry, device):
        self.model = model
        self.params = params
        self.policy = policy
        self.n_slots = n_slots
        self.max_len = max_len
        self.geometry = geometry
        self.device = device
        # quantized pages were rejected at the engine level: speculative
        # paged serving always stores fp pages
        self.state = model.init_paged_state(
            n_slots, page_size=geometry.page_size, n_pages=geometry.n_pages,
            max_pages_per_seq=geometry.max_pages_per_seq, kv="fp")
        self.pool = PagePool(geometry.n_pages)
        self.table = np.full((n_slots, geometry.max_pages_per_seq), -1,
                             np.int32)
        self.slot_pages: list[list[int]] = [[] for _ in range(n_slots)]
        self._chunk = serve_steps.make_draft_step(model, policy, paged=True)
        self._verify_fn = serve_steps.make_verify_step(model, policy,
                                                       paged=True)

    # -- admission -----------------------------------------------------
    def can_admit(self, slot: int, need_tokens: int) -> bool:
        return self.pool.can_alloc(
            pages_for(need_tokens, self.geometry.page_size))

    def reserve(self, slot: int, need_tokens: int):
        need = pages_for(need_tokens, self.geometry.page_size)
        pages = self.pool.alloc(need)
        assert pages is not None, "reserve() without can_admit()"
        self.slot_pages[slot] = pages
        self.table[slot, :] = -1
        self.table[slot, :need] = pages
        position = self.state.position.clone()
        position[slot] = 0
        self.state = self.state._replace(position=position)

    def release(self, slot: int):
        self.pool.free(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self.table[slot, :] = -1

    def _with_table(self, mask: np.ndarray):
        """The state with non-participating rows unmapped (-1): their
        writes route to the trash page inside the step."""
        table = torch.as_tensor(
            np.where(mask[:, None], self.table, -1).astype(np.int32),
            device=self.device)
        return self.state._replace(
            pages=self.state.pages._replace(table=table))

    def prefill_into(self, slot: int, prompt: np.ndarray) -> np.ndarray:
        """Stream the prompt through the chunk step (only this row
        valid); returns the last-token logits (V,)."""
        C = self.geometry.prefill_chunk
        mask = np.zeros(self.n_slots, bool)
        mask[slot] = True
        out = None
        for off in range(0, len(prompt), C):
            m = min(C, len(prompt) - off)
            tokens = np.zeros((self.n_slots, C), np.int32)
            tokens[slot, :m] = prompt[off:off + m]
            n_valid = np.zeros(self.n_slots, np.int32)
            n_valid[slot] = m
            out, self.state = self._chunk(
                self.params, torch.as_tensor(tokens, device=self.device),
                self._with_table(mask),
                torch.as_tensor(n_valid, device=self.device))
        return _host(out[slot])

    # -- stepping ------------------------------------------------------
    def decode(self, tokens: np.ndarray, mask: np.ndarray) -> np.ndarray:
        logits, self.state = self._chunk(
            self.params, torch.as_tensor(tokens, device=self.device),
            self._with_table(mask),
            torch.as_tensor(mask.astype(np.int32), device=self.device))
        return _host(logits)

    def verify(self, chunk: np.ndarray, mask: np.ndarray) -> np.ndarray:
        n_valid = mask.astype(np.int32) * chunk.shape[1]
        logits, self.state = self._verify_fn(
            self.params, torch.as_tensor(chunk, device=self.device),
            self._with_table(mask),
            torch.as_tensor(n_valid, device=self.device))
        return _host(logits)

    def set_positions(self, ctx: torch.Tensor):
        self.state = self.state._replace(position=ctx)

    def stats(self) -> dict:
        return self.pool.stats()


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
class SpeculativeServeEngine(_EngineBase):
    """Draft-k / verify-accept continuous batching over ONE param tree.

    ``kv_cache``: 'fixed' (ring buffer) or 'paged' (page pools — one per
    side, fp page storage).  ``compress_draft=True`` compresses the
    weights once against the draft policy so the draft genuinely serves
    at its low precision; the target always serves the original params.
    ``device`` defaults to the card and must be where ``params`` live.
    """

    def __init__(
        self,
        model,
        params,
        *,
        target_policy: Policy = QuantPolicy(),
        draft_policy: Policy,
        draft_k: int = 4,
        n_slots: int = 4,
        max_len: int = 512,
        kv_cache: str = "fixed",
        prefill_bucket: int = 64,
        page_size: int = 16,
        n_pages: int | None = None,
        prefill_chunk: int | None = None,
        compress_draft: bool = True,
        device="cuda",
    ):
        if kv_cache not in ("fixed", "paged"):
            raise ValueError(
                f"kv_cache must be 'fixed' or 'paged'; got {kv_cache!r}")
        if not (1 <= draft_k < max_len):
            raise ValueError(spec_draft_k_message(draft_k, max_len))
        dmode = kv_cache_mode(draft_policy)
        tmode = kv_cache_mode(target_policy)
        if dmode != tmode:
            raise ValueError(spec_kv_mismatch_message(dmode, tmode))
        if kv_cache == "paged" and tmode in ("int8", "fp8"):
            raise ValueError(spec_quantized_pages_message(tmode))
        if kv_cache == "fixed" and tmode == "fp8":
            raise ValueError(
                "kv_cache='fp8' is paged-only and paged speculative "
                "serving requires fp pages; drop the fp8 kv_cache mode")
        self._bind(model, params, device)
        self.policy = target_policy
        self.draft_k = draft_k
        self.n_slots = n_slots
        self.max_len = max_len
        self.kv_cache = kv_cache

        draft_params = params
        self.weight_bytes = None
        if compress_draft:
            from repro_torch.models import serving_transforms as st

            draft_params = st.compress_weights(params, draft_policy)
            self.weight_bytes = st.weight_bytes_report(params, draft_params)
            draft_policy = st.serving_policy(draft_policy)
        self.draft_policy = draft_policy
        self.params = params

        dev = self.device
        if kv_cache == "paged":
            if prefill_chunk is None:
                prefill_chunk = max(page_size,
                                    -(-64 // page_size) * page_size)
            geo = PageGeometry(
                page_size=page_size,
                n_pages=(n_pages if n_pages is not None
                         else n_slots * pages_for(max_len, page_size)),
                max_len=max_len, prefill_chunk=prefill_chunk)
            check_geometry(geo)
            self.geometry = geo
            side = lambda p, pol: _PagedSide(
                model, p, pol, n_slots=n_slots, max_len=max_len,
                geometry=geo, device=dev)
        else:
            self.geometry = None
            side = lambda p, pol: _FixedSide(
                model, p, pol, n_slots=n_slots, max_len=max_len,
                prefill_bucket=prefill_bucket, device=dev)
        self.draft = side(draft_params, draft_policy)
        self.target = side(params, target_policy)

        # host bookkeeping
        self.active = np.zeros(n_slots, dtype=bool)
        self._cur = np.zeros((n_slots, 1), np.int32)
        self._ctx = np.zeros(n_slots, np.int32)  # committed tokens in KV
        self._rngs: list[np.random.Generator | None] = [None] * n_slots
        self._slot_target_steps = np.zeros(n_slots, np.int64)
        self._slot_drafted = np.zeros(n_slots, np.int64)
        self._slot_accepted = np.zeros(n_slots, np.int64)
        self._slot_emitted = np.zeros(n_slots, np.int64)
        self.stats = {"rounds": 0, "slot_rounds": 0, "draft_steps": 0,
                      "target_steps": 0, "drafted": 0, "accepted": 0,
                      "emitted": 0}
        self._init_common(n_slots)

    # ------------------------------------------------------------- queueing
    def submit(self, req: Request):
        # verify can overshoot the natural end by up to draft_k tokens;
        # both the ring cache and the page reservation carry the headroom
        need = len(req.prompt) + req.max_new_tokens + self.draft_k
        if need > self.max_len:
            raise ValueError(
                f"request exceeds engine max_len: prompt of "
                f"{len(req.prompt)} tokens + max_new_tokens="
                f"{req.max_new_tokens} + draft_k={self.draft_k} headroom "
                f"needs {need} > max_len={self.max_len}")
        self.queue.append(req)

    def _completion_extra(self, slot: int) -> dict:
        return {
            "target_steps": int(self._slot_target_steps[slot]),
            "drafted_tokens": int(self._slot_drafted[slot]),
            "accepted_draft_tokens": int(self._slot_accepted[slot]),
        }

    def _sync_positions(self):
        """Rollback / commit: ONE upload of ``ctx``, taken by both sides
        (rejected suffixes become invisible; no page moves, no leaks)."""
        ctx = torch.as_tensor(self._ctx.astype(np.int32), device=self.device)
        self.draft.set_positions(ctx)
        self.target.set_positions(ctx)

    # ------------------------------------------------------------ admission
    def _admit(self):
        while self.queue:
            free = [s for s in range(self.n_slots) if not self.active[s]]
            if not free:
                return
            req = self.queue[0]
            slot = free[0]
            need = len(req.prompt) + req.max_new_tokens + self.draft_k
            # FCFS: the queue head waits until BOTH pools can reserve
            if not (self.draft.can_admit(slot, need)
                    and self.target.can_admit(slot, need)):
                return
            self.queue.pop(0)
            self.draft.reserve(slot, need)
            self.target.reserve(slot, need)
            prompt = np.asarray(req.prompt, np.int32)
            self.draft.prefill_into(slot, prompt)  # logits unused: the
            # draft never predicts the first token, only continuations
            tlogits = self.target.prefill_into(slot, prompt)
            seed = req.uid if req.seed is None else req.seed
            self._rngs[slot] = np.random.default_rng(seed)
            first = _host_sample(self._rngs[slot], tlogits,
                                 req.temperature, req.top_k)
            self.req[slot] = req
            self.generated[slot] = [first]
            self.active[slot] = True
            self._cur[slot, 0] = first
            self._ctx[slot] = len(prompt)
            self._slot_target_steps[slot] = 0
            self._slot_drafted[slot] = 0
            self._slot_accepted[slot] = 0
            self._slot_emitted[slot] = 0
            if req.eos_id is not None and first == req.eos_id:
                self._evict(slot, "eos")
            elif req.max_new_tokens <= 1:
                self._evict(slot, "length")

    def _evict(self, slot: int, reason: str):
        self._complete(slot, reason)
        self.draft.release(slot)
        self.target.release(slot)
        self.active[slot] = False
        self._rngs[slot] = None

    def _has_work(self) -> bool:
        return bool(self.queue) or bool(self.active.any())

    # ---------------------------------------------------------------- round
    def _draft_phase(self, mask: np.ndarray, need_dist: bool):
        """k + 1 draft steps: (drafts (B, k), draft logits (B, k, V) when
        a stochastic row needs the distribution, else None)."""
        k, B = self.draft_k, self.n_slots
        drafts = np.zeros((B, k), np.int32)
        dlogits = None
        tok_in = self._cur.copy()
        for i in range(k + 1):
            logits = self.draft.decode(tok_in, mask)  # (B, V)
            self.stats["draft_steps"] += 1
            if i == k:
                break  # pre-pay step: d_k's KV is written; output unused
            if need_dist:
                if dlogits is None:
                    dlogits = np.zeros((B, k, logits.shape[1]), np.float32)
                dlogits[:, i] = logits
            for s in range(B):
                if not mask[s]:
                    continue
                req = self.req[s]
                if req.temperature > 0:
                    drafts[s, i] = _host_sample(
                        self._rngs[s], logits[s], req.temperature,
                        req.top_k)
                else:
                    drafts[s, i] = int(np.argmax(logits[s]))
            tok_in = drafts[:, i:i + 1]
        return drafts, dlogits

    def tick(self):
        """One engine iteration: admit -> draft k (+1) -> verify -> accept
        -> position rollback/commit."""
        self._admit()
        if not self.active.any():
            self.ticks += 1
            return
        self._sync_positions()
        k = self.draft_k
        B = self.n_slots
        mask = self.active.copy()
        need_dist = any(self.req[s].temperature > 0
                        for s in range(B) if mask[s])
        drafts, dlogits = self._draft_phase(mask, need_dist)

        # ---- verify: ONE chunked target pass over [cur, d_1..d_k]
        chunk = np.concatenate([self._cur, drafts], axis=1)  # (B, k+1)
        vlogits = self.target.verify(chunk, mask)  # (B, k+1, V)

        # ---- accept + commit
        new_ctx = self._ctx.copy()
        for s in range(B):
            if not mask[s]:
                continue
            req = self.req[s]
            if req.temperature > 0:
                a, nxt = rejection_accept(
                    self._rngs[s], drafts[s], dlogits[s], vlogits[s],
                    req.temperature, req.top_k)
            else:
                a, nxt = greedy_accept(drafts[s], vlogits[s])
            self._slot_target_steps[s] += 1
            self._slot_drafted[s] += k
            self._slot_accepted[s] += a
            self.stats["slot_rounds"] += 1
            self.stats["target_steps"] += 1
            self.stats["drafted"] += k
            self.stats["accepted"] += a
            # emit sequentially: d_1..d_a then the correction/bonus;
            # eos or the length cap can cut the stream anywhere
            emitted = [int(t) for t in drafts[s, :a]] + [nxt]
            finished = None
            for t in emitted:
                self.generated[s].append(t)
                self._slot_emitted[s] += 1
                self.stats["emitted"] += 1
                if req.eos_id is not None and t == req.eos_id:
                    finished = "eos"
                    break
                if len(self.generated[s]) >= req.max_new_tokens:
                    finished = "length"
                    break
            if finished is not None:
                self._evict(s, finished)
                continue
            # cur + a accepted drafts are now committed context; the
            # last emitted token is the new pending cur (not in KV yet)
            new_ctx[s] = self._ctx[s] + 1 + a
            self._cur[s, 0] = emitted[-1]

        # the positions reset at the start of the next round
        self._ctx = new_ctx
        self.stats["rounds"] += 1
        self.ticks += 1

    # ----------------------------------------------------------- reporting
    @property
    def utilization(self) -> float:
        return float(self.active.mean())

    @property
    def accepted_per_target_step(self) -> float:
        """Tokens emitted per target verify pass (> 1.0 means the draft
        is paying for itself; k + 1 is the ceiling)."""
        if self.stats["slot_rounds"] == 0:
            return 0.0
        return self.stats["emitted"] / self.stats["slot_rounds"]

    def acceptance_stats(self) -> dict:
        out = dict(self.stats)
        out["draft_k"] = self.draft_k
        out["accepted_per_target_step"] = self.accepted_per_target_step
        out["acceptance_rate"] = (
            self.stats["accepted"] / self.stats["drafted"]
            if self.stats["drafted"] else 0.0)
        return out

    def page_stats(self) -> dict:
        """Combined pool accounting (paged mode): draft + target pools."""
        if self.kv_cache != "paged":
            return {}
        return {"draft": self.draft.stats(), "target": self.target.stats()}
