"""Continuous-batching serving engines (eager PyTorch).

Two engines share the queue / completion machinery:

``ServeEngine`` — fixed-slot ring-buffer KV.  ``n_slots`` sequences share
one batched DecodeState sized ``(n_slots, max_len)``; prefill runs per
request at a *bucketed* length (prompts are right-padded to the next
multiple of ``prefill_bucket`` and masked via ``n_valid``, so at most
``max_len / prefill_bucket`` distinct prefill shapes occur) and the
resulting batch-1 cache is copied into the slot's rows.  Every tick is one
batched decode step; idle slots compute garbage — the fixed-shape tax.
The SSM family serves through it too, with a per-slot recurrent state
(conv window + SSM state) in place of the ring buffer and an exact-length
prefill (a padded tail would enter the recurrence).

``PagedServeEngine`` — vLLM-style paged KV (``serve.kv_pages``).  All
slots share one physical page pool per layer; a host-side ``PagePool``
hands out fixed-size pages at admission (the worst case
``pages_for(prompt + max_new_tokens)`` is reserved up front, so decode
never deadlocks mid-sequence) and a per-slot page table maps logical to
physical pages.  Prefill is *chunked* through the same ``paged_step`` the
decode tick uses — one ``prefill_chunk`` tile per prefilling slot per
tick, interleaved with decode — so exactly two step shapes exist:
``(n_slots, prefill_chunk)`` and ``(n_slots, 1)``.  Pages can store fp,
INT8 or FP8 codes with per-(page, head) scales; ``kv="auto"`` follows the
policy's ``kv_cache`` mode.

The engine is token-identical to a straight prefill-then-decode of the
same request (masked rows are zeroed *before* any seq-axis requant, so
paging never perturbs quantizer group maxima — see ``nn.attention``).

Quantized serving: pass a policy; weights/activations get ABFP QDQ inside
every step (the paper's inference story).

Compressed serving (``compress=True``): weights are compressed ONCE at
engine construction against each kernel's *resolved* site rule
(``models.serving_transforms.compress_weights``) and the runtime policy
drops its weight quantizers; qmatmul's ``compressed`` execution backend
then contracts the stored codes directly, so decode never dequantizes a
kernel.  ``engine.weight_bytes`` records the resident-byte accounting.

Expert-resident MoE serving: when ``compress=True`` meets an MoE model,
the per-expert compressed banks are collected into a
``serve.experts.ExpertStore`` — an LRU (``expert_cache`` capacity) of
decompressed-dense expert copies fed by a routing-frequency probe at
admission.  ``refresh_experts()`` swaps cache-resident experts into the
params (skipping their per-step dequant); cache state is pure
representation, so hits/misses/refreshes never change tokens.
``expert_stats()`` reports hit/miss + residency split hot/cold.

Speculative serving (a compressed draft, a verifying target) is
``serve.speculative.SpeculativeServeEngine``, on the same base.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.analysis import messages as msg
from repro_torch.core.policy import (Policy, QuantPolicy, attn_backend_mode,
                                     kv_cache_mode)
from repro_torch.models.lm import DecodeState
from repro_torch.nn.module import require_device
from repro_torch.serve import steps as serve_steps
from repro_torch.serve.kv_pages import (PageGeometry, PagePool,
                                        attention_read_bytes, check_geometry,
                                        pages_for, resident_kv_bytes)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 32
    eos_id: int | None = None
    # sampling: 0 temperature is exact argmax; top_k <= 0 keeps the full
    # distribution; seed None derives the request's stream from its uid
    temperature: float = 0.0
    top_k: int = 0
    seed: int | None = None


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: list  # generated ids (first token from prefill logits included)
    prompt_len: int
    finished_reason: str  # 'eos' | 'length'
    # per-request serving metadata (speculative engines fill these in;
    # plain engines leave the defaults)
    target_steps: int = 0
    drafted_tokens: int = 0
    accepted_draft_tokens: int = 0


class TickBudgetExhausted(RuntimeError):
    """``run_until_done`` ran out of ticks with work still in flight.

    The partial results travel on the exception: ``completions`` holds
    what finished, ``unfinished`` the uids still queued or resident in a
    slot — a truncated run must never look like a finished one.
    """

    def __init__(self, max_ticks: int, completions: list, unfinished: list):
        self.max_ticks = max_ticks
        self.completions = completions
        self.unfinished = unfinished
        super().__init__(
            f"tick budget of {max_ticks} exhausted with "
            f"{len(unfinished)} request(s) unfinished (uids {unfinished}); "
            "finished completions are on .completions"
        )


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def _tree_devices(tree, out: set):
    if isinstance(tree, torch.Tensor):
        out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tree_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tree_devices(v, out)
    elif hasattr(tree, "codes"):  # CompressedKernel
        out.add(tree.codes.device)
        out.add(tree.scale.device)
    elif hasattr(tree, "entries"):  # ExpertBank
        _tree_devices(list(tree.entries), out)
    return out


def copy_into_slot(full_caches, part_caches, slot: int) -> None:
    """Copy each layer's batch-1 prefill cache (ring, or SSM conv window and
    state) into row ``slot`` of the engine's batched caches, in place."""
    for full, part in zip(full_caches, part_caches):
        for f, p in zip(full, part):
            if f is None or f.ndim == 0:
                continue  # absent scales / the scalar length mark
            if p.shape[0] != 1:
                raise ValueError(
                    f"prefill state must be batch-1 along axis 0 to "
                    f"scatter into a slot; got shape {tuple(p.shape)}")
            if p.shape[1:] != f.shape[1:]:
                raise ValueError(
                    "prefill cache shape mismatch — prefill with the "
                    f"engine's max_len: got {tuple(p.shape)} vs engine "
                    f"{tuple(f.shape)} (batch axis 0)")
            f[slot] = p[0].to(f.dtype)


class _EngineBase:
    """Queue / completion bookkeeping shared by the engines."""

    model: object
    params: object
    policy: Policy
    n_slots: int
    max_len: int
    expert_store = None  # set by MoE compressed construction

    def _bind(self, model, params, device):
        """Check that the model and every parameter live on ``device`` (the
        engine moves nothing between devices on its own)."""
        self.model = model
        self.device = require_device(device)
        for where in (*_tree_devices(params, set()), model.device):
            if not _same_device(where, self.device):
                raise ValueError(
                    f"engine device is {self.device} but the model or its "
                    f"params live on {where}; build and init the model on "
                    "the engine's device")

    def _compress(self, params, policy, compress: bool,
                  expert_cache: int | None = None):
        """Compressed serving: weights stored per resolved site rule once,
        the runtime policy without weight quantizers; on an MoE model the
        expert banks also go into an ``ExpertStore``."""
        self.weight_bytes = None
        served = None
        if compress:
            from repro_torch.models import serving_transforms as st

            served = st.compress_weights(params, policy)
            self.weight_bytes = st.weight_bytes_report(params, served)
            params = served
            policy = st.serving_policy(policy)
        self._build_expert_store(served, expert_cache, compress)
        self.params = params
        self.policy = policy

    # ------------------------------------------------------- expert store
    def _build_expert_store(self, served, expert_cache: int | None,
                            compress: bool) -> None:
        """Validate the ``expert_cache`` request and, when compressed
        serving meets an MoE model, collect the expert banks into an
        ``ExpertStore`` (per-expert backing entries + LRU caches)."""
        name = getattr(self.model.cfg, "name", "?")
        if expert_cache is not None:
            if not compress:
                raise ValueError(msg.expert_cache_requires_compress_message())
            if not getattr(self.model, "is_moe", False):
                raise ValueError(msg.expert_non_moe_message(
                    "an expert cache", name))
        if compress and getattr(self.model, "is_moe", False):
            from repro_torch.serve.experts import ExpertStore

            try:
                self.expert_store = ExpertStore(
                    served, capacity=int(expert_cache or 0),
                    model_name=name)
            except ValueError:
                # float-rule banks stayed plain dense stacks — nothing to
                # store; serving is dense-resident and trivially identical
                self.expert_store = None

    def _observe_experts(self, prompt) -> None:
        """Probe routing loads for an admitted prompt and feed the store.

        The probe pads the prompt to a multiple of the MoE group size
        (the dispatch asserts ``(B*S) % group_tokens == 0``) — pad-token
        routes only perturb the frequency counters, and counters / cache
        state never enter the compute path, so tokens are unaffected.
        ``Model.expert_loads`` runs eagerly at that padded length."""
        if self.expert_store is None:
            return
        p = np.asarray(prompt, np.int32).reshape(-1)
        gt = max(1, getattr(self.model.cfg, "moe_group_tokens", 1))
        padded = max(gt, -(-len(p) // gt) * gt)
        if padded != len(p):
            p = np.concatenate([p, np.zeros(padded - len(p), np.int32)])
        loads = self.model.expert_loads(
            self.params, torch.as_tensor(p[None], device=self.device),
            policy=self.policy)
        self.expert_store.observe(loads.cpu().numpy())

    def refresh_experts(self) -> None:
        """Swap cache-resident experts into the serving params (and
        evicted ones back to their compressed entries).  Tokens are
        unchanged by construction — the cached dense copies equal the
        dequantized backing entries bit for bit."""
        if self.expert_store is None:
            raise ValueError(
                "refresh_experts: engine has no expert store (construct "
                "with compress=True on an MoE model)")
        self.params = self.expert_store.materialize(self.params)

    def expert_stats(self) -> dict | None:
        """The store's residency/traffic report, or None when expert-
        resident serving is inactive."""
        return (None if self.expert_store is None
                else self.expert_store.stats())

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """(n_slots, vocab) logits -> (n_slots, 1) sampled tokens."""
        topk = (torch.as_tensor(self._topk, device=self.device)
                if (self._topk > 0).any() else None)
        return serve_steps.sample_step(logits, self._gens, self._temps, topk)

    def _seed_slot(self, slot: int, req: "Request"):
        self._temps[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._gens[slot].manual_seed(req.uid if req.seed is None else req.seed)

    def _init_common(self, n_slots: int):
        self.req: list[Request | None] = [None] * n_slots
        self.generated: list[list[int]] = [[] for _ in range(n_slots)]
        self.queue: list[Request] = []
        self.done: list[Completion] = []
        self.ticks = 0
        self._temps = np.zeros(n_slots, np.float32)
        self._topk = np.zeros(n_slots, np.int32)
        # one sampling stream per slot, re-seeded at admission
        self._gens = [torch.Generator(device=self.device)
                      for _ in range(n_slots)]

    def submit(self, req: Request):
        need = len(req.prompt) + req.max_new_tokens
        if need > self.max_len:
            raise ValueError(
                f"request exceeds engine max_len: prompt of "
                f"{len(req.prompt)} tokens + max_new_tokens="
                f"{req.max_new_tokens} needs {need} > max_len={self.max_len}"
            )
        self.queue.append(req)

    def _completion_extra(self, slot: int) -> dict:
        """Per-request metadata hook (the speculative engine overrides)."""
        return {}

    def _complete(self, slot: int, reason: str):
        req = self.req[slot]
        self.done.append(
            Completion(
                uid=req.uid,
                tokens=list(self.generated[slot]),
                prompt_len=len(req.prompt),
                finished_reason=reason,
                **self._completion_extra(slot),
            )
        )
        self.req[slot] = None
        self.generated[slot] = []

    def _has_work(self) -> bool:
        raise NotImplementedError

    def _resident_uids(self) -> list[int]:
        return [r.uid for r in self.req if r is not None]

    def tick(self):
        raise NotImplementedError

    def run_until_done(self, max_ticks: int = 10_000) -> list[Completion]:
        """Drive ticks until the queue and slots drain.

        Raises ``TickBudgetExhausted`` (with the partial completions
        attached) if work remains after ``max_ticks`` ticks.
        """
        spent = 0
        while self._has_work():
            if spent >= max_ticks:
                raise TickBudgetExhausted(
                    max_ticks, list(self.done),
                    self._resident_uids() + [r.uid for r in self.queue])
            self.tick()
            spent += 1
        return self.done


class ServeEngine(_EngineBase):
    """Slot-based continuous batching over a TransformerLM-family model.

    ``device`` defaults to the card and must be where ``params`` live; the
    engine moves nothing between devices on its own.  The ring-buffer
    caches are updated in place by every decode step.
    """

    def __init__(
        self,
        model,
        params,
        *,
        n_slots: int = 4,
        max_len: int = 512,
        policy: Policy = QuantPolicy(),
        prefill_bucket: int = 64,
        compress: bool = False,
        expert_cache: int | None = None,
        device="cuda",
    ):
        self._bind(model, params, device)
        mode = kv_cache_mode(policy)  # engine-global cache storage: fail
        # fast on maps whose rules disagree on kv_cache
        if mode == "fp8":
            raise ValueError(msg.fp8_fixed_slot_message())
        self.attn_backend = attn_backend_mode(policy)
        if self.attn_backend == "compressed" and mode != "int8":
            # the decode path would raise this at its first step anyway
            raise ValueError(msg.compressed_attn_storage_message(
                mode, "the ring-buffer cache"))
        self._compress(params, policy, compress, expert_cache)
        self.n_slots = n_slots
        self.max_len = max_len
        self.prefill_bucket = prefill_bucket

        state = model.init_decode_state(n_slots, max_len,
                                        kv_quant=(mode == "int8"))
        if not isinstance(state, DecodeState):
            raise TypeError(
                "ServeEngine drives TransformerLM-family models; got "
                f"{type(state).__name__} from "
                f"{type(model).__name__}.init_decode_state"
            )
        self._is_ssm = state.ssm is not None
        self.state = state._replace(position=torch.zeros(
            (n_slots,), dtype=torch.int32, device=self.device))
        self._cur = np.zeros((n_slots, 1), np.int32)
        self.active = np.zeros(n_slots, dtype=bool)
        self._padded_lengths: set[int] = set()
        self.prefills = 0  # prefill calls made (one per admitted request)
        self._init_common(n_slots)

    def _bucketed(self, S: int) -> int:
        """Pad length for a prompt of S tokens: next bucket multiple,
        capped at max_len.  SSM models prefill at exact length (the
        recurrence would integrate a padded tail — see lm.prefill)."""
        if self._is_ssm:
            return S
        b = self.prefill_bucket
        return min(-(-S // b) * b, self.max_len)

    @property
    def prefill_compiles(self) -> int:
        """Distinct padded prefill lengths seen so far (the reference
        counts compiled prefill programs, one per length; bucketing keeps
        this <= the bucket count)."""
        return len(self._padded_lengths)

    def _insert_state(self, slot: int, sub, prompt_len: int,
                      first_token: int):
        """Copy a batch-1 prefill DecodeState into slot ``slot``: every
        layer's ring cache, or its SSM conv window and state."""
        copy_into_slot(self.state.kv or self.state.ssm, sub.kv or sub.ssm,
                       slot)
        self.state.position[slot] = prompt_len
        self._cur[slot, 0] = first_token

    def _admit(self):
        dev = self.device
        for slot in range(self.n_slots):
            if self.active[slot] or not self.queue:
                continue
            req = self.queue.pop(0)
            self._observe_experts(req.prompt)
            S = len(req.prompt)
            padded = self._bucketed(S)
            tokens = np.zeros((1, padded), np.int32)
            tokens[0, :S] = req.prompt
            n_valid = (None if self._is_ssm  # exact-length prefill
                       else torch.tensor([S], dtype=torch.int32, device=dev))
            logits, sub = self.model.prefill(
                self.params, {"tokens": torch.as_tensor(tokens, device=dev)},
                self.policy, max_len=self.max_len, n_valid=n_valid)
            self._padded_lengths.add(padded)
            self.prefills += 1
            self._seed_slot(slot, req)
            first = self._first_token(slot, req, logits[0:1])
            self.active[slot] = True
            self.req[slot] = req
            self.generated[slot] = [first]
            self._insert_state(slot, sub, S, first)
            if req.eos_id is not None and first == req.eos_id:
                self._evict(slot, "eos")
            elif req.max_new_tokens <= 1:
                self._evict(slot, "length")

    def _first_token(self, slot: int, req: Request,
                     logits: torch.Tensor) -> int:
        """Sample a request's first token from its (1, vocab) prefill
        logits, with the slot's freshly seeded stream."""
        topk = (torch.tensor([req.top_k], device=self.device)
                if req.top_k > 0 else None)
        return int(serve_steps.sample_tokens(
            logits, [self._gens[slot]], [req.temperature], topk)[0, 0])

    def _evict(self, slot: int, reason: str):
        self._complete(slot, reason)
        self.active[slot] = False

    def _has_work(self) -> bool:
        return bool(self.queue) or bool(self.active.any())

    def _decode(self) -> np.ndarray:
        """One batched decode step over every slot (idle ones included)."""
        logits, self.state = self.model.decode_step(
            self.params, torch.as_tensor(self._cur, device=self.device),
            self.state, self.policy)
        return self._sample(logits)[:, 0].cpu().numpy()

    def tick(self):
        """One engine iteration: admit -> batched decode -> evict."""
        self._admit()
        if not self.active.any():
            return
        toks = self._decode()
        self.ticks += 1
        for slot in range(self.n_slots):
            if not self.active[slot]:
                continue
            req = self.req[slot]
            tok = int(toks[slot])
            self.generated[slot].append(tok)
            self._cur[slot, 0] = tok
            if req.eos_id is not None and tok == req.eos_id:
                self._evict(slot, "eos")
            elif len(self.generated[slot]) >= req.max_new_tokens:
                self._evict(slot, "length")

    @property
    def utilization(self) -> float:
        return float(self.active.mean())


class PagedServeEngine(_EngineBase):
    """Paged-KV continuous batching: block pool + chunked prefill.

    Admission reserves a request's worst-case page count from the shared
    ``PagePool`` (FCFS — the queue head blocks, which keeps admission
    order deterministic and can never deadlock a running sequence).
    Prefill streams each prompt through ``paged_step`` one
    ``prefill_chunk`` tile per tick while other slots keep decoding: rows
    not participating in a call carry ``n_valid = 0`` and an all -1 page
    table, so their writes land in the trash page and their position
    doesn't advance — row independence makes the interleaving order
    unobservable in the tokens.

    ``device`` defaults to the card and must be where ``params`` live; the
    engine moves nothing between devices on its own.
    """

    def __init__(
        self,
        model,
        params,
        *,
        n_slots: int = 4,
        max_len: int = 512,
        policy: Policy = QuantPolicy(),
        page_size: int = 16,
        n_pages: int | None = None,
        prefill_chunk: int | None = None,
        kv: str = "auto",
        compress: bool = False,
        expert_cache: int | None = None,
        device="cuda",
    ):
        self._bind(model, params, device)
        mode = kv_cache_mode(policy)
        if kv == "auto":
            kv = {"int8": "int8", "fp8": "fp8"}.get(mode, "fp")
        if kv not in ("fp", "int8", "fp8"):
            raise ValueError(
                f"kv must be 'auto', 'fp', 'int8' or 'fp8'; got {kv!r}")
        if prefill_chunk is None:
            prefill_chunk = max(page_size, -(-64 // page_size) * page_size)
        geo = PageGeometry(page_size=page_size,
                           n_pages=(n_pages if n_pages is not None
                                    else n_slots
                                    * pages_for(max_len, page_size)),
                           max_len=max_len, prefill_chunk=prefill_chunk)
        check_geometry(geo)
        self.geometry = geo
        self.kv = kv
        self.attn_backend = attn_backend_mode(policy)
        if self.attn_backend == "compressed" and kv == "fp":
            # fail at construction, not inside the first paged_step
            raise ValueError(msg.compressed_attn_storage_message(
                "fp", "the paged KV pool"))

        self._compress(params, policy, compress, expert_cache)
        self._paged_step = serve_steps.make_paged_step(model, self.policy)
        self.n_slots = n_slots
        self.max_len = max_len

        self.state = model.init_paged_state(
            n_slots, page_size=geo.page_size, n_pages=geo.n_pages,
            max_pages_per_seq=geo.max_pages_per_seq, kv=kv)
        self.pool = PagePool(geo.n_pages)
        self.table = np.full((n_slots, geo.max_pages_per_seq), -1, np.int32)
        self.slot_pages: list[list[int]] = [[] for _ in range(n_slots)]
        self.active = np.zeros(n_slots, dtype=bool)      # decoding
        self.prefilling = np.zeros(n_slots, dtype=bool)  # mid-prefill
        self._pf_pos = [0] * n_slots  # prompt tokens consumed so far
        self._cur = np.zeros((n_slots, 1), np.int32)
        self.steps = 0  # paged_step calls made (prefill and decode)
        self._init_common(n_slots)

    # ------------------------------------------------------------- the step
    def _step(self, tokens: np.ndarray, n_valid: np.ndarray,
              mask: np.ndarray) -> np.ndarray:
        """One paged step + sampling; returns the sampled token per slot
        (host array).  Rows outside ``mask`` get an unmapped (-1) table
        row: their writes route to the trash page inside the step."""
        dev = self.device
        table = torch.as_tensor(
            np.where(mask[:, None], self.table, -1).astype(np.int32),
            device=dev)
        state = self.state._replace(
            pages=self.state.pages._replace(table=table))
        logits, self.state = self._paged_step(
            self.params, torch.as_tensor(tokens, device=dev), state,
            torch.as_tensor(n_valid.astype(np.int32), device=dev))
        self.steps += 1
        return self._sample(logits)[:, 0].cpu().numpy()

    # ------------------------------------------------------------ admission
    def _admit(self):
        while self.queue:
            free = [s for s in range(self.n_slots)
                    if not self.active[s] and not self.prefilling[s]]
            if not free:
                return
            req = self.queue[0]
            need = pages_for(len(req.prompt) + req.max_new_tokens,
                             self.geometry.page_size)
            pages = self.pool.alloc(need)
            if pages is None:
                return  # FCFS: the head waits for pages; no overtaking
            self.queue.pop(0)
            self._observe_experts(req.prompt)
            slot = free[0]
            self.slot_pages[slot] = pages
            self.table[slot, :] = -1
            self.table[slot, :need] = pages
            self.prefilling[slot] = True
            self.req[slot] = req
            self.generated[slot] = []
            self._pf_pos[slot] = 0
            self._seed_slot(slot, req)
            self.state.position[slot] = 0

    # -------------------------------------------------------------- prefill
    def _prefill_tick(self):
        rows = [s for s in range(self.n_slots) if self.prefilling[s]]
        if not rows:
            return
        C = self.geometry.prefill_chunk
        tokens = np.zeros((self.n_slots, C), np.int32)
        n_valid = np.zeros((self.n_slots,), np.int32)
        for s in rows:
            p = self.req[s].prompt
            off = self._pf_pos[s]
            m = min(C, len(p) - off)
            tokens[s, :m] = p[off:off + m]
            n_valid[s] = m
        toks = self._step(tokens, n_valid, self.prefilling)
        for s in rows:
            self._pf_pos[s] += int(n_valid[s])
            if self._pf_pos[s] < len(self.req[s].prompt):
                continue
            first = int(toks[s])
            self.prefilling[s] = False
            self.active[s] = True
            self.generated[s] = [first]
            self._cur[s, 0] = first
            req = self.req[s]
            if req.eos_id is not None and first == req.eos_id:
                self._evict(s, "eos")
            elif req.max_new_tokens <= 1:
                self._evict(s, "length")

    # --------------------------------------------------------------- decode
    def _decode_tick(self):
        if not self.active.any():
            return
        toks = self._step(self._cur, self.active.astype(np.int32),
                          self.active)
        for slot in range(self.n_slots):
            if not self.active[slot]:
                continue
            req = self.req[slot]
            t = int(toks[slot])
            self.generated[slot].append(t)
            self._cur[slot, 0] = t
            if req.eos_id is not None and t == req.eos_id:
                self._evict(slot, "eos")
            elif len(self.generated[slot]) >= req.max_new_tokens:
                self._evict(slot, "length")

    def _evict(self, slot: int, reason: str):
        self._complete(slot, reason)
        self.pool.free(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self.table[slot, :] = -1
        self.active[slot] = False
        self.prefilling[slot] = False

    # ----------------------------------------------------------- tick loop
    def _has_work(self) -> bool:
        return bool(self.queue) or bool(self.active.any()) \
            or bool(self.prefilling.any())

    def tick(self):
        """Admit -> one prefill chunk per prefilling slot -> one decode
        step over the active slots."""
        self._admit()
        self._prefill_tick()
        self._decode_tick()
        self.ticks += 1

    # ----------------------------------------------------------- reporting
    @property
    def utilization(self) -> float:
        return float((self.active | self.prefilling).mean())

    def page_stats(self) -> dict:
        return self.pool.stats()

    def kv_bytes(self) -> dict:
        """Resident KV bytes at the CURRENT pool occupancy (see
        ``kv_pages.resident_kv_bytes`` for the equivalents), plus the
        attention-path *read* accounting: the bytes one decode step pulls
        from the KV store, which depends on the attention backend — the
        compressed backend reads codes + page scales only, while the
        QDQ-sim paths also materialize a dense round-trip copy."""
        c = self.model.cfg
        fp_bytes = torch.empty(
            (), dtype=getattr(torch, c.dtype)).element_size()
        out = resident_kv_bytes(
            self.pool.in_use, page_size=self.geometry.page_size,
            n_kv=c.n_kv, head_dim=c.head_dim_, n_layers=c.n_layers,
            kv=self.kv, fp_bytes=fp_bytes)
        out.update(attention_read_bytes(
            self.pool.in_use * self.geometry.page_size,
            n_kv=c.n_kv, head_dim=c.head_dim_, n_layers=c.n_layers,
            kv=self.kv, backend=self.attn_backend,
            fp_bytes=fp_bytes, page_size=self.geometry.page_size))
        return out
