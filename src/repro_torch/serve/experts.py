"""Expert-resident MoE serving: compressed store, LRU cache, precision.

Dense MoE serving keeps every ``(E, D, F)`` expert stack fully resident
even though each token touches only ``top_k`` experts — for phi35-moe
class models that is >90% of the parameters.  This module is the software
analogue of an off-chip expert store (DynaNDE-style):

  * ``ExpertStore`` — the backing store.  Experts live as the per-expert
    entries ``compress_weights`` produced (``ExpertBank``: each expert a
    ``CompressedKernel`` or a dense slice, per its ``experts.{e}`` site
    rule), so cold experts can sit at INT4 while hot experts carry
    INT8/FP8.

  * ``ExpertCache`` — an LRU of configurable capacity holding
    decompressed-dense copies of recently-routed experts.  Cache state is
    pure *representation*: a cached expert's dense copy equals its
    dequantized backing entry bit-for-bit, so hits/misses can never change
    tokens — only resident bytes and counters.  ``ExpertStore.materialize``
    swaps the cached copies into the serving params (the swapped-in
    experts then skip dequant inside the step).

  * Routing-frequency counters — fed by the model's ``expert_loads``
    probe at admission time — drive both LRU admission and the offline
    per-expert precision assignment (``assign_expert_precision``): hot
    experts are assigned a higher-precision format (INT8/FP8), cold ones
    INT4, emitted as a fully serializable ``PolicyMap`` preset.

The engines (``serve.engine``) build a store automatically when
``compress=True`` meets an MoE model; ``launch/serve.py`` exposes
``--expert-cache`` / ``--expert-precision`` and reports per-expert
hit/miss + residency stats.  Counters and traces are numpy on the host;
the banks, dense copies and probes are tensors on the model's device.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from repro_torch.analysis.messages import expert_non_moe_message
from repro_torch.core.policy import (
    Policy,
    PolicyMap,
    PolicyRule,
    QuantPolicy,
    as_policy_map,
)
from repro_torch.models import serving_transforms as st


class ExpertCache:
    """LRU cache of per-expert dense copies with hit/miss accounting.

    Keys are expert indices; values are whatever the owner stores (the
    ``ExpertStore`` keeps ``{kind: dense array}`` dicts).  ``access``
    records a hit/miss and refreshes recency; ``admit`` inserts and
    returns the evicted key (if any).  ``capacity == 0`` disables caching
    (every access is a miss, nothing is ever admitted).
    """

    def __init__(self, capacity: int):
        if capacity < 0:
            raise ValueError(f"expert cache capacity must be >= 0, "
                             f"got {capacity}")
        self.capacity = capacity
        self._od: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def access(self, key) -> bool:
        if key in self._od:
            self._od.move_to_end(key)
            self.hits += 1
            return True
        self.misses += 1
        return False

    def admit(self, key, value=None):
        """Insert (or refresh) ``key``; returns the evicted key or None."""
        if self.capacity == 0:
            return None
        if key in self._od:
            self._od[key] = value
            self._od.move_to_end(key)
            return None
        self._od[key] = value
        if len(self._od) > self.capacity:
            old, _ = self._od.popitem(last=False)
            self.evictions += 1
            return old
        return None

    def get(self, key):
        return self._od[key]

    def keys(self) -> list:
        """Cached keys, least- to most-recently used."""
        return list(self._od)

    def __contains__(self, key) -> bool:
        return key in self._od

    def __len__(self) -> int:
        return len(self._od)

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


def _dense_entry_bytes(entry) -> int:
    """f32-equivalent dense bytes of one expert entry."""
    if isinstance(entry, st.CompressedKernel):
        lead_n = 1
        for d in entry.codes.shape[:-2]:
            lead_n *= int(d)
        return lead_n * entry.k * _itemsize(getattr(torch, entry.dtype))
    return st.entry_bytes(entry)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


class ExpertStore:
    """Backing store + per-site LRU caches over a served MoE param tree.

    Built from the output of ``compress_weights``: collects every expert
    bank (``wi``/``wg``/``wo`` stacks next to a router) keyed by its MoE
    block site (``blocks.{i}/ffn`` unrolled, ``block/ffn`` under scan —
    scan-stacked banks hold all layers in one site, so experts cache
    whole-column; the port's layers are always unrolled).  One ``ExpertCache`` of ``capacity`` experts per site;
    routing loads arrive via ``observe`` and drive hit/miss accounting,
    LRU admission (misses decompress the backing entry into the cache)
    and the frequency counters ``assign_expert_precision`` consumes.
    """

    def __init__(self, served_params, *, capacity: int = 0,
                 model_name: str = ""):
        banks: dict = {}
        order: list[str] = []

        def collect(site, kind, w):
            if site not in banks:
                order.append(site)
                banks[site] = {}
            banks[site][kind] = w
            return w

        st._walk_kernels(served_params, lambda s, w: w, expert_fn=collect)
        if not banks:
            raise ValueError(
                expert_non_moe_message("an expert store",
                                       model_name or "this model"))
        self.sites = order
        self.banks = banks
        first = next(iter(banks[order[0]].values()))
        self.n_experts = (first.n_experts if isinstance(first, st.ExpertBank)
                          else int(first.shape[first.ndim - 3]))
        self.capacity = int(capacity)
        self.caches = {s: ExpertCache(self.capacity) for s in order}
        self.counts = {s: np.zeros(self.n_experts, np.float64)
                       for s in order}

    # ------------------------------------------------------------- entries
    def _entry(self, site: str, kind: str, e: int):
        b = self.banks[site][kind]
        if isinstance(b, st.ExpertBank):
            return b.entries[e]
        return b.select(b.ndim - 3, e)

    def _dense_copy(self, site: str, kind: str, e: int):
        entry = self._entry(site, kind, e)
        if isinstance(entry, st.CompressedKernel):
            return st.decompress_kernel(entry)
        return entry

    # ------------------------------------------------------------- routing
    def observe(self, loads) -> None:
        """Feed per-layer routed-token counts (``(L, E)`` or ``(E,)``).

        Rows map to sites in layer order; a single scan-shared site
        aggregates all layers.  Touched experts (load > 0) update the
        frequency counters and run through the LRU: hits refresh recency,
        misses decompress the backing entry into the cache (heaviest
        load ends most-recent).
        """
        loads = np.atleast_2d(np.asarray(loads, np.float64))
        if loads.shape[1] != self.n_experts:
            raise ValueError(
                f"observe: got loads for {loads.shape[1]} experts, store "
                f"holds {self.n_experts}")
        if len(self.sites) == 1:
            rows = [(self.sites[0], loads.sum(axis=0))]
        elif loads.shape[0] == len(self.sites):
            rows = list(zip(self.sites, loads))
        else:
            raise ValueError(
                f"observe: {loads.shape[0]} load rows vs "
                f"{len(self.sites)} MoE sites")
        for site, row in rows:
            self.counts[site] += row
            cache = self.caches[site]
            touched = np.nonzero(row > 0)[0]
            # ascending load (ties: descending index) => the heaviest
            # expert is accessed last and ends most-recently-used
            for e in sorted(touched, key=lambda i: (row[i], -i)):
                if not cache.access(int(e)) and cache.capacity > 0:
                    value = {kind: self._dense_copy(site, kind, int(e))
                             for kind in self.banks[site]}
                    cache.admit(int(e), value)

    def warm(self, experts) -> None:
        """Pre-admit ``experts`` (iterable of indices) at every site
        without touching hit/miss counters (admission order = iteration
        order, so the last listed expert is most-recent)."""
        for site in self.sites:
            cache = self.caches[site]
            for e in experts:
                value = {kind: self._dense_copy(site, kind, int(e))
                         for kind in self.banks[site]}
                cache.admit(int(e), value)

    # --------------------------------------------------------- realization
    def materialize(self, params):
        """Serving params with cache-resident experts swapped for their
        decompressed-dense copies (those experts then skip dequant inside
        the step).  Values are identical by construction — only
        the storage representation changes, so tokens cannot.  Rebuilt
        from the pristine backing banks each call, so experts evicted
        since the last refresh drop back to their compressed entries
        (idempotent; safe to call on already-materialized params)."""

        def swap(site, kind, w):
            bank = self.banks.get(site, {}).get(kind)
            if not isinstance(bank, st.ExpertBank):
                return w
            cache = self.caches[site]
            for e in cache.keys():
                bank = bank.replace_entry(e, cache.get(e)[kind])
            return bank

        return st._walk_kernels(params, lambda s, w: w, expert_fn=swap)

    # --------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Residency + traffic report: store/cache bytes (hot/cold split),
        hit/miss/eviction counters and per-site routing frequencies."""
        E = self.n_experts
        hits = sum(c.hits for c in self.caches.values())
        misses = sum(c.misses for c in self.caches.values())
        evictions = sum(c.evictions for c in self.caches.values())
        store_bytes = cache_bytes = dense_bytes = 0
        hot_bytes = cold_bytes = 0
        cached_total = 0
        per_site = {}
        for site in self.sites:
            cache = self.caches[site]
            cached = set(cache.keys())
            cached_total += len(cached)
            for e in range(E):
                res = sum(st.entry_bytes(self._entry(site, k, e))
                          for k in self.banks[site])
                den = sum(_dense_entry_bytes(self._entry(site, k, e))
                          for k in self.banks[site])
                store_bytes += res
                dense_bytes += den
                if e in cached:
                    copy = sum(v.numel() * v.element_size()
                               for v in cache.get(e).values())
                    cache_bytes += copy
                    hot_bytes += res + copy
                else:
                    cold_bytes += res
            per_site[site] = {
                "cached": cache.keys(),
                "hits": cache.hits, "misses": cache.misses,
                "evictions": cache.evictions,
                "counts": [float(c) for c in self.counts[site]],
            }
        resident = store_bytes + cache_bytes
        n = hits + misses
        return {
            "n_experts": E,
            "capacity": self.capacity,
            "n_sites": len(self.sites),
            "cached_experts": cached_total,
            "hits": hits, "misses": misses, "evictions": evictions,
            "hit_rate": hits / n if n else 0.0,
            "store_bytes": store_bytes,
            "cache_bytes": cache_bytes,
            "resident_bytes": resident,
            "hot_bytes": hot_bytes,
            "cold_bytes": cold_bytes,
            "dense_bytes": dense_bytes,
            "ratio": resident / max(dense_bytes, 1),
            "sites": per_site,
        }


# ---------------------------------------------------------------------------
# Routing-frequency probe + offline per-expert precision assignment
# ---------------------------------------------------------------------------
def route_frequencies(model, params, token_batches, *,
                      policy: Policy = QuantPolicy()) -> np.ndarray:
    """Aggregate ``model.expert_loads`` over token batches -> (L, E)."""
    total = None
    for tokens in token_batches:
        loads = model.expert_loads(params, np.asarray(tokens),
                                   policy=policy).cpu().numpy()
        total = loads if total is None else total + loads
    if total is None:
        raise ValueError("route_frequencies: no token batches given")
    return total


def hot_experts(loads, n_hot: int) -> list[int]:
    """The ``n_hot`` most-routed experts (loads summed over layers),
    ordered hottest-first; ties break toward the lower index."""
    loads = np.asarray(loads, np.float64)
    agg = loads.sum(axis=0) if loads.ndim == 2 else loads
    n_hot = max(0, min(int(n_hot), len(agg)))
    order = sorted(range(len(agg)), key=lambda e: (-agg[e], e))
    return order[:n_hot]


def expert_precision_map(base_policy: Policy, hot: list[int], *,
                         hot_fmt: str = "int8", cold_fmt: str = "int4",
                         name: str | None = None) -> PolicyMap:
    """Per-expert precision preset: hot experts at ``hot_fmt``, every
    other expert at ``cold_fmt``, all non-expert sites untouched.

    Expert rules use ``*/experts.{e}`` patterns — no ``blocks`` mention,
    so the map stays scan-compatible — prepended to the base rules
    (first-match-wins).  The result round-trips through
    ``policy_to_dict``/``policy_from_dict`` like any other PolicyMap.
    """
    pm = as_policy_map(base_policy)
    base = pm.resolve("block/ffn")
    if base.weight is None:
        raise ValueError(
            "expert_precision_map needs a base policy with an enabled "
            f"weight rule at the MoE site (got {pm.name!r}); per-expert "
            "formats replace the weight format, they cannot invent one")
    hot_p = base.replace(name=f"{base.name}_hot",
                         weight=base.weight.replace(fmt_name=hot_fmt))
    cold_p = base.replace(name=f"{base.name}_cold",
                          weight=base.weight.replace(fmt_name=cold_fmt))
    rules = tuple(PolicyRule(f"*/experts.{e}", hot_p) for e in sorted(hot))
    rules += (PolicyRule("*/experts.*", cold_p),)
    return PolicyMap(name=name or f"{pm.name}+experts_{hot_fmt}_{cold_fmt}",
                     rules=rules + pm.rules, default=pm.default)


def assign_expert_precision(loads, base_policy: Policy, *,
                            hot_frac: float = 0.25, n_hot: int | None = None,
                            hot_fmt: str = "int8", cold_fmt: str = "int4",
                            name: str | None = None) -> PolicyMap:
    """Offline assignment pass: routing loads -> per-expert PolicyMap.

    ``loads`` is the ``(L, E)`` (or ``(E,)``) output of
    ``route_frequencies``/``ExpertStore`` counters; the top ``n_hot``
    (default ``ceil(E * hot_frac)``) experts get ``hot_fmt``, the rest
    ``cold_fmt``.
    """
    loads = np.asarray(loads, np.float64)
    E = loads.shape[-1]
    if n_hot is None:
        n_hot = max(1, int(np.ceil(E * hot_frac)))
    return expert_precision_map(base_policy, hot_experts(loads, n_hot),
                                hot_fmt=hot_fmt, cold_fmt=cold_fmt,
                                name=name)


def zipf_trace(n_experts: int, length: int, *, alpha: float = 0.0,
               top_k: int = 2, seed: int = 0) -> np.ndarray:
    """Synthetic routing trace ``(length, n_experts)``: each step routes
    ``top_k`` distinct experts drawn from a Zipf(``alpha``) popularity
    (``alpha=0`` is uniform; larger alpha = heavier skew)."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, n_experts + 1, dtype=np.float64) ** alpha
    p /= p.sum()
    rows = np.zeros((length, n_experts), np.float64)
    k = min(top_k, n_experts)
    for t in range(length):
        sel = rng.choice(n_experts, size=k, replace=False, p=p)
        rows[t, sel] = 1.0
    return rows
