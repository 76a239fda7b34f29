"""Serving-mode weight transforms: prequantized and compressed weights.

The paper's simulator QDQs weights *inside every forward pass* — right for
QAT/research, but at serving time weights are frozen, so
``compress_weights`` stores kernels as int CODES + per-group unit scales
(the paper's storage story made real), and ``prequantize_weights`` QDQs
them offline once (dense, exactly what the runtime QDQ would produce).
The ``compressed`` execution
backend (``core.simulate``) contracts the codes directly — integer group
sums, per-group rescale — so device memory never sees a dequantized
kernel.  INT4 codes pack two-per-byte, so resident weight bytes track the
policy's bit budget.

The transform is **PolicyMap-aware**: every ``kernel`` leaf is resolved
against its site address (the same contract ``qmatmul`` uses), so a mixed
map compresses each kernel against *its* rule:

  * int-format weight rules (``abfp`` or ``channel_max`` scalers) become
    ``CompressedKernel`` codes + scales;
  * float-format rules (e.g. FP8-E4M3 attention) are QDQ'd offline but
    stay dense — there is no integer code to store;
  * fp32 (disabled) rules leave the kernel untouched.

Site addresses are derived from the param-tree path: dict keys join with
``/`` and list entries under ``blocks`` become ``blocks.{i}`` (layers are
always a list of per-layer dicts in this package).  That is the
TransformerLM / ViT layout; the hybrid's tree (``mamba_groups``,
``shared``, ``lora``) is addressed at run time by family names
(``shared/q`` against the path ``shared/attn/q``), so it takes flat
policies only (a flat policy resolves the same at every site) and a
site-rule map raises there.

The tied embedding table is NOT touched: it feeds the input lookup too,
and pre-quantizing it would change input embeddings (the runtime path only
QDQs the readout matmul).

MoE expert banks (the ``wi``/``wg``/``wo`` stacks next to a ``router``)
are walked along their stacked expert axis: each expert resolves its OWN
rule at ``{site}/experts.{e}`` (first-match-wins over the block-level
pattern), so a mixed map can keep hot experts at INT8/FP8 while cold
experts compress to INT4.  Heterogeneous per-expert storage lives in an
``ExpertBank``.
"""

from __future__ import annotations

import torch

from repro_torch.core import abfp as abfp_mod
from repro_torch.core.formats import IntFormat
from repro_torch.core.policy import (
    Policy,
    PolicyMap,
    PolicyRule,
    QuantPolicy,
    TensorQuant,
    as_policy_map,
    resolve_policy,
)
from repro_torch.core.quantize import (pack_int4_codes, quantize,
                                       unpack_int4_codes)
from repro_torch.core.simulate import qdq_weight


class CompressedKernel:
    """int codes + per-group unit scales, with their storage metadata.

    codes: ``(N, G, n)`` int8 — contraction grouped last — or, when
    ``packed``, ``(N, G, n//2)`` uint8 nibble pairs (INT4 storage).
    scale: ``(N, G)`` f32 unit scales (alpha / qmax).  ``fmt_name`` records
    the stored integer format so reports/backends can reason about the bit
    budget without the policy in hand; ``dtype`` is the dense kernel's
    dtype name (e.g. ``"float32"``).
    """

    __slots__ = ("codes", "scale", "axis", "pad", "k", "dtype", "fmt_name",
                 "packed")

    def __init__(self, codes, scale, axis: int, pad: int, k: int,
                 dtype: str, fmt_name: str = "int8", packed: bool = False):
        self.codes = codes
        self.scale = scale
        self.axis = axis
        self.pad = pad
        self.k = k
        self.dtype = dtype
        self.fmt_name = fmt_name
        self.packed = packed

    def tree_children(self) -> tuple:
        """(codes, scale): the leaves a logical-axes / layout tree holds
        here (``dist.sharding.map_axes``); the rest is metadata."""
        return (self.codes, self.scale)

    def tree_rebuild(self, children) -> "CompressedKernel":
        return CompressedKernel(children[0], children[1], self.axis,
                                self.pad, self.k, self.dtype, self.fmt_name,
                                self.packed)

    @property
    def group(self) -> int:
        """Stored group length n (in codes, not bytes — packing-aware)."""
        n = self.codes.shape[-1]
        return n * 2 if self.packed else n

    def __repr__(self):
        return (f"CompressedKernel(codes={tuple(self.codes.shape)},"
                f" scale={tuple(self.scale.shape)},"
                f" fmt={self.fmt_name}, packed={self.packed})")


class ExpertBank:
    """Per-expert entries for one stacked MoE expert kernel.

    Replaces a dense ``(E, K, N)`` expert stack with a tuple of per-expert
    entries — each a dense ``(K, N)`` slice or a ``CompressedKernel`` — so
    experts can carry *different* storage formats (hot INT8 / cold INT4).
    The expert axis is END-RELATIVE at -3, as in the reference.
    """

    __slots__ = ("entries",)

    def __init__(self, entries):
        self.entries = tuple(entries)

    def tree_children(self) -> tuple:
        return self.entries

    def tree_rebuild(self, children) -> "ExpertBank":
        return ExpertBank(children)

    @property
    def n_experts(self) -> int:
        return len(self.entries)

    def dense(self, dtype=None) -> torch.Tensor:
        """Stacked dense view ``(E, K, N)``: every compressed entry
        decompressed (each call, as the reference's forward does)."""
        mats = [decompress_kernel(e, dtype)
                if isinstance(e, CompressedKernel)
                else (e if dtype is None else e.to(dtype))
                for e in self.entries]
        return torch.stack(mats, dim=mats[0].ndim - 2)

    def replace_entry(self, e: int, value) -> "ExpertBank":
        """A bank with expert ``e``'s entry swapped for ``value`` (the
        expert store swaps a dense copy in, or the backing entry back)."""
        entries = list(self.entries)
        entries[e] = value
        return ExpertBank(entries)

    def __repr__(self):
        n_c = sum(isinstance(e, CompressedKernel) for e in self.entries)
        return (f"ExpertBank(n_experts={self.n_experts}, "
                f"compressed={n_c}, dense={self.n_experts - n_c})")


def entry_bytes(entry) -> int:
    """Resident bytes of one weight entry (dense tensor or codes+scales)."""
    if isinstance(entry, CompressedKernel):
        return _leaf_bytes(entry.codes) + _leaf_bytes(entry.scale)
    return _leaf_bytes(entry)


# MoE param sub-dicts are recognised structurally: the expert stacks sit
# next to their router.  Keys here are the ONLY non-'kernel' leaves the
# walks transform.
_EXPERT_KEYS = ("wi", "wg", "wo")


def _is_moe_bank(node) -> bool:
    return (isinstance(node, dict) and "router" in node
            and "wi" in node and "wo" in node)


def _walk_kernels(params, fn, expert_fn=None):
    """Apply ``fn(site, kernel_leaf)`` to every 'kernel' entry; keep
    structure.  ``site`` follows the runtime site-address contract (see
    module docstring).  When ``expert_fn`` is given, MoE expert stacks are
    visited too as ``expert_fn(site, kind, stack)`` with ``kind`` one of
    ``wi``/``wg``/``wo`` and ``site`` the block-level address (e.g.
    ``blocks.0/ffn``); otherwise they pass through untouched."""

    def rec(node, path):
        if isinstance(node, dict):
            out = {}
            bank = _is_moe_bank(node)
            for k, v in node.items():
                if bank and k in _EXPERT_KEYS:
                    out[k] = (expert_fn("/".join(path), k, v)
                              if expert_fn is not None else v)
                elif k == "kernel" and isinstance(
                        v, (torch.Tensor, CompressedKernel)):
                    out[k] = fn("/".join(path), v)
                elif k == "blocks" and isinstance(v, (list, tuple)):
                    out[k] = type(v)(rec(b, path + [f"blocks.{i}"])
                                     for i, b in enumerate(v))
                else:
                    out[k] = rec(v, path + [k])
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v, path + [str(i)])
                              for i, v in enumerate(node))
        return node

    return rec(params, [])


def _check_site_rules_supported(params, policy: Policy, what: str) -> None:
    """Reject a site-rule map on a tree whose paths are not its sites
    (thin shim over the static analyzer, QL008: same message, one
    source)."""
    if not isinstance(params, dict):
        return
    from repro_torch.analysis.policy_lint import (
        non_contract_layout_diagnostic)

    d = non_contract_layout_diagnostic(policy, list(params), what)
    if d is not None:
        raise NotImplementedError(d.message)


def _site_weight(policy: Policy, site: str) -> TensorQuant | None:
    p = resolve_policy(policy, site)
    return p.weight if p.enabled else None


def expert_site(site: str, e: int) -> str:
    """Site address of expert ``e`` inside the MoE block at ``site``
    (``blocks.0/ffn/experts.3``), the runtime contract of ``nn.moe``."""
    return f"{site}/experts.{e}"


def _expert_weights(policy: Policy, site: str, n_experts: int):
    return [_site_weight(policy, expert_site(site, e))
            for e in range(n_experts)]


def serving_policy(policy: Policy) -> Policy:
    """The runtime policy to pair with compressed weights.

    Weight quantizers drop rule-wise — EXCEPT at the tied-readout site
    ``embed/attend``: the embedding table is never transformed offline (it
    feeds the input lookup too), so that one matmul keeps its runtime
    weight QDQ or compressed serving would silently diverge from the QDQ
    simulation on tied-embedding models.  The result is therefore always a
    PolicyMap carrying the keep-rule (inert on untied models, whose
    ``lm_head`` kernel IS transformed offline).
    """
    def drop_weight(p: QuantPolicy) -> QuantPolicy:
        if p.weight is None:
            return p
        return p.replace(name=p.name + "_served", weight=None)

    pm = as_policy_map(policy)
    if all(p.weight is None for p in pm.policies):
        return policy
    keep = pm.resolve("embed/attend")
    rules = tuple(PolicyRule(r.pattern, drop_weight(r.policy))
                  for r in pm.rules)
    if keep.weight is not None:
        rules = (PolicyRule("embed/attend", keep),) + rules
    return PolicyMap(name=pm.name + "_served", rules=rules,
                     default=drop_weight(pm.default))


def prequantize_weights(params, policy: Policy):
    """QDQ every kernel offline per its site's resolved weight rule.

    fp32-rule sites are left untouched; all scalers ``qdq_weight`` supports
    (abfp / channel_max / dynamic_max) round-trip exactly at serving time.
    Layers are always a list of per-layer dicts here, so every kernel
    resolves at its own site (the reference's stacked-layout check has
    nothing to reject).  MoE expert stacks QDQ per-expert against their
    ``experts.{e}`` rules and stay stacked-dense.
    """
    _check_site_rules_supported(params, policy, "prequantize_weights")

    def one(site, w):
        tq = _site_weight(policy, site)
        if tq is None or isinstance(w, CompressedKernel):
            return w
        return qdq_weight(w, tq, contract_axis=w.ndim - 2).to(w.dtype)

    def one_bank(site, kind, w):
        if isinstance(w, ExpertBank):
            return w
        e_axis = w.ndim - 3
        tqs = _expert_weights(policy, site, w.shape[e_axis])
        if all(tq is None for tq in tqs):
            return w
        cols = []
        for e, tq in enumerate(tqs):
            we = w.select(e_axis, e)
            if tq is not None:
                we = qdq_weight(we, tq, contract_axis=we.ndim - 2)
            cols.append(we.to(w.dtype))
        return torch.stack(cols, dim=e_axis)

    return _walk_kernels(params, one, expert_fn=one_bank)


# ---------------------------------------------------------------------------
# Real compressed storage: int codes + scales
# ---------------------------------------------------------------------------
def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def compress_kernel(w: torch.Tensor, tq: TensorQuant) -> CompressedKernel:
    """One dense kernel -> CompressedKernel per an int-format weight rule.

    The contraction sits at rank-2 (K, N) and is stored END-RELATIVE.
    ``abfp`` rules group K by ``tq.group``; ``channel_max`` rules store one
    group spanning all of K with the per-output-channel alpha (bit-exact
    with the runtime channel-max QDQ).  INT4 codes pack two-per-byte.
    """
    if not isinstance(tq.fmt, IntFormat):
        raise ValueError(
            f"compress_kernel stores integer codes; got format "
            f"{tq.fmt_name!r} (float-format rules stay dense — see "
            "compress_weights)"
        )
    axis = w.ndim - 2
    if tq.scaler == "abfp":
        codes, scales, (pad, k) = abfp_mod.abfp_quantize(
            w, tq.fmt, axis=axis, n=tq.group, dtype=torch.int8,
            scale_dtype=getattr(torch, tq.scale_dtype),
        )
    elif tq.scaler == "channel_max":
        # one group spanning K, alpha = per-output-channel max (matches
        # core.simulate.qdq_weight's channel_max path bit-for-bit)
        wm = torch.movedim(w, axis, -1)[..., None, :]  # (..., N, 1, K)
        alpha = torch.clamp_min(wm.abs().amax(dim=-1, keepdim=True), 1e-8)
        codes, scale = quantize(wm, alpha, tq.fmt, dtype=torch.int8)
        scales = scale[..., 0]
        pad, k = 0, w.shape[axis]
    else:
        raise ValueError(
            f"compress_kernel supports 'abfp'/'channel_max' weight "
            f"scalers, got {tq.scaler!r}"
        )
    packed = tq.fmt.bits <= 4 and codes.shape[-1] % 2 == 0
    if packed:
        codes = pack_int4_codes(codes)
    # `scales` are already UNIT scales (alpha/qmax); keep f32 — they are
    # 1/group of the codes count, and f32 keeps serving numerics exact.
    return CompressedKernel(codes.contiguous(),
                            scales.to(torch.float32).contiguous(),
                            -2, pad, k, _dtype_name(w.dtype),
                            fmt_name=tq.fmt.name, packed=packed)


def compress_weights(params, policy: Policy):
    """kernel -> CompressedKernel per the kernel's resolved site rule.

      * int-format rule (abfp / channel_max) — stored as codes + scales,
        consumed directly by the ``compressed`` execution backend;
      * float-format rule (e.g. FP8-E4M3) — QDQ'd offline, stays dense;
      * fp32 (disabled) rule — untouched.
    MoE expert stacks become ``ExpertBank``s of per-expert entries, each
    resolved at ``{site}/experts.{e}`` — a fully fp32 bank stays a plain
    dense stack.  Pair with ``serving_policy(policy)`` at runtime.
    """
    _check_site_rules_supported(params, policy, "compress_weights")

    def _one_entry(w, tq):
        if tq is None:
            return w
        if isinstance(tq.fmt, IntFormat) and tq.scaler in ("abfp",
                                                           "channel_max"):
            return compress_kernel(w, tq)
        # float formats / exotic scalers: no integer codes to store —
        # prequantize offline so serving still matches the QDQ simulation
        return qdq_weight(w, tq, contract_axis=w.ndim - 2).to(w.dtype)

    def one(site, w):
        if isinstance(w, CompressedKernel):
            return w
        return _one_entry(w, _site_weight(policy, site))

    def one_bank(site, kind, w):
        if isinstance(w, ExpertBank):
            return w
        e_axis = w.ndim - 3
        tqs = _expert_weights(policy, site, w.shape[e_axis])
        if all(tq is None for tq in tqs):
            return w  # fully fp32 bank: stays a plain dense stack
        return ExpertBank([_one_entry(w.select(e_axis, e), tq)
                           for e, tq in enumerate(tqs)])

    return _walk_kernels(params, one, expert_fn=one_bank)


def compress_axes(axes_tree, compressed_tree):
    """Mirror ``compress_weights`` on the logical-axes tree.

    For a kernel with axes (a_contract, a_out) the codes are laid out
    (a_out, G, n) and scales (a_out, G) — sharding follows the surviving
    output axis; group dims replicate.  The metadata is copied from the
    compressed tree (meta tensors will do), so the structures match leaf
    for leaf.  Dense (uncompressed / fp32-rule) kernels keep their axes;
    an ``ExpertBank``'s entries drop the expert axis.
    """
    from repro_torch.dist.sharding import is_axes_leaf

    def rec(ax_node, node):
        if isinstance(node, CompressedKernel):
            axes = ax_node  # original kernel axes tuple
            lead = tuple(axes[:-2]) if len(axes) > 2 else ()
            a_out = axes[-1]
            return node.tree_rebuild((lead + (a_out, None, None),
                                      lead + (a_out, None)))
        if isinstance(node, ExpertBank):
            # the expert axis is consumed by the bank; each entry keeps the
            # per-expert kernel axes (contract, out)
            sub = tuple(ax_node[:-3]) + tuple(ax_node[-2:])
            return ExpertBank([rec(sub, e) for e in node.entries])
        if isinstance(ax_node, dict):
            return {k: rec(ax_node[k], node[k]) for k in ax_node}
        if isinstance(ax_node, (list, tuple)) and not is_axes_leaf(ax_node):
            vals = [rec(a, n) for a, n in zip(ax_node, node)]
            if hasattr(ax_node, "_fields"):
                return type(ax_node)(*vals)
            return type(ax_node)(vals)
        return ax_node

    return rec(axes_tree, compressed_tree)


def decompress_kernel(entry: CompressedKernel, dtype=None) -> torch.Tensor:
    """codes+scales -> dense kernel."""
    dt = dtype or getattr(torch, entry.dtype)
    codes = entry.codes
    if entry.packed:
        codes = unpack_int4_codes(codes)
    w = codes.to(dt) * entry.scale.to(dt)[..., None]
    # (…, N, G, n) -> flatten -> unpad -> contraction back to rank-2
    w = w.reshape(*w.shape[:-2], w.shape[-2] * w.shape[-1])
    if entry.pad:
        w = w[..., :entry.k]
    return torch.movedim(w, -1, entry.axis)  # axis == -2 (end-relative)


# ---------------------------------------------------------------------------
# Resident-weight-byte accounting (serve / benchmark reports)
# ---------------------------------------------------------------------------
def _leaf_bytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def weight_bytes_report(dense_params, served_params) -> dict:
    """Per-site resident weight bytes: dense tree vs its served transform.

    Walks the ``kernel`` leaves of both trees in lockstep and reports the
    bytes each representation keeps resident in device memory, scale
    overhead included.  MoE expert stacks report one row per expert site
    (``{site}/experts.{e}``, the wi/wg/wo kernels of one expert summed),
    so per-expert precision shows up per expert.
    """
    sites = []
    dense_by_site = {}

    def record(site, w):
        dense_by_site[site] = _leaf_bytes(w)
        return w

    def record_bank(site, kind, w):
        dense_by_site[(site, kind)] = _leaf_bytes(w)
        return w

    _walk_kernels(dense_params, record, expert_fn=record_bank)

    def one(site, w):
        if isinstance(w, CompressedKernel):
            resident = _leaf_bytes(w.codes) + _leaf_bytes(w.scale)
            kind = "compressed"
            fmt = w.fmt_name + ("_packed" if w.packed else "")
        else:
            resident = _leaf_bytes(w)
            kind = "dense"
            fmt = _dtype_name(w.dtype)
        sites.append({
            "site": site, "kind": kind, "fmt": fmt,
            "dense_bytes": dense_by_site[site],
            "resident_bytes": resident,
        })
        return w

    expert_rows = {}  # expert site -> row (wi/wg/wo summed)

    def one_bank(site, kind, w):
        entries = (list(w.entries) if isinstance(w, ExpertBank)
                   else [w.select(w.ndim - 3, e)
                         for e in range(w.shape[w.ndim - 3])])
        per_dense = dense_by_site[(site, kind)] // len(entries)
        for e, entry in enumerate(entries):
            if isinstance(entry, CompressedKernel):
                k_, fmt = "compressed", entry.fmt_name + (
                    "_packed" if entry.packed else "")
            else:
                k_, fmt = "dense", _dtype_name(entry.dtype)
            row = expert_rows.setdefault(expert_site(site, e), {
                "site": expert_site(site, e), "kind": k_, "fmt": fmt,
                "dense_bytes": 0, "resident_bytes": 0,
            })
            row["dense_bytes"] += per_dense
            row["resident_bytes"] += entry_bytes(entry)
        return w

    _walk_kernels(served_params, one, expert_fn=one_bank)
    sites.extend(expert_rows.values())
    dense_total = sum(s["dense_bytes"] for s in sites)
    resident_total = sum(s["resident_bytes"] for s in sites)
    return {
        "sites": sites,
        "dense_kernel_bytes": dense_total,
        "resident_kernel_bytes": resident_total,
        "compressed_sites": sum(s["kind"] == "compressed" for s in sites),
        "dense_sites": sum(s["kind"] == "dense" for s in sites),
        "ratio": resident_total / max(dense_total, 1),
    }


def weight_bytes_summary(report: dict) -> dict:
    """Flat JSON-row form of a ``weight_bytes_report`` (the shape the
    launcher emits)."""
    return {
        "compressed_sites": report["compressed_sites"],
        "dense_sites": report["dense_sites"],
        "dense_weight_mb": round(report["dense_kernel_bytes"] / 1e6, 3),
        "resident_weight_mb": round(
            report["resident_kernel_bytes"] / 1e6, 3),
        "weight_bytes_ratio": round(report["ratio"], 4),
    }
