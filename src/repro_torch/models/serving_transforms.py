"""Serving-mode weight transforms: compressed weight storage.

The paper's simulator QDQs weights *inside every forward pass* — right for
QAT/research, but at serving time weights are frozen, so
``compress_weights`` stores kernels as int CODES + per-group unit scales
(the paper's storage story made real).  The ``compressed`` execution
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
always a list of per-layer dicts in this package).

The tied embedding table is NOT touched: it feeds the input lookup too,
and pre-quantizing it would change input embeddings (the runtime path only
QDQs the readout matmul).

MoE expert banks are not ported yet (no ``ExpertBank``).
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

    @property
    def group(self) -> int:
        """Stored group length n (in codes, not bytes — packing-aware)."""
        n = self.codes.shape[-1]
        return n * 2 if self.packed else n

    def __repr__(self):
        return (f"CompressedKernel(codes={tuple(self.codes.shape)},"
                f" scale={tuple(self.scale.shape)},"
                f" fmt={self.fmt_name}, packed={self.packed})")


def _walk_kernels(params, fn):
    """Apply ``fn(site, kernel_leaf)`` to every 'kernel' entry; keep
    structure.  ``site`` follows the runtime site-address contract (see
    module docstring)."""

    def rec(node, path):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k == "kernel" and isinstance(
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


def _site_weight(policy: Policy, site: str) -> TensorQuant | None:
    p = resolve_policy(policy, site)
    return p.weight if p.enabled else None


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
    Pair with ``serving_policy(policy)`` at runtime.
    """
    def one(site, w):
        if isinstance(w, CompressedKernel):
            return w
        tq = _site_weight(policy, site)
        if tq is None:
            return w
        if isinstance(tq.fmt, IntFormat) and tq.scaler in ("abfp",
                                                           "channel_max"):
            return compress_kernel(w, tq)
        # float formats / exotic scalers: no integer codes to store —
        # prequantize offline so serving still matches the QDQ simulation
        return qdq_weight(w, tq, contract_axis=w.ndim - 2).to(w.dtype)

    return _walk_kernels(params, one)


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
    overhead included.
    """
    sites = []
    dense_by_site = {}

    def record(site, w):
        dense_by_site[site] = _leaf_bytes(w)
        return w

    _walk_kernels(dense_params, record)

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

    _walk_kernels(served_params, one)
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
