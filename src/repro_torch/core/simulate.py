"""The simulator chokepoint: quantized matmul (paper eqns (6)-(9), Fig 2).

Every matmul-bearing layer in ``repro_torch.nn`` routes through ``qmatmul``
(linear layers) or ``qdq_activation`` (attention BMM operands): the policy
flows down the call tree and this module applies the quantizer functions
f_q^w, f_q^x, f_q^y around the contraction.

Execution backends — ``qmatmul`` dispatches to a registered backend, each
declaring the weight representation it consumes:

  ========== =========== =====================================================
  backend    consumes    semantics
  ========== =========== =====================================================
  ref        dense       QDQ both operands, contract in high precision
                         (paper-faithful)
  int8       dense       quantize on the fly, contract int8 codes with exact
                         integer group sums and per-group rescale
  fused      dense       fused QDQ+matmul CUDA kernels: ``abfp_matmul``, or
                         ``abfp_matmul_int8`` when ``compute == 'int8'``
  compressed codes       contract PRE-QUANTIZED weight codes + per-group unit
                         scales directly (integer group sums, per-group
                         rescale) — device memory never sees a dequantized
                         kernel; with ``policy.fused`` and an int-ABFP input
                         of the stored group this is the CUDA kernel
                         ``kernels.quant_matmul``
  ========== =========== =====================================================

Selection (``execution_backend``): a ``CompressedKernel`` weight always
takes the ``compressed`` backend (the representation decides); otherwise
``policy.fused`` -> fused, ``policy.compute == 'int8'`` with an eligible
int-ABFP policy -> int8, everything else -> ref.

Calibration taps in at ``qdq_activation``: while a ``Calibrator`` is
active (``Calibrator.observing()``) every activation quantizer hands its
input to the observer under its site name before QDQ.  The ``fused``
backend QDQs inside its kernels and never reaches ``qdq_activation``, so it
observes nothing — as in the reference.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import abfp as abfp_mod
from repro_torch.core.calibration import Calibrator
from repro_torch.core.formats import IntFormat
from repro_torch.core.policy import (Policy, QuantPolicy, TensorQuant,
                                     resolve_policy)
from repro_torch.core.quantize import maybe_ste, unpack_int4_codes
from repro_torch.kernels.quant_matmul import group_contract


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _dynamic_max_alpha(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x.abs().amax(), 1e-8)


def qdq_activation(
    x: torch.Tensor,
    tq: TensorQuant | None,
    *,
    axis: int = -1,
    site: str = "",
    alpha=None,
) -> torch.Tensor:
    """Apply an activation quantizer along the contraction ``axis``.

    ``alpha`` supplies the calibrated scale when ``tq.scaler == 'static'``
    (threaded from the q tree by the owning layer: a tensor on ``x``'s
    device, so the static branch uploads nothing per call).
    """
    if tq is None:
        return x
    calib = Calibrator.active()
    if calib is not None and site:
        calib.observe(site, x)
    if tq.scaler == "abfp":
        return abfp_mod.abfp_qdq(
            x, tq.fmt, axis=axis, n=tq.group, ste=tq.ste,
            scale_dtype=_dtype(tq.scale_dtype),
        )
    if tq.scaler == "dynamic_max":
        return maybe_ste(x, _dynamic_max_alpha(x), tq.fmt, tq.ste)
    if tq.scaler == "static":
        if alpha is None:
            # Uncalibrated: fall back to dynamic max (calibration pass mode).
            alpha = _dynamic_max_alpha(x)
        alpha = torch.as_tensor(alpha, dtype=torch.float32, device=x.device)
        return maybe_ste(x, alpha, tq.fmt, tq.ste)
    raise ValueError(f"bad activation scaler {tq.scaler!r}")


def qdq_weight(
    w: torch.Tensor, tq: TensorQuant | None, *, contract_axis: int = 0
) -> torch.Tensor:
    """Apply the weight quantizer. ``w`` is (K, N); groups run along K."""
    if tq is None:
        return w
    if tq.scaler == "abfp":
        return abfp_mod.abfp_qdq(
            w, tq.fmt, axis=contract_axis, n=tq.group, ste=tq.ste,
            scale_dtype=_dtype(tq.scale_dtype),
        )
    if tq.scaler == "channel_max":
        # Per-output-channel max over the contraction dim (paper weights).
        alpha = torch.clamp_min(
            w.abs().amax(dim=contract_axis, keepdim=True), 1e-8
        )
        return maybe_ste(w, alpha, tq.fmt, tq.ste)
    if tq.scaler == "dynamic_max":
        return maybe_ste(w, _dynamic_max_alpha(w), tq.fmt, tq.ste)
    raise ValueError(f"bad weight scaler {tq.scaler!r}")


def _fp_matmul(x: torch.Tensor, w: torch.Tensor,
               compute_dtype) -> torch.Tensor:
    """``x @ w`` with operands in ``compute_dtype`` and an f32 result.  TF32
    is switched off: an f32 product here means full f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    y = torch.matmul(x.to(compute_dtype), w.to(compute_dtype))
    return y.to(torch.float32)


def _int8_group_matmul(x, w, tq_in: TensorQuant, tq_w: TensorQuant):
    """Native path: per-group int8 contraction with exact integer sums.

    y[..., nout] = sum_g s_x[..., g] * s_w[g, nout] * (xc_g . wc_g)
    """
    n = tq_in.group
    # honor each operand's scale_dtype so the compressed backend's aligned
    # path (which quantizes x identically) stays bit-exact with this one
    xc, xs, _ = abfp_mod.abfp_quantize(
        x, tq_in.fmt, axis=-1, n=n, dtype=torch.float32,
        scale_dtype=_dtype(tq_in.scale_dtype))
    wc, ws, _ = abfp_mod.abfp_quantize(
        w, tq_w.fmt, axis=0, n=n, dtype=torch.float32,
        scale_dtype=_dtype(tq_w.scale_dtype))
    # xc: (..., G, n) ; wc: (N, G, n) (axis 0 moved last by grouping)
    return group_contract(
        xc, xs, wc, ws,
        max_abs_product=tq_in.fmt.qmax_pos * tq_w.fmt.qmax_pos)


def _is_compressed(w) -> bool:
    # name check: serving_transforms imports this module (no cycle)
    return type(w).__name__ == "CompressedKernel"


def _compressed_group_matmul(x, wk, policy: QuantPolicy, *, site: str,
                             in_alpha, compute_dtype=torch.float32):
    """Contract pre-quantized weight codes + unit scales directly.

    Aligned fast path (int-ABFP input whose group matches the stored
    grouping): quantize x to codes, contract codes with exact integer
    group sums, rescale per (x-group, w-group) — bit-identical to the
    ``int8`` backend given identical codes.  Everything else (static /
    per-tensor / float-format / absent input quantizers) QDQs x per its
    rule and contracts the fp activations against the codes grouped by the
    stored structure, rescaling by the weight's unit scales — exactly
    QDQ(x) @ (codes * scales) without materializing the dense kernel.

    Precision contract: at f32 ``compute_dtype`` this matches the ref
    backend up to f32 accumulation order — greedy tokens are asserted
    identical.  Under a reduced compute dtype the activation operand is
    rounded to ``compute_dtype`` exactly like ``_fp_matmul``; the weight
    side stays codes*scales.
    """
    codes = wk.codes
    if wk.packed:
        codes = unpack_int4_codes(codes)
    if codes.ndim != 3:
        raise ValueError(
            "compressed backend expects rank-3 (N, G, n) codes at apply "
            f"time, got {tuple(codes.shape)}"
        )
    ws = wk.scale.to(torch.float32)  # (N, G)
    N, G, n = codes.shape
    tq = policy.input

    if (tq is not None and isinstance(tq.fmt, IntFormat)
            and tq.scaler == "abfp" and tq.group == n):
        # abfp_quantize zero-pads x along K exactly like the stored codes
        xc, xs, _ = abfp_mod.abfp_quantize(
            x, tq.fmt, axis=-1, n=n, dtype=torch.float32,
            scale_dtype=_dtype(tq.scale_dtype),
        )
        return group_contract(xc, xs, codes, ws,
                              max_abs_product=tq.fmt.qmax_pos * 128.0)

    xq = qdq_activation(x, tq, axis=-1, site=site + "/in", alpha=in_alpha)
    # mirror _fp_matmul's activation-operand rounding, then contract in f32
    xq = xq.to(compute_dtype).to(torch.float32)
    if wk.pad:
        xq = torch.nn.functional.pad(xq, (0, wk.pad))
    xg = xq.reshape(*xq.shape[:-1], G, n)
    torch.backends.cuda.matmul.allow_tf32 = False
    partial = torch.einsum("...gk,ngk->...gn", xg, codes.to(torch.float32))
    return torch.einsum("...gn,ng->...n", partial, ws)


# ---------------------------------------------------------------------------
# Execution-backend registry
# ---------------------------------------------------------------------------
class ExecBackend(NamedTuple):
    """One way to execute the quantized contraction.

    ``weight_repr`` declares the weight representation the backend
    consumes: 'dense' (an (K, N) tensor) or 'compressed'
    (``CompressedKernel`` codes + scales).
    """

    name: str
    weight_repr: str
    fn: Callable


_BACKENDS: dict[str, ExecBackend] = {}


def register_backend(name: str, weight_repr: str = "dense"):
    def deco(fn):
        _BACKENDS[name] = ExecBackend(name, weight_repr, fn)
        return fn
    return deco


def backends() -> dict[str, ExecBackend]:
    """The registered execution backends (read-only view)."""
    return dict(_BACKENDS)


@register_backend("ref")
def _ref_backend(x, w, policy, *, site, in_alpha, compute_dtype):
    """Paper-faithful: QDQ both operands, contract in high precision."""
    if not policy.enabled:
        return _fp_matmul(x, w, compute_dtype)
    xq = qdq_activation(
        x, policy.input, axis=-1, site=site + "/in", alpha=in_alpha
    )
    wq = qdq_weight(w, policy.weight, contract_axis=0)
    return _fp_matmul(xq, wq, compute_dtype)


@register_backend("int8")
def _int8_backend(x, w, policy, *, site, in_alpha, compute_dtype):
    """Beyond-paper: real int8 contraction of freshly quantized codes."""
    return _int8_group_matmul(x, w, policy.input, policy.weight)


@register_backend("fused")
def _fused_backend(x, w, policy, *, site, in_alpha, compute_dtype):
    """Fused QDQ+matmul kernels (``abfp_matmul`` / ``abfp_matmul_int8``)."""
    from repro_torch.kernels import ops as kops

    return kops.abfp_matmul_fused(x, w, policy)


@register_backend("compressed", weight_repr="compressed")
def _compressed_backend(x, w, policy, *, site, in_alpha, compute_dtype):
    """Serve pre-quantized weight codes straight into the contraction."""
    tq = policy.input
    if (policy.fused
            and tq is not None and isinstance(tq.fmt, IntFormat)
            and tq.scaler == "abfp" and tq.group == w.group):
        from repro_torch.kernels import ops as kops

        return kops.quant_matmul_fused(x, w, tq)
    return _compressed_group_matmul(x, w, policy, site=site,
                                    in_alpha=in_alpha,
                                    compute_dtype=compute_dtype)


def _int8_native_ok(policy: QuantPolicy) -> bool:
    tin, tw = policy.input, policy.weight
    return (
        tin is not None and tw is not None
        and tin.scaler == "abfp" and tw.scaler == "abfp"
        and tin.group == tw.group
        and isinstance(tin.fmt, IntFormat) and isinstance(tw.fmt, IntFormat)
    )


def execution_backend(policy: QuantPolicy, w) -> ExecBackend:
    """Select the backend for a *resolved* flat policy + weight.

    The weight representation wins: compressed storage always executes in
    the compressed domain (that backend internally handles every input
    spec, including fp32/no-input rules, without densifying the kernel).
    Dense weights follow the policy: fused -> int8 (when the policy is an
    int-ABFP pair with matched groups) -> ref.
    """
    if _is_compressed(w):
        return _BACKENDS["compressed"]
    if not policy.enabled:
        return _BACKENDS["ref"]
    if policy.fused:
        return _BACKENDS["fused"]
    if policy.compute == "int8" and _int8_native_ok(policy):
        return _BACKENDS["int8"]
    return _BACKENDS["ref"]


def qmatmul(
    x: torch.Tensor,
    w,
    policy: Policy,
    *,
    site: str = "",
    in_alpha=None,
    out_alpha=None,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Quantized-simulated ``x @ w`` with ``x: (..., K)`` and ``w: (K, N)``
    dense or a ``CompressedKernel`` (codes + per-group scales).

    A site-addressed PolicyMap is resolved here against ``site`` — the one
    chokepoint where per-site mixed precision takes effect.  The resolved
    policy + weight representation then pick an execution backend (see
    module docstring).
    """
    policy = resolve_policy(policy, site)
    backend = execution_backend(policy, w)
    if backend.weight_repr == "dense" and _is_compressed(w):
        # repr-mismatch guard: unreachable under the current selection
        # (compressed storage always routes to the compressed backend);
        # raising — instead of silently densifying — surfaces any future
        # selection bug that would defeat the keep-weights-compressed
        # invariant as an error rather than a memory regression
        raise ValueError(
            f"execution backend {backend.name!r} consumes dense weights "
            f"but site {site!r} holds compressed storage; selection must "
            "route CompressedKernel weights to a compressed-consuming "
            "backend (decompress explicitly if densification is intended)"
        )
    y = backend.fn(x, w, policy, site=site, in_alpha=in_alpha,
                   compute_dtype=compute_dtype)
    if policy.output is not None:
        y = qdq_activation(
            y, policy.output, axis=-1, site=site + "/out", alpha=out_alpha
        )
    return y


# ---------------------------------------------------------------------------
# Attention-backend registry (mirror of the execution-backend registry)
# ---------------------------------------------------------------------------
class AttnBackend(NamedTuple):
    """One way to execute the attention block's contractions.

    ``kv_repr`` declares the KV representation the backend consumes:
    'dense' (fp K/V, dequantized if stored quantized) or 'codes'
    (int8/fp8 cache codes + unit scales, contracted in-kernel).
    """

    name: str
    kv_repr: str
    fn: Callable | None  # kernel entry; None when the module decides


_ATTN_BACKENDS: dict[str, AttnBackend] = {}


def register_attn_backend(name: str, kv_repr: str = "dense"):
    def deco(fn):
        _ATTN_BACKENDS[name] = AttnBackend(name, kv_repr, fn)
        return fn
    return deco


def attn_backends() -> dict[str, AttnBackend]:
    """The registered attention backends (read-only view)."""
    return dict(_ATTN_BACKENDS)


def attention_backend(policy: QuantPolicy) -> AttnBackend:
    """Look up the backend a *resolved* flat policy selects.

    ``nn.attention`` resolves the PolicyMap at the block site and calls
    this — an unknown name raises here (the registry is the source of
    truth), the same contract ``execution_backend`` pins for matmuls.
    """
    name = getattr(policy, "attn_backend", "auto") or "auto"
    if name not in _ATTN_BACKENDS:
        raise ValueError(
            f"unknown attention backend {name!r} "
            f"(registered: {sorted(_ATTN_BACKENDS)})")
    return _ATTN_BACKENDS[name]


# 'auto' / 'ref' carry no kernel: the module's reference path runs.
_ATTN_BACKENDS["auto"] = AttnBackend("auto", "dense", None)
_ATTN_BACKENDS["ref"] = AttnBackend("ref", "dense", None)


@register_attn_backend("fused")
def _fused_attn_backend(*args, **kw):
    """Dense flash-attention kernel."""
    from repro_torch.kernels import ops as kops

    return kops.flash_attention_gqa(*args, **kw)


@register_attn_backend("compressed", kv_repr="codes")
def _compressed_attn_backend(*args, **kw):
    """Quantized-KV attention kernel: cache codes contracted on chip."""
    from repro_torch.kernels import ops as kops

    return kops.flash_attention_quant_gqa(*args, **kw)
