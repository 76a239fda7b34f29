"""Roofline terms and the analytic cost model of a launch.

Terms (per card, seconds) — constants from ``launch.mesh`` (one H100 SXM):
    compute    = flops / PEAK_BF16_FLOPS
    memory     = bytes_accessed / HBM_BW
    collective = collective_link_bytes / NVLINK_BW

The dry run (``launch.dryrun``) reads its numbers off a traced step
(``launch.traced.TracedStep``, the port's counterpart of a compiled
executable): ``cost_dict`` and ``memory_dict`` read its cost and memory
analyses, ``collective_bytes`` prices the collectives DTensor issued
(records of kind, local result bytes and group size) with ring factors
(all-reduce 2·P, all-gather P, reduce-scatter (N-1)·R ≈ P, all-to-all R,
collective-permute R), and ``extrapolate`` carries the small unrolled
cells' costs to the whole depth (affine in the layer count).

``enumerate_matmul_sites`` is the site-address contract the layers thread
to ``qmatmul`` (the static analyzer's site universe); ``policy_bits_report``
integrates a policy's bit-widths over it and ``model_flops`` is the
analytic 6·N·D / 2·N·D count.
"""

from __future__ import annotations

from repro_torch.configs.base import pad_to
from repro_torch.core.policy import resolve_policy
from repro_torch.launch import mesh as hw

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16,
}


def _link_bytes(kind: str, result_bytes: int, n: int) -> float:
    """Ring-traffic bytes per card for one collective."""
    if kind == "all-reduce":
        return 2.0 * result_bytes * (n - 1) / max(n, 1)
    if kind == "all-gather":
        return result_bytes * (n - 1) / max(n, 1)
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)  # result is the scattered shard
    if kind == "all-to-all":
        return result_bytes * (n - 1) / max(n, 1)
    return float(result_bytes)  # collective-permute


def collective_bytes(records) -> dict:
    """Per-kind link-byte totals of collective records ``(kind, local
    result bytes, group size)``, kinds named as the reference's HLO names
    them (``traced.COLLECTIVE_KINDS`` maps the ``c10d_functional`` ops)."""
    bytes_by_kind: dict[str, float] = {}
    counts: dict[str, int] = {}
    for kind, result_bytes, n in records:
        b = _link_bytes(kind, result_bytes, n)
        bytes_by_kind[kind] = bytes_by_kind.get(kind, 0.0) + b
        counts[kind] = counts.get(kind, 0) + 1
    return {
        "bytes_by_kind": bytes_by_kind,
        "counts": counts,
        "total_bytes": sum(bytes_by_kind.values()),
    }


def cost_dict(compiled) -> dict:
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return dict(ca)


def memory_dict(compiled) -> dict:
    ma = compiled.memory_analysis()
    keys = (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes",
        "generated_code_size_in_bytes",
    )
    return {k: int(getattr(ma, k, 0)) for k in keys}


def extract_costs(traced) -> dict:
    cost = cost_dict(traced)
    colls = collective_bytes(traced.collectives)
    return {
        "flops": float(cost.get("flops", 0.0)),
        "bytes": float(cost.get("bytes accessed", 0.0)),
        "collective_bytes": float(colls["total_bytes"]),
        "collectives": colls,
    }


def extrapolate(cost_k: dict, cost_2k: dict, periods: int) -> dict:
    """Affine layer-count extrapolation: total = f(k) + (P-1)·(f(2k)-f(k)).

    ``periods`` = n_layers / k where k is the layer-pattern period.
    """
    out = {}
    for key in ("flops", "bytes", "collective_bytes"):
        per = cost_2k[key] - cost_k[key]
        out[key] = cost_k[key] + max(periods - 1, 0) * per
        out[key + "_fixed"] = cost_k[key] - per  # embed/head/optimizer part
        out[key + "_per_period"] = per
    return out


def roofline_terms(flops: float, bytes_accessed: float,
                   coll_bytes: float) -> dict:
    t_c = flops / hw.PEAK_BF16_FLOPS
    t_m = bytes_accessed / hw.HBM_BW
    t_x = coll_bytes / hw.NVLINK_BW
    dominant = max(
        (("compute", t_c), ("memory", t_m), ("collective", t_x)),
        key=lambda kv: kv[1],
    )[0]
    bound = max(t_c, t_m, t_x)
    return {
        "t_compute_s": t_c,
        "t_memory_s": t_m,
        "t_collective_s": t_x,
        "dominant": dominant,
        "roofline_bound_s": bound,
        # fraction of the bound spent on useful compute
        "compute_fraction_of_bound": (t_c / bound) if bound > 0 else 0.0,
    }


# ---------------------------------------------------------------------------
# Per-site bit-width accounting (site-addressed PolicyMap cost model)
# ---------------------------------------------------------------------------
_GATED_ACTS = ("swiglu", "geglu", "reglu")


def enumerate_matmul_sites(cfg) -> list:
    """[(site_address, K, N, multiplicity)] for every quantized matmul.

    Follows the site-name contract the layers thread to ``qmatmul`` (eager
    unrolled naming, ``blocks.{i}/...`` for lm/vit/ssm/moe; family-level
    names ``attn/... mlp/... cross/... shared/... mamba/...`` for
    encdec/hybrid, which never thread layer indices).  K*N*multiplicity is
    the weight parameter count at the site, so per-site bit-widths
    integrate into a weight-bits budget.
    """
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    hd = cfg.head_dim_
    sites = []

    if cfg.family == "hybrid":
        # mamba blocks share family-level names (no layer index); the
        # shared attention block is counted once (zamba2 weight sharing)
        di = cfg.ssm_expand * d
        proj = (2 * di + 2 * cfg.ssm_groups * cfg.ssm_state
                + di // cfg.ssm_head_dim)
        n_shared = L // cfg.shared_attn_every if cfg.shared_attn_every else 0
        n_mamba = L - n_shared
        n_wi = 2 if cfg.act in _GATED_ACTS else 1
        sites = [
            ("mamba/in_proj", d, proj, n_mamba),
            ("mamba/out_proj", di, d, n_mamba),
            ("shared/q", 2 * d, cfg.n_heads * hd, 1),
            ("shared/k", 2 * d, cfg.n_kv * hd, 1),
            ("shared/v", 2 * d, cfg.n_kv * hd, 1),
            ("shared/o", cfg.n_heads * hd, d, 1),
            ("mlp/wi", d, f, n_wi),
            ("mlp/wo", f, d, 1),
            ("embed/attend", d, cfg.vocab_padded, 1),
        ]
        return sites

    if cfg.family == "encdec":
        # encoder self-attn + decoder self-attn + decoder cross-attn all
        # share the generic 'attn' site (same Attention module/name);
        # cross K/V projections are addressed as 'cross/{k,v}'
        E, Ld = cfg.encoder_layers, L
        n_attn = E + 2 * Ld
        n_wi = 2 if cfg.act in _GATED_ACTS else 1
        sites = [
            ("attn/q", d, cfg.n_heads * hd, n_attn),
            ("attn/k", d, cfg.n_kv * hd, E + Ld),  # cross K/V separate
            ("attn/v", d, cfg.n_kv * hd, E + Ld),
            ("attn/o", cfg.n_heads * hd, d, n_attn),
            ("cross/k", d, cfg.n_kv * hd, Ld),
            ("cross/v", d, cfg.n_kv * hd, Ld),
            ("mlp/wi", d, f, n_wi * (E + Ld)),
            ("mlp/wo", f, d, E + Ld),
            ("embed/attend", d, cfg.vocab_padded, 1),
        ]
        return sites

    def block_sites(i: int):
        out = []
        if cfg.family == "ssm" or (cfg.ssm_state > 0 and cfg.family != "hybrid"):
            di = cfg.ssm_expand * d
            proj = (2 * di + 2 * cfg.ssm_groups * cfg.ssm_state
                    + di // cfg.ssm_head_dim)
            out.append((f"blocks.{i}/mamba/in_proj", d, proj, 1))
            out.append((f"blocks.{i}/mamba/out_proj", di, d, 1))
            return out
        out.append((f"blocks.{i}/attn/q", d, cfg.n_heads * hd, 1))
        out.append((f"blocks.{i}/attn/k", d, cfg.n_kv * hd, 1))
        out.append((f"blocks.{i}/attn/v", d, cfg.n_kv * hd, 1))
        out.append((f"blocks.{i}/attn/o", cfg.n_heads * hd, d, 1))
        n_wi = 2 if cfg.act in _GATED_ACTS else 1  # wi (+ wg)
        if cfg.family == "moe" and cfg.n_experts > 0:
            # one site per expert (the runtime per-expert weight contract
            # in nn.moe / serving_transforms.expert_site), so per-expert
            # precision maps account expert bits individually
            for e in range(cfg.n_experts):
                out.append((f"blocks.{i}/ffn/experts.{e}", d, f, n_wi))
                out.append((f"blocks.{i}/ffn/experts.{e}", f, d, 1))
        else:
            out.append((f"blocks.{i}/ffn/wi", d, f, 1))
            if n_wi == 2:
                out.append((f"blocks.{i}/ffn/wg", d, f, 1))
            out.append((f"blocks.{i}/ffn/wo", f, d, 1))
        return out

    if cfg.family == "vit":
        sites.append(("patch_embed", cfg.patch_size**2 * cfg.n_channels, d, 1))
        for i in range(L):
            sites.extend(block_sites(i))
        sites.append(("head", d, pad_to(cfg.n_classes, 128), 1))
        return sites

    for i in range(L):
        sites.extend(block_sites(i))
    if cfg.tied_embeddings:
        sites.append(("embed/attend", d, cfg.vocab_padded, 1))
    else:
        sites.append(("lm_head", d, cfg.vocab_padded, 1))
    return sites


def policy_bits_report(cfg, policy, unquant_bits: int = 16) -> dict:
    """Resolve ``policy`` at every matmul site and integrate bit-widths.

    Returns per-site weight/activation bits plus the aggregate weight-bits
    budget — the cost-model view of a site-addressed PolicyMap (what the
    speculative and expert lints compare).  Unquantized tensors
    are charged ``unquant_bits`` (bf16 serving dtype).
    """
    per_site = []
    total_bits = 0.0
    total_params = 0
    for site, K, N, mult in enumerate_matmul_sites(cfg):
        pol = resolve_policy(policy, site)
        w_bits = pol.weight.fmt.bits if pol.weight is not None else unquant_bits
        a_bits = pol.input.fmt.bits if pol.input is not None else unquant_bits
        n_params = K * N * mult
        per_site.append({
            "site": site,
            "policy": pol.name,
            "w_bits": w_bits,
            "a_bits": a_bits,
            "params": n_params,
        })
        total_bits += n_params * w_bits
        total_params += n_params
    return {
        "sites": per_site,
        "total_weight_bits": total_bits,
        "total_weight_params": total_params,
        "mean_weight_bits": total_bits / max(total_params, 1),
    }


def model_flops(cfg, shape, chips: int) -> float:
    """Analytic 6·N·D (train) / 2·N·D (inference fwd), per card."""
    n = cfg.n_active_params() if cfg.family == "moe" else cfg.n_params()
    if cfg.family == "vit" and shape.kind in ("train", "prefill"):
        # encoder length is fixed by the image grid, not the shape's seq_len
        # (decode kinds fall through to the generic one-token convention;
        # vit configs skip them, but callers may not consult skip_shapes)
        tokens = shape.global_batch * cfg.vit_seq_len
        total = (6.0 if shape.kind == "train" else 2.0) * n * tokens
    elif shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        total = 6.0 * n * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        total = 2.0 * n * tokens
    else:  # decode: one token per sequence
        total = 2.0 * n * shape.global_batch
    return total / chips
