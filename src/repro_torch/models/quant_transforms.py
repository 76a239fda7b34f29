"""Model-level PTQ pass implementations: calibration -> static scales /
SmoothQuant / GPTQ / RPTQ applied to a TransformerLM params tree.

This is the analogue of INT-FP-QSim's "replace the layers" step at the
model level: the layers already carry quantizer hooks (policy + optional
``q`` static-scale tree); these functions *produce* the folded weights and
the ``q`` tree from calibration statistics.  Weights, statistics and alphas
stay tensors on the model's device.

The canonical driver API is the ``QuantRecipe`` pass pipeline in
``repro_torch.core.recipe`` — the engine sequences these implementations,
re-calibrating between param-mutating and stats-consuming passes.  The old
free-function entry points (``apply_smoothquant``, ``apply_gptq``,
``rptq_qtree``, ``static_qtree``) remain as deprecation shims that delegate
to single-pass recipes.

Layers always run one by one (a list of per-layer dicts), so Calibrator
observers fire per site.

Site-name contract (set by nn.* layer names threaded from models.lm):
    blocks.{i}/attn/{q,k,v,o}/in      linear inputs
    blocks.{i}/attn/bmm_{q,k,v}       attention BMM operands
    blocks.{i}/attn/probs             attention probabilities
    blocks.{i}/ffn/{wi,wo}/in         MLP inputs (wg shares wi's input)
    blocks.{i}/mamba/{in_proj,out_proj}/in
    embed/attend/in                   tied LM head input

Site-addressed PolicyMaps plug in at two points: ``site_address`` maps a
calibration site to its policy-resolution address, and
``solve_alphas_for_policy`` / ``static_qtree(calib, policy_map, ...)``
solve each site's clip range against *its resolved format* (one
observation pass, per-site solves).
"""

from __future__ import annotations

import re
import warnings
from typing import Callable

import torch

from repro_torch.core import rptq as rptq_mod
from repro_torch.core import smoothquant as sq_mod
from repro_torch.core.calibration import Calibrator, max_alpha, mse_alpha
from repro_torch.core.formats import Format
from repro_torch.core.gptq import GPTQConfig, gptq_quantize
from repro_torch.core.policy import (NONE, Policy, PolicyMap, QuantPolicy,
                                     resolve_policy)

SiteFilter = Callable[[str], bool]  # matched against the site ADDRESS


def _copy_tree(node):
    """A new nest of dicts / lists over the same tensors (the reference's
    ``tree_map(lambda x: x, ...)``: passes replace leaves, never mutate)."""
    if isinstance(node, dict):
        return {k: _copy_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_copy_tree(v) for v in node)
    return node


# ---------------------------------------------------------------------------
# Calibration pass
# ---------------------------------------------------------------------------
@torch.no_grad()
def calibrate(model, params, batches, policy: Policy,
              collect_outer: bool = False) -> Calibrator:
    """Run observation passes over ``batches`` (list of batch dicts)."""
    calib = Calibrator(collect_outer=collect_outer)
    with calib.observing():
        for batch in batches:
            model.apply(params, batch, policy)
    return calib


def solve_alphas(calib: Calibrator, fmt: Format, method: str = "mse",
                 per_channel: bool = False,
                 site_filter: SiteFilter | None = None) -> dict:
    """{site: alpha} for every observed site, all against one format.

    ``site_filter`` (matched against the site *address*) scopes the solve —
    how recipe passes restrict themselves to e.g. ``*ffn*`` sites.
    """
    out = {}
    for site, st in calib.stats.items():
        if site_filter is not None and not site_filter(site_address(site)):
            continue
        if method == "max":
            out[site] = max_alpha(st, per_channel=per_channel)
        elif method == "mse":
            out[site] = mse_alpha(st, fmt, per_channel=per_channel)
        else:
            raise ValueError(f"unknown calibration method {method!r}")
    return out


def site_address(calib_site: str) -> str:
    """Calibration site name -> PolicyMap resolution address.

    Linear inputs drop the trailing ``/in``; attention BMM operands and
    probabilities resolve at the owning attention block (where the layer
    reads ``attn_bmm`` off its resolved policy).
    """
    if calib_site.endswith("/in"):
        return calib_site[: -len("/in")]
    head, _, leaf = calib_site.rpartition("/")
    if leaf.startswith("bmm_") or leaf == "probs":
        return head
    return calib_site


def solve_alphas_for_policy(calib: Calibrator, policy: Policy,
                            method: str = "mse",
                            per_channel: bool = False,
                            site_filter: SiteFilter | None = None) -> dict:
    """Per-site alphas where each site solves for *its* resolved format.

    The mixed-precision counterpart of ``solve_alphas``: with a PolicyMap a
    W8A8 endcap block grid-searches its clip range against INT8 while the
    W4A4 interior searches against INT4 — one calibration pass, per-site
    solves.  Sites whose resolved policy has no input quantizer (fp32
    rules) are skipped; ``site_filter`` additionally scopes by address.
    """
    out = {}
    for site, st in calib.stats.items():
        addr = site_address(site)
        if site_filter is not None and not site_filter(addr):
            continue
        tq = resolve_policy(policy, addr).input
        if tq is None:
            continue
        if method == "max":
            out[site] = max_alpha(st, per_channel=per_channel)
        elif method == "mse":
            out[site] = mse_alpha(st, tq.fmt, per_channel=per_channel)
        else:
            raise ValueError(f"unknown calibration method {method!r}")
    return out


# ---------------------------------------------------------------------------
# Static-scale q tree
# ---------------------------------------------------------------------------
_SITE_RE = re.compile(
    r"^blocks\.(\d+)/(attn|ffn|mamba)/([a-z_]+)(?:/in)?$"
)

# q-tree key for each site leaf name
_LEAF_KEY = {
    "q": "q", "k": "k", "v": "v", "o": "o",
    "bmm_q": "bmm_q", "bmm_k": "bmm_k", "bmm_v": "bmm_v", "probs": "probs",
    "wi": "wi", "wo": "wo",
    "in_proj": "in_proj", "out_proj": "out_proj",
}


def build_qtree(n_layers: int, alphas: dict) -> tuple[dict, tuple]:
    """{site: alpha} -> (q tree matching TransformerLM.apply(q=...), dropped).

    ``dropped`` reports the calibration sites that could not be placed in
    the block tree (e.g. ``embed/attend/in``, out-of-range layer indices,
    unknown leaves) — those fall back to dynamic-max at eval.  Callers
    surface the report instead of silently losing sites.
    """
    blocks = [dict() for _ in range(n_layers)]
    dropped = []
    for site, alpha in alphas.items():
        m = _SITE_RE.match(site)
        if not m:
            dropped.append(site)
            continue
        i, group, leaf = int(m.group(1)), m.group(2), m.group(3)
        if leaf not in _LEAF_KEY or i >= n_layers:
            dropped.append(site)
            continue
        blocks[i].setdefault(group, {})[_LEAF_KEY[leaf]] = {
            "in_alpha": torch.as_tensor(alpha)
        }
    for b in blocks:
        ffn = b.get("ffn")
        if ffn and "wi" in ffn and "wg" not in ffn:
            ffn["wg"] = ffn["wi"]  # gate sees the same input as wi
    return {"blocks": blocks}, tuple(sorted(dropped))


def static_qtree(calib: Calibrator, fmt, n_layers: int,
                 method: str = "mse", return_report: bool = False):
    """DEPRECATED shim: the paper's static activation calibration (§II-B1).

    Use a ``static`` recipe pass instead (``get_recipe('static_mse')``).
    ``fmt`` is either a single Format (every site solves against it) or a
    flat-policy/PolicyMap (each site solves against its *resolved* input
    format — the mixed-precision path).  With ``return_report=True`` also
    returns the dropped-site report from ``build_qtree``.
    """
    _warn_deprecated("static_qtree",
                     "recipe.get_recipe('static_mse') / a 'static' pass")
    from repro_torch.core import recipe as rc

    if isinstance(fmt, (QuantPolicy, PolicyMap)):
        policy, fmt_name = fmt, None
    else:
        policy, fmt_name = NONE, fmt.name
    rec = rc.QuantRecipe("static_qtree_shim", (
        rc.PassSpec("static", options={"fmt": fmt_name, "method": method}),))
    res = rc.RecipeEngine(policy=policy, n_layers=n_layers).run(
        rec, {}, calib=calib)
    if return_report:
        return res.qtree, res.dropped_sites
    return res.qtree


# ---------------------------------------------------------------------------
# SmoothQuant (paper §II-B3)
# ---------------------------------------------------------------------------
def _smoothquant_params(params, calib: Calibrator, *, alpha: float = 0.5,
                        plus_one_norm: bool = False,
                        site_filter: SiteFilter | None = None
                        ) -> tuple[dict, int]:
    """Fold SmoothQuant factors into ln1->qkv and ln2->(wi,wg).

    Follows the reference implementation: only norm-preceded projections are
    smoothed (o/wo have no foldable producer and stay unsmoothed).  Returns
    (new params tree, number of folded sites).  ``site_filter`` scopes by
    the fold's anchor address (``blocks.{i}/attn/q`` for the qkv fold,
    ``blocks.{i}/ffn/wi`` for the MLP fold).
    """
    blocks = params["blocks"]
    assert isinstance(blocks, (list, tuple)), (
        "SmoothQuant requires per-layer params")
    n_folded = 0
    new_blocks = []
    for i, bp in enumerate(blocks):
        bp = _copy_tree(bp)
        if "attn" in bp and (site_filter is None
                             or site_filter(f"blocks.{i}/attn/q")):
            site = f"blocks.{i}/attn/q/in"
            if site in calib.stats:
                n_folded += 1
                act_absmax = calib.stats[site].ch_absmax
                w_absmax = torch.stack(
                    [bp["attn"][k]["kernel"].abs().amax(dim=1)
                     for k in ("q", "k", "v")]).amax(dim=0)
                s = sq_mod.smoothing_factors(act_absmax, w_absmax, alpha)
                for k in ("q", "k", "v"):
                    w = bp["attn"][k]["kernel"]
                    bp["attn"][k]["kernel"] = w * s[:, None].to(w.dtype)
                bp["ln1"] = _fold_norm(bp["ln1"], s, plus_one_norm)
        if "ffn" in bp and "wi" in bp["ffn"] and (
                site_filter is None or site_filter(f"blocks.{i}/ffn/wi")):
            site = f"blocks.{i}/ffn/wi/in"
            if site in calib.stats:
                n_folded += 1
                act_absmax = calib.stats[site].ch_absmax
                names = [k for k in ("wi", "wg") if k in bp["ffn"]]
                w_absmax = torch.stack(
                    [bp["ffn"][k]["kernel"].abs().amax(dim=1)
                     for k in names]).amax(dim=0)
                s = sq_mod.smoothing_factors(act_absmax, w_absmax, alpha)
                for k in names:
                    w = bp["ffn"][k]["kernel"]
                    bp["ffn"][k]["kernel"] = w * s[:, None].to(w.dtype)
                bp["ln2"] = _fold_norm(bp["ln2"], s, plus_one_norm)
        new_blocks.append(bp)
    out = dict(params)
    out["blocks"] = new_blocks
    return out, n_folded


def apply_smoothquant(params, calib: Calibrator, *, alpha: float = 0.5,
                      plus_one_norm: bool = False) -> dict:
    """DEPRECATED shim: delegate to a single-pass 'smoothquant' recipe."""
    _warn_deprecated("apply_smoothquant",
                     "recipe.get_recipe('smoothquant')")
    from repro_torch.core import recipe as rc

    rec = rc.QuantRecipe("smoothquant_shim", (
        rc.PassSpec("smoothquant",
                    options={"alpha": alpha,
                             "plus_one_norm": plus_one_norm}),))
    eng = rc.RecipeEngine(policy=NONE, n_layers=len(params["blocks"]))
    return eng.run(rec, params, calib=calib).params


def _fold_norm(norm_params: dict, s: torch.Tensor, plus_one: bool) -> dict:
    np_ = dict(norm_params)
    scale = np_["scale"]
    if plus_one:  # effective scale is (1 + w): (1+w)/s = 1 + w'
        np_["scale"] = ((1.0 + scale.to(torch.float32)) / s - 1.0).to(
            scale.dtype)
    else:
        np_["scale"] = (scale.to(torch.float32) / s).to(scale.dtype)
    if "bias" in np_:
        b = np_["bias"]
        np_["bias"] = (b.to(torch.float32) / s).to(b.dtype)
    return np_


# ---------------------------------------------------------------------------
# GPTQ (paper §II-B4)
# ---------------------------------------------------------------------------
_GPTQ_SITES = {
    ("attn", "q"): "attn/q/in",
    ("attn", "k"): "attn/q/in",   # same input as q (ln1 output)
    ("attn", "v"): "attn/q/in",
    ("attn", "o"): "attn/o/in",
    ("ffn", "wi"): "ffn/wi/in",
    ("ffn", "wg"): "ffn/wi/in",
    ("ffn", "wo"): "ffn/wo/in",
}


def _gptq_params(params, calib: Calibrator, fmt: Format,
                 cfg: GPTQConfig = GPTQConfig(), *,
                 site_filter: SiteFilter | None = None,
                 progress: Callable | None = None) -> tuple[dict, dict]:
    """Replace every decoder linear kernel with its GPTQ-quantized version.

    ``calib`` must have been collected with ``collect_outer=True`` (Hessians
    H = X^T X per site).  Returns (new_params, info-per-site).
    ``site_filter`` scopes by the kernel's address ``blocks.{i}/{group}/{name}``.
    """
    blocks = params["blocks"]
    assert isinstance(blocks, (list, tuple)), "GPTQ requires per-layer params"
    dtype = params_dtype(params)
    infos = {}
    new_blocks = []
    for i, bp in enumerate(blocks):
        bp = _copy_tree(bp)
        for (group, name), site_suffix in _GPTQ_SITES.items():
            if group not in bp or name not in bp[group]:
                continue
            if site_filter is not None and not site_filter(
                    f"blocks.{i}/{group}/{name}"):
                continue
            site = f"blocks.{i}/{site_suffix}"
            st = calib.stats.get(site)
            if st is None or st.outer is None:
                continue
            w = bp[group][name]["kernel"].to(torch.float32)
            wq, info = gptq_quantize(w, st.outer, fmt, cfg)
            bp[group][name]["kernel"] = wq.to(dtype)
            infos[f"blocks.{i}/{group}/{name}"] = info
            if progress:
                progress(i, group, name, info)
        new_blocks.append(bp)
    out = dict(params)
    out["blocks"] = new_blocks
    return out, infos


def apply_gptq(params, calib: Calibrator, fmt: Format,
               cfg: GPTQConfig = GPTQConfig(), *,
               progress: Callable | None = None) -> tuple[dict, dict]:
    """DEPRECATED shim: delegate to a single-pass 'gptq' recipe."""
    _warn_deprecated("apply_gptq", "recipe.get_recipe('gptq')")
    if progress is not None:  # callbacks are not recipe-serializable
        return _gptq_params(params, calib, fmt, cfg, progress=progress)
    from repro_torch.core import recipe as rc

    rec = rc.QuantRecipe("gptq_shim", (
        rc.PassSpec("gptq", options={
            "fmt": fmt.name, "percdamp": cfg.percdamp,
            "blocksize": cfg.blocksize, "group_size": cfg.group_size,
            "actorder": cfg.actorder}),))
    res = rc.RecipeEngine(policy=NONE, n_layers=len(params["blocks"])).run(
        rec, params, calib=calib)
    return res.params, res.artifacts.get("gptq", {})


def params_dtype(params) -> torch.dtype:
    """The dtype of the first floating-point tensor in ``params``."""
    stack = [params]
    while stack:
        node = stack.pop(0)
        if isinstance(node, dict):
            stack[:0] = list(node.values())
        elif isinstance(node, (list, tuple)):
            stack[:0] = list(node)
        elif isinstance(node, torch.Tensor) and node.is_floating_point():
            return node.dtype
    return torch.float32


# ---------------------------------------------------------------------------
# RPTQ (paper §II-B5)
# ---------------------------------------------------------------------------
def _rptq_alphas(calib: Calibrator, num_clusters: int = 8,
                 site_filter: SiteFilter | None = None) -> tuple[dict, dict]:
    """Cluster activation channels per site -> ({site: per-ch alpha}, perms).

    Numerically identical to the reorder+cluster-scale scheme (the
    permutation only matters for hardware layout — see core/rptq.py); the
    perms are returned for the equivalence tests / a hardware backend.
    The alphas go back to the statistics' device.
    """
    alphas, perms = {}, {}
    for site, st in calib.stats.items():
        if st.ch_min is None:
            continue
        if site_filter is not None and not site_filter(site_address(site)):
            continue
        res = rptq_mod.solve(st.ch_min.cpu().numpy(), st.ch_max.cpu().numpy(),
                             num_clusters=num_clusters)
        alphas[site] = torch.from_numpy(res.alpha_per_channel).to(
            st.ch_min.device)
        perms[site] = res.perm
    return alphas, perms


def rptq_qtree(calib: Calibrator, n_layers: int,
               num_clusters: int = 8) -> tuple[dict, dict]:
    """DEPRECATED shim: delegate to a single-pass 'rptq' recipe."""
    _warn_deprecated("rptq_qtree", "recipe.get_recipe('rptq')")
    from repro_torch.core import recipe as rc

    rec = rc.QuantRecipe("rptq_shim", (
        rc.PassSpec("rptq", options={"num_clusters": num_clusters}),))
    res = rc.RecipeEngine(policy=NONE, n_layers=n_layers).run(
        rec, {}, calib=calib)
    return res.qtree, res.artifacts.get("rptq_perms", {})


# ---------------------------------------------------------------------------
# Deprecation plumbing
# ---------------------------------------------------------------------------
def _warn_deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"repro_torch.models.quant_transforms.{old} is deprecated; drive "
        f"PTQ through the QuantRecipe pipeline instead: {new} "
        "(see repro_torch.core.recipe)",
        DeprecationWarning, stacklevel=3,
    )
