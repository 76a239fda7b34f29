"""Weights carried across: the reference package's parameter tree, as numpy
arrays, becomes the port's tree of tensors — and so do its PTQ artifacts:
a static-scale q tree (``from_repro_qtree``), a calibrator's running
statistics (``from_repro_calibrator``), an optimizer state
(``from_repro_opt_state``) and a checkpoint the reference wrote
(``read_repro_checkpoint``).

``from_repro_params`` takes the reference's *unboxed* parameter tree (a
decoder LM's, an SSM LM's (``blocks`` of ``{ln, mamba}``), a ViT's:
``patch_embed``, ``pos_embed``, ``cls``, ``final_norm``, ``head`` and the
blocks; the Zamba2 hybrid's: ``embed``, ``mamba_groups``, ``shared``,
``lora``, ``final_norm``; or an encoder-decoder's: ``embed``,
``pos_embed``, ``encoder``, ``decoder``, ``enc_norm``, ``final_norm``;
or an MoE LM's, whose blocks' ``ffn`` holds the ``router`` (D, E) and
the expert stacks ``wi`` / ``wg`` (E, D, F) and ``wo`` (E, F, D))
after a host transfer (nested dicts of numpy
arrays; the caller does the ``device_get``), so this module imports nothing
of the reference.  Layers stacked along a leading ``(L, ...)`` axis (the
reference's ``scan_layers=True`` form) are unstacked into the port's list of
per-layer dicts; a list stays a list.  The hybrid's ``mamba_groups`` (G,
k-1, ...) become a list of G lists of k-1 block dicts and its ``lora`` (G,
...) a list of G dicts.  A key the port does not know is an error, not a
silent drop.  The encoder-decoder's ``encoder`` and ``decoder`` (stacked
or listed) become lists of per-layer dicts, as ``blocks`` do; a VLM's tree
is a decoder LM's, its head untied (``lm_head``).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.nn.module import require_device

_LEAF = None
_DENSE = {"kernel": _LEAF, "bias": _LEAF, "smooth": _LEAF}
_NORM = {"scale": _LEAF, "bias": _LEAF}
_ATTN = {"q": _DENSE, "k": _DENSE, "v": _DENSE, "o": _DENSE}
_MLP = {"wi": _DENSE, "wg": _DENSE, "wo": _DENSE}
_MAMBA = {"in_proj": _DENSE, "out_proj": _DENSE, "conv_w": _LEAF,
          "conv_b": _LEAF, "A_log": _LEAF, "D": _LEAF, "dt_bias": _LEAF,
          "norm": _NORM}
_BLOCK = {
    "ln1": _NORM, "ln2": _NORM, "ln1_post": _NORM, "ln2_post": _NORM,
    "attn": _ATTN, "ffn": _MLP,
    # the SSM family's block: a pre-norm Mamba2 mixer
    "ln": _NORM, "mamba": _MAMBA,
}
# the MoE family's block: its FFN is a router and three expert stacks
_MOE_BLOCK = dict(_BLOCK, ffn={"router": _LEAF, "wi": _LEAF, "wg": _LEAF,
                               "wo": _LEAF})
_LORA = {nm: {"A": _LEAF, "B": _LEAF} for nm in ("q", "k", "v")}
# the encoder-decoder's blocks: pre-LN encoder blocks, and decoder blocks
# with a cross-attention between self-attention and the MLP
_ENC_BLOCK = {"ln1": _NORM, "attn": _ATTN, "ln2": _NORM, "mlp": _MLP}
_DEC_BLOCK = {"ln1": _NORM, "self_attn": _ATTN, "ln_x": _NORM,
              "cross_attn": _ATTN, "ln2": _NORM, "mlp": _MLP}
_ENCDEC = {"embed": {"table": _LEAF}, "pos_embed": _LEAF,
           "encoder": _ENC_BLOCK, "decoder": _DEC_BLOCK, "enc_norm": _NORM,
           "final_norm": _NORM}
_TOP = {
    "embed": {"table": _LEAF},
    "final_norm": _NORM,
    "lm_head": _DENSE,
    "pos_embed": _LEAF,
    "blocks": _BLOCK,
    # the vision family's front and head
    "patch_embed": _DENSE,
    "cls": _LEAF,
    "head": _DENSE,
    # the hybrid's Mamba2 groups, shared attention block and its LoRAs
    "mamba_groups": {"ln": _NORM, "mamba": _MAMBA},
    "shared": {"ln1": _NORM, "attn": _ATTN, "ln2": _NORM, "mlp": _MLP},
    "lora": _LORA,
    # the encoder-decoder's stacks and encoder norm
    "encoder": _ENC_BLOCK,
    "decoder": _DEC_BLOCK,
    "enc_norm": _NORM,
}
# top-level keys of the trees with a layout of their own, by family
_FOREIGN = {"mamba_groups": "hybrid", "shared": "hybrid", "lora": "hybrid",
            "encoder": "encdec", "decoder": "encdec", "enc_norm": "encdec"}


def _convert(node, schema, path: str, device, index=None):
    """numpy tree -> tensor tree under ``schema``; ``index`` selects one
    layer of leaves stacked along a leading axis."""
    if schema is _LEAF:
        if isinstance(node, dict):
            raise KeyError(f"{path}: expected an array, got a dict with "
                           f"keys {sorted(node)}")
        if isinstance(node, torch.Tensor):  # a checkpoint's bf16 leaf
            t = node if index is None else node[index]
            return t.clone().to(device)
        arr = np.asarray(node)
        if index is not None:
            arr = arr[index]
        return torch.from_numpy(np.array(arr)).to(device)  # a copy
    if not isinstance(node, dict):
        raise KeyError(f"{path}: expected a dict of {sorted(schema)}, got "
                       f"{type(node).__name__}")
    unknown = sorted(set(node) - set(schema))
    if unknown:
        raise KeyError(
            f"{path or 'params'}: unknown parameter key(s) {unknown}; the "
            f"port knows {sorted(schema)} here")
    return {k: _convert(v, schema[k], f"{path}/{k}" if path else k, device,
                        index)
            for k, v in node.items()}


def _first_leaf(node):
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return np.asarray(node)


def _layers(node, schema, name: str, device) -> list:
    """A stack of layers — stacked (L, ...) leaves or a list of per-layer
    dicts — as a list of per-layer dicts of tensors."""
    if isinstance(node, dict):  # stacked (L, ...) leaves: unstack
        n = _first_leaf(node).shape[0]
        return [_convert(node, schema, f"{name}.{i}", device, i)
                for i in range(n)]
    return [_convert(b, schema, f"{name}.{i}", device)
            for i, b in enumerate(node)]


def from_repro_params(tree: dict, cfg: ArchConfig, device="cuda") -> dict:
    """The reference's parameter tree (numpy) as the port's (tensors on
    ``device``), for a dense-, moe-, ssm-, vlm-, hybrid-, encdec- or
    vit-family ``cfg``."""
    device = require_device(device)
    unknown = sorted(set(tree) - set(_TOP))
    if unknown:
        raise KeyError(f"params: unknown top-level key(s) {unknown}; the "
                       f"port knows {sorted(_TOP)}")
    if cfg.family == "hybrid":
        return _hybrid_params(tree, cfg, device)
    if cfg.family == "encdec":
        return _encdec_params(tree, cfg, device)
    out = {}
    for key, node in tree.items():  # key order is kept: reports walk it
        if key in _FOREIGN:
            raise KeyError(f"params: {key!r} belongs to the {_FOREIGN[key]} "
                           f"family, not {cfg.name} ({cfg.family})")
        if key != "blocks":
            out[key] = _convert(node, _TOP[key], key, device)
        else:
            out[key] = _layers(node, _MOE_BLOCK if cfg.family == "moe"
                               else _BLOCK, "blocks", device)
    if "blocks" not in out:
        raise KeyError("params lack 'blocks'")
    if len(out["blocks"]) != cfg.n_layers:
        raise ValueError(
            f"params hold {len(out['blocks'])} layers but {cfg.name} has "
            f"n_layers={cfg.n_layers}")
    if cfg.family == "vit":
        need = {"patch_embed", "pos_embed", "final_norm", "head",
                "blocks"} | ({"cls"} if cfg.pool == "cls" else set())
    else:
        need = {"embed", "final_norm", "blocks"} | (
            set() if cfg.tied_embeddings else {"lm_head"})
    missing = sorted(need - set(out))
    if missing:
        raise KeyError(f"params lack {missing} required by {cfg.name}")
    return out


def _hybrid_params(tree: dict, cfg: ArchConfig, device) -> dict:
    """The hybrid's tree: ``mamba_groups`` stacked (G, k-1, ...) and
    ``lora`` stacked (G, ...) unstacked into lists."""
    need = ("embed", "mamba_groups", "shared", "lora", "final_norm")
    wrong = sorted(set(tree) - set(need))
    missing = sorted(set(need) - set(tree))
    if wrong or missing:
        raise KeyError(f"params of {cfg.name}: unexpected {wrong}, missing "
                       f"{missing}; the hybrid's tree holds {list(need)}")
    G, k1 = _first_leaf(tree["mamba_groups"]).shape[:2]
    if G * (k1 + 1) != cfg.n_layers or k1 + 1 != cfg.shared_attn_every:
        raise ValueError(
            f"params hold {G} groups of {k1} Mamba2 blocks but {cfg.name} "
            f"has n_layers={cfg.n_layers}, shared_attn_every="
            f"{cfg.shared_attn_every}")
    out = {}
    for key, node in tree.items():
        if key == "mamba_groups":
            out[key] = [[_convert(node, _TOP[key], f"{key}.{g}.{j}", device,
                                  (g, j)) for j in range(k1)]
                        for g in range(G)]
        elif key == "lora":
            out[key] = [_convert(node, _LORA, f"lora.{g}", device, g)
                        for g in range(G)]
        else:
            out[key] = _convert(node, _TOP[key], key, device)
    return out


def _encdec_params(tree: dict, cfg: ArchConfig, device) -> dict:
    """The encoder-decoder's tree: ``encoder`` and ``decoder`` stacked (L,
    ...) or listed, unstacked into lists of per-layer dicts."""
    wrong = sorted(set(tree) - set(_ENCDEC))
    missing = sorted(set(_ENCDEC) - set(tree))
    if wrong or missing:
        raise KeyError(f"params of {cfg.name}: unexpected {wrong}, missing "
                       f"{missing}; the encoder-decoder's tree holds "
                       f"{list(_ENCDEC)}")
    out = {}
    for key, node in tree.items():
        if key in ("encoder", "decoder"):
            out[key] = _layers(node, _ENCDEC[key], key, device)
        else:
            out[key] = _convert(node, _ENCDEC[key], key, device)
    for key, n in (("encoder", cfg.encoder_layers),
                   ("decoder", cfg.n_layers)):
        if len(out[key]) != n:
            raise ValueError(f"params hold {len(out[key])} {key} layers but "
                             f"{cfg.name} has {n}")
    return out


def from_repro_qtree(tree: dict, device="cuda") -> dict:
    """The reference's static-scale q tree (``{"blocks": [{group: {leaf:
    {"in_alpha": alpha}}}]}``, alphas as numpy after a host transfer) as the
    port's: the same nesting, every alpha a float32 tensor on ``device``."""
    device = require_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return torch.from_numpy(
            np.array(node, dtype=np.float32)).to(device)

    return conv(tree)


def from_repro_calibrator(calib, device="cuda"):
    """A reference ``Calibrator`` (its ``stats`` hold numpy arrays and
    Python floats) as the port's, every statistic a tensor on ``device``:
    absmax a 0-d float32 tensor, the per-channel vectors and reservoir rows
    float32, the X^T X outer products float64."""
    from repro_torch.core.calibration import Calibrator, RunningStats

    device = require_device(device)

    def t(x, dtype):
        return None if x is None else torch.from_numpy(
            np.array(x, dtype=dtype)).to(device)

    out = Calibrator(collect_outer=calib.collect_outer)
    for site, st in calib.stats.items():
        out.stats[site] = RunningStats(
            absmax=t(st.absmax, np.float32),
            ch_absmax=t(st.ch_absmax, np.float32),
            ch_min=t(st.ch_min, np.float32),
            ch_max=t(st.ch_max, np.float32),
            count=int(st.count),
            samples=[t(x, np.float32) for x in st.samples],
            max_samples=st.max_samples,
            collect_outer=st.collect_outer,
            outer=t(st.outer, np.float64),
        )
    return out


def from_repro_opt_state(state, cfg: ArchConfig, device="cuda"):
    """The reference's ``AdamWState`` (``mu`` / ``nu`` trees of numpy
    arrays after a host transfer, ``count`` an int32 scalar) as the port's:
    the moments laid out as ``from_repro_params`` lays out the parameters,
    ``count`` an int32 tensor on ``device``."""
    from repro_torch.optim.adamw import AdamWState

    device = require_device(device)
    return AdamWState(
        mu=from_repro_params(state.mu, cfg, device),
        nu=from_repro_params(state.nu, cfg, device),
        count=torch.tensor(int(np.asarray(state.count)), dtype=torch.int32,
                           device=device))


_TOKEN = re.compile(
    r"\['(?P<key>[^']*)'\]|\[(?P<index>\d+)\]|\.(?P<attr>\w+)")


def _tree_from_paths(entries) -> dict:
    """Nested dicts (and lists, for ``[i]`` keys) from ``(path, leaf)``
    pairs whose paths are the reference's key strings
    (``['blocks']/[0]/['attn']``; a NamedTuple's field is ``.mu``)."""
    root: dict = {}
    for path, leaf in entries:
        keys = []
        for tok in path.split("/"):
            m = _TOKEN.fullmatch(tok)
            if m is None:
                raise ValueError(f"checkpoint path {path!r}: cannot parse "
                                 f"{tok!r}")
            keys.append(int(m["index"]) if m["index"] is not None
                        else m["key"] if m["key"] is not None else m["attr"])
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            if sorted(node) != list(range(len(node))):
                raise ValueError(f"checkpoint indices {sorted(node)} are "
                                 "not 0..n-1")
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def read_repro_checkpoint(directory: str, step: int, cfg: ArchConfig,
                          device="cuda") -> dict:
    """A checkpoint written by the reference's ``checkpoint.store`` (its
    ``CheckpointManager``: ``step_<N>/params`` and ``step_<N>/opt``) as the
    port's trees: ``{"params": ..., "opt": AdamWState, "metadata": ...}``.
    The manifest's leaf paths are parsed into the reference's tree, which
    ``from_repro_params`` (stacked layers unstacked) and
    ``from_repro_opt_state`` carry across; a reference run resumes in the
    port from them."""
    from types import SimpleNamespace

    from repro_torch.checkpoint import store

    def read(name):
        final, manifest = store.read_manifest(directory, step, name)
        tree = _tree_from_paths(
            (e["path"], store.load_leaf(final, e).numpy()
             if e["dtype"] != "bfloat16" else store.load_leaf(final, e))
            for e in manifest["leaves"])
        return tree, manifest.get("metadata", {})

    params, meta = read("params")
    opt, _ = read("opt")
    state = SimpleNamespace(mu=opt["mu"], nu=opt["nu"], count=opt["count"])
    return {"params": from_repro_params(params, cfg, device),
            "opt": from_repro_opt_state(state, cfg, device),
            "metadata": meta}
