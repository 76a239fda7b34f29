"""Weights carried across: the reference package's parameter tree, as numpy
arrays, becomes the port's tree of tensors.

``from_repro_params`` takes the reference's *unboxed* parameter tree after a
host transfer (nested dicts of numpy arrays; the caller does the
``device_get``), so this module imports nothing of the reference.  Layers
stacked along a leading ``(L, ...)`` axis (the reference's
``scan_layers=True`` form) are unstacked into the port's list of per-layer
dicts; a list stays a list.  A key the port does not know is an error, not
a silent drop.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.nn.module import require_device

_LEAF = None
_DENSE = {"kernel": _LEAF, "bias": _LEAF}
_NORM = {"scale": _LEAF, "bias": _LEAF}
_BLOCK = {
    "ln1": _NORM, "ln2": _NORM, "ln1_post": _NORM, "ln2_post": _NORM,
    "attn": {"q": _DENSE, "k": _DENSE, "v": _DENSE, "o": _DENSE},
    "ffn": {"wi": _DENSE, "wg": _DENSE, "wo": _DENSE},
}
_TOP = {
    "embed": {"table": _LEAF},
    "final_norm": _NORM,
    "lm_head": _DENSE,
    "pos_embed": _LEAF,
    "blocks": _BLOCK,
}


def _convert(node, schema, path: str, device, index=None):
    """numpy tree -> tensor tree under ``schema``; ``index`` selects one
    layer of leaves stacked along a leading axis."""
    if schema is _LEAF:
        if isinstance(node, dict):
            raise KeyError(f"{path}: expected an array, got a dict with "
                           f"keys {sorted(node)}")
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


def from_repro_params(tree: dict, cfg: ArchConfig, device="cuda") -> dict:
    """The reference's parameter tree (numpy) as the port's (tensors on
    ``device``), for a dense-family ``cfg``."""
    device = require_device(device)
    unknown = sorted(set(tree) - set(_TOP))
    if unknown:
        raise KeyError(f"params: unknown top-level key(s) {unknown}; the "
                       f"port knows {sorted(_TOP)}")
    out = {}
    for key, node in tree.items():  # key order is kept: reports walk it
        if key != "blocks":
            out[key] = _convert(node, _TOP[key], key, device)
        elif isinstance(node, dict):  # stacked (L, ...) leaves: unstack
            n = _first_leaf(node).shape[0]
            out[key] = [_convert(node, _BLOCK, f"blocks.{i}", device, i)
                        for i in range(n)]
        else:
            out[key] = [_convert(b, _BLOCK, f"blocks.{i}", device)
                        for i, b in enumerate(node)]
    if "blocks" not in out:
        raise KeyError("params lack 'blocks'")
    if len(out["blocks"]) != cfg.n_layers:
        raise ValueError(
            f"params hold {len(out['blocks'])} layers but {cfg.name} has "
            f"n_layers={cfg.n_layers}")
    need = {"embed", "final_norm", "blocks"} | (
        set() if cfg.tied_embeddings else {"lm_head"})
    missing = sorted(need - set(out))
    if missing:
        raise KeyError(f"params lack {missing} required by {cfg.name}")
    return out
