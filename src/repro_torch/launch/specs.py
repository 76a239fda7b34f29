"""Input specs + layouts for every (arch x shape) cell.

No allocation anywhere: parameters and states are tensors on the ``meta``
device (``Model.init`` / ``init_decode_state`` with ``device="meta"``),
batches are ``meta`` tensors, and layouts are derived from the
logical-axes trees via ``repro_torch.dist.sharding`` rules.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.dist import sharding as shd
from repro_torch.models.encdec import EncDecState
from repro_torch.models.hybrid import HybridState
from repro_torch.models.lm import DecodeState
from repro_torch.nn.attention import KVCache
from repro_torch.nn.ssm import SSMCache


# ---------------------------------------------------------------------------
# Per-shape logical-rule overrides
# ---------------------------------------------------------------------------
def rules_for(cfg: ArchConfig, shape: ShapeSpec,
              strategy: str | None = None) -> dict:
    rules: dict = dict(shd.DEFAULT_RULES)
    rules["conv_dim"] = None
    if strategy == "fsdp":
        # Pure FSDP/ZeRO-3: batch over the WHOLE mesh, weights 1-D sharded
        # over (data, model) on their feature dim, no tensor parallelism
        # and no sequence-parallel resharding.  Activations stay
        # batch-sharded only (the duplicate-axis filter strips data/model
        # from activation feature dims since batch used them).
        rules.update({
            "batch": ("pod", "data", "model"),
            "seq_res": None,
            "kv_seq": None,
            "heads": None,
            "qkv": ("data", "model"),
            "mlp": ("data", "model"),
            "vocab": ("data", "model"),
            "experts": "model",  # MoE keeps expert sharding
            "moe_mlp": None,
            "ssm_inner": None,
            "ssm_heads": None,
        })
    if shape.name == "long_500k":
        # batch=1: nothing to shard there; spread the KV length over the
        # whole mesh instead (flash-decoding).
        rules["batch"] = None
        rules["kv_seq"] = ("pod", "data", "model")
    if cfg.sharding_overrides:
        for k, v in cfg.sharding_overrides.items():
            if ":" in k:  # shape-scoped override, e.g. "train_4k:batch"
                shp, ax = k.split(":", 1)
                if shp == shape.name:
                    rules[ax] = tuple(v) if isinstance(v, (list, tuple)) else v
            else:
                rules[k] = tuple(v) if isinstance(v, (list, tuple)) else v
    return rules


def fit_batch_rule(rules: dict, global_batch: int, mesh) -> dict:
    """Auto-fallback: drop mesh axes the batch dim can't fill evenly.

    A step's arguments must divide exactly, so a 256-row batch cannot map
    onto 512 cards; the production behaviour is to keep the largest prefix
    of the mapped axes that divides evenly (the remaining axes replicate the
    batch — pure compute overprovisioning, never an error)."""
    phys = rules.get("batch")
    if phys is None:
        return rules
    axes = (phys,) if isinstance(phys, str) else tuple(phys)
    sizes = shd.mesh_axis_sizes(mesh)
    kept, _ = shd.fit_axes(axes, global_batch, sizes)
    out = dict(rules)
    out["batch"] = tuple(kept) if kept else None
    return out


# ---------------------------------------------------------------------------
# Batch specs
# ---------------------------------------------------------------------------
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeSpec):
    """(meta tensor tree, axes tree) for the training/prefill batch dict."""
    B, S = shape.global_batch, shape.seq_len
    i32, dt = torch.int32, getattr(torch, cfg.dtype)
    sds, axes = {}, {}
    if cfg.family == "vit":
        # classification batches: the encoder length is fixed by the image
        # grid (cfg.vit_seq_len); the shape grid contributes the batch size.
        sds["images"] = _meta(
            (B, cfg.image_size, cfg.image_size, cfg.n_channels), dt)
        axes["images"] = ("batch", None, None, None)
        if shape.kind == "train":
            sds["labels"] = _meta((B,), i32)
            axes["labels"] = ("batch",)
        return sds, axes
    tok_len = S
    if cfg.family == "vlm":
        tok_len = S - cfg.vision_patches
        sds["patch_embeds"] = _meta((B, cfg.vision_patches, cfg.d_model), dt)
        axes["patch_embeds"] = ("batch", None, "embed")
    if cfg.family == "encdec":
        sds["frames"] = _meta((B, S, cfg.d_model), dt)
        axes["frames"] = ("batch", None, "embed")
    sds["tokens"] = _meta((B, tok_len), i32)
    axes["tokens"] = ("batch", None)
    if shape.kind == "train":
        sds["labels"] = _meta((B, tok_len), i32)
        axes["labels"] = ("batch", None)
    return sds, axes


def token_spec(cfg: ArchConfig, batch: int):
    return _meta((batch, 1), torch.int32), ("batch", None)


# ---------------------------------------------------------------------------
# Decode-state axes (mirrors each family's state; the port keeps one cache
# per layer in a list, so no "layers" axis leads a cache's axes)
# ---------------------------------------------------------------------------
_KV = ("batch", "kv_seq", "qkv")


def _kv_axes(quant: bool = False) -> KVCache:
    if quant:
        scale = ("batch", "kv_seq", None)
        return KVCache(k=_KV, v=_KV, length=(), k_scale=scale, v_scale=scale)
    return KVCache(k=_KV, v=_KV, length=())


def _ssm_axes() -> SSMCache:
    return SSMCache(conv=("batch", None, "ssm_inner"),
                    state=("batch", "ssm_heads", None, None))


def decode_state_axes(cfg: ArchConfig, state) -> Any:
    """Axes tree matching ``init_decode_state``'s structure."""
    if isinstance(state, HybridState):
        return HybridState(
            kv=[_kv_axes() for _ in state.kv],
            ssm=[[_ssm_axes() for _ in group] for group in state.ssm],
            x0=("batch", None, "embed"),
            position=(),
        )
    if isinstance(state, EncDecState):
        return EncDecState(
            kv=[_kv_axes() for _ in state.kv],
            cross_k=("layers",) + _KV,
            cross_v=("layers",) + _KV,
            enc_pos=("batch", "kv_seq"),
            position=(),
        )
    assert isinstance(state, DecodeState)
    kv = ssm = None
    if state.kv is not None:
        kv = [_kv_axes(quant=c.k_scale is not None) for c in state.kv]
    if state.ssm is not None:
        ssm = [_ssm_axes() for _ in state.ssm]
    return DecodeState(kv=kv, ssm=ssm, position=())


def eval_decode_state(model, cfg: ArchConfig, shape: ShapeSpec,
                      kv_quant: bool = False, device="meta"):
    """The decode state, as tensors on the ``meta`` device by default (no
    allocation)."""
    B, S = shape.global_batch, shape.seq_len
    kw = {}
    if cfg.family == "encdec":
        kw["enc_len"] = S
    if kv_quant:
        kw["kv_quant"] = True
    return model.inner.init_decode_state(B, S, device=device, **kw)


# ---------------------------------------------------------------------------
# Layout assembly
# ---------------------------------------------------------------------------
def shardings_from_axes(axes_tree, mesh, rules, sds_tree=None):
    """Axes tree -> ``NamedSharding`` tree.

    With ``sds_tree`` (matching tensors, ``meta`` ones included), each
    leaf's spec is size-fitted: mesh axes a dim can't divide evenly are
    skipped, falling back toward replication (``spec_for(fit_shape=...)``):
    a layout never leans on DTensor's padding of uneven shards, and
    feature dims don't always fill the mesh — e.g. DeiT's 384-wide qkv
    bias on a 256-way (data, model) FSDP sharding.
    """
    def one(axes, sds=None):
        if axes is None:
            return shd.NamedSharding(mesh, shd.spec_for((), rules=rules,
                                                        mesh=mesh))
        return shd.NamedSharding(mesh, shd.spec_for(
            axes, rules=rules, mesh=mesh,
            fit_shape=None if sds is None else tuple(sds.shape)))

    if sds_tree is None:
        return shd.map_axes(one, axes_tree)
    return shd.map_axes(one, axes_tree, sds_tree)


def distribute(tree, shardings):
    """Each tensor of ``tree`` (the whole value, the same on every rank)
    as a DTensor laid out by the matching ``NamedSharding``: each rank keeps
    its own chunk, with no communication.  Nodes with ``tree_children`` /
    ``tree_rebuild`` (a compressed kernel) are walked into."""
    if hasattr(tree, "tree_children"):
        return tree.tree_rebuild([
            distribute(t, s) for t, s in zip(tree.tree_children(),
                                             shardings.tree_children())])
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(distribute(t, s)
                            for t, s in zip(tree, shardings)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute(t, s) for t, s in zip(tree, shardings))
    if tree is None:
        return None
    return shardings.distribute(tree)
