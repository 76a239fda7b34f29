"""Elastic restore planning: lay a checkpoint out onto *any* mesh.

A checkpoint saved unsharded (or on another mesh) restores onto the current
mesh with layouts computed from the logical-axes tree + rule table.  The
plan never relies on DTensor's padding of uneven shards: a dim that can't
fill its assigned mesh axes keeps the greedy subset that divides evenly
(``sharding.fit_axes`` — the policy ``launch.specs.fit_batch_rule`` applies
to batches) and replicates the rest — recorded per dim in
``RestoreReport.fallbacks`` so the launcher can log exactly what degraded
(e.g. ``d_ff=130`` on a 4-way ``model`` axis) instead of failing.

``restore_specs`` is the pure planner (any object exposing axis names and a
shape, test fakes included); ``shardings_for_restore`` wraps the plan into
``NamedSharding`` leaves (mesh + spec, hence DTensor placements) for
``checkpoint.store.restore_pytree``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

from repro_torch.dist import sharding as shd


@dataclasses.dataclass(frozen=True)
class Fallback:
    """One dim that (partially) lost sharding, or a whole-leaf rank bailout."""

    path: str
    dim: int  # -1 for a rank-mismatch bailout of the whole leaf
    logical: Any  # logical axis name (or axes tuple for dim == -1)
    size: int  # dim size (or leaf rank for dim == -1)
    ways: int  # shard count the dim could not divide into
    kept: int = 1  # shard count actually retained (largest dividing prefix)


@dataclasses.dataclass
class RestoreReport:
    n_params: int = 0  # leaves planned
    n_sharded: int = 0  # leaves with at least one sharded dim
    fallbacks: list = dataclasses.field(default_factory=list)

    def summary(self) -> str:
        return (
            f"restore plan: {self.n_params} params, {self.n_sharded} sharded, "
            f"{len(self.fallbacks)} replication fallbacks"
        )


def _entry_ways(entry, sizes: Mapping) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(sizes.get(a, 1) for a in names)


def _key_paths(axes_tree) -> list:
    """The JAX key strings (``['blocks'][0]['ffn']['wi']['kernel']``) of
    an axes tree's leaves, in JAX's leaf order (dict keys sorted)."""
    out = []

    def walk(node, path):
        if shd.is_axes_leaf(node):
            out.append("".join(path))
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + [f"[{k!r}]"])
        elif hasattr(node, "tree_children"):  # a compressed kernel, a bank
            for i, c in enumerate(node.tree_children()):
                walk(c, path + [f"[<flat index {i}>]"])
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for f in node._fields:
                walk(getattr(node, f), path + [f".{f}"])
        else:
            for i, c in enumerate(node):
                walk(c, path + [f"[{i}]"])

    walk(axes_tree, [])
    return out


def restore_specs(paxes, shape_structs, mesh, rules: Mapping):
    """Pure planning: (PartitionSpec tree, RestoreReport).

    ``paxes``: logical-axes tree (``Model.param_axes()``);
    ``shape_structs``: matching tree of tensors (``meta`` ones allocate
    nothing) or of anything with a ``shape``.
    A ``None`` axes leaf means intentional full replication (unannotated
    leaf) — not a fallback, matching ``launch.specs.shardings_from_axes``.
    Fallback paths are JAX's key strings (``['blocks'][0]['ffn']...``), in
    JAX's leaf order.
    """
    sizes = shd.mesh_axis_sizes(mesh)
    report = RestoreReport()
    paths = iter(_key_paths(paxes))

    def one(axes, sds):
        report.n_params += 1
        pstr = next(paths)
        shape = tuple(sds.shape)
        if axes is None:
            return shd.P()
        axes = tuple(axes)
        if len(axes) != len(shape):
            report.fallbacks.append(
                Fallback(pstr, -1, axes, len(shape), 0))
            return shd.P()
        # Two resolutions: the unfitted spec is the launch-time intent; the
        # fitted one skips (without consuming) mesh axes a dim can't divide,
        # so an axis a small dim strands is still claimable by a later dim.
        intended = list(shd.spec_for(axes, rules=rules, mesh=mesh))
        fitted = list(shd.spec_for(axes, rules=rules, mesh=mesh,
                                   fit_shape=shape))
        for d, n in enumerate(shape):
            ways = _entry_ways(intended[d], sizes)
            kept = _entry_ways(fitted[d], sizes)
            if kept < ways:
                report.fallbacks.append(
                    Fallback(pstr, d, axes[d], n, ways, kept))
        if any(e is not None for e in fitted):
            report.n_sharded += 1
        return shd.P(*fitted)

    specs = shd.map_axes(one, paxes, shape_structs)
    return specs, report


def shardings_for_restore(paxes, shape_structs, mesh, rules: Mapping):
    """(NamedSharding tree, RestoreReport) for ``store.restore_pytree``."""
    specs, report = restore_specs(paxes, shape_structs, mesh, rules)
    shardings = shd.map_axes(lambda _, spec: shd.NamedSharding(mesh, spec),
                             paxes, specs)
    return shardings, report
