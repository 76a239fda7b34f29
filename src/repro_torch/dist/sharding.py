"""Logical-axis sharding rules over a ``DeviceMesh``.

Every parameter of ``repro_torch.nn`` / ``repro_torch.models`` has a tree of
*logical* axis names beside it (``Model.param_axes()``), and the forward
passes mark their activations with logical names (``constrain``); this
module owns the table that maps those names onto the mesh's axes:

- ``spec_for(axes, rules=..., mesh=...)`` resolves a logical-axes tuple into
  a ``PartitionSpec``, dropping mesh axes the mesh does not have (single-pod
  meshes have no ``"pod"``) and using each mesh axis at most once per spec
  (the first dim wins);
- ``placements(spec, mesh)`` turns a spec into DTensor placements, one per
  mesh dimension (``Shard(d)`` or ``Replicate()``);
- ``constrain(x, axes)`` is the in-model sharding hint.  Outside a
  ``use_rules`` context it returns ``x`` itself and does nothing else, so
  single-device runs never touch ``torch.distributed``.

Rule values are ``None`` (replicate), a mesh-axis name, or a tuple of
mesh-axis names (the dim is sharded over their product, major to minor).
A dim sharded over several mesh axes is sharded by DTensor in mesh-dimension
order, so such a tuple must list its axes in the mesh's order.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
from typing import Any, Mapping, Sequence

# ---------------------------------------------------------------------------
# Default rule table (Megatron-style TP + sequence parallelism)
# ---------------------------------------------------------------------------
DEFAULT_RULES: dict = {
    # data axes: batch over (pod, data); residual-stream sequence dim over
    # 'model' (sequence parallelism — norms/residual adds are sharded, the
    # TP all-reduce becomes reduce-scatter + all-gather pairs).
    "batch": ("pod", "data"),
    "seq": None,
    "seq_res": "model",
    "kv_seq": None,
    # replicated structural axes
    "layers": None,
    "embed": None,
    "head_dim": None,
    "conv_dim": None,
    "mamba_groups": None,
    "lora": None,
    # tensor-parallel feature axes
    "heads": "model",
    "kv_heads": "model",
    "qkv": "model",
    "mlp": "model",
    "vocab": "model",
    "ssm_inner": "model",
    "ssm_heads": "model",
    # MoE: experts over 'model', expert-hidden over 'data' (2-D expert
    # sharding; fits Llama4-Scout-scale expert tables)
    "experts": "model",
    "moe_mlp": "data",
}


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh-axis name, or
    a tuple of mesh-axis names.  ``P(("data",),)`` and ``P("data")`` are
    distinct specs, as in the reference."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + (tuple.__repr__(self) if len(self) != 1
                      else f"({self[0]!r})")


P = PartitionSpec


# ---------------------------------------------------------------------------
# Active (mesh, rules) context — arms `constrain`
# ---------------------------------------------------------------------------
class _Context(threading.local):
    def __init__(self):
        self.stack: list[tuple[Any, Mapping]] = []


_CTX = _Context()


def active() -> tuple[Any, Mapping] | None:
    """The innermost (mesh, rules) armed by ``use_rules``, or None."""
    return _CTX.stack[-1] if _CTX.stack else None


@contextlib.contextmanager
def use_rules(mesh, rules: Mapping):
    """Arm ``constrain`` with a mesh + rule table for the enclosed calls.

    Inside, an op that meets a DTensor and a plain tensor takes the plain
    one as replicated (DTensor's ``implicit_replication``): a plain tensor
    in the model is a value every rank formed whole and the same
    (positions, masks, a decode step's position), which the reference's
    GSPMD replicates."""
    from torch.distributed.tensor.experimental import implicit_replication

    outer = not _CTX.stack
    _CTX.stack.append((mesh, dict(rules)))
    try:
        with implicit_replication() if outer else contextlib.nullcontext():
            yield
    finally:
        _CTX.stack.pop()


# ---------------------------------------------------------------------------
# Spec resolution
# ---------------------------------------------------------------------------
def is_axes_leaf(x) -> bool:
    """A logical-axes leaf: None or a flat tuple of names/None.

    State NamedTuples (KVCache etc.) are tuples too — they are containers,
    not axes.  Shared by ``launch.specs`` and ``dist.elastic`` so the leaf
    convention has exactly one definition.
    """
    return x is None or (
        type(x) is tuple
        and all(e is None or isinstance(e, str) for e in x)
    )


def map_axes(fn, axes_tree, *rest):
    """``fn(axes_leaf, *other_leaves)`` over an axes tree (dicts, lists,
    NamedTuples, nodes with ``tree_children`` / ``tree_rebuild`` such as a
    compressed kernel; ``is_axes_leaf`` leaves) and trees of its
    structure, leaves visited in JAX's order (dict keys sorted); the
    result has the axes tree's structure."""
    if is_axes_leaf(axes_tree):
        return fn(axes_tree, *rest)
    if hasattr(axes_tree, "tree_children"):
        kids = zip(axes_tree.tree_children(),
                   *(r.tree_children() for r in rest))
        return axes_tree.tree_rebuild([map_axes(fn, *xs) for xs in kids])
    if isinstance(axes_tree, dict):
        out = {k: map_axes(fn, axes_tree[k], *(r[k] for r in rest))
               for k in sorted(axes_tree)}
        return {k: out[k] for k in axes_tree}
    if isinstance(axes_tree, tuple) and hasattr(axes_tree, "_fields"):
        return type(axes_tree)(*(map_axes(fn, *xs)
                                 for xs in zip(axes_tree, *rest)))
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(map_axes(fn, *xs)
                               for xs in zip(axes_tree, *rest))
    raise TypeError(f"map_axes: not an axes tree node: {axes_tree!r}")


def mesh_axis_names(mesh) -> tuple | None:
    """The axis names of a ``DeviceMesh`` (``mesh_dim_names``) or of any
    object with ``axis_names``."""
    if mesh is None:
        return None
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    return tuple(names)


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or of an object with
    ``axis_names`` and ``devices.shape``."""
    devices = getattr(mesh, "devices", None)
    shape = devices.shape if devices is not None else tuple(mesh.shape)
    return dict(zip(mesh_axis_names(mesh), shape))


def fit_axes(names: Sequence[str], n: int, sizes: Mapping[str, int]):
    """Greedy subset of mesh ``names`` that ``n`` divides evenly.

    Arguments of a step must divide their mesh axes exactly; axes the dim
    can't fill are skipped (later axes are still considered), matching
    ``launch.specs.fit_batch_rule``.  Axes absent from ``sizes`` are skipped
    too.  Returns (kept_names, kept_product).
    """
    kept, prod = [], 1
    for a in names:
        if a not in sizes:
            continue
        if n % (prod * sizes[a]) == 0:
            kept.append(a)
            prod *= sizes[a]
    return kept, prod


def spec_for(axes: Sequence[str | None] | None, *, rules: Mapping | None = None,
             mesh=None, fit_shape: Sequence[int] | None = None
             ) -> PartitionSpec:
    """Resolve logical ``axes`` to a ``PartitionSpec``.

    - a ``None`` logical name resolves to a replicated dim;
    - rule values may be a string (kept as a bare spec entry) or a tuple
      (kept as a tuple entry, even when filtering leaves one element —
      ``P(("data",),)`` and ``P("data")`` are distinct specs);
    - physical axes absent from the mesh's axis names are silently dropped
      (the same rule table serves single-pod and multi-pod meshes);
    - each physical axis is used at most once per spec: a later dim that
      maps to an already-used axis loses it (replicated instead);
    - with ``fit_shape`` (the tensor's dims), a mesh axis the dim can't
      divide evenly is skipped *without being consumed*, so a later dim
      mapped to the same axis can still claim it (see
      ``elastic.restore_specs``).
    """
    ctx = active()
    if rules is None:
        rules = ctx[1] if ctx is not None else DEFAULT_RULES
    if mesh is None and ctx is not None:
        mesh = ctx[0]
    mesh_axes = mesh_axis_names(mesh)

    if axes is None:
        axes = ()
    sizes: Mapping[str, int] = {}
    if fit_shape is not None:
        if len(fit_shape) != len(axes):
            raise ValueError(
                f"spec_for: fit_shape {tuple(fit_shape)} rank != axes {axes}")
        if mesh is not None:
            sizes = mesh_axis_sizes(mesh)
    entries: list = []
    used: set[str] = set()
    for d, name in enumerate(axes):
        rule = rules.get(name) if name is not None else None
        if rule is None:
            entries.append(None)
            continue
        as_tuple = not isinstance(rule, str)
        phys = tuple(rule) if as_tuple else (rule,)
        kept, prod = [], 1
        for a in phys:
            if mesh_axes is not None and a not in mesh_axes:
                continue
            if a in used:
                continue
            if fit_shape is not None:
                size = sizes.get(a, 1)
                if fit_shape[d] % (prod * size) != 0:
                    continue
                prod *= size
            kept.append(a)
            used.add(a)
        if not kept:
            entries.append(None)
        elif as_tuple:
            entries.append(tuple(kept))
        else:
            entries.append(kept[0])
    return PartitionSpec(*entries)


def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dimension,
    ``Shard(d)`` where tensor dim ``d`` names that mesh axis, else
    ``Replicate()``.  A dim over several mesh axes is split by DTensor in
    mesh-dimension order (major to minor); a tuple entry whose axes are
    not in the mesh's order raises, since no plain ``Shard`` layout is that
    split."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(
                f"placements: dim {d} is sharded over {group}, not in the "
                f"mesh's axis order {names}; DTensor shards a dim over "
                "several mesh axes in mesh order only")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def _lay_out(x, mesh, spec):
    from torch.distributed.tensor import DTensor, distribute_tensor

    want = placements(spec, mesh)
    if isinstance(x, DTensor):
        if tuple(x.placements) == want:
            return x
        return x.redistribute(mesh, want)
    # a plain tensor inside the mesh is a whole value every rank made the
    # same (positions, masks): each rank keeps its own chunk, no traffic
    return distribute_tensor(x, mesh, want, src_data_rank=None)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout: the mesh and its ``PartitionSpec``; ``placements``
    are the DTensor placements, one per mesh dimension."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def distribute(self, t):
        """``t`` (the whole value, on every rank) as a DTensor of this
        layout: each rank keeps its own chunk, with no communication."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(t, self.mesh, self.placements,
                                 src_data_rank=None)


# ---------------------------------------------------------------------------
# In-model sharding hint
# ---------------------------------------------------------------------------
def constrain(x, axes: Sequence[str | None]):
    """Lay ``x`` out as the logical ``axes`` say on the active mesh.

    Outside a ``use_rules`` context this returns ``x`` itself.  Inside, the
    spec is fitted to ``x``'s shape (a mesh axis a dim cannot divide evenly
    is skipped: two KV heads on a 4-way "model" axis stay whole), a
    DTensor is redistributed to the spec's placements (an all-gather where
    a sharded op cannot go on: the reference's GSPMD inserts the same), and
    a plain tensor — a value every rank formed whole — becomes a DTensor
    of that layout, each rank keeping its chunk.
    """
    if not _CTX.stack:
        return x
    mesh, rules = _CTX.stack[-1]
    axes = tuple(axes)
    if len(axes) != x.ndim:
        raise ValueError(
            f"constrain: rank mismatch — axes {axes} vs array rank {x.ndim} "
            f"(shape {tuple(x.shape)})"
        )
    return _lay_out(x, mesh, spec_for(axes, rules=rules, mesh=mesh,
                                      fit_shape=tuple(x.shape)))


def whole_along(x, dims):
    """``x`` whole along each of ``dims`` on every rank: a DTensor sharded
    along one is all-gathered along it, as GSPMD gathers where a sharded
    op cannot go on (a QDQ group spanning shards of its axis; the rows a
    projection flattens from a sequence-sharded residual stream);
    anything else is returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dims = {d % x.ndim for d in dims}
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim in dims else p
                 for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def settled(x):
    """``x`` with its pending reductions carried out: a DTensor's
    ``Partial`` placements (a mean or sum over a sharded dim) all-reduced
    to ``Replicate``, as GSPMD's psum; anything else as it is (DTensor
    cannot turn a pending mean into a pending sum where the two meet)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    want = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def unflatten(x, dim: int, sizes):
    """``x.unflatten(dim, sizes)``.  A DTensor sharded along ``dim`` into
    more chunks than ``sizes[0]`` splits into evenly (two KV heads over a
    4-way "model" axis; the heads of a 16-way one) is all-gathered along
    ``dim`` first, as GSPMD reshards such a reshape; DTensor refuses it."""
    if is_dtensor(x):
        x = _splittable(x, dim, sizes)
    return x.unflatten(dim, sizes)


def whole_grad_along(y, dims):
    """``y`` itself; under a mesh its gradient is made whole along each of
    ``dims`` before it flows back (``whole_along``'s gather, for the
    backward of a projection whose rows were gathered going forward: a
    gradient sharded along the sequence would meet the unflatten of those
    rows, which DTensor refuses)."""
    if is_dtensor(y) and y.requires_grad:
        y.register_hook(lambda g: whole_along(g, dims))
    return y


def merge_last(x):
    """``x.flatten(-2)``: the last two dims into one ((heads, head_dim);
    a QDQ's (groups, n)).  A gradient that comes back sharded along the
    merged dim into more chunks than the leading size splits into evenly
    (an FSDP weight sharded 256 ways) is made whole along it before the
    unflatten DTensor refuses, as GSPMD reshards it."""
    y = x.flatten(-2)
    if is_dtensor(y) and y.requires_grad:
        sizes = tuple(x.shape[-2:])
        y.register_hook(lambda g: _splittable(g, -1, sizes))
    return y


def _splittable(x, dim: int, sizes):
    """``x``, gathered along ``dim`` where its shards there do not split
    ``sizes[0]`` evenly."""
    from torch.distributed.tensor import Shard

    d = dim % x.ndim
    ways = 1
    for p, n in zip(x.placements, x.device_mesh.shape):
        if isinstance(p, Shard) and p.dim == d:
            ways *= n
    return whole_along(x, (d,)) if sizes[0] % ways else x


def _chunk_like(t, dest, dims):
    """``t``'s own chunk on this rank, laid out as ``dest`` where ``t``'s
    dim ``i`` is ``dest``'s dim ``dims[i]`` at the same size (``None``, or
    another size: whole there)."""
    if not hasattr(t, "ndim"):
        return t
    from torch.distributed.tensor import Replicate, Shard

    mesh = dest.device_mesh
    place = []
    for p in dest.placements:
        i = dims.index(p.dim) if isinstance(p, Shard) and p.dim in dims \
            else None
        ok = i is not None and i < t.ndim and t.shape[i] == dest.shape[p.dim]
        place.append(Shard(i) if ok else Replicate())
    if is_dtensor(t):
        if tuple(t.placements) != tuple(place):
            t = t.redistribute(mesh, place)
        return t.to_local()
    if all(isinstance(p, Replicate) for p in place):
        return t
    return _lay_out(t, mesh, _spec_of(place, t.ndim, mesh)).to_local()


def _seq_chunk(dest) -> tuple[int, int]:
    """(first position, number of positions) of this rank's chunk of a
    ring ``dest`` along its position dim 1."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(
        dest.shape, dest.device_mesh, dest.placements)
    return offset[1], shape[1]


def put_rows(dest, slot, value):
    """``dest[b, slot[b]] = value[b]`` for every row ``b``, in place: a
    ring write of one position a row (``slot``: (B,) or one position for
    every row; ``value``: ``dest`` without its position dim 1).  Where
    ``dest`` is a DTensor, each rank writes its own rows into its own
    chunk, and a ring split along its positions (``long_500k``'s
    ``kv_seq``) is written only by the rank that holds the position."""
    import torch

    slot = slot.long().reshape(-1)  # a tensor index, never one .item()
    if not is_dtensor(dest):
        dest[torch.arange(dest.shape[0], device=dest.device), slot] = value
        return
    local = dest.to_local()
    value = _chunk_like(value, dest, (0,) + tuple(range(2, dest.ndim)))
    s = _chunk_like(slot, dest, (0,))
    first, n = _seq_chunk(dest)
    rows = torch.arange(local.shape[0], device=local.device)
    s = s - first
    if n != dest.shape[1]:
        held = (s >= 0) & (s < n)
        s = s.clamp(0, n - 1)
        value = torch.where(held.reshape(-1, *[1] * (value.ndim - 1)),
                            value, local[rows, s])
    local[rows, s] = value


def put_seq(dest, idx, value):
    """``dest[:, idx] = value``, in place: the same positions ``idx`` of
    every row (a prefill's entries into a ring; ``value``: (B, len(idx),
    ...)).  Where ``dest`` is a DTensor each rank writes its own chunk; a
    ring split along its positions is not written so (no step does)."""
    if not is_dtensor(dest):
        dest[:, idx] = value
        return
    first, n = _seq_chunk(dest)
    if n != dest.shape[1]:
        raise NotImplementedError(
            "put_seq: a ring split along its positions takes one position "
            "a row (put_rows)")
    local = dest.to_local()
    local[:, idx] = _chunk_like(value, dest, (0, None)
                                + tuple(range(2, dest.ndim)))


def take_rows(table, ids):
    """``table[ids]``: rows of a table (embeddings, positions) at integer
    ``ids``.  Where ``ids`` is a DTensor, each rank gathers its own ids'
    rows from its whole copy of the table, the result laid out as the ids
    are, and the table's gradient is the ranks' sum (``Partial``): the
    reference's GSPMD gather, without DTensor's rule for ``aten.index``
    (whose backward fails on batch-sharded ids in torch 2.11)."""
    if not is_dtensor(ids):
        return table[ids.long()]
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = ids.device_mesh
    if is_dtensor(table):
        whole = [Replicate()] * mesh.ndim
        if tuple(table.placements) != tuple(whole):
            table = table.redistribute(mesh, whole)
        table = table.to_local(grad_placements=[
            Partial() if p.is_shard() else Replicate()
            for p in ids.placements])
    rows = table[ids.to_local().long()]
    return DTensor.from_local(rows, mesh, ids.placements, run_check=False)


def per_shard(fn, *args, **kw):
    """``fn(*args, **kw)`` on each rank's own chunks when an argument is a
    DTensor, its output (or each of a tuple's) a DTensor laid out as the
    first such argument, its leading dims being the first's (the
    reference's GSPMD partitions attention so: every sharded dim is one
    whose entries do not meet — batch rows, heads); ``fn(*args, **kw)``
    itself otherwise.  A dim of the first DTensor stays sharded where every
    tensor argument that has it has it at the same size (or at size 1, a
    broadcast): the others are chunked alike, a plain tensor (positions, a
    mask) by each rank from its whole copy.  A dim on which the arguments
    differ (eight query heads beside two KV heads) is gathered whole in
    all of them.  The chunks carry gradients both ways."""
    first = next((a for a in args if is_dtensor(a)), None)
    if first is None:
        return fn(*args, **kw)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = first.device_mesh
    tensors = [a for a in args if hasattr(a, "ndim")]

    def agree(d):
        return all(a.ndim <= d or a.shape[d] in (first.shape[d], 1)
                   for a in tensors)

    want = tuple(p if isinstance(p, Shard) and agree(p.dim) else Replicate()
                 for p in first.placements)

    def chunk(a):
        if not hasattr(a, "ndim"):
            return a
        mine = tuple(p if isinstance(p, Shard) and p.dim < a.ndim
                     and a.shape[p.dim] == first.shape[p.dim] > 1
                     else Replicate() for p in want)
        if is_dtensor(a):
            if tuple(a.placements) != mine:
                a = a.redistribute(mesh, mine)
            return a.to_local()
        if all(isinstance(p, Replicate) for p in mine):
            return a
        return _lay_out(a, mesh, _spec_of(mine, a.ndim, mesh)).to_local()

    out = fn(*map(chunk, args), **kw)
    wrap = lambda o: DTensor.from_local(o, mesh, want, run_check=False)
    return type(out)(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def _spec_of(place, ndim: int, mesh) -> PartitionSpec:
    """The ``PartitionSpec`` of DTensor placements ``place`` on ``mesh``
    for a tensor of ``ndim`` dims (mesh axes in mesh order)."""
    entries: list = [[] for _ in range(ndim)]
    for name, p in zip(mesh_axis_names(mesh), place):
        if p.is_shard():
            entries[p.dim].append(name)
    return PartitionSpec(*(None if not e else e[0] if len(e) == 1
                           else tuple(e) for e in entries))


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor, without importing ``torch.distributed``
    when nothing has (a single-device run never has)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)
