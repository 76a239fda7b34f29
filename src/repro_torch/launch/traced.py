"""A step traced once through counters: the port's counterpart of the
reference's compiled executable, for the dry run and its roofline.

``trace_step(fn, args, donate)`` runs ``fn(*args)`` once under
``StepCounter``, a ``TorchDispatchMode`` that sees every aten op that runs
on a local tensor (an op on DTensors is handed back to DTensor, which
redistributes its arguments and then runs the op on each rank's own
chunks: those local ops, and the collectives the redistribution issues,
come back through the mode; the fake tensors of DTensor's sharding
propagation are not counted).  It records what one rank does:

- ``flops``: the matmul-class FLOPs of the local ops, from
  ``torch.utils.flop_counter``'s formulas applied to the operands each
  local op multiplies (after DTensor has redistributed them);
- ``bytes accessed``: for each local op, the bytes of its tensor inputs
  plus those of its outputs; a view (an output that aliases an input
  without writing it), an allocation without a write and a collective's
  wait count 0.  This is the eager program's traffic, larger than a fused
  program's;
- the collectives, as records ``(kind, local result bytes, group size)``
  with the reference's kind names (``COLLECTIVE_KINDS``);
- memory, as XLA's memory analysis reads a compiled step:
  ``argument_size_in_bytes`` (the local bytes of the inputs the step
  reads or hands back as outputs: ``jax.jit`` prunes the others),
  ``output_size_in_bytes`` (the outputs'; XLA's also counts its output
  tuple, 8 bytes an output), ``alias_size_in_bytes`` (the outputs held
  in a donated input's buffer: those that reuse its storage, as a step
  that updates its parameters or its decode state in place does, then
  any other output of a read donated input's local shape and dtype, as
  XLA reuses a donated buffer — a step's count or position + 1),
  ``temp_size_in_bytes`` (so
  that argument + output + temp - alias is the peak of the live storage
  bytes during the step, every input's included) and
  ``generated_code_size_in_bytes`` (0).

The same code counts on ``meta`` tensors (nothing is allocated) and on
CUDA tensors, where the storages it tracks are the allocator's blocks.
"""

from __future__ import annotations

import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.dist.sharding import is_dtensor

# c10d_functional op -> the reference's HLO collective kind
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv": "collective-permute",
    "isend": "collective-permute", "irecv": "collective-permute",
    "permute_tensor": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "wait_tensor"}


def _tensors(tree) -> list:
    """The tensors of a tree of dicts, sequences, NamedTuples and nodes
    with ``tree_children`` (a compressed kernel), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if hasattr(tree, "tree_children"):
        tree = list(tree.tree_children())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _group_size(args) -> int:
    """The group size of a ``c10d_functional`` call: its ``group_size``
    argument, or its group's size (the last string argument names it)."""
    ints = [a for a in args[1:] if isinstance(a, int)
            and not isinstance(a, bool)]
    names = [a for a in args if isinstance(a, str)]
    if names:
        from torch.distributed.distributed_c10d import _resolve_process_group

        try:
            return _resolve_process_group(names[-1]).size()
        except (KeyError, ValueError, RuntimeError):
            pass
    return ints[-1] if ints else 1


def local_tensor(t):
    """A DTensor's local chunk; a plain tensor as it is."""
    return t._local_tensor if is_dtensor(t) else t


class StepCounter(TorchDispatchMode):
    """Counts the local ops run while it is active (see the module's
    docstring); ``hold(tensors)`` marks storages live before the step."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: list[tuple[str, int, int]] = []
        self.live = 0
        self.peak = 0
        self.read: set[int] = set()  # tensors some op took as an input
        self._storages: dict[int, int] = {}

    # ---------------------------------------------------------- storages
    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def track(self, t) -> None:
        """Count ``t``'s storage live until it is freed (once)."""
        if isinstance(t, FakeTensor) or t.layout != torch.strided:
            return
        s = t.untyped_storage()
        key = id(s)
        if key in self._storages:
            return
        n = s.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._free, key)

    def hold(self, tensors) -> None:
        for t in tensors:
            self.track(t)

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if any(map(is_dtensor, ins)):
            # DTensor redistributes and runs the local ops: they (and its
            # collectives) come back here on plain tensors
            return NotImplemented
        out = func(*args, **kwargs)
        if not isinstance(func, torch._ops.OpOverload):
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out  # sharding propagation's shapes
        self.read.update(map(id, ins))
        for t in outs:
            self.track(t)
        ns, _, short = func._schema.name.partition("::")
        if ns in _COLLECTIVE_NAMESPACES and short in COLLECTIVE_KINDS:
            n = _group_size(args)
            self.collectives.extend((COLLECTIVE_KINDS[short], _nbytes(t), n)
                                    for t in outs)
        elif not (short.lstrip("_") in _NO_TRAFFIC or _is_view(func)):
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        return out


class _Memory:
    def __init__(self, **kw):
        self.__dict__.update(kw)


class TracedStep:
    """What ``trace_step`` recorded: ``cost_analysis()`` and
    ``memory_analysis()`` read as the reference's compiled executable's
    do, and ``collectives`` are the records ``roofline.collective_bytes``
    prices."""

    def __init__(self, counter: StepCounter, memory: dict):
        self.flops = counter.flops
        self.bytes_accessed = counter.bytes
        self.collectives = list(counter.collectives)
        self.memory = memory

    def cost_analysis(self) -> dict:
        return {"flops": float(self.flops),
                "bytes accessed": float(self.bytes_accessed)}

    def memory_analysis(self):
        return _Memory(**self.memory)


def _aliased(out_leaves, donated, read) -> int:
    """The bytes of the outputs held in donated buffers: those sharing a
    donated input's storage, then (as XLA reuses a donated buffer) any
    other output matched to a read donated input of its local shape and
    dtype, each input taken once."""
    key = lambda t: (tuple(t.shape), t.dtype)
    place = lambda t: (id(t.untyped_storage()), t.storage_offset(),
                       tuple(t.shape))
    free = {place(t): t for t in donated}
    alias, rest = 0, []
    for t in out_leaves:
        if free.pop(place(t), None) is not None:
            alias += _nbytes(t)
        else:
            rest.append(t)
    spare = [key(t) for t in free.values() if id(t) in read]
    for t in rest:
        if key(t) in spare:
            spare.remove(key(t))
            alias += _nbytes(t)
    return alias


def trace_step(fn, args, donate=()) -> TracedStep:
    """``fn(*args)`` run once under a ``StepCounter``; ``donate``: the
    indices of the arguments whose buffers the step may reuse (the
    reference's ``donate_argnums``)."""
    arg_leaves = [local_tensor(t) for t in _tensors(args)]
    donated = [local_tensor(t) for i in donate for t in _tensors(args[i])]
    counter = StepCounter()
    counter.hold(arg_leaves)
    base = counter.live
    counter.peak = base
    with counter:
        out = fn(*args)
    out_leaves = [local_tensor(t) for t in _tensors(out)]
    read = counter.read | set(map(id, out_leaves))  # a pass-through reads
    argument = sum(_nbytes(t) for t in arg_leaves if id(t) in read)
    output = sum(map(_nbytes, out_leaves))
    alias = _aliased(out_leaves, donated, read)
    # every input's storage is live through the step (read or not); the
    # peak is taken over storages, relative to the inputs' own bytes
    peak = counter.peak - base + sum(map(_nbytes, arg_leaves))
    memory = {"argument_size_in_bytes": argument,
              "output_size_in_bytes": output,
              "alias_size_in_bytes": alias,
              "temp_size_in_bytes": peak - argument - output + alias,
              "generated_code_size_in_bytes": 0}
    return TracedStep(counter, memory)
