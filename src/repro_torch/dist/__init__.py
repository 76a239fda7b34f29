"""Distributed-execution layer: logical-axis sharding rules + elastic restore.

``repro_torch.dist.sharding`` maps *logical* axis names (``batch``,
``embed``, ``mlp``, ...) to the axes of a ``torch.distributed`` DeviceMesh
via a rule table; the models name every parameter and activation axis
logically, so one rule table swap re-targets the whole stack (TP, FSDP,
sequence-parallel, multi-pod).  ``repro_torch.dist.elastic`` plans
checkpoint-restore layouts onto an arbitrary mesh, replicating dims that
don't divide evenly.
"""

from repro_torch.dist import elastic, sharding

__all__ = ["elastic", "sharding"]
