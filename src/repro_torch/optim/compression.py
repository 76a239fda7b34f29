"""Gradient compression for the slow cross-pod hop, with the paper's own
int8 machinery: int8 quantize + error feedback.

The cross-pod all-reduce is made explicitly over the mesh's ``"pod"``
process group: each pod quantizes its local (already data-reduced)
gradient to int8 against one per-tensor scale, all-reduces the codes as
int32, dequantizes, and keeps the residual as error-feedback state for the
next step — op for op as the reference's ``compressed_psum_pod`` under
``shard_map``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.formats import INT8
from repro_torch.core.quantize import dequantize, div_by_constant, quantize
from repro_torch.tree import leaves, unflatten


def compressed_psum_pod(grads, errors, mesh):
    """All-reduce ``grads`` over the mesh's ``"pod"`` dimension with int8
    error feedback.

    ``grads`` / ``errors``: trees of this rank's local tensors (the pod's
    gradient, replicated over the other mesh dimensions), ``errors`` of the
    same structure (f32).  Returns (reduced_grads, new_errors); every rank
    of a pod group gets the same reduced gradients.
    """
    group = mesh.get_group("pod")
    npods = mesh.size(mesh.mesh_dim_names.index("pod"))

    def one(g, e):
        g32 = g.to(torch.float32) + e
        # Shared scale: codes are summed ACROSS pods, so every pod must
        # quantize against the same alpha (a max), else code sums mix units.
        alpha = torch.clamp_min(torch.amax(torch.abs(g32)), 1e-8)
        alpha = alpha.reshape(1)  # collectives take no 0-d tensor
        dist.all_reduce(alpha, op=dist.ReduceOp.MAX, group=group)
        codes, scale = quantize(g32, alpha[0], INT8)
        summed = codes.to(torch.int32)
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        out = div_by_constant(dequantize(summed, scale), npods)
        new_e = g32 - dequantize(codes, scale)
        return out.to(g.dtype), new_e

    outs = [one(g, e) for g, e in zip(leaves(grads), leaves(errors))]
    return (unflatten(grads, [o[0] for o in outs]),
            unflatten(grads, [o[1] for o in outs]))
