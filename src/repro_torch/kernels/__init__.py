"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``, built with ``nvcc``
for ``sm_90a`` at first use and bound through ``ctypes``), each beside its
plain PyTorch version.  ``chip_smoke.py`` at the repository root holds
every kernel against its plain version on the card.

No kernel has a backward: ``refuse_inputs`` makes each wrapper raise when it
would be differentiated, on the CPU (where it runs its plain version) as on
the card (where its output, written through ``ctypes``, would carry no
gradient), as the reference's Pallas kernels raise under ``jax.grad``.  Nor
does a kernel take a DTensor (a tensor laid out over a mesh by
``dist.sharding``): the wrapper raises ``TypeError`` rather than run its
plain version or a kernel on one rank's chunk."""

import torch

from repro_torch.dist.sharding import is_dtensor


def refuse_inputs(name: str, *tensors) -> None:
    """Raise ``TypeError`` if an input of kernel ``name`` is a DTensor, and
    ``ValueError`` if grad mode is on and an input requires grad."""
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(
            f"{name}: an input is a DTensor; the kernel takes whole tensors "
            "on one device (call full_tensor() first, or run the sharded "
            "step through a non-fused policy)")
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise ValueError(
            f"{name}: the kernel has no backward, and an input requires "
            "grad; train through a non-fused policy (QAT differentiates the "
            "plain QDQ through its straight-through estimator) and call the "
            "kernels under torch.no_grad()")
