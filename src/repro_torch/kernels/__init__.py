"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``, built with ``nvcc``
for ``sm_90a`` at first use and bound through ``ctypes``), each beside its
plain PyTorch version.  ``chip_smoke.py`` at the repository root holds
every kernel against its plain version on the card.

No kernel has a backward: ``refuse_grad`` makes each wrapper raise when it
would be differentiated, on the CPU (where it runs its plain version) as on
the card (where its output, written through ``ctypes``, would carry no
gradient), as the reference's Pallas kernels raise under ``jax.grad``."""

import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise if grad mode is on and an input of kernel ``name`` requires
    grad."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise ValueError(
            f"{name}: the kernel has no backward, and an input requires "
            "grad; train through a non-fused policy (QAT differentiates the "
            "plain QDQ through its straight-through estimator) and call the "
            "kernels under torch.no_grad()")
