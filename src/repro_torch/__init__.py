"""repro_torch: the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

Same sub-package layout and names as the JAX package (``core/ kernels/ nn/
models/ serve/ configs/ launch/``); plain tensor code is PyTorch and every
kernel the JAX package wrote in Pallas is a hand-written CUDA kernel under
``kernels/csrc``.  The package imports ``torch`` and numpy only — never
``jax`` and nothing of ``repro``.

Entry points (``build_model``, ``model.init``, the engines, the launcher)
take ``device=`` and default to ``"cuda"``; without a card that default
raises — nothing here degrades to the CPU on its own.  The CPU is used only
when the caller passes ``device="cpu"`` (the tests do), and then the kernel
wrappers run their plain PyTorch versions.
"""

from repro_torch.version import __version__

__all__ = ["__version__"]
