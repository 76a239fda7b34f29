"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``, built with ``nvcc``
for ``sm_90a`` at first use and bound through ``ctypes``), each beside its
plain PyTorch version.  ``chip_smoke.py`` at the repository root holds
every kernel against its plain version on the card."""
