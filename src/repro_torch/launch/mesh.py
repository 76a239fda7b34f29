"""The card's hardware constants: one NVIDIA H100 SXM.

Published peaks from NVIDIA's H100 data sheet (SXM part, dense rates
without sparsity, at the full 700 W power limit; a card set below it runs
slower under load).  ``launch.roofline`` bounds a call by them and
``chip_smoke.py`` states every kernel's bound against them.  The meshes of
several cards come with the distributed slice of the port.
"""

PEAK_BF16_FLOPS = 989e12  # bf16 / fp16 tensor cores, FLOP/s
PEAK_INT8_OPS = 1979e12  # int8 tensor cores, OP/s
PEAK_TF32_FLOPS = 495e12  # tf32 tensor cores, FLOP/s
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores, FLOP/s
HBM_BW = 3.35e12  # HBM3, bytes/s
# NVLink 4: 900 GB/s a GPU, both directions together (18 links); each
# direction, the rate a collective's link bytes move at
NVLINK_BW = 450e9
