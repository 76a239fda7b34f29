"""Meshes of cards, and the card's hardware constants (one NVIDIA H100 SXM).

The production mesh is 16 x 16 = 256 cards a pod (``("data", "model")``),
or two pods (``("pod", "data", "model")``, 512 cards); the debug mesh is 2
x 4.  They are FUNCTIONS over an initialised default process group
(``torch.distributed.init_process_group``), so importing this module
touches no distributed state.  Each takes the device type (``"cuda"`` by
default; the CPU tests pass ``"cpu"`` over ``gloo``) and raises when the
world size is not the mesh's.

Published peaks from NVIDIA's H100 data sheet (SXM part, dense rates
without sparsity, at the full 700 W power limit; a card set below it runs
slower under load).  ``launch.roofline`` bounds a call by them and
``chip_smoke.py`` states every kernel's bound against them.
"""

from __future__ import annotations

import math


def _make_mesh(shape, axes, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh {axes} needs an initialised default process "
            "group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(
            f"a {shape} mesh {axes} needs a world of {math.prod(shape)} "
            f"ranks, this one has {world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 4, device_type="cuda"):
    """Small mesh for CI-scale sharding tests (8 ranks)."""
    return _make_mesh((n_data, n_model), ("data", "model"), device_type)


PEAK_BF16_FLOPS = 989e12  # bf16 / fp16 tensor cores, FLOP/s
PEAK_INT8_OPS = 1979e12  # int8 tensor cores, OP/s
PEAK_TF32_FLOPS = 495e12  # tf32 tensor cores, FLOP/s
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores, FLOP/s
HBM_BW = 3.35e12  # HBM3, bytes/s
# NVLink 4: 900 GB/s a GPU, both directions together (18 links); each
# direction, the rate a collective's link bytes move at
NVLINK_BW = 450e9
