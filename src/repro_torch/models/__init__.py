"""Model zoo of the port: the dense decoder LM family so far."""

from repro_torch.models.registry import build_model

__all__ = ["build_model"]
