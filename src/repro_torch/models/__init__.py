"""Model zoo of the port: the dense decoder LM family, the vision
transformers (ViT / DeiT), the state-space family (Mamba2) and the Zamba2
hybrid so far."""

from repro_torch.models.registry import build_model

__all__ = ["build_model"]
