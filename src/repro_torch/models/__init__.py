"""Model zoo of the port: the dense decoder LM family and the vision
transformers (ViT / DeiT) so far."""

from repro_torch.models.registry import build_model

__all__ = ["build_model"]
