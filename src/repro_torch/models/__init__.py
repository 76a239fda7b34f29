"""Model zoo of the port: the dense decoder LM family, the vision
transformers (ViT / DeiT), the state-space family (Mamba2), the Zamba2
hybrid, the encoder-decoder (Whisper) and the vision-language model
(InternVL2: stub patch embeddings before the text) so far."""

from repro_torch.models.registry import build_model

__all__ = ["build_model"]
