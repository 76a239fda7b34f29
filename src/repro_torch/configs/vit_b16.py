"""ViT-B/16 [arXiv:2010.11929]: the paper's vision-transformer baseline
(Table II/III ViT rows).  224x224 images, 16x16 patches -> 196 tokens + cls,
pre-LN encoder, GELU MLP, learned position embeddings."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="vit-b16",
    family="vit",
    source="arXiv:2010.11929 (ViT); quantized in arXiv:2307.03712 §III",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv=12,  # ViT is MHA: no KV grouping
    head_dim=64,
    d_ff=3072,
    act="gelu",
    norm="ln",
    qkv_bias=True,
    pos="learned",
    image_size=224,
    patch_size=16,
    n_channels=3,
    n_classes=1000,
    pool="cls",
    # encoder-only classifier: decode shapes are inapplicable
    skip_shapes=("decode_32k", "long_500k"),
)
