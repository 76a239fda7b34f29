"""DeiT-S/16 [arXiv:2012.12877]: the data-efficient ViT variant the paper
quantizes alongside ViT-B (Table II/III DeiT rows).  Same encoder recipe at
half width (384) with 6 heads."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deit-s16",
    family="vit",
    source="arXiv:2012.12877 (DeiT); quantized in arXiv:2307.03712 §III",
    n_layers=12,
    d_model=384,
    n_heads=6,
    n_kv=6,
    head_dim=64,
    d_ff=1536,
    act="gelu",
    norm="ln",
    qkv_bias=True,
    pos="learned",
    image_size=224,
    patch_size=16,
    n_channels=3,
    n_classes=1000,
    pool="cls",
    skip_shapes=("decode_32k", "long_500k"),
)
