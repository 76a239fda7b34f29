"""InternVL2-2B [arXiv:2404.16821]: InternLM2-1.8B language backbone +
InternViT frontend (STUB: input_specs() provides patch embeddings)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    source="arXiv:2404.16821; hf",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv=8,
    head_dim=128,
    d_ff=8192,
    vocab=92553,
    act="swiglu",
    norm="rms",
    vision_patches=256,  # stub patch embeds prepended to the sequence
    tied_embeddings=False,
    rope_theta=1000000.0,
    remat="dots",
    skip_shapes=("long_500k",),  # pure full attention
)
