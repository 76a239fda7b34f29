"""Granite-3 8B [hf:ibm-granite]: dense GQA (kv=8), SwiGLU, RMSNorm."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b",
    family="dense",
    source="hf:ibm-granite/granite-3.0-2b-base; hf",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    head_dim=128,
    d_ff=12800,
    vocab=49155,  # odd on purpose: padded to 49408 (see vocab_padded)
    act="swiglu",
    norm="rms",
    tied_embeddings=True,
    rope_theta=10000.0,
    remat="dots",
    skip_shapes=("long_500k",),  # pure full attention
)
