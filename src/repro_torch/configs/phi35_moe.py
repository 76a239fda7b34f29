"""Phi-3.5-MoE 42B (6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct]:
16 experts top-2, GQA kv=8."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    head_dim=128,
    d_ff=6400,
    vocab=32064,
    act="swiglu",
    norm="ln",
    n_experts=16,
    top_k=2,
    capacity_factor=1.25,
    moe_group_tokens=1024,
    tied_embeddings=False,
    rope_theta=10000.0,
    remat="dots",
    skip_shapes=("long_500k",),  # pure full attention
)
