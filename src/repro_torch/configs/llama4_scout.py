"""Llama-4-Scout-17B-16E [hf:meta-llama]: MoE 16 experts top-1 (early
fusion noted in DESIGN.md; text backbone per assignment)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    n_layers=48,
    d_model=5120,
    n_heads=40,  # 40 % 16 != 0: padded head sharding
    n_kv=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    act="swiglu",
    norm="rms",
    n_experts=16,
    top_k=1,
    capacity_factor=1.25,
    moe_group_tokens=1024,
    tied_embeddings=False,
    rope_theta=500000.0,
    remat="dots",
    logits_chunk=512,
    skip_shapes=("long_500k",),  # full attention in this config
)
