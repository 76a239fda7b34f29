"""Qwen2-7B [arXiv:2407.10671]: GQA kv=4, QKV bias, SwiGLU, RMSNorm."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b",
    family="dense",
    source="arXiv:2407.10671; hf",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv=4,
    head_dim=128,
    d_ff=18944,
    vocab=152064,
    act="swiglu",
    norm="rms",
    qkv_bias=True,
    tied_embeddings=False,
    rope_theta=1000000.0,
    remat="dots",
    logits_chunk=512,
    skip_shapes=("long_500k",),  # pure full attention
)
