"""H2O-Danube-1.8B [arXiv:2401.16818]: llama+mistral mix — GQA (kv=8),
sliding-window attention, SwiGLU, RMSNorm, RoPE."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    source="arXiv:2401.16818; hf",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv=8,
    head_dim=80,
    d_ff=6912,
    vocab=32000,
    act="swiglu",
    norm="rms",
    window=4096,  # SWA — makes long_500k decode sub-quadratic
    tied_embeddings=False,
    rope_theta=10000.0,
    remat="dots",
    # SWA => KV cache is window-bounded => long-context decode is linear.
    skip_shapes=(),
)
