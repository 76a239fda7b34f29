"""Whisper-large-v3 backbone [arXiv:2212.04356]: enc-dec, 32+32 layers,
LayerNorm/GELU, learned decoder positions.  Conv/mel frontend is a stub:
input_specs() provides precomputed frame embeddings."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    source="arXiv:2212.04356; unverified",
    n_layers=32,          # decoder layers
    encoder_layers=32,
    d_model=1280,
    n_heads=20,  # 20 % 16 != 0: padded head sharding
    n_kv=20,
    head_dim=64,
    d_ff=5120,
    vocab=51866,
    act="gelu",
    norm="ln",
    pos="learned",
    max_position=65536,
    tied_embeddings=True,
    remat="dots",
    skip_shapes=("long_500k",),  # full attention enc-dec
)
