"""Zamba2-7B [arXiv:2411.15242]: Mamba2 backbone + shared attention block
(every 3rd layer) with per-invocation LoRA; GQA kv=32 (MHA), ssm_state=64."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    source="arXiv:2411.15242; unverified",
    n_layers=81,  # 27 groups x (2 mamba + 1 shared-attn invocation)
    d_model=3584,
    n_heads=32,
    n_kv=32,
    head_dim=112,
    d_ff=14336,
    vocab=32000,
    act="swiglu",
    norm="rms",
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    shared_attn_every=3,
    lora_rank=8,
    tied_embeddings=True,
    remat="full",
    skip_shapes=(),  # hybrid: long_500k runs (SSM state + seq-sharded KV)
)
