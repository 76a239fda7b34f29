"""Mamba2-130M [arXiv:2405.21060]: pure SSD (attention-free), 24 layers,
d_model=768, ssm_state=128."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    source="arXiv:2405.21060; unverified",
    n_layers=24,
    d_model=768,
    n_heads=4,    # unused (attention-free)
    n_kv=4,
    d_ff=0,       # attention-free: no FFN sublayer in mamba2 blocks
    vocab=50280,
    norm="rms",
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    tied_embeddings=True,
    remat="full",
    # 130M params: tensor parallelism is pointless and the inner dims
    # (d_inner=1536 -> proj_out=3352, H=24) don't divide 16; run the SSM
    # core data-parallel, shard only the (padded) vocab.
    sharding_overrides={
        "ssm_inner": None, "ssm_heads": None,
        # 130M on 256 chips: nothing to tensor-parallelize; use the model
        # axis for extra data parallelism where the batch divides.
        "train_4k:batch": ("pod", "data", "model"),
    },
    skip_shapes=(),  # SSM: long_500k is the showcase
)
