"""Gemma2-9B [arXiv:2408.00118]: alternating local(4096)/global attention,
logit softcaps (attn 50, final 30), GeGLU, pre+post RMSNorm with (1+w),
head_dim=256, vocab 256k."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    source="arXiv:2408.00118; hf",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    act="geglu",
    norm="rms",
    norm_plus_one=True,
    post_norms=True,
    window=4096,
    alt_local_global=True,
    attn_softcap=50.0,
    final_softcap=30.0,
    tied_embeddings=True,
    rope_theta=10000.0,
    remat="dots",
    logits_chunk=512,  # 256k vocab: never materialize (S, V) in training
    # local+global alternating: decode cost linear in KV (seq-sharded cache);
    # long_500k runs (hybrid local/global is not "pure full attention").
    skip_shapes=(),
)
