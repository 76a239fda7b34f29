"""OPT family (the paper's own models) for benchmark tables: pre-LN decoder,
ReLU FFN, learned positions, tied embeddings [arXiv:2205.01068].

`opt-tiny` is the synthetic-pretraining stand-in used by benchmarks (no
offline OPT checkpoints)."""

from repro_torch.configs.base import ArchConfig

_OPT_125M = ArchConfig(
    name="opt-125m",
    family="dense",
    source="arXiv:2205.01068",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv=12,
    d_ff=3072,
    vocab=50272,
    act="relu",
    norm="ln",
    pos="learned",
    max_position=2048,
    tied_embeddings=True,
    scan_layers=False,  # calibration requires per-layer eager sites
)

_OPT_TINY = _OPT_125M.replace(
    name="opt-tiny",
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv=4,
    head_dim=32,
    d_ff=512,
    vocab=512,
    max_position=512,
)


def get(name: str) -> ArchConfig:
    return {"opt-125m": _OPT_125M, "opt-tiny": _OPT_TINY}[name]
