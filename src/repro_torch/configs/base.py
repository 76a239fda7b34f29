"""ArchConfig: one dataclass describing every supported architecture family,
plus the assigned input-shape grid (train_4k / prefill_32k / decode_32k /
long_500k).
"""

from __future__ import annotations

import dataclasses


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # --- identity ---------------------------------------------------------
    name: str = "arch"
    family: str = "dense"  # dense | moe | hybrid | ssm | encdec | vlm
    source: str = ""  # paper / hf citation

    # --- transformer dims ---------------------------------------------------
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv: int = 2
    head_dim: int | None = None  # default d_model // n_heads
    d_ff: int = 512
    vocab: int = 512
    act: str = "swiglu"
    norm: str = "rms"  # rms | ln
    norm_plus_one: bool = False  # gemma (1+w) convention
    qkv_bias: bool = False
    tied_embeddings: bool = True
    pos: str = "rope"  # rope | learned | sinusoidal
    rope_theta: float = 10000.0
    max_position: int = 1 << 20  # learned-pos table size cap

    # --- attention variants -------------------------------------------------
    window: int | None = None  # sliding-window size (SWA)
    alt_local_global: bool = False  # gemma2: even layers local, odd global
    attn_softcap: float | None = None
    final_softcap: float | None = None
    post_norms: bool = False  # gemma2 extra post-block norms

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_group_tokens: int = 1024

    # --- SSM / hybrid ---------------------------------------------------------
    ssm_state: int = 0  # >0 enables mamba blocks
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 128
    shared_attn_every: int = 0  # zamba2: every k-th layer is the shared block
    lora_rank: int = 8  # zamba2 per-invocation LoRA on the shared block

    # --- enc-dec (whisper backbone) ------------------------------------------
    encoder_layers: int = 0  # >0 enables encoder+cross-attention

    # --- vlm (internvl2 backbone) ---------------------------------------------
    vision_patches: int = 0  # stub patch-embedding count prepended to seq

    # --- vit (image classification) -------------------------------------------
    image_size: int = 0  # >0 enables the ViT classification family
    patch_size: int = 16
    n_channels: int = 3
    n_classes: int = 0
    pool: str = "cls"  # 'cls' token readout | 'mean' pooling

    # --- execution -------------------------------------------------------------
    dtype: str = "float32"
    param_dtype: str = "float32"
    remat: str = "none"  # none | full | dots
    scan_layers: bool = True
    q_block: int = 512
    kv_block: int = 512
    logits_chunk: int = 0  # >0: chunked loss over seq (never materialize SxV)
    sharding_overrides: dict | None = None  # logical-rule overrides

    # --- assigned shape applicability --------------------------------------
    skip_shapes: tuple = ()  # e.g. ('long_500k',) for pure full-attention

    # ------------------------------------------------------------------ api
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return pad_to(self.vocab, 256)

    @property
    def is_attention_free(self) -> bool:
        return self.ssm_state > 0 and self.shared_attn_every == 0

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def vit_seq_len(self) -> int:
        """Encoder sequence length: patches (+ cls token)."""
        return self.n_patches + (1 if self.pool == "cls" else 0)

    def n_params(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd = self.head_dim_
        attn = d * hd * (self.n_heads + 2 * self.n_kv) + self.n_heads * hd * d
        glu = 3 if self.act in ("swiglu", "geglu", "reglu") else 2
        mlp = glu * d * f
        if self.family == "vit":
            patch = (self.patch_size**2 * self.n_channels + 1) * d
            pos = self.vit_seq_len * d + (d if self.pool == "cls" else 0)
            # padded head, matching the built model (cf. vocab_padded)
            head = (d + 1) * pad_to(self.n_classes, 128)
            return L * (attn + mlp) + patch + pos + head
        if self.family == "moe":
            mlp = mlp * self.n_experts + d * self.n_experts
        ssm = 0
        if self.ssm_state > 0:
            di = self.ssm_expand * d
            nh = di // self.ssm_head_dim
            proj = 2 * di + 2 * self.ssm_groups * self.ssm_state + nh
            ssm = d * proj + di * d + self.ssm_conv * (
                di + 2 * self.ssm_groups * self.ssm_state
            )
        if self.family == "ssm":
            per_layer = ssm
        elif self.family == "hybrid":
            # shared attn counted once; mamba layers dominate
            n_shared = (
                L // self.shared_attn_every if self.shared_attn_every else 0
            )
            n_mamba = L - n_shared
            emb = self.vocab_padded * d * (1 if self.tied_embeddings else 2)
            return n_mamba * ssm + (attn + mlp) + emb
        else:
            per_layer = attn + mlp
        emb = self.vocab_padded * d * (1 if self.tied_embeddings else 2)
        enc = self.encoder_layers * (attn + mlp)
        dec_cross = self.encoder_layers and L * attn or 0
        return L * per_layer + emb + enc + dec_cross

    def n_active_params(self) -> int:
        """MoE: only top_k experts active per token."""
        if self.family != "moe":
            return self.n_params()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd = self.head_dim_
        attn = d * hd * (self.n_heads + 2 * self.n_kv) + self.n_heads * hd * d
        glu = 3 if self.act in ("swiglu", "geglu", "reglu") else 2
        mlp_active = glu * d * f * self.top_k + d * self.n_experts
        emb = self.vocab_padded * d * (1 if self.tied_embeddings else 2)
        return L * (attn + mlp_active) + emb

    def shapes(self) -> list[ShapeSpec]:
        return [s for k, s in SHAPES.items() if k not in self.skip_shapes]

    def reduced(self, seq: int = 64) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 3 if self.shared_attn_every else 2),
            d_model=64,
            n_heads=4,
            n_kv=2,
            head_dim=16,
            d_ff=128,
            vocab=503,  # deliberately non-multiple-of-256: tests padding
            moe_group_tokens=64,
            ssm_head_dim=16,
            ssm_state=16 if self.ssm_state else 0,
            ssm_chunk=16,
            q_block=32,
            kv_block=32,
            max_position=4096,
            logits_chunk=0,
            remat="none",  # CPU-scale; also required for calibration taps
            window=8 if self.window else None,
        )
        if self.family == "moe":
            kw["n_experts"] = 4
        if self.family == "hybrid":
            kw["n_layers"] = 3
            kw["shared_attn_every"] = 3
            kw["lora_rank"] = 4
        if self.family == "encdec":
            kw["encoder_layers"] = 2
        if self.family == "vlm":
            kw["vision_patches"] = 8
        if self.family == "vit":
            # 32x32 images in 8x8 patches -> 16-token encoder, 10 classes
            kw["image_size"] = 32
            kw["patch_size"] = 8
            kw["n_classes"] = min(self.n_classes or 10, 10)
        return dataclasses.replace(self, **kw)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
