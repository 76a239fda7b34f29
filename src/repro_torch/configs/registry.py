"""Config registry: ``--arch <id>`` resolution (the reference's 14 ids)."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_ARCHS = {
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    # the mixture-of-experts family
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout",
    # the paper's vision-transformer family (§III ViT/DeiT tables)
    "vit-b16": "repro_torch.configs.vit_b16",
    "deit-s16": "repro_torch.configs.deit_s16",
    # the paper's own model family (PTQ methods table)
    "opt-125m": "repro_torch.configs.opt",
    "opt-tiny": "repro_torch.configs.opt",
    # the state-space family and the Mamba2 / shared-attention hybrid
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    # the encoder-decoder (stub audio front end) and the vision-language
    # model (stub patch embeddings prepended to the text)
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
}


def list_configs() -> list[str]:
    return sorted(_ARCHS)


def get_config(name: str) -> ArchConfig:
    key = name.lower()
    if key not in _ARCHS:
        raise ValueError(f"unknown arch {name!r}; known: {list_configs()}")
    mod = importlib.import_module(_ARCHS[key])
    return mod.get(key) if hasattr(mod, "get") else mod.CONFIG
