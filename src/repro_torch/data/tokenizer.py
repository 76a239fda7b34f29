"""Byte-level tokenizer (no external vocab files; fully offline): a copy of
the reference's numpy tokenizer.

ids 0..255 are raw bytes; specials live above.  This is the GPT-2-byte
fallback scheme: lossless on any UTF-8 text, vocab 260, and good enough for
the proxy-model experiments in ``benchmarks/`` (the paper's OPT uses BPE,
but PPL *comparisons between precision policies* only need a consistent
tokenization — see EXPERIMENTS.md §Method).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ByteTokenizer:
    pad_id: int = 256
    bos_id: int = 257
    eos_id: int = 258
    unk_id: int = 259  # unused (bytes are total) — kept for API parity

    @property
    def vocab_size(self) -> int:
        return 260

    def encode(self, text: str, bos: bool = True, eos: bool = False):
        ids = list(text.encode("utf-8"))
        if bos:
            ids = [self.bos_id] + ids
        if eos:
            ids = ids + [self.eos_id]
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids) -> str:
        bs = bytes(int(i) for i in np.asarray(ids).ravel() if int(i) < 256)
        return bs.decode("utf-8", errors="replace")
