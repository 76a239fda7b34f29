"""Data of the port: byte tokenizer, token corpora, the deterministic LM
loader (numpy copies of the reference's, batches bit-equal), and the
synthetic image set and its loaders."""

from repro_torch.data.corpus import synthetic_corpus, text_corpus
from repro_torch.data.images import (ImageLoader, eval_image_batches,
                                     synthetic_images)
from repro_torch.data.loader import LMLoader, LoaderState
from repro_torch.data.tokenizer import ByteTokenizer

__all__ = [
    "ByteTokenizer",
    "synthetic_corpus",
    "text_corpus",
    "synthetic_images",
    "ImageLoader",
    "eval_image_batches",
    "LMLoader",
    "LoaderState",
]
