"""Corpora for the offline environment (numpy copies of the reference's:
the same seed gives the same token stream, bit for bit).

Two sources:
  * ``synthetic_corpus`` — a deterministic hierarchical Markov-chain token
    stream with Zipfian unigrams and long-range "topic" structure.  It is
    *learnable* (a small LM drives PPL well below the unigram entropy) which
    is what the benchmark harness needs: precision policies are compared on
    the same trained model, so the corpus only has to expose structure that
    quantization error can destroy.
  * ``text_corpus`` — tokenize a local text file (byte-level), for users who
    mount real data (e.g. wikitext) into the container.

Both return a flat ``np.int32 [N]`` token stream; the loader packs it.
"""

from __future__ import annotations

import os

import numpy as np


def synthetic_corpus(
    n_tokens: int,
    vocab: int,
    seed: int = 0,
    n_topics: int = 8,
    topic_len: int = 256,
    order: int = 2,
) -> np.ndarray:
    """Deterministic topic-switching Markov stream.

    Each topic owns a sparse ``order``-gram transition table over a Zipfian
    vocabulary subset; the stream switches topic every ``topic_len`` tokens.
    A trained LM must learn both local n-gram structure and the topic prior,
    so quantization damage shows up as a PPL gap — the property the paper's
    tables measure.
    """
    rng = np.random.RandomState(seed)
    # Zipfian unigram over the vocab (shared base distribution).
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    base_p = 1.0 / ranks
    base_p /= base_p.sum()

    # One SHARED successor table (state -> 8 candidates) so the bigram
    # structure is strong and learnable even by a tiny model; topics modulate
    # only the *weights* among candidates (longer-range structure).
    n_succ = 8
    topic_perm = np.stack(
        [rng.permutation(vocab) for _ in range(n_topics)]
    )  # (T, V)
    succ = rng.randint(0, vocab, size=(vocab, n_succ))

    out = np.empty(n_tokens, dtype=np.int32)
    state = 0
    for start in range(0, n_tokens, topic_len):
        t = (start // topic_len) % n_topics
        end = min(start + topic_len, n_tokens)
        for i in range(start, end):
            cands = succ[state]  # (n_succ,)
            # Zipf-weighted choice among candidates through the topic's lens.
            w = base_p[topic_perm[t, cands]]
            w = w / w.sum()
            state = int(cands[np.searchsorted(np.cumsum(w), rng.rand())])
            out[i] = state
    return out


def text_corpus(path: str, tokenizer=None) -> np.ndarray:
    """Byte-tokenize a text file into a flat stream."""
    from repro_torch.data.tokenizer import ByteTokenizer

    tokenizer = tokenizer or ByteTokenizer()
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        text = f.read()
    return tokenizer.encode(text, bos=True, eos=True)


def cache_or_build(path: str, builder, *args, **kw) -> np.ndarray:
    """Build-once cache for corpora (benchmarks re-run many policies)."""
    if os.path.exists(path):
        return np.load(path)
    arr = builder(*args, **kw)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, arr)
    return arr
