"""The port's token data pipeline against the reference's: the byte
tokenizer, the synthetic and text corpora, the Feistel shuffle, the LM
loader (``batch_at``, host shards, ``state_at`` / ``resume``) and the
evaluation batches.  They are numpy copies, so every output is held
bit-equal (``assert_array_equal`` and equal dtypes)."""

import numpy as np
import pytest

from repro.data import corpus as j_corpus
from repro.data import loader as j_loader
from repro.data.tokenizer import ByteTokenizer as JTok
from repro_torch.data import corpus as t_corpus
from repro_torch.data import loader as t_loader
from repro_torch.data.tokenizer import ByteTokenizer as TTok


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _same_batch(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        _same(got[k], want[k])


@pytest.mark.parametrize("text", ["", "hello wörld ☃", "a\nb\x00c" * 7])
@pytest.mark.parametrize("bos,eos", [(True, False), (False, True),
                                     (True, True), (False, False)])
def test_tokenizer_encode_decode(text, bos, eos):
    t, j = TTok(), JTok()
    ids = t.encode(text, bos=bos, eos=eos)
    _same(ids, j.encode(text, bos=bos, eos=eos))
    assert t.decode(ids) == j.decode(ids) == text
    assert (t.vocab_size, t.pad_id, t.bos_id, t.eos_id, t.unk_id) == (
        j.vocab_size, j.pad_id, j.bos_id, j.eos_id, j.unk_id)


@pytest.mark.parametrize("n,vocab,seed,topics,topic_len", [
    (2000, 101, 7, 8, 256), (3000, 503, 0, 8, 256), (1500, 64, 3, 3, 100),
    (777, 260, 11, 5, 64)])
def test_synthetic_corpus_is_the_reference_stream(n, vocab, seed, topics,
                                                  topic_len):
    _same(t_corpus.synthetic_corpus(n, vocab, seed=seed, n_topics=topics,
                                    topic_len=topic_len),
          j_corpus.synthetic_corpus(n, vocab, seed=seed, n_topics=topics,
                                    topic_len=topic_len))


def test_text_corpus_and_cache(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_text("The quick brown fox ☃ jumps.\nÜber alles\n" * 20,
                    encoding="utf-8")
    _same(t_corpus.text_corpus(str(path)), j_corpus.text_corpus(str(path)))
    cache = str(tmp_path / "cache" / "c.npy")
    built = t_corpus.cache_or_build(cache, t_corpus.synthetic_corpus, 500,
                                    50, seed=1)
    _same(built, j_corpus.synthetic_corpus(500, 50, seed=1))
    # the second call reads the file the first wrote (the builder is not run)
    again = t_corpus.cache_or_build(cache, lambda *a, **k: 1 / 0)
    _same(again, built)
    _same(j_corpus.cache_or_build(cache, lambda *a, **k: 1 / 0), built)


@pytest.mark.parametrize("n,seed", [(2, 0), (1000, 3), (4097, 10),
                                    (99_991, 2**31)])
def test_feistel_perm_is_the_reference_perm(n, seed):
    idx = np.arange(min(n, 5000))
    _same(t_loader._feistel_perm(idx, n, seed),
          j_loader._feistel_perm(idx, n, seed))


@pytest.mark.parametrize("seq,gb,seed,hosts", [(32, 4, 0, 1), (16, 8, 5, 2),
                                               (64, 2, 9, 1)])
def test_loader_batches_are_the_reference_batches(seq, gb, seed, hosts):
    stream = j_corpus.synthetic_corpus(20_000, vocab=97, seed=1)
    for host in range(hosts):
        t = t_loader.LMLoader(stream, seq_len=seq, global_batch=gb,
                              seed=seed, host_id=host, n_hosts=hosts)
        j = j_loader.LMLoader(stream, seq_len=seq, global_batch=gb,
                              seed=seed, host_id=host, n_hosts=hosts)
        assert (t.n_windows, t.steps_per_epoch, t.local_batch) == (
            j.n_windows, j.steps_per_epoch, j.local_batch)
        # steps across an epoch boundary (a new shuffle seed)
        for step in (0, 1, 7, t.steps_per_epoch, 3 * t.steps_per_epoch + 2):
            _same_batch(t.batch_at(step), j.batch_at(step))
        it_t, it_j = t.resume(t.state_at(4)), j.resume(j.state_at(4))
        for _ in range(3):
            _same_batch(next(it_t), next(it_j))
        assert t.state_at(4) == (4,)


def test_loader_iterates_and_rejects_a_short_stream():
    stream = j_corpus.synthetic_corpus(5000, vocab=50, seed=0)
    t = t_loader.LMLoader(stream, seq_len=16, global_batch=4, seed=2)
    it = iter(t)
    for step in range(3):
        _same_batch(next(it), t.batch_at(step))
    with pytest.raises(ValueError, match="stream too short"):
        t_loader.LMLoader(np.arange(10, dtype=np.int32), seq_len=32,
                          global_batch=1)


@pytest.mark.parametrize("seq,batch,max_batches", [(32, 2, None), (16, 4, 3),
                                                   (50, 3, 100)])
def test_eval_batches_are_the_reference_batches(seq, batch, max_batches):
    stream = j_corpus.synthetic_corpus(3000, vocab=77, seed=4)
    got = list(t_loader.eval_batches(stream, seq, batch, max_batches))
    want = list(j_loader.eval_batches(stream, seq, batch, max_batches))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _same_batch(g, w)
