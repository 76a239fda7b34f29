"""Port compressed weight storage vs the reference.

The same numpy kernels go through ``repro`` and ``repro_torch``.  Codes,
scales, ``packed``, ``pad`` and the byte report are held EQUAL (codes and
bf16-derived scales are pinned bit patterns; bytes are integers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jp
from repro.models import serving_transforms as jst
from repro_torch.core import policy as tp
from repro_torch.models import serving_transforms as tst


def _tree(rng, d=64, ff=136, vocab=256, n_layers=2):
    """A TransformerLM-shaped parameter tree of numpy arrays (K = 136 pads
    to the 64-group on the wo kernels)."""
    def dense(i, o, bias=False):
        p = {"kernel": (rng.randn(i, o) / np.sqrt(i)).astype(np.float32)}
        if bias:
            p["bias"] = rng.randn(o).astype(np.float32)
        return p

    def block():
        return {
            "ln1": {"scale": np.ones(d, np.float32)},
            "attn": {"q": dense(d, d, True), "k": dense(d, 32, True),
                     "v": dense(d, 32, True), "o": dense(d, d)},
            "ln2": {"scale": np.ones(d, np.float32)},
            "ffn": {"wi": dense(d, ff), "wg": dense(d, ff),
                    "wo": dense(ff, d)},
        }

    return {
        "embed": {"table": rng.randn(vocab, d).astype(np.float32)},
        "final_norm": {"scale": np.ones(d, np.float32)},
        "blocks": [block() for _ in range(n_layers)],
        "lm_head": dense(d, vocab),
    }


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(v, fn) for v in tree]
    return fn(tree)


def _kernels(tree, path=()):
    """(site path, kernel leaf) pairs in walk order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "kernel":
                yield "/".join(path), v
            else:
                yield from _kernels(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _kernels(v, path[:-1] + (f"{path[-1]}.{i}",))


@pytest.mark.parametrize("fmt,scaler,k", [
    ("int4", "abfp", 128), ("int4", "abfp", 200), ("int8", "abfp", 200),
    ("int4", "channel_max", 96), ("int8", "channel_max", 96),
    ("int3", "abfp", 64),
])
def test_compress_kernel_equal(fmt, scaler, k):
    rng = np.random.RandomState(k)
    w = rng.randn(k, 48).astype(np.float32)
    w[:64, 3] = 0.0  # an all-zero group
    jk = jst.compress_kernel(jnp.asarray(w),
                             jp.TensorQuant(fmt, scaler=scaler, group=64))
    tk = tst.compress_kernel(torch.from_numpy(w),
                             tp.TensorQuant(fmt, scaler=scaler, group=64))
    assert (tk.packed, tk.pad, tk.k, tk.axis, tk.fmt_name, tk.dtype,
            tk.group) == (jk.packed, jk.pad, jk.k, jk.axis, jk.fmt_name,
                          jk.dtype, jk.group)
    np.testing.assert_array_equal(tk.codes.numpy(), np.asarray(jk.codes))
    np.testing.assert_array_equal(
        tk.scale.numpy().view(np.uint32),
        np.asarray(jk.scale).view(np.uint32))
    np.testing.assert_array_equal(
        tst.decompress_kernel(tk).numpy().view(np.uint32),
        np.asarray(jst.decompress_kernel(jk)).view(np.uint32))


@pytest.mark.parametrize("preset", ["w4a8_abfp", "w4ffn_fp8attn", "fp32",
                                    "w4a8_mse"])
def test_compress_weights_and_byte_report_equal(preset):
    rng = np.random.RandomState(4)
    tree = _tree(rng)
    jparams = _map_tree(tree, jnp.asarray)
    tparams = _map_tree(tree, torch.from_numpy)
    jserved = jst.compress_weights(jparams, jp.preset(preset))
    tserved = tst.compress_weights(tparams, tp.preset(preset))
    jk, tk = dict(_kernels(jserved)), dict(_kernels(tserved))
    assert list(jk) == list(tk)
    n_compressed = 0
    for site in jk:
        a, b = jk[site], tk[site]
        assert isinstance(b, tst.CompressedKernel) == \
            isinstance(a, jst.CompressedKernel), site
        if isinstance(b, tst.CompressedKernel):
            n_compressed += 1
            assert (b.packed, b.pad, b.k, b.fmt_name) == \
                (a.packed, a.pad, a.k, a.fmt_name), site
            np.testing.assert_array_equal(b.codes.numpy(),
                                          np.asarray(a.codes))
            np.testing.assert_array_equal(
                b.scale.numpy().view(np.uint32),
                np.asarray(a.scale).view(np.uint32))
        else:  # dense: untouched, or QDQ'd offline for float formats
            np.testing.assert_array_equal(
                b.numpy().view(np.uint32), np.asarray(a).view(np.uint32))
    jrep = jst.weight_bytes_report(jparams, jserved)
    trep = tst.weight_bytes_report(tparams, tserved)
    assert trep == jrep
    assert trep["compressed_sites"] == n_compressed
    assert tst.weight_bytes_summary(trep) == jst.weight_bytes_summary(jrep)
    # the embedding table is never transformed
    assert tserved["embed"]["table"] is tparams["embed"]["table"]


@pytest.mark.parametrize("preset", ["w4a8_abfp", "w4ffn_fp8attn", "fp32",
                                    "w4a16"])
def test_serving_policy_equal(preset):
    j = jst.serving_policy(jp.preset(preset))
    t = tst.serving_policy(tp.preset(preset))
    assert tp.policy_to_dict(t) == jp.policy_to_dict(j)


def test_compress_kernel_rejects_float_formats():
    with pytest.raises(ValueError, match="integer codes"):
        tst.compress_kernel(torch.zeros(64, 8), tp.TensorQuant("e4m3"))
