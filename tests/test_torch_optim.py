"""The port's optimizer pieces against the reference's on the same numpy
inputs (seeded): ``warmup_cosine``, ``global_norm`` /
``clip_by_global_norm``, and five ``AdamW`` updates with and without
weight decay, under a constant and a scheduled learning rate, both through
the functional ``update`` + ``apply_updates`` and the in-place ``step_``.

Bar: rtol 1e-6 (f32 sums over a leaf, and XLA's and PyTorch's ``pow`` /
``cos``, can differ in their last bit); the leaf order (JAX's: dict keys
sorted) and the tree structure are held exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as j_adamw
from repro.optim import clip as j_clip
from repro.optim.schedule import warmup_cosine as j_warmup_cosine
from repro_torch import tree as t_tree
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import clip as t_clip
from repro_torch.optim.schedule import warmup_cosine as t_warmup_cosine

RTOL = 1e-6


def _np_tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    r = lambda *s: (scale * rng.randn(*s)).astype(np.float32)
    return {"zeta": r(3, 5), "alpha": {"kernel": r(8, 4), "bias": r(4)},
            "blocks": [{"w": r(6, 6), "ln": {"scale": r(6)}}
                       for _ in range(2)]}


def _to_torch(tree):
    return t_tree.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got_tree, want_tree, rtol=RTOL, atol=0.0):
    got = t_tree.flatten_with_paths(got_tree)
    want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    assert [p for p, _ in got] == ["/".join(str(k) for k in p)
                                   for p, _ in want]
    for (p, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=p)


def test_leaf_order_and_paths_are_jaxs():
    state = j_adamw.AdamW().init(_to_jax(_np_tree(0)))
    want = ["/".join(str(k) for k in p) for p, _ in
            jax.tree_util.tree_flatten_with_path(
                {"opt": state, "x": None, "y": [1, (2, 3)]})[0]]
    tstate = t_adamw.AdamW().init(_to_torch(_np_tree(0)))
    got = [p for p, _ in t_tree.flatten_with_paths(
        {"opt": tstate, "x": None, "y": [1, (2, 3)]})]
    assert got == want
    tree = _to_torch(_np_tree(1))
    flat = t_tree.leaves(tree)
    back = t_tree.unflatten(tree, [x + 1 for x in flat])
    assert list(back) == list(tree)  # dicts keep their own key order
    assert all(torch.equal(b, x + 1) for b, x in
               zip(t_tree.leaves(back), flat))
    with pytest.raises(ValueError):
        t_tree.unflatten(tree, flat + [flat[0]])


@pytest.mark.parametrize("peak,warmup,total,floor", [
    (3e-4, 20, 100, 0.1), (1e-3, 0, 50, 0.0), (2e-2, 5, 5, 0.3),
    (5e-4, 7, 1000, 0.1)])
def test_warmup_cosine(peak, warmup, total, floor):
    jl = j_warmup_cosine(peak, warmup, total, floor)
    tl = t_warmup_cosine(peak, warmup, total, floor)
    for step in list(range(0, total + 6)) + [total * 3]:
        want = np.asarray(jl(jnp.asarray(step, jnp.int32)))
        got = tl(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("scale,max_norm", [(1.0, 1.0), (1e-3, 1.0),
                                            (10.0, 0.5), (0.0, 1.0)])
def test_global_norm_and_clip(scale, max_norm):
    g = _np_tree(3, scale)
    want_g, want_n = j_clip.clip_by_global_norm(_to_jax(g), max_norm)
    tree = _to_torch(g)
    before = t_tree.leaves(tree)
    got_g, got_n = t_clip.clip_by_global_norm(tree, max_norm)
    # scaled in place: the tree's own tensors, the reference's numbers
    assert got_g is tree and all(
        a is b for a, b in zip(t_tree.leaves(got_g), before))
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), rtol=RTOL)
    np.testing.assert_allclose(t_clip.global_norm(_to_torch(g)).numpy(),
                               np.asarray(j_clip.global_norm(_to_jax(g))),
                               rtol=RTOL)
    _close(got_g, want_g)


@pytest.mark.parametrize("decay", [0.0, 0.01])
@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("in_place", [False, True])
def test_five_adamw_updates(decay, schedule, in_place):
    lr_j = j_warmup_cosine(1e-2, 2, 5) if schedule else 3e-3
    lr_t = t_warmup_cosine(1e-2, 2, 5) if schedule else 3e-3
    jopt = j_adamw.AdamW(lr=lr_j, weight_decay=decay)
    topt = t_adamw.AdamW(lr=lr_t, weight_decay=decay)
    jp, tp = _to_jax(_np_tree(0)), _to_torch(_np_tree(0))
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts.count.dtype == torch.int32 and int(ts.count) == 0
    for k in range(5):
        g = _np_tree(10 + k, 0.1)
        ju, js = jopt.update(_to_jax(g), js, jp)
        jp = j_adamw.apply_updates(jp, ju)
        if in_place:
            before = t_tree.leaves(tp)
            ts = topt.step_(_to_torch(g), ts, tp)
            assert all(a is b for a, b in zip(t_tree.leaves(tp), before))
        else:
            tu, ts = topt.update(_to_torch(g), ts, tp)
            _close(tu, ju, atol=1e-9)
            tp = t_adamw.apply_updates(tp, tu)
        assert int(ts.count) == int(js.count) == k + 1
        _close(tp, jp)
        _close(ts.mu, js.mu)
        _close(ts.nu, js.nu)
