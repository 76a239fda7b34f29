"""``launch.specs`` and ``compress_axes`` of the port against the
reference's: the twins of ``test_roofline_launch.py``'s spec tests
(``fit_batch_rule``, ``rules_for``, ``batch_specs``, ``spec_for`` with
``fit_shape``), ``rules_for`` over every config, shape and strategy,
``decode_state_axes`` / ``eval_decode_state`` per family (the reference's
stacked caches mapped onto the port's per-layer lists), and the full-width
plans: ``shardings_from_axes`` for qwen2-7b and phi3.5-moe (at 2 of their
layers: every layer's plan is the same) on fake (16, 16) and (2, 16, 16)
meshes, dense and compressed, spec for spec with the reference's (the port
on the ``meta`` device, the reference under ``eval_shape``)."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.configs import list_configs
from repro.dist import sharding as ref_shd
from repro.launch import specs as ref_sp
from repro.models import build_model as ref_build
from repro_torch.configs import SHAPES, get_config
from repro_torch.core.policy import preset
from repro_torch.dist import sharding as shd
from repro_torch.launch import specs as sp
from repro_torch.models import build_model
from repro_torch.models import serving_transforms as st
from torch_dist_helpers import full_width_trees


class _Mesh:
    def __init__(self, axes, shape):
        self.axis_names = axes

        class _D:
            def __init__(s, sh):
                s.shape = sh

        self.devices = _D(shape)


MESHES = {"16x16": _Mesh(("data", "model"), (16, 16)),
          "2x16x16": _Mesh(("pod", "data", "model"), (2, 16, 16))}


def _fold(spec):
    """A port spec with one-name tuple entries folded into the name (the
    installed JAX's ``PartitionSpec`` folds them)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


# ------------------------------------------------------------ batch fitting
def test_fit_batch_rule_keeps_dividing_prefix():
    rules = {"batch": ("pod", "data", "model")}
    mesh = MESHES["2x16x16"]
    for n, want in ((256, ("pod", "data")), (512, ("pod", "data", "model")),
                    (1, None)):
        out = sp.fit_batch_rule(rules, n, mesh)
        assert out["batch"] == want
        assert out == ref_sp.fit_batch_rule(rules, n, mesh)


def test_fit_batch_rule_none_passthrough():
    mesh = _Mesh(("data",), (8,))
    assert sp.fit_batch_rule({"batch": None}, 7, mesh)["batch"] is None
    assert ref_sp.fit_batch_rule({"batch": None}, 7, mesh)["batch"] is None


def test_rules_for_fsdp_strategy():
    cfg = get_config("gemma2-9b")
    rules = sp.rules_for(cfg, SHAPES["train_4k"], strategy="fsdp")
    assert rules["batch"] == ("pod", "data", "model")
    assert rules["seq_res"] is None
    assert rules["mlp"] == ("data", "model")
    assert sp.rules_for(cfg, SHAPES["train_4k"])["mlp"] == "model"
    assert rules == ref_sp.rules_for(ref_config("gemma2-9b"),
                                     REF_SHAPES["train_4k"], "fsdp")


def test_rules_for_long_context():
    rules = sp.rules_for(get_config("mamba2-130m"), SHAPES["long_500k"])
    assert rules["batch"] is None
    assert rules["kv_seq"] == ("pod", "data", "model")
    assert rules == ref_sp.rules_for(ref_config("mamba2-130m"),
                                     REF_SHAPES["long_500k"])


def test_rules_for_every_config_shape_and_strategy():
    for name in list_configs():
        for shape in SHAPES:
            for strategy in (None, "fsdp"):
                assert sp.rules_for(get_config(name), SHAPES[shape],
                                    strategy) == ref_sp.rules_for(
                    ref_config(name), REF_SHAPES[shape], strategy), (
                    name, shape, strategy)


# ------------------------------------------------------------- batch specs
def _same_batch(port, ref):
    (psds, pax), (rsds, rax) = port, ref
    assert pax == rax
    assert list(psds) == list(rsds)
    for k in psds:
        assert psds[k].device.type == "meta"
        assert tuple(psds[k].shape) == tuple(rsds[k].shape), k
        assert str(psds[k].dtype).split(".")[1] == str(rsds[k].dtype), k


def test_batch_specs_families():
    for arch, extra in (("qwen2-7b", None), ("internvl2-2b", "patch_embeds"),
                        ("whisper-large-v3", "frames")):
        sds, axes = sp.batch_specs(get_config(arch), SHAPES["train_4k"])
        assert "tokens" in sds and "labels" in sds
        if extra:
            assert extra in sds and extra in axes
        if arch == "internvl2-2b":
            assert (sds["tokens"].shape[1] + sds["patch_embeds"].shape[1]
                    == 4096)
        for shape in SHAPES:
            _same_batch(sp.batch_specs(get_config(arch), SHAPES[shape]),
                        ref_sp.batch_specs(ref_config(arch),
                                           REF_SHAPES[shape]))


def test_batch_specs_vit():
    sds, axes = sp.batch_specs(get_config("vit-b16"), SHAPES["train_4k"])
    assert tuple(sds["images"].shape) == (256, 224, 224, 3)
    assert tuple(sds["labels"].shape) == (256,)
    assert axes["images"] == ("batch", None, None, None)
    sds_e, _ = sp.batch_specs(get_config("vit-b16"), SHAPES["prefill_32k"])
    assert "images" in sds_e and "labels" not in sds_e
    for shape in SHAPES:
        _same_batch(sp.batch_specs(get_config("vit-b16"), SHAPES[shape]),
                    ref_sp.batch_specs(ref_config("vit-b16"),
                                       REF_SHAPES[shape]))


def test_token_spec():
    t, ax = sp.token_spec(get_config("qwen2-7b"), 16)
    rt, rax = ref_sp.token_spec(ref_config("qwen2-7b"), 16)
    assert (tuple(t.shape), ax) == (tuple(rt.shape), rax)
    assert t.dtype == torch.int32 and t.device.type == "meta"


def test_spec_for_fit_shape_drops_nondividing_axes():
    mesh = MESHES["16x16"]
    rules = {"qkv": ("data", "model")}
    for n, want in ((384, shd.P(("data",))), (512, shd.P(("data", "model"))),
                    (7, shd.P(None))):
        got = shd.spec_for(("qkv",), rules=rules, mesh=mesh, fit_shape=(n,))
        assert got == want
        assert _fold(got) == tuple(ref_shd.spec_for(
            ("qkv",), rules=rules, mesh=mesh, fit_shape=(n,)))


def test_spec_for_fit_skipped_axis_not_consumed():
    mesh = MESHES["16x16"]
    rules = {"r1": "model", "r2": "model"}
    spec = shd.spec_for(("r1", "r2"), rules=rules, mesh=mesh,
                        fit_shape=(10, 32))
    assert spec == shd.P(None, "model")
    assert tuple(spec) == tuple(ref_shd.spec_for(
        ("r1", "r2"), rules=rules, mesh=mesh, fit_shape=(10, 32)))


def test_spec_for_fit_shape_rank_mismatch_raises():
    mesh = _Mesh(("data",), (8,))
    with pytest.raises(ValueError, match="rank"):
        shd.spec_for(("batch", "embed"), rules={"batch": "data"}, mesh=mesh,
                     fit_shape=(8,))


# ------------------------------------------------------- decode-state axes
def _norm_state(x):
    """A state or axes tree as plain dicts / lists: NamedTuples by field
    (the port's unset ``pages`` dropped), stacked leaves kept."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {f: _norm_state(v) for f, v in zip(x._fields, x)
                if not (f == "pages" and v is None)}
    if isinstance(x, list):
        return [_norm_state(v) for v in x]
    return x


def _listed(ref, n, strip=1):
    """A stacked (n, ...) axes NamedTuple as the port's list of n."""
    one = type(ref)(*(None if a is None else a[strip:] for a in ref))
    return [_norm_state(one)] * n


ARCHS = ("qwen2-7b", "mamba2-130m", "zamba2-7b", "whisper-large-v3",
         "gemma2-9b")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_axes_and_eval_decode_state(arch):
    shape = SHAPES["decode_32k"]
    for kv_quant in (False, True):
        if kv_quant and arch != "qwen2-7b":
            continue
        cfg = get_config(arch).replace(n_layers=4) if arch != "zamba2-7b" \
            else get_config(arch).replace(n_layers=12)
        rcfg = ref_config(arch).replace(n_layers=cfg.n_layers)
        state = sp.eval_decode_state(build_model(cfg, device="meta"), cfg,
                                     shape, kv_quant=kv_quant)
        rstate = ref_sp.eval_decode_state(ref_build(rcfg), rcfg,
                                          REF_SHAPES["decode_32k"],
                                          kv_quant=kv_quant)
        axes = sp.decode_state_axes(cfg, state)
        rax = ref_sp.decode_state_axes(rcfg, rstate)
        want = _norm_state(rax)
        if "x0" in want:  # hybrid: kv (G, ...), ssm (G, k-1, ...)
            G, k1 = len(state.ssm), len(state.ssm[0])
            want["kv"] = _listed(rax.kv, G)
            want["ssm"] = [_listed(rax.ssm, k1, 2)] * G
        else:
            for key in ("kv", "ssm"):
                if getattr(rax, key, None) is not None:
                    want[key] = _listed(getattr(rax, key), cfg.n_layers)
        assert _norm_state(axes) == want
        # the state's leaves have the reference's shapes (a stacked leaf
        # per layer) and dtypes, on the meta device
        flat = jax.tree_util.tree_leaves(_norm_state(state))
        assert all(t.device.type == "meta" for t in flat)
        for key in ("kv", "ssm"):
            ours, theirs = getattr(state, key, None), getattr(rstate, key,
                                                                None)
            if ours is None:
                continue
            one = ours[0][0] if "x0" in want and key == "ssm" else ours[0]
            for a, b in zip(one, theirs):
                if a is None:
                    continue
                strip = 2 if "x0" in want and key == "ssm" else 1
                assert tuple(a.shape) == tuple(b.shape[strip:])
                assert str(a.dtype).split(".")[1] == str(b.dtype)
        if "cross_k" in want:  # the port keeps the cross K / V stacked
            assert tuple(state.cross_k.shape) == tuple(rstate.cross_k.shape)


# --------------------------------------------------------- full-width plans
def _ref_leaves(tree):
    return [(jax.tree_util.keystr(p), _fold(s)) for p, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))[0]]


def _port_leaves(tree, path=""):
    if isinstance(tree, shd.NamedSharding):
        return [(path, _fold(tree.spec))]
    if isinstance(tree, shd.PartitionSpec):
        return [(path, _fold(tree))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _port_leaves(tree[k], f"{path}[{k!r}]")]
    if hasattr(tree, "tree_children"):
        return [x for i, c in enumerate(tree.tree_children())
                for x in _port_leaves(c, f"{path}[<flat index {i}>]")]
    return [x for i, c in enumerate(tree)
            for x in _port_leaves(c, f"{path}[{i}]")]


@pytest.fixture(scope="module", params=[
    ("qwen2-7b", False), ("qwen2-7b", True),
    ("phi3.5-moe-42b-a6.6b", False), ("phi3.5-moe-42b-a6.6b", True)],
    ids=lambda p: f"{p[0]}-{'compressed' if p[1] else 'dense'}")
def full_width(request):
    return request.param, full_width_trees(*request.param)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_shardings_from_axes_at_full_width(full_width, mesh, monkeypatch):
    (name, compressed), (axes, params, rax, rsds) = full_width
    monkeypatch.setattr(ref_sp, "NamedSharding", lambda m, spec: spec)
    for fit in (False, True):
        rules = sp.rules_for(get_config(name), SHAPES["train_4k"])
        ours = sp.shardings_from_axes(axes, MESHES[mesh], rules,
                                      params if fit else None)
        theirs = ref_sp.shardings_from_axes(rax, MESHES[mesh], rules,
                                            rsds if fit else None)
        got, want = _port_leaves(ours), _ref_leaves(theirs)
        assert len(got) == len(want) > 20
        assert got == want
    if compressed:  # the codes follow the kernel's output axis
        k = ours["blocks"][0]["attn"]["q"]["kernel"]
        assert isinstance(k, st.CompressedKernel)
        assert _fold(k.codes.spec) == ("model", None, None)


def test_compress_axes_drops_the_expert_axis():
    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
    model = build_model(cfg, device="cpu")
    params = st.compress_weights(model.init(torch.Generator()),
                                 preset("w4a8_abfp"))
    axes = st.compress_axes(model.param_axes(), params)
    bank = axes["blocks"][0]["ffn"]["wi"]
    assert isinstance(bank, st.ExpertBank)
    assert all(e.codes == ("moe_mlp", None, None) and e.scale == ("moe_mlp",
               None) for e in bank.entries)
    assert axes["blocks"][0]["ffn"]["router"] == ("embed", "experts")
    assert axes["embed"] == {"table": ("vocab", "embed")}
    # the metadata is the compressed tree's
    e = params["blocks"][0]["ffn"]["wi"].entries[0]
    assert (bank.entries[0].k, bank.entries[0].packed) == (e.k, e.packed)
    np.testing.assert_equal(len(bank.entries), cfg.n_experts)
