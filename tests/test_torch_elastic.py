"""Elastic restore planning of the port against the reference's: the twins
of ``test_sharding_dist.py``'s ``restore_specs`` tests (each port result
held to the reference's), ``restore_specs`` at full width (qwen2-7b and
phi3.5-moe, 2 of their layers, dense and compressed, both production mesh
shapes, default and FSDP rules: the same specs and the same fallbacks, path
for path), and one gloo rank (a world of one, a (1, 1) mesh): the restore
round trip through ``shardings_for_restore`` and ``CheckpointManager``, a
DTensor refused by every kernel wrapper, ``constrain`` on a real DTensor,
``compressed_psum_pod`` over a (1, 1) ``("pod", "data")`` mesh, the
meshes' world-size checks, and reduced qwen2-7b's sharded loss and
gradients (RoPE, grouped KV heads) bit-equal to the unsharded ones."""

import dataclasses

import jax
import numpy as np
import pytest

from repro.dist import elastic as ref_el
from repro.dist import sharding as ref_shd
from repro_torch.configs import SHAPES, get_config
from repro_torch.dist import elastic as el
from repro_torch.dist import sharding as shd
from repro_torch.launch import specs as sp
from torch_dist_helpers import full_width_trees, run_gloo_ranks


class _FakeMesh24:
    """2x4 (data, model) mesh stand-in: planning is pure, no devices."""

    axis_names = ("data", "model")

    class devices:
        shape = (2, 4)


class _Mesh:
    def __init__(self, axes, shape):
        self.axis_names = axes

        class _D:
            pass

        self.devices = _D()
        self.devices.shape = shape


def _fold(spec):
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _meta(shape):
    import torch

    return torch.empty(shape, dtype=torch.float32, device="meta")


def _both(paxes, shapes, mesh, rules):
    """(port specs, port report, reference specs, reference report)."""
    specs, report = el.restore_specs(
        paxes, {k: _meta(v) for k, v in shapes.items()}, mesh, rules)
    rspecs, rreport = ref_el.restore_specs(
        paxes, {k: jax.ShapeDtypeStruct(v, np.float32)
                for k, v in shapes.items()}, mesh, rules)
    for k in paxes:
        assert _fold(specs[k]) == tuple(rspecs[k]), k
    assert (report.n_params, report.n_sharded) == (rreport.n_params,
                                                   rreport.n_sharded)
    assert [dataclasses.astuple(f) for f in report.fallbacks] == [
        dataclasses.astuple(f) for f in rreport.fallbacks]
    assert report.summary() == rreport.summary()
    return specs, report


def test_restore_specs_replication_fallback():
    paxes = {"wi": ("embed", "mlp"), "wo": ("mlp", "embed"),
             "bias": ("mlp",)}
    shapes = {"wi": (64, 130), "wo": (130, 64), "bias": (128,)}
    specs, report = _both(paxes, shapes, _FakeMesh24(),
                          dict(shd.DEFAULT_RULES))
    assert specs["wi"] == shd.P(None, None)
    assert specs["wo"] == shd.P(None, None)
    assert specs["bias"] == shd.P("model")
    assert (report.n_params, report.n_sharded) == (3, 1)
    fb = {f.path: f for f in report.fallbacks}
    assert len(fb) == 2 and fb["['wi']"].logical == "mlp"
    assert fb["['wi']"].size == 130 and fb["['wi']"].ways == 4


def test_restore_specs_rank_mismatch_bails_to_replicated():
    specs, report = _both({"w": ("embed", "mlp")}, {"w": (8,)},
                          _FakeMesh24(), dict(shd.DEFAULT_RULES))
    assert specs["w"] == shd.P()
    assert len(report.fallbacks) == 1 and report.fallbacks[0].dim == -1
    assert "1 replication fallbacks" in report.summary()


def test_restore_specs_tuple_rule_keeps_dividing_subset():
    rules = dict(shd.DEFAULT_RULES, batch=("data", "model"))
    specs, report = _both({"x": ("batch", "embed")}, {"x": (6, 64)},
                          _FakeMesh24(), rules)
    assert specs["x"] == shd.P(("data",), None)
    fb = report.fallbacks[0]
    assert fb.ways == 8 and fb.kept == 2


def test_restore_specs_unfit_dim_releases_axis_to_later_dim():
    rules = dict(shd.DEFAULT_RULES, moe_mlp="model")
    specs, report = _both({"wi": ("experts", "moe_mlp")},
                          {"wi": (6, 1024)}, _FakeMesh24(), rules)
    assert specs["wi"] == shd.P(None, "model")
    fb = report.fallbacks[0]
    assert len(report.fallbacks) == 1
    assert fb.logical == "experts" and fb.ways == 4 and fb.kept == 1


def test_restore_specs_none_axes_replicates_without_fallback():
    specs, report = _both({"w": None}, {"w": (4, 4)}, _FakeMesh24(),
                          dict(shd.DEFAULT_RULES))
    assert specs["w"] == shd.P()
    assert report.n_params == 1 and not report.fallbacks


# ---------------------------------------------------------- full width
def _ref_leaves(tree):
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]]


def _port_leaves(tree, path=""):
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


@pytest.mark.parametrize("mesh", [("data", "model"), ("pod", "data", "model")],
                         ids=["16x16", "2x16x16"])
def test_restore_specs_at_full_width(full_width, mesh):
    (name, _), (axes, params, rax, rsds) = full_width
    fake = _Mesh(mesh, (16, 16) if len(mesh) == 2 else (2, 16, 16))
    for strategy in (None, "fsdp"):
        rules = sp.rules_for(get_config(name), SHAPES["train_4k"], strategy)
        specs, report = el.restore_specs(axes, params, fake, rules)
        rspecs, rreport = ref_el.restore_specs(rax, rsds, fake, rules)
        assert _port_leaves(specs) == _ref_leaves(rspecs)
        assert [dataclasses.astuple(f) for f in report.fallbacks] == [
            dataclasses.astuple(f) for f in rreport.fallbacks]
        assert report.summary() == rreport.summary()
        # the plan is the fitted one: every sharded dim divides its axes
        sizes = shd.mesh_axis_sizes(fake)
        for (path, spec), (_, leaf) in zip(_port_leaves(specs),
                                           _port_leaves_of(params)):
            for d, e in enumerate(spec):
                names = () if e is None else (e,) if isinstance(e, str) \
                    else e
                assert leaf.shape[d] % int(np.prod(
                    [sizes[a] for a in names])) == 0, path


def _port_leaves_of(tree, path=""):
    if hasattr(tree, "shape") and not hasattr(tree, "tree_children"):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _port_leaves_of(tree[k], f"{path}[{k!r}]")]
    if hasattr(tree, "tree_children"):
        return [x for i, c in enumerate(tree.tree_children())
                for x in _port_leaves_of(c, f"{path}[<flat index {i}>]")]
    return [x for i, c in enumerate(tree)
            for x in _port_leaves_of(c, f"{path}[{i}]")]


# ------------------------------------------------------- a world of one
_ONE_RANK = """
from repro_torch.checkpoint import store
from repro_torch.checkpoint.manager import CheckpointConfig, CheckpointManager
from repro_torch.dist import sharding as shd
from repro_torch.dist.elastic import shardings_for_restore
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.core.formats import INT8, INT4
from repro_torch.core.quantize import dequantize, quantize
from repro_torch.optim.compression import compressed_psum_pod
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

for fn, kw in ((make_debug_mesh, {}), (make_production_mesh, {})):
    try:
        fn(device_type="cpu", **kw)
        raise SystemExit("a mesh took a world of 1")
    except ValueError as e:
        assert "ranks" in str(e), e
mesh = make_debug_mesh(1, 1, device_type="cpu")
assert mesh.mesh_dim_names == ("data", "model")

# the reference's real-mesh round trip
params = {"wi": torch.arange(12, dtype=torch.float32).reshape(3, 4)}
paxes = {"wi": ("embed", "mlp")}
store.save_pytree("ck", 0, params)
store.mark_committed("ck", 0)
meta = {"wi": torch.empty((3, 4), device="meta")}
sh, report = shardings_for_restore(paxes, meta, mesh, dict(shd.DEFAULT_RULES))
restored = store.restore_pytree("ck", 0, meta, shardings=sh)
wi = restored["wi"]
result["roundtrip"] = dict(
    n=report.n_params, fallbacks=len(report.fallbacks),
    dtensor=isinstance(wi, DTensor), placements=str(wi.placements),
    equal=bool(torch.equal(wi.full_tensor(), params["wi"])))
mgr = CheckpointManager(CheckpointConfig(directory="ck"))
out = mgr.restore(0, {"state": meta}, shardings={"state": sh})["state"]
result["manager"] = bool(isinstance(out["wi"], DTensor) and
                         torch.equal(out["wi"].full_tensor(), params["wi"]))
# a DTensor saved gathers whole
store.save_pytree("ck", 1, {"wi": wi})
final, manifest = store.read_manifest("ck", 1, "state")
result["saved_whole"] = bool(torch.equal(
    store.load_leaf(final, manifest["leaves"][0]), params["wi"]))

# every kernel wrapper refuses a DTensor, launching nothing
from repro_torch.kernels.abfp_qdq import abfp_qdq
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention_quant import flash_attention_quant
from repro_torch.kernels.quant_matmul import (abfp_matmul, abfp_matmul_int8,
                                              quant_matmul)

def dt(t):
    return distribute_tensor(t, mesh, (Replicate(), Replicate()),
                             src_data_rank=None)

x = dt(torch.ones((4, 64)))
w = dt(torch.ones((64, 8)))
codes = dt(torch.zeros((8, 1, 64), dtype=torch.int8))
scales = dt(torch.ones((8, 1)))
q4 = dt(torch.ones((1, 1, 1, 64)))
c4 = dt(torch.zeros((1, 64, 1, 64), dtype=torch.int8))
s3 = dt(torch.ones((1, 64, 1)))
p2 = dt(torch.zeros((1, 1), dtype=torch.int32))
k2 = dt(torch.zeros((1, 64), dtype=torch.int32))
calls = {
    "abfp_qdq": lambda: abfp_qdq(x, INT8),
    "abfp_matmul": lambda: abfp_matmul(x, w, INT8, INT4),
    "abfp_matmul_int8": lambda: abfp_matmul_int8(x, w, INT8, INT4),
    "quant_matmul": lambda: quant_matmul(x, codes, scales, INT8),
    "flash_attention": lambda: flash_attention(
        dt(torch.ones((1, 4, 8))), dt(torch.ones((1, 4, 8))),
        dt(torch.ones((1, 4, 8)))),
    "flash_attention_quant": lambda: flash_attention_quant(
        q4, c4, c4, s3, s3, p2, k2, 64, scale=1.0),
}
refused = {}
for name, call in calls.items():
    try:
        call()
        refused[name] = "ran"
    except TypeError as e:
        refused[name] = "DTensor" in str(e)
result["refused"] = refused

# constrain lays a plain tensor out and redistributes a DTensor
with shd.use_rules(mesh, dict(shd.DEFAULT_RULES)):
    y = shd.constrain(torch.ones((2, 4, 8)), ("batch", "seq_res", "embed"))
    z = shd.constrain(y, ("batch", None, "embed"))
result["constrain"] = [str(y.placements), str(z.placements),
                       bool(torch.equal(z.full_tensor(), torch.ones((2, 4, 8))))]

# the pod all-reduce on a (1, 1) (pod, data) mesh is its plain arithmetic
pod = torch.distributed.device_mesh.init_device_mesh(
    "cpu", (1, 1), mesh_dim_names=("pod", "data"))
g = torch.from_numpy(np.random.RandomState(0).randn(3, 40).astype(
    np.float32))
e = torch.from_numpy(np.random.RandomState(1).randn(3, 40).astype(
    np.float32)) * 1e-3
red, enew = compressed_psum_pod({"g": g}, {"g": e}, pod)
g32 = g + e
codes_, scale_ = quantize(g32, torch.clamp_min(g32.abs().amax(), 1e-8), INT8)
plain = dequantize(codes_.to(torch.int32), scale_) / torch.tensor(1.0)
result["psum"] = [bool(torch.equal(red["g"], plain)),
                  bool(torch.equal(enew["g"], g32 - dequantize(codes_,
                                                               scale_)))]

# a RoPE / GQA decoder's sharded loss and gradients are the unsharded ones
from repro_torch.configs import get_config
from repro_torch.core.policy import preset
from repro_torch.launch import specs as sp
from repro_torch.models import build_model
from repro_torch.train.step import make_loss_and_grads

cfg = get_config("qwen2-7b").reduced()
model = build_model(cfg, device="cpu")
gen = torch.Generator()
gen.manual_seed(0)
p0 = model.init(gen)
tok = torch.from_numpy(np.random.RandomState(2).randint(
    0, cfg.vocab, (2, 16)).astype(np.int32))
batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
rules = dict(shd.DEFAULT_RULES)
psh = sp.shardings_from_axes(model.param_axes(), mesh, rules, p0)
bsh = sp.shardings_from_axes({"tokens": ("batch", None),
                              "labels": ("batch", None)}, mesh, rules, batch)
whole = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
same = []
for pol in (preset("fp32"), preset("w4a8_abfp").with_ste(True)):
    l0, _, g0 = make_loss_and_grads(model, pol)(p0, batch)
    with shd.use_rules(mesh, rules):
        l1, _, g1 = make_loss_and_grads(model, pol)(
            sp.distribute(p0, psh), sp.distribute(batch, bsh))
    same.append(bool(torch.equal(whole(l1), l0)) and all(
        torch.equal(whole(a), b) for a, b in zip(g1, g0)))
result["gqa"] = [cfg.n_heads, cfg.n_kv, same]
"""


def test_a_world_of_one(tmp_path):
    res = run_gloo_ranks(_ONE_RANK, 1, tmp_path, timeout=90)
    assert res["roundtrip"] == dict(
        n=1, fallbacks=0, dtensor=True,
        placements="(Replicate(), Shard(dim=1))", equal=True)
    assert res["manager"] and res["saved_whole"]
    assert res["refused"] == {k: True for k in (
        "abfp_qdq", "abfp_matmul", "abfp_matmul_int8", "quant_matmul",
        "flash_attention", "flash_attention_quant")}
    # (1, 1) mesh: batch over data, seq_res over model, then seq gathered
    assert res["constrain"] == ["(Shard(dim=0), Shard(dim=1))",
                                "(Shard(dim=0), Replicate())", True]
    assert res["psum"] == [True, True]
    n_heads, n_kv, same = res["gqa"]
    assert n_heads > n_kv and same == [True, True]


def test_reference_round_trip_plan_matches(tmp_path):
    """The reference's own real-mesh plan for the same leaf."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    sds = {"wi": jax.ShapeDtypeStruct((3, 4), np.float32)}
    _, rreport = ref_el.shardings_for_restore(
        {"wi": ("embed", "mlp")}, sds, mesh, dict(ref_shd.DEFAULT_RULES))
    specs, report = el.restore_specs({"wi": ("embed", "mlp")},
                                     {"wi": _meta((3, 4))}, mesh,
                                     dict(shd.DEFAULT_RULES))
    assert report.summary() == rreport.summary()
    assert _fold(specs["wi"]) == tuple(ref_shd.spec_for(
        ("embed", "mlp"), mesh=mesh, fit_shape=(3, 4)))
