"""Eight gloo ranks on a (2, 4) mesh, held to the reference's eight XLA
host devices (``test_sharding_dist.py``'s three multi-device tests, twinned)
and to the port's own unsharded run, from the reference's weights carried
across by ``bridge.from_repro_params``:

- opt-tiny's sharded train step (parameters laid out by
  ``shardings_from_axes``, the batch over ``data``, ``use_rules``): under
  fp32 the loss and the updated parameters within 1e-5 relative of the
  port's unsharded step and of the reference's 2x4 run; under w4a8_abfp
  with STE the loss finite, ``wi`` in at least 4 shards, and within twice
  the gap between the reference's own sharded and unsharded losses;
- ``compressed_psum_pod`` over a (2, 4) ``("pod", "data")`` mesh: reduced
  gradients and error feedback bit-equal to the reference's ``shard_map``
  run on the same ``g``;
- the elastic restore of a ``d_ff=130`` checkpoint the reference wrote:
  values bit-equal, the reference's fallbacks, path for path.

One launch of each side serves every test (a module fixture); the two
sides run at once.
"""

import pickle

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import store as ref_store
from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.nn.module import unbox
from repro_torch.bridge import from_repro_params
from repro_torch.configs import get_config
from repro_torch.core.policy import preset
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.train.step import (TrainStepConfig, make_loss_and_grads,
                                    make_train_step)
from repro_torch.tree import flatten_with_paths
from torch_dist_helpers import TINY, Ranks, rel_err, run_in_devices

POLICIES = ("fp32", "w4a8_abfp")

_REFERENCE = """
import dataclasses, pickle
from functools import partial
from jax.sharding import PartitionSpec as P
from repro.checkpoint import store
from repro.configs import get_config
from repro.core.policy import preset
from repro.dist import sharding as shd
from repro.dist.elastic import shardings_for_restore
from repro.launch import specs as sp
from repro.launch.mesh import make_debug_mesh
from repro.models import build_model
from repro.nn.module import axes_of
from repro.optim.adamw import AdamW
from repro.optim.compression import compressed_psum_pod
from repro.train.step import TrainStepConfig, make_train_step
try:  # jax >= 0.6
    from jax import shard_map
    _sm_kw = {"check_vma": False}
except ImportError:  # jax 0.4.x
    from jax.experimental.shard_map import shard_map
    _sm_kw = {"check_rep": False}

work = WORK
cfg = get_config("opt-tiny").replace(**TINY)
model = build_model(cfg)
paxes = axes_of(jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0))))
with open(work + "/params.pkl", "rb") as f:
    params0 = jax.tree_util.tree_map(jnp.asarray, pickle.load(f))
data = np.load(work + "/batch.npz")
batch = {k: jnp.asarray(data[k]) for k in ("tokens", "labels")}
mesh = make_debug_mesh(2, 4)
rules = dict(shd.DEFAULT_RULES)
result = {}
for name in ("fp32", "w4a8_abfp"):
    pol = preset(name) if name == "fp32" else preset(name).with_ste(True)
    opt = AdamW(lr=1e-3)
    step = jax.jit(make_train_step(model, opt, pol, TrainStepConfig()))
    p1, _, m1 = step(params0, opt.init(params0), batch)
    params = jax.device_put(params0, sp.shardings_from_axes(paxes, mesh,
                                                            rules))
    bsh = sp.shardings_from_axes({"tokens": ("batch", None),
                                  "labels": ("batch", None)}, mesh, rules)
    sbatch = jax.device_put(batch, bsh)
    with mesh, shd.use_rules(mesh, rules):
        p2, _, m2 = step(params, opt.init(params), sbatch)
        if name == "fp32":
            g2 = jax.jit(jax.grad(
                lambda p, b: model.loss(p, b, pol)[0]))(params, sbatch)
            np.savez(f"{work}/ref_fp32_grads.npz", **{
                jax.tree_util.keystr(k): np.asarray(v) for k, v in
                jax.tree_util.tree_flatten_with_path(g2)[0]})
    wi = p2["blocks"][0]["ffn"]["wi"]["kernel"]
    n_shards = len({tuple((sl.start, sl.stop) for sl in s.index)
                    for s in wi.addressable_shards})
    for tag, tree in (("unsharded", p1), ("sharded", p2)):
        np.savez(f"{work}/ref_{name}_{tag}.npz", **{
            jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]})
    result[name] = {"unsharded": float(m1["loss"]),
                    "sharded": float(m2["loss"]), "wi_shards": n_shards}

pmesh = jax.make_mesh((2, 4), ("pod", "data"))
g = jnp.asarray(data["g"])

@partial(shard_map, mesh=pmesh, in_specs=(P("pod"), P()),
         out_specs=(P(), P("pod")), **_sm_kw)
def run(gl, el):
    red, enew = compressed_psum_pod(gl[0], el[0], pmesh)
    return red[None], enew[None]

red, enew = run(g, jnp.zeros((2, g.shape[1]), jnp.float32))
np.savez(work + "/ref_psum.npz", red=np.asarray(red)[0],
         enew=np.asarray(enew))

cfg130 = cfg.replace(d_ff=130)
m130 = build_model(cfg130)
boxes = jax.eval_shape(lambda: m130.init(jax.random.PRNGKey(0)))
sds = jax.tree_util.tree_map(lambda b: b.value, boxes,
                             is_leaf=lambda b: hasattr(b, "axes"))
sh, report = shardings_for_restore(axes_of(boxes), sds, mesh, rules)
restored = store.restore_pytree(work + "/ck130", 1, sds, shardings=sh)
np.savez(work + "/ref_restored.npz", **{
    jax.tree_util.keystr(k): np.asarray(v) for k, v in
    jax.tree_util.tree_flatten_with_path(restored)[0]})
wi = restored["blocks"][0]["ffn"]["wi"]["kernel"]
result["elastic"] = {
    "fallbacks": [list(dataclasses.astuple(f)) for f in report.fallbacks],
    "summary": report.summary(),
    "wi_shards": len({tuple((sl.start, sl.stop) for sl in s.index)
                      for s in wi.addressable_shards})}
"""

_RANKS = """
import dataclasses, logging, pickle
logging.disable(logging.WARNING)
from repro_torch.bridge import from_repro_params
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.core.policy import preset
from repro_torch.dist import sharding as shd
from repro_torch.dist.elastic import shardings_for_restore
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.compression import compressed_psum_pod
from repro_torch.train.step import (TrainStepConfig, make_loss_and_grads,
                                    make_train_step)
from repro_torch.tree import flatten_with_paths, tree_map
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

TINY = %r
cfg = get_config("opt-tiny").replace(**TINY)
model = build_model(cfg, device="cpu")
with open("params.pkl", "rb") as f:
    params0 = from_repro_params(pickle.load(f), cfg, device="cpu")
data = np.load("batch.npz")
batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "labels")}
mesh = make_debug_mesh(2, 4, device_type="cpu")
rules = dict(shd.DEFAULT_RULES)
psh = sp.shardings_from_axes(model.param_axes(), mesh, rules, params0)
bsh = sp.shardings_from_axes({"tokens": ("batch", None),
                              "labels": ("batch", None)}, mesh, rules, batch)

def shards(t):
    # distinct chunks of t over the mesh (the reference counts distinct
    # index tuples of its addressable shards)
    coords = [None] * world
    dist.all_gather_object(coords, mesh.get_coordinate())
    pl = t.placements
    return len({tuple(c[i] for i, p in enumerate(pl) if p.is_shard())
                for c in coords})

def whole(tree):
    return {p.replace("/", ""): (v.full_tensor() if isinstance(v, DTensor)
                                 else v).numpy()
            for p, v in flatten_with_paths(tree)}

for name in ("fp32", "w4a8_abfp"):
    pol = preset(name) if name == "fp32" else preset(name).with_ste(True)
    params = sp.distribute(tree_map(torch.clone, params0), psh)
    opt = AdamW(lr=1e-3)
    step = make_train_step(model, opt, pol, TrainStepConfig())
    sbatch = sp.distribute(batch, bsh)
    with shd.use_rules(mesh, rules):
        if name == "fp32":
            _, _, grads = make_loss_and_grads(model, pol)(params, sbatch)
            grads = {p.replace("/", ""): g.full_tensor().numpy()
                     for (p, _), g in zip(flatten_with_paths(params), grads)}
            if rank == 0:
                np.savez("port_fp32_grads.npz", **grads)
        p2, _, m = step(params, opt.init(params), sbatch)
    loss = m["loss"]
    loss = loss.full_tensor() if isinstance(loss, DTensor) else loss
    wi = p2["blocks"][0]["ffn"]["wi"]["kernel"]
    out = whole(p2)
    result[name] = {"loss": float(loss), "wi_shards": shards(wi),
                    "wi_placements": str(wi.placements)}
    if rank == 0:
        np.savez(f"port_{name}.npz", **out)

pmesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("pod", "data"))
pod = pmesh.get_coordinate()[0]
g = torch.from_numpy(data["g"][pod])
red, enew = compressed_psum_pod({"g": g}, {"g": torch.zeros_like(g)}, pmesh)
got = [None] * world
dist.all_gather_object(got, (pod, red["g"].numpy(), enew["g"].numpy()))
if rank == 0:
    np.savez("port_psum.npz", red=np.stack([r for _, r, _ in got]),
             pods=np.array([p for p, _, _ in got]),
             enew=np.stack([e for _, _, e in got]))

m130 = build_model(cfg.replace(d_ff=130), device="meta")
meta = m130.init(torch.Generator())
sh, report = shardings_for_restore(m130.param_axes(), meta, mesh, rules)
restored = store.restore_pytree("ck130", 1, meta, shardings=sh)
wi = restored["blocks"][0]["ffn"]["wi"]["kernel"]
out = whole(restored)
result["elastic"] = {
    "fallbacks": [list(dataclasses.astuple(f)) for f in report.fallbacks],
    "summary": report.summary(), "wi_shards": shards(wi),
    "dtensors": all(isinstance(v, DTensor)
                    for _, v in flatten_with_paths(restored))}
if rank == 0:
    np.savez("port_restored.npz", **out)
"""


def _policy(name):
    return preset(name) if name == "fp32" else preset(name).with_ste(True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("dist_ranks")
    cfg = ref_config("opt-tiny").replace(**TINY)
    params = jax.tree_util.tree_map(np.asarray, unbox(jax.jit(
        ref_build(cfg).init)(jax.random.PRNGKey(0))))
    with open(work / "params.pkl", "wb") as f:
        pickle.dump(params, f)
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, cfg.vocab, (8, 32)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    g = np.random.RandomState(1).randn(2, 256).astype(np.float32)
    np.savez(work / "batch.npz", tokens=tokens, labels=labels, g=g)
    p130 = jax.tree_util.tree_map(np.asarray, unbox(jax.jit(ref_build(
        cfg.replace(d_ff=130)).init)(jax.random.PRNGKey(0))))
    ref_store.save_pytree(str(work / "ck130"), 1, p130)
    ref_store.mark_committed(str(work / "ck130"), 1)

    ranks = Ranks(_RANKS % (TINY,), 8, work, timeout=150)
    ref_code = _REFERENCE.replace("WORK", repr(str(work))).replace(
        "**TINY", "**" + repr(TINY))
    ref = run_in_devices(ref_code, timeout=240)
    # the port's unsharded steps, while the ranks run
    pcfg = get_config("opt-tiny").replace(**TINY)
    model = build_model(pcfg, device="cpu")
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    plain = {}
    for name in POLICIES:
        p0 = from_repro_params(params, pcfg, device="cpu")
        if name == "fp32":
            _, _, grads = make_loss_and_grads(model, _policy(name))(p0, batch)
            plain["grads"] = {p.replace("/", ""): g.numpy() for (p, _), g in
                              zip(flatten_with_paths(p0), grads)}
        opt = AdamW(lr=1e-3)
        p1, _, m = make_train_step(model, opt, _policy(name),
                                   TrainStepConfig())(p0, opt.init(p0), batch)
        plain[name] = {"loss": float(m["loss"]), "params": {
            p.replace("/", ""): v.numpy() for p, v in flatten_with_paths(p1)}}
    port = ranks.result()
    return {"work": work, "ref": ref, "port": port, "plain": plain,
            "p130": p130}


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def test_fp32_sharded_step_matches_unsharded_and_reference(runs):
    """The loss and every gradient within 1e-5 relative (of the leaf's
    largest) of the port's unsharded step and of the reference's 2x4 run.
    The updated parameters are held at 1e-5 relative of the leaf's largest
    on every element whose gradient is at least 100 x AdamW's eps on both
    sides: Adam's first step moves a weight by lr * g / (|g| + eps), so a
    gradient near eps (these are 1e-10..1e-8 of 5e-3) turns a last-bit
    change of its sum into a change of up to 2 lr, which the reference's
    own 2x4 step shows against its unsharded one (1.1e-4 relative on
    blocks.1's wo).  There each element is held within 2 lr; an element
    whose gradient is 0 on both sides is held like the others."""
    work, port, ref, plain = (runs["work"], runs["port"]["fp32"],
                              runs["ref"]["fp32"], runs["plain"]["fp32"])
    assert np.isfinite(port["loss"])
    assert abs(port["loss"] - plain["loss"]) <= 1e-5 * abs(plain["loss"])
    assert abs(port["loss"] - ref["sharded"]) <= 1e-5 * abs(ref["sharded"])
    grads = _npz(work / "port_fp32_grads.npz")
    ref_grads = _npz(work / "ref_fp32_grads.npz")
    assert set(grads) == set(ref_grads) == set(runs["plain"]["grads"])
    for k in grads:
        assert rel_err(grads[k], runs["plain"]["grads"][k]) <= 1e-5, k
        assert rel_err(grads[k], ref_grads[k]) <= 1e-5, k
    ours = _npz(work / "port_fp32.npz")
    theirs = _npz(work / "ref_fp32_sharded.npz")
    assert set(ours) == set(theirs) == set(plain["params"])
    lr, eps = 1e-3, AdamW(lr=1e-3).eps
    for k in ours:
        g = np.minimum(np.abs(runs["plain"]["grads"][k]), np.abs(ref_grads[k]))
        well = (g >= 100 * eps) | (np.maximum(np.abs(
            runs["plain"]["grads"][k]), np.abs(ref_grads[k])) == 0)
        for other in (plain["params"][k], theirs[k]):
            diff = np.abs(ours[k] - other)
            assert diff[well].max(initial=0) <= 1e-5 * np.abs(other).max(), k
            assert diff.max() <= 2 * lr * (1 + 1e-3), k
    assert port["wi_shards"] == ref["wi_shards"] == 4


def test_w4a8_qat_sharded_step(runs):
    port, ref, plain = (runs["port"]["w4a8_abfp"], runs["ref"]["w4a8_abfp"],
                        runs["plain"]["w4a8_abfp"])
    assert np.isfinite(port["loss"])
    assert port["wi_shards"] >= 4 and ref["wi_shards"] >= 4
    assert port["wi_placements"] == "(Replicate(), Shard(dim=1))"
    gap = abs(ref["sharded"] - ref["unsharded"])
    assert abs(port["loss"] - plain["loss"]) <= 2 * gap, (port, plain, ref)


def test_compressed_psum_pod_bit_equal_to_reference(runs):
    ours = _npz(runs["work"] / "port_psum.npz")
    theirs = _npz(runs["work"] / "ref_psum.npz")
    for r, pod in enumerate(ours["pods"]):
        np.testing.assert_array_equal(ours["red"][r], theirs["red"])
        np.testing.assert_array_equal(ours["enew"][r], theirs["enew"][pod])
    g = _npz(runs["work"] / "batch.npz")["g"]
    assert np.abs(theirs["red"] - g.mean(0)).max() <= 2.1 * np.abs(
        g).max() / 127
    assert np.abs(theirs["enew"]).max() > 0


def test_elastic_restore_onto_a_2x4_mesh(runs):
    ours, ref = runs["port"]["elastic"], runs["ref"]["elastic"]
    assert ours["fallbacks"] == ref["fallbacks"] and ours["fallbacks"]
    assert ours["summary"] == ref["summary"]
    assert ours["dtensors"]
    # d_ff=130 can't shard 4-way: wi keeps one chunk, as the reference's
    assert ours["wi_shards"] == ref["wi_shards"]
    restored = _npz(runs["work"] / "port_restored.npz")
    theirs = _npz(runs["work"] / "ref_restored.npz")
    saved = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(runs["p130"])[0]}
    assert set(restored) == set(saved) == set(theirs)
    for k in saved:
        np.testing.assert_array_equal(restored[k], saved[k])
        np.testing.assert_array_equal(theirs[k], saved[k])
