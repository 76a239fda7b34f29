"""The port's sharding rules against the reference's: ``spec_for`` (the
twins of ``test_sharding_dist.py``'s spec tests), ``placements``,
``constrain`` (the object itself outside ``use_rules``, no import of
``torch.distributed.tensor`` on that path, the reference's rank error
inside), and the logical-axes trees: ``Model.param_axes()`` equals the
reference's ``axes_of(model.init(...))`` for every registered config, the
stacked (``scan_layers``) form mapped onto the port's lists."""

import subprocess
import sys

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as ref_config
from repro.configs import list_configs
from repro.dist import sharding as ref_shd
from repro.models import build_model as ref_build
from repro.nn.module import axes_of
from repro_torch.configs import get_config
from repro_torch.dist import sharding as shd
from repro_torch.models import build_model
from torch_dist_helpers import ROOT


class _FakeMesh:
    axis_names = ("pod", "data", "model")


class _SP:
    axis_names = ("data", "model")


def _same(port_spec, ref_spec):
    """The port's spec equals the reference's entry for entry.  The port
    keeps a one-name tuple entry a tuple (``P(("data",),)`` is not
    ``P("data")``, as the reference's ``spec_for`` builds them); the
    installed JAX's ``PartitionSpec`` folds such an entry into its name, so
    the comparison folds the port's the same way."""
    fold = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in port_spec)
    assert fold == tuple(ref_spec), (port_spec, ref_spec)


def test_spec_resolution_default_rules():
    rules = dict(shd.DEFAULT_RULES)
    assert rules == ref_shd.DEFAULT_RULES
    spec = shd.spec_for(("batch", None, "embed"), rules=rules,
                        mesh=_FakeMesh())
    assert spec == shd.P(("pod", "data"), None, None)
    _same(spec, ref_shd.spec_for(("batch", None, "embed"), rules=rules,
                                 mesh=_FakeMesh()))


def test_spec_drops_absent_mesh_axes():
    rules = dict(shd.DEFAULT_RULES)
    spec = shd.spec_for(("batch", "heads"), rules=rules, mesh=_SP())
    assert spec == shd.P(("data",), "model")  # 'pod' dropped, tuple kept
    assert spec != shd.P("data", "model")
    _same(spec, ref_shd.spec_for(("batch", "heads"), rules=rules, mesh=_SP()))


def test_spec_no_duplicate_axis_use():
    rules = dict(shd.DEFAULT_RULES, seq="model")
    spec = shd.spec_for(("seq", "heads"), rules=rules, mesh=_FakeMesh())
    flat = []
    for e in spec:
        if e is not None:
            flat.extend(e if isinstance(e, tuple) else (e,))
    assert flat.count("model") == 1
    _same(spec, ref_shd.spec_for(("seq", "heads"), rules=rules,
                                 mesh=_FakeMesh()))


@pytest.mark.parametrize("axes", [
    ("batch", "seq_res", "embed"), ("batch", "seq", "heads", "head_dim"),
    ("experts", "embed", "moe_mlp"), ("vocab", "embed"), (None, "qkv"),
    ("kv_seq", "batch", "mlp", "layers"), None, ()])
@pytest.mark.parametrize("mesh", [_FakeMesh(), _SP(), None])
def test_spec_for_every_rule_matches_reference(axes, mesh):
    for rules in (dict(shd.DEFAULT_RULES),
                  dict(shd.DEFAULT_RULES, batch=("pod", "data", "model"),
                       mlp=("data", "model"), seq_res=None)):
        _same(shd.spec_for(axes, rules=rules, mesh=mesh),
              ref_shd.spec_for(axes, rules=rules, mesh=mesh))


def test_spec_for_reads_the_active_rules():
    rules = {"embed": "model"}
    with shd.use_rules(_SP(), rules):
        assert shd.active()[1] == rules
        assert shd.spec_for(("embed",)) == shd.P("model")
    assert shd.active() is None
    assert shd.spec_for(("embed",)) == shd.P(None)


def test_fit_axes_matches_reference():
    sizes = {"pod": 2, "data": 16, "model": 16}
    for n in (1, 2, 6, 32, 256, 384, 512, 7):
        for names in (("pod", "data", "model"), ("data", "model"),
                      ("model", "nope")):
            kept, prod = shd.fit_axes(names, n, sizes)
            rk, rp = ref_shd.fit_axes(names, n, sizes)
            assert (kept, prod) == (list(rk), rp)


def test_is_axes_leaf_matches_reference():
    from repro_torch.nn.attention import KVCache

    for x in (None, (), ("a", None), ("a", 1), [("a",)],
              KVCache(("a",), ("b",), ()), {"a": ("b",)}):
        assert shd.is_axes_leaf(x) == ref_shd.is_axes_leaf(x)


# ---------------------------------------------------------------- placements
class _DMesh:
    """A DeviceMesh's naming surface (``mesh_dim_names`` and ``shape``)."""

    mesh_dim_names = ("pod", "data", "model")
    shape = (2, 16, 16)


def test_placements_one_per_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard

    pl = shd.placements(shd.P(("pod", "data"), None, "model"), _DMesh())
    assert pl == (Shard(0), Shard(0), Shard(2))
    assert shd.placements(shd.P(None, None), _DMesh()) == (Replicate(),) * 3
    assert shd.placements(shd.P(("data",), "model"), _SPMesh()) == (
        Shard(0), Shard(1))
    assert shd.mesh_axis_sizes(_DMesh()) == {"pod": 2, "data": 16,
                                             "model": 16}


class _SPMesh:
    mesh_dim_names = ("data", "model")
    shape = (2, 4)


def test_placements_refuse_a_tuple_out_of_mesh_order():
    with pytest.raises(ValueError, match="mesh's axis order"):
        shd.placements(shd.P(("model", "data")), _SPMesh())


# ----------------------------------------------------------------- constrain
def test_constrain_noop_outside_mesh():
    x = torch.ones((2, 2))
    assert shd.constrain(x, ("batch", "embed")) is x
    # the reference's no-op is the same value
    import jax.numpy as jnp

    y = ref_shd.constrain(jnp.ones((2, 2)), ("batch", "embed"))
    assert y.shape == tuple(x.shape)


def test_constrain_rank_mismatch_raises_the_reference_error():
    x = torch.ones((2, 3))
    with shd.use_rules(_SP(), dict(shd.DEFAULT_RULES)):
        with pytest.raises(ValueError, match="rank mismatch"):
            shd.constrain(x, ("batch",))


def test_the_unarmed_path_imports_no_dtensor():
    """Outside ``use_rules`` a whole forward and the abfp grouping never
    import ``torch.distributed.tensor`` (1.3 s, and dispatch on the serve
    path's every layer)."""
    prog = """
import sys, torch
from repro_torch.configs import get_config
from repro_torch.core.policy import preset
from repro_torch.models import build_model
m = build_model(get_config("opt-tiny").reduced(), device="cpu")
g = torch.Generator(); g.manual_seed(0)
p = m.init(g)
tok = torch.zeros((2, 8), dtype=torch.int32)
m.loss(p, {"tokens": tok, "labels": tok}, preset("w4a8_abfp"))
assert "torch.distributed.tensor" not in sys.modules
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin",
                              "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-2000:]


# --------------------------------------------------------------- axes trees
def _unstack(ax, n):
    """A stacked axes tree's leaves without their ``n`` leading "layers"."""
    if ax is None:
        return None
    if isinstance(ax, dict):
        return {k: _unstack(v, n) for k, v in ax.items()}
    assert ax[:n] == ("layers",) * n, ax
    return ax[n:]


def _reference_axes_listed(name: str, scan: bool, port_axes: dict):
    cfg = ref_config(name).reduced().replace(scan_layers=scan)
    model = ref_build(cfg)
    ax = dict(axes_of(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0)))))
    if isinstance(ax.get("blocks"), dict):
        ax["blocks"] = [_unstack(ax["blocks"], 1)] * cfg.n_layers
    for key in ("encoder", "decoder", "lora"):  # always stacked (L, ...)
        if isinstance(ax.get(key), dict):
            ax[key] = [_unstack(ax[key], 1)] * len(port_axes[key])
    if "mamba_groups" in ax:  # stacked (G, k-1, ...)
        g = port_axes["mamba_groups"]
        ax["mamba_groups"] = [[_unstack(ax["mamba_groups"], 2)]
                              * len(g[0])] * len(g)
    return ax


@pytest.mark.parametrize("name", list_configs())
def test_param_axes_equal_the_reference(name):
    model = build_model(get_config(name).reduced(), device="cpu")
    port = model.param_axes()
    for scan in (False, True):
        assert _reference_axes_listed(name, scan, port) == port, (name, scan)
    # the axes tree has the parameters' structure, leaf for leaf, and each
    # leaf names every dim of its parameter
    def check(ax, p):
        assert ax is None or len(ax) == p.ndim, (ax, tuple(p.shape))

    shd.map_axes(check, port, model.init(torch.Generator()))


def test_param_axes_equal_at_full_width():
    for name in ("qwen2-7b", "phi3.5-moe-42b-a6.6b"):
        cfg = get_config(name).replace(n_layers=2)
        port = build_model(cfg, device="meta").param_axes()
        rcfg = ref_config(name).replace(n_layers=2, scan_layers=False)
        ref = axes_of(jax.eval_shape(
            lambda: ref_build(rcfg).init(jax.random.PRNGKey(0))))
        assert ref == port


def test_partition_spec_repr_and_distinctness():
    assert repr(shd.P("data")) == "P('data')"
    assert shd.P(("data",)) != shd.P("data")
    assert tuple(JP(("pod", "data"), None)) == tuple(
        shd.P(("pod", "data"), None))
