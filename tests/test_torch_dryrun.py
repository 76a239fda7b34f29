"""The port's dry run (``launch.dryrun``, ``launch.traced``) against the
reference's (``repro.launch.dryrun``):

- the lint gate's record (qwen2-7b ``train_4k --compress``: QL204, before
  any process group or mesh) and a skipped cell's record, field for field;
- parity at reduced size: the reference compiles ``build_cell``'s step on 8
  XLA host devices (a subprocess), the port traces it on ``meta`` DTensors
  over a fake group of 8 ranks, both on the (2, 4) ("data", "model") mesh;
  the argument, output and alias bytes of the memory analyses are held
  equal (a differing argument is listed leaf by leaf on both sides; XLA's
  output size holds its output tuple too, 8 bytes an output; at a Whisper
  decode step the port reads the cross-attention's K and V projection
  weights that XLA prunes), and so
  are ``policy_bits``, ``weight_bytes`` (``--compress``), the mesh, the
  chip count and ``model_flops_per_device``;
- the counters: one ``Dense`` on the (2, 4) mesh counts the local
  product's FLOPs, an unsharded 1-layer fp32 forward counts the
  hand-counted FLOPs, meta and CPU tensors count the same, and pass 1's
  totals equal the extrapolated ones for a config whose layers cost the
  same;
- importing ``launch.dryrun`` makes no process group and leaves CUDA
  uninitialised.

Nothing here allocates on a card; the fake group is destroyed after the
module's tests.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.policy import preset, with_kv_cache
from repro_torch.dist import sharding as shd
from repro_torch.launch import roofline as rf
from repro_torch.launch import specs as sp
from repro_torch.tree import flatten_with_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, BATCH = 64, 8
# (arch, shape kind, --compress, --kv-int8)
CELLS = (
    ("qwen2-7b", "train", False, False),
    ("qwen2-7b", "decode", False, False),
    ("qwen2-7b", "decode", True, True),
    ("mamba2-130m", "decode", False, False),
    ("zamba2-7b", "decode", False, False),
    ("whisper-large-v3", "decode", False, False),
    ("phi3.5-moe-42b-a6.6b", "decode", False, False),
    ("vit-b16", "prefill", False, False),
)
SHAPE_NAMES = {"train": "train_4k", "prefill": "prefill_32k",
               "decode": "decode_32k"}

REF_SCRIPT = r"""
import json, os, sys
import jax
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.core.policy import preset, with_kv_cache
from repro.dist import sharding as shd
from repro.launch import roofline as rf, specs as sp
from repro.launch.dryrun import build_cell
from repro.launch.mesh import make_debug_mesh

cells, seq, batch, names = json.loads(sys.argv[1])
mesh = make_debug_mesh()
out = []
for arch, kind, compress, kv8 in cells:
    cfg = get_config(arch).reduced().replace(
        dtype="bfloat16", param_dtype="bfloat16", scan_layers=False)
    shape = ShapeSpec(names[kind], seq, batch, kind)
    pol = preset("w4a8_abfp", n_layers=cfg.n_layers)
    if kind == "train":
        pol = pol.with_ste(True)
    if kv8:
        pol = with_kv_cache(pol, "int8")
    rules = sp.fit_batch_rule(sp.rules_for(cfg, shape), batch, mesh)
    fn, args, ins, outs, don, info = build_cell(cfg, shape, pol, mesh,
                                                rules, compress=compress)
    with mesh, shd.use_rules(mesh, rules):
        c = jax.jit(fn, in_shardings=ins, out_shardings=outs,
                    donate_argnums=don).lower(*args).compile()
    leaves = []
    for i, (a, s) in enumerate(zip(args, c.input_shardings[0])):
        flat, _ = jax.tree_util.tree_flatten_with_path(a)
        shs = jax.tree_util.tree_leaves(
            s, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
        rows = []
        try:
            for (path, leaf), sh in zip(flat, shs, strict=True):
                n = leaf.dtype.itemsize
                for d in sh.shard_shape(leaf.shape):
                    n *= d
                rows.append([i, jax.tree_util.keystr(path), n])
        except (ValueError, IndexError):  # a prefix tree of shardings
            rows = []
        leaves.extend(rows)
    out.append({"memory": rf.memory_dict(c), "leaves": leaves,
                "n_out": len(jax.tree_util.tree_leaves(
                    jax.eval_shape(fn, *args))),
                "weight_bytes": info.get("weight_bytes"),
                "policy_bits": rf.policy_bits_report(cfg, pol),
                "mesh": dict(zip(mesh.axis_names, mesh.devices.shape)),
                "chips": int(mesh.devices.size),
                "model_flops": rf.model_flops(cfg, shape, mesh.devices.size)})
print("RESULT" + json.dumps(out))
"""


def _cell(arch, kind, kv8):
    cfg = get_config(arch).reduced().replace(
        dtype="bfloat16", param_dtype="bfloat16", scan_layers=False)
    shape = ShapeSpec(SHAPE_NAMES[kind], SEQ, BATCH, kind)
    pol = preset("w4a8_abfp", n_layers=cfg.n_layers)
    if kind == "train":
        pol = pol.with_ste(True)
    if kv8:
        pol = with_kv_cache(pol, "int8")
    return cfg, shape, pol


@pytest.fixture(scope="module")
def reference():
    """The reference's records of ``CELLS``, from one subprocess with 8
    XLA host devices."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT,
         json.dumps([CELLS, SEQ, BATCH, SHAPE_NAMES])],
        capture_output=True, text=True, env=env, timeout=600)
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT")]
    assert line, p.stderr[-3000:]
    return json.loads(line[0][len("RESULT"):])


@pytest.fixture(scope="module")
def mesh():
    """A fake world of 8 ranks and its (2, 4) mesh; destroyed after the
    module's tests."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_debug_mesh

    fake_world(8)
    try:
        yield make_debug_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ records
def test_gate_record_is_the_references():
    from repro.launch.dryrun import run_cell as ref_run_cell
    from repro_torch.launch.dryrun import run_cell

    import torch.distributed as dist

    got = run_cell("qwen2-7b", "train_4k", compress=True)
    assert not dist.is_initialized()  # the gate comes before any group
    assert got["status"] == "lint_error"
    assert any(d["code"] == "QL204" for d in got["lint"])
    assert got == ref_run_cell("qwen2-7b", "train_4k", compress=True)


def test_skipped_record_is_the_references():
    from repro.launch.dryrun import run_cell as ref_run_cell
    from repro_torch.launch.dryrun import run_cell

    got = run_cell("vit-b16", "decode_32k")
    assert got["status"] == "skipped"
    assert got == ref_run_cell("vit-b16", "decode_32k")


def test_cli_gate_exits_1(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-7b", "--shape", "train_4k", "--compress", "--out-dir",
         str(tmp_path)], capture_output=True, text=True, env=env,
        timeout=300)
    assert p.returncode == 1 and "QL204" in p.stdout, p.stdout + p.stderr
    assert not list(tmp_path.iterdir())  # the gate returns before writing


def test_import_makes_no_group_and_leaves_cuda_alone():
    code = ("import torch, torch.distributed as dist\n"
            "import repro_torch.launch.dryrun\n"
            "print(dist.is_initialized(), torch.cuda.is_initialized())")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert p.stdout.split() == ["False", "False"], p.stderr


# ------------------------------------------------------------------ parity
def _port_leaves(args) -> list:
    from repro_torch.launch.traced import _tensors, local_tensor

    out = []
    for i, a in enumerate(args):
        for path, leaf in flatten_with_paths(a):
            for t in map(local_tensor, _tensors(leaf)):
                out.append([i, path, t.numel() * t.element_size()])
    return out


def _by_arg(leaves) -> dict:
    out = {}
    for i, _, n in leaves:
        out[i] = out.get(i, 0) + n
    return out


@pytest.mark.parametrize("k", range(len(CELLS)),
                         ids=["-".join(map(str, c)) for c in CELLS])
def test_memory_matches_the_references(reference, mesh, k):
    from repro_torch.launch.dryrun import build_cell
    from repro_torch.launch.traced import trace_step

    arch, kind, compress, kv8 = CELLS[k]
    cfg, shape, pol = _cell(arch, kind, kv8)
    rules = sp.fit_batch_rule(sp.rules_for(cfg, shape), BATCH, mesh)
    fn, args, donate, info = build_cell(cfg, shape, pol, mesh, rules,
                                        compress=compress)
    leaves = _port_leaves(args)
    with shd.use_rules(mesh, rules):
        traced = trace_step(fn, args, donate)
    ref = reference[k]
    got_args, want_args = _by_arg(leaves), _by_arg(ref["leaves"])
    for i in want_args:  # the arguments whose leaves the reference lists
        assert got_args.get(i) == want_args[i], (
            f"argument {i}: port leaves "
            f"{[(p, n) for j, p, n in leaves if j == i]} vs reference "
            f"{[(p, n) for j, p, n in ref['leaves'] if j == i]}")
    got = rf.memory_dict(traced)
    # XLA's output size also holds the output tuple: a pointer (8 bytes)
    # to each of its output buffers
    want = dict(ref["memory"])
    want["output_size_in_bytes"] -= 8 * ref["n_out"]
    if cfg.family == "encdec" and kind == "decode":
        # the port's cross-attention projects K and V of the decoder input
        # and replaces them by the state's (as the reference's code does;
        # XLA prunes the two projections, so it never reads their weights)
        want["argument_size_in_bytes"] += sum(
            n for i, p, n in leaves if i == 0 and "cross_attn" in p
            and ("['k']" in p or "['v']" in p))
    for key in ("argument_size_in_bytes", "output_size_in_bytes",
                "alias_size_in_bytes"):
        assert got[key] == want[key], (key, got, ref["memory"])
    assert info.get("weight_bytes") == ref["weight_bytes"]
    assert rf.policy_bits_report(cfg, pol) == ref["policy_bits"]
    assert shd.mesh_axis_sizes(mesh) == ref["mesh"]
    assert mesh.size() == ref["chips"]
    assert rf.model_flops(cfg, shape, mesh.size()) == ref["model_flops"]
    assert got["temp_size_in_bytes"] >= 0


# ---------------------------------------------------------------- counters
def test_dense_on_the_mesh_counts_the_local_product(mesh):
    from repro_torch.launch.traced import trace_step
    from repro_torch.nn.linear import Dense

    B, S, K, N = 8, 16, 64, 128
    dense = Dense(K, N, param_dtype="float32", dtype="float32", name="d",
                  in_axis="embed", out_axis="mlp")
    params = dense.init(torch.Generator(), "meta")
    rules = dict(shd.DEFAULT_RULES, seq_res=None)
    psh = sp.shardings_from_axes(dense.axes(), mesh, rules, params)
    xsh = sp.shardings_from_axes(("batch", None, "embed"), mesh, rules)
    x = xsh.distribute(torch.empty(B, S, K, device="meta"))
    with shd.use_rules(mesh, rules):
        traced = trace_step(lambda p, x: dense.apply(p, x, preset("fp32")),
                            (sp.distribute(params, psh), x))
    assert traced.flops == 2 * (B // 2 * S) * K * (N // 4)


def test_unsharded_forward_counts_the_hand_counted_flops():
    """A 1-layer fp32 qwen2-7b .reduced() forward, no mesh: every matmul
    of the block and the head, by hand."""
    from repro_torch.launch.traced import trace_step
    from repro_torch.models import build_model

    cfg = get_config("qwen2-7b").reduced().replace(n_layers=1)
    model = build_model(cfg, device="meta")
    params = model.init(torch.Generator())
    B, S = 2, 16
    toks = torch.zeros(B, S, dtype=torch.int32, device="meta")
    traced = trace_step(lambda p, t: model.apply(p, {"tokens": t},
                                                 preset("fp32"))[0],
                        (params, toks))
    d, hd, H, KV, f = (cfg.d_model, cfg.head_dim_, cfg.n_heads, cfg.n_kv,
                       cfg.d_ff)
    M = B * S
    proj = 2 * M * d * (H * hd + 2 * KV * hd) + 2 * M * (H * hd) * d
    attn = 2 * (2 * B * H * S * S * hd)  # scores and probs @ V
    mlp = 2 * M * d * f * 2 + 2 * M * f * d  # wi, wg, wo
    head = 2 * M * d * cfg.vocab_padded
    assert traced.flops == proj + attn + mlp + head


def test_meta_and_cpu_count_the_same(mesh):
    """The same step on ``meta`` and on CPU tensors: equal FLOPs, bytes,
    collectives and argument, output and alias bytes, and the predicted
    peaks within 10 % (a meta kernel's strides can differ from the CPU
    kernel's, so a later reshape copies on one device and views on the
    other; ``chip_smoke.py``'s dryrun phase holds a card run so)."""
    from repro_torch.launch.traced import trace_step
    from repro_torch.models import build_model

    cfg = get_config("qwen2-7b").reduced()
    rules = sp.fit_batch_rule(sp.rules_for(cfg, sp_shape := ShapeSpec(
        "train_4k", 16, 8, "train")), 8, mesh)
    got = {}
    for device in ("meta", "cpu"):
        model = build_model(cfg, device=device)
        params = model.init(torch.Generator(device=device)
                            if device != "meta" else torch.Generator())
        batch, axes = sp.batch_specs(cfg, sp_shape)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                 for k, v in batch.items()}
        psh = sp.shardings_from_axes(model.param_axes(), mesh, rules, params)
        bsh = sp.shardings_from_axes(axes, mesh, rules)
        with shd.use_rules(mesh, rules):
            t = trace_step(lambda p, b: model.loss(p, b, preset("fp32"))[0],
                           (sp.distribute(params, psh),
                            sp.distribute(batch, bsh)))
        mem = dict(t.memory)
        peak = (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
                + mem.pop("temp_size_in_bytes") - mem["alias_size_in_bytes"])
        got[device] = (t.flops, t.bytes_accessed, t.collectives, mem, peak)
    assert got["meta"][:4] == got["cpu"][:4]
    assert abs(got["meta"][4] - got["cpu"][4]) <= 0.1 * got["cpu"][4]
    assert got["meta"][2]  # the sharded loss issued collectives


def test_pass1_equals_the_extrapolation_for_uniform_layers(mesh):
    """qwen2-7b .reduced() at 4 layers: the traced totals equal
    ``extrapolate`` of the 1- and 2-layer cells."""
    from repro_torch.launch.dryrun import build_cell
    from repro_torch.launch.traced import trace_step

    cfg, shape, pol = _cell("qwen2-7b", "decode", False)
    rules = sp.fit_batch_rule(sp.rules_for(cfg, shape), BATCH, mesh)
    costs = {}
    for n in (1, 2, 4):
        fn, args, donate, _ = build_cell(cfg.replace(n_layers=n), shape, pol,
                                         mesh, rules)
        with shd.use_rules(mesh, rules):
            costs[n] = rf.extract_costs(trace_step(fn, args, donate))
    ext = rf.extrapolate(costs[1], costs[2], periods=4)
    for key in ("flops", "bytes", "collective_bytes"):
        assert ext[key] == costs[4][key], key
    assert costs[4]["flops"] > 0 and costs[4]["collective_bytes"] > 0
