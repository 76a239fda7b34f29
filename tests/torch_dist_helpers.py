"""Multi-device harnesses shared by the distribution tests.

``run_in_devices`` is the reference's subprocess harness
(``tests/test_sharding_dist.py``): a JAX program over ``n`` forced host
devices, its ``result`` dict printed as JSON.  ``run_gloo_ranks`` runs a
body of PyTorch code in ``world`` processes joined by a ``gloo`` process
group over a ``file://`` store (no TCP port is chosen by the test), each
group created with a timeout of at most 60 s; it joins the ranks with a
deadline, kills stragglers, and fails with every rank's stderr.  Rank 0's
``result`` dict comes back.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the reduced opt-tiny of the reference's sharded-step test
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
            d_ff=128, vocab=512, scan_layers=False)


def _env(**extra) -> dict:
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    if "TMPDIR" in os.environ:
        env["TMPDIR"] = os.environ["TMPDIR"]
    env.update(extra)
    return env


def run_in_devices(code: str, n: int = 8, timeout: int = 300) -> dict:
    """The reference's harness: ``code`` under ``n`` XLA host devices."""
    prog = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n}"
        import json
        import jax
        import jax.numpy as jnp
        import numpy as np
        {textwrap.indent(textwrap.dedent(code), '        ').strip()}
        print("RESULT:" + json.dumps(result))
    """)
    return _result(start_devices(prog), timeout, "the reference's devices")


def start_devices(prog: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", prog], cwd=ROOT,
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _result(proc: subprocess.Popen, timeout: float, what: str) -> dict:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"{what} passed {timeout} s:\n{err[-3000:]}")
    assert proc.returncode == 0, f"{what} failed:\n{err[-3000:]}"
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULT:")]
    assert lines, f"{what} printed no result:\n{out[-2000:]}{err[-2000:]}"
    return json.loads(lines[-1][len("RESULT:"):])


_RANK = """
import datetime, json, os, sys
import numpy as np
import torch
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
store = sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=60))
result = {}
%s
if rank == 0:
    print("RESULT:" + json.dumps(result), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


class Ranks:
    """``world`` started rank processes; ``result()`` joins them."""

    def __init__(self, body: str, world: int, workdir, timeout: float = 120):
        workdir = pathlib.Path(workdir)
        workdir.mkdir(parents=True, exist_ok=True)
        store = workdir / "gloo_store"
        if store.exists():
            store.unlink()
        prog = _RANK % textwrap.dedent(body).strip()
        self.timeout, self.procs, self.logs = timeout, [], []
        for r in range(world):  # output to files: no pipe fills and blocks
            out = open(workdir / f"rank{r}.out", "w+")
            err = open(workdir / f"rank{r}.err", "w+")
            self.logs.append((out, err))
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", prog, str(r), str(world), str(store)],
                cwd=workdir, env=_env(), stdout=out, stderr=err, text=True))

    def result(self) -> dict:
        deadline = time.monotonic() + self.timeout
        try:
            for p in self.procs:
                try:
                    p.wait(timeout=max(deadline - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    pass
        finally:
            for p in self.procs:  # no rank outlives its test
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for out, err in self.logs:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
            out.close()
            err.close()
        tails = [f"--- rank {r} (rc {p.returncode}):\n{texts[r][1][-2500:]}"
                 for r, p in enumerate(self.procs) if p.returncode != 0]
        if tails:
            raise AssertionError(
                f"gloo ranks failed or passed {self.timeout} s:\n"
                + "\n".join(tails))
        lines = [ln for ln in texts[0][0].splitlines()
                 if ln.startswith("RESULT:")]
        assert lines, f"rank 0 printed no result:\n{texts[0][0][-2000:]}"
        return json.loads(lines[-1][len("RESULT:"):])


def run_gloo_ranks(body: str, world: int, workdir,
                   timeout: float = 120) -> dict:
    """Run ``body`` (it sets entries of ``result``; ``rank``, ``world``,
    ``dist`` and ``torch`` are in scope) on ``world`` gloo ranks."""
    return Ranks(body, world, workdir, timeout).result()


def full_width_trees(name: str, compressed: bool):
    """(port axes, port meta params, reference axes, reference shapes) of
    ``name`` at full width and 2 layers, dense or compressed (w4a8_abfp)."""
    import jax

    from repro.configs import get_config as ref_config
    from repro.core.policy import preset as ref_preset
    from repro.models import build_model as ref_build
    from repro.models import serving_transforms as ref_st
    from repro.nn.module import axes_of
    from repro_torch.configs import get_config
    from repro_torch.core.policy import preset
    from repro_torch.models import build_model
    from repro_torch.models import serving_transforms as st

    cfg = get_config(name).replace(n_layers=2)
    model = build_model(cfg, device="meta")
    params = model.init(torch.Generator())
    axes = model.param_axes()
    rcfg = ref_config(name).replace(n_layers=2, scan_layers=False)
    boxes = jax.eval_shape(lambda: ref_build(rcfg).init(
        jax.random.PRNGKey(0)))
    rax = axes_of(boxes)
    rsds = jax.tree_util.tree_map(lambda b: b.value, boxes,
                                  is_leaf=lambda b: hasattr(b, "axes"))
    if compressed:
        params = st.compress_weights(params, preset("w4a8_abfp"))
        axes = st.compress_axes(axes, params)
        rsds = jax.eval_shape(lambda p: ref_st.compress_weights(
            p, ref_preset("w4a8_abfp")), rsds)
        rax = ref_st.compress_axes(rax, rsds)
    return axes, params, rax, rsds


def rel_err(a, b) -> float:
    """max |a - b| / max |b| (0 for two zero arrays)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else float(
        np.abs(a - b).max())
