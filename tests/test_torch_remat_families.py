"""Rematerialization in the two families whose loops the reference wraps in
plain ``jax.checkpoint`` (``models/hybrid.py``'s group body,
``models/encdec.py``'s encoder and decoder bodies): zamba2-7b and
whisper-large-v3 ``.reduced()`` on weights carried across by the bridge.

In the port, the loss and every gradient under remat "full" and "dots"
are bit-equal to "none" (both recompute the whole body, as the reference
does for any remat other than "none"), and the backward runs the bodies'
contractions again; against the reference's remat run (fp32, jitted
``value_and_grad``), the loss is held at the family tests' bars
(``test_torch_hybrid.py``: rtol 1e-6; ``test_torch_encdec.py``: rtol
1e-5) and each gradient leaf within 1e-5 of its largest entry
(``test_torch_train_step.py``'s bar), or of a hundredth of the tree's
largest entry where that is larger: a key projection's bias has no
gradient in exact arithmetic (a softmax row does not move when all its
scores move alike), and both stacks leave rounding noise there."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import policy as jp
from repro.models import build_model as j_build_model
from repro.nn.module import unbox
from repro_torch import bridge
from repro_torch import tree as tt
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import policy as tp
from repro_torch.models import build_model as t_build_model

B, S, S_ENC = 2, 12, 24
LOSS_RTOL = {"zamba2-7b": 1e-6, "whisper-large-v3": 1e-5}
ARCHS = tuple(LOSS_RTOL)


class _CountMatmuls(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                    torch.ops.aten.bmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    arch = request.param
    jcfg = j_get_config(arch).reduced()
    jparams = jax.device_get(unbox(jax.jit(j_build_model(jcfg).init)(
        jax.random.PRNGKey(0))))
    rng = np.random.RandomState(7)
    if arch == "zamba2-7b":  # nonzero LoRA B, so the folded deltas count
        for lo in jparams["lora"].values():
            lo["B"] = (rng.randn(*lo["B"].shape) * 0.05).astype(np.float32)
    toks = rng.randint(0, jcfg.vocab, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": toks, "labels": labels}
    if arch == "whisper-large-v3":
        batch["frames"] = rng.randn(B, S_ENC, jcfg.d_model).astype(
            np.float32)
    tcfg = t_get_config(arch).reduced()
    return {"arch": arch, "jcfg": jcfg, "jparams": jparams, "tcfg": tcfg,
            "tparams": bridge.from_repro_params(jparams, tcfg, device="cpu"),
            "batch": batch}


def _port_grads(f, remat: str, policy):
    """(loss, gradients in the port's leaf order, matmuls in the
    backward)."""
    model = t_build_model(f["tcfg"].replace(remat=remat), device="cpu")
    req = [p.detach().requires_grad_() for p in tt.leaves(f["tparams"])]
    loss, _ = model.loss(tt.unflatten(f["tparams"], req), f["batch"],
                         policy)
    with _CountMatmuls() as count:
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    return loss.detach(), grads, count.mm


@pytest.mark.parametrize("policy", ["fp32", "w4a8_abfp"])
def test_remat_modes_are_bit_equal(fam, policy):
    pol = tp.preset(policy)
    if policy != "fp32":
        pol = pol.with_ste(True)  # QAT, as a train step runs it
    runs = {r: _port_grads(fam, r, pol) for r in ("none", "full", "dots")}
    loss0, grads0, mm0 = runs["none"]
    for remat in ("full", "dots"):
        loss, grads, mm = runs[remat]
        assert torch.equal(loss, loss0), remat
        assert all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(grads, grads0)), remat
        # the bodies' forwards run again in the backward, contractions too
        assert mm > mm0, (remat, mm, mm0)


def test_remat_matches_the_references(fam):
    """The config's own remat ("full" for Zamba2-7B, "dots" for
    Whisper-large-v3), fp32, against the reference's checkpointed run."""
    remat = t_get_config(fam["arch"]).remat
    assert remat != "none"
    jcfg = fam["jcfg"].replace(remat=remat)
    jmodel = j_build_model(jcfg)
    fp = jp.preset("fp32")
    (want, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, fam["batch"], fp), has_aux=True))(
            fam["jparams"])
    loss, grads, _ = _port_grads(fam, remat, tp.preset("fp32"))
    np.testing.assert_allclose(float(loss), float(want),
                               rtol=LOSS_RTOL[fam["arch"]])
    want_grads = tt.leaves(bridge.from_repro_params(
        jax.device_get(jgrads), fam["tcfg"], device="cpu"))
    names = [p for p, _ in tt.flatten_with_paths(fam["tparams"])]
    assert len(want_grads) == len(grads) == len(names)
    top = max(float(w.abs().max()) for w in want_grads)
    for name, g, w in zip(names, grads, want_grads):
        g = np.zeros(w.shape, np.float32) if g is None else g.numpy()
        w = w.numpy()
        bar = 1e-5 * max(float(np.abs(w).max()), 1e-2 * top)
        assert float(np.abs(g - w).max()) <= bar, name
