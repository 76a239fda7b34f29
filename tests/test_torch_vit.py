"""The vision family in the port vs the reference, on weights carried across
by the bridge: ``extract_patches`` and ``PatchEmbed``, the encoder's logits
under the paper's vision policies and the fused P-fp / P-int8 policies
(every matmul through ``abfp_matmul`` / ``abfp_matmul_int8``, every
attention call through the non-causal ``flash_attention``; on the CPU each
wrapper runs its plain version, the reference its Pallas kernels in
interpret mode), the mean-pool readout, ``loss``, the padded classes, the
configs, the synthetic images and their loaders, and the launcher's exit.

Tolerance: rtol 1e-4, atol 1e-4 on logits and losses (f32 contractions
summed in another order; quantizer codes agree at this size), as the opt
parity tests hold theirs.  Patches, images and batches: bit-equal.

The reference's init and forwards run jitted (one compile each): op by op
it spends two to three times as long compiling the same primitives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import policy as jp
from repro.data import images as j_images
from repro.models import build_model as j_build_model
from repro.nn import patch_embed as j_pe
from repro.nn.module import unbox
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import list_configs
from repro_torch.core import policy as tp
from repro_torch.data import images as t_images
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import quant_matmul as t_qm
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as t_build_model
from repro_torch.nn import patch_embed as t_pe

TOL = dict(rtol=1e-4, atol=1e-4)
N_GROUP = 32  # divides every width of both configs (64, 96, 128, 192)
B = 2
POLICIES = ("fp32", "w4a4_abfp", "w4a8_abfp", "w4a4_e2m1", "w4a4_e1m2",
            "w4a8_int8_native", "p_fp", "p_int8")


def _vit_cfg(mod):
    return mod("vit-b16").reduced()


def _deit_proxy(mod):
    """The reference benchmarks' DeiT proxy dims (benchmarks/common.py)."""
    return mod("deit-s16").reduced().replace(
        n_layers=3, d_model=96, n_heads=6, n_kv=6, head_dim=16, d_ff=192)


CONFIGS = {"vit": _vit_cfg, "deit": _deit_proxy}


def _policy(mod, name):
    """A policy of either stack; p_fp / p_int8: the fused paths (``fused``
    on every entry, the ``fused`` attention backend; P-fp without
    attention-BMM QDQ, so attention takes the flash kernel)."""
    if name == "fp32":
        return mod.preset("fp32")
    fused = lambda p: mod.map_policies(p, lambda q: q.replace(fused=True))
    if name == "p_int8":
        return mod.with_attn_backend(
            fused(mod.preset("w4a8_int8_native", n=N_GROUP)), "fused")
    if name == "p_fp":
        pol = mod.map_policies(mod.preset("w4a8_abfp", n=N_GROUP),
                               lambda q: q.replace(attn_bmm=False))
        return mod.with_attn_backend(fused(pol), "fused")
    return mod.preset(name, n=N_GROUP)


def _images(cfg, seed, batch=B):
    return np.random.RandomState(seed).randn(
        batch, cfg.image_size, cfg.image_size, cfg.n_channels).astype(
            np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _build(name):
    """Both stacks of one config, the reference's weights carried across."""
    jcfg = CONFIGS[name](j_get_config)
    jmodel = j_build_model(jcfg)
    jparams = unbox(jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    tcfg = CONFIGS[name](t_get_config)
    tmodel = t_build_model(tcfg, device="cpu")
    tparams = bridge.from_repro_params(jax.device_get(jparams), tcfg,
                                       device="cpu")
    return jcfg, jmodel, jparams, tcfg, tmodel, tparams


@pytest.fixture(scope="module")
def vit_stacks():
    return _build("vit")


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def stacks(request, vit_stacks):
    return vit_stacks if request.param == "vit" else _build(request.param)


def _ref_logits(jmodel, jparams, images, jpol):
    fn = jax.jit(lambda p, x: jmodel.apply(p, {"images": x}, jpol)[0])
    return fn(jparams, jnp.asarray(images))


@pytest.fixture(scope="module")
def ref_logits(stacks):
    """The reference's logits of every policy in ``POLICIES`` on one batch,
    from one jitted function (one compile for all of them)."""
    jcfg, jmodel, jparams, tcfg, _, _ = stacks
    images = _images(tcfg, 3)
    pols = [_policy(jp, name) for name in POLICIES]
    fn = jax.jit(lambda p, x: [jmodel.apply(p, {"images": x}, pol)[0]
                               for pol in pols])
    return images, dict(zip(POLICIES, fn(jparams, jnp.asarray(images))))


class _Launches:
    """Calls of the fused wrappers the model makes (on the CPU each runs
    its plain version and counts nothing itself)."""

    def __init__(self, monkeypatch):
        self.calls = {"abfp_matmul": 0, "abfp_matmul_int8": 0,
                      "flash_attention": 0}
        for mod, name in ((t_qm, "abfp_matmul"), (t_qm, "abfp_matmul_int8"),
                          (t_fa, "flash_attention")):
            monkeypatch.setattr(mod, name, self._counted(
                name, getattr(mod, name)))

    def _counted(self, name, fn):
        def call(*a, **kw):
            self.calls[name] += 1
            if name == "flash_attention":
                assert kw["causal"] is False
            return fn(*a, **kw)
        return call


# ------------------------------------------------------------- patch embed
def test_extract_patches_is_the_references():
    img = np.random.RandomState(1).randn(2, 48, 32, 3).astype(np.float32)
    for patch in (8, 16):
        got = t_pe.extract_patches(torch.from_numpy(img), patch)
        want = np.asarray(j_pe.extract_patches(jnp.asarray(img), patch))
        np.testing.assert_array_equal(got.numpy(), want)
    # patch 1 is the top-right 16x16 block, flattened as (ph, pw, c)
    np.testing.assert_array_equal(
        t_pe.extract_patches(torch.from_numpy(img), 16)[:, 1].numpy(),
        img[:, 0:16, 16:32, :].reshape(2, -1))


@pytest.mark.parametrize("policy", ["fp32", "w4a4_abfp"])
def test_patch_embed_is_the_references(policy):
    jpe = j_pe.PatchEmbed(image_size=16, patch_size=8, n_channels=3,
                          d_model=32)
    jparams = unbox(jpe.init(jax.random.PRNGKey(1)))
    jparams["bias"] = jnp.linspace(-1.0, 1.0, 32)
    tpe = t_pe.PatchEmbed(image_size=16, patch_size=8, n_channels=3,
                          d_model=32)
    tparams = {k: torch.from_numpy(np.array(v))
               for k, v in jax.device_get(jparams).items()}
    img = np.random.RandomState(2).randn(B, 16, 16, 3).astype(np.float32)
    want = jpe.apply(jparams, jnp.asarray(img), _policy(jp, policy))
    got = tpe.apply(tparams, torch.from_numpy(img), _policy(tp, policy))
    assert got.shape == (B, 4, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ forward pass
@pytest.mark.parametrize("policy", POLICIES)
def test_apply_matches_reference(stacks, ref_logits, policy, monkeypatch):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    images, want = ref_logits[0], ref_logits[1][policy]
    launches = _Launches(monkeypatch)
    got, aux = tmodel.apply(tparams, {"images": images}, _policy(tp, policy))
    assert got.shape == (B, 128) and float(aux) == 0.0
    _close(got, want)
    kernel = {"p_fp": "abfp_matmul", "p_int8": "abfp_matmul_int8"}.get(
        policy)
    want_calls = {"abfp_matmul": 0, "abfp_matmul_int8": 0,
                  "flash_attention": 0}
    if kernel:
        # patch projection, q, k, v, o, wi, wo a layer, and the head; one
        # non-causal flash call a layer
        want_calls[kernel] = 6 * tcfg.n_layers + 2
        want_calls["flash_attention"] = tcfg.n_layers
    assert launches.calls == want_calls


def test_padded_classes_and_loss_match_reference(stacks):
    """The 118 padded head columns sit at NEG_INF; ``loss`` (CE and top-1)
    reads the 10 real classes only, as the reference's does."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    images = _images(tcfg, 4, batch=4)
    labels = np.array([0, 3, 9, 3], np.int32)
    pol_j, pol_t = _policy(jp, "w4a8_abfp"), _policy(tp, "w4a8_abfp")
    batch = {"images": images, "labels": labels}
    jloss, jm = jax.jit(lambda p, b: jmodel.loss(p, b, pol_j))(
        jparams, jax.tree_util.tree_map(jnp.asarray, batch))
    tloss, tm = tmodel.loss(tparams, batch, pol_t)
    _close(tloss, jloss)
    _close(tm["ce"], jm["ce"])
    assert float(tm["acc"]) == float(jm["acc"])
    logits, _ = tmodel.apply(tparams, batch, pol_t)
    assert bool((logits[:, 10:] == -1e9).all())
    assert bool((logits[:, :10] > -1e8).all())


def test_mean_pool_and_hidden_match_reference(vit_stacks):
    """The mean-pool readout, on the cls model's weights less its cls token
    and last position (a mean-pool encoder has 16 tokens, not 17)."""
    jcfg = _vit_cfg(j_get_config).replace(pool="mean")
    tcfg = _vit_cfg(t_get_config).replace(pool="mean")
    jmodel = j_build_model(jcfg)
    jparams = {k: v for k, v in vit_stacks[2].items() if k != "cls"}
    jparams["pos_embed"] = jparams["pos_embed"][:tcfg.vit_seq_len]
    tmodel = t_build_model(tcfg, device="cpu")
    tparams = bridge.from_repro_params(jax.device_get(jparams), tcfg,
                                       device="cpu")
    images = _images(tcfg, 6)
    jpol, tpol = _policy(jp, "w4a8_abfp"), _policy(tp, "w4a8_abfp")
    _close(tmodel.apply(tparams, {"images": images}, tpol)[0],
           _ref_logits(jmodel, jparams, images, jpol))
    jh, _ = jax.jit(lambda p, x: jmodel.apply(
        p, {"images": x}, jpol, return_hidden=True))(jparams,
                                                     jnp.asarray(images))
    th, _ = tmodel.apply(tparams, {"images": images}, tpol,
                         return_hidden=True)
    assert th.shape == (B, tcfg.vit_seq_len, tcfg.d_model) == (B, 16, 64)
    _close(th, jh)


# ----------------------------------------------------------------- configs
def test_configs_and_param_counts_are_the_references():
    assert {"vit-b16", "deit-s16"} <= set(list_configs())
    for name in ("vit-b16", "deit-s16"):
        tcfg, jcfg = t_get_config(name), j_get_config(name)
        for key in ("family", "n_layers", "d_model", "n_heads", "n_kv",
                    "head_dim_", "d_ff", "act", "norm", "qkv_bias", "pos",
                    "image_size", "patch_size", "n_channels", "n_classes",
                    "pool", "n_patches", "vit_seq_len", "skip_shapes"):
            assert getattr(tcfg, key) == getattr(jcfg, key), (name, key)
        assert tcfg.n_params() == jcfg.n_params(), name
        red_t, red_j = tcfg.reduced(), jcfg.reduced()
        assert (red_t.image_size, red_t.patch_size, red_t.n_classes,
                red_t.vit_seq_len) == (red_j.image_size, red_j.patch_size,
                                       red_j.n_classes, red_j.vit_seq_len)
    full = t_get_config("vit-b16")
    assert (full.vit_seq_len, full.d_model, full.d_ff) == (197, 768, 3072)
    assert t_get_config("deit-s16").n_params() < full.n_params()


def test_build_model_defaults_to_the_card():
    cfg = t_get_config("vit-b16")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default does not raise")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_build_model(cfg)
    model = t_build_model(cfg.reduced(), device="cpu")
    assert model.device.type == "cpu"


@pytest.mark.parametrize("arch", ["vit-b16", "deit-s16"])
def test_launcher_exits_for_an_encoder(arch):
    with pytest.raises(SystemExit) as e:
        tserve.main(["--arch", arch, "--device", "cpu"])
    msg = str(e.value)
    assert "encoder-only classifier" in msg
    assert "chip_smoke.py --phases vit" in msg


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_images_and_loaders_are_the_references(seed):
    kw = dict(image_size=32, n_channels=3, n_classes=10, seed=seed)
    ti, tl = t_images.synthetic_images(24, **kw)
    ji, jl = j_images.synthetic_images(24, **kw)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)
    tload = t_images.ImageLoader(ti, tl, global_batch=8, seed=seed)
    jload = j_images.ImageLoader(ji, jl, global_batch=8, seed=seed)
    for step in (0, 2, 3, 7):  # within and across epochs
        tb, jb = tload.batch_at(step), jload.batch_at(step)
        np.testing.assert_array_equal(tb["images"], jb["images"])
        np.testing.assert_array_equal(tb["labels"], jb["labels"])
    tev = list(t_images.eval_image_batches(ti, tl, 5, max_batches=3))
    jev = list(j_images.eval_image_batches(ji, jl, 5, max_batches=3))
    assert len(tev) == len(jev) == 3
    for tb, jb in zip(tev, jev):
        np.testing.assert_array_equal(tb["images"], jb["images"])
        np.testing.assert_array_equal(tb["labels"], jb["labels"])
