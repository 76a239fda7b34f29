"""The port's ``launch.roofline`` against the reference's: the matmul site
universe of every registered config, the per-site bit report of every
shipped preset over every config, and ``model_flops`` of every config at
every shape, all equal; the reference's ``roofline_terms`` dominance
test on the card's constants (``launch.mesh``: one H100 SXM); and the
twins of its parser tests: the collectives of its ``HLO_SAMPLE``, given to
the port as records (kind, local result bytes, group size), price as the
reference parses them, no collective prices 0, and the affine layer-count
extrapolation is the reference's."""

import math

import pytest

import repro.configs as j_cfg
import repro.core.policy as j_pol
import repro.launch.roofline as j_rf
import repro_torch.configs as t_cfg
import repro_torch.core.policy as t_pol
import repro_torch.launch.lint as t_cli
import repro_torch.launch.mesh as t_mesh
import repro_torch.launch.roofline as t_rf

ARCHS = t_cfg.list_configs()


@pytest.mark.parametrize("arch", ARCHS)
def test_matmul_sites_are_the_references(arch):
    got = t_rf.enumerate_matmul_sites(t_cfg.get_config(arch))
    assert got == j_rf.enumerate_matmul_sites(j_cfg.get_config(arch))
    assert got and len({s for s, *_ in got}) <= len(got)


@pytest.mark.parametrize("name", t_cli.sweep_presets())
def test_policy_bits_report_is_the_references(name):
    for arch in ARCHS:
        tcfg, jcfg = t_cfg.get_config(arch), j_cfg.get_config(arch)
        got = t_rf.policy_bits_report(
            tcfg, t_pol.preset(name, n_layers=tcfg.n_layers))
        want = j_rf.policy_bits_report(
            jcfg, j_pol.preset(name, n_layers=jcfg.n_layers))
        assert got == want, arch


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_are_the_references(arch):
    tcfg, jcfg = t_cfg.get_config(arch), j_cfg.get_config(arch)
    for shape in t_cfg.SHAPES:
        for chips in (1, 256):
            assert t_rf.model_flops(tcfg, t_cfg.SHAPES[shape], chips) == \
                j_rf.model_flops(jcfg, j_cfg.SHAPES[shape], chips)


def test_roofline_terms_dominance():
    t = t_rf.roofline_terms(flops=t_mesh.PEAK_BF16_FLOPS, bytes_accessed=0.0,
                            coll_bytes=0.0)
    assert t["dominant"] == "compute"
    assert t["t_compute_s"] == pytest.approx(1.0)
    t = t_rf.roofline_terms(0.0, t_mesh.HBM_BW * 2, 0.0)
    assert t["dominant"] == "memory" and t["t_memory_s"] == pytest.approx(2.0)
    t = t_rf.roofline_terms(0.0, 0.0, t_mesh.NVLINK_BW * 3)
    assert t["dominant"] == "collective"
    assert t["t_collective_s"] == pytest.approx(3.0)
    assert t["compute_fraction_of_bound"] == 0.0


def test_the_cards_constants():
    """NVIDIA's H100 SXM data sheet (dense rates): the figures every bound
    of ``chip_smoke.py`` is stated against."""
    assert (t_mesh.PEAK_BF16_FLOPS, t_mesh.PEAK_INT8_OPS,
            t_mesh.PEAK_TF32_FLOPS, t_mesh.PEAK_F32_FLOPS) == (
        989e12, 1979e12, 495e12, 67e12)
    assert (t_mesh.HBM_BW, t_mesh.NVLINK_BW) == (3.35e12, 450e9)


# the collectives of ``test_roofline_launch.HLO_SAMPLE``: (kind, dtype,
# dims, group size as its replica_groups give it)
HLO_SAMPLE_COLLECTIVES = (
    ("all-gather", "bf16", (16, 1024), 16),
    ("all-reduce", "f32", (256, 256), 4),
    ("reduce-scatter", "bf16", (8, 128), 8),
    ("collective-permute", "f32", (64,), 16),
)


def test_collective_records_price_as_the_reference_parses():
    from test_roofline_launch import HLO_SAMPLE

    records = [(kind, t_rf._DTYPE_BYTES[dt] * math.prod(dims), n)
               for kind, dt, dims, n in HLO_SAMPLE_COLLECTIVES]
    got = t_rf.collective_bytes(records)
    want = j_rf.collective_bytes(HLO_SAMPLE)
    assert got == want
    assert got["counts"] == {"all-gather": 1, "all-reduce": 1,
                             "reduce-scatter": 1, "collective-permute": 1}
    assert t_rf._DTYPE_BYTES == j_rf._DTYPE_BYTES


def test_no_collective_prices_nothing():
    assert t_rf.collective_bytes([])["total_bytes"] == 0
    assert t_rf.collective_bytes([]) == j_rf.collective_bytes(
        "%d = f32[128,128]{1,0} dot(%a, %b)")


def test_extrapolation_affine():
    c1 = {"flops": 10.0, "bytes": 100.0, "collective_bytes": 5.0}
    c2 = {"flops": 16.0, "bytes": 160.0, "collective_bytes": 7.0}
    out = t_rf.extrapolate(c1, c2, periods=10)
    # fixed + 10*per_period: fixed = 2*c1 - c2
    assert out["flops"] == pytest.approx(10 + 9 * 6)
    assert out["bytes_fixed"] == pytest.approx(40.0)
    assert out["collective_bytes_per_period"] == pytest.approx(2.0)
    assert out == j_rf.extrapolate(c1, c2, periods=10)
