"""The port's ``launch.roofline`` against the reference's: the matmul site
universe of every registered config, the per-site bit report of every
shipped preset over every config, and ``model_flops`` of every config at
every shape, all equal; and the reference's ``roofline_terms`` dominance
test on the card's constants (``launch.mesh``: one H100 SXM)."""

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
