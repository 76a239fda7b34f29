"""Port policy layer vs the reference: every preset resolves every site to
the same flat policy, and a ``policy_to_dict`` made by ``repro`` loads in
the port.  Policies are plain frozen dataclasses, so equality is exact
(compared through their dict form)."""

import dataclasses

import pytest

from repro.core import policy as jp
from repro_torch.core import policy as tp

FLAT = sorted(jp._PRESET_FACTORIES)
MIXED = sorted(jp._MIXED_FACTORIES)
ALL = ["fp32"] + FLAT + MIXED + [n + "_qat" for n in FLAT + MIXED]

SITES = [
    "blocks.0/attn/q", "blocks.0/attn", "blocks.0/ffn/wi", "blocks.0/ffn/wo",
    "blocks.3/attn/o", "blocks.3/ffn/wi", "blocks.2/attn/k", "lm_head",
    "embed/attend", "head", "patch_embed", "blocks.1/mamba/in_proj",
]


def _flat_dict(p):
    return dataclasses.asdict(p)


def test_preset_names_match():
    assert sorted(tp._PRESET_FACTORIES) == FLAT
    assert sorted(tp._MIXED_FACTORIES) == MIXED


@pytest.mark.parametrize("name", ALL)
@pytest.mark.parametrize("n", [64, 32])
def test_preset_resolves_every_site_identically(name, n):
    j = jp.preset(name, n=n, n_layers=4)
    t = tp.preset(name, n=n, n_layers=4)
    assert jp.policy_to_dict(j) == tp.policy_to_dict(t)
    for site in SITES:
        assert (_flat_dict(jp.resolve_policy(j, site))
                == _flat_dict(tp.resolve_policy(t, site))), site


@pytest.mark.parametrize("name", ALL)
def test_reference_dict_loads_in_port(name):
    j = jp.preset(name, n_layers=4)
    j = jp.with_attn_backend(jp.with_kv_cache(j, "int8"), "compressed")
    t = tp.policy_from_dict(jp.policy_to_dict(j))
    assert tp.policy_to_dict(t) == jp.policy_to_dict(j)
    assert tp.kv_cache_mode(t) == jp.kv_cache_mode(j) == "int8"
    assert tp.attn_backend_mode(t) == jp.attn_backend_mode(j) == "compressed"
    for site in SITES:
        assert (_flat_dict(tp.resolve_policy(t, site))
                == _flat_dict(jp.resolve_policy(j, site)))


def test_map_policies_fused_everywhere():
    t = tp.map_policies(tp.preset("w4ffn_fp8attn"),
                        lambda p: p.replace(fused=True))
    j = jp.map_policies(jp.preset("w4ffn_fp8attn"),
                        lambda p: p.replace(fused=True))
    assert tp.policy_to_dict(t) == jp.policy_to_dict(j)
    assert all(p.fused for p in tp.policies_of(t))


def test_mixed_kv_modes_rejected_with_reference_message():
    def mixed(mod):
        pm = mod.preset("w4ffn_fp8attn")
        rules = (mod.PolicyRule(pm.rules[0].pattern,
                                pm.rules[0].policy.replace(kv_cache="int8")),)
        return pm.replace(rules=rules)

    with pytest.raises(ValueError) as je:
        jp.kv_cache_mode(mixed(jp))
    with pytest.raises(ValueError) as te:
        tp.kv_cache_mode(mixed(tp))
    assert str(te.value) == str(je.value)


def test_scan_and_family_shims_raise_reference_messages():
    j = jp.preset("w4a4_abfp+w8a8_ends", n_layers=4)
    t = tp.preset("w4a4_abfp+w8a8_ends", n_layers=4)
    with pytest.raises(ValueError) as je:
        jp.check_scan_compatible(j, True, "m")
    with pytest.raises(ValueError) as te:
        tp.check_scan_compatible(t, True, "m")
    assert str(te.value) == str(je.value)
    tp.check_scan_compatible(t, False, "m")  # unrolled layers: fine
    with pytest.raises(NotImplementedError) as je:
        jp.reject_layer_rules(j, "m")
    with pytest.raises(NotImplementedError) as te:
        tp.reject_layer_rules(t, "m")
    assert str(te.value) == str(je.value)


def test_unknown_names_raise():
    with pytest.raises(ValueError, match="unknown policy preset"):
        tp.preset("w3a3")
    with pytest.raises(ValueError, match="unknown attention backend"):
        tp.with_attn_backend(tp.preset("w4a8_abfp"), "bogus")
