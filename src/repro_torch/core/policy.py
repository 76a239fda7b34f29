"""Quantization policy: which tensors get which format/scaler (paper Fig 2).

``TensorQuant`` configures one tensor role (input / weight / output) of a
matmul site; ``QuantPolicy`` bundles the three roles plus execution options.
``PolicyMap`` lifts that to *site-addressed mixed precision*: an ordered
list of ``(site_pattern, QuantPolicy)`` rules resolved first-match-wins
against the matmul site address, with a default policy for unmatched sites.
Everything is frozen/hashable so policies can key caches and compare by
value.

Site addresses follow the calibration site-name contract (minus the
trailing ``/in``), e.g.::

    blocks.3/attn/q        attention q projection of block 3
    blocks.3/attn          the block's attention BMMs / KV-cache handling
    blocks.3/ffn/wi        MLP input projection (wg shares wi's input)
    blocks.3/mamba/in_proj SSM input projection
    embed/attend           tied LM head readout
    patch_embed / head     ViT frontend / classifier head

Patterns are ``fnmatch`` globs (``*`` crosses ``/``) or, with a ``re:``
prefix, full regexes matched with ``re.fullmatch``.  Per-layer rules
(``blocks.0/*``) always resolve in this package: layers are a Python list
of per-layer dicts with sites ``blocks.{i}/...`` (there is no scan).

Presets mirror the paper's experimental grid:
  w4a4_abfp, w4a8_abfp        — Tables I-IV, VII, VIII, X
  w4a4_e2m1, w4a4_e1m2        — Table II (FP4 weights+activations)
  w4_ae4m3_abfp               — Table V/VI (INT4 weights, FP8-E4M3 acts)
  w4a4_mse, w4a8_mse          — static MSE calibration rows
  *_qat                       — ABFP forward + PWL-STE backward (eqn (5))
  w4a16                       — weight-only (GPTQ baseline config)
  w8a8_int8_native            — beyond-paper: real int8 compute
Mixed (PolicyMap) presets — the layer-sensitivity frontier:
  w4a4_abfp+w8a8_ends         — W8A8 first/last blocks, W4A4 interior
                                (requires ``n_layers``)
  w4ffn_fp8attn               — FP8-E4M3 attention, INT4 ABFP FFN
"""

from __future__ import annotations

import dataclasses
import fnmatch
import functools
import re
from typing import Callable, Union

from repro_torch.core.formats import Format, get_format


@dataclasses.dataclass(frozen=True)
class TensorQuant:
    """Quantizer spec for one tensor role at a matmul site.

    scaler:
      'abfp'         — dynamic per-vector max over groups of ``group`` along
                       the contraction dim (paper eqn (4)); scales BF16.
      'dynamic_max'  — dynamic per-tensor max.
      'channel_max'  — per-output-channel max (paper's weight calibration).
      'static'       — calibrated alpha from the QuantState (max or MSE).
    """

    fmt_name: str
    scaler: str = "abfp"
    group: int = 64
    ste: bool = False
    scale_dtype: str = "bfloat16"

    @property
    def fmt(self) -> Format:
        return get_format(self.fmt_name)

    def replace(self, **kw) -> "TensorQuant":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Full policy for the simulator's matmul chokepoint.

    compute:
      'fp'    — paper-faithful: QDQ then high-precision matmul (eqns 6-9).
      'int8'  — beyond-paper native path: int8 codes contracted with
                per-group rescale (only valid for int formats + abfp).
    fused:
      route through the hand-written CUDA kernel (``repro_torch.kernels``).
    """

    name: str = "fp32"
    input: TensorQuant | None = None
    weight: TensorQuant | None = None
    output: TensorQuant | None = None
    attn_bmm: bool = False  # also quantize q/k and probs/v inputs
    compute: str = "fp"
    fused: bool = False
    # KV-cache handling at decode (serving §Perf):
    #   'requant'  — paper-faithful: re-QDQ the whole cache every step.
    #   'on_write' — quantize each entry once when written (exact for K's
    #                head_dim groups; per-token for V — documented
    #                deviation), skip re-QDQ at read: kills the per-step
    #                full-cache QDQ chain.
    #   'int8'     — on_write semantics + REAL int8 cache storage (codes +
    #                per-(slot, head) f32 scales): halves cache capacity
    #                and read traffic.  TransformerLM family.
    kv_cache: str = "requant"
    # Attention backend at the block site (per-site, mirrors the qmatmul
    # execution-backend registry — core.simulate.attn_backends):
    #   'auto'       — module heuristics decide (reference / blockwise /
    #                  flash when the module opts in); today's behavior.
    #   'ref'        — force the plain PyTorch paths (never a kernel).
    #   'fused'      — request the dense flash kernel where eligible.
    #   'compressed' — contract quantized KV codes in-kernel (decode paths;
    #                  requires int8/fp8 cache storage).
    attn_backend: str = "auto"

    @property
    def enabled(self) -> bool:
        return any(x is not None for x in (self.input, self.weight, self.output))

    def replace(self, **kw) -> "QuantPolicy":
        return dataclasses.replace(self, **kw)

    def with_ste(self, ste: bool = True) -> "QuantPolicy":
        """QAT variant: same formats, PWL-STE gradients."""
        rep = {}
        for role in ("input", "weight", "output"):
            tq = getattr(self, role)
            if tq is not None:
                rep[role] = tq.replace(ste=ste)
        return self.replace(name=self.name + "_qat", **rep)


NONE = QuantPolicy()


# ---------------------------------------------------------------------------
# Site-addressed PolicyMap
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PolicyRule:
    """One ``(site_pattern, policy)`` entry of a PolicyMap.

    ``pattern`` is an fnmatch glob over the site address, or a regex when
    prefixed with ``re:`` (anchored — matched with ``re.fullmatch``).
    """

    pattern: str
    policy: QuantPolicy

    def matches(self, site: str) -> bool:
        if self.pattern.startswith("re:"):
            return re.fullmatch(self.pattern[3:], site) is not None
        return fnmatch.fnmatchcase(site, self.pattern)


@dataclasses.dataclass(frozen=True)
class PolicyMap:
    """Ordered site-pattern rules, first-match-wins, with a default policy.

    Frozen and hashable like a flat QuantPolicy; resolution is cached per
    (map, site) so it costs a dict lookup on the hot path.
    """

    name: str = "map"
    rules: tuple = ()  # tuple[PolicyRule, ...]; (pattern, policy) coerced
    default: QuantPolicy = NONE

    def __post_init__(self):
        coerced = tuple(
            r if isinstance(r, PolicyRule) else PolicyRule(*r)
            for r in self.rules
        )
        object.__setattr__(self, "rules", coerced)

    # --- resolution --------------------------------------------------------
    def resolve(self, site: str) -> QuantPolicy:
        """First rule whose pattern matches ``site``; else the default."""
        return _resolve_cached(self, site)

    # --- flat-policy protocol ----------------------------------------------
    @property
    def enabled(self) -> bool:
        return self.default.enabled or any(r.policy.enabled for r in self.rules)

    def replace(self, **kw) -> "PolicyMap":
        return dataclasses.replace(self, **kw)

    def map_policies(self, fn: Callable[[QuantPolicy], QuantPolicy],
                     name: str | None = None) -> "PolicyMap":
        """Apply ``fn`` to every rule policy and the default."""
        return PolicyMap(
            name=name or self.name,
            rules=tuple(PolicyRule(r.pattern, fn(r.policy))
                        for r in self.rules),
            default=fn(self.default),
        )

    def replace_all(self, **kw) -> "PolicyMap":
        """``QuantPolicy.replace`` across all enabled rules + default
        (method form of module-level ``replace_enabled``)."""
        return replace_enabled(self, **kw)

    def with_ste(self, ste: bool = True) -> "PolicyMap":
        return self.map_policies(
            lambda p: p.with_ste(ste) if p.enabled else p,
            name=self.name + "_qat",
        )

    @property
    def policies(self) -> tuple:
        """All distinct policies, rule order then default."""
        seen, out = set(), []
        for p in [r.policy for r in self.rules] + [self.default]:
            if p not in seen:
                seen.add(p)
                out.append(p)
        return tuple(out)


@functools.lru_cache(maxsize=4096)
def _resolve_cached(pm: PolicyMap, site: str) -> QuantPolicy:
    for rule in pm.rules:
        if rule.matches(site):
            return rule.policy
    return pm.default


Policy = Union[QuantPolicy, PolicyMap]


def resolve_policy(policy: Policy, site: str) -> QuantPolicy:
    """The one resolution chokepoint every layer routes through.

    Flat QuantPolicy passes through unchanged (compat: a flat policy IS a
    single-rule map); PolicyMap resolves at the site address.
    """
    if isinstance(policy, PolicyMap):
        return policy.resolve(site)
    return policy


def as_policy_map(policy: Policy, name: str | None = None) -> PolicyMap:
    """Compat shim: lift a flat QuantPolicy into an equivalent PolicyMap."""
    if isinstance(policy, PolicyMap):
        return policy
    return PolicyMap(name=name or policy.name, rules=(), default=policy)


def has_site_rules(policy: Policy) -> bool:
    """True when any site rules exist."""
    return isinstance(policy, PolicyMap) and len(policy.rules) > 0


def has_layer_rules(policy: Policy) -> bool:
    """True when rules address specific layers (``blocks.{i}/...``).

    Layer-indexed rules require eager unrolled execution
    (``scan_layers=False``): under scan-over-layers every layer shares one
    trace whose sites are ``block/...``, so ``blocks.3/...`` patterns would
    silently fall through to the default.  Models raise on this combination
    instead of mis-resolving.  (Heuristic on the documented site contract:
    a rule is layer-indexed iff its pattern mentions ``blocks`` — plural
    only exists in the unrolled ``blocks.{i}/...`` naming; scan sites are
    ``block/...``, so any ``blocks``-mentioning pattern, including dot-less
    globs like ``blocks*`` or regex spellings ``blocks\\.``/``blocks[.]``,
    can never match under scan.)
    """
    return has_site_rules(policy) and any(
        "blocks" in r.pattern for r in policy.rules
    )


def has_expert_rules(policy: Policy) -> bool:
    """True when rules address individual MoE experts (``experts.{e}``).

    Expert-indexed patterns (``*/experts.3``) resolve at the runtime MoE
    sub-sites ``{block}/ffn/experts.{e}``; they deliberately avoid the
    word ``blocks`` so a layer-uniform per-expert map stays scan-
    compatible (``has_layer_rules`` does not trip on them).
    """
    return has_site_rules(policy) and any(
        "experts" in r.pattern for r in policy.rules
    )


def check_scan_compatible(policy: Policy, scan_layers: bool,
                          model_name: str = "") -> None:
    """Raise if layer-indexed rules are used with scan-over-layers.

    Thin shim over the static analyzer (QL004): the runtime error and the
    lint finding are the same message, produced in one place.
    """
    from repro_torch.analysis.policy_lint import scan_compat_diagnostic

    d = scan_compat_diagnostic(policy, scan_layers, model_name)
    if d is not None:
        raise ValueError(d.message)


def reject_layer_rules(policy: Policy, model_name: str = "") -> None:
    """Raise if layer-indexed rules hit a model without per-layer sites.

    encdec/hybrid address their matmuls with family-level names (``attn``,
    ``shared/q``, ``mamba/...``) — no ``blocks.{i}`` prefix exists there, so
    layer-indexed rules would silently resolve to the default everywhere.
    Thin shim over the static analyzer (QL005).
    """
    from repro_torch.analysis.policy_lint import layer_rules_family_diagnostic

    d = layer_rules_family_diagnostic(policy, model_name)
    if d is not None:
        raise NotImplementedError(d.message)


def policies_of(policy: Policy) -> tuple:
    """All distinct flat policies behind ``policy`` (one for a flat)."""
    if isinstance(policy, PolicyMap):
        return policy.policies
    return (policy,)


def map_policies(policy: Policy,
                 fn: Callable[[QuantPolicy], QuantPolicy]) -> Policy:
    """Apply ``fn`` across a flat policy or every entry of a map."""
    if isinstance(policy, PolicyMap):
        return policy.map_policies(fn)
    return fn(policy)


def replace_enabled(policy: Policy, **kw) -> Policy:
    """``QuantPolicy.replace(**kw)`` across a flat policy or every enabled
    entry of a map (disabled fp32 rules stay untouched) — the one place the
    skip-disabled contract lives for launch-time overrides."""
    return map_policies(policy,
                        lambda p: p.replace(**kw) if p.enabled else p)


def kv_cache_mode(policy: Policy) -> str:
    """The (engine-global) KV-cache storage mode.

    Cache *storage* is allocated once for all layers, so a map's rules must
    agree on it; heterogeneous kv_cache across sites is rejected here rather
    than silently mis-sizing the cache.
    """
    # disabled (fp32) rules count: cache storage keys off kv_cache alone,
    # so an fp32 rule's 'requant' is heterogeneous with int8 elsewhere.
    # Thin shim over the static analyzer (QL007).
    from repro_torch.analysis.policy_lint import kv_mode_diagnostic

    mode, d = kv_mode_diagnostic(policy)
    if d is not None:
        raise ValueError(d.message)
    return mode


def with_kv_cache(policy: Policy, mode: str) -> Policy:
    """Set ``kv_cache`` on EVERY entry of a map (disabled fp32 rules too).

    Unlike ``replace_enabled``, this must not skip disabled rules: cache
    *storage* is structural — a layer whose resolved policy is fp32 still
    owns cache slots, and those must match the other layers' storage
    format or the stacked per-layer caches diverge in pytree structure.
    """
    return map_policies(policy, lambda p: p.replace(kv_cache=mode))


def with_attn_backend(policy: Policy, name: str) -> Policy:
    """Set ``attn_backend`` on EVERY entry of a map (disabled rules too).

    Like ``with_kv_cache``, this must not skip disabled rules: an fp32
    policy over int8/fp8 cache *storage* is a valid serving configuration
    (storage keys off kv_cache alone), and the compressed backend must
    engage at those sites too — the fp32 leg of the parity gate.
    """
    from repro_torch.core.simulate import attn_backends

    if name not in attn_backends():
        raise ValueError(
            f"unknown attention backend {name!r} "
            f"(registered: {sorted(attn_backends())})")
    return map_policies(policy, lambda p: p.replace(attn_backend=name))


def attn_backend_mode(policy: Policy) -> str:
    """The effective attention backend of a policy or map.

    Mirrors ``kv_cache_mode``'s engine-global contract: entries must agree
    (attention dispatch is per-site, but the engines' byte accounting and
    pre-flight lint reason about one backend per serve)."""
    modes = {getattr(p, "attn_backend", "auto")
             for p in policies_of(policy)}
    if len(modes) > 1:
        raise ValueError(
            f"policy {getattr(policy, 'name', '?')!r} mixes attention "
            f"backends {sorted(modes)}; set one with with_attn_backend()")
    return modes.pop()


# ---------------------------------------------------------------------------
# Serialization (configs / artifacts round-trip)
# ---------------------------------------------------------------------------
def policy_to_dict(policy: Policy) -> dict:
    """Plain-dict form of a flat policy or a map (JSON-safe)."""
    if isinstance(policy, PolicyMap):
        return {
            "kind": "map",
            "name": policy.name,
            "rules": [
                {"pattern": r.pattern, "policy": policy_to_dict(r.policy)}
                for r in policy.rules
            ],
            "default": policy_to_dict(policy.default),
        }
    d = dataclasses.asdict(policy)
    d["kind"] = "flat"
    return d


def policy_from_dict(d: dict) -> Policy:
    """Inverse of ``policy_to_dict``."""
    d = dict(d)
    kind = d.pop("kind", "map" if "rules" in d else "flat")
    if kind == "map":
        return PolicyMap(
            name=d.get("name", "map"),
            rules=tuple(
                PolicyRule(r["pattern"], policy_from_dict(r["policy"]))
                for r in d.get("rules", ())
            ),
            default=policy_from_dict(d.get("default", {"kind": "flat"})),
        )
    for role in ("input", "weight", "output"):
        if d.get(role) is not None:
            d[role] = TensorQuant(**d[role])
    return QuantPolicy(**d)


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------
def _abfp(fmt: str, n: int, ste: bool = False) -> TensorQuant:
    return TensorQuant(fmt_name=fmt, scaler="abfp", group=n, ste=ste)


# Built ONCE at module scope: name -> factory(n) -> QuantPolicy.  (The old
# implementation rebuilt the whole policy table dict on every preset() call.)
_PRESET_FACTORIES: dict[str, Callable[[int], QuantPolicy]] = {
    # --- ABFP family (Tables I-IV, VIII, X) ---
    "w4a4_abfp": lambda n: QuantPolicy(
        name="w4a4_abfp", input=_abfp("int4", n), weight=_abfp("int4", n),
        attn_bmm=True,
    ),
    "w4a8_abfp": lambda n: QuantPolicy(
        name="w4a8_abfp", input=_abfp("int8", n), weight=_abfp("int4", n),
        attn_bmm=True,
    ),
    "w8a8_abfp": lambda n: QuantPolicy(
        name="w8a8_abfp", input=_abfp("int8", n), weight=_abfp("int8", n),
        attn_bmm=True,
    ),
    # --- FP4 weights + activations (Table II) ---
    "w4a4_e2m1": lambda n: QuantPolicy(
        name="w4a4_e2m1", input=_abfp("e2m1", n), weight=_abfp("e2m1", n),
        attn_bmm=True,
    ),
    "w4a4_e1m2": lambda n: QuantPolicy(
        name="w4a4_e1m2", input=_abfp("e1m2", n), weight=_abfp("e1m2", n),
        attn_bmm=True,
    ),
    # --- INT4 weights + FP8 activations (Tables V, VI) ---
    "w4_ae4m3_abfp": lambda n: QuantPolicy(
        name="w4_ae4m3_abfp", input=_abfp("e4m3", n), weight=_abfp("int4", n),
        attn_bmm=True,
    ),
    # --- FP8 weights + activations (mixed-preset building block) ---
    "w8a8_e4m3": lambda n: QuantPolicy(
        name="w8a8_e4m3", input=_abfp("e4m3", n), weight=_abfp("e4m3", n),
        attn_bmm=True,
    ),
    # --- static calibration (Tables I, IV): per-channel max weights,
    #     static MSE activations ---
    "w4a4_mse": lambda n: QuantPolicy(
        name="w4a4_mse",
        input=TensorQuant("int4", scaler="static"),
        weight=TensorQuant("int4", scaler="channel_max"),
        attn_bmm=True,
    ),
    "w4a8_mse": lambda n: QuantPolicy(
        name="w4a8_mse",
        input=TensorQuant("int8", scaler="static"),
        weight=TensorQuant("int4", scaler="channel_max"),
        attn_bmm=True,
    ),
    "w8a8_mse": lambda n: QuantPolicy(
        name="w8a8_mse",
        input=TensorQuant("int8", scaler="static"),
        weight=TensorQuant("int8", scaler="channel_max"),
        attn_bmm=True,
    ),
    # --- FP8-E4M3 static calibration (mixed-preset / recipe building
    #     block: static-MSE clip ranges solved against the E4M3 grid) ---
    "w8a8_e4m3_mse": lambda n: QuantPolicy(
        name="w8a8_e4m3_mse",
        input=TensorQuant("e4m3", scaler="static"),
        weight=TensorQuant("e4m3", scaler="channel_max"),
        attn_bmm=True,
    ),
    # --- weight-only (GPTQ baseline shape, Table V "W4A16") ---
    "w4a16": lambda n: QuantPolicy(
        name="w4a16", input=None, weight=_abfp("int4", n), attn_bmm=False,
    ),
    # --- beyond-paper: native int8 compute ---
    "w8a8_int8_native": lambda n: QuantPolicy(
        name="w8a8_int8_native", input=_abfp("int8", n),
        weight=_abfp("int8", n), attn_bmm=False, compute="int8",
    ),
    "w4a8_int8_native": lambda n: QuantPolicy(
        name="w4a8_int8_native", input=_abfp("int8", n),
        weight=_abfp("int4", n), attn_bmm=False, compute="int8",
    ),
}


def endcap_map(interior: QuantPolicy, ends: QuantPolicy, n_layers: int,
               name: str | None = None) -> PolicyMap:
    """W-endcaps map: first/last blocks at ``ends``, interior at ``interior``.

    The classic layer-sensitivity assignment — endcap blocks carry the
    heaviest activation outliers, so they get the wider format while the
    interior runs at the aggressive one.
    """
    if n_layers < 2:
        raise ValueError(f"endcap map needs n_layers >= 2, got {n_layers}")
    return PolicyMap(
        name=name or f"{interior.name}+{ends.name}_ends",
        rules=(
            PolicyRule("blocks.0/*", ends),
            PolicyRule(f"blocks.{n_layers - 1}/*", ends),
        ),
        default=interior,
    )


# Mixed presets: name -> factory(n, n_layers) -> PolicyMap.
_MIXED_FACTORIES: dict[str, Callable[[int, int | None], PolicyMap]] = {}


def _mixed(name: str):
    def deco(fn):
        _MIXED_FACTORIES[name] = fn
        return fn
    return deco


@_mixed("w4a4_abfp+w8a8_ends")
def _w4a4_w8a8_ends(n: int, n_layers: int | None) -> PolicyMap:
    if n_layers is None:
        raise ValueError(
            "preset 'w4a4_abfp+w8a8_ends' addresses first/last blocks: pass "
            "preset(name, n_layers=cfg.n_layers)"
        )
    return endcap_map(
        _PRESET_FACTORIES["w4a4_abfp"](n),
        _PRESET_FACTORIES["w8a8_abfp"](n),
        n_layers,
        name="w4a4_abfp+w8a8_ends",
    )


@_mixed("w4ffn_fp8attn")
def _w4ffn_fp8attn(n: int, n_layers: int | None) -> PolicyMap:
    """FP8-E4M3 attention (projections + BMMs), INT4-ABFP FFN + rest."""
    return PolicyMap(
        name="w4ffn_fp8attn",
        rules=(PolicyRule("*attn*", _PRESET_FACTORIES["w8a8_e4m3"](n)),),
        default=_PRESET_FACTORIES["w4a4_abfp"](n),
    )


@_mixed("w4ffn_fp8attn_mse")
def _w4ffn_fp8attn_mse(n: int, n_layers: int | None) -> PolicyMap:
    """Static-calibrated twin of ``w4ffn_fp8attn``: FP8-E4M3 attention with
    static-MSE clip ranges, INT4-weight/INT8-act static-MSE FFN + rest —
    the per-site-format eval policy the site-scoped PTQ recipes pair with
    (each site's alpha grid-searches against *its* resolved grid)."""
    return PolicyMap(
        name="w4ffn_fp8attn_mse",
        rules=(PolicyRule("*attn*", _PRESET_FACTORIES["w8a8_e4m3_mse"](n)),),
        default=_PRESET_FACTORIES["w4a8_mse"](n),
    )


def preset(name: str, n: int = 64, n_layers: int | None = None) -> Policy:
    """Look up a named policy (flat or mixed) from the paper's grid.

    ``n`` is the ABFP group size; ``n_layers`` is required by mixed presets
    whose rules address first/last blocks (e.g. ``w4a4_abfp+w8a8_ends``).
    """
    key = name.lower()
    if key in ("fp32", "none", "off", "baseline"):
        return NONE
    if key in _MIXED_FACTORIES:
        return _MIXED_FACTORIES[key](n, n_layers)
    if key.endswith("_qat"):
        base = key[: -len("_qat")]
        if base in _MIXED_FACTORIES:
            return _MIXED_FACTORIES[base](n, n_layers).with_ste(True)
        if base not in _PRESET_FACTORIES:
            raise ValueError(
                f"unknown QAT preset {name!r}: base {base!r} is not a known "
                f"policy; known bases: {sorted(_PRESET_FACTORIES)} "
                f"(+ mixed: {sorted(_MIXED_FACTORIES)})"
            )
        return _PRESET_FACTORIES[base](n).with_ste(True)
    try:
        return _PRESET_FACTORIES[key](n)
    except KeyError as e:
        raise ValueError(
            f"unknown policy preset {name!r}; known: "
            f"{sorted(_PRESET_FACTORIES)} (+ mixed: "
            f"{sorted(_MIXED_FACTORIES)}, '_qat' suffixes, 'fp32')"
        ) from e
