"""QuantRecipe: composable, site-aware PTQ pass pipelines.

The paper's headline contribution is a *survey harness* comparing ABFP,
SmoothQuant, GPTQ and RPTQ — and their combinations — across formats.  This
module is the driver layer for that harness: each method is a ``QuantPass``
declaring what it reads and writes (params, activation statistics, Hessians,
static-alpha q trees), and a ``QuantRecipe`` is an ordered list of pass
specs that the engine sequences with two guarantees the old free-function
drivers could not give:

  * **No stale statistics.**  A param-mutating pass (SmoothQuant, GPTQ)
    invalidates every activation statistic collected before it.  The engine
    tracks freshness and automatically re-runs calibration between a
    param-mutating pass and any downstream pass that consumes stats —
    eliminating the silent stale-Hessian bug class (GPTQ solving against
    pre-SmoothQuant Hessians).
  * **Site scoping.**  Every pass takes a site pattern with the same
    fnmatch/``re:`` rules PolicyMap uses, so one pipeline can give FP8
    attention static-MSE scales while INT4 FFNs take SmoothQuant+GPTQ.

Recipes are declarative and serializable (``recipe_to_dict`` /
``recipe_from_dict`` round-trip, like PolicyMap), registered by name next
to the format presets (``smoothquant+gptq``, ``rptq_w4a8``, ...), and
composable: ``get_recipe("smoothquant+gptq")`` concatenates registered
parts split on ``+``.

Pass order is validated up front: a param-mutating pass after a pass that
already materialized an activation-statistic artifact (a static q tree)
would silently invalidate that artifact, so ``QuantRecipe.validate`` raises
``RecipeError`` instead of running it.

Usage (the whole PTQ pipeline in three lines)::

    from repro_torch.core.recipe import apply_recipe, get_recipe
    res = apply_recipe(get_recipe("smoothquant+gptq+static_mse"),
                       model, params, calib_batches, preset("w4a8_mse"))
    ppl = eval_ppl(model, res.params, policy, q=res.qtree)

The port always runs its layers one by one, so every observation site
fires per layer; calibration statistics, GPTQ and the static solves run on
the model's device.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import re
from typing import Callable, Mapping

from repro_torch.core.calibration import Calibrator
from repro_torch.core.formats import get_format
from repro_torch.core.policy import Policy
from repro_torch.core.policy import preset as policy_preset


class RecipeError(ValueError):
    """Invalid recipe: unknown pass kind/option or invalid pass order."""


class StaleCalibrationError(RecipeError):
    """A pass needs (re)calibration but the engine has no way to run it.

    Raised when a pass consumes activation statistics that are missing or
    were collected before a param-mutating pass, and no ``calibrate_fn``
    was provided — the failure the old hand-chained drivers hit *silently*.
    """


# ---------------------------------------------------------------------------
# Pass kinds: what each method reads and writes.
# ---------------------------------------------------------------------------
# reads:  'params'  — consumes the current weight tree
#         'calib'   — consumes activation statistics (absmax/minmax/samples)
#         'hessian' — consumes X^T X outer products (GPTQ)
# writes: 'params'  — mutates weights (invalidates all stats collected before)
#         'qtree'   — contributes static-alpha entries to the q tree
@dataclasses.dataclass(frozen=True)
class PassKind:
    name: str
    reads: frozenset
    writes: frozenset
    defaults: tuple  # ((option, default), ...) — also the allowed option set
    run: Callable  # (RecipeState, merged-options dict, site_filter) -> info

    @property
    def mutates_params(self) -> bool:
        return "params" in self.writes

    @property
    def needs_stats(self) -> bool:
        return bool({"calib", "hessian"} & self.reads)


PASS_KINDS: dict[str, PassKind] = {}


def quant_pass(name: str, *, reads=(), writes=(), defaults=()):
    """Register a pass kind (decorator over its run function)."""

    def deco(fn):
        PASS_KINDS[name] = PassKind(
            name=name, reads=frozenset(reads), writes=frozenset(writes),
            defaults=tuple(defaults), run=fn,
        )
        return fn

    return deco


# ---------------------------------------------------------------------------
# Recipe declaration
# ---------------------------------------------------------------------------
def _match_sites(pattern: str, site: str) -> bool:
    """Same pattern language as PolicyMap rules: fnmatch, or ``re:`` regex."""
    if pattern.startswith("re:"):
        return re.fullmatch(pattern[3:], site) is not None
    return fnmatch.fnmatchcase(site, pattern)


@dataclasses.dataclass(frozen=True)
class PassSpec:
    """One step of a recipe: a pass kind, a site scope, and options.

    ``sites`` uses PolicyMap's pattern rules (fnmatch glob, ``*`` crosses
    ``/``; ``re:`` prefix for anchored regexes) matched against the
    policy-resolution site address (``blocks.3/ffn/wi``, ``blocks.3/attn``,
    ``embed/attend``, ...).  ``options`` is a flat mapping of JSON scalars,
    stored sorted so specs stay frozen/hashable.
    """

    kind: str
    sites: str = "*"
    options: tuple = ()  # ((key, value), ...); dicts coerced

    def __post_init__(self):
        opts = self.options
        if isinstance(opts, Mapping):
            opts = tuple(sorted(opts.items()))
        else:
            opts = tuple(sorted((str(k), v) for k, v in opts))
        object.__setattr__(self, "options", opts)

    @property
    def opts(self) -> dict:
        return dict(self.options)

    def matches(self, site: str) -> bool:
        return _match_sites(self.sites, site)


@dataclasses.dataclass(frozen=True)
class QuantRecipe:
    """An ordered, validated, serializable PTQ pass pipeline.

    ``policy_preset`` optionally names the evaluation policy this recipe was
    designed for (e.g. ``rptq_w4a8`` pairs with ``w4a8_mse``): consumers use
    it as the default when no explicit policy is given.
    """

    name: str
    passes: tuple = ()  # tuple[PassSpec, ...]; dicts coerced
    policy_preset: str | None = None

    def __post_init__(self):
        coerced = tuple(
            p if isinstance(p, PassSpec) else PassSpec(**p)
            for p in self.passes
        )
        object.__setattr__(self, "passes", coerced)

    # --- validation --------------------------------------------------------
    def validate(self) -> "QuantRecipe":
        if not self.passes:
            raise RecipeError(f"recipe {self.name!r} has no passes")
        qtree_written_by = None
        for spec in self.passes:
            kind = PASS_KINDS.get(spec.kind)
            if kind is None:
                raise RecipeError(
                    f"recipe {self.name!r}: unknown pass kind {spec.kind!r}; "
                    f"known: {sorted(PASS_KINDS)}"
                )
            allowed = {k for k, _ in kind.defaults}
            unknown = set(spec.opts) - allowed
            if unknown:
                raise RecipeError(
                    f"recipe {self.name!r}: pass {spec.kind!r} got unknown "
                    f"option(s) {sorted(unknown)}; allowed: {sorted(allowed)}"
                )
            if spec.sites.startswith("re:"):
                try:
                    re.compile(spec.sites[3:])
                except re.error as e:
                    raise RecipeError(
                        f"recipe {self.name!r}: pass {spec.kind!r} has an "
                        f"invalid site regex {spec.sites!r}: {e}"
                    ) from e
            if kind.mutates_params and qtree_written_by is not None:
                raise RecipeError(
                    f"recipe {self.name!r}: param-mutating pass "
                    f"{spec.kind!r} after q-tree pass "
                    f"{qtree_written_by!r} would silently invalidate the "
                    "static alphas already solved — reorder the recipe so "
                    "weight-mutating passes run before static/rptq passes"
                )
            if "qtree" in kind.writes:
                qtree_written_by = spec.kind
        return self

    # --- composition -------------------------------------------------------
    def __add__(self, other: "QuantRecipe") -> "QuantRecipe":
        return QuantRecipe(
            name=f"{self.name}+{other.name}",
            passes=self.passes + other.passes,
            policy_preset=other.policy_preset or self.policy_preset,
        )


# ---------------------------------------------------------------------------
# Serialization (dict round-trip, like PolicyMap)
# ---------------------------------------------------------------------------
def recipe_to_dict(recipe: QuantRecipe) -> dict:
    """Plain-dict (JSON-safe) form of a recipe."""
    return {
        "name": recipe.name,
        "policy_preset": recipe.policy_preset,
        "passes": [
            {"kind": p.kind, "sites": p.sites, "options": p.opts}
            for p in recipe.passes
        ],
    }


def recipe_from_dict(d: dict) -> QuantRecipe:
    """Inverse of ``recipe_to_dict``."""
    return QuantRecipe(
        name=d.get("name", "recipe"),
        passes=tuple(
            PassSpec(
                kind=p["kind"],
                sites=p.get("sites", "*"),
                options=p.get("options", ()),
            )
            for p in d.get("passes", ())
        ),
        policy_preset=d.get("policy_preset"),
    )


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RecipeState:
    """Mutable pipeline state threaded through the passes."""

    params: dict
    policy: Policy
    n_layers: int
    calib: Calibrator | None = None
    calib_fresh: bool = False  # stats match the CURRENT params tree
    qtree: dict | None = None
    artifacts: dict = dataclasses.field(default_factory=dict)
    dropped_sites: set = dataclasses.field(default_factory=set)
    steps: list = dataclasses.field(default_factory=list)
    n_calibrations: int = 0


@dataclasses.dataclass
class RecipeResult:
    """What a recipe produced: new params, q tree, per-pass artifacts."""

    params: dict
    qtree: dict | None
    artifacts: dict
    calib: Calibrator | None
    steps: tuple  # ((step_name, info_dict), ...) execution log
    n_calibrations: int
    dropped_sites: tuple  # calibration sites no q-tree slot exists for


def _merge_qtree(base: dict | None, new: dict) -> dict:
    """Merge q trees leaf-wise; later passes override earlier entries."""
    if base is None:
        return new
    blocks = []
    for b_old, b_new in zip(base["blocks"], new["blocks"]):
        b = {g: dict(v) for g, v in b_old.items()}
        for g, leaves in b_new.items():
            b.setdefault(g, {}).update(leaves)
        blocks.append(b)
    return {"blocks": blocks}


def _outer_needed(passes: tuple, start: int) -> bool:
    """Will the calibration collected before pass ``start`` need Hessians?

    Scan forward: a Hessian consumer before the next param-mutating pass
    shares this calibration; anything after a param mutation gets a fresh
    one anyway.  (The mutating pass itself is checked first — GPTQ both
    reads Hessians and writes params.)
    """
    for spec in passes[start:]:
        kind = PASS_KINDS[spec.kind]
        if "hessian" in kind.reads:
            return True
        if kind.mutates_params:
            return False
    return False


class RecipeEngine:
    """Sequences a recipe's passes, re-calibrating whenever stats go stale.

    ``calibrate_fn(params, collect_outer) -> Calibrator`` is how the engine
    refreshes statistics; without one, a pass that needs fresh stats raises
    ``StaleCalibrationError`` instead of silently consuming stale ones
    (single-pass legacy shims run in this mode with a caller-provided
    Calibrator).
    """

    def __init__(self, *, policy: Policy, n_layers: int,
                 calibrate_fn: Callable[[dict, bool], Calibrator] | None = None):
        self.policy = policy
        self.n_layers = n_layers
        self.calibrate_fn = calibrate_fn

    def run(self, recipe, params: dict,
            calib: Calibrator | None = None) -> RecipeResult:
        recipe = as_recipe(recipe).validate()
        state = RecipeState(
            params=params, policy=self.policy, n_layers=self.n_layers,
            calib=calib, calib_fresh=calib is not None,
        )
        for i, spec in enumerate(recipe.passes):
            kind = PASS_KINDS[spec.kind]
            if kind.needs_stats:
                self._ensure_calibrated(recipe, state, i)
            opts = {**dict(kind.defaults), **spec.opts}
            info = kind.run(state, opts, spec.matches) or {}
            state.steps.append((spec.kind, {"sites": spec.sites, **info}))
            if kind.mutates_params:
                state.calib_fresh = False
        return RecipeResult(
            params=state.params, qtree=state.qtree,
            artifacts=state.artifacts, calib=state.calib,
            steps=tuple(state.steps), n_calibrations=state.n_calibrations,
            dropped_sites=tuple(sorted(state.dropped_sites)),
        )

    def _ensure_calibrated(self, recipe: QuantRecipe, state: RecipeState,
                           i: int) -> None:
        kind = PASS_KINDS[recipe.passes[i].kind]
        need_outer = "hessian" in kind.reads
        have_outer = state.calib is not None and state.calib.collect_outer
        if state.calib is not None and state.calib_fresh and (
                have_outer or not need_outer):
            return
        if self.calibrate_fn is None:
            why = ("were collected before a param-mutating pass"
                   if state.calib is not None and not state.calib_fresh
                   else "lack Hessians (collect_outer=False)"
                   if state.calib is not None
                   else "are missing")
            raise StaleCalibrationError(
                f"recipe {recipe.name!r}: pass {kind.name!r} needs "
                f"activation statistics that {why}, and the engine has no "
                "calibrate_fn to refresh them — use apply_recipe(model, "
                "params, batches, ...) or pass calibrate_fn to RecipeEngine"
            )
        collect_outer = need_outer or _outer_needed(recipe.passes, i)
        state.calib = self.calibrate_fn(state.params, collect_outer)
        if not state.calib.stats:
            raise RecipeError(
                f"recipe {recipe.name!r}: calibration observed no sites — "
                "observers only fire at quantized matmuls, so a disabled "
                "(fp32) observation policy collects nothing; calibrate "
                "under an enabled policy (e.g. preset('w4a8_mse'))"
            )
        state.calib_fresh = True
        state.n_calibrations += 1
        state.steps.append(("calibrate", {"collect_outer": collect_outer}))


def apply_recipe(recipe, model, params: dict, batches,
                 policy: Policy | None = None, *,
                 n_layers: int | None = None,
                 calib: Calibrator | None = None,
                 calib_policy: Policy | None = None) -> RecipeResult:
    """Run ``recipe`` end-to-end against a model + calibration batches.

    ``policy`` is the evaluation policy (drives per-site format resolution
    for ``static`` passes with ``fmt=None``); defaults to the recipe's
    ``policy_preset``.  ``calib_policy`` is the policy used for observation
    passes (defaults to ``policy``).  A pre-collected fresh ``calib`` is
    used until the first param-mutating pass invalidates it.
    """
    recipe = as_recipe(recipe)
    n_layers = n_layers if n_layers is not None else model.cfg.n_layers
    if policy is None:
        if recipe.policy_preset is None:
            raise RecipeError(
                f"recipe {recipe.name!r} has no policy_preset; pass an "
                "explicit policy"
            )
        policy = policy_preset(recipe.policy_preset, n_layers=n_layers)
    obs_policy = calib_policy if calib_policy is not None else policy
    if not getattr(obs_policy, "enabled", False) and any(
            PASS_KINDS[s.kind].needs_stats
            for s in recipe.passes if s.kind in PASS_KINDS):
        raise RecipeError(
            f"recipe {recipe.name!r} consumes activation statistics but the "
            f"observation policy {getattr(obs_policy, 'name', obs_policy)!r} "
            "is disabled (fp32) — observers never fire; pass an enabled "
            "calib_policy (e.g. preset('w4a8_mse'))"
        )

    def calibrate_fn(p: dict, collect_outer: bool) -> Calibrator:
        from repro_torch.models import quant_transforms as qt

        return qt.calibrate(model, p, batches, obs_policy,
                            collect_outer=collect_outer)

    engine = RecipeEngine(policy=policy, n_layers=n_layers,
                          calibrate_fn=calibrate_fn)
    return engine.run(recipe, params, calib=calib)


# ---------------------------------------------------------------------------
# Built-in passes (impls live in repro_torch.models.quant_transforms —
# imported lazily so core.recipe has no module-level dependency on the
# models layer)
# ---------------------------------------------------------------------------
@quant_pass("smoothquant", reads=("params", "calib"), writes=("params",),
            defaults=(("alpha", 0.5), ("plus_one_norm", False)))
def _run_smoothquant(state: RecipeState, opts: dict, site_filter) -> dict:
    """Fold difficulty-migration factors into norm->projection pairs."""
    from repro_torch.models import quant_transforms as qt

    state.params, n_folded = qt._smoothquant_params(
        state.params, state.calib, alpha=opts["alpha"],
        plus_one_norm=opts["plus_one_norm"], site_filter=site_filter,
    )
    return {"folded_sites": n_folded}


@quant_pass("gptq", reads=("params", "hessian"), writes=("params",),
            defaults=(("fmt", "int4"), ("percdamp", 0.01),
                      ("blocksize", 128), ("group_size", -1),
                      ("actorder", False)))
def _run_gptq(state: RecipeState, opts: dict, site_filter) -> dict:
    """Second-order weight rounding against fresh Hessians."""
    from repro_torch.core.gptq import GPTQConfig
    from repro_torch.models import quant_transforms as qt

    cfg = GPTQConfig(percdamp=opts["percdamp"], blocksize=opts["blocksize"],
                     group_size=opts["group_size"], actorder=opts["actorder"])
    state.params, infos = qt._gptq_params(
        state.params, state.calib, get_format(opts["fmt"]), cfg,
        site_filter=site_filter,
    )
    state.artifacts.setdefault("gptq", {}).update(infos)
    return {"fmt": opts["fmt"], "kernels": len(infos)}


@quant_pass("static", reads=("calib",), writes=("qtree",),
            defaults=(("fmt", None), ("method", "mse")))
def _run_static(state: RecipeState, opts: dict, site_filter) -> dict:
    """Static activation calibration (paper §II-B1) into the q tree.

    ``fmt=None`` solves each site against its policy-resolved input format
    (the mixed-precision path); a format name solves every scoped site
    against that format.
    """
    from repro_torch.models import quant_transforms as qt

    if opts["fmt"] is None:
        alphas = qt.solve_alphas_for_policy(
            state.calib, state.policy, method=opts["method"],
            site_filter=site_filter,
        )
    else:
        alphas = qt.solve_alphas(
            state.calib, get_format(opts["fmt"]), method=opts["method"],
            site_filter=site_filter,
        )
    tree, dropped = qt.build_qtree(state.n_layers, alphas)
    state.qtree = _merge_qtree(state.qtree, tree)
    state.dropped_sites.update(dropped)
    return {"sites_solved": len(alphas), "dropped": len(dropped)}


@quant_pass("rptq", reads=("calib",), writes=("qtree",),
            defaults=(("num_clusters", 8),))
def _run_rptq(state: RecipeState, opts: dict, site_filter) -> dict:
    """Channel-cluster static scales (paper §II-B5) into the q tree."""
    from repro_torch.models import quant_transforms as qt

    alphas, perms = qt._rptq_alphas(
        state.calib, num_clusters=opts["num_clusters"],
        site_filter=site_filter,
    )
    tree, dropped = qt.build_qtree(state.n_layers, alphas)
    state.qtree = _merge_qtree(state.qtree, tree)
    state.dropped_sites.update(dropped)
    state.artifacts.setdefault("rptq_perms", {}).update(perms)
    return {"sites_solved": len(alphas), "dropped": len(dropped)}


# ---------------------------------------------------------------------------
# Registry: named recipes next to the policy presets
# ---------------------------------------------------------------------------
_RECIPES: dict[str, QuantRecipe] = {}


def register_recipe(recipe: QuantRecipe, overwrite: bool = False) -> QuantRecipe:
    key = recipe.name.lower()
    if key in _RECIPES and not overwrite:
        raise RecipeError(f"recipe {recipe.name!r} already registered")
    _RECIPES[key] = recipe.validate()
    return recipe


def recipe_names() -> list[str]:
    return sorted(_RECIPES)


def get_recipe(name: str) -> QuantRecipe:
    """Look up a registered recipe; ``a+b`` composes registered parts."""
    key = name.lower()
    if key in _RECIPES:
        return _RECIPES[key]
    if "+" in key:
        parts = []
        for part in key.split("+"):
            if part not in _RECIPES:
                raise RecipeError(
                    f"unknown recipe part {part!r} in {name!r}; known: "
                    f"{recipe_names()}"
                )
            parts.append(_RECIPES[part])
        composed = parts[0]
        for p in parts[1:]:
            composed = composed + p
        return dataclasses.replace(composed, name=key).validate()
    raise RecipeError(
        f"unknown recipe {name!r}; known: {recipe_names()} "
        "(+ '+'-compositions of them)"
    )


def as_recipe(obj) -> QuantRecipe:
    """Coerce a recipe name / dict / QuantRecipe to a QuantRecipe."""
    if isinstance(obj, QuantRecipe):
        return obj
    if isinstance(obj, str):
        return get_recipe(obj)
    if isinstance(obj, Mapping):
        return recipe_from_dict(dict(obj))
    raise RecipeError(f"cannot interpret {type(obj).__name__} as a recipe")


def quantizes_weights_offline(recipe) -> bool:
    """True when the recipe leaves pre-quantized weights behind (a GPTQ
    pass).  Consumers evaluating/serving its output should disable the
    runtime weight quantizer (``replace_enabled(policy, weight=None)``) —
    re-quantizing an already-QDQ'd kernel against a shrunken channel-max
    alpha adds pure double-quantization noise."""
    return any(spec.kind == "gptq" for spec in as_recipe(recipe).passes)


# Single-method recipes (the paper's individual PTQ columns).
register_recipe(QuantRecipe("static_mse", (PassSpec("static"),)))
register_recipe(QuantRecipe(
    "static_max", (PassSpec("static", options={"method": "max"}),)))
register_recipe(QuantRecipe("smoothquant", (PassSpec("smoothquant"),)))
register_recipe(QuantRecipe("gptq", (PassSpec("gptq"),)))
register_recipe(QuantRecipe("rptq", (PassSpec("rptq"),)))

# Method+format bundles (a method paired with its evaluation policy).
register_recipe(QuantRecipe(
    "rptq_w4a8", (PassSpec("rptq"),), policy_preset="w4a8_mse"))
register_recipe(QuantRecipe(
    "sq_gptq_w4a8",
    (PassSpec("smoothquant"), PassSpec("gptq"), PassSpec("static")),
    policy_preset="w4a8_mse",
))

# Site-aware showcase: FP8-E4M3 attention takes static-MSE only, while the
# INT4/INT8 FFNs (and everything else) take SmoothQuant+GPTQ before their
# static solve — one pipeline, scoped by the same patterns PolicyMap uses.
register_recipe(QuantRecipe(
    "fp8attn_mse+int4ffn_sqgptq",
    (
        PassSpec("smoothquant", sites="*ffn*"),
        PassSpec("gptq", sites="*ffn*", options={"fmt": "int4"}),
        PassSpec("static"),  # fmt=None: each site solves vs its policy format
    ),
    policy_preset="w4ffn_fp8attn_mse",
))
