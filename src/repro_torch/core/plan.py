"""CompressionPlan: per-linear compression policy as ordered glob rules
(port of ``repro.core.plan``; the DSL and the JSON it writes are the
reference's letter for letter, so a plan string moves between the two
packages unchanged).

A plan is an ordered rule list; each rule matches ``linear_paths`` names
(glob) plus an optional layer range, and resolves to a registered
compressor with per-rule hyper-parameters. First match wins; unmatched
linears stay dense.

Spec formats (``CompressionPlan.parse`` accepts all of them):

inline DSL — ``;``-separated ``[layers/]pattern=method[@k=v,...]``::

    attn.*=sparsegpt; moe.shared.*=slab@cr=0.4; *=slab
    0-3/mlp.*=wanda@pattern=2:4; *=slab        # layers 0..3 only

JSON — a list of rule objects (or ``{"base": {...}, "rules": [...]}``;
loose keys are per-rule options)::

    [{"match": "attn.*", "method": "sparsegpt", "layers": "0-3"},
     {"match": "*", "method": "slab", "cr": 0.4, "pattern": "2:4"}]

``@/path/to/plan.json`` loads the JSON from a file. Layer ranges:
``"2"``, ``"0-3"``, ``"5-"`` (open end), ``"-2"``, comma-separated
unions. Option values are JSON literals where possible (``cr=0.4`` ->
float), bare strings otherwise (``pattern=2:4``); the bare word ``auto``
is a True flag. Options naming ``SLaBConfig`` fields override the plan's
base config; anything else goes to the compressor's constructor (e.g.
``alt_iters`` for ``hassle``).

**Auto-allocated CRs** — a rule with the ``auto`` flag leaves its ``cr``
to the sensitivity-driven budget allocator (``core.allocator``);
plan-level allocator options ride as bare ``key=value`` segments (keys:
``budget`` / ``floor`` / ``ceiling`` / ``candidates`` /
``granularity``)::

    *=slab@auto; budget=0.5
    attn.*=sparsegpt; *=slab@auto,iters=4; budget=0.6; ceiling=0.9

Such a plan cannot be resolved directly (``resolve`` raises); the
pipeline routes it through ``core.allocator.allocate_plan``, which
returns a concrete plan with per-(layer, path) ``cr`` rules.

Plans round-trip: ``parse(plan.to_dsl())``, ``parse(plan.to_json())``
and ``parse(repr(plan))`` all give an equal plan (string option values
must not contain ``,`` or ``;``, which the DSL reserves).

``CalibrationSpec`` wraps the calibration token array with a streaming
chunk size: the pipeline forwards one chunk at a time and the tap
statistics accumulate across chunks inside one capture.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import functools
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import compressor as compressor_lib
from repro_torch.core.slab import SLaBConfig

_SKIP_METHODS = ("skip", "none")
_SCFG_FIELDS = {f.name for f in dataclasses.fields(SLaBConfig)}
# plan-level allocator options: bare "key=value" DSL segments / loose
# JSON keys consumed by core.allocator.allocate_plan
_AUTO_KEYS = ("budget", "floor", "ceiling", "candidates", "granularity")


@functools.lru_cache(maxsize=256)
def _parse_layer_spec(spec: str) -> Tuple[Tuple[int, Optional[int]], ...]:
    """``"0-3,7,12-"`` -> ((0, 3), (7, 7), (12, None)) inclusive ranges."""
    out: List[Tuple[int, Optional[int]]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo_s, hi_s = part.split("-", 1)
            lo = int(lo_s) if lo_s.strip() else 0
            hi = int(hi_s) if hi_s.strip() else None
            out.append((lo, hi))
        else:
            v = int(part)
            out.append((v, v))
    if not out:
        raise ValueError(f"empty layer spec {spec!r}")
    return tuple(out)


def _layers_match(layers, layer: int) -> bool:
    if layers is None:
        return True
    if isinstance(layers, int):
        return layer == layers
    if isinstance(layers, (list, tuple)):
        return layer in layers
    return any(lo <= layer and (hi is None or layer <= hi)
               for lo, hi in _parse_layer_spec(str(layers)))


def _coerce(v: str) -> Any:
    try:
        return json.loads(v)
    except (json.JSONDecodeError, ValueError):
        return v


@dataclasses.dataclass
class PlanRule:
    """One policy rule: glob over linear-path names + layer range ->
    compressor name + per-rule options."""

    match: str                                # glob, e.g. "attn.*"
    method: str                               # registry name or "skip"
    layers: Union[str, int, Sequence[int], None] = None
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        # normalize int / int-list layer specs to the DSL string form
        # so equality and to_dsl/repr round-trips hold for every
        # construction route (5 == parse("5/...") layers)
        if isinstance(self.layers, int):
            self.layers = str(self.layers)
        elif isinstance(self.layers, (list, tuple)):
            self.layers = ",".join(str(x) for x in self.layers)

    def matches(self, layer: int, path: str) -> bool:
        return (fnmatch.fnmatchcase(path, self.match)
                and _layers_match(self.layers, layer))


@dataclasses.dataclass(frozen=True)
class ResolvedCompression:
    """What a plan hands the pipeline for one (layer, path)."""

    method: str
    compressor: compressor_lib.Compressor

    @property
    def needs(self):
        return self.compressor.needs

    @property
    def scfg(self) -> SLaBConfig:
        return self.compressor.scfg


class CompressionPlan:
    """Ordered rules; ``resolve`` is first-match-wins."""

    def __init__(self, rules: Sequence[PlanRule],
                 base: SLaBConfig = SLaBConfig(),
                 auto_options: Optional[Dict[str, Any]] = None):
        self.rules = list(rules)
        self.base = base
        self.auto_options = dict(auto_options or {})
        self._built: Dict[int, ResolvedCompression] = {}

    @property
    def is_auto(self) -> bool:
        """True while any rule still needs the budget allocator to pin
        its CR (the ``@auto`` flag)."""
        return any(r.options.get("auto") for r in self.rules)

    @property
    def wants_allocation(self) -> bool:
        """True when the pipeline should route this plan through the
        budget allocator: any ``@auto`` rule, or a plan-level
        ``budget=`` with at least one allocatable rule (non-skip, no
        explicit ``cr=`` pin). The latter keeps ``'*=slab; budget=0.5'``
        honest — a budget segment is never silently dropped — while
        allocator-emitted plans (every rule pinned by ``cr=``) stay
        concrete."""
        if self.is_auto:
            return True
        if self.auto_options.get("budget") is None:
            return False
        return any(r.method not in _SKIP_METHODS and "cr" not in r.options
                   for r in self.rules)

    def matching_rule(self, layer: int, path: str) -> Optional[PlanRule]:
        """The first rule matching (layer, path), skip rules included."""
        for rule in self.rules:
            if rule.matches(layer, path):
                return rule
        return None

    def resolve(self, layer: int, path: str, allow_auto: bool = False
                ) -> Optional[ResolvedCompression]:
        """Compressor for (layer, path); None = leave dense (an explicit
        ``skip`` rule or no matching rule at all). ``allow_auto`` builds
        ``@auto`` rules at the base config's CR (probe-only use — the
        allocator reads ``needs``/``keep_fraction_for`` this way)."""
        for i, rule in enumerate(self.rules):
            if not rule.matches(layer, path):
                continue
            if rule.method in _SKIP_METHODS:
                return None
            if rule.options.get("auto") and not allow_auto:
                raise ValueError(
                    f"plan rule {rule.match!r} is @auto: its CR is not "
                    f"allocated yet — run core.allocator.allocate_plan "
                    f"(or give the plan a 'budget=' segment and let the "
                    f"pipeline allocate)")
            if i not in self._built:
                self._built[i] = self._build(rule)
            return self._built[i]
        return None

    def _build(self, rule: PlanRule) -> ResolvedCompression:
        over = {k: v for k, v in rule.options.items() if k in _SCFG_FIELDS}
        extra = {k: v for k, v in rule.options.items()
                 if k not in _SCFG_FIELDS and k != "auto"}
        if isinstance(over.get("group"), list):
            over["group"] = tuple(over["group"])
        scfg = dataclasses.replace(self.base, **over)
        return ResolvedCompression(
            rule.method, compressor_lib.get(rule.method, scfg, **extra))

    # -- serialization (round-trips through parse) --------------------

    def to_dsl(self) -> str:
        """The inline-DSL form; ``parse(plan.to_dsl())`` == ``plan``."""
        segs = [f"{k}={_fmt_opt(v)}" for k, v in self.auto_options.items()]
        segs += [_rule_to_dsl(r) for r in self.rules]
        return "; ".join(segs)

    def to_json(self) -> str:
        """The JSON-dict form; ``parse(plan.to_json())`` == ``plan``."""
        obj: Dict[str, Any] = {}
        bover = {f.name: getattr(self.base, f.name)
                 for f in dataclasses.fields(SLaBConfig)
                 if getattr(self.base, f.name) != f.default}
        if bover:
            obj["base"] = {k: list(v) if isinstance(v, tuple) else v
                           for k, v in bover.items()}
        obj.update(self.auto_options)
        rules = []
        for r in self.rules:
            d: Dict[str, Any] = {"match": r.match, "method": r.method}
            if r.layers is not None:
                d["layers"] = r.layers         # normalized str form
            if r.options:
                d["options"] = dict(r.options)
            rules.append(d)
        obj["rules"] = rules
        return json.dumps(obj)

    def __eq__(self, other) -> bool:
        return (isinstance(other, CompressionPlan)
                and self.rules == other.rules
                and self.base == other.base
                and self.auto_options == other.auto_options)

    def __repr__(self) -> str:
        return f"CompressionPlan({self.to_dsl()})"

    # -- parsing -----------------------------------------------------

    @classmethod
    def parse(cls, spec, base: SLaBConfig = SLaBConfig()
              ) -> "CompressionPlan":
        if isinstance(spec, CompressionPlan):
            return spec
        if isinstance(spec, PlanRule):
            return cls([spec], base)
        auto_options: Dict[str, Any] = {}
        if isinstance(spec, str):
            s = spec.strip()
            if s.startswith("CompressionPlan(") and s.endswith(")"):
                s = s[len("CompressionPlan("):-1].strip()  # repr round-trip
            if s.startswith("@"):
                with open(s[1:]) as f:
                    spec = json.load(f)
            else:
                parsed = None
                if s and s[0] in "{[":
                    # looks like JSON — but a DSL rule may also start
                    # with a fnmatch character class ("[am]*.out=skip"),
                    # so fall back to the DSL on a parse failure
                    try:
                        parsed = json.loads(s)
                    except json.JSONDecodeError:
                        parsed = None
                if parsed is not None:
                    spec = parsed
                else:
                    rules: List[PlanRule] = []
                    for seg in s.split(";"):
                        seg = seg.strip()
                        if not seg:
                            continue
                        k, eq, v = seg.partition("=")
                        if eq and k.strip() in _AUTO_KEYS and "/" not in k:
                            auto_options[k.strip()] = _coerce(v.strip())
                        else:
                            rules.append(_parse_inline_rule(seg))
                    spec = rules
        if isinstance(spec, dict):
            if "method" in spec:               # a bare single-rule object
                spec = [spec]
            else:
                spec = dict(spec)
                for k in [k for k in spec if k in _AUTO_KEYS]:
                    auto_options[k] = spec.pop(k)
                bover = {k: v for k, v in spec.get("base", {}).items()
                         if k in _SCFG_FIELDS}
                if isinstance(bover.get("group"), list):
                    bover["group"] = tuple(bover["group"])
                base = dataclasses.replace(base, **bover)
                spec = spec.get("rules", [])
        if isinstance(spec, (list, tuple)):
            rules = [r if isinstance(r, PlanRule) else _rule_from_dict(r)
                     for r in spec]
            if not rules:
                raise ValueError(
                    "CompressionPlan spec resolved to zero rules — a "
                    "plan that compresses nothing is almost certainly a "
                    "spec mistake (use '*=skip' to skip everything)")
            return cls(rules, base, auto_options)
        raise TypeError(f"cannot parse a CompressionPlan from "
                        f"{type(spec).__name__}")


def _split_top_level(s: str, sep: str) -> List[str]:
    """Split on ``sep`` outside []/{}/() nesting, so JSON-literal option
    values like ``group=[4,1]`` survive the comma split."""
    parts: List[str] = []
    depth = 0
    cur: List[str] = []
    for ch in s:
        if ch in "[{(":
            depth += 1
        elif ch in ")}]":
            depth -= 1
        if ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def _parse_inline_rule(txt: str) -> PlanRule:
    txt = txt.strip()
    layers = None
    # a "/" is the layer-range separator only before the first "=" —
    # option *values* may legitimately contain slashes (paths etc.)
    slash, eq = txt.find("/"), txt.find("=")
    if slash != -1 and (eq == -1 or slash < eq):
        layers, txt = txt.split("/", 1)
        layers = layers.strip()
    if "=" not in txt:
        raise ValueError(f"bad plan rule {txt!r}: expected "
                         f"[layers/]pattern=method[@k=v,...]")
    match, rhs = txt.split("=", 1)
    method, _, opts = rhs.partition("@")
    options: Dict[str, Any] = {}
    for kv in filter(None, (p.strip() for p in _split_top_level(opts, ","))):
        if "=" in kv:
            k, v = kv.split("=", 1)
            options[k.strip()] = _coerce(v.strip())
        elif kv == "auto":                     # the only bare flag —
            options[kv] = True                 # anything else is a typo
        else:
            raise ValueError(f"bad option {kv!r} in plan rule {txt!r} "
                             f"(expected k=v; the only bare flag is "
                             f"'auto')")
    return PlanRule(match.strip(), method.strip(), layers, options)


def _fmt_opt(v: Any) -> str:
    """Option value in DSL form: bare strings stay bare, everything else
    is a JSON literal (so ``_coerce`` recovers the same value)."""
    return v if isinstance(v, str) else json.dumps(v)


def _rule_to_dsl(r: PlanRule) -> str:
    layers = f"{r.layers}/" if r.layers is not None else ""
    opts = ",".join(k if (v is True and k == "auto")
                    else f"{k}={_fmt_opt(v)}"
                    for k, v in r.options.items())
    return f"{layers}{r.match}={r.method}" + (f"@{opts}" if opts else "")


def _rule_from_dict(d: dict) -> PlanRule:
    d = dict(d)
    match = d.pop("match")
    method = d.pop("method")
    layers = d.pop("layers", None)
    options = dict(d.pop("options", {}))
    options.update(d)                      # loose keys are options
    return PlanRule(match, method, layers, options)


def plan_for_method(method: str, scfg: SLaBConfig = SLaBConfig()
                    ) -> CompressionPlan:
    """The ``method=`` sugar: one catch-all rule."""
    return CompressionPlan([PlanRule("*", method)], base=scfg)


# ------------------------------------------------------------------
# Streaming calibration
# ------------------------------------------------------------------

@dataclasses.dataclass
class CalibrationSpec:
    """Calibration data + streaming policy.

    ``tokens`` is (N, S) int ids, or (N, S, D) embeds for the
    stub-frontend families, a numpy array or a tensor.
    ``batch_size`` sequences are forwarded per chunk; tap statistics
    accumulate across chunks inside one ``TapCapture``, so N can exceed
    what a single forward fits. None keeps the single-batch behaviour.
    """

    tokens: Any
    batch_size: Optional[int] = None

    def batches(self) -> list:
        t = (self.tokens if torch.is_tensor(self.tokens)
             else np.asarray(self.tokens))
        bs = self.batch_size or t.shape[0]
        if bs <= 0:
            raise ValueError(f"batch_size must be positive, got {bs}")
        return [t[i:i + bs] for i in range(0, t.shape[0], bs)]
