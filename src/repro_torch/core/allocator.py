"""Sensitivity-driven per-layer compression-ratio allocation (port of
``repro.core.allocator``).

  1. **Probe** — from ONE streaming calibration pass
     (``core.pipeline.collect_model_stats``), sample each linear's
     CR -> err_after frontier: at every candidate CR the method's
     ``keep_fraction_for`` picks the W_S keep fraction, and the
     activation-weighted score mass that pruning at that fraction drops
     predicts the error (exact for score pruners such as ``wanda`` and
     ``magnitude``, a monotone proxy for ``slab`` / ``hassle``). No
     forward runs per candidate.
  2. **Group** — ``granularity="layer"`` gives each layer's linears one
     CR; the default ``"linear"`` one CR per linear. The hybrid's
     ``shared.*`` linears are one set of tied weights: one group, one
     CR, at either granularity.
  3. **Solve** — discrete water-filling: every group starts at its
     lowest admissible CR and takes, step by step, the move with the
     least predicted-error increase per unit of size-weighted CR gained,
     until the global budget is met. The uniform-at-budget allocation is
     the fallback, so the result is never predicted worse than it.
  4. **Emit** — a concrete ``CompressionPlan``: one
     ``layer/path=method@cr=...`` rule per allocated linear, the pinned
     rules of the template kept behind them. Handing ``Allocation.stats``
     back to ``compress_model(stats=...)`` keeps allocate + compress at
     one calibration pass.

The probe runs on ``device``, where the weights live. Its squared scores, their sorted
cumulative sums and the error sums are float64, as the reference's
numpy probe is: at float32 the water-filling ratios of near-equal groups
can order differently, and the chosen CRs then differ from the
reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import plan as plan_lib
from repro_torch.core import sparsity
from repro_torch.core.pipeline import (ModelTapStats, _device_for, _get,
                                       _tap_paths, collect_model_stats,
                                       shared_layer, stats_on)
from repro_torch.core.slab import SLaBConfig

# 0.05 .. 0.95: dense enough that the budget is hit within ±2.5 % per
# group, coarse enough that the probe stays a few masks per linear
DEFAULT_CANDIDATES = tuple(round(0.05 * i, 2) for i in range(1, 20))
DEFAULT_FLOOR = 0.05
DEFAULT_CEILING = 0.95


@dataclasses.dataclass
class Frontier:
    """Sampled CR -> predicted-err_after curve of one allocation group.

    ``errs[i]`` predicts the summed ``CompressStats.err_after`` of the
    group's members at ``crs[i]`` (ascending, feasible candidates only);
    ``size`` is the members' parameter count (the budget weight)."""

    key: str
    size: int
    crs: np.ndarray
    errs: np.ndarray
    members: Tuple[Tuple[int, str], ...] = ()
    err_before: float = 0.0


@dataclasses.dataclass
class Allocation:
    """What ``allocate_plan`` decided, and the statistics it probed."""

    plan: plan_lib.CompressionPlan       # concrete: every cr pinned
    stats: ModelTapStats                 # pass to compress_model(stats=)
    crs: Dict[str, float]                # group key -> allocated CR
    rows: List[dict]                     # per (layer, path) report
    budget: float
    achieved: float                      # size-weighted requested CR
    predicted_err: float                 # summed predicted err_after

    def table(self) -> str:
        lines = [f"{'layer':>5}  {'path':<20} {'method':<10} "
                 f"{'cr':>6}  {'pred err_after':>14}"]
        for r in self.rows:
            lines.append(f"{r['layer']:>5}  {r['path']:<20} "
                         f"{r['method']:<10} {r['cr']:>6.3f}  "
                         f"{r['err_after']:>14.4g}")
        lines.append(f"budget={self.budget:.3f} -> achieved "
                     f"{self.achieved:.3f} (size-weighted), predicted "
                     f"err sum {self.predicted_err:.4g}")
        return "\n".join(lines)


def measured_global_cr(params: dict, rows) -> float:
    """Size-weighted measured CR over ``CompressStats`` rows, the
    quantity ``budget`` targets (parameter-count weights; a row's size
    is its layer's own leaf, and a hybrid ``shared.*`` row's its
    ``shared_attn`` leaf)."""
    tot = wsum = 0.0
    for s in rows:
        leaf = _leaf(params, s.layer, s.name)
        sz = 0.0 if leaf is None else float(leaf.numel())
        tot += sz
        wsum += sz * s.cr
    return wsum / max(tot, 1.0)


# ------------------------------------------------------------------
# Sensitivity probe
# ------------------------------------------------------------------

def _group_cum(s2: torch.Tensor, group) -> Tuple[torch.Tensor, int]:
    """Per-comparison-group ascending cumulative score mass, tiled as
    ``sparsity.group_topk_mask`` tiles (gcd fallback included):
    ``cum[:, p-1]`` is each group's p smallest squared scores summed, so
    keeping the top k drops ``cum[:, gsz-k-1]``. Exact for unstructured
    group top-k pruning (ties carry equal mass)."""
    d_out, d_in = s2.shape
    g_rows = group[0] or d_out
    g_cols = group[1] or d_in
    if d_out % g_rows or d_in % g_cols:
        g_rows = math.gcd(g_rows, d_out)
        g_cols = math.gcd(g_cols, d_in)
    gsz = g_rows * g_cols
    s = s2.reshape(d_out // g_rows, g_rows, d_in // g_cols, g_cols)
    s = s.permute(0, 2, 1, 3).reshape(-1, gsz)
    return torch.cumsum(torch.sort(s, dim=1).values, dim=1), gsz


def _leaf_curve(w: torch.Tensor, norms: Optional[torch.Tensor], comp,
                candidates: Sequence[float]
                ) -> Tuple[Dict[float, float], float]:
    """(cr -> predicted err_after, err_before) of one parameter leaf in
    model orientation: (D_in, D_out), or (E, D_in, D_out) stacked
    experts. Infeasible candidates (keep fraction <= 0, or above an N:M
    pattern's ceiling) are absent from the curve.

    Unstructured rules evaluate every candidate from ONE sort per matrix
    (the group-wise cumulative score mass); N:M rules call the real
    ``prune_mask`` per candidate (the pre-mask interacts with the group
    top-k)."""
    arr = w.float()
    if arr.dim() == 3:
        mats = [arr[e].T for e in range(arr.shape[0])]
        nrm = None if norms is None else norms.float()
        nrms = [None if nrm is None else (nrm[e] if nrm.dim() == 2 else nrm)
                for e in range(arr.shape[0])]
    else:
        mats = [arr.T]
        nrms = [None if norms is None else norms.float()]
    d_out, d_in = mats[0].shape
    smats = [m.abs() * n[None, :] if n is not None else m.abs()
             for m, n in zip(mats, nrms)]
    s2 = [s.double() ** 2 for s in smats]
    err_before = math.sqrt(sum(float(x.sum()) for x in s2))
    unstructured = comp.scfg.pattern is None
    if unstructured:
        cums = [_group_cum(x2, comp.scfg.group) for x2 in s2]

    curve: Dict[float, float] = {}
    for cr in candidates:
        frac = comp.keep_fraction_for(float(cr), d_out, d_in)
        if frac <= 0.0:
            continue
        err2 = 0.0
        ok = True
        if unstructured:
            for cum, gsz in cums:
                p = gsz - min(int(math.floor(frac * gsz)), gsz)
                if p > 0:
                    err2 += float(cum[:, p - 1].sum())
        else:
            for s, x2 in zip(smats, s2):
                try:
                    mask = sparsity.prune_mask(s, frac,
                                               group=comp.scfg.group,
                                               pattern=comp.scfg.pattern)
                except ValueError:  # keep_frac above the N:M ceiling
                    ok = False
                    break
                err2 += float(x2[~mask].sum())
        if ok:
            curve[float(cr)] = math.sqrt(err2)
    return curve, err_before


# ------------------------------------------------------------------
# Water-filling solver
# ------------------------------------------------------------------

def waterfill(frontiers: Sequence[Frontier], budget: float,
              floor: float = 0.0, ceiling: float = 1.0
              ) -> Dict[str, float]:
    """One CR per frontier such that the size-weighted mean CR meets
    ``budget`` at the least summed predicted error.

    Discrete greedy water-filling: every group starts at its lowest
    admissible candidate; the step with the smallest marginal error
    increase per unit of size-weighted CR gained is taken until the
    budget is reached (ties break on the group key). The uniform
    allocation (every group at its smallest candidate >= budget) is the
    fallback, so the result is never predicted worse than uniform.
    Raises ValueError when the budget is infeasible (every group at its
    ceiling still falls short) or a group has no admissible candidate."""
    if not frontiers:
        raise ValueError("waterfill needs at least one frontier")
    work = []
    for fr in sorted(frontiers, key=lambda f: f.key):
        sel = [(float(c), float(e)) for c, e in zip(fr.crs, fr.errs)
               if floor - 1e-12 <= c <= ceiling + 1e-12]
        if not sel:
            raise ValueError(
                f"group {fr.key!r}: no admissible CR candidates inside "
                f"[floor={floor}, ceiling={ceiling}]")
        work.append((fr, [c for c, _ in sel], [e for _, e in sel]))
    total = float(sum(fr.size for fr, _, _ in work))
    idx = {fr.key: 0 for fr, _, _ in work}
    cur = sum(fr.size * crs[0] for fr, crs, _ in work) / total

    while cur + 1e-9 < budget:
        best = None
        for fr, crs, errs in work:
            i = idx[fr.key]
            if i + 1 >= len(crs):
                continue
            gain = fr.size * (crs[i + 1] - crs[i]) / total
            cost = max(errs[i + 1] - errs[i], 0.0)
            cand = (cost / gain, fr.key, gain)
            if best is None or cand[:2] < best[:2]:
                best = cand
        if best is None:
            raise ValueError(
                f"budget={budget:.3f} infeasible: every group is at its "
                f"ceiling (max achievable size-weighted CR {cur:.3f})")
        idx[best[1]] += 1
        cur += best[2]

    greedy_err = sum(errs[idx[fr.key]] for fr, _, errs in work)
    uniform = {}
    for fr, crs, errs in work:
        js = [j for j, c in enumerate(crs) if c >= budget - 1e-9]
        if not js:
            uniform = None
            break
        uniform[fr.key] = js[0]
    if uniform is not None:
        uni_err = sum(errs[uniform[fr.key]] for fr, _, errs in work)
        if uni_err < greedy_err:     # greedy is a heuristic on unequal
            idx = uniform            # steps: never worse than uniform
    return {fr.key: crs[idx[fr.key]] for fr, crs, _ in work}


# ------------------------------------------------------------------
# End-to-end allocation
# ------------------------------------------------------------------

def _leaf(params: dict, layer: int, path: str):
    """The weight of ``path`` at ``layer``: a ``shared.*`` path's lives in
    ``params["shared_attn"]``."""
    if path.startswith("shared."):
        return _get(params.get("shared_attn", {}), path.split(".", 1)[1])
    return _get(params["layers"][layer], path)


def _group_key(layer: int, path: str, granularity: str) -> str:
    if path.startswith("shared."):
        return "shared"              # one set of tied weights: one CR
    if granularity == "layer":
        return f"L{layer}"
    return f"L{layer}/{path}"


def allocate_plan(cfg, params: dict, calib=None,
                  budget: Optional[float] = None, template=None, *,
                  plan=None,
                  stats: Optional[ModelTapStats] = None,
                  candidates: Optional[Sequence[float]] = None,
                  floor: Optional[float] = None,
                  ceiling: Optional[float] = None,
                  granularity: Optional[str] = None,
                  base: SLaBConfig = SLaBConfig(),
                  progress: Optional[Callable[[str], None]] = None,
                  device=None) -> Allocation:
    """Solve per-(layer, path) CRs that meet a global ``budget`` and emit
    a concrete ``CompressionPlan``.

    ``template`` (or a parsed ``plan``) names the methods: rules with the
    ``@auto`` flag get allocated CRs; when no rule is flagged, every
    non-skip rule WITHOUT an explicit ``cr=`` is allocatable (so
    ``allocate_plan(cfg, params, calib, 0.5, "*=slab")`` works and a
    hand-pinned ``attn.wq=wanda@cr=0.2`` is never overridden). Pinned
    rules keep their ``cr`` and stay out of the budget. Plan-level
    ``budget=`` / ``floor=`` / ``ceiling=`` / ``candidates=`` /
    ``granularity=`` segments supply defaults for those arguments.

    ``stats`` reuses a precollected ``ModelTapStats`` (moved to
    ``device``); otherwise one streaming pass over ``calib`` is collected
    here. The probe runs on ``device`` (CUDA unless ``"cpu"``), where
    ``params`` must live. Hand ``Allocation.stats`` to
    ``compress_model(stats=...)`` so that no second pass runs."""
    dev = _device_for(params, device, "allocate_plan")
    if plan is None:
        plan = plan_lib.CompressionPlan.parse(
            template if template is not None else "*=slab", base=base)
    else:
        plan = plan_lib.CompressionPlan.parse(plan, base=base)
    ao = plan.auto_options
    budget = float(budget if budget is not None else ao.get("budget", -1))
    if budget <= 0.0 or budget >= 1.0:
        raise ValueError(f"allocate_plan needs a budget in (0, 1) — got "
                         f"{budget} (pass budget= or add a 'budget=0.5' "
                         f"plan segment)")
    floor = float(floor if floor is not None
                  else ao.get("floor", DEFAULT_FLOOR))
    ceiling = float(ceiling if ceiling is not None
                    else ao.get("ceiling", DEFAULT_CEILING))
    cand = tuple(sorted(candidates if candidates is not None
                        else ao.get("candidates", DEFAULT_CANDIDATES)))
    granularity = str(granularity if granularity is not None
                      else ao.get("granularity", "linear"))
    if granularity not in ("linear", "layer"):
        raise ValueError(f"granularity must be 'linear' or 'layer', "
                         f"got {granularity!r}")

    if stats is None:
        if calib is None:
            raise ValueError("allocate_plan needs calibration data or "
                             "precollected stats=")
        stats = collect_model_stats(cfg, params, calib, plan=plan,
                                    progress=progress, device=dev)
    else:
        stats = stats_on(stats, dev)

    flagged = plan.is_auto
    groups: Dict[str, dict] = {}
    member_curves: Dict[Tuple[int, str], Dict[float, float]] = {}
    emit: List[Tuple[int, str, plan_lib.PlanRule, str]] = []
    shared_at = shared_layer(cfg, params)
    for l in range(cfg.n_layers):
        for pth in _tap_paths(cfg, l, shared_at):
            rule = plan.matching_rule(l, pth)
            if rule is None or rule.method in plan_lib._SKIP_METHODS:
                continue
            if flagged and not rule.options.get("auto"):
                continue             # pinned rule: its cr stays as-is
            if not flagged and "cr" in rule.options:
                continue             # explicit cr= is a pin, not a hint
            comp = plan.resolve(l, pth, allow_auto=True)
            w = _leaf(params, l, pth)
            if w is None:
                continue
            curve, err_b = _leaf_curve(w, stats.norms.get((l, pth)),
                                       comp.compressor, cand)
            key = _group_key(l, pth, granularity)
            g = groups.setdefault(key, {"size": 0, "curves": [],
                                        "members": [], "err_before": 0.0})
            g["size"] += int(w.numel())
            g["curves"].append(curve)
            g["members"].append((l, pth))
            g["err_before"] += err_b
            member_curves[(l, pth)] = curve
            emit.append((l, pth, rule, key))
    if not groups:
        raise ValueError("plan matched no allocatable linears — nothing "
                         "to allocate a budget over")

    frontiers = []
    for key, g in sorted(groups.items()):
        common = sorted(set.intersection(*(set(c) for c in g["curves"])))
        if not common:
            raise ValueError(
                f"group {key!r}: members share no feasible CR candidate")
        errs = [sum(c[cr] for c in g["curves"]) for cr in common]
        frontiers.append(Frontier(key, g["size"], np.asarray(common),
                                  np.asarray(errs),
                                  tuple(g["members"]), g["err_before"]))

    crs = waterfill(frontiers, budget, floor=floor, ceiling=ceiling)

    by_key = {f.key: f for f in frontiers}
    rows: List[dict] = []
    new_rules: List[plan_lib.PlanRule] = []
    consumed = set()
    for l, pth, rule, key in emit:
        cr = crs[key]
        options = {k: v for k, v in rule.options.items() if k != "auto"}
        options["cr"] = cr
        new_rules.append(plan_lib.PlanRule(pth, rule.method, layers=l,
                                           options=options))
        consumed.add(id(rule))
        rows.append({"layer": l, "path": pth, "method": rule.method,
                     "group": key, "cr": cr,
                     "err_after": member_curves[(l, pth)][cr]})
    tail = [r for r in plan.rules if id(r) not in consumed]
    # no auto_options on the emitted plan: it is concrete, and a surviving
    # budget= segment would allocate again when the plan is reused
    out_plan = plan_lib.CompressionPlan(new_rules + tail, base=plan.base)

    achieved = (sum(by_key[k].size * c for k, c in crs.items())
                / sum(by_key[k].size for k in crs))
    predicted = sum(
        float(f.errs[int(np.searchsorted(f.crs, crs[f.key]))])
        for f in frontiers)
    if progress:
        progress(f"allocated {len(frontiers)} CR groups at budget "
                 f"{budget:.3f} (achieved {achieved:.3f})")
    return Allocation(out_plan, stats, crs, rows, budget, achieved,
                      predicted)
