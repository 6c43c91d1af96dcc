"""The port's budget allocator (``core.allocator``) against the
reference's on bridged weights and bridged tap statistics:
stablelm_12b SMOKE (GQA, 2 layers) at f32.

- ``allocate_plan(budget=0.5, template="*=slab")`` emits the reference's
  plan string, ``achieved`` within 1e-9 and per-linear frontiers at rel
  < 1e-6 (float64 probe sums on both sides); also with an N:M rule,
  whose probe calls ``prune_mask`` per candidate;
- ``waterfill`` returns the reference's CRs on hand-checkable fixtures
  and raises where it raises;
- an ``@auto`` plan through ``compress_model`` costs one calibration
  pass; an unallocated ``@auto`` rule raises on ``resolve``; a pinned
  ``cr=`` rule is never overridden.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import allocator as ref_alloc
from repro.core import compressor as ref_compressor
from repro.core import pipeline as ref_pipeline
from repro.core import plan as ref_plan
from repro.data import calibration_batch
from repro.models import lm as ref_lm
from repro_torch import bridge, configs
from repro_torch.core import allocator
from repro_torch.core import compressor as compressor_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core.allocator import (Frontier, allocate_plan,
                                        measured_global_cr, waterfill)
from repro_torch.core.pipeline import collect_model_stats, compress_model
from repro_torch.core.slab import SLaBConfig
from repro_torch.models import lm

NM_TEMPLATE = "mlp.*=wanda@pattern=2:4; *=slab@iters=2"


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def model():
    cfg_r = ref_configs.get("stablelm_12b", smoke=True).with_(
        dtype=jnp.float32)
    cfg = configs.get("stablelm_12b", smoke=True).with_(dtype=torch.float32)
    params_r, _ = ref_lm.init(cfg_r, jax.random.PRNGKey(0))
    params = bridge.params(jax.tree.map(np.asarray, params_r), cfg.n_layers,
                           device="cpu")
    calib = calibration_batch(cfg.vocab, n_seq=4, seq_len=16)
    return cfg_r, cfg, params_r, params, calib


@pytest.fixture(scope="module")
def ref_stats(model):
    cfg_r, _, params_r, _, calib = model
    return ref_pipeline.collect_model_stats(cfg_r, params_r, calib,
                                            plan="*=slab")


# ------------------------------------------------------------------
# allocate_plan on bridged statistics
# ------------------------------------------------------------------

def _both(model, ref_stats, template, budget=0.5, **kw):
    cfg_r, cfg, params_r, params, _ = model
    want = ref_alloc.allocate_plan(cfg_r, params_r, budget=budget,
                                   template=template, stats=ref_stats, **kw)
    got = allocate_plan(cfg, params, budget=budget, template=template,
                        stats=bridge.tap_stats(ref_stats, device="cpu"),
                        device="cpu", **kw)
    return want, got


@pytest.mark.parametrize("template", ["*=slab", NM_TEMPLATE])
def test_allocated_plan_equals_reference(model, ref_stats, template):
    want, got = _both(model, ref_stats, template)
    assert got.plan.to_dsl() == want.plan.to_dsl()
    assert got.plan.to_json() == want.plan.to_json()
    assert got.crs == want.crs
    assert abs(got.achieved - want.achieved) < 1e-9
    assert abs(got.achieved - 0.5) <= 0.025
    assert got.predicted_err == pytest.approx(want.predicted_err, rel=1e-6)
    assert [(r["layer"], r["path"], r["method"], r["group"], r["cr"])
            for r in got.rows] == [
        (r["layer"], r["path"], r["method"], r["group"], r["cr"])
        for r in want.rows]
    for a, b in zip(got.rows, want.rows):
        assert a["err_after"] == pytest.approx(b["err_after"], rel=1e-6)
    assert len(set(got.crs.values())) > 1      # a real reallocation
    assert not got.plan.wants_allocation
    assert got.table().splitlines()[-1] == want.table().splitlines()[-1]


def test_layer_granularity_equals_reference(model, ref_stats):
    want, got = _both(model, ref_stats, "*=slab", budget=0.6,
                      granularity="layer")
    assert got.plan.to_dsl() == want.plan.to_dsl()
    assert set(got.crs) == {"L0", "L1"}


@pytest.mark.parametrize("method,pattern", [("slab", None), ("wanda", None),
                                            ("wanda", "2:4"),
                                            ("hassle", None)])
def test_frontiers_equal_reference(model, ref_stats, method, pattern):
    """Every linear's sampled CR -> predicted-error curve at rel < 1e-6
    (the N:M rule masks each candidate; infeasible candidates absent on
    both sides)."""
    cfg_r, cfg, params_r, params, _ = model
    scfg = dict(pattern=pattern)
    comp_r = ref_compressor.get(method, ref_plan.SLaBConfig(**scfg))
    comp = compressor_lib.get(method, SLaBConfig(**scfg))
    cand = allocator.DEFAULT_CANDIDATES
    assert cand == ref_alloc.DEFAULT_CANDIDATES
    for l in range(cfg.n_layers):
        for pth in ("attn.wk", "attn.wo", "mlp.w_up", "mlp.w_down"):
            w_r = ref_pipeline._get(params_r["layers"], pth)[l]
            n_r = ref_stats.norms[(l, pth)]
            want, eb_r = ref_alloc._leaf_curve(w_r, n_r, comp_r, cand)
            sec, name = pth.split(".")
            got, eb = allocator._leaf_curve(
                params["layers"][l][sec][name],
                bridge.tensor(n_r, device="cpu"), comp, cand)
            assert list(got) == list(want), (l, pth)
            assert eb == pytest.approx(eb_r, rel=1e-6)
            for cr, e in want.items():
                assert got[cr] == pytest.approx(e, rel=1e-6), (l, pth, cr)


def test_keep_fraction_for_equals_reference():
    for method in ("slab", "hassle", "wanda", "sparsegpt", "magnitude",
                   "sola"):
        for kw in ({}, {"rank": 3}, {"include_binary": False}):
            a = compressor_lib.get(method, SLaBConfig(**kw))
            b = ref_compressor.get(method, ref_plan.SLaBConfig(**kw))
            for cr in (0.05, 0.5, 0.9, 0.95):
                for shape in ((64, 96), (8, 16)):
                    assert a.keep_fraction_for(cr, *shape) == \
                        b.keep_fraction_for(cr, *shape), (method, kw, cr)
    assert compressor_lib.get("slab").keep_fraction_for(0.95, 64, 96) == 0.0


def test_compression_from_the_allocation_matches_reference(model,
                                                           ref_stats):
    """Both packages compress from the same bridged statistics under the
    same allocated plan: the same rows and measured CRs, and
    ``measured_global_cr`` within 0.025 of the budget."""
    cfg_r, cfg, params_r, params, _ = model
    want, got = _both(model, ref_stats, NM_TEMPLATE)
    out_r, rows_r = ref_pipeline.compress_model(cfg_r, params_r, None,
                                                plan=want.plan,
                                                stats=want.stats)
    out, rows = compress_model(cfg, params, None, plan=got.plan,
                               stats=got.stats, device="cpu")
    assert [(s.layer, s.name, s.method, s.variant, s.cr_requested)
            for s in rows] == [(s.layer, s.name, s.method, s.variant,
                                s.cr_requested) for s in rows_r]
    for s, s_r in zip(rows, rows_r):
        assert abs(s.cr - s_r.cr) < 1e-6
    g = measured_global_cr(out, rows)
    assert g == pytest.approx(ref_alloc.measured_global_cr(out_r, rows_r),
                              abs=1e-6)
    assert abs(g - 0.5) <= 0.025


# ------------------------------------------------------------------
# waterfill on the reference's hand fixtures
# ------------------------------------------------------------------

GRID = [0.2, 0.4, 0.6, 0.8]
FIXTURES = {
    "three_layer": ([("a", 100, GRID, [0, 1, 2, 10]),
                     ("b", 100, GRID, [0, 5, 10, 20]),
                     ("c", 100, GRID, [0, 0.5, 1.0, 1.5])],
                    dict(budget=0.6)),
    "sensitive": ([("sensitive", 10, GRID, [0, 100, 200, 300]),
                   ("easy1", 10, GRID, [0, 0.1, 0.2, 0.3]),
                   ("easy2", 10, GRID, [0, 0.1, 0.2, 0.3])],
                  dict(budget=0.6)),
    "below_floor": ([("a", 1, GRID, [0, 1, 2, 3])], dict(budget=0.1)),
    "clamps": ([("a", 1, GRID, [0, 1, 2, 10]), ("b", 1, GRID, [0, 5, 10, 20])],
               dict(budget=0.5, floor=0.4, ceiling=0.6)),
    "size_weighted": ([("big", 9000, GRID, [0, 0.1, 0.2, 0.3]),
                       ("tiny", 1000, GRID, [0, 50, 100, 200])],
                      dict(budget=0.6)),
    "size_weighted_056": ([("big", 9000, GRID, [0, 0.1, 0.2, 0.3]),
                           ("tiny", 1000, GRID, [0, 50, 100, 200])],
                          dict(budget=0.56)),
    "infeasible": ([("a", 1, GRID, [0, 1, 2, 3]),
                    ("b", 1, GRID, [0, 1, 2, 3])], dict(budget=0.9)),
    "infeasible_ceiling": ([("a", 1, GRID, [0, 1, 2, 3]),
                            ("b", 1, GRID, [0, 1, 2, 3])],
                           dict(budget=0.7, ceiling=0.6)),
    "no_admissible": ([("a", 1, GRID, [0, 1, 2, 10]),
                       ("b", 1, GRID, [0, 5, 10, 20])],
                      dict(budget=0.5, floor=0.85)),
}


def _solve(mod, fronts, kw):
    try:
        return mod.waterfill([mod.Frontier(k, s, np.asarray(c, float),
                                           np.asarray(e, float))
                              for k, s, c, e in fronts], **kw)
    except ValueError as e:
        return ("raises", str(e))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_waterfill_equals_reference(name):
    fronts, kw = FIXTURES[name]
    assert _solve(allocator, fronts, kw) == _solve(ref_alloc, fronts, kw)


def test_waterfill_random_frontiers_equal_reference():
    rng = np.random.default_rng(3)
    for _ in range(20):
        fronts = [(f"g{i}", int(rng.integers(1, 100)) * 10, GRID,
                   list(np.cumsum(rng.gamma(1.0, 5.0, size=len(GRID)))))
                  for i in range(4)]
        got = _solve(allocator, fronts, dict(budget=0.6))
        assert got == _solve(ref_alloc, fronts, dict(budget=0.6))
        pred = sum(e[GRID.index(got[k])] for k, _, _, e in fronts)
        uni = sum(e[GRID.index(0.6)] for _, _, _, e in fronts)
        assert pred <= uni + 1e-12


def test_waterfill_hand_checked_values():
    fronts, kw = FIXTURES["three_layer"]
    assert _solve(allocator, fronts, kw) == {"a": 0.6, "b": 0.4, "c": 0.8}
    assert waterfill([Frontier("a", 1, np.asarray(GRID),
                               np.asarray([0.0, 1, 2, 3]))],
                     budget=0.1) == {"a": 0.2}


# ------------------------------------------------------------------
# the pipeline's routes into the allocator
# ------------------------------------------------------------------

def test_auto_plan_compresses_in_one_calibration_pass(model, monkeypatch):
    _, cfg, _, params, calib = model
    calls = {"n": 0}
    orig = lm._layer_fwd

    def counted(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(lm, "_layer_fwd", counted)
    spec = plan_lib.CalibrationSpec(calib, batch_size=2)
    new, rows = compress_model(cfg, params, spec,
                               plan="*=wanda@auto; budget=0.6",
                               device="cpu")
    assert calls["n"] == cfg.n_layers * 2
    assert len(rows) == 14 and all(s.method == "wanda" for s in rows)
    assert len({s.cr_requested for s in rows}) > 1
    for s in rows:
        assert abs(s.cr - s.cr_requested) < 0.05
    stats = collect_model_stats(cfg, params, spec, plan="*=wanda",
                                device="cpu")
    assert stats.n_forwards == cfg.n_layers * 2


def test_unallocated_auto_rule_raises(model):
    plan = plan_lib.CompressionPlan.parse("*=slab@auto; budget=0.5")
    assert plan.is_auto and plan.wants_allocation
    with pytest.raises(ValueError, match="auto"):
        plan.resolve(0, "attn.wq")
    _, cfg, _, params, calib = model
    with pytest.raises(ValueError, match="budget"):
        compress_model(cfg, params, calib, plan="*=slab@auto", device="cpu")
    with pytest.raises(ValueError, match="infeasible"):
        allocate_plan(cfg, params, calib, budget=0.9, template="*=wanda",
                      ceiling=0.5, device="cpu")


def test_pinned_cr_rule_is_not_overridden(model, ref_stats):
    template = "attn.wq=wanda@cr=0.2; mlp.w_up=skip; *=sola@auto,softness=0.25"
    want, got = _both(model, ref_stats, template)
    assert got.plan.to_dsl() == want.plan.to_dsl()
    assert not got.plan.is_auto
    assert {r["path"] for r in got.rows}.isdisjoint({"attn.wq", "mlp.w_up"})
    _, cfg, _, params, _ = model
    for l in range(cfg.n_layers):
        assert got.plan.resolve(l, "attn.wq").scfg.cr == 0.2
        assert got.plan.resolve(l, "mlp.w_up") is None
        r = got.plan.resolve(l, "mlp.w_down")
        assert r.method == "sola" and r.compressor.softness == 0.25
    _, rows = compress_model(cfg, params, None, plan=got.plan,
                             stats=got.stats, device="cpu")
    assert all(s.cr_requested == 0.2 for s in rows if s.name == "attn.wq")
    assert not any(s.name == "mlp.w_up" for s in rows)
    # an explicit cr= in an unflagged plan is a pin too
    want, got = _both(model, ref_stats, "attn.wq=wanda@cr=0.2; *=wanda")
    assert got.plan.to_dsl() == want.plan.to_dsl()
    assert "attn.wq" not in {r["path"] for r in got.rows}
