"""The port's compression plans, streamed tap statistics and mixed-plan
compression against the reference, on bridged weights: stablelm_12b
SMOKE (GQA, 2 layers) at f32, deepseek_moe_16b SMOKE for the per-expert
taps.

- plan strings (DSL, JSON, repr) equal the reference's letter for letter
  and resolve to the same method and ``SLaBConfig``;
- ``collect_model_stats`` over a ``CalibrationSpec`` (6 sequences in
  chunks of 2): the same keys and ``n_forwards``, norms and Hessians at
  rel < 1e-5; streamed equals unstreamed within rel < 1e-6;
- ``compress_model(plan=...)`` under a mixed plan with a ``skip`` rule:
  equal stats rows, ``cr`` within 1e-6, weights at ROADMAP §C's bounds,
  also from precollected statistics (``stats=``);
- the reference's decompositions of that plan, packed by
  ``pack_model(plan=...)``, decode to the reference's greedy tokens;
- the three dense configs added with the plans (llama3.2-3b,
  mistral-nemo-12b, nemotron-4-340b) at SMOKE size: ``forward`` at rel
  < 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:        # property tests skip without hypothesis
    from conftest import given, settings, strategies as st

from repro import configs as ref_configs
from repro.core import packed_model as ref_pm
from repro.core import pipeline as ref_pipeline
from repro.core import plan as ref_plan
from repro.core.slab import SLaBConfig as RefSLaBConfig
from repro.data import calibration_batch
from repro.launch import serve as ref_serve
from repro.models import lm as ref_lm
from repro.models.common import positions_for as ref_positions_for
from repro_torch import bridge, configs
from repro_torch.core import plan as plan_lib
from repro_torch.core.packed_model import PackedLinear, pack_model
from repro_torch.core.pipeline import (collect_model_stats, compress_model,
                                       layer_tap_stats, linear_paths)
from repro_torch.core.slab import SLaBConfig
from repro_torch.launch.serve import greedy_decode
from repro_torch.models import lm
from repro_torch.models.common import positions_for
from test_plan_roundtrip import PROBES, SPECS

MIXED = ("0/attn.wo=skip; attn.*=sparsegpt@cr=0.6; "
         "0/mlp.*=wanda@pattern=2:4; *=slab@iters=2")


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


_ref_forward = jax.jit(lambda cfg, p, t: ref_lm.forward(cfg, p, t)[0],
                       static_argnums=0)


# ------------------------------------------------------------------
# (a) plans
# ------------------------------------------------------------------

def _resolution(plan):
    """(method, SLaBConfig fields) per probe point; @auto rules probed at
    the base config."""
    out = []
    for layer, path in PROBES:
        r = plan.resolve(layer, path, allow_auto=True)
        out.append(None if r is None
                   else (r.method, dataclasses.asdict(r.scfg)))
    return out


def _same_strings(spec, **kw):
    ref = ref_plan.CompressionPlan.parse(
        spec, **{k: RefSLaBConfig(**v) for k, v in kw.items()})
    got = plan_lib.CompressionPlan.parse(
        spec, **{k: SLaBConfig(**v) for k, v in kw.items()})
    assert got.to_dsl() == ref.to_dsl()
    assert got.to_json() == ref.to_json()
    assert repr(got) == repr(ref)
    return ref, got


@pytest.mark.parametrize("spec", SPECS)
def test_plan_strings_equal_reference(spec):
    ref, got = _same_strings(spec)
    assert got.is_auto == ref.is_auto
    assert got.wants_allocation == ref.wants_allocation
    assert _resolution(got) == _resolution(ref)
    # each of the reference's strings parses back to the same port plan
    for s in (ref.to_dsl(), ref.to_json(), repr(ref)):
        assert plan_lib.CompressionPlan.parse(s) == got


@pytest.mark.parametrize("spec", SPECS)
def test_plan_strings_with_a_base_equal_reference(spec):
    _same_strings(spec, base=dict(cr=0.35, iters=3, group=(4, 1)))


@settings(max_examples=40, deadline=None)
@given(spec=st.sampled_from(SPECS), budget=st.floats(0.05, 0.95),
       swap=st.booleans())
def test_property_composed_plan_strings_equal_reference(spec, budget, swap):
    composed = f"budget={budget}; {spec}"
    ref = ref_plan.CompressionPlan.parse(composed)
    got = plan_lib.CompressionPlan.parse(composed)
    if swap and len(got.rules) > 1:
        ref = ref_plan.CompressionPlan(list(reversed(ref.rules)), ref.base,
                                       ref.auto_options)
        got = plan_lib.CompressionPlan(list(reversed(got.rules)), got.base,
                                       got.auto_options)
    assert got.to_dsl() == ref.to_dsl()
    assert got.to_json() == ref.to_json()
    assert _resolution(got) == _resolution(ref)


def test_plan_resolution_of_the_mixed_plan():
    plan = plan_lib.CompressionPlan.parse(MIXED)
    assert plan.resolve(0, "attn.wo") is None
    assert plan.resolve(1, "attn.wo").method == "sparsegpt"
    assert plan.resolve(1, "attn.wo").scfg.cr == 0.6
    assert plan.resolve(0, "mlp.w_up").scfg.pattern == "2:4"
    assert plan.resolve(1, "mlp.w_up").method == "slab"
    assert plan.resolve(1, "mlp.w_up").scfg.iters == 2
    assert plan_lib.CompressionPlan.parse("attn.*=slab").resolve(
        0, "mlp.w_up") is None
    with pytest.raises(ValueError, match="@auto"):
        plan_lib.CompressionPlan.parse("*=slab@auto").resolve(0, "attn.wq")


def test_calibration_spec_chunks():
    toks = np.arange(14).reshape(7, 2)
    assert [c.shape[0] for c in
            plan_lib.CalibrationSpec(toks, 3).batches()] == [3, 3, 1]
    assert len(plan_lib.CalibrationSpec(torch.from_numpy(toks)).batches()) \
        == 1
    with pytest.raises(ValueError, match="positive"):
        plan_lib.CalibrationSpec(toks, -1).batches()


# ------------------------------------------------------------------
# (b) tap statistics
# ------------------------------------------------------------------

def _model(arch):
    cfg_r = ref_configs.get(arch, smoke=True).with_(dtype=jnp.float32)
    cfg = configs.get(arch, smoke=True).with_(dtype=torch.float32)
    params_r, _ = ref_lm.init(cfg_r, jax.random.PRNGKey(0))
    return cfg_r, cfg, params_r, bridge.params(_np_tree(params_r),
                                               cfg.n_layers, device="cpu")


@pytest.fixture(scope="module")
def dense():
    cfg_r, cfg, params_r, params = _model("stablelm_12b")
    calib = calibration_batch(cfg.vocab, n_seq=6, seq_len=16)
    return cfg_r, cfg, params_r, params, calib


@pytest.fixture(scope="module")
def moe():
    cfg_r, cfg, params_r, params = _model("deepseek_moe_16b")
    calib = calibration_batch(cfg.vocab, n_seq=6, seq_len=16)
    return cfg_r, cfg, params_r, params, calib


def _stats_pair(model, plan):
    cfg_r, cfg, params_r, params, calib = model
    ref = ref_pipeline.collect_model_stats(
        cfg_r, params_r, ref_plan.CalibrationSpec(calib, batch_size=2),
        plan=plan)
    got = collect_model_stats(cfg, params,
                              plan_lib.CalibrationSpec(calib, batch_size=2),
                              plan=plan, device="cpu")
    return ref, got


@pytest.fixture(scope="module")
def dense_stats(dense):
    return _stats_pair(dense, MIXED)


def _hold_stats(ref, got, tol):
    assert got.n_forwards == ref.n_forwards
    assert list(got.norms) == list(ref.norms)
    assert list(got.hessians) == list(ref.hessians)
    for k, v in ref.norms.items():
        assert tuple(got.norms[k].shape) == v.shape, k
        assert _rel(got.norms[k], v) < tol, k
    for k, v in ref.hessians.items():
        assert _rel(got.hessians[k], v) < tol, k


def test_streamed_tap_stats_match_reference(dense, dense_stats):
    ref, got = dense_stats
    cfg = dense[1]
    assert got.n_forwards == cfg.n_layers * 3
    _hold_stats(ref, got, 1e-5)
    # Hessians exactly where the mixed plan's sparsegpt rules need them
    assert sorted(got.hessians) == [(0, "attn.wk"), (0, "attn.wq"),
                                    (0, "attn.wv"), (1, "attn.wk"),
                                    (1, "attn.wo"), (1, "attn.wq"),
                                    (1, "attn.wv")]


def test_streamed_tap_stats_equal_one_batch(dense, dense_stats):
    cfg_r, cfg, _, params, calib = dense
    _, streamed = dense_stats
    one = collect_model_stats(cfg, params, calib, plan=MIXED, device="cpu")
    assert one.n_forwards == cfg.n_layers
    assert list(one.norms) == list(streamed.norms)
    for k, v in one.norms.items():
        assert _rel(streamed.norms[k], v) < 1e-6, k
    for k, v in one.hessians.items():
        assert _rel(streamed.hessians[k], v) < 1e-6, k


def test_moe_tap_stats_match_reference_per_expert(moe):
    ref, got = _stats_pair(moe, "*=sparsegpt")
    cfg = moe[1]
    _hold_stats(ref, got, 1e-5)
    assert tuple(got.norms[(0, "moe.w_up")].shape) == (cfg.n_experts,
                                                         cfg.d_model)
    assert tuple(got.hessians[(0, "moe.w_down")].shape) == (
        cfg.n_experts, cfg.d_ff, cfg.d_ff)


def test_layer_tap_stats_match_reference(dense):
    cfg_r, cfg, params_r, params, calib = dense
    toks = calib[:2]
    h_r = ref_lm.embed_inputs(cfg_r, params_r, jnp.asarray(toks))
    lp_r = jax.tree.map(lambda a: a[1], params_r["layers"])
    want = ref_pipeline.layer_tap_stats(
        cfg_r, params_r, lp_r, 1, h_r,
        ref_positions_for(cfg_r, *toks.shape), hessian=True)
    h = lm.embed_inputs(cfg, params, torch.from_numpy(toks))
    got = layer_tap_stats(cfg, params, params["layers"][1], 1, h,
                          positions_for(cfg, *toks.shape), hessian=True)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == sorted(linear_paths(cfg))
        for k in w:
            assert _rel(g[k], w[k]) < 1e-5, k
    norms, hess = layer_tap_stats(cfg, params, params["layers"][1], 1, h,
                                  positions_for(cfg, *toks.shape),
                                  hessian_names={"attn.wo"})
    assert list(hess) == ["attn.wo"] and len(norms) == 7


def test_hessian_names_override(dense):
    _, cfg, _, params, calib = dense
    every = collect_model_stats(cfg, params, calib, hessian_names=True,
                                device="cpu")
    assert len(every.hessians) == len(every.norms) == 14
    some = collect_model_stats(cfg, params, calib, plan="*=wanda",
                               hessian_names={"mlp.w_down"}, device="cpu")
    assert sorted(some.hessians) == [(0, "mlp.w_down"), (1, "mlp.w_down")]
    none = collect_model_stats(cfg, params, calib, plan="*=wanda",
                               device="cpu")
    assert not none.hessians


# ------------------------------------------------------------------
# (c) mixed-plan compression
# ------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixed(dense, dense_stats):
    cfg_r, cfg, params_r, params, calib = dense
    spec_r = ref_plan.CalibrationSpec(calib, batch_size=2)
    spec = plan_lib.CalibrationSpec(calib, batch_size=2)
    ref = ref_pipeline.compress_model(cfg_r, params_r, spec_r, plan=MIXED,
                                      keep_decompositions=True)
    got = compress_model(cfg, params, spec, plan=MIXED,
                         keep_decompositions=True, device="cpu")
    ref_pre = ref_pipeline.compress_model(cfg_r, params_r, None, plan=MIXED,
                                          stats=dense_stats[0])
    got_pre = compress_model(cfg, params, None, plan=MIXED,
                             stats=bridge.tap_stats(dense_stats[0],
                                                    device="cpu"),
                             device="cpu")
    return ref, got, ref_pre, got_pre


def _row(s):
    return (s.layer, s.name, s.method, s.variant, s.cr_requested)


def _hold_compressed(cfg, ref, got):
    params_r, stats_r = ref[0], ref[1]
    params, stats = got[0], got[1]
    assert [_row(s) for s in stats] == [_row(s) for s in stats_r]
    for s, s_r in zip(stats, stats_r):
        assert abs(s.cr - s_r.cr) < 1e-6, _row(s)
        w = params["layers"][s.layer]
        for part in s.name.split("."):
            w = w[part]
        w_r = np.asarray(ref_pipeline._get(params_r["layers"],
                                           s.name)[s.layer])
        w = w.numpy()
        assert np.mean((w != 0) == (w_r != 0)) >= 0.999, _row(s)
        assert _rel(w, w_r) < 1e-4, _row(s)
    # the skipped linear is the layer's own weight, untouched
    assert torch.equal(params["layers"][0]["attn"]["wo"],
                       bridge.tensor(params_r["layers"]["attn"]["wo"][0],
                                     device="cpu"))


def test_mixed_plan_compression_matches_reference(dense, mixed):
    ref, got, _, _ = mixed
    cfg = dense[1]
    _hold_compressed(cfg, ref, got)
    assert len(got[1]) == 13
    assert {(s.method, s.variant) for s in got[1]} == {
        ("sparsegpt", "sparse-ell"), ("wanda", "sparse-nm"),
        ("slab", "slab-ell")}
    assert set(got[2]) == {(s.layer, s.name) for s in got[1]}


def test_mixed_plan_from_bridged_stats_matches_reference(dense, mixed):
    _, _, ref_pre, got_pre = mixed
    _hold_compressed(dense[1], ref_pre, got_pre)


def test_method_sugar_equals_its_plan(dense):
    _, cfg, _, params, calib = dense
    scfg = SLaBConfig(cr=0.5, iters=1)
    a = compress_model(cfg, params, calib, method="wanda", scfg=scfg,
                       device="cpu")
    b = compress_model(cfg, params, calib, scfg=scfg,
                       plan=plan_lib.plan_for_method("wanda", scfg),
                       device="cpu")
    assert [_row(s) for s in a[1]] == [_row(s) for s in b[1]]
    for la, lb in zip(a[0]["layers"], b[0]["layers"]):
        assert torch.equal(la["mlp"]["w_up"], lb["mlp"]["w_up"])


# ------------------------------------------------------------------
# (d) packed serving of the mixed plan
# ------------------------------------------------------------------

def test_mixed_plan_packed_greedy_equals_reference(dense, mixed):
    cfg_r, cfg, _, _, _ = dense
    ref = mixed[0]
    dense_r, stats_r, decs_r = ref
    packed_r, rep_r = ref_pm.pack_plan_decs(
        dense_r, decs_r, cfg_r.n_layers, ref_plan.CompressionPlan.parse(MIXED),
        dtype=jnp.float32)
    decs = {k: bridge.decomposition(d, device="cpu")
            for k, d in decs_r.items()}
    dense_p = bridge.params(_np_tree(dense_r), cfg.n_layers, device="cpu")
    packed_p, rep = pack_model(dense_p, decs, dtype=torch.float32,
                               plan=MIXED)
    assert rep.by_variant == rep_r.by_variant
    assert rep.n_packed == rep_r.n_packed == 13
    for s in stats_r:
        pl = packed_p["layers"][s.layer]
        for part in s.name.split("."):
            pl = pl[part]
        assert isinstance(pl, PackedLinear) and pl.variant == s.variant
    assert not isinstance(packed_p["layers"][0]["attn"]["wo"], PackedLinear)
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab, (3, 8)).astype(np.int32)
    want = ref_serve.greedy_decode(cfg_r, packed_r, jnp.asarray(prompts), 5)
    got = greedy_decode(cfg, packed_p, prompts, 5, device="cpu")
    assert np.array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------
# the dense configs added with this slice
# ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3_2_3b", "mistral_nemo_12b",
                                  "nemotron_4_340b"])
def test_new_dense_config_forward_matches_reference(arch):
    cfg_r, cfg, params_r, params = _model(arch)
    full_r, full = ref_configs.get(arch), configs.get(arch)
    for f in ("n_layers", "d_model", "n_heads", "n_kv", "d_head", "d_ff",
              "vocab", "act", "rope_theta"):
        assert getattr(full, f) == getattr(full_r, f), f
        assert getattr(cfg, f) == getattr(cfg_r, f), f
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 16)).astype(
        np.int32)
    want = _ref_forward(cfg_r, params_r, jnp.asarray(toks))
    got, _ = lm.forward(cfg, params, torch.from_numpy(toks))
    assert _rel(got, want) < 1e-5
