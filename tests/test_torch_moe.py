"""The port's mixture-of-experts slice against the reference on the CPU,
at the phi3.5-moe SMOKE geometry (2 layers, d_model 64, 4 experts,
top-2) and f32, on bridged weights:

- the config mirror's fields, and the bridge's per-layer expert leaves;
- ``moe_ffn`` (capacity dispatch, top-2 gates, aux loss) at rel < 1e-5,
  on an input where the capacity drops tokens too;
- the per-expert taps (norms, dispatched-row counts, Grams) at 1e-5;
- ``compress_model`` per-expert decompositions (slab at 2 iterations and
  wanda 2:4): ≥ 99.9 % equal masks, W_L ⊙ W_B at rel < 1e-3;
- ``pack_model``'s ExpertPackedStacks byte-identical to the reference's
  ``pack_expert_stack`` on the same decompositions;
- the packed ``forward``, ``decode_step`` (logits rel < 1e-4) and
  ``greedy_decode`` (tokens equal, square and ragged);
- the engine (bridged dense weights) equal to the reference engine on
  one evicting trace at the published capacity factor, and, at a
  drop-free capacity factor, token-equal to ``greedy_decode``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import packed_model as ref_pm
from repro.core import pipeline as ref_pipeline
from repro.core import slab as ref_slab
from repro.core.plan import CompressionPlan
from repro.data import calibration_batch
from repro.launch import serve as ref_serve
from repro.models import common as ref_common
from repro.models import lm as ref_lm
from repro.models import moe as ref_moe
from repro.models.common import positions_for as ref_positions_for
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import Request as RefRequest
from repro_torch import bridge, configs
from repro_torch.core import slab
from repro_torch.core.packed_model import ExpertPackedStack, pack_model
from repro_torch.core.pipeline import compress_model
from repro_torch.core.plan import plan_for_method
from repro_torch.launch.serve import greedy_decode
from repro_torch.models import common, lm, moe
from repro_torch.models.common import positions_for
from repro_torch.serving import Engine, EngineConfig, Request

EXPERT_PATHS = ("moe.w_gate", "moe.w_up", "moe.w_down")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("smoke", [True, False])
def test_config_fields_equal_reference(smoke):
    ref = ref_configs.get("phi3_5_moe", smoke=smoke)
    port = configs.get("phi3_5_moe", smoke=smoke)
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if f.name == "dtype":
            assert jnp.dtype(a).name == str(b).rsplit(".", 1)[-1]
        else:
            assert a == b, f.name


# ------------------------------------------------------------- moe_ffn

@pytest.fixture(scope="module")
def layer():
    cfg_r = ref_configs.get("phi3_5_moe", smoke=True).with_(
        dtype=jnp.float32)
    cfg = configs.get("phi3_5_moe", smoke=True).with_(dtype=torch.float32)
    p_r, _ = ref_moe.init_moe(cfg_r, jax.random.PRNGKey(3))
    return cfg_r, cfg, p_r, {k: bridge.tensor(v, device="cpu") for k, v in
                             _np_tree(p_r).items()}


def _skewed_input(p, seed, b=2, s=8, d=64, alpha=0.0):
    """Tokens plus ``alpha`` times router column 0: a large alpha sends
    every token to expert 0 first, past its capacity."""
    x = np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)
    col = p["router"][:, 0].numpy()
    return (x + alpha * col / np.linalg.norm(col)).astype(np.float32)


def _dropped(cfg, p, x) -> int:
    """Expert choices that find their expert's slots taken (numpy)."""
    xt = x.reshape(-1, x.shape[-1]).astype(np.float64)
    logits = xt @ p["router"].numpy().astype(np.float64)
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :cfg.top_k]
    cap = moe.capacity(cfg, xt.shape[0])
    counts = np.bincount(top.reshape(-1), minlength=cfg.n_experts)
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("alpha", [0.0, 40.0], ids=["spread", "drops"])
def test_moe_ffn_matches_reference(layer, alpha):
    cfg_r, cfg, p_r, p = layer
    x = _skewed_input(p, 5, alpha=alpha)
    if alpha:
        assert _dropped(cfg, p, x) > 0
    y_r, aux_r = ref_moe.moe_ffn(cfg_r, p_r, jnp.asarray(x))
    y, aux = moe.moe_ffn(cfg, p, torch.from_numpy(x))
    assert y.shape == (2, 8, 64)
    assert _rel(y, y_r) < 1e-5
    assert abs(float(aux) - float(aux_r)) <= 1e-6 * abs(float(aux_r))


def test_moe_ffn_groups_tokens_like_reference(layer):
    """Several dispatch groups (32 tokens in groups of 8) and a token
    count that does not divide into groups (one group of 30)."""
    cfg_r, cfg, p_r, p = layer
    for (b, s) in ((4, 8), (3, 10)):
        x = _skewed_input(p, 6, b=b, s=s, alpha=20.0)
        y_r, aux_r = ref_moe.moe_ffn(cfg_r.with_(moe_group=8), p_r,
                                     jnp.asarray(x))
        y, aux = moe.moe_ffn(cfg.with_(moe_group=8), p, torch.from_numpy(x))
        assert _rel(y, y_r) < 1e-5
        assert abs(float(aux) - float(aux_r)) <= 1e-6 * abs(float(aux_r))


def test_stacked_taps_match_reference(layer):
    """Norms, per-expert dispatched-row counts (unused capacity slots are
    zero rows) and per-expert Grams of the MoE layer's taps."""
    cfg_r, cfg, p_r, p = layer
    x = _skewed_input(p, 7, alpha=40.0)
    with ref_common.tap_capture(hessian=True) as tap_r:
        with ref_common.tap_scope("moe"):
            ref_moe.moe_ffn(cfg_r, p_r, jnp.asarray(x))
    with common.tap_capture(hessian=True) as tap:
        with common.tap_scope("moe"):
            moe.moe_ffn(cfg, p, torch.from_numpy(x))
    names = ("moe.router",) + EXPERT_PATHS
    assert sorted(tap_r.names()) == sorted(names)
    for name in names:
        assert tap.has(name)
        assert _rel(tap.norms(name), tap_r.norms(name)) < 1e-5
        assert _rel(tap.hessian(name), tap_r.hessian(name)) < 1e-5
        assert np.array_equal(np.asarray(tap.token_count(name)),
                              np.asarray(tap_r.token_count(name)))
    counts = np.asarray(tap.token_count("moe.w_gate"))
    assert counts.shape == (cfg.n_experts,)
    assert counts.sum() < 16 * cfg.top_k           # some choices dropped


# ------------------------------------------------- compress / pack / serve

@pytest.fixture(scope="module")
def models():
    cfg_r = ref_configs.get("phi3_5_moe", smoke=True).with_(
        dtype=jnp.float32)
    cfg = configs.get("phi3_5_moe", smoke=True).with_(dtype=torch.float32)
    params_r, _ = ref_lm.init(cfg_r, jax.random.PRNGKey(0))
    return cfg_r, cfg, params_r, bridge.params(_np_tree(params_r),
                                               cfg.n_layers, device="cpu")


def test_bridge_params_slices_expert_leaves_per_layer(models):
    """The reference's (L, E, D, F) expert leaves arrive as one (E, D, F)
    tensor per layer, the router as (D, E)."""
    cfg_r, cfg, params_r, params = models
    assert len(params["layers"]) == cfg.n_layers
    for l, lp in enumerate(params["layers"]):
        assert sorted(lp["moe"]) == ["router", "w_down", "w_gate", "w_up"]
        for name, t in lp["moe"].items():
            want = np.asarray(params_r["layers"]["moe"][name][l])
            assert t.is_contiguous() and t.shape == want.shape
            assert np.array_equal(t.numpy(), want)
    assert lp["moe"]["w_up"].shape == (cfg.n_experts, cfg.d_model, cfg.d_ff)


@pytest.fixture(scope="module", params=[("slab", None), ("wanda", "2:4")],
                ids=["slab", "wanda-2:4"])
def compressed(request, models):
    """Both packages compress the same bridged model with the same
    calibration batch."""
    method, pattern = request.param
    cfg_r, cfg, params_r, params = models
    calib = calibration_batch(cfg.vocab, n_seq=2, seq_len=16)
    kw = dict(cr=0.5, iters=2, pattern=pattern)
    plan = CompressionPlan.parse(f"*={method}",
                                 base=ref_slab.SLaBConfig(**kw))
    dense_r, st_r, decs_r = ref_pipeline.compress_model(
        cfg_r, params_r, calib, plan=plan, keep_decompositions=True)
    dense, st, decs = compress_model(
        cfg, params, calib, method=method, scfg=slab.SLaBConfig(**kw),
        keep_decompositions=True, device="cpu")
    return method, pattern, plan, dense_r, st_r, decs_r, dense, st, decs


def test_compress_model_expert_decs_match_reference(models, compressed):
    cfg_r, cfg, _, _ = models
    _, _, _, _, st_r, decs_r, _, st, decs = compressed
    assert [(s.layer, s.name, s.variant) for s in st] == \
        [(s.layer, s.name, s.variant) for s in st_r]
    for a, b in zip(st, st_r):
        assert abs(a.err_after - b.err_after) / b.err_after < 1e-3, a.name
    assert sorted(decs) == sorted(decs_r)
    for key in decs:
        if key[1] not in EXPERT_PATHS:
            continue
        assert type(decs[key]) is tuple
        assert len(decs[key]) == cfg.n_experts
        for e, (d, d_r) in enumerate(zip(decs[key], decs_r[key])):
            agree = np.mean((d.w_s.numpy() != 0) == (np.asarray(d_r.w_s)
                                                     != 0))
            assert agree >= 0.999, (key, e, agree)
            if d.u.numel():
                lb = slab.low_rank_times_binary(d)
                lb_r = ref_slab.low_rank_times_binary(d_r)
                assert _rel(lb, lb_r) < 1e-3, (key, e)


@pytest.fixture(scope="module")
def packed(models, compressed):
    """The reference's packed model, and the port's pack of the bridged
    reference decompositions."""
    cfg_r, cfg, _, _ = models
    method, pattern, plan, dense_r, st_r, decs_r = compressed[:6]
    packed_r, rep_r = ref_pm.pack_plan_decs(
        dense_r, decs_r, cfg_r.n_layers, plan,
        variants={(s.layer, s.name): s.variant for s in st_r})
    assert rep_r.fallback == []
    decs = {k: (bridge.expert_decompositions(d, device="cpu") if type(d) is tuple
                else bridge.decomposition(d, device="cpu")) for k, d in decs_r.items()}
    dense = bridge.params(_np_tree(dense_r), cfg.n_layers, device="cpu")
    packed_p, rep = pack_model(
        dense, decs, plan=plan_for_method(method, slab.SLaBConfig(
            pattern=pattern)), dtype=torch.float32)
    return pattern, dense, decs_r, packed_r, packed_p, rep


def test_pack_model_expert_stacks_byte_identical(models, compressed,
                                                 packed):
    cfg_r, cfg, _, _ = models
    variant = "slab-ell" if compressed[0] == "slab" else "sparse-nm"
    pattern, dense, decs_r, _, packed_p, rep = packed
    assert rep.fallback == ()
    assert rep.by_variant == {variant: cfg.n_layers * (
        4 + len(EXPERT_PATHS) * cfg.n_experts)}
    for l in range(cfg.n_layers):
        for path in EXPERT_PATHS:
            mod, leaf = path.split(".")
            eps = packed_p["layers"][l][mod][leaf]
            assert isinstance(eps, ExpertPackedStack)
            old = jnp.asarray(dense["layers"][l][mod][leaf].numpy())
            ref = ref_pm.pack_expert_stack(old, decs_r[(l, path)], pattern,
                                           jnp.float32)
            want = bridge.expert_packed_stack(ref, device="cpu")
            assert eps.members == want.members
            assert eps.dense_members == want.dense_members == ()
            for g, w in zip(eps.groups, want.groups, strict=True):
                assert g.variant == w.variant == variant
                for name in ("sparse_vals", "sparse_idx", "b_packed", "u",
                             "v"):
                    a, b = getattr(g, name), getattr(w, name)
                    assert (a is None) == (b is None), name
                    if a is not None:
                        assert a.dtype == b.dtype and torch.equal(a, b)


def test_packed_forward_matches_reference(models, packed):
    cfg_r, cfg, _, _ = models
    _, _, _, packed_r, packed_p, _ = packed
    toks = _tokens(4, 2, 12, cfg.vocab)
    want, aux_r = ref_lm.forward(cfg_r, packed_r, jnp.asarray(toks))
    got, aux = lm.forward(cfg, packed_p, torch.from_numpy(toks))
    assert got.shape == (2, 12, cfg.vocab)
    assert _rel(got, want) < 1e-4
    assert abs(float(aux) - float(aux_r)) <= 1e-5 * abs(float(aux_r))


def test_packed_decode_steps_match_reference(models, packed):
    cfg_r, cfg, _, _ = models
    _, _, _, packed_r, packed_p, _ = packed
    b, s = 3, 6
    toks = _tokens(3, b, s, cfg.vocab)
    step_r = jax.jit(ref_lm.decode_step, static_argnums=0)
    cache_r = ref_lm.init_cache(cfg_r, b, s)
    cache = lm.init_cache(cfg, b, s, device="cpu")
    for t in range(s):
        want, cache_r = step_r(cfg_r, packed_r, cache_r,
                               jnp.asarray(toks[:, t:t + 1]),
                               ref_positions_for(cfg_r, b, 1, offset=t))
        got, cache = lm.decode_step(cfg, packed_p, cache,
                                    torch.from_numpy(toks[:, t:t + 1]),
                                    positions_for(cfg, b, 1, offset=t))
        assert _rel(got, want) < 1e-4, t


def test_packed_greedy_tokens_equal_reference(models, packed):
    cfg_r, cfg, _, _ = models
    _, _, _, packed_r, packed_p, _ = packed
    prompts = _tokens(5, 3, 8, cfg.vocab)
    want = ref_serve.greedy_decode(cfg_r, packed_r, jnp.asarray(prompts), 5)
    got = greedy_decode(cfg, packed_p, prompts, 5, device="cpu")
    assert np.array_equal(got.numpy(), np.asarray(want))
    lengths = np.array([8, 3, 6], np.int32)
    want = ref_serve.greedy_decode(cfg_r, packed_r, jnp.asarray(prompts), 5,
                                   lengths=lengths)
    got = greedy_decode(cfg, packed_p, prompts, 5, lengths=lengths,
                        device="cpu")
    assert np.array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------- the engine

TRACE = [(10, 6, 0.0), (12, 6, 0.0), (8, 6, 0.0), (9, 5, 4.0)]
ENGINE_KW = dict(n_slots=3, n_blocks=8, block_size=4, max_len=32,
                 prefill_chunk=4)


def _trace(vocab, cls):
    rng = np.random.default_rng(17)
    return [cls(rid=i, prompt=rng.integers(0, vocab, size=p,
                                           dtype=np.int64).astype(np.int32),
                max_new=n, arrival=a)
            for i, (p, n, a) in enumerate(TRACE)]


def _no_leak(eng):
    assert not eng.sched.slots and eng.sched.alloc.n_reserved == 0
    assert eng.sched.alloc.n_free == eng.ecfg.n_blocks


def _greedy_streams(cfg, params, done):
    """A ragged greedy_decode of the trace's prompts, row = rid."""
    prompts = np.zeros((len(done), max(p for p, _, _ in TRACE)), np.int32)
    for r in done:
        prompts[r.rid, :len(r.prompt)] = r.prompt
    return greedy_decode(cfg, params, prompts, max(n for _, n, _ in TRACE),
                         lengths=[len(r.prompt) for r in done],
                         device="cpu").numpy()


def test_engine_equals_reference_engine_at_published_capacity(models):
    """Capacity couples the rows of a step (and the filler tokens of
    inactive slots take capacity too), so at the published capacity
    factor the engine is held to the reference's engine on the same
    trace, not to greedy_decode: equal out, status, ttft and finish.
    Some stream differs from greedy_decode's: the coupling is real."""
    cfg_r, cfg, dense_r, dense = models
    eng = Engine(cfg, dense, EngineConfig(**ENGINE_KW), device="cpu")
    mine = eng.run(_trace(cfg.vocab, Request), clock="steps", max_steps=500)
    ref_eng = RefEngine(cfg_r, dense_r, RefEngineConfig(**ENGINE_KW))
    theirs = ref_eng.run(_trace(cfg.vocab, RefRequest), clock="steps",
                         max_steps=500)
    assert ref_eng.sched.n_evictions > 0 and eng.sched.n_evictions > 0
    for a, b in zip(mine, theirs, strict=True):
        assert (a.rid, a.status, a.out, a.ttft, a.finish) == \
            (b.rid, b.status, b.out, b.ttft, b.finish)
    _no_leak(eng)
    want = _greedy_streams(cfg, dense, mine)
    assert any(not np.array_equal(np.asarray(r.out),
                                  want[r.rid, :r.max_new]) for r in mine)


def test_engine_token_equal_to_greedy_at_drop_free_capacity(models):
    """With capacity_factor = n_experts / top_k every expert has a slot
    for every token of a group, nothing is dropped and a row's output no
    longer depends on its neighbours: the engine's streams equal a
    ragged greedy_decode of the same prompts."""
    _, cfg, _, dense = models
    cfg_f = cfg.with_(capacity_factor=cfg.n_experts / cfg.top_k)
    eng = Engine(cfg_f, dense, EngineConfig(**ENGINE_KW), device="cpu")
    done = eng.run(_trace(cfg.vocab, Request), clock="steps", max_steps=500)
    assert eng.sched.n_evictions > 0
    want = _greedy_streams(cfg_f, dense, done)
    for r in done:
        assert r.status == "finished"
        assert np.array_equal(np.asarray(r.out), want[r.rid, :r.max_new]), \
            r.rid
    _no_leak(eng)
