"""The port's hybrid family (zamba2-7b: a Mamba-2 backbone and one shared
transformer block) against the reference on the CPU, at the SMOKE
geometry (7 layers, d_model 64, the shared block's 4 heads of 16 and
d_ff 128, firing before layers 2 and 5) and f32, on bridged weights:

- the config mirror (FULL and SMOKE), ``n_shared_invocations`` and the
  FULL parameter count on ``meta``;
- ``lm.forward`` logits at rel < 1e-4; the shared block runs before the
  Mamba block of each firing layer, once per invocation, and zeroing
  it moves the logits (``test_models.py``);
- ``decode_step`` at rel < 1e-4, continued from a bridged reference
  cache (``bridge.mamba_cache`` and ``bridge.kv_cache``), and
  ``greedy_decode`` tokens equal to the reference's, square and ragged;
- the shared block's taps scoped ``shared.*`` on firing layers only
  (``test_taps.py``); the block compressed once, at its first firing
  layer, into a copy of ``shared_attn`` (``test_plan.py``); its linears
  one allocation group with the reference's CR (``test_allocator.py``);
- at 6 layers under ``0/mamba.out=skip; *=slab``: the compressed model
  (the shared block's weights too) at rel < 1e-4 of the reference's,
  the packed report (segments included) equal to ``pack_plan_decs``',
  the seven shared linears packed once into ``shared_attn`` and run by
  both invocations, and the packed forward and decode against the
  dense-equivalent model and the reference's packed decode (``test_pipeline.py``, ``test_expert_packing.py``,
  ``test_hetero_packing.py``, ``test_segmented_scan.py``);
- the serving engine and ``paged_decode_step`` still refuse the family
  (and the audio encoder); ``lm.init`` builds every family of the
  reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import allocator as ref_alloc
from repro.core import packed_model as ref_pm
from repro.core import pipeline as ref_pipeline
from repro.core.plan import CompressionPlan as RefPlan
from repro.core.slab import SLaBConfig as RefSLaBConfig
from repro.data import calibration_batch
from repro.launch import serve as ref_serve
from repro.models import lm as ref_lm
from repro.models.common import positions_for as ref_positions_for
from repro_torch import bridge, configs
from repro_torch.core import packed_model
from repro_torch.core.allocator import allocate_plan, measured_global_cr
from repro_torch.core.packed_model import PackedLinear, pack_model
from repro_torch.core.pipeline import (compress_model, layer_tap_stats,
                                       shared_linear_paths)
from repro_torch.core.slab import SLaBConfig
from repro_torch.launch.serve import greedy_decode
from repro_torch.models import lm
from repro_torch.models.common import positions_for, tap_capture
from repro_torch.serving import Engine, EngineConfig
from repro_torch.tree import leaves_with_path

ARCH = "zamba2_7b"
SHARED = ["shared.attn.wq", "shared.attn.wk", "shared.attn.wv",
          "shared.attn.wo", "shared.mlp.w_gate", "shared.mlp.w_up",
          "shared.mlp.w_down"]


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


def _cfgs(**kw):
    return (ref_configs.get(ARCH, smoke=True).with_(dtype=jnp.float32, **kw),
            configs.get(ARCH, smoke=True).with_(dtype=torch.float32, **kw))


def _bridge(cfg, tree):
    return bridge.params(jax.tree.map(np.asarray, tree), cfg.n_layers,
                         device="cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _leaf(tree, path):
    for k in path.split("."):
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def model():
    cfg_r, cfg = _cfgs()
    params_r, _ = ref_lm.init(cfg_r, jax.random.PRNGKey(0))
    return cfg_r, cfg, params_r, _bridge(cfg, params_r)


@pytest.mark.parametrize("smoke", [True, False])
def test_config_fields_equal_reference(smoke):
    ref = ref_configs.get(ARCH, smoke=smoke)
    port = configs.get(ARCH, smoke=smoke)
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if f.name == "dtype":
            assert jnp.dtype(a).name == str(b).rsplit(".", 1)[-1]
        else:
            assert a == b, f.name
    for prop in ("d_inner", "ssm_heads", "conv_dim", "d_q", "d_kv"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert lm.n_shared_invocations(port) == ref_lm.n_shared_invocations(ref)
    assert shared_linear_paths(port) == \
        ref_pipeline.shared_linear_paths(ref) == SHARED


def test_param_count_full_equals_reference():
    cfg = configs.get(ARCH)
    n = lm.param_count(cfg)
    assert n == ref_lm.param_count(ref_configs.get(ARCH))
    assert 6e9 <= n <= 9e9
    abstract = lm.abstract_params(cfg)
    shapes = {"/".join(p): tuple(t.shape) for p, t in
              leaves_with_path(abstract["shared_attn"])}
    assert shapes["mlp/w_down"] == (14336, 3584)
    assert shapes["attn/wq"] == (3584, 3584)
    assert tuple(abstract["layers"][0]["mamba"]["in_z"].shape) == (3584,
                                                                  7168)


# ------------------------------------------------------------ the model

@pytest.mark.parametrize("s", [64, 40])
def test_forward_matches_reference(model, s):
    cfg_r, cfg, params_r, params = model
    toks = _tokens(7, 2, s, cfg.vocab)
    want, _ = ref_lm.forward(cfg_r, params_r, jnp.asarray(toks))
    got, _ = lm.forward(cfg, params, torch.from_numpy(toks))
    assert got.shape == (2, s, cfg.vocab)
    assert _rel(got, want) < 1e-4


def test_shared_block_fires_before_the_mamba_block(model, monkeypatch):
    """Zeroing the shared block moves the logits (the reference's case);
    it runs once per invocation, before layers 2 and 5, ahead of their
    Mamba blocks."""
    _, cfg, _, params = model
    toks = torch.from_numpy(_tokens(1, 1, 16, cfg.vocab))
    base, _ = lm.forward(cfg, params, toks)
    p2 = dict(params)
    p2["shared_attn"] = {k: ({kk: torch.zeros_like(vv)
                              for kk, vv in v.items()}
                             if isinstance(v, dict) else torch.zeros_like(v))
                         for k, v in params["shared_attn"].items()}
    pert, _ = lm.forward(cfg, p2, toks)
    assert float((base - pert).abs().max()) > 1e-6
    order = []
    shared, block = lm._attn_layer, lm.mamba_lib.mamba_block

    def spy_shared(*a):
        order.append("shared")
        return shared(*a)

    def spy_block(*a):
        order.append("mamba")
        return block(*a)

    monkeypatch.setattr(lm, "_attn_layer", spy_shared)
    monkeypatch.setattr(lm.mamba_lib, "mamba_block", spy_block)
    lm.forward(cfg, params, toks)
    assert order == ["mamba", "mamba", "shared", "mamba", "mamba", "mamba",
                     "shared", "mamba", "mamba"]
    assert order.count("shared") == lm.n_shared_invocations(cfg) == 2


def _decode(ref, cfg, params, toks, cache=None, t0=0):
    """Logits of every decode step over ``toks`` (positions from ``t0``)
    and the last cache."""
    b, s = toks.shape
    mod, pos = (ref_lm, ref_positions_for) if ref else (lm, positions_for)
    if cache is None:
        cache = (ref_lm.init_cache(cfg, b, 8) if ref
                 else lm.init_cache(cfg, b, 8, device="cpu"))
    out = []
    for t in range(s):
        tok = toks[:, t:t + 1]
        tok = jnp.asarray(tok) if ref else torch.from_numpy(tok)
        logits, cache = mod.decode_step(cfg, params, cache, tok,
                                        pos(cfg, b, 1, offset=t0 + t))
        out.append(np.asarray(logits[:, 0]))
    return np.stack(out, 1), cache


def _bridge_cache(c_r):
    return lm.SSMCache(
        bridge.mamba_cache(jax.tree.map(np.asarray, c_r.mamba),
                           device="cpu"),
        bridge.kv_cache(jax.tree.map(np.asarray, c_r.shared_kv),
                        device="cpu"))


def test_decode_steps_match_reference_from_a_bridged_cache(model):
    """Three reference steps, then three more in both packages from the
    bridged cache (the shared block's two KV caches at length 3)."""
    cfg_r, cfg, params_r, params = model
    toks = _tokens(8, 2, 6, cfg.vocab)
    first_r, c_r = _decode(True, cfg_r, params_r, toks[:, :3])
    first, _ = _decode(False, cfg, params, toks[:, :3])
    assert _rel(first, first_r) < 1e-4
    cache = _bridge_cache(c_r)
    assert [kv.length for kv in cache.shared_kv] == [3, 3]
    want, c_r2 = _decode(True, cfg_r, params_r, toks[:, 3:], c_r, 3)
    got, cache2 = _decode(False, cfg, params, toks[:, 3:], cache, 3)
    assert _rel(got, want) < 1e-4
    want_c = _bridge_cache(c_r2)
    for a, b in zip(cache2.shared_kv, want_c.shared_kv):
        assert a.length == b.length == 6
        assert _rel(a.k, b.k) < 1e-4 and _rel(a.v, b.v) < 1e-4
    for a, b in zip(cache2.mamba, want_c.mamba):
        assert _rel(a.h, b.h) < 1e-4
    fwd, _ = lm.forward(cfg, params, torch.from_numpy(toks))
    assert _rel(np.concatenate([first, got], 1), fwd) < 1e-4


@pytest.mark.parametrize("ragged", [False, True])
def test_greedy_decode_tokens_equal_reference(model, ragged):
    cfg_r, cfg, params_r, params = model
    prompts = _tokens(9, 3, 5, cfg.vocab)
    lengths = np.array([5, 2, 4], np.int32) if ragged else None
    want = ref_serve.greedy_decode(cfg_r, params_r, jnp.asarray(prompts), 6,
                                   lengths=lengths)
    got = greedy_decode(cfg, params, prompts, 6, lengths=lengths,
                        device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_and_paged_decode_refuse_the_family(model):
    _, cfg, _, params = model
    with pytest.raises(ValueError, match="paged cache"):
        Engine(cfg, params, EngineConfig(), device="cpu")
    with pytest.raises(ValueError, match="unsupported family"):
        lm.paged_decode_step(cfg, params, [], None, torch.zeros(2), None,
                             None)
    # every family the reference assembles builds; of those with a KV
    # cache, the encoder (audio) has no decode path and is refused too
    for arch in ref_configs.ARCH_IDS:
        c = configs.get(arch, smoke=True)
        p = lm.init(c, device="cpu")
        assert set(p) == set(ref_lm.abstract_params(
            ref_configs.get(arch, smoke=True))[0]), arch
    audio = configs.get("hubert_xlarge", smoke=True)
    p = lm.init(audio, device="cpu")
    with pytest.raises(ValueError, match="paged cache"):
        Engine(audio, p, EngineConfig(), device="cpu")
    with pytest.raises(ValueError, match="unsupported family"):
        lm.paged_decode_step(audio, p, [], None, torch.zeros(2), None, None)


# ------------------------------------------------- taps and compression

def test_shared_block_taps_are_scoped(model):
    """On a firing layer the shared block taps as ``shared.*`` beside the
    Mamba block's ``mamba.*``; elsewhere no ``shared.*`` tap; the norms
    equal the reference's."""
    cfg_r, cfg, params_r, params = model
    cal = np.asarray(calibration_batch(cfg.vocab, n_seq=1, seq_len=16))
    h = lm.embed_inputs(cfg, params, torch.from_numpy(cal))
    pos = positions_for(cfg, 1, 16)
    idx = cfg.attn_every - 1
    with tap_capture() as tap:
        lm._layer_fwd(cfg, params, params["layers"][idx], idx, h, pos)
    assert all(tap.has(n) for n in ["mamba.in_z", "mamba.in_x",
                                    "mamba.out"] + SHARED)
    with tap_capture() as tap0:
        lm._layer_fwd(cfg, params, params["layers"][0], 0, h, pos)
    assert tap0.has("mamba.out") and not any(tap0.has(n) for n in SHARED)
    norms, _ = layer_tap_stats(cfg, params, params["layers"][idx], idx, h,
                               pos)
    h_r = ref_lm.embed_inputs(cfg_r, params_r, jnp.asarray(cal))
    lp_r = jax.tree.map(lambda a: a[idx], params_r["layers"])
    norms_r, _ = ref_pipeline.layer_tap_stats(
        cfg_r, params_r, lp_r, idx, h_r, ref_positions_for(cfg_r, 1, 16))
    assert norms.keys() == norms_r.keys()
    for k in norms:
        assert _rel(norms[k], norms_r[k]) < 1e-5, k


def test_shared_block_is_compressed_once(model):
    """The reference's ``test_plan`` case, ``shared.*=slab@iters=1;
    *=skip``: the seven shared linears, at the first firing layer, into a
    copy of ``shared_attn``; the Mamba stack untouched. (The compressed
    shared weights are held to the reference's by
    ``test_compressed_model_matches_reference``.)"""
    _, cfg, _, params = model
    cal = np.asarray(calibration_batch(cfg.vocab, n_seq=2, seq_len=16))
    new, stats = compress_model(cfg, params, cal,
                                plan="shared.*=slab@iters=1; *=skip",
                                device="cpu")
    assert sorted(s.name for s in stats) == sorted(SHARED)
    assert all(s.layer == cfg.attn_every - 1 for s in stats)
    assert new["shared_attn"] is not params["shared_attn"]
    for p in SHARED:
        sub = p.split(".", 1)[1]
        assert not torch.equal(_leaf(new["shared_attn"], sub),
                               _leaf(params["shared_attn"], sub)), p
    assert all(new["layers"][l]["mamba"]["out"] is
               params["layers"][l]["mamba"]["out"]
               for l in range(cfg.n_layers))
    logits, _ = lm.forward(cfg, new, torch.from_numpy(
        _tokens(1, 2, 8, cfg.vocab)))
    assert torch.isfinite(logits).all()


def test_shared_block_gets_one_cr(model):
    """Tied weights: every ``shared.*`` linear in ONE allocation group,
    at the reference's CR; the emitted plan compresses the block once."""
    cfg_r, cfg, params_r, params = model
    cal = np.asarray(calibration_batch(cfg.vocab, n_seq=2, seq_len=16))
    spec = "shared.*=wanda@auto; *=skip; budget=0.5"
    alloc_r = ref_alloc.allocate_plan(cfg_r, params_r, cal, budget=0.5,
                                      plan=spec)
    alloc = allocate_plan(cfg, params, cal, budget=0.5, plan=spec,
                          device="cpu")
    assert set(alloc.crs) == {"shared"}
    assert alloc.crs == alloc_r.crs
    rows = [r for r in alloc.rows if r["path"].startswith("shared.")]
    assert {r["path"] for r in rows} == set(SHARED)
    assert len({r["cr"] for r in rows}) == 1
    new, stats = compress_model(cfg, params, None, plan=alloc.plan,
                                stats=alloc.stats, device="cpu")
    assert sorted(s.name for s in stats) == sorted(SHARED)
    assert len({s.cr_requested for s in stats}) == 1
    # shared.* rows weigh their shared_attn leaves, as the reference's do
    assert measured_global_cr(params, stats) == pytest.approx(
        ref_alloc.measured_global_cr(params_r, stats), rel=1e-12)


# ------------------------------------------- packing at 6 layers (L2, L5)

PARTIAL = "0/mamba.out=skip; *=slab"


@pytest.fixture(scope="module")
def packed6(model):
    """The first 6 of ``model``'s layers (the shared block fires before L2
    and L5), slab at one iteration under ``0/mamba.out=skip; *=slab`` in
    both packages; the reference's decompositions packed by both."""
    cfg_r, cfg = _cfgs(n_layers=6)
    params_r = dict(model[2], layers=jax.tree.map(lambda a: a[:6],
                                                  model[2]["layers"]))
    cal = np.asarray(calibration_batch(cfg.vocab, n_seq=2, seq_len=16))
    plan_r = RefPlan.parse(PARTIAL, base=RefSLaBConfig(cr=0.5, iters=1))
    dense_r, _, decs_r = ref_pipeline.compress_model(
        cfg_r, params_r, cal, plan=plan_r, keep_decompositions=True)
    packed_r, rep_r = ref_pm.pack_plan_decs(dense_r, decs_r, cfg.n_layers,
                                            plan_r)
    dense, stats, decs = compress_model(
        cfg, _bridge(cfg, params_r), cal, plan=PARTIAL,
        scfg=SLaBConfig(cr=0.5, iters=1), keep_decompositions=True,
        device="cpu")
    dense_b = _bridge(cfg, dense_r)
    bdecs = {k: bridge.decomposition(jax.tree.map(np.asarray, d),
                                     device="cpu")
             for k, d in decs_r.items()}
    packed, rep = pack_model(dense_b, bdecs, plan=PARTIAL)
    own, own_rep = pack_model(dense, decs, plan=PARTIAL)
    return dict(cfg_r=cfg_r, cfg=cfg, dense_r=dense_r, packed_r=packed_r,
                rep_r=rep_r, dense=dense, stats=stats, decs=decs,
                dense_b=dense_b, packed=packed, rep=rep, own=own,
                own_rep=own_rep)


def test_compressed_model_matches_reference(packed6):
    """Every planned linear (the shared block's at L2, after L2's Mamba
    linears) compressed, weights at rel < 1e-4 of the reference's."""
    s = packed6
    names = [(st.layer, st.name) for st in s["stats"]]
    assert names[:5] == [(0, "mamba.in_z"), (0, "mamba.in_x"),
                         (1, "mamba.in_z"), (1, "mamba.in_x"),
                         (1, "mamba.out")]
    assert names[5:8] == [(2, "mamba.in_z"), (2, "mamba.in_x"),
                          (2, "mamba.out")]
    assert names[8:15] == [(2, p) for p in SHARED]
    assert len(names) == 17 + 7
    assert {k for k in s["decs"] if k[1].startswith("shared.")} == \
        {(2, p) for p in SHARED}
    for p in SHARED:
        sub = p.split(".", 1)[1]
        assert _rel(_leaf(s["dense"]["shared_attn"], sub),
                    _leaf(s["dense_b"]["shared_attn"], sub)) < 1e-4, p
    for l in range(6):
        for k in ("in_z", "in_x", "out"):
            assert _rel(s["dense"]["layers"][l]["mamba"][k],
                        s["dense_b"]["layers"][l]["mamba"][k]) < 1e-4, (l, k)


def test_packed_report_equals_reference(packed6):
    s = packed6
    rep, rep_r = s["rep"], s["rep_r"]
    assert rep.n_packed == rep_r.n_packed == 17 + 7
    assert rep.by_variant == rep_r.by_variant == {"slab-ell": 24}
    assert rep.paths == rep_r.paths
    assert rep.paths[-7:] == sorted(SHARED)
    assert list(rep.fallback) == list(rep_r.fallback) == []
    assert [tuple(g) for g in rep.segments] == \
        [(g.lo, g.hi, g.sig) for g in rep_r.segments]
    assert [(g.lo, g.hi) for g in rep.segments] == [(0, 1), (1, 6)]
    for var, (pb, db) in rep_r.bytes_by_variant.items():
        assert rep.bytes_by_variant[var] == pytest.approx((pb, db),
                                                          rel=1e-12), var
    assert s["own_rep"].by_variant == {"slab-ell": 24}
    assert s["own_rep"].paths == rep.paths


def test_shared_block_packs_once_and_serves(packed6, monkeypatch):
    """The seven shared linears are PackedLinears in ``shared_attn`` (the
    input params untouched), both invocations launch the same objects,
    and the packed forward / decode match the dense-equivalent model and
    the reference's packed decode."""
    s = packed6
    cfg, packed = s["cfg"], s["packed"]
    for p in SHARED:
        sub = p.split(".", 1)[1]
        assert isinstance(_leaf(packed["shared_attn"], sub), PackedLinear)
        assert not isinstance(_leaf(s["dense_b"]["shared_attn"], sub),
                              PackedLinear)
    calls = {}
    real = packed_model.packed_matmul

    def spy(x, w):
        calls[id(w)] = calls.get(id(w), 0) + 1
        return real(x, w)

    monkeypatch.setattr(packed_model, "packed_matmul", spy)
    toks = _tokens(5, 2, 3, cfg.vocab)
    f_p, _ = lm.forward(cfg, packed, torch.from_numpy(toks))
    shared_ids = {id(_leaf(packed["shared_attn"], p.split(".", 1)[1]))
                  for p in SHARED}
    assert len(shared_ids) == 7
    assert all(calls[i] == 2 for i in shared_ids)
    assert sum(calls.values()) == 17 + 2 * 7
    monkeypatch.undo()
    f_d, _ = lm.forward(cfg, s["dense_b"], torch.from_numpy(toks))
    assert _rel(f_p, f_d) < 1e-4
    l_p, _ = _decode(False, cfg, packed, toks)
    l_d, _ = _decode(False, cfg, s["dense_b"], toks)
    l_r, _ = _decode(True, s["cfg_r"], s["packed_r"], toks)
    assert _rel(l_p, l_d) < 1e-4
    assert _rel(l_p, l_r) < 1e-4
    bridged = bridge.params(s["packed_r"], cfg.n_layers, device="cpu")
    for p in SHARED:
        sub = p.split(".", 1)[1]
        a, b = _leaf(bridged["shared_attn"], sub), _leaf(packed["shared_attn"],
                                                         sub)
        assert a.variant == b.variant and torch.equal(a.sparse_vals,
                                                      b.sparse_vals)
    got, _ = lm.forward(cfg, bridged, torch.from_numpy(toks))
    assert _rel(got, f_p) < 1e-6


# ------------------------------------------------------------ training

def test_train_step_under_every_remat_policy(model):
    """One train step of the hybrid (the shared block inside each
    checkpointed layer or block) gives the loss and parameters of no
    checkpoint; ``launch.train`` runs the family."""
    from repro_torch.data import SyntheticCorpus
    from repro_torch.launch.train import train
    from repro_torch.optim import adamw
    from repro_torch.runtime.step import make_train_fn
    from repro_torch.tree import tree_map
    _, cfg, _, params = model
    batch = SyntheticCorpus(cfg.vocab, seed=0).batch(0, 2, 32)
    acfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    out = {}
    for remat in ("none", "nothing", "dots", "blocks:7"):
        p = tree_map(lambda t: t.detach().clone(), params)
        p, _, m = make_train_fn(cfg, acfg, remat=remat)(
            p, adamw.adamw_init(p, acfg), batch)
        out[remat] = (float(m["loss"]), p)
    l0, p0 = out["none"]
    for remat, (l, p) in out.items():
        assert abs(l - l0) <= 1e-6 * abs(l0), remat
        for (path, a), (_, b) in zip(leaves_with_path(p),
                                     leaves_with_path(p0), strict=True):
            assert _rel(a, b) < 1e-6, (remat, path)
    assert not torch.equal(p0["shared_attn"]["attn"]["wq"],
                           params["shared_attn"]["attn"]["wq"])
    _, losses = train(ARCH, True, 2, 2, 16, None, device="cpu")
    assert len(losses) == 2 and all(np.isfinite(losses))
