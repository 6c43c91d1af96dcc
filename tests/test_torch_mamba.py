"""The port's SSM family (mamba2-1.3b) against the reference on the CPU, at
the SMOKE geometry (2 layers, d_model 64, d_inner 128, 8 SSD heads of
16, state 16, chunk 32) and f32, on bridged weights:

- the config mirror (FULL and SMOKE) and its derived widths;
- ``_causal_conv``, ``_ssd_chunk_scan`` (S a multiple of the chunk and
  not, with a carried state), ``mamba_block`` and ``mamba_decode_step``
  (from a bridged reference cache) at rel < 1e-5;
- ``lm.forward`` logits and ``decode_step`` over a prompt at rel < 1e-4,
  ``greedy_decode`` tokens equal to the reference's, square and ragged;
- the reference's own SSM cases: the decode state does not grow with
  the sequence (``test_models.py``), FULL parameter counts on ``meta``,
  SparseGPT through the tapped Hessians (``test_taps.py``), slab on the
  family (``test_pipeline.py``), the budget allocator on the family
  (``test_allocator.py``, CRs equal to the reference's), the partial
  plan ``0/mamba.out=skip; *=slab`` packed and served
  (``test_hetero_packing.py``) and the segments of a deeper partial
  packing (``test_segmented_scan.py``), both equal to the reference's;
- one train step: loss and gradients against ``jax.value_and_grad`` at
  rel < 1e-4, autograd through the SSD scan;
- the serving engine still refuses the family.
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
from repro.core.slab import SLaBDecomposition as RefDec
from repro.data import calibration_batch
from repro.launch import serve as ref_serve
from repro.models import lm as ref_lm
from repro.models import mamba2 as ref_mamba
from repro.models.common import positions_for as ref_positions_for
from repro_torch import bridge, configs
from repro_torch.core.allocator import allocate_plan, measured_global_cr
from repro_torch.core.packed_model import (PackedLinear, pack_model,
                                           segment_runs)
from repro_torch.core.pipeline import compress_model, linear_paths
from repro_torch.core.slab import SLaBConfig
from repro_torch.launch.serve import greedy_decode
from repro_torch.models import lm, mamba2
from repro_torch.models.common import positions_for
from repro_torch.serving import Engine, EngineConfig
from repro_torch.tree import leaves_with_path, tree_leaves

ARCH = "mamba2_1_3b"


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
    for prop in ("d_inner", "ssm_heads", "conv_dim"):
        assert getattr(port, prop) == getattr(ref, prop), prop


# ------------------------------------------------------------ the block

def test_causal_conv_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 13, 24)).astype(np.float32)
    w = rng.standard_normal((24, 4)).astype(np.float32)
    want = ref_mamba._causal_conv(jnp.asarray(x), jnp.asarray(w))
    got = mamba2._causal_conv(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (2, 13, 24)
    assert _rel(got, want) < 1e-5
    # causal: the output at t does not see the input after t
    x2 = x.copy()
    x2[:, 7:] += 1.0
    got2 = mamba2._causal_conv(torch.from_numpy(x2), torch.from_numpy(w))
    assert torch.equal(got2[:, :7], got[:, :7])


def _scan_inputs(seed, b, s, h=4, p=8, n=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.uniform(0.0, 1.5, h)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, a, bm, cm, h0


@pytest.mark.parametrize("s", [64, 40], ids=["chunked", "one-chunk"])
@pytest.mark.parametrize("carry", [False, True], ids=["h0-zero", "h0"])
def test_ssd_chunk_scan_matches_reference(s, carry):
    """S = 64 runs two chunks of 32; S = 40 falls back to one chunk."""
    x, dt, a, bm, cm, h0 = _scan_inputs(2, 2, s)
    h0 = h0 if carry else None
    y_r, hf_r = ref_mamba._ssd_chunk_scan(
        *(jnp.asarray(t) for t in (x, dt, a, bm, cm)), 32,
        None if h0 is None else jnp.asarray(h0))
    y, hf = mamba2._ssd_chunk_scan(
        *(torch.from_numpy(t) for t in (x, dt, a, bm, cm)), 32,
        None if h0 is None else torch.from_numpy(h0))
    assert y.dtype == torch.float32 and hf.shape == (2, 4, 8, 6)
    assert _rel(y, y_r) < 1e-5
    assert _rel(hf, hf_r) < 1e-5


def test_ssd_chunk_scan_chunks_compose():
    """Two chunks of 32 with the carried state equal one pass at chunk 64
    (the chunked form is the recurrence, cut anywhere)."""
    x, dt, a, bm, cm, _ = _scan_inputs(3, 1, 64)
    args = [torch.from_numpy(t) for t in (x, dt, a, bm, cm)]
    y32, h32 = mamba2._ssd_chunk_scan(*args, 32)
    y64, h64 = mamba2._ssd_chunk_scan(*args, 64)
    assert _rel(y32, y64) < 1e-5 and _rel(h32, h64) < 1e-5


@pytest.fixture(scope="module")
def block():
    cfg_r, cfg = _cfgs()
    p_r, _ = ref_mamba.init_mamba(cfg_r, jax.random.PRNGKey(4))
    p = {k: bridge.tensor(np.asarray(v), device="cpu")
         for k, v in p_r.items()}
    return cfg_r, cfg, p_r, p


@pytest.mark.parametrize("s", [64, 21])
def test_mamba_block_matches_reference(block, s):
    cfg_r, cfg, p_r, p = block
    x = np.random.default_rng(5).standard_normal((2, s, 64)).astype(
        np.float32)
    want = ref_mamba.mamba_block(cfg_r, p_r, jnp.asarray(x))
    got = mamba2.mamba_block(cfg, p, torch.from_numpy(x))
    assert got.shape == (2, s, 64)
    assert _rel(got, want) < 1e-5


def test_mamba_decode_step_from_bridged_cache(block):
    """Three reference steps fill the conv windows and the state; the
    port continues from the bridged cache."""
    cfg_r, cfg, p_r, p = block
    xs = np.random.default_rng(6).standard_normal((4, 2, 1, 64)).astype(
        np.float32)
    c_r = ref_mamba.init_mamba_cache(cfg_r, 2)
    for t in range(3):
        _, c_r = ref_mamba.mamba_decode_step(cfg_r, p_r, jnp.asarray(xs[t]),
                                             c_r)
    stacked = jax.tree.map(lambda a: np.asarray(a)[None], c_r)
    (c,) = bridge.mamba_cache(stacked, device="cpu")
    assert float(c.h.abs().max()) > 0
    y_r, c_r2 = ref_mamba.mamba_decode_step(cfg_r, p_r, jnp.asarray(xs[3]),
                                            c_r)
    y, c2 = mamba2.mamba_decode_step(cfg, p, torch.from_numpy(xs[3]), c)
    assert y.shape == (2, 1, 64)
    assert _rel(y, y_r) < 1e-5
    for a, b in zip(c2, c_r2):
        assert a.shape == b.shape and _rel(a, b) < 1e-5
    assert torch.equal(c2.conv_x[:, :-1], c.conv_x[:, 1:])   # rolled


# ------------------------------------------------------------ the model

@pytest.mark.parametrize("s", [64, 40])
def test_forward_matches_reference(model, s):
    cfg_r, cfg, params_r, params = model
    toks = _tokens(7, 2, s, cfg.vocab)
    want, _ = ref_lm.forward(cfg_r, params_r, jnp.asarray(toks))
    got, aux = lm.forward(cfg, params, torch.from_numpy(toks))
    assert got.shape == (2, s, cfg.vocab) and float(aux) == 0.0
    assert _rel(got, want) < 1e-4


def _decode(ref, cfg, params, toks):
    """Logits of every decode step over ``toks`` and the last cache."""
    b, s = toks.shape
    mod, pos = (ref_lm, ref_positions_for) if ref else (lm, positions_for)
    cache = (ref_lm.init_cache(cfg, b, s) if ref
             else lm.init_cache(cfg, b, s, device="cpu"))
    out = []
    for t in range(s):
        tok = toks[:, t:t + 1]
        tok = jnp.asarray(tok) if ref else torch.from_numpy(tok)
        logits, cache = mod.decode_step(cfg, params, cache, tok,
                                        pos(cfg, b, 1, offset=t))
        out.append(np.asarray(logits[:, 0]))
    return np.stack(out, 1), cache


def test_decode_steps_match_reference_and_forward(model):
    cfg_r, cfg, params_r, params = model
    toks = _tokens(8, 2, 6, cfg.vocab)
    want, c_r = _decode(True, cfg_r, params_r, toks)
    got, cache = _decode(False, cfg, params, toks)
    assert _rel(got, want) < 1e-4
    assert cache.shared_kv is None and len(cache.mamba) == cfg.n_layers
    for l, mc in enumerate(bridge.mamba_cache(
            jax.tree.map(np.asarray, c_r.mamba), device="cpu")):
        for a, b in zip(cache.mamba[l], mc):
            assert _rel(a, b) < 1e-4
    fwd, _ = lm.forward(cfg, params, torch.from_numpy(toks))
    assert _rel(got, fwd) < 1e-4          # the recurrence = the scan


@pytest.mark.parametrize("ragged", [False, True])
def test_greedy_decode_tokens_equal_reference(model, ragged):
    cfg_r, cfg, params_r, params = model
    prompts = _tokens(9, 3, 5, cfg.vocab)
    lengths = np.array([5, 2, 4], np.int32) if ragged else None
    want = ref_serve.greedy_decode(cfg_r, params_r, jnp.asarray(prompts), 6,
                                   lengths=lengths)
    got = greedy_decode(cfg, params, prompts, 6, lengths=lengths,
                        device="cpu")
    assert got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mamba_state_is_sequence_length_independent():
    cfg = configs.get(ARCH, smoke=True)
    sizes = [sum(t.numel() for t in tree_leaves(
        lm.init_cache(cfg, 2, s_max, device="meta"))) for s_max in
        (128, 524288)]
    assert sizes[0] == sizes[1] > 0


def test_param_count_full_equals_reference():
    cfg = configs.get(ARCH)
    n = lm.param_count(cfg)
    assert n == ref_lm.param_count(ref_configs.get(ARCH))
    assert 1.0e9 <= n <= 1.6e9
    shapes = {"/".join(p): tuple(t.shape) for p, t in
              leaves_with_path(lm.abstract_params(cfg)["layers"][0])}
    assert shapes["mamba/in_x"] == (2048, 4096)
    assert shapes["mamba/out"] == (4096, 2048)
    assert shapes["mamba/in_dt"] == (2048, 64)


def test_engine_refuses_ssm(model):
    _, cfg, _, params = model
    with pytest.raises(ValueError, match="paged cache"):
        Engine(cfg, params, EngineConfig(), device="cpu")
    with pytest.raises(ValueError, match="unsupported family"):
        lm.paged_decode_step(cfg, params, [], None, torch.zeros(2), None,
                             None)


# ------------------------------------------------- compression and packing

def test_sparsegpt_end_to_end(model):
    """The reference's ``test_taps`` case: the tapped Hessians run
    SparseGPT on the family; the pruned weights equal the reference's."""
    cfg_r, cfg, params_r, params = model
    cal = np.asarray(calibration_batch(cfg.vocab, n_seq=2, seq_len=32))
    new_r, stats_r = ref_pipeline.compress_model(
        cfg_r, params_r, cal, method="sparsegpt",
        scfg=RefSLaBConfig(cr=0.5))
    new, stats = compress_model(cfg, params, cal, method="sparsegpt",
                                scfg=SLaBConfig(cr=0.5), device="cpu")
    assert len(stats) == cfg.n_layers * len(linear_paths(cfg)) == 6
    assert all(s.err_before > 0 for s in stats)
    want = _bridge(cfg, new_r)
    for l in range(cfg.n_layers):
        for pth in linear_paths(cfg):
            part, leaf = pth.split(".")
            w, w0 = new["layers"][l][part][leaf], params["layers"][l][part][
                leaf]
            assert float((w == 0).float().mean()) > 0.2, pth
            assert not torch.equal(w, w0), pth
            assert _rel(w, want["layers"][l][part][leaf]) < 1e-4, (l, pth)
    logits, _ = lm.forward(cfg, new, torch.from_numpy(
        _tokens(1, 2, 16, cfg.vocab)))
    assert torch.isfinite(logits).all()


def test_allocator_on_the_family_matches_reference(model):
    """The reference's ``test_allocator`` case: ``*=wanda@auto`` at
    budget 0.5 meets the budget within a grid step, with the reference's
    CRs."""
    cfg_r, cfg, params_r, params = model
    cal = np.asarray(calibration_batch(cfg.vocab, n_seq=2, seq_len=16))
    spec = "*=wanda@auto; budget=0.5"
    alloc_r = ref_alloc.allocate_plan(cfg_r, params_r, cal, plan=spec)
    alloc = allocate_plan(cfg, params, cal, plan=spec, device="cpu")
    assert alloc.crs == alloc_r.crs
    assert set(alloc.crs) == {f"L{l}/{p}" for l in range(cfg.n_layers)
                              for p in linear_paths(cfg)}
    new, rows = compress_model(cfg, params, None, plan=alloc.plan,
                               stats=alloc.stats, device="cpu")
    assert len(rows) == 6
    assert abs(measured_global_cr(params, rows) - 0.5) < 0.06
    logits, _ = lm.forward(cfg, new, torch.from_numpy(
        _tokens(1, 2, 8, cfg.vocab)))
    assert torch.isfinite(logits).all()


PARTIAL = "0/mamba.out=skip; *=slab"


@pytest.fixture(scope="module")
def partial(model):
    """slab at 1 iteration under ``0/mamba.out=skip; *=slab``, compressed
    by both packages from the same bridged weights; the reference's
    decompositions packed by both."""
    cfg_r, cfg, params_r, params = model
    cal = np.asarray(calibration_batch(cfg.vocab, n_seq=2, seq_len=16))
    base_r = RefSLaBConfig(cr=0.5, iters=1)
    plan_r = RefPlan.parse(PARTIAL, base=base_r)
    dense_r, stats_r, decs_r = ref_pipeline.compress_model(
        cfg_r, params_r, cal, plan=plan_r, keep_decompositions=True)
    packed_r, rep_r = ref_pm.pack_plan_decs(dense_r, decs_r, cfg.n_layers,
                                            plan_r)
    dense, stats, decs = compress_model(
        cfg, params, cal, plan=PARTIAL, scfg=SLaBConfig(cr=0.5, iters=1),
        keep_decompositions=True, device="cpu")
    bdecs = {k: bridge.decomposition(jax.tree.map(np.asarray, d),
                                     device="cpu")
             for k, d in decs_r.items()}
    dense_b = _bridge(cfg, dense_r)
    packed, rep = pack_model(dense_b, bdecs, plan=PARTIAL)
    return (cfg_r, cfg, dense_r, packed_r, rep_r, dense, stats, dense_b,
            packed, rep)


def test_slab_compresses_the_family_like_reference(partial):
    """The reference's ``test_pipeline`` case on mamba2: every planned
    linear compressed, the dense-equivalent weights at rel < 1e-4 of the
    reference's."""
    cfg_r, cfg, dense_r, _, _, dense, stats, dense_b, _, _ = partial
    assert [(s.layer, s.name) for s in stats] == [
        (0, "mamba.in_z"), (0, "mamba.in_x"), (1, "mamba.in_z"),
        (1, "mamba.in_x"), (1, "mamba.out")]
    for l in range(cfg.n_layers):
        for k in ("in_z", "in_x", "out", "in_b", "in_dt", "conv_x"):
            assert _rel(dense["layers"][l]["mamba"][k],
                        dense_b["layers"][l]["mamba"][k]) < 1e-4, (l, k)


def test_partial_plan_packs_and_serves(partial):
    """The reference's ``test_hetero_packing`` SSM case: the report (the
    segments too) equals ``pack_plan_decs``', and the packed forward and
    decode match the dense-equivalent model."""
    (cfg_r, cfg, dense_r, packed_r, rep_r, _, _, dense_b, packed,
     rep) = partial
    assert isinstance(packed_r["layers"]["mamba"]["out"], ref_pm.PackedStack)
    assert rep.n_packed == rep_r.n_packed == 5
    assert rep.by_variant == rep_r.by_variant == {"slab-ell": 5}
    assert rep.paths == rep_r.paths
    assert [tuple(s) for s in rep.segments] == \
        [(s.lo, s.hi, s.sig) for s in rep_r.segments]
    assert [(s.lo, s.hi) for s in rep.segments] == [(0, 1), (1, 2)]
    assert dict(rep.segments[0].sig)["mamba.out"] == "dense"
    assert not isinstance(packed["layers"][0]["mamba"]["out"], PackedLinear)
    assert rep.bytes_by_variant.keys() == dict(rep_r.bytes_by_variant).keys()
    toks = _tokens(4, 2, 3, cfg.vocab)
    f_d, _ = lm.forward(cfg, dense_b, torch.from_numpy(toks))
    f_p, _ = lm.forward(cfg, packed, torch.from_numpy(toks))
    assert _rel(f_p, f_d) < 1e-4
    l_d, _ = _decode(False, cfg, dense_b, toks)
    l_p, _ = _decode(False, cfg, packed, toks)
    l_r, _ = _decode(True, cfg_r, packed_r, toks)
    assert _rel(l_p, l_d) < 1e-4
    assert _rel(l_p, l_r) < 1e-4
    bridged = bridge.params(packed_r, cfg.n_layers, device="cpu")
    assert segment_runs(bridged["layers"], cfg.n_layers) == ((0, 1), (1, 2))


def test_deeper_partial_packing_segments_equal_reference():
    """The reference's ``test_segmented_scan`` SSM case at 4 layers:
    magnitude-pruned sparse-only decs (L0/mamba.out left dense) pack into
    the reference's two segments, and decode matches the dense model."""
    cfg_r, cfg = _cfgs(n_layers=4)
    params_r, _ = ref_lm.init(cfg_r, jax.random.PRNGKey(0))
    decs_r, dense_r = {}, jax.tree.map(np.asarray, params_r)
    for name in ref_pipeline.linear_paths(cfg_r):
        leaf = ref_pipeline._get(dense_r["layers"], name).copy()
        for l in range(cfg.n_layers):
            if (l, name) == (0, "mamba.out"):
                continue
            w = leaf[l].T                        # (D_out, D_in)
            k = w.shape[1] // 2                  # keep half of each row
            cut = -np.sort(-np.abs(w), axis=1)[:, k - 1:k]
            w_s = np.where(np.abs(w) >= cut, w, 0.0).astype(np.float32)
            decs_r[(l, name)] = RefDec(
                jnp.asarray(w_s), jnp.zeros((w.shape[0], 0)),
                jnp.zeros((w.shape[1], 0)), jnp.zeros((0, 0), jnp.int8))
            leaf[l] = w_s.T
        ref_pipeline._set(dense_r["layers"], name, leaf)
    packed_r, rep_r = ref_pm.pack_plan_decs(dense_r, decs_r, cfg.n_layers,
                                            RefPlan.parse("*=wanda"))
    dense = _bridge(cfg, dense_r)
    decs = {k: bridge.decomposition(jax.tree.map(np.asarray, d),
                                    device="cpu") for k, d in decs_r.items()}
    packed, rep = pack_model(dense, decs, plan="*=wanda")
    assert [tuple(s) for s in rep.segments] == \
        [(s.lo, s.hi, s.sig) for s in rep_r.segments]
    assert len(rep.segments) == 2
    toks = _tokens(3, 2, 3, cfg.vocab)
    l_p, _ = _decode(False, cfg, packed, toks)
    l_d, _ = _decode(False, cfg, dense, toks)
    assert _rel(l_p, l_d) < 1e-4


# ------------------------------------------------------------ training

def test_train_step_loss_and_gradients_match_reference(model):
    """One step's loss and gradients (the SSD scan's included, by
    autograd) against ``jax.value_and_grad``, then the step itself."""
    from repro_torch.data import SyntheticCorpus
    from repro_torch.optim import adamw
    from repro_torch.runtime.step import make_train_fn
    cfg_r, cfg, params_r, _ = model
    batch = SyntheticCorpus(cfg.vocab, seed=0).batch(0, 2, 64)
    (loss_r, _), grads_r = jax.jit(jax.value_and_grad(
        lambda p, b: ref_lm.loss_fn(cfg_r, p, b), has_aux=True))(
        params_r, jax.tree.map(jnp.asarray, batch))
    params = _bridge(cfg, params_r)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = lm.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    assert _rel(loss.detach(), loss_r) < 1e-5
    want = dict(leaves_with_path(_bridge(cfg, grads_r)))
    got = dict(zip([p for p, _ in leaves_with_path(params)], grads))
    assert want.keys() == got.keys()
    for path, g in got.items():
        assert float(g.abs().max()) > 0, path
        assert _rel(g, want[path]) < 1e-4, path
    acfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    p2, _, m = make_train_fn(cfg, acfg, remat="dots")(
        params, adamw.adamw_init(params, acfg), batch)
    assert abs(float(m["loss"]) - float(loss_r)) < 1e-4 * abs(float(loss_r))
    after, _ = lm.loss_fn(cfg, p2, batch)
    assert float(after) < float(loss_r)
