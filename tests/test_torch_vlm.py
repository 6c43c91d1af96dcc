"""The port's vlm family (qwen2-vl-2b: M-RoPE over (t, h, w) position
streams, tied embeddings, prefill on precomputed patch embeddings,
decode on text token ids) against the reference on the CPU, at the
SMOKE geometry (2 layers, d_model 64, 4 heads of 16 with kv 2, M-RoPE
sections (2, 3, 3)) and f32, on bridged weights:

- ``apply_mrope`` with distinct (t, h, w) ids at rel < 1e-6, its
  reduction to RoPE for text ids, and ``positions_for``'s (B, S, 3)
  ids, with a per-row tensor offset as the engine passes it;
- ``lm.forward`` on token ids and on embeddings with a (t, h, w) grid at
  rel < 1e-5, including a 4 x 4 patch grid at t = 0, where the causal
  mask compares the query's t id with the key's index (the reference's
  mask, kept on purpose: ROADMAP §C);
- ``decode_step`` against ``forward`` (rel < 2e-3, ``test_models.py``),
  ``greedy_decode`` tokens equal to the reference's (square and ragged),
  and the engine's streams equal to the reference engine's;
- ``collect_model_stats`` (its taps on (B, S, 3) positions) and
  ``compress_model`` against the reference, and the reference's
  decompositions packed by ``pack_model``: every linear packed, the tied
  ``embed`` never, logits at rel < 1e-4 of the reference's packed model;
- ``loss_fn`` on embeddings with grid positions and its gradients at
  rel < 1e-5, ``launch.train``'s embeddings batches bitwise equal to the
  reference's, and the tied tree through a checkpoint of either package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.checkpoint import load_pytree as ref_load
from repro.checkpoint import save_pytree as ref_save
from repro.core import packed_model as ref_pm
from repro.core import pipeline as ref_pipeline
from repro.core.plan import CompressionPlan as RefPlan
from repro.core.slab import SLaBConfig as RefSLaBConfig
from repro.data import calibration_batch
from repro.launch import serve as ref_serve
from repro.models import common as ref_common
from repro.models import lm as ref_lm
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import Request as RefRequest
from repro_torch import bridge, configs
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.core.packed_model import PackedLinear, pack_model
from repro_torch.core.pipeline import (collect_model_stats, compress_model,
                                       linear_paths)
from repro_torch.core.slab import SLaBConfig
from repro_torch.launch.serve import greedy_decode
from repro_torch.models import lm
from repro_torch.models.common import apply_mrope, apply_rope, positions_for
from repro_torch.serving import Engine, EngineConfig, Request
from repro_torch.tree import leaves_with_path, tree_leaves

ARCH = "qwen2_vl_2b"
PLAN = "*=slab"


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


def _bridge(cfg, tree):
    return bridge.params(jax.tree.map(np.asarray, tree), cfg.n_layers,
                         device="cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.fixture(scope="module")
def model():
    cfg_r = ref_configs.get(ARCH, smoke=True).with_(dtype=jnp.float32)
    cfg = configs.get(ARCH, smoke=True).with_(dtype=torch.float32)
    params_r, _ = ref_lm.init(cfg_r, jax.random.PRNGKey(0))
    return cfg_r, cfg, params_r, _bridge(cfg, params_r)


def test_init_ties_the_embedding(model):
    """The vlm keeps its token table (decode takes ids) and unembeds
    through it: no ``lm_head``, in both packages."""
    cfg_r, cfg, params_r, params = model
    assert set(params) == set(params_r) == {"embed", "layers", "final_norm"}
    assert set(lm.init(cfg, device="cpu")) == set(params)
    h = torch.randn(1, 3, cfg.d_model)
    assert torch.equal(lm.unembed(cfg, params, h), h @ params["embed"].T)


# ------------------------------------------------------------- M-RoPE

def _grid_ids(text: int, frames: int, rows: int, cols: int,
              t0: int = None) -> np.ndarray:
    """(S, 3) Qwen2-VL position ids: ``text`` text tokens (t = h = w =
    index), then a frames x rows x cols patch grid whose (t, h, w) start
    at ``t0`` (default: after the text)."""
    base = text if t0 is None else t0
    ids = [(i, i, i) for i in range(text)]
    ids += [(base + f, base + r, base + c) for f in range(frames)
            for r in range(rows) for c in range(cols)]
    return np.asarray(ids, np.int32)


def test_apply_mrope_matches_reference_on_distinct_streams():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 36, 4, 16)).astype(np.float32)
    pos = np.stack([_grid_ids(4, 2, 4, 4),
                    rng.integers(0, 50, (36, 3)).astype(np.int32)])
    assert (pos[..., 0] != pos[..., 1]).any() and \
        (pos[..., 1] != pos[..., 2]).any()
    want = ref_common.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e4,
                                  (2, 3, 3))
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e4,
                      (2, 3, 3))
    assert _rel(got, want) < 1e-6
    # the sections pick the streams: another split rotates otherwise
    other = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e4,
                        (4, 2, 2))
    assert _rel(other, want) > 1e-3
    # text ids (t = h = w): M-RoPE is 1-D RoPE
    t = torch.arange(36, dtype=torch.int32)[None].expand(2, 36)
    torch.testing.assert_close(
        apply_mrope(torch.from_numpy(x), t[..., None].expand(2, 36, 3), 1e4,
                    (2, 3, 3)),
        apply_rope(torch.from_numpy(x), t, 1e4), rtol=0, atol=1e-6)


def test_positions_for_gives_three_streams(model):
    cfg_r, cfg, _, _ = model
    np.testing.assert_array_equal(
        positions_for(cfg, 2, 5, offset=3).numpy(),
        np.asarray(ref_common.positions_for(cfg_r, 2, 5, offset=3)))
    lengths = np.array([3, 7, 0], np.int32)
    got = positions_for(cfg, 3, 1, offset=torch.from_numpy(lengths)[:, None])
    want = ref_common.positions_for(cfg_r, 3, 1,
                                    offset=jnp.asarray(lengths)[:, None])
    assert tuple(got.shape) == (3, 1, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the dense family keeps (B, S)
    dense = configs.get("llama2_7b", smoke=True)
    assert tuple(positions_for(dense, 2, 5).shape) == (2, 5)


# ------------------------------------------------------------ the model

def _embeds(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


# token ids; 4 text embeddings then a 2 x 4 x 4 patch grid; a 4 x 4
# patch grid all at t = 0 (each patch's query sees key 0 only)
FORWARD_CASES = {"tokens": None, "grid": _grid_ids(4, 2, 4, 4),
                 "t0_grid": _grid_ids(0, 1, 4, 4, t0=0)}


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_forward_matches_reference(model, case):
    cfg_r, cfg, params_r, params = model
    ids = FORWARD_CASES[case]
    if ids is None:
        x = _tokens(7, 2, 40, cfg.vocab)
        want, _ = ref_lm.forward(cfg_r, params_r, jnp.asarray(x))
        got, _ = lm.forward(cfg, params, torch.from_numpy(x))
    else:
        x = _embeds(7, 2, len(ids), cfg.d_model)
        pos = np.broadcast_to(ids, (2,) + ids.shape).copy()
        want, _ = ref_lm.forward(cfg_r, params_r, jnp.asarray(x),
                                 jnp.asarray(pos))
        got, _ = lm.forward(cfg, params, torch.from_numpy(x),
                            torch.from_numpy(pos))
    assert got.shape == (2, x.shape[1], cfg.vocab)
    assert _rel(got, want) < 1e-5


def test_t0_grid_masks_by_the_t_stream(model):
    """The reference's mask under M-RoPE: query t id >= key index. With
    every patch at t = 0, patch 3 sees key 0 only: moving patch 1 leaves
    its logits as they are (by index it would see patch 1), moving patch
    0 changes them; the same in both packages."""
    cfg_r, cfg, params_r, params = model
    ids = FORWARD_CASES["t0_grid"]
    pos = np.broadcast_to(ids, (1,) + ids.shape).copy()
    x = _embeds(3, 1, len(ids), cfg.d_model)
    out = {}
    for moved in (None, 1, 0):
        xm = x.copy()
        if moved is not None:
            xm[:, moved] += 1.0
        got, _ = lm.forward(cfg, params, torch.from_numpy(xm),
                            torch.from_numpy(pos))
        want, _ = ref_lm.forward(cfg_r, params_r, jnp.asarray(xm),
                                 jnp.asarray(pos))
        assert _rel(got, want) < 1e-5
        out[moved] = got[:, 3].numpy()
    np.testing.assert_allclose(out[1], out[None], rtol=0, atol=1e-6)
    assert np.abs(out[0] - out[None]).max() > 1e-4


def test_decode_matches_forward(model):
    _, cfg, _, params = model
    toks = torch.from_numpy(_tokens(1, 2, 24, cfg.vocab))
    full, _ = lm.forward(cfg, params, toks)
    cache = lm.init_cache(cfg, 2, 24, device="cpu")
    outs = []
    for t in range(24):
        pos = positions_for(cfg, 2, 1, offset=t)
        assert tuple(pos.shape) == (2, 1, 3)
        lg, cache = lm.decode_step(cfg, params, cache, toks[:, t:t + 1], pos)
        outs.append(lg[:, 0])
    assert _rel(torch.stack(outs, 1), full) < 2e-3


@pytest.mark.parametrize("ragged", [False, True])
def test_greedy_decode_tokens_equal_reference(model, ragged):
    cfg_r, cfg, params_r, params = model
    prompts = _tokens(9, 3, 6, cfg.vocab)
    lengths = np.array([6, 2, 4], np.int32) if ragged else None
    want = ref_serve.greedy_decode(cfg_r, params_r, jnp.asarray(prompts), 6,
                                   lengths=lengths)
    got = greedy_decode(cfg, params, prompts, 6, lengths=lengths,
                        device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _trace(cfg, specs, cls):
    rng = np.random.default_rng(8)
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab, size=p).astype(
                np.int32), max_new=n, arrival=a)
            for i, (p, n, a) in enumerate(specs)]


def test_engine_streams_equal_reference_engine(model):
    """A mixed-arrival trace with evictions through both engines: equal
    out, status, ttft and finish for every request; each stream equal to
    ``greedy_decode``; no block leaked."""
    cfg_r, cfg, params_r, params = model
    specs = [(9, 6, 0.0), (17, 5, 2.0), (5, 7, 3.0), (11, 4, 3.0)]
    kw = dict(n_slots=2, n_blocks=7, block_size=4, max_len=28,
              prefill_chunk=4)
    eng = Engine(cfg, params, EngineConfig(**kw), device="cpu")
    mine = eng.run(_trace(cfg, specs, Request), clock="steps", max_steps=500)
    ref_eng = RefEngine(cfg_r, params_r, RefEngineConfig(**kw))
    theirs = ref_eng.run(_trace(cfg, specs, RefRequest), clock="steps",
                         max_steps=500)
    assert ref_eng.sched.n_evictions > 0
    for a, b in zip(mine, theirs, strict=True):
        assert (a.rid, a.status, a.out, a.ttft, a.finish) == \
            (b.rid, b.status, b.out, b.ttft, b.finish)
        assert a.status == "finished"
        want = greedy_decode(cfg, params, a.prompt[None], a.max_new,
                             device="cpu")[0].numpy()
        np.testing.assert_array_equal(np.asarray(a.out), want)
    assert not eng.sched.slots and eng.sched.alloc.n_free == kw["n_blocks"]


# ------------------------------------------------- taps and compression

@pytest.fixture(scope="module")
def compressed(model):
    """``*=slab`` (one iteration, CR 0.5) in both packages; the
    reference's decompositions packed by both."""
    cfg_r, cfg, params_r, params = model
    cal = np.asarray(calibration_batch(cfg.vocab, n_seq=2, seq_len=16))
    plan_r = RefPlan.parse(PLAN, base=RefSLaBConfig(cr=0.5, iters=1))
    dense_r, stats_r, decs_r = ref_pipeline.compress_model(
        cfg_r, params_r, cal, plan=plan_r, keep_decompositions=True)
    packed_r, rep_r = ref_pm.pack_plan_decs(dense_r, decs_r, cfg.n_layers,
                                            plan_r)
    dense, stats, decs = compress_model(
        cfg, params, cal, plan=PLAN, scfg=SLaBConfig(cr=0.5, iters=1),
        keep_decompositions=True, device="cpu")
    bdecs = {k: bridge.decomposition(jax.tree.map(np.asarray, d),
                                     device="cpu")
             for k, d in decs_r.items()}
    dense_b = _bridge(cfg, dense_r)
    packed, rep = pack_model(dense_b, bdecs, plan=PLAN)
    return dict(cal=cal, dense_r=dense_r, stats_r=stats_r,
                packed_r=packed_r, rep_r=rep_r, dense=dense, stats=stats,
                decs=decs, dense_b=dense_b, packed=packed, rep=rep)


def test_collect_model_stats_matches_reference(model, compressed):
    """Calibration on token ids, the taps' positions (B, S, 3): every
    linear of every layer tapped, the norms at rel < 1e-5."""
    cfg_r, cfg, params_r, params = model
    ref = ref_pipeline.collect_model_stats(cfg_r, params_r, compressed["cal"])
    got = collect_model_stats(cfg, params, compressed["cal"], device="cpu")
    assert got.n_forwards == ref.n_forwards == cfg.n_layers
    assert list(got.norms) == list(ref.norms) == [
        (l, p) for l in range(cfg.n_layers) for p in linear_paths(cfg)]
    for k in ref.norms:
        assert _rel(got.norms[k], ref.norms[k]) < 1e-5, k


def test_compressed_model_matches_reference(model, compressed):
    _, cfg, _, _ = model
    s = compressed
    assert [(st.layer, st.name) for st in s["stats"]] == \
        [(st.layer, st.name) for st in s["stats_r"]]
    assert len(s["stats"]) == 7 * cfg.n_layers
    for a, b in zip(s["stats"], s["stats_r"]):
        assert a.variant == b.variant == "slab-ell"
        assert abs(a.cr - b.cr) < 1e-6
    for (path, a), (_, b) in zip(leaves_with_path(s["dense"]["layers"]),
                                 leaves_with_path(s["dense_b"]["layers"]),
                                 strict=True):
        assert _rel(a, b) < 1e-4, path
    assert s["dense"]["embed"] is model[3]["embed"]


def test_packed_logits_match_reference_packed_model(model, compressed):
    """Every linear packed slab-ell, the tied ``embed`` a plain tensor;
    the packed forward (token ids and a patch grid) and decode at rel <
    1e-4 of the reference's packed model (its kernels in interpret
    mode)."""
    cfg_r, cfg, _, _ = model
    s = compressed
    rep, rep_r = s["rep"], s["rep_r"]
    assert rep.by_variant == rep_r.by_variant == {"slab-ell": 14}
    assert rep.paths == rep_r.paths and not rep.fallback
    packed = s["packed"]
    assert not isinstance(packed["embed"], PackedLinear)
    assert "lm_head" not in packed
    for l in range(cfg.n_layers):
        for pth in linear_paths(cfg):
            mod, leaf = pth.split(".")
            assert isinstance(packed["layers"][l][mod][leaf], PackedLinear)
    toks = _tokens(5, 2, 8, cfg.vocab)
    ids = FORWARD_CASES["grid"]
    x = _embeds(6, 1, len(ids), cfg.d_model)
    got, _ = lm.forward(cfg, packed, torch.from_numpy(x),
                        torch.from_numpy(ids[None]))
    want, _ = ref_lm.forward(cfg_r, s["packed_r"], jnp.asarray(x),
                             jnp.asarray(ids[None]))
    assert _rel(got, want) < 1e-4
    g = greedy_decode(cfg, packed, toks[:, :4], 4, device="cpu")
    g_r = ref_serve.greedy_decode(cfg_r, s["packed_r"],
                                  jnp.asarray(toks[:, :4]), 4)
    np.testing.assert_array_equal(g.numpy(), np.asarray(g_r))
    own, own_rep = pack_model(s["dense"], s["decs"], plan=PLAN)
    assert own_rep.by_variant == {"slab-ell": 14}
    assert own["embed"] is s["dense"]["embed"]
    # the reference's packed tree (stacked packed leaves, no lm_head)
    # bridged: the same forward as the port's packing of its decs
    bridged = _bridge(cfg, s["packed_r"])
    assert set(bridged) == {"embed", "layers", "final_norm"}
    got_b, _ = lm.forward(cfg, bridged, torch.from_numpy(toks))
    got_p, _ = lm.forward(cfg, packed, torch.from_numpy(toks))
    assert _rel(got_b, got_p) < 1e-6


# ------------------------------------------------------------ training

def test_loss_and_grads_match_reference(model):
    """Embeddings with grid positions (the batch's positions move to the
    params' device with the inputs); every gradient at rel < 1e-5, the
    tied table's too."""
    cfg_r, cfg, params_r, params = model
    ids = FORWARD_CASES["grid"]
    x = _embeds(4, 2, len(ids), cfg.d_model)
    labels = _tokens(4, 2, len(ids), cfg.vocab)
    pos = np.broadcast_to(ids, (2,) + ids.shape).copy()
    batch_r = {"inputs": jnp.asarray(x), "labels": jnp.asarray(labels),
               "positions": jnp.asarray(pos)}
    (loss_r, _), grads_r = jax.jit(jax.value_and_grad(
        lambda p: ref_lm.loss_fn(cfg_r, p, batch_r), has_aux=True))(params_r)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, _ = lm.loss_fn(cfg, params, {"inputs": x, "labels": labels,
                                           "positions": pos})
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    loss = float(loss.detach())
    assert abs(loss - float(loss_r)) <= 1e-5 * abs(float(loss_r))
    g_b = tree_leaves(_bridge(cfg, grads_r))
    paths = [p for p, _ in leaves_with_path(params)]
    for path, a, b in zip(paths, grads, g_b, strict=True):
        assert _rel(a, b) < 1e-5, path


def _ref_batches(arch, steps, batch, seq, monkeypatch):
    """The batches the reference's ``launch.train`` feeds its step, read
    through a host callback in place of the train step."""
    from repro.launch import train as ref_train
    seen = []

    def recorder(cfg, acfg, planner, **kw):
        def fn(params, opt, b):
            jax.debug.callback(lambda **a: seen.append(
                {k: np.asarray(v) for k, v in a.items()}), **b)
            z = jnp.zeros((), jnp.float32)
            return params, opt, {"loss": z, "grad_norm": z, "lr": z}
        return fn

    monkeypatch.setattr(ref_train, "make_train_fn", recorder)
    ref_train.train(arch, True, steps, batch, seq, None)
    jax.effects_barrier()
    return seen


def test_train_batches_equal_reference_and_train_runs(monkeypatch):
    """``launch.train``'s step batches (standard-normal embeddings from
    ``default_rng(step)`` and the corpus's labels) bitwise equal to the
    reference's; two steps of the vlm train."""
    from repro_torch.data import SyntheticCorpus
    from repro_torch.launch.train import make_batch, train
    cfg = configs.get(ARCH, smoke=True)
    want = _ref_batches(ARCH, 2, 2, 16, monkeypatch)
    corpus = SyntheticCorpus(cfg.vocab, seed=0)
    assert len(want) == 2
    for step, w in enumerate(want):
        got = make_batch(cfg, corpus, step, 2, 16, "cpu")
        assert sorted(got) == sorted(w)
        assert got["inputs"].dtype == torch.float32
        assert tuple(got["inputs"].shape) == (2, 16, cfg.d_model)
        for k in w:
            np.testing.assert_array_equal(got[k].numpy(), w[k])
    _, losses = train(ARCH, True, 2, 2, 16, None, device="cpu")
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_tied_tree_checkpoints_across_packages(tmp_path):
    """The bf16 tied tree (no ``lm_head``) saved by the port loads in the
    reference bitwise, as the reference's layer-stacked tree, and the
    reference's save of that tree in the port."""
    cfg = configs.get(ARCH, smoke=True)
    params = lm.init(cfg, seed=3, device="cpu")
    assert "lm_head" not in params
    hold_checkpoints_across_packages(params, cfg.n_layers, tmp_path)


def ref_layout(params: dict) -> dict:
    """The port's params as the reference holds them: the layer list
    stacked leaf by leaf on a leading L dim (bf16 bit-exact)."""
    def stack(ls):
        if isinstance(ls[0], dict):
            return {k: stack([d[k] for d in ls]) for k in ls[0]}
        return jnp.asarray(np.stack([bridge_np(t) for t in ls]))
    out = {k: jax.tree.map(lambda t: jnp.asarray(bridge_np(t)), v)
           for k, v in params.items() if k != "layers"}
    out["layers"] = stack(params["layers"])
    return out


def hold_checkpoints_across_packages(params: dict, n_layers: int,
                                     tmp_path) -> None:
    """``params`` saved by the port loads bitwise in the reference as its
    layer-stacked tree, and the reference's save of that tree loads
    bitwise in the port."""
    as_jax = ref_layout(params)
    save_pytree(params, str(tmp_path / "port"))
    got_r = ref_load(as_jax, str(tmp_path / "port"))
    ref_save(as_jax, str(tmp_path / "ref"))
    got = load_pytree(params, str(tmp_path / "ref"), device="cpu")
    back = bridge.params(jax.tree.map(np.asarray, got_r), n_layers,
                         device="cpu")
    for a, b, c in zip(tree_leaves(params), tree_leaves(back),
                       tree_leaves(got), strict=True):
        assert np.array_equal(bridge_np(a).view(np.uint8),
                              bridge_np(b).view(np.uint8))
        assert c.dtype == a.dtype and torch.equal(c, a)


def bridge_np(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy, bf16 as ``ml_dtypes.bfloat16`` (bit-exact)."""
    import ml_dtypes
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()
