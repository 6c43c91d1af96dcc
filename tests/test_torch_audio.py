"""The port's audio family (hubert-xlarge: a non-causal encoder on
precomputed frame embeddings, no rotary embedding, no token table, no
decode path) against the reference on the CPU, at the SMOKE geometry (2
layers, d_model 64, 4 heads of 16, GELU d_ff 128, 64 units) and f32, on
bridged weights:

- the tree: ``lm_head`` and no ``embed``; ``lm.forward`` and
  ``runtime.step.make_prefill_fn`` on embeddings at rel < 1e-5; the
  encoder is bidirectional (``test_models.py``);
- ``collect_model_stats`` and ``compress_model`` calibrated on (N, S, D)
  embeddings, whole and streamed in chunks, against the reference; the
  reference's decompositions packed by ``pack_model`` (every linear, the
  ``lm_head`` never) at rel < 1e-4 of the reference's packed model;
- ``loss_fn`` and its gradients at rel < 1e-5; ``launch.train``'s
  embeddings batches bitwise equal to the reference's, and the tree
  through a checkpoint of either package;
- no decode path: the engine, ``paged_decode_step`` and ``serve --arch
  hubert_xlarge`` refuse the family.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import packed_model as ref_pm
from repro.core import pipeline as ref_pipeline
from repro.core.plan import CalibrationSpec as RefSpec
from repro.core.plan import CompressionPlan as RefPlan
from repro.core.slab import SLaBConfig as RefSLaBConfig
from repro.models import lm as ref_lm
from repro_torch import bridge, configs
from repro_torch.core.packed_model import PackedLinear, pack_model
from repro_torch.core.pipeline import (collect_model_stats, compress_model,
                                       linear_paths)
from repro_torch.core.plan import CalibrationSpec
from repro_torch.core.slab import SLaBConfig
from repro_torch.models import lm
from repro_torch.runtime.step import make_prefill_fn
from repro_torch.serving import Engine, EngineConfig
from repro_torch.tree import leaves_with_path, tree_leaves
from test_torch_vlm import _ref_batches, hold_checkpoints_across_packages

ARCH = "hubert_xlarge"
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


def _frames(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


@pytest.fixture(scope="module")
def model():
    cfg_r = ref_configs.get(ARCH, smoke=True).with_(dtype=jnp.float32)
    cfg = configs.get(ARCH, smoke=True).with_(dtype=torch.float32)
    params_r, _ = ref_lm.init(cfg_r, jax.random.PRNGKey(0))
    return cfg_r, cfg, params_r, _bridge(cfg, params_r)


def test_tree_has_no_token_table(model):
    cfg_r, cfg, params_r, params = model
    assert set(params) == set(params_r) == {"layers", "final_norm",
                                            "lm_head"}
    assert set(lm.init(cfg, device="cpu")) == set(params)
    assert set(lm.abstract_params(cfg)) == set(params)
    assert lm.params_device(params).type == "cpu"


@pytest.mark.parametrize("s", [64, 40])
def test_forward_and_prefill_match_reference(model, s):
    cfg_r, cfg, params_r, params = model
    x = _frames(7, 2, s, cfg.d_model)
    want, _ = ref_lm.forward(cfg_r, params_r, jnp.asarray(x))
    got, _ = lm.forward(cfg, params, torch.from_numpy(x))
    assert got.shape == (2, s, cfg.vocab)
    assert _rel(got, want) < 1e-5
    pre = make_prefill_fn(cfg)(params, torch.from_numpy(x))
    assert _rel(pre, ref_lm.prefill(cfg_r, params_r, jnp.asarray(x))) < 1e-5
    assert not pre.requires_grad


def test_encoder_is_bidirectional(model):
    """Moving the LAST frame moves the FIRST frame's output (the
    reference's case); in a causal model it could not."""
    _, cfg, _, params = model
    x = torch.from_numpy(_frames(1, 1, 32, cfg.d_model))
    base, _ = lm.forward(cfg, params, x)
    x2 = x.clone()
    x2[:, -1] = 0.0
    pert, _ = lm.forward(cfg, params, x2)
    assert float((pert[:, 0] - base[:, 0]).abs().max()) > 1e-6
    c_base, _ = lm.forward(cfg.with_(causal=True), params, x)
    c_pert, _ = lm.forward(cfg.with_(causal=True), params, x2)
    assert float((c_pert[:, 0] - c_base[:, 0]).abs().max()) < 1e-6


# ------------------------------------------------------ compression

@pytest.fixture(scope="module")
def compressed(model):
    """``*=slab`` (one iteration, CR 0.5) calibrated on 4 x 16 frame
    embeddings in both packages; the reference's decompositions packed by
    both."""
    cfg_r, cfg, params_r, params = model
    cal = _frames(11, 4, 16, cfg.d_model)
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
    return dict(cal=cal, stats_r=stats_r, packed_r=packed_r, rep_r=rep_r,
                dense=dense, stats=stats, decs=decs, dense_b=dense_b,
                packed=packed, rep=rep)


@pytest.mark.parametrize("chunk", [None, 2])
def test_collect_model_stats_on_embeddings(model, compressed, chunk):
    """Every linear of every layer tapped from frame embeddings, whole or
    streamed two sequences a chunk; norms at rel < 1e-5 of the
    reference's."""
    cfg_r, cfg, params_r, params = model
    cal = compressed["cal"]
    ref = ref_pipeline.collect_model_stats(
        cfg_r, params_r, cal if chunk is None else RefSpec(cal, chunk))
    got = collect_model_stats(
        cfg, params, cal if chunk is None else CalibrationSpec(cal, chunk),
        device="cpu")
    assert got.n_forwards == ref.n_forwards == cfg.n_layers * (
        1 if chunk is None else 2)
    assert list(got.norms) == list(ref.norms) == [
        (l, p) for l in range(cfg.n_layers) for p in linear_paths(cfg)]
    for k in ref.norms:
        assert _rel(got.norms[k], ref.norms[k]) < 1e-5, k


def test_compressed_model_matches_reference(model, compressed):
    _, cfg, _, _ = model
    s = compressed
    assert linear_paths(cfg) == ["attn.wq", "attn.wk", "attn.wv", "attn.wo",
                                 "mlp.w_up", "mlp.w_down"]
    assert [(st.layer, st.name) for st in s["stats"]] == \
        [(st.layer, st.name) for st in s["stats_r"]]
    for a, b in zip(s["stats"], s["stats_r"], strict=True):
        assert a.variant == b.variant == "slab-ell"
        assert abs(a.cr - b.cr) < 1e-6
    for (path, a), (_, b) in zip(leaves_with_path(s["dense"]["layers"]),
                                 leaves_with_path(s["dense_b"]["layers"]),
                                 strict=True):
        assert _rel(a, b) < 1e-4, path


def test_packed_logits_match_reference_packed_model(model, compressed):
    cfg_r, cfg, _, _ = model
    s = compressed
    assert s["rep"].by_variant == s["rep_r"].by_variant == {
        "slab-ell": 6 * cfg.n_layers}
    assert s["rep"].paths == s["rep_r"].paths and not s["rep"].fallback
    packed = s["packed"]
    assert not isinstance(packed["lm_head"], PackedLinear)
    for l in range(cfg.n_layers):
        for pth in linear_paths(cfg):
            mod, leaf = pth.split(".")
            assert isinstance(packed["layers"][l][mod][leaf], PackedLinear)
    x = _frames(5, 2, 16, cfg.d_model)
    got = lm.prefill(cfg, packed, torch.from_numpy(x))
    want = ref_lm.prefill(cfg_r, s["packed_r"], jnp.asarray(x))
    assert _rel(got, want) < 1e-4
    dense_eq = lm.prefill(cfg, s["dense_b"], torch.from_numpy(x))
    assert _rel(got, dense_eq) < 1e-4
    _, own_rep = pack_model(s["dense"], s["decs"], plan=PLAN)
    assert own_rep.by_variant == {"slab-ell": 6 * cfg.n_layers}
    # the reference's packed tree (stacked packed leaves, no embed)
    # bridged: the same prefill as the port's packing of its decs
    bridged = _bridge(cfg, s["packed_r"])
    assert set(bridged) == {"layers", "final_norm", "lm_head"}
    assert _rel(lm.prefill(cfg, bridged, torch.from_numpy(x)), got) < 1e-6


# ------------------------------------------------------------ training

def test_loss_and_grads_match_reference(model):
    cfg_r, cfg, params_r, params = model
    x = _frames(4, 2, 16, cfg.d_model)
    labels = np.random.default_rng(4).integers(0, cfg.vocab, (2, 16)).astype(
        np.int32)
    batch_r = {"inputs": jnp.asarray(x), "labels": jnp.asarray(labels)}
    (loss_r, _), grads_r = jax.jit(jax.value_and_grad(
        lambda p: ref_lm.loss_fn(cfg_r, p, batch_r), has_aux=True))(params_r)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, _ = lm.loss_fn(cfg, params, {"inputs": x, "labels": labels})
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


def test_train_batches_equal_reference_and_train_runs(monkeypatch):
    from repro_torch.data import SyntheticCorpus
    from repro_torch.launch.train import make_batch, train
    cfg = configs.get(ARCH, smoke=True)
    want = _ref_batches(ARCH, 2, 2, 16, monkeypatch)
    corpus = SyntheticCorpus(cfg.vocab, seed=0)
    assert len(want) == 2
    for step, w in enumerate(want):
        got = make_batch(cfg, corpus, step, 2, 16, "cpu")
        assert sorted(got) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(got[k].numpy(), w[k])
    _, losses = train(ARCH, True, 2, 2, 16, None, device="cpu")
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_tree_checkpoints_across_packages(tmp_path):
    """The bf16 tree with no ``embed`` saved by the port loads in the
    reference bitwise, as the reference's layer-stacked tree, and the
    reference's save of that tree in the port."""
    cfg = configs.get(ARCH, smoke=True)
    params = lm.init(cfg, seed=3, device="cpu")
    hold_checkpoints_across_packages(params, cfg.n_layers, tmp_path)


# ------------------------------------------------------- no decode path

def test_decode_paths_refuse_the_family(model, capsys):
    _, cfg, _, params = model
    with pytest.raises(ValueError, match="paged cache"):
        Engine(cfg, params, EngineConfig(), device="cpu")
    with pytest.raises(ValueError, match="unsupported family"):
        lm.paged_decode_step(cfg, params, [], None, torch.zeros(2), None,
                             None)
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--arch", ARCH, "--device", "cpu"])
    err = capsys.readouterr().err
    assert "encoder-only" in err and "lm.prefill" in err
