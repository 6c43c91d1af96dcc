"""The port's serve slice end to end against the reference on bridged
inputs: stablelm_12b SMOKE (GQA) at f32 with 2 layers.

- dense ``forward`` and every ``decode_step`` at rel < 1e-5;
- the reference's decompositions, bridged and packed by the port, serve
  packed ``decode_step`` logits within rel 1e-4 of the reference's packed
  model (unstructured -> slab-ell, and 2:4 -> slab-nm);
- ``greedy_decode`` tokens, square and ragged, equal the reference's on
  the same planes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import packed_model as ref_pm
from repro.core import pipeline as ref_pipeline
from repro.core.slab import SLaBConfig as RefSLaBConfig
from repro.data import calibration_batch
from repro.launch import serve as ref_serve
from repro.models import lm as ref_lm
from repro.models.common import positions_for as ref_positions_for
from repro_torch import bridge, configs
from repro_torch.core.packed_model import PackedLinear, pack_model
from repro_torch.core.pipeline import linear_paths
from repro_torch.core.plan import plan_for_method
from repro_torch.core.slab import SLaBConfig
from repro_torch.launch.serve import greedy_decode
from repro_torch.models import lm
from repro_torch.models.common import positions_for


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# the reference's eager decode/forward dispatch op by op (and its packed
# kernels run in interpret mode); jit them once per shape
_ref_decode = jax.jit(ref_lm.decode_step, static_argnums=0)
_ref_forward = jax.jit(lambda cfg, p, t: ref_lm.forward(cfg, p, t)[0],
                       static_argnums=0)


@pytest.fixture(scope="module")
def models():
    cfg_r = ref_configs.get("stablelm_12b", smoke=True).with_(
        dtype=jnp.float32)
    cfg = configs.get("stablelm_12b", smoke=True).with_(dtype=torch.float32)
    params_r, _ = ref_lm.init(cfg_r, jax.random.PRNGKey(0))
    return cfg_r, cfg, params_r, bridge.params(_np_tree(params_r),
                                               cfg.n_layers, device="cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_forward_matches_reference(models):
    cfg_r, cfg, params_r, params = models
    toks = _tokens(1, 2, 16, cfg.vocab)
    want = _ref_forward(cfg_r, params_r, jnp.asarray(toks))
    got, _ = lm.forward(cfg, params, torch.from_numpy(toks))
    assert got.shape == (2, 16, cfg.vocab)
    assert _rel(got, want) < 1e-5


def test_decode_steps_match_reference(models):
    cfg_r, cfg, params_r, params = models
    b, s = 2, 8
    toks = _tokens(2, b, s, cfg.vocab)
    cache_r = ref_lm.init_cache(cfg_r, b, s)
    cache = lm.init_cache(cfg, b, s, device="cpu")
    for t in range(s):
        want, cache_r = _ref_decode(
            cfg_r, params_r, cache_r, jnp.asarray(toks[:, t:t + 1]),
            ref_positions_for(cfg_r, b, 1, offset=t))
        got, cache = lm.decode_step(
            cfg, params, cache, torch.from_numpy(toks[:, t:t + 1]),
            positions_for(cfg, b, 1, offset=t))
        assert _rel(got, want) < 1e-5, t
    # the bridged reference cache holds the same keys/values
    kv = bridge.kv_cache(_np_tree(cache_r.kv), device="cpu")
    for a, c in zip(kv, cache):
        assert a.length == c.length == s
        assert _rel(c.k, a.k) < 1e-5 and _rel(c.v, a.v) < 1e-5


@pytest.fixture(scope="module", params=[None, "2:4"], ids=["ell", "2:4"])
def packed(request, models):
    """Reference compress -> reference packed model, and the same decs
    bridged and packed by the port."""
    pattern = request.param
    cfg_r, cfg, params_r, _ = models
    calib = calibration_batch(cfg.vocab, n_seq=2, seq_len=16)
    dense_r, _, decs_r = ref_pipeline.compress_model(
        cfg_r, params_r, calib, method="slab",
        scfg=RefSLaBConfig(cr=0.5, iters=1, pattern=pattern),
        keep_decompositions=True)
    packed_r = ref_pm.pack_model(dense_r, decs_r, cfg_r.n_layers,
                                 pattern=pattern, dtype=jnp.float32)
    decs = {k: bridge.decomposition(d, device="cpu") for k, d in decs_r.items()}
    dense = bridge.params(_np_tree(dense_r), cfg.n_layers, device="cpu")
    packed_p, rep = pack_model(
        dense, decs, plan=plan_for_method("slab", SLaBConfig(
            pattern=pattern)), dtype=torch.float32)
    variant = "slab-nm" if pattern else "slab-ell"
    assert rep.by_variant == {variant: cfg.n_layers * len(linear_paths(cfg))}
    for lp in packed_p["layers"]:
        assert isinstance(lp["attn"]["wq"], PackedLinear)
        assert lp["mlp"]["w_down"].variant == variant
    return pattern, packed_r, packed_p


def test_packed_decode_matches_reference_packed(models, packed):
    cfg_r, cfg, _, _ = models
    _, packed_r, packed_p = packed
    b, s = 2, 6
    toks = _tokens(3, b, s, cfg.vocab)
    cache_r = ref_lm.init_cache(cfg_r, b, s)
    cache = lm.init_cache(cfg, b, s, device="cpu")
    for t in range(s):
        want, cache_r = _ref_decode(
            cfg_r, packed_r, cache_r, jnp.asarray(toks[:, t:t + 1]),
            ref_positions_for(cfg_r, b, 1, offset=t))
        got, cache = lm.decode_step(
            cfg, packed_p, cache, torch.from_numpy(toks[:, t:t + 1]),
            positions_for(cfg, b, 1, offset=t))
        assert _rel(got, want) < 1e-4, t


def test_packed_forward_matches_reference_packed(models, packed):
    """The packed full-sequence forward: M = B·S rows through each
    kernel wrapper."""
    cfg_r, cfg, _, _ = models
    _, packed_r, packed_p = packed
    toks = _tokens(4, 2, 12, cfg.vocab)
    want = _ref_forward(cfg_r, packed_r, jnp.asarray(toks))
    got, _ = lm.forward(cfg, packed_p, torch.from_numpy(toks))
    assert _rel(got, want) < 1e-4


def test_greedy_tokens_equal_reference(models, packed):
    cfg_r, cfg, _, _ = models
    _, packed_r, packed_p = packed
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
