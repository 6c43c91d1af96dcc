"""The port's second slice end to end against the reference on bridged
llama2_7b SMOKE weights at f32 (d_ff = 344: no sign words, so the
sparse-only and low-rank variants pack where slab-* cannot):

- ``compress_model`` with wanda 2:4, sparsegpt and slab W_S + W_L: every
  linear's tapped-norm errors within rel 1e-3 of the reference's
  ``CompressStats``, and the same variant;
- the reference's own packed planes, bridged, serve greedy tokens equal
  to the reference's ``greedy_decode``.
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
from repro_torch import bridge, configs
from repro_torch.core.packed_model import PackedLinear
from repro_torch.core.pipeline import _get, _set, compress_model
from repro_torch.core.slab import SLaBConfig
from repro_torch.launch.serve import greedy_decode

CASES = {
    "wanda-2:4": ("wanda", dict(cr=0.5, pattern="2:4"), "sparse-nm"),
    "sparsegpt": ("sparsegpt", dict(cr=0.5), "sparse-ell"),
    "slab-w_s+w_l": ("slab", dict(cr=0.5, iters=2, include_binary=False),
                     "lowrank-ell"),
}


@pytest.fixture(scope="module")
def models():
    cfg_r = ref_configs.get("llama2_7b", smoke=True).with_(
        dtype=jnp.float32)
    cfg = configs.get("llama2_7b", smoke=True).with_(dtype=torch.float32)
    params_r, _ = ref_lm.init(cfg_r, jax.random.PRNGKey(0))
    params = bridge.params(jax.tree.map(np.asarray, params_r), cfg.n_layers, device="cpu")
    return cfg_r, cfg, params_r, params


@pytest.fixture(scope="module", params=sorted(CASES))
def compressed(request, models):
    """Both packages compress the same bridged weights; the reference's
    model is packed by the reference and bridged layer by layer."""
    method, kw, variant = CASES[request.param]
    cfg_r, cfg, params_r, params = models
    calib = calibration_batch(cfg.vocab, n_seq=4, seq_len=32)
    dense_r, st_r, decs_r = ref_pipeline.compress_model(
        cfg_r, params_r, calib, method=method, scfg=RefSLaBConfig(**kw),
        keep_decompositions=True)
    _, st = compress_model(cfg, params, calib, method=method,
                           scfg=SLaBConfig(**kw), device="cpu")
    packed_r = ref_pm.pack_model(dense_r, decs_r, cfg_r.n_layers,
                                 pattern=kw.get("pattern"),
                                 dtype=jnp.float32)
    packed = bridge.params(
        jax.tree.map(np.asarray, {k: v for k, v in dense_r.items()}),
        cfg.n_layers, device="cpu")
    for (l, path) in decs_r:
        pl_r = ref_pm.layer_slice(packed_r["layers"], l)
        _set(packed["layers"][l], path,
             bridge.packed_linear(_get(pl_r, path), device="cpu"))
    return variant, st_r, st, packed_r, packed


def test_compress_stats_match_reference(compressed):
    variant, st_r, st, _, _ = compressed
    assert [(s.layer, s.name) for s in st] == \
        [(s.layer, s.name) for s in st_r]
    for a, b in zip(st, st_r):
        assert abs(a.err_before - b.err_before) / b.err_before < 1e-3
        assert abs(a.err_after - b.err_after) / b.err_after < 1e-3, a.name
        assert abs(a.cr - b.cr) < 2e-3, a.name
        assert a.variant == b.variant == variant


def test_greedy_tokens_equal_reference_on_bridged_planes(models,
                                                         compressed):
    cfg_r, cfg, _, _ = models
    variant, _, _, packed_r, packed = compressed
    for lp in packed["layers"]:
        for w in (lp["attn"]["wq"], lp["mlp"]["w_down"]):
            assert isinstance(w, PackedLinear) and w.variant == variant
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab, (3, 8)).astype(np.int32)
    want = ref_serve.greedy_decode(cfg_r, packed_r, jnp.asarray(prompts), 5)
    got = greedy_decode(cfg, packed, prompts, 5, device="cpu")
    assert np.array_equal(got.numpy(), np.asarray(want))
    if variant != "lowrank-ell":
        return                  # the ragged batch once, on one variant
    lengths = np.array([8, 3, 6], np.int32)
    want = ref_serve.greedy_decode(cfg_r, packed_r, jnp.asarray(prompts), 5,
                                   lengths=lengths)
    got = greedy_decode(cfg, packed, prompts, 5, lengths=lengths,
                        device="cpu")
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_serve_cli_packs_wanda_2to4_as_sparse_nm_on_the_cpu(capsys):
    """The CLI takes every registered compressor; wanda 2:4 on llama2_7b
    SMOKE leaves no linear dense."""
    from repro_torch.core import compressor
    from repro_torch.launch import serve
    assert set(compressor.available()) == {
        "hassle", "magnitude", "slab", "sola", "sparsegpt", "wanda"}
    serve.main(["--arch", "llama2_7b", "--compress", "wanda", "--pattern",
                "2:4", "--packed", "--device", "cpu", "--calib-seqs", "4",
                "--calib-len", "32"])
    out = capsys.readouterr().out
    assert "compressed 14 linears (wanda)" in out
    assert "packed serving: 14 linears on the kernel path across 7 paths " \
           "[sparse-nm=14]" in out
    assert "sample generation:" in out
