"""The port's compression core against the reference: configs, the
synthetic corpus, the packers (byte-identical planes for the same
bridged decomposition), ``slab_decompose`` and ``compress_model``.

Inputs are made with numpy from a seed and handed to both sides."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import packed_model as ref_pm
from repro.core import packing as ref_packing
from repro.core import pipeline as ref_pipeline
from repro.core import slab as ref_slab
from repro.core import sparsity as ref_sparsity
from repro.data import synthetic as ref_synth
from repro.models import lm as ref_lm
from repro_torch import bridge, configs
from repro_torch.core import packed_model, packing, pipeline, slab, sparsity
from repro_torch.data import synthetic


@pytest.mark.parametrize("name,smoke", [("llama2_7b", False),
                                        ("llama2_7b", True),
                                        ("stablelm_12b", True),
                                        ("stablelm_12b", False)])
def test_config_fields_equal_reference(name, smoke):
    ref = ref_configs.get(name, smoke=smoke)
    port = configs.get(name, smoke=smoke)
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if f.name == "dtype":
            assert jnp.dtype(a).name == str(b).rsplit(".", 1)[-1]
        else:
            assert a == b, f.name


def test_synthetic_corpus_streams_identical():
    for seed in (0, 3):
        a = ref_synth.SyntheticCorpus(512, seed=seed).batch(2, 3, 17)
        b = synthetic.SyntheticCorpus(512, seed=seed).batch(2, 3, 17)
        for k in ("inputs", "labels"):
            assert np.array_equal(a[k], b[k])
        assert np.array_equal(
            ref_synth.calibration_batch(512, seed, n_seq=4, seq_len=32),
            synthetic.calibration_batch(512, seed, n_seq=4, seq_len=32))


def test_topk_mask_breaks_ties_by_lower_index():
    """Exact ties (quantized scores) keep the lower column ids, as
    lax.top_k does."""
    rng = np.random.default_rng(0)
    s = np.round(rng.random((16, 64)) * 4).astype(np.float32)
    for k in (1, 7, 32, 63):
        want = np.asarray(ref_sparsity._exact_topk_mask_rows(
            jnp.asarray(s), k))
        got = sparsity._exact_topk_mask_rows(torch.from_numpy(s), k).numpy()
        assert np.array_equal(got, want)
    want = np.asarray(ref_sparsity.prune_mask(jnp.asarray(s), 0.4,
                                              pattern="2:4"))
    got = sparsity.prune_mask(torch.from_numpy(s), 0.4, pattern="2:4")
    assert np.array_equal(got.numpy(), want)


def _ref_dec(seed, d_out=64, d_in=128, pattern=None, iters=2):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((d_out, d_in)) * 0.05).astype(np.float32)
    an = np.abs(rng.standard_normal(d_in)).astype(np.float32) + 0.1
    cfg = ref_slab.SLaBConfig(cr=0.5, iters=iters, pattern=pattern)
    dec = ref_slab.slab_decompose(jnp.asarray(w), jnp.asarray(an), cfg)
    return w, an, dec


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pattern", [None, "2:4", "4:8"])
def test_packers_byte_identical(pattern, dtype):
    """pack_sign_bits / pack_nm / ell_pack and pack_linear give the same
    bytes as the reference for the same bridged decomposition."""
    _, _, dec = _ref_dec(5, pattern=pattern)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    pdec = bridge.decomposition(dec, device="cpu")
    assert np.array_equal(
        packing.pack_sign_bits(pdec.w_b).numpy(),
        np.asarray(ref_packing.pack_sign_bits(dec.w_b)).view(np.int32))
    ws_ref = dec.w_s.astype(jdt)
    ws = pdec.w_s.to(tdt)
    if pattern:
        n, m = map(int, pattern.split(":"))
        a, b = ref_packing.pack_nm(ws_ref, n, m), packing.pack_nm(ws, n, m)
        assert torch.equal(b.values, bridge.tensor(a.values, device="cpu"))
        assert torch.equal(b.indices, bridge.tensor(a.indices, device="cpu"))
    else:
        a, b = ref_packing.ell_pack(ws_ref), packing.ell_pack(ws)
        assert torch.equal(b.values, bridge.tensor(a.values, device="cpu"))
        assert torch.equal(b.indices, bridge.tensor(a.indices, device="cpu"))
        assert b.indices.dtype == torch.int16
    want = bridge.packed_linear(ref_pm.pack_linear(dec, pattern, jdt), device="cpu")
    got = packed_model.pack_linear(pdec, pattern, tdt)
    assert got.variant == want.variant
    for f in ("sparse_vals", "sparse_idx", "b_packed", "u", "v"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_ell_pads_on_zero_columns_like_reference():
    """Short rows pad with value 0 at the lowest unused zero columns."""
    rng = np.random.default_rng(2)
    w = np.where(rng.random((8, 64)) < 0.3,
                 rng.standard_normal((8, 64)), 0.0).astype(np.float32)
    a = ref_packing.ell_pack(jnp.asarray(w))
    b = packing.ell_pack(torch.from_numpy(w))
    assert torch.equal(b.indices, bridge.tensor(a.indices, device="cpu"))
    assert torch.equal(b.values, bridge.tensor(a.values, device="cpu"))
    assert np.array_equal(packing.ell_unpack(b).numpy(), w)
    assert packing.ell_row_nnz_max(torch.from_numpy(w)) == \
        ref_packing.ell_row_nnz_max(jnp.asarray(w))


@pytest.mark.parametrize("pattern", [None, "2:4"])
def test_slab_decompose_one_iteration_agrees(pattern):
    w, an, dec = _ref_dec(11, d_out=96, d_in=256, pattern=pattern, iters=1)
    cfg = slab.SLaBConfig(cr=0.5, iters=1, pattern=pattern)
    got = slab.slab_decompose(torch.from_numpy(w), torch.from_numpy(an), cfg)
    agree = np.mean((got.w_s.numpy() != 0) == (np.asarray(dec.w_s) != 0))
    assert agree >= 0.999, agree
    e_ref = float(ref_slab.decomposition_error(jnp.asarray(w), dec,
                                               jnp.asarray(an)))
    e = float(slab.decomposition_error(torch.from_numpy(w), got,
                                       torch.from_numpy(an)))
    assert abs(e - e_ref) / e_ref < 1e-4
    assert np.array_equal(got.w_b.numpy(), np.asarray(dec.w_b))


def test_slab_decompose_four_iterations_error_agrees():
    w, an, dec = _ref_dec(12, d_out=96, d_in=256, iters=4)
    got = slab.slab_decompose(torch.from_numpy(w), torch.from_numpy(an),
                              slab.SLaBConfig(cr=0.5, iters=4))
    e_ref = float(ref_slab.decomposition_error(jnp.asarray(w), dec,
                                               jnp.asarray(an)))
    e = float(slab.decomposition_error(torch.from_numpy(w), got,
                                       torch.from_numpy(an)))
    assert abs(e - e_ref) / e_ref < 1e-3
    assert abs(slab.compression_ratio(got) -
               ref_slab.compression_ratio(dec)) < 1e-9


def test_compress_model_per_linear_errors_match_reference():
    """llama2_7b smoke at f32, bridged weights, one calibration batch:
    every linear's tapped-norm errors within rel 1e-3 of the reference."""
    cfg_r = ref_configs.get("llama2_7b", smoke=True).with_(
        dtype=jnp.float32)
    cfg = configs.get("llama2_7b", smoke=True).with_(dtype=torch.float32)
    params_r, _ = ref_lm.init(cfg_r, jax.random.PRNGKey(0))
    params = bridge.params(jax.tree.map(np.asarray, params_r), cfg.n_layers, device="cpu")
    calib = ref_synth.calibration_batch(cfg.vocab, n_seq=4, seq_len=32)
    _, st_r = ref_pipeline.compress_model(
        cfg_r, params_r, calib, scfg=ref_slab.SLaBConfig(cr=0.5, iters=2))
    _, st = pipeline.compress_model(
        cfg, params, calib, scfg=slab.SLaBConfig(cr=0.5, iters=2),
        device="cpu")
    assert [(s.layer, s.name) for s in st] == \
        [(s.layer, s.name) for s in st_r]
    for a, b in zip(st, st_r):
        assert abs(a.err_before - b.err_before) / b.err_before < 1e-3
        assert abs(a.err_after - b.err_after) / b.err_after < 1e-3, a.name
        assert abs(a.cr - b.cr) < 1e-9
        assert a.variant == b.variant == "slab-ell"
