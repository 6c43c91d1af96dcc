"""The port's compressors against the reference on identical numpy
inputs: the pruning baselines of Table I (wanda, magnitude, sparsegpt),
``sola`` and ``hassle``, the ``slab`` ablation modes of Table III with
rank-r factors, the Hessian taps and the loss."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import baselines as ref_base
from repro.core import compressor as ref_comp
from repro.core import lowrank as ref_lowrank
from repro.core import slab as ref_slab
from repro.data import synthetic as ref_synth
from repro.models import common as ref_common
from repro.models import lm as ref_lm
from repro_torch import bridge, configs
from repro_torch.core import baselines, compressor, lowrank, slab
from repro_torch.models import common, lm


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _weights(seed, d_out=64, d_in=128):
    """Seeded W, column norms and a Hessian X^T X of 256 tokens."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((d_out, d_in)) * 0.05).astype(np.float32)
    x = rng.standard_normal((256, d_in)).astype(np.float32)
    x *= np.abs(rng.standard_normal(d_in)).astype(np.float32) + 0.2
    h = (x.T @ x).astype(np.float32)
    an = np.sqrt(np.diag(h)).astype(np.float32)
    return w, an, h


def _both(name, cfg_kw, w, an=None, h=None, **opts):
    """One compressor of each package on the same inputs."""
    ref = ref_comp.get(name, ref_slab.SLaBConfig(**cfg_kw), **opts).compress(
        jnp.asarray(w), ref_comp.LinearStats(
            None if an is None else jnp.asarray(an),
            None if h is None else jnp.asarray(h)))
    got = compressor.get(name, slab.SLaBConfig(**cfg_kw), **opts).compress(
        torch.from_numpy(w), compressor.LinearStats(
            None if an is None else torch.from_numpy(an),
            None if h is None else bridge.hessian(h, device="cpu")))
    return ref, got


@pytest.mark.parametrize("name", ["wanda", "magnitude", "sola"])
@pytest.mark.parametrize("pattern", [None, "2:4", "4:8"])
def test_pruner_masks_bit_identical(name, pattern):
    w, an, _ = _weights(1)
    ref, got = _both(name, dict(cr=0.5, pattern=pattern), w, an)
    assert np.array_equal(got.dense.numpy() != 0, np.asarray(ref.dense) != 0)
    assert _rel(got.dense, ref.dense) < 1e-6
    assert got.cr == ref.cr
    assert got.dec.u.shape == (64, 0) and got.dec.v.shape == (128, 0)
    assert tuple(got.dec.w_b.shape) == (0, 0)
    assert torch.equal(got.dec.w_s, got.dense)


@pytest.mark.parametrize("pattern", [None, "2:4"])
def test_sparsegpt_matches_reference(pattern):
    """d_in 200: one full block of 128 and a ragged one of 72."""
    w, _, h = _weights(2, d_in=200)
    want = np.asarray(ref_base.sparsegpt_prune(jnp.asarray(w),
                                               jnp.asarray(h), 0.5,
                                               pattern=pattern))
    got = baselines.sparsegpt_prune(torch.from_numpy(w), torch.from_numpy(h),
                                    0.5, pattern=pattern).numpy()
    assert _rel(got, want) < 1e-4
    assert np.mean((got != 0) == (want != 0)) >= 0.999
    ref, cl = _both("sparsegpt", dict(cr=0.5, pattern=pattern), w, h=h)
    assert _rel(cl.dense, ref.dense) < 1e-4
    assert abs(cl.cr - ref.cr) < 2e-3


def test_sparsegpt_dead_columns_stay_zero():
    """A column no calibration token touched (zero Hessian diagonal) is
    zeroed, as in the reference."""
    w, _, h = _weights(3)
    h[:, 5] = 0.0
    h[5, :] = 0.0
    got = baselines.sparsegpt_prune(torch.from_numpy(w), torch.from_numpy(h),
                                    0.6).numpy()
    want = np.asarray(ref_base.sparsegpt_prune(jnp.asarray(w),
                                               jnp.asarray(h), 0.6))
    assert not got[:, 5].any() and not want[:, 5].any()
    assert _rel(got, want) < 1e-4


def test_hassle_matches_reference_on_w_s_plus_uv():
    """Compared on W_S + u vᵀ (the SVD's signs are arbitrary, so the
    factors themselves are not compared)."""
    w, an, h = _weights(4, d_out=48, d_in=96)
    ref, got = _both("hassle", dict(cr=0.5, rank=2), w, an, h, alt_iters=2)
    rebuild = lambda d: np.asarray(d.w_s, np.float64) + \
        np.asarray(d.u, np.float64) @ np.asarray(d.v, np.float64).T
    want = rebuild(ref.dec)
    assert _rel(rebuild(got.dec), want) < 1e-3
    assert _rel(got.dense, ref.dense) < 1e-3
    assert got.dec.u.shape == (48, 2) and tuple(got.dec.w_b.shape) == (0, 0)
    assert abs(got.cr - ref.cr) < 5e-3


ABLATIONS = {
    "w_s+w_l": dict(include_binary=False),
    "w_s+w_l_rank3": dict(include_binary=False, rank=3),
    "w_s+w_b": dict(include_lowrank=False),
    "w_s_only": dict(include_binary=False, include_lowrank=False),
    "factor": dict(factor_mode=True),
    "rank3": dict(rank=3),
}


@pytest.mark.parametrize("mode", sorted(ABLATIONS))
def test_slab_ablation_modes_match_reference(mode):
    w, an, _ = _weights(5)
    kw = dict(cr=0.5, iters=2, **ABLATIONS[mode])
    dec_r = ref_slab.slab_decompose(jnp.asarray(w), jnp.asarray(an),
                                    ref_slab.SLaBConfig(**kw))
    dec = slab.slab_decompose(torch.from_numpy(w), torch.from_numpy(an),
                              slab.SLaBConfig(**kw))
    assert _rel(slab.reconstruct(dec), ref_slab.reconstruct(dec_r)) < 1e-3
    assert np.mean((dec.w_s.numpy() != 0)
                   == (np.asarray(dec_r.w_s) != 0)) >= 0.999
    for a, b in ((dec.u, dec_r.u), (dec.v, dec_r.v), (dec.w_b, dec_r.w_b)):
        assert tuple(a.shape) == tuple(b.shape)
    assert abs(slab.compression_ratio(dec)
               - ref_slab.compression_ratio(dec_r)) < 1e-3


@pytest.mark.parametrize("shape,r", [((40, 60), 1), ((40, 60), 3),
                                     ((24, 1100), 2)])
def test_truncated_svd_matches_reference(shape, r):
    """All three branches: power iteration (r = 1), the exact SVD (the
    larger side ≤ 1024) and subspace iteration; compared on u s vᵀ."""
    rng = np.random.default_rng(6)
    y = rng.standard_normal(shape).astype(np.float32)
    y[:, :3] *= 4.0                     # a clear top of the spectrum
    s_r, u_r, v_r = ref_lowrank.truncated_svd(jnp.asarray(y), r)
    s, u, v = lowrank.truncated_svd(torch.from_numpy(y), r)
    want = (np.asarray(u_r) * np.asarray(s_r)) @ np.asarray(v_r).T
    got = ((u * s) @ v.T).numpy()
    assert _rel(got, want) < 1e-4
    assert _rel(s, s_r) < 1e-5


def test_hessian_tap_matches_reference():
    """Norms and X^T X Grams per tap name, restricted to the requested
    names; taps fed the same tensor share one Gram."""
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal((2, 5, 32)).astype(np.float32)
          for _ in range(2)]
    names = ("attn.wq", "attn.wk", "mlp.w_down")
    with ref_common.tap_capture(hessian=True,
                                hessian_names={"attn.wq", "attn.wk"}) as rc:
        for x in xs:
            xj = jnp.asarray(x)
            for nm in names:
                rc.record(nm, xj)
    with common.tap_capture(hessian=True,
                            hessian_names={"attn.wq", "attn.wk"}) as pc:
        for x in xs:
            xt = torch.from_numpy(x)
            for nm in names:
                common.tap_record(nm, xt)
    for nm in names:
        assert _rel(pc.norms(nm), rc.norms(nm)) < 1e-6
    for nm in ("attn.wq", "attn.wk"):
        assert _rel(pc.hessian(nm), rc.hessian(nm)) < 1e-6
    assert pc.hessian("mlp.w_down") is None
    assert rc.hessian("mlp.w_down") is None
    with common.tap_capture(hessian=True) as once:
        xt = torch.from_numpy(xs[0])
        common.tap_record("attn.wq", xt)
        common.tap_record("attn.wk", xt)
    assert once.hessian("attn.wq") is once.hessian("attn.wk")


def test_softmax_xent_and_loss_fn_match_reference():
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((2, 6, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 6)).astype(np.int32)
    mask = (rng.random((2, 6)) < 0.7).astype(np.float32)
    for m in (None, mask):
        want = float(ref_common.softmax_xent(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m)))
        got = float(common.softmax_xent(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m)))
        assert abs(got - want) / want < 1e-5

    cfg_r = ref_configs.get("llama2_7b", smoke=True).with_(
        dtype=jnp.float32)
    cfg = configs.get("llama2_7b", smoke=True).with_(dtype=torch.float32)
    params_r, _ = ref_lm.init(cfg_r, jax.random.PRNGKey(0))
    params = bridge.params(jax.tree.map(np.asarray, params_r), cfg.n_layers, device="cpu")
    batch = ref_synth.SyntheticCorpus(cfg.vocab, seed=0).batch(0, 2, 17)
    loss_r, parts_r = jax.jit(ref_lm.loss_fn, static_argnums=0)(
        cfg_r, params_r, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, parts = lm.loss_fn(cfg, params, batch)
    assert abs(float(loss) - float(loss_r)) / float(loss_r) < 1e-5
    assert abs(float(parts["ce"]) - float(parts_r["ce"])) < 1e-5 * float(
        parts_r["ce"])
