"""The port's deepseek-moe-16b slice against the reference on the CPU, at
the SMOKE geometry (d_model 64, 8 routed experts of d_ff 96, top-3, a
shared SwiGLU MLP of width 192) and f32, on bridged weights:

- the config mirror's fields, FULL and SMOKE;
- ``moe_ffn`` with its shared experts at rel < 1e-5, and the tap norms
  and Grams of every linear, ``moe.shared.*`` included;
- the bridge's nested ``moe.shared`` dict and the pipeline's paths;
- per method, both packages compressing the same bridged model (cut to
  1 layer: the reference compresses expert by expert in eager JAX):
  the same stats and variants, expert masks ≥ 99.9 % equal; the port's
  ``pack_model`` of the bridged reference decompositions byte-identical
  to the reference's pack, shared linears and expert stacks alike (the
  same groups per leaf and dense members); packed ``forward`` and
  ``decode_step`` logits at rel < 1e-4 and ``greedy_decode`` tokens
  equal (square; ragged once). Here: slab (slab-ell), sparsegpt
  (sparse-ell) and slab with W_S := 0 (binlr);
  ``test_torch_deepseek_variants.py`` runs hassle (lowrank-ell), hassle
  2:4 (lowrank-nm) and slab W_S + W_L (lowrank-dense) through the same
  chain;
- the port of the reference's
  ``test_deepseek_shared_experts_pack_and_match``.
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
from repro_torch import bridge, configs
from repro_torch.core import slab
from repro_torch.core.packed_model import (ExpertPackedStack, PackedLinear,
                                           pack_model)
from repro_torch.core.pipeline import _get, compress_model, linear_paths
from repro_torch.core.plan import plan_for_method
from repro_torch.launch.serve import greedy_decode
from repro_torch.models import common, lm, moe

EXPERT_PATHS = ("moe.w_gate", "moe.w_up", "moe.w_down")
SHARED_PATHS = ("moe.shared.w_gate", "moe.shared.w_up", "moe.shared.w_down")
PLANES = ("sparse_vals", "sparse_idx", "b_packed", "u", "v")


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


def _bridged(tree):
    if isinstance(tree, dict):
        return {k: _bridged(v) for k, v in tree.items()}
    return bridge.tensor(np.asarray(tree), device="cpu")


@pytest.mark.parametrize("smoke", [True, False])
def test_config_fields_equal_reference(smoke):
    ref = ref_configs.get("deepseek_moe_16b", smoke=smoke)
    port = configs.get("deepseek_moe_16b", smoke=smoke)
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if f.name == "dtype":
            assert jnp.dtype(a).name == str(b).rsplit(".", 1)[-1]
        else:
            assert a == b, f.name
    assert port.shared_ff == 2 * port.d_ff


# ------------------------------------------------ moe_ffn + shared experts

@pytest.fixture(scope="module")
def layer():
    cfg_r = ref_configs.get("deepseek_moe_16b", smoke=True).with_(
        dtype=jnp.float32)
    cfg = configs.get("deepseek_moe_16b", smoke=True).with_(
        dtype=torch.float32)
    p_r, _ = ref_moe.init_moe(cfg_r, jax.random.PRNGKey(3))
    return cfg_r, cfg, p_r, _bridged(p_r)


def _input(seed, b=2, s=8, d=64):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def test_moe_ffn_with_shared_experts_matches_reference(layer):
    """The routed experts plus the always-on shared MLP; the shared
    branch is exactly ``mlp`` of the shared weights on the layer input."""
    from repro_torch.models import mlp
    cfg_r, cfg, p_r, p = layer
    assert sorted(p["shared"]) == ["w_down", "w_gate", "w_up"]
    assert p["shared"]["w_up"].shape == (cfg.d_model, cfg.shared_ff)
    x = _input(5)
    y_r, aux_r = ref_moe.moe_ffn(cfg_r, p_r, jnp.asarray(x))
    y, aux = moe.moe_ffn(cfg, p, torch.from_numpy(x))
    assert y.shape == (2, 8, 64)
    assert _rel(y, y_r) < 1e-5
    assert abs(float(aux) - float(aux_r)) <= 1e-6 * abs(float(aux_r))
    routed, _ = moe.moe_ffn(cfg.with_(shared_ff=0), p, torch.from_numpy(x))
    shared = mlp.mlp(cfg, p["shared"], torch.from_numpy(x))
    assert _rel(y - routed, shared) < 1e-5


def test_shared_expert_taps_match_reference(layer):
    """Norms and Grams of every tap of the layer; the shared MLP's
    linears record as ``moe.shared.*``."""
    cfg_r, cfg, p_r, p = layer
    x = _input(7)
    with ref_common.tap_capture(hessian=True) as tap_r:
        with ref_common.tap_scope("moe"):
            ref_moe.moe_ffn(cfg_r, p_r, jnp.asarray(x))
    with common.tap_capture(hessian=True) as tap:
        with common.tap_scope("moe"):
            moe.moe_ffn(cfg, p, torch.from_numpy(x))
    names = ("moe.router",) + EXPERT_PATHS + SHARED_PATHS
    assert sorted(tap_r.names()) == sorted(names)
    for name in names:
        assert tap.has(name)
        assert _rel(tap.norms(name), tap_r.norms(name)) < 1e-5
        assert _rel(tap.hessian(name), tap_r.hessian(name)) < 1e-5


# ------------------------------------------------- compress / pack / serve

def build_models():
    """The reference's SMOKE model cut to 1 layer at f32, and the port's
    bridge of it."""
    cfg_r = ref_configs.get("deepseek_moe_16b", smoke=True).with_(
        dtype=jnp.float32, n_layers=1)
    cfg = configs.get("deepseek_moe_16b", smoke=True).with_(
        dtype=torch.float32, n_layers=1)
    params_r, _ = ref_lm.init(cfg_r, jax.random.PRNGKey(0))
    return cfg_r, cfg, params_r, bridge.params(_np_tree(params_r),
                                               cfg.n_layers, device="cpu")


@pytest.fixture(scope="module")
def models():
    return build_models()


def test_bridge_params_carry_shared_experts(models):
    cfg_r, cfg, params_r, params = models
    assert linear_paths(cfg) == ref_pipeline.linear_paths(cfg_r)
    for l, lp in enumerate(params["layers"]):
        shared = lp["moe"]["shared"]
        assert sorted(shared) == ["w_down", "w_gate", "w_up"]
        for name, t in shared.items():
            want = np.asarray(params_r["layers"]["moe"]["shared"][name][l])
            assert t.is_contiguous() and np.array_equal(t.numpy(), want)
        assert shared["w_down"].shape == (cfg.shared_ff, cfg.d_model)


class Chain:
    """One method through both packages: the reference's compressed
    model, stats and decompositions and its pack of them
    (``pack_plan_decs``); the port's compressed model, stats and
    decompositions, and its ``pack_model`` of the bridged reference
    decompositions."""

    def __init__(self, models, method, kw, zero_ws_of=None):
        cfg_r, cfg, params_r, params = models
        self.cfg_r, self.cfg = cfg_r, cfg
        self.pattern = kw.get("pattern")
        self.plan = CompressionPlan.parse(f"*={method}",
                                          base=ref_slab.SLaBConfig(**kw))
        if zero_ws_of is None:
            calib = calibration_batch(cfg.vocab, n_seq=2, seq_len=16)
            self.dense_r, self.st_r, self.decs_r = \
                ref_pipeline.compress_model(cfg_r, params_r, calib,
                                            plan=self.plan,
                                            keep_decompositions=True)
            self.dense, self.st, self.decs = compress_model(
                cfg, params, calib, method=method,
                scfg=slab.SLaBConfig(**kw), keep_decompositions=True,
                device="cpu")
        else:
            # W_S := 0 in every decomposition: what remains is W_L ⊙ W_B
            src = zero_ws_of
            self.dense_r, self.st_r, self.st = src.dense_r, None, None
            self.dense, self.decs = src.dense, None
            self.decs_r = {k: (tuple(_zero_ws(e) for e in d)
                               if type(d) is tuple else _zero_ws(d))
                           for k, d in src.decs_r.items()}
        self.packed_r, self.rep_r = ref_pm.pack_plan_decs(
            self.dense_r, self.decs_r, cfg_r.n_layers, self.plan)
        decs_b = {k: (bridge.expert_decompositions(d, device="cpu") if type(d) is tuple
                      else bridge.decomposition(d, device="cpu"))
                  for k, d in self.decs_r.items()}
        self.packed, self.rep = pack_model(
            bridge.params(_np_tree(self.dense_r), cfg.n_layers, device="cpu"), decs_b,
            plan=plan_for_method(method, slab.SLaBConfig(**kw)),
            dtype=torch.float32)


def _zero_ws(dec):
    return dec._replace(w_s=jnp.zeros_like(dec.w_s))


def check_decs_match(chain):
    """The port's stats and decompositions against the reference's: the
    same (layer, path, variant) in the same order, weighted errors within
    rel 1e-3, masks ≥ 99.9 % equal and the low-rank terms within rel
    1e-3 (W_L ⊙ W_B with a binary term, W_L = u vᵀ without)."""
    st, st_r, decs, decs_r = chain.st, chain.st_r, chain.decs, chain.decs_r
    assert [(s.layer, s.name, s.variant) for s in st] == \
        [(s.layer, s.name, s.variant) for s in st_r]
    for a, b in zip(st, st_r):
        assert abs(a.err_after - b.err_after) / b.err_after < 1e-3, a.name
    assert sorted(decs) == sorted(decs_r)
    for key in decs:
        d_e, r_e = decs[key], decs_r[key]
        if type(d_e) is not tuple:
            d_e, r_e = (d_e,), (r_e,)
        assert len(d_e) == len(r_e)
        for d, d_r in zip(d_e, r_e):
            agree = np.mean((d.w_s.numpy() != 0) == (np.asarray(d_r.w_s)
                                                     != 0))
            assert agree >= 0.999, (key, agree)
            if not d.u.numel():
                continue
            if d.w_b.numel():
                lr = slab.low_rank_times_binary(d)
                lr_r = ref_slab.low_rank_times_binary(d_r)
            else:
                lr = d.u.reshape(d.u.shape[0], -1) @ \
                    d.v.reshape(d.v.shape[0], -1).T
                lr_r = np.asarray(d_r.u).reshape(d_r.u.shape[0], -1) @ \
                    np.asarray(d_r.v).reshape(d_r.v.shape[0], -1).T
            assert _rel(lr, lr_r) < 1e-3, key


def _same_planes(got, want):
    assert (got.variant, got.m_pat, got.d_in, got.d_out, got.rank) == \
        (want.variant, want.m_pat, want.d_in, want.d_out, want.rank)
    for name in PLANES:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), name


def check_pack_byte_identical(chain, variant):
    """Every linear packed as ``variant`` with no dense fallback, in both
    packages; each shared linear a PackedLinear and each expert leaf an
    ExpertPackedStack byte-identical to the reference's pack (the same
    groups per leaf, members and dense members)."""
    cfg = chain.cfg
    assert chain.rep.fallback == () and chain.rep_r.fallback == []
    n_lin = cfg.n_layers * (4 + len(SHARED_PATHS)
                            + len(EXPERT_PATHS) * cfg.n_experts)
    assert chain.rep.by_variant == {variant: n_lin}
    assert dict(chain.rep_r.by_variant) == {variant: n_lin}
    assert "moe.shared.w_gate" in chain.rep.paths
    for l in range(cfg.n_layers):
        lp_r = ref_pm.layer_slice(chain.packed_r["layers"], l)
        lp = chain.packed["layers"][l]
        for path in SHARED_PATHS + ("attn.wq",):
            assert isinstance(_get(lp, path), PackedLinear), path
            _same_planes(_get(lp, path),
                         bridge.packed_linear(_get(lp_r, path), device="cpu"))
        for path in EXPERT_PATHS:
            eps = _get(lp, path)
            want = bridge.expert_packed_stack(_get(lp_r, path), device="cpu")
            assert isinstance(eps, ExpertPackedStack)
            assert eps.members == want.members
            assert eps.dense_members == want.dense_members == ()
            assert eps.dense is None and want.dense is None
            assert eps.variant_counts() == {variant: cfg.n_experts}
            for g, w in zip(eps.groups, want.groups, strict=True):
                _same_planes(g, w)


def check_serving(chain, ragged=False):
    """Packed forward and decode_step logits within rel 1e-4 of the
    reference's, greedy tokens equal (and, with ``ragged``, on a ragged
    batch too)."""
    cfg_r, cfg = chain.cfg_r, chain.cfg
    toks = _tokens(4, 2, 12, cfg.vocab)
    want, aux_r = ref_lm.forward(cfg_r, chain.packed_r, jnp.asarray(toks))
    got, aux = lm.forward(cfg, chain.packed, torch.from_numpy(toks))
    assert got.shape == (2, 12, cfg.vocab)
    assert _rel(got, want) < 1e-4
    assert abs(float(aux) - float(aux_r)) <= 1e-5 * abs(float(aux_r))
    b, s = 3, 6
    toks = _tokens(3, b, s, cfg.vocab)
    step_r = jax.jit(ref_lm.decode_step, static_argnums=0)
    cache_r = ref_lm.init_cache(cfg_r, b, s)
    cache = lm.init_cache(cfg, b, s, device="cpu")
    for t in range(s):
        want, cache_r = step_r(cfg_r, chain.packed_r, cache_r,
                               jnp.asarray(toks[:, t:t + 1]),
                               ref_positions_for(cfg_r, b, 1, offset=t))
        got, cache = lm.decode_step(cfg, chain.packed, cache,
                                    torch.from_numpy(toks[:, t:t + 1]),
                                    common.positions_for(cfg, b, 1,
                                                         offset=t))
        assert _rel(got, want) < 1e-4, t
    prompts = _tokens(5, 3, 8, cfg.vocab)
    want = ref_serve.greedy_decode(cfg_r, chain.packed_r,
                                   jnp.asarray(prompts), 5)
    got = greedy_decode(cfg, chain.packed, prompts, 5, device="cpu")
    assert np.array_equal(got.numpy(), np.asarray(want))
    if ragged:
        lengths = np.array([8, 3, 6], np.int32)
        want = ref_serve.greedy_decode(cfg_r, chain.packed_r,
                                       jnp.asarray(prompts), 5,
                                       lengths=lengths)
        got = greedy_decode(cfg, chain.packed, prompts, 5, lengths=lengths,
                            device="cpu")
        assert np.array_equal(got.numpy(), np.asarray(want))


METHODS = {  # name -> (method, SLaBConfig fields, variant)
    # one alternating step: the reference recompiles its power iteration
    # at every call in eager mode, ~0.3 s a linear and step
    "slab": ("slab", dict(cr=0.5, iters=1), "slab-ell"),
    # f32: ELL wins on bytes below K_max = 2K/3, so CR 0.5 packs as ELL
    "sparsegpt": ("sparsegpt", dict(cr=0.5), "sparse-ell"),
}


@pytest.fixture(scope="module")
def chains(models):
    """Each case's Chain, built at first use: the METHODS, and "binlr",
    slab's decompositions with W_S := 0."""
    cache = {}

    def get(name):
        if name not in cache:
            if name == "binlr":
                cache[name] = Chain(models, "slab", {},
                                    zero_ws_of=get("slab"))
            else:
                method, kw, _ = METHODS[name]
                cache[name] = Chain(models, method, kw)
        return cache[name]
    return get


def _variant(name):
    return "binlr" if name == "binlr" else METHODS[name][2]


@pytest.mark.parametrize("name", list(METHODS))
def test_compress_model_decs_match_reference(chains, name):
    check_decs_match(chains(name))


@pytest.mark.parametrize("name", list(METHODS) + ["binlr"])
def test_pack_model_byte_identical_to_reference(chains, name):
    check_pack_byte_identical(chains(name), _variant(name))


@pytest.mark.parametrize("name", list(METHODS) + ["binlr"])
def test_packed_serving_matches_reference(chains, name):
    check_serving(chains(name), ragged=name == "slab")


def test_deepseek_shared_experts_pack_and_match(chains):
    """The port's own decompositions: routed experts pack on the expert
    axis while the always-on shared MLP packs as plain 2-D linears, zero
    fallback, forward parity with the compressed dense model."""
    c = chains("slab")
    packed, rep = pack_model(c.dense, c.decs, dtype=torch.float32)
    assert rep.fallback == ()
    assert isinstance(packed["layers"][0]["moe"]["w_gate"],
                      ExpertPackedStack)
    assert isinstance(packed["layers"][0]["moe"]["shared"]["w_gate"],
                      PackedLinear)
    assert "moe.shared.w_gate" in rep.paths
    toks = torch.from_numpy(_tokens(6, 2, 8, c.cfg.vocab))
    f_d, _ = lm.forward(c.cfg, c.dense, toks)
    f_p, _ = lm.forward(c.cfg, packed, toks)
    assert _rel(f_p, f_d) < 1e-4


def test_serve_cli_serves_deepseek_packed_on_the_cpu(capsys):
    """``serve --arch deepseek_moe_16b --packed`` on the CPU: attention,
    shared and routed experts all slab-ell, no expert left dense."""
    from repro_torch.launch import serve
    serve.main(["--arch", "deepseek_moe_16b", "--packed", "--device", "cpu",
                "--iters", "1", "--calib-seqs", "2", "--calib-len", "16",
                "--batch", "2", "--prompt-len", "4", "--gen-len", "2"])
    out = capsys.readouterr().out
    assert "packed serving: 62 linears on the kernel path across 10 paths " \
           "[slab-ell=62]" in out
    assert "experts: 6 leaves [slab-ell=48]; dense experts: 0" in out
    assert "sample generation:" in out
