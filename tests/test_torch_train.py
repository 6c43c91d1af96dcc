"""The port's training path against the reference, on the CPU, with the
reference's weights bridged into the port (``bridge.params``) and the
gradients compared through ``bridge.params`` on the reference's stacked
ones:

- AdamW: ``adamw_update`` on a bridged f32 tree (two steps, so the
  moments are not zero) at rel < 1e-6 per leaf; ``cosine_schedule`` over
  steps 0-120; ``global_norm_clip``; bf16 moments at bf16's precision;
- int8 compression: payloads bitwise equal, scales at rel < 1e-7;
- llama2_7b SMOKE at f32: ``loss_fn`` and its gradients against
  ``jax.value_and_grad(repro.models.lm.loss_fn)`` (rel < 1e-5 loss, <
  1e-4 per gradient leaf); ``make_train_fn`` over 5 steps from a bridged
  init, losses at rel < 1e-4 each step; ``microbatches=2`` against 1 at
  rel < 1e-5; every remat policy (``blocks:2`` too) against ``"none"``
  at rel < 1e-6;
- phi3_5_moe SMOKE: one loss (aux included) and its gradients at rel <
  1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import lm as ref_lm
from repro.optim import adamw as ref_adamw
from repro.optim import compress as ref_compress
from repro_torch import bridge, configs
from repro_torch.data import SyntheticCorpus
from repro_torch.models import lm
from repro_torch.optim import adamw, compress
from repro_torch.runtime.step import REMAT_POLICIES, make_train_fn
from repro_torch.tree import leaves_with_path, tree_leaves, tree_map


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _models(arch):
    cfg_r = ref_configs.get(arch, smoke=True).with_(dtype=jnp.float32)
    cfg = configs.get(arch, smoke=True).with_(dtype=torch.float32)
    params_r, _ = ref_lm.init(cfg_r, jax.random.PRNGKey(0))
    return cfg_r, cfg, params_r


def _bridge(cfg, tree):
    return bridge.params(jax.tree.map(np.asarray, tree), cfg.n_layers,
                         device="cpu")


def _hold_trees(got, want, tol, what):
    """Every leaf of ``got`` (port layout) against the bridged ``want``."""
    for (path, a), (_, b) in zip(leaves_with_path(got),
                                 leaves_with_path(want), strict=True):
        if b.numel() and float(b.abs().max()) == 0.0:
            assert float(a.abs().max()) == 0.0, (what, path)
            continue
        assert _rel(a.detach().float(), b.float()) < tol, (what, path)


def _batch(cfg, step=0, b=4, s=32):
    return SyntheticCorpus(cfg.vocab, seed=0).batch(step, b, s)


def _clone(params):
    return tree_map(lambda t: t.detach().clone(), params)


# ------------------------------------------------------------------
# optimizer
# ------------------------------------------------------------------

ACFG = dict(lr=1e-2, warmup_steps=2, total_steps=20)


def test_adamw_update_matches_reference():
    cfg_r, cfg, params_r = _models("llama2_7b")
    rng = np.random.default_rng(1)
    grads_r = [jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(
        p.shape).astype(np.float32) * 0.1), params_r) for _ in range(2)]
    acfg_r = ref_adamw.AdamWConfig(**ACFG)
    acfg = adamw.AdamWConfig(**ACFG)
    p_r, o_r = params_r, ref_adamw.adamw_init(params_r, acfg_r)
    p, o = _bridge(cfg, params_r), None
    o = adamw.adamw_init(p, acfg)
    for g_r in grads_r:
        p_r, o_r, m_r = ref_adamw.adamw_update(g_r, o_r, p_r, acfg_r)
        p, o, m = adamw.adamw_update(_bridge(cfg, g_r), o, p, acfg)
        assert _rel(m["grad_norm"], m_r["grad_norm"]) < 1e-6
        assert _rel(m["lr"], m_r["lr"]) < 1e-6
    assert int(o.count) == int(o_r.count) == 2
    _hold_trees(p, _bridge(cfg, p_r), 1e-6, "params")
    _hold_trees(o.mu, _bridge(cfg, o_r.mu), 1e-6, "mu")
    _hold_trees(o.nu, _bridge(cfg, o_r.nu), 1e-6, "nu")


def test_adamw_updates_in_place():
    """The step writes into the parameters and moments it was given (the
    reference donates them), each at its own dtype."""
    rng = np.random.default_rng(2)
    p = {"w": torch.from_numpy(rng.standard_normal((4, 8)).astype(
        np.float32)), "b": [torch.ones(3, dtype=torch.bfloat16)]}
    before = _clone(p)
    g = tree_map(lambda t: torch.full(t.shape, 0.5, dtype=t.dtype), p)
    acfg = adamw.AdamWConfig(moment_dtype=torch.bfloat16, **ACFG)
    o = adamw.adamw_init(p, acfg)
    got_p, got_o, _ = adamw.adamw_update(g, o, p, acfg)
    assert got_p["w"] is p["w"] and got_p["b"][0] is p["b"][0]
    assert got_o.mu["w"] is o.mu["w"] and got_o.nu["b"][0] is o.nu["b"][0]
    assert p["b"][0].dtype == torch.bfloat16
    assert o.mu["w"].dtype == torch.bfloat16 and int(got_o.count) == 1
    assert not torch.equal(p["w"], before["w"])
    want_mu = 0.1 * 0.5 / (0.5 * 35 ** 0.5)       # (1 - b1) * clipped g
    assert float((o.mu["w"].float() - want_mu).abs().max()) < 1e-4


def test_cosine_schedule_matches_reference():
    acfg_r = ref_adamw.AdamWConfig(lr=1.0, warmup_steps=10,
                                   total_steps=100, min_lr_frac=0.1)
    acfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                             min_lr_frac=0.1)
    steps = np.arange(121)
    want = np.array([float(ref_adamw.cosine_schedule(acfg_r, jnp.asarray(s)))
                     for s in steps])
    got = np.array([float(adamw.cosine_schedule(acfg, torch.tensor(s)))
                    for s in steps])
    assert np.abs(got - want).max() < 1e-6
    assert got[0] == 0.0 and abs(got[100] - 0.1) < 1e-6 and \
        abs(got[120] - 0.1) < 1e-6


def test_global_norm_clip_matches_reference():
    rng = np.random.default_rng(3)
    g = {"a": rng.standard_normal((100,)).astype(np.float32) * 10,
         "b": [rng.standard_normal((7, 3)).astype(np.float32)]}
    want, gn_r = ref_adamw.global_norm_clip(
        jax.tree.map(jnp.asarray, g), 1.0)
    got, gn = adamw.global_norm_clip(tree_map(torch.from_numpy, g), 1.0)
    assert _rel(gn, gn_r) < 1e-6
    assert _rel(got["a"], want["a"]) < 1e-6
    assert _rel(got["b"][0], want["b"][0]) < 1e-6
    assert abs(float(torch.sqrt(sum((t * t).sum() for t in tree_leaves(
        got)))) - 1.0) < 1e-5


def test_bf16_moments_match_reference():
    acfg_r = ref_adamw.AdamWConfig(moment_dtype=jnp.bfloat16, **ACFG)
    acfg = adamw.AdamWConfig(moment_dtype=torch.bfloat16, **ACFG)
    rng = np.random.default_rng(4)
    w = rng.standard_normal((64,)).astype(np.float32)
    p_r, p = {"w": jnp.asarray(w)}, {"w": torch.from_numpy(w.copy())}
    o_r, o = ref_adamw.adamw_init(p_r, acfg_r), adamw.adamw_init(p, acfg)
    assert o.mu["w"].dtype == torch.bfloat16
    for _ in range(3):
        g = rng.standard_normal((64,)).astype(np.float32)
        p_r, o_r, _ = ref_adamw.adamw_update({"w": jnp.asarray(g)}, o_r,
                                             p_r, acfg_r)
        p, o, _ = adamw.adamw_update({"w": torch.from_numpy(g)}, o, p, acfg)
    assert o.mu["w"].dtype == o.nu["w"].dtype == torch.bfloat16
    # one bf16 ulp (2^-8 relative) where the f32 values round apart
    assert _rel(o.mu["w"].float(), o_r.mu["w"].astype(jnp.float32)) < 1e-2
    assert _rel(o.nu["w"].float(), o_r.nu["w"].astype(jnp.float32)) < 1e-2
    assert _rel(p["w"], p_r["w"]) < 1e-4


def test_int8_compression_matches_reference():
    rng = np.random.default_rng(5)
    g = {"a": rng.standard_normal((256,)).astype(np.float32) * 3e-3,
         "b": [rng.standard_normal((17, 9)).astype(np.float32) * 40]}
    # exact halves round to even in both
    g["c"] = np.array([-127, -3.5, -2.5, -0.5, 0.5, 1.5, 2.5, 127],
                      np.float32)          # scale exactly 1
    e = jax.tree.map(lambda a: np.zeros_like(a), g)
    q_r, s_r, e_r = ref_compress.ef_compress_pytree(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e))
    q, s, e2 = compress.ef_compress_pytree(tree_map(torch.from_numpy, g),
                                           tree_map(torch.from_numpy, e))
    for k in ("a", "c"):
        assert torch.equal(q[k], torch.from_numpy(np.array(q_r[k])))
        assert _rel(s[k], s_r[k]) < 1e-7
        assert _rel(e2[k], e_r[k]) < 1e-5
    assert torch.equal(q["b"][0], torch.from_numpy(np.array(q_r["b"][0])))
    back = compress.ef_decompress_pytree(q, s)
    assert _rel(back["a"], ref_compress.ef_decompress_pytree(q_r, s_r)["a"]) \
        < 1e-7
    assert torch.equal(compress.init_error_buffers(q)["a"],
                       torch.zeros(256))
    qq, ss = compress.int8_compress(torch.from_numpy(g["a"]))
    qq_r, ss_r = ref_compress.int8_compress(jnp.asarray(g["a"]))
    assert torch.equal(qq, torch.from_numpy(np.array(qq_r)))
    assert _rel(compress.int8_decompress(qq, ss),
                ref_compress.int8_decompress(qq_r, ss_r)) < 1e-7


# ------------------------------------------------------------------
# loss and gradients
# ------------------------------------------------------------------

def _value_and_grad(cfg, params, batch, policy=None, block=1):
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, parts = lm.loss_fn(cfg, params, batch, policy, block)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    parts = {k: v.detach() for k, v in parts.items()}
    return loss.detach(), parts, dict(zip(
        [p for p, _ in leaves_with_path(params)], grads))


def _ref_value_and_grad(cfg_r, params_r, batch):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: ref_lm.loss_fn(cfg_r, p, b), has_aux=True))
    (loss, parts), grads = fn(params_r, jax.tree.map(jnp.asarray, batch))
    return loss, parts, grads


@pytest.mark.parametrize("arch,tol", [("llama2_7b", 1e-4),
                                      ("phi3_5_moe", 1e-4)])
def test_loss_and_gradients_match_reference(arch, tol):
    cfg_r, cfg, params_r = _models(arch)
    batch = _batch(cfg)
    loss_r, parts_r, grads_r = _ref_value_and_grad(cfg_r, params_r, batch)
    params = _bridge(cfg, params_r)
    loss, parts, grads = _value_and_grad(cfg, params, batch)
    assert _rel(loss, loss_r) < (1e-5 if arch == "llama2_7b" else tol)
    assert _rel(parts["ce"], parts_r["ce"]) < 1e-5
    if cfg.family == "moe":
        assert float(parts["aux"]) > 0
        assert _rel(parts["aux"], parts_r["aux"]) < tol
    want = dict(leaves_with_path(_bridge(cfg, grads_r)))
    assert want.keys() == grads.keys()
    for path, g in grads.items():
        assert _rel(g, want[path]) < tol, path


def _ref_train(cfg_r, params_r, acfg_r, batches):
    from repro.runtime.meshctx import use_mesh
    from repro.runtime.sharding import Planner
    from repro.runtime.step import make_train_fn as ref_make
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with use_mesh(mesh):
        fn = jax.jit(ref_make(cfg_r, acfg_r, Planner(mesh, cfg_r),
                              microbatches=1, remat="none"))
    p, o, losses = params_r, ref_adamw.adamw_init(params_r, acfg_r), []
    for b in batches:
        p, o, m = fn(p, o, jax.tree.map(jnp.asarray, b))
        losses.append(float(m["loss"]))
    return p, losses


def test_train_steps_match_reference():
    cfg_r, cfg, params_r = _models("llama2_7b")
    batches = [_batch(cfg, s) for s in range(5)]
    acfg_r = ref_adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=5)
    acfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=5)
    p_r, want = _ref_train(cfg_r, params_r, acfg_r, batches)
    step = make_train_fn(cfg, acfg, remat="none")
    p, o = _bridge(cfg, params_r), None
    o = adamw.adamw_init(p, acfg)
    got = []
    for b in batches:
        p, o, m = step(p, o, b)
        got.append(float(m["loss"]))
    assert got[-1] < got[0]
    for a, b in zip(got, want):
        assert abs(a - b) / abs(b) < 1e-4, (got, want)
    _hold_trees(p, _bridge(cfg, p_r), 1e-3, "params after 5 steps")


@pytest.fixture(scope="module")
def one_step():
    """One train step of llama2_7b SMOKE (f32, bridged init) per remat
    policy and microbatch count: {(remat, microbatches): (loss, params,
    first moment)}. After one step the first moment is (1 - b1) times
    the clipped gradient, so it holds the gradients; a parameter's
    first AdamW step is ±lr wherever |g| >> eps, and amplifies the last
    bits of a gradient near 0."""
    cfg_r, cfg, params_r = _models("llama2_7b")
    acfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    batch = _batch(cfg, 3)
    out = {}
    for remat, mb in [("none", 1), ("none", 2), ("nothing", 1),
                      ("dots", 1), ("everything", 1), ("blocks:2", 1),
                      ("nothing", 2)]:
        p = _bridge(cfg, params_r)
        p, o, m = make_train_fn(cfg, acfg, microbatches=mb, remat=remat)(
            p, adamw.adamw_init(p, acfg), batch)
        out[(remat, mb)] = (float(m["loss"]), p, o.mu)
    return out


def test_microbatches_match_one_batch(one_step):
    (l1, _, g1), (l2, _, g2) = one_step[("none", 1)], one_step[("none", 2)]
    assert abs(l2 - l1) / abs(l1) < 1e-5
    _hold_trees(g2, g1, 1e-5, "microbatches=2")
    l3, p3, g3 = one_step[("nothing", 2)]
    assert abs(l3 - l2) / abs(l2) < 1e-6
    _hold_trees(g3, g2, 1e-6, "microbatches=2 under remat")
    _hold_trees(p3, one_step[("none", 2)][1], 1e-6, "params")


@pytest.mark.parametrize("remat", ["nothing", "dots", "everything",
                                   "blocks:2"])
def test_remat_policies_match_none(one_step, remat):
    l0, p0, g0 = one_step[("none", 1)]
    l, p, g = one_step[(remat, 1)]
    assert abs(l - l0) / abs(l0) < 1e-6
    _hold_trees(g, g0, 1e-6, remat)
    _hold_trees(p, p0, 1e-6, remat)
    assert set(REMAT_POLICIES) == {"none", "nothing", "dots", "everything"}
