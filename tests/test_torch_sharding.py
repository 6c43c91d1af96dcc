"""The port's sharding planner and placement against the reference, with
no processes:

- ``Planner.spec`` equals the reference's for every leaf of every
  config's params (full-width shapes) and KV caches, on meshes (1, 2),
  (2, 4), (1, 16) and (pod 2, 16, 16) (the reference's Planner reads only
  ``axis_names`` and ``shape`` of its mesh);
- ``packed_axes`` of the 11 packed variants (ranks 1 and 8) and of an
  expert stack, and ``merge_packed_axes`` of a packed model, equal the
  reference's on bridged leaves (the reference's "layers" lead dropped:
  the port keeps one leaf per layer);
- ``kv_cache_axes`` / ``paged_cache_axes`` / ``mamba_cache_axes`` equal
  the reference's;
- every rank's ``tree_shard`` of a packed model, assembled, gives each
  leaf back bit for bit;
- an uncompressed model placed by its specs: dense leaves cut over
  "model" and "data" as the specs say, assembled back bit for bit.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import packed_model as ref_pm
from repro.core.slab import SLaBDecomposition as RefDec
from repro.models import attention as ref_attn
from repro.models import lm as ref_lm
from repro.models import mamba2 as ref_mamba
from repro.runtime.sharding import Planner as RefPlanner
from repro.serving import paged_cache as ref_paged
from repro_torch import bridge, configs
from repro_torch.core import packed_model as pm
from repro_torch.core.pipeline import compress_model
from repro_torch.core.slab import SLaBConfig
from repro_torch.data import calibration_batch
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.models import mamba2
from repro_torch.runtime.meshctx import Shard
from repro_torch.runtime.mesh import Mesh, make_test_mesh
from repro_torch.runtime.sharding import (Planner, _entry_axes, _map,
                                          is_axes_leaf, tree_shard)
from repro_torch.serving import paged_cache

ARCHS = list(ref_configs.ARCH_IDS) + ["llama2_7b"]
MESHES = {"1x2": (1, 2, 0), "2x4": (2, 4, 0), "1x16": (1, 16, 0),
          "pod2x16x16": (16, 16, 2)}


def _ref_mesh(data, model, pod):
    shape = ({"pod": pod} if pod else {}) | {"data": data, "model": model}
    return types.SimpleNamespace(axis_names=tuple(shape), shape=shape)


def _axes_leaves(axes, shapes, prefix=()):
    """{path: (axes tuple, shape)} over an axes tree and a matching tree
    of shaped leaves."""
    if is_axes_leaf(axes):
        return {prefix: (axes, tuple(shapes.shape))}
    if isinstance(axes, dict):
        out = {}
        for k in axes:
            out |= _axes_leaves(axes[k], shapes[k], prefix + (k,))
        return out
    raise TypeError(type(axes))


@functools.lru_cache(maxsize=None)
def _ref_param_leaves(arch):
    """The reference's (axes, shape) per path, "layers" lead dropped."""
    cfg = ref_configs.get(arch)
    shapes, axes = ref_lm.abstract_params(cfg)
    out = {}
    for path, (ax, shp) in _axes_leaves(axes, shapes).items():
        if path[0] == "layers":
            assert ax[0] == "layers" and shp[0] == cfg.n_layers
            ax, shp = ax[1:], shp[1:]
        out[path] = (ax, shp)
    return out


def _port_param_leaves(arch):
    cfg = configs.get(arch)
    axes, params = lm.param_axes(cfg), lm.abstract_params(cfg)
    out = {}
    for k in axes:
        if k == "layers":
            assert len(axes[k]) == len(params[k]) == cfg.n_layers
            for path, v in _axes_leaves(axes[k][0], params[k][0]).items():
                out[("layers",) + path] = v
        else:
            out |= _axes_leaves(axes[k], params[k], (k,))
    return out


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_planner_specs_equal_reference(arch, mesh):
    data, model, pod = MESHES[mesh]
    ref = _ref_param_leaves(arch)
    got = _port_param_leaves(arch)
    assert got.keys() == ref.keys()
    cfg_r, cfg = ref_configs.get(arch), configs.get(arch)
    rp = RefPlanner(_ref_mesh(data, model, pod), cfg_r)
    pp = Planner(make_test_mesh(data, model, pod), cfg)
    n_sharded = 0
    for path, (ax, shp) in got.items():
        rax, rshp = ref[path]
        assert (ax, shp) == (rax, rshp), path
        lead = ("layers",) if path[0] == "layers" else ()
        want = tuple(rp.spec(lead + ax, (cfg.n_layers,) * len(lead) + shp))
        assert pp.spec(ax, shp) == want[len(lead):], path
        n_sharded += any(want)
    assert n_sharded
    assert pp.batch_axes() == tuple(rp.batch_axes())
    for b in (1, 8, 12, 32):
        assert pp.act_spec("batch", None, shape=(b, 16)) == tuple(
            rp.act_spec("batch", None, shape=(b, 16)))
    # the caches: contiguous (B 8, S 4096) and paged (512 blocks of 16)
    if cfg.family in ("ssm", "hybrid"):
        mc = mamba2.mamba_cache_axes()
        rmc = ref_mamba.mamba_cache_axes()
        shapes = ((8, cfg.ssm_conv - 1, cfg.d_inner),
                  (8, cfg.ssm_conv - 1, cfg.ssm_state),
                  (8, cfg.ssm_conv - 1, cfg.ssm_state),
                  (8, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state))
        for a, ra, shp in zip(mc, rmc, shapes):
            assert pp.spec(a, shp) == tuple(rp.spec(ra, shp))
    if cfg.family not in ("ssm", "audio"):
        kv = attn.kv_cache_axes(cfg)
        shp = (8, 4096, cfg.n_kv, cfg.d_head)
        assert pp.spec(kv.k, shp) == tuple(rp.spec(
            ref_attn.kv_cache_axes(cfg_r).k, shp))
    if cfg.family not in ("ssm", "hybrid", "audio"):
        pg = paged_cache.paged_cache_axes(cfg).k
        shp = (512, 16, cfg.n_kv, cfg.d_head)
        want = tuple(rp.spec(ref_paged.paged_cache_axes(cfg_r).k,
                             (cfg.n_layers,) + shp))
        assert pp.spec(pg, shp) == want[1:]


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("arch", ["stablelm_12b", "zamba2_7b"])
def test_cache_axes_equal_reference(arch, kv_quant):
    cfg = configs.get(arch).with_(kv_quant=kv_quant)
    cfg_r = ref_configs.get(arch).with_(kv_quant=kv_quant)

    def strip(t):
        return None if t is None else tuple(t)

    kv, rkv = attn.kv_cache_axes(cfg), ref_attn.kv_cache_axes(cfg_r)
    assert tuple(kv)[:5] == tuple(rkv) and kv.seq_lo is None
    assert tuple(mamba2.mamba_cache_axes()) == tuple(
        ref_mamba.mamba_cache_axes())
    if cfg.family == "dense":
        pg = paged_cache.paged_cache_axes(cfg)
        rpg = ref_paged.paged_cache_axes(cfg_r)
        for a, ra in zip(pg, rpg):
            assert strip(a) == (None if ra is None else tuple(ra)[1:])
        assert lm.cache_axes(cfg) == [kv] * cfg.n_layers
    else:
        ca, rca = lm.cache_axes(cfg), ref_lm.cache_axes(cfg_r)
        assert len(ca.mamba) == cfg.n_layers
        assert tuple(ca.mamba[0]) == tuple(
            jax.tree.map(lambda ax: tuple(ax)[1:], rca.mamba,
                         is_leaf=lambda x: isinstance(x, tuple)
                         and all(isinstance(a, (str, type(None)))
                                 for a in x)))
        assert len(ca.shared_kv) == lm.n_shared_invocations(cfg)


# ------------------------------------------------------- packed leaves

N, K = 64, 128


def _dec(kind, rank, seed=0):
    """A reference decomposition of ``kind`` ("<sparse>-<terms>") with a
    rank-``rank`` factor: (dec, pattern)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((N, K)) * 0.1).astype(np.float32)
    u = rng.standard_normal((N, rank)).astype(np.float32) * 0.2
    v = rng.standard_normal((K, rank)).astype(np.float32) * 0.2
    w_b = np.where(rng.random((N, K)) < 0.5, 1, -1).astype(np.int8)
    sparse, terms = kind.split("-") if "-" in kind else ("", kind)
    keep = np.zeros_like(w, bool)
    if sparse == "nm":
        grp = np.abs(w).reshape(N, K // 4, 4).argsort(-1) >= 2
        keep = grp.reshape(N, K)
    elif sparse:
        q = {"ell": 0.7, "dense": 0.2}[sparse]
        keep = np.abs(w) > np.quantile(np.abs(w), q, axis=1, keepdims=True)
    w_s = np.where(keep, w, 0).astype(np.float32)
    none_u = np.zeros((N, 0), np.float32)
    none_v = np.zeros((K, 0), np.float32)
    none_b = np.zeros((0, 0), np.int8)
    uu, vv, bb = {"slab": (u, v, w_b), "binlr": (u, v, w_b),
                  "lowrank": (u, v, none_b),
                  "sparse": (none_u, none_v, none_b)}[terms]
    dec = RefDec(jnp.asarray(w_s), jnp.asarray(uu), jnp.asarray(vv),
                 jnp.asarray(bb))
    return dec, "2:4" if sparse == "nm" else None


KINDS = ["ell-slab", "nm-slab", "dense-slab", "binlr", "ell-lowrank",
         "nm-lowrank", "dense-lowrank", "lowrank", "ell-sparse", "nm-sparse",
         "dense-sparse"]


def _ref_axes_tuple(pl):
    return tuple(None if a is None else tuple(a) for a in
                 (pl.sparse_vals, pl.sparse_idx, pl.b_packed, pl.u, pl.v))


def _port_axes_tuple(pl):
    return (pl.sparse_vals, pl.sparse_idx, pl.b_packed, pl.u, pl.v)


@pytest.mark.parametrize("rank", [1, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_packed_axes_equal_reference(kind, rank):
    dec, pattern = _dec(kind, rank)
    pl_r = ref_pm.pack_linear(dec, pattern, jnp.float32)
    pl = bridge.packed_linear(pl_r, device="cpu")
    ax, ax_r = pm.packed_axes(pl), ref_pm.packed_axes(pl_r)
    assert _port_axes_tuple(ax) == _ref_axes_tuple(ax_r)
    assert (ax.variant, ax.m_pat, ax.d_in, ax.d_out, ax.rank) == (
        pl.variant, pl.m_pat, pl.d_in, pl.d_out, pl.rank)
    if pl.u is not None and "sparse" not in kind:
        assert (ax.u[0] == "packed_out") == (rank >= pm.LR_SHARD_RANK)


def test_all_eleven_variants_have_axes():
    seen = {ref_pm.pack_linear(*_dec(k, 1), jnp.float32).variant
            for k in KINDS}
    assert seen == set(pm.VARIANTS)


@pytest.mark.parametrize("rank", [1, 8])
def test_expert_stack_axes_equal_reference(rank):
    """Experts of two sparsities (two ELL buckets) and one left dense."""
    e_decs = [_dec("ell-slab", rank, seed=e)[0] for e in range(5)]
    e_decs[3] = _dec("dense-slab", rank, seed=3)[0]
    e_decs[4] = RefDec(None, None, None, None)
    old = jnp.asarray(np.random.default_rng(0).standard_normal(
        (5, K, N)).astype(np.float32))
    eps_r = ref_pm.pack_expert_stack(old, tuple(e_decs), None, jnp.float32)
    eps = bridge.expert_packed_stack(eps_r, device="cpu")
    ax, ax_r = pm.packed_axes(eps), ref_pm.packed_axes(eps_r)
    assert len(ax.groups) == len(ax_r.groups) >= 2
    for g, g_r in zip(ax.groups, ax_r.groups):
        assert _port_axes_tuple(g) == _ref_axes_tuple(g_r)
    assert ax.dense == tuple(ax_r.dense) == ("experts", None, "packed_out")
    assert (ax.members, ax.dense_members) == (eps.members,
                                              eps.dense_members)


def test_merge_packed_axes_equals_reference():
    from benchmarks.common import synthetic_pruned_packed
    cfg_r = ref_configs.get("stablelm_12b", smoke=True).with_(
        dtype=jnp.float32)
    cfg = configs.get("stablelm_12b", smoke=True).with_(dtype=torch.float32)
    _, packed_r, _ = synthetic_pruned_packed(cfg_r, lambda l: 0.5,
                                             skip={(0, "attn.wq")})
    ax_r = ref_pm.merge_packed_axes(ref_lm.param_axes(cfg_r), packed_r)
    packed = bridge.params(jax.tree.map(np.asarray, packed_r),
                           cfg.n_layers, device="cpu")
    ax = pm.merge_packed_axes(lm.param_axes(cfg), packed)
    n_packed = 0
    for l, lp in enumerate(ax["layers"]):
        for sub in ("attn", "mlp"):
            for name, a in lp[sub].items():
                leaf = packed["layers"][l][sub][name]
                ra = ax_r["layers"][sub][name]
                if isinstance(leaf, pm.PackedLinear):
                    n_packed += 1
                    ra = ra.groups[0] if hasattr(ra, "groups") else ra
                    want = tuple(None if x is None else tuple(x)[1:]
                                 for x in _ref_axes_tuple(ra))
                    assert _port_axes_tuple(a) == want, (l, name)
                else:
                    assert a == ("embed", "heads") and (l, name) == (
                        0, "wq")
    assert n_packed == 13
    assert ax["final_norm"] == tuple(ax_r["final_norm"])


# ------------------------------------------------------- placement

@functools.lru_cache(maxsize=None)
def _packed_port_model(arch):
    """A port model compressed under a mixed plan and packed (f32)."""
    cfg = configs.get(arch, smoke=True).with_(dtype=torch.float32)
    params = lm.init(cfg, seed=0, device="cpu")
    plan = ("attn.wo=wanda; attn.wq=sparsegpt@pattern=2:4; "
            "mlp.w_gate=hassle@rank=8; *=slab")
    calib = calibration_batch(cfg.vocab, seed=0, n_seq=2, seq_len=16)
    dense, _, decs = compress_model(
        cfg, params, calib, plan=plan, scfg=SLaBConfig(iters=1),
        keep_decompositions=True, device="cpu")
    packed, rep = pm.pack_model(dense, decs, plan=plan, dtype=torch.float32)
    return cfg, packed, rep


def _leaves(tree):
    """Every tensor of a params tree, packed planes and dense remainders
    included, in a fixed order."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        elif isinstance(t, pm.PackedLinear):
            for f in ("sparse_vals", "sparse_idx", "b_packed", "u", "v"):
                if getattr(t, f) is not None:
                    out.append((path + (f,), getattr(t, f)))
        elif isinstance(t, pm.ExpertPackedStack):
            for i, g in enumerate(t.groups):
                walk(g, path + (i,))
            if t.dense is not None:
                walk(t.dense, path + ("dense",))
        elif isinstance(t, Shard):
            out.append((path, t))
        elif isinstance(t, torch.Tensor):
            out.append((path, t))
    walk(tree, ())
    return out


def _assemble(trees, specs, mesh):
    """The whole tree from every rank's shards, ``trees[r]`` rank r's (in
    ``mesh``'s rank order), with no process group."""
    def put(spec, *parts, plane):
        parts = [p.local if isinstance(p, Shard) else p for p in parts]
        shape = list(parts[0].shape)
        for d, entry in enumerate(spec):
            shape[d] *= mesh.n(_entry_axes(entry))
        out = parts[0].new_empty(shape)
        for r, p in enumerate(parts):
            at = Mesh(mesh.shape, r)
            view = out
            for d, entry in enumerate(spec):
                axes = _entry_axes(entry)
                if mesh.n(axes) > 1:
                    view = view.narrow(d, at.index(axes) * p.shape[d],
                                       p.shape[d])
            view.copy_(p)
        return out
    return _map(put, specs, trees[0], *trees[1:])


@pytest.mark.parametrize("mesh", ["1x2", "2x4"])
@pytest.mark.parametrize("arch", ["stablelm_12b", "deepseek_moe_16b"])
def test_dense_leaves_placed_by_their_specs(arch, mesh):
    """An uncompressed model (every linear dense) placed by
    ``tree_specs``: each dense leaf cut on every dim its spec names, over
    "model" on heads / kv / ffn / experts dims as well as on a vocab
    dim, and every rank's shards assembled give the tree back bit for
    bit."""
    data, model = map(int, mesh.split("x"))
    cfg = configs.get(arch, smoke=True).with_(dtype=torch.float32)
    planner = Planner(make_test_mesh(data, model), cfg)
    params, axes = lm.init(cfg, seed=0, device="cpu"), lm.param_axes(cfg)
    specs = planner.tree_specs(axes, params)
    shards = [tree_shard(params, specs, make_test_mesh(data, model, rank=r))
              for r in range(data * model)]
    seen = {"model": 0, "vocab": 0, "data": 0}

    def held(ax, t, spec, local, plane):
        n = 1
        for name, e in zip(ax, spec):
            axes_e = () if e is None else (e if isinstance(e, tuple)
                                           else (e,))
            n *= int(np.prod([planner.mesh.shape[a] for a in axes_e]))
            if "model" in axes_e:
                seen["vocab" if name == "vocab" else "model"] += 1
            elif axes_e:
                seen["data"] += 1
        got = local.local if isinstance(local, Shard) else local
        assert got.numel() * n == t.numel()
        return t
    _map(held, axes, params, specs, shards[-1])
    assert seen["model"] and seen["vocab"] and seen["data"]
    back = _assemble(shards, specs, make_test_mesh(data, model))
    for (path, a), (_, b) in zip(_leaves(params), _leaves(back),
                                 strict=True):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("mesh", ["1x2", "2x1", "2x2", "2x4"])
@pytest.mark.parametrize("arch", ["stablelm_12b", "phi3_5_moe",
                                  "deepseek_moe_16b", "qwen2_vl_2b"])
def test_tree_shard_then_assemble_is_bitwise(arch, mesh):
    data, model = map(int, mesh.split("x"))
    cfg, packed, rep = _packed_port_model(arch)
    assert rep.n_packed
    axes = pm.merge_packed_axes(lm.param_axes(cfg), packed)
    planner = Planner(make_test_mesh(data, model), cfg)
    specs = planner.tree_specs(axes, packed)
    shards = [tree_shard(packed, specs, make_test_mesh(data, model, rank=r))
              for r in range(data * model)]
    back = _assemble(shards, specs, make_test_mesh(data, model))
    want, got = _leaves(packed), _leaves(back)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, a), (_, b) in zip(want, got):
        assert isinstance(b, torch.Tensor), path
        assert a.dtype == b.dtype and torch.equal(a, b), path
    # the local shards: dense leaves wrapped, packed planes plain and cut
    n_dense = n_rows = 0
    for path, leaf in _leaves(shards[-1]):
        if isinstance(leaf, Shard):
            n_dense += 1
            assert leaf.local.numel() < int(np.prod(leaf.shape))
    for lp, lp0 in zip(shards[-1]["layers"], packed["layers"]):
        for sub in ("attn", "mlp"):
            for name, w in lp.get(sub, {}).items():
                if isinstance(w, pm.PackedLinear) and w.sparse_vals is not None:
                    rows = w.sparse_vals.shape[0]
                    n_rows += rows < w.d_out
                    assert rows * (model if w.d_out % model == 0 else 1) \
                        == w.d_out
    if data > 1:
        assert n_dense          # the norms and tables over "data"
    if model > 1:
        assert n_rows or arch in ("phi3_5_moe", "deepseek_moe_16b")
