"""The port's ``core.apply``, ``SLaBPacked`` / ``pack_decomposition``,
``ops.slab_linear_kernel`` and the heterogeneous-packing report against
the reference, on decompositions made from a seed with numpy and carried
to both packages (``bridge.decomposition``):

- ``slab_linear`` / ``slab_linear_packed`` / ``to_dense`` at rel < 1e-5:
  ranks 1 and 3, no low-rank part, no binary part, ELL and 2:4 packings;
- ``pack_decomposition``'s planes byte-identical;
- ``slab_linear_kernel`` on the CPU against the reference's in interpret
  mode (as ``tests/test_kernels.py`` runs it) at rel < 1e-5;
- ``segment_runs`` / ``PackReport.segments``, the ``"dense-fallback"``
  bytes and the fallback list of ``pack_model`` equal to
  ``pack_plan_decs``' on the same decompositions (partial coverage, mixed
  N:M patterns, an unservable dec, a MoE leaf with a missing layer and a
  dense expert), and a reference ``PackedStack`` model bridged by
  ``bridge.params`` serving the logits of the port's own packing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import apply as ref_apply
from repro.core import packed_model as ref_pm
from repro.core import packing as ref_packing
from repro.core.plan import CompressionPlan as RefPlan
from repro.core.slab import SLaBDecomposition as RefDec
from repro.kernels import ops as ref_ops
from repro.models import lm as ref_lm
from repro_torch import bridge, configs
from repro_torch.core import apply, packing
from repro_torch.core.packed_model import (PackedLinear, has_hetero,
                                           layer_slice_range, pack_model,
                                           segment_runs)
from repro_torch.kernels import ops
from repro_torch.models import lm


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np_dec(seed, d_out=64, d_in=128, rank=1, keep=0.4, pattern=None,
            binary=True, uniform=True):
    """A decomposition from ``seed``: W_S keeping ``keep`` of each row (or
    a ragged count with ``uniform=False``; n of every m with
    ``pattern``), non-negative rank-``rank`` factors, ±1 signs."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((d_out, d_in)).astype(np.float32) * 0.05
    if pattern is not None:
        n, m = map(int, pattern.split(":"))
        g = np.abs(w).reshape(d_out, d_in // m, m)
        top = np.argsort(-g, axis=-1, kind="stable")[..., :n]
        mask = np.zeros_like(g, bool)
        np.put_along_axis(mask, top, True, axis=-1)
        mask = mask.reshape(d_out, d_in)
    else:
        k = int(keep * d_in)
        counts = (np.full(d_out, k) if uniform
                  else rng.integers(k // 2, k + 1, size=d_out))
        order = np.argsort(-np.abs(w), axis=1, kind="stable")
        mask = np.zeros_like(w, bool)
        for r in range(d_out):
            mask[r, order[r, :counts[r]]] = True
    w_s = np.where(mask, w, 0.0).astype(np.float32)
    u = np.abs(rng.standard_normal((d_out, rank))).astype(np.float32) * 0.1
    v = np.abs(rng.standard_normal((d_in, rank))).astype(np.float32) * 0.1
    w_b = np.where(rng.standard_normal((d_out, d_in)) >= 0, 1,
                   -1).astype(np.int8)
    if not binary:
        w_b = np.zeros((0, 0), np.int8)
    return RefDec(w_s, u, v, w_b)


def _both(dec):
    ref = RefDec(*(None if a is None else jnp.asarray(a) for a in dec))
    return ref, bridge.decomposition(dec, device="cpu")


CASES = {
    "rank1": dict(rank=1),
    "rank3": dict(rank=3),
    "no-lowrank": dict(rank=0),
    "no-binary": dict(rank=2, binary=False),
    "ragged-rows": dict(rank=1, uniform=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_slab_linear_and_to_dense_match_reference(case):
    ref_dec, dec = _both(_np_dec(1, **CASES[case]))
    x = np.random.default_rng(2).standard_normal((5, 128)).astype(np.float32)
    want = ref_apply.slab_linear(jnp.asarray(x), ref_dec)
    got = apply.slab_linear(torch.from_numpy(x), dec)
    assert _rel(got, want) < 1e-5
    want_d = ref_apply.to_dense(ref_dec, jnp.float32)
    got_d = apply.to_dense(dec, torch.float32)
    assert _rel(got_d, want_d) < 1e-6


def _same_plane(got: torch.Tensor, want) -> None:
    want = bridge.tensor(np.asarray(want), device="cpu")
    assert got.dtype == want.dtype and tuple(got.shape) == tuple(want.shape)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case,pattern", [("rank1", None), ("rank3", None),
                                          ("ragged-rows", None),
                                          ("rank1", "2:4"),
                                          ("rank3", "2:4")])
def test_pack_decomposition_planes_byte_identical(case, pattern):
    kw = dict(CASES[case])
    if pattern:
        kw.update(pattern=pattern)
    ref_dec, dec = _both(_np_dec(3, **kw))
    want = ref_packing.pack_decomposition(ref_dec, pattern)
    got = packing.pack_decomposition(dec, pattern)
    assert (got.d_out, got.d_in) == (want.d_out, want.d_in)
    kind = type(want.sparse).__name__
    if kind == "NMPacked":
        assert isinstance(got.sparse, packing.NMPacked)
        _same_plane(got.sparse.values, want.sparse.values)
        _same_plane(got.sparse.indices, want.sparse.indices)
        assert packing.nm_packed_bits(got.sparse) == \
            ref_packing.nm_packed_bits(want.sparse)
    elif kind == "ELLPacked":
        assert isinstance(got.sparse, packing.ELLPacked)
        _same_plane(got.sparse.values, want.sparse.values)
        _same_plane(got.sparse.indices, want.sparse.indices)
    else:
        assert case == "ragged-rows"             # dense-masked W_S
        _same_plane(got.sparse, want.sparse)
    for f in ("u", "v", "b_packed"):
        _same_plane(getattr(got, f), getattr(want, f))
    if got.u.dim() == 1:        # slab_linear_packed serves rank 1 (both)
        x = np.random.default_rng(4).standard_normal((3, 128)).astype(
            np.float32)
        assert _rel(apply.slab_linear_packed(torch.from_numpy(x), got),
                    ref_apply.slab_linear_packed(jnp.asarray(x), want)) \
            < 1e-5


@pytest.mark.parametrize("pattern,ragged", [(None, False), (None, True),
                                            ("2:4", False)])
def test_slab_linear_kernel_matches_reference_interpret(pattern, ragged):
    """#2 for an N:M bundle, #3 for an ELL or dense one, through the
    wrappers' plain versions on the CPU, against the reference's Pallas
    kernels in interpret mode."""
    kw = dict(rank=1, uniform=not ragged, d_out=128, d_in=256)
    if pattern:
        kw.update(pattern=pattern)
    ref_dec, dec = _both(_np_dec(5, **kw))
    x = np.random.default_rng(6).standard_normal((64, 256)).astype(
        np.float32)
    want = ref_ops.slab_linear_kernel(
        jnp.asarray(x), ref_packing.pack_decomposition(ref_dec, pattern),
        bm=32, bn=64, bk=64, interpret=True)
    ops.reset_launch_counts()
    got = ops.slab_linear_kernel(torch.from_numpy(x),
                                 packing.pack_decomposition(dec, pattern))
    assert _rel(got, want) < 1e-5
    assert _rel(got, x @ np.asarray(ref_apply.to_dense(
        ref_dec, jnp.float32)).T) < 1e-5
    assert not any(ops.launch_counts().values())    # the CPU path


# ------------------------------------------------------------------
# heterogeneous packing: segments and dense-fallback accounting
# ------------------------------------------------------------------

def _ref_cfg(arch, **kw):
    return ref_configs.get(arch, smoke=True).with_(dtype=jnp.float32, **kw)


def _pruned_decs(cfg_r, params_r, keep_of, pattern_of, skip=(),
                 slab_paths=(), unservable=()):
    """Magnitude-pruned decompositions of the reference params' 2-D
    linears, per (layer, path): ``keep_of(l)`` (or the N:M pattern of
    ``pattern_of(l, path)``), the ±1 ⊙ rank-1 term on ``slab_paths``,
    none on ``skip``, no sparse plane on ``unservable``. Returns the
    decs and the dense-equivalent reference params."""
    from repro.core.pipeline import _get, _set, linear_paths
    dense = jax.tree.map(lambda a: a, params_r)
    decs = {}
    rng = np.random.default_rng(11)
    for name in linear_paths(cfg_r):
        leaf = np.asarray(_get(params_r["layers"], name))
        if leaf.ndim != 3:
            continue
        new = []
        for l in range(cfg_r.n_layers):
            w = leaf[l].T
            if (l, name) in skip:
                new.append(leaf[l])
                continue
            pat = pattern_of(l, name)
            d = _np_dec(int(rng.integers(1 << 30)), *w.shape,
                        rank=1 if name in slab_paths else 0,
                        keep=keep_of(l), pattern=pat,
                        binary=name in slab_paths)
            w_s = np.where(d.w_s != 0, w, 0.0).astype(np.float32)
            d = d._replace(w_s=w_s)
            if (l, name) in unservable:
                decs[(l, name)] = d._replace(w_s=None)
                new.append(leaf[l])
                continue
            decs[(l, name)] = d
            w_hat = w_s + (d.u @ d.v.T) * d.w_b if d.w_b.size else w_s
            new.append(w_hat.T.astype(np.float32))
        _set(dense["layers"], name, jnp.asarray(np.stack(new)))
    return decs, dense


def _ref_decs(decs):
    return {k: RefDec(*(None if a is None else jnp.asarray(a) for a in d))
            for k, d in decs.items()}


def _port(cfg, dense_r, decs, plan):
    params = bridge.params(jax.tree.map(np.asarray, dense_r), cfg.n_layers,
                           device="cpu")
    pdecs = {k: bridge.decomposition(d, device="cpu")
             for k, d in decs.items()}
    return pack_model(params, pdecs, plan=plan)


HETERO_PLAN = ("0/attn.wk=wanda@pattern=2:4; attn.wk=wanda@pattern=4:8; "
               "*=wanda")


@pytest.fixture(scope="module")
def hetero():
    """stablelm_12b SMOKE at 4 layers: L0/attn.wq skipped (a partial
    path), attn.wk 2:4 at L0 and 4:8 after, layers 0-1 kept at 0.25 and
    2-3 at 0.5 (ELL pad widths differ), the MLP's w_gate / w_up with the
    ±1 term (slab-ell), L3/mlp.w_down with no sparse plane (unservable)."""
    cfg_r = _ref_cfg("stablelm_12b", n_layers=4)
    cfg = configs.get("stablelm_12b", smoke=True).with_(
        dtype=torch.float32, n_layers=4)
    params_r, _ = ref_lm.init(cfg_r, jax.random.PRNGKey(0))
    decs, dense_r = _pruned_decs(
        cfg_r, params_r, lambda l: 0.25 if l < 2 else 0.5,
        lambda l, p: ("2:4" if l == 0 else "4:8") if p == "attn.wk"
        else None,
        skip={(0, "attn.wq")}, slab_paths=("mlp.w_gate", "mlp.w_up"),
        unservable={(3, "mlp.w_down")})
    packed_r, rep_r = ref_pm.pack_plan_decs(
        dense_r, _ref_decs(decs), cfg_r.n_layers, RefPlan.parse(HETERO_PLAN))
    packed, rep = _port(cfg, dense_r, decs, HETERO_PLAN)
    return cfg_r, cfg, dense_r, packed_r, rep_r, packed, rep


def _hold_report(rep, rep_r, n_layers):
    assert rep.n_packed == rep_r.n_packed
    assert rep.by_variant == rep_r.by_variant
    assert rep.paths == rep_r.paths
    assert list(rep.fallback) == list(rep_r.fallback)
    assert [tuple(s) for s in rep.segments] == \
        [(s.lo, s.hi, s.sig) for s in rep_r.segments]
    assert rep.bytes_by_variant.keys() == dict(rep_r.bytes_by_variant).keys()
    for var, (pb, db) in rep_r.bytes_by_variant.items():
        assert rep.bytes_by_variant[var] == pytest.approx((pb, db),
                                                          rel=1e-12), var


def test_partial_coverage_and_mixed_patterns_report(hetero):
    cfg_r, cfg, _, packed_r, rep_r, packed, rep = hetero
    _hold_report(rep, rep_r, cfg.n_layers)
    assert rep.fallback == ((3, "mlp.w_down"),)
    assert "dense-fallback" in rep.bytes_by_variant
    assert rep.by_variant["sparse-nm"] == 4      # 2:4 at L0, 4:8 at L1-3
    wq = packed["layers"][0]["attn"]["wq"]
    assert not isinstance(wq, PackedLinear)               # dense
    assert packed["layers"][1]["attn"]["wq"].variant == "sparse-ell"
    assert {packed["layers"][l]["attn"]["wk"].m_pat
            for l in range(4)} == {4, 8}
    assert packed["layers"][0]["mlp"]["w_up"].variant == "slab-ell"


def test_segment_runs_boundaries(hetero):
    """Layer 0 (wq dense, wk 2:4), layers 1 (wk 4:8 at keep 0.25), 2
    (keep 0.5), 3 (w_down dense): the reference's scan segments."""
    cfg_r, cfg, _, packed_r, rep_r, packed, rep = hetero
    want = ref_pm.segment_runs(packed_r["layers"], cfg.n_layers)
    assert segment_runs(packed["layers"], cfg.n_layers) == want
    assert want == ((0, 1), (1, 2), (2, 3), (3, 4))
    assert has_hetero(packed["layers"])
    assert ref_pm.has_hetero(packed_r["layers"])
    assert dict(rep.segments[0].sig)["attn.wq"] == "dense"
    assert dict(rep.segments[1].sig)["attn.wq"].startswith("sparse-ell")
    sub = layer_slice_range(packed["layers"], 1, 3)
    assert len(sub) == 2 and sub[0] is packed["layers"][1]


def test_segment_runs_homogeneous_is_one_run():
    cfg_r = _ref_cfg("stablelm_12b", n_layers=3)
    cfg = configs.get("stablelm_12b", smoke=True).with_(
        dtype=torch.float32, n_layers=3)
    params_r, _ = ref_lm.init(cfg_r, jax.random.PRNGKey(1))
    decs, dense_r = _pruned_decs(cfg_r, params_r, lambda l: 0.5,
                                 lambda l, p: None)
    packed_r, rep_r = ref_pm.pack_plan_decs(
        dense_r, _ref_decs(decs), 3, RefPlan.parse("*=wanda"))
    packed, rep = _port(cfg, dense_r, decs, "*=wanda")
    _hold_report(rep, rep_r, 3)
    assert segment_runs(packed["layers"], 3) == ((0, 3),)
    assert len(rep.segments) == 1 and not has_hetero(packed["layers"])


def test_bridged_packed_stack_serves_the_ports_logits(hetero):
    """``bridge.params`` unstacks the reference's PackedStack leaves (and
    its stacked PackedLinears) into the port's per-layer leaves: the
    planes equal the port's own packing, and so do the logits."""
    cfg_r, cfg, _, packed_r, _, packed, _ = hetero
    assert isinstance(packed_r["layers"]["attn"]["wq"], ref_pm.PackedStack)
    bridged = bridge.params(packed_r, cfg.n_layers, device="cpu")
    for l in range(cfg.n_layers):
        for part, leaf in (("attn", "wq"), ("attn", "wk"), ("mlp", "w_up"),
                           ("mlp", "w_down")):
            a = bridged["layers"][l][part][leaf]
            b = packed["layers"][l][part][leaf]
            assert type(a) is type(b), (l, part, leaf)
            if isinstance(a, PackedLinear):
                assert a.variant == b.variant
                assert torch.equal(a.sparse_vals, b.sparse_vals)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32))
    got, _ = lm.forward(cfg, bridged, toks)
    want, _ = lm.forward(cfg, packed, toks)
    assert _rel(got, want) < 1e-4


def test_moe_missing_layer_and_dense_expert_report():
    """phi3_5_moe SMOKE: expert decs of moe.w_up at layer 0 only, expert 1
    without a sparse plane; attention decs at both layers. The expert
    path's missing layer and the dense expert count under
    "dense-fallback" as in the reference, and the bridged PackedStack of
    expert stacks serves the port's logits."""
    cfg_r = _ref_cfg("phi3_5_moe")
    cfg = configs.get("phi3_5_moe", smoke=True).with_(dtype=torch.float32)
    params_r, _ = ref_lm.init(cfg_r, jax.random.PRNGKey(2))
    decs, dense_r = _pruned_decs(cfg_r, params_r, lambda l: 0.4,
                                 lambda l, p: None)
    w_up = np.asarray(dense_r["layers"]["moe"]["w_up"])
    e_decs = []
    for e in range(cfg.n_experts):
        w = w_up[0, e].T
        d = _np_dec(20 + e, *w.shape, rank=0, keep=0.3, binary=False)
        d = d._replace(w_s=np.where(d.w_s != 0, w, 0.0).astype(np.float32))
        e_decs.append(d._replace(w_s=None) if e == 1 else d)
    new = w_up.copy()
    for e, d in enumerate(e_decs):
        if d.w_s is not None:
            new[0, e] = d.w_s.T
    dense_r["layers"]["moe"]["w_up"] = jnp.asarray(new)
    decs[(0, "moe.w_up")] = tuple(e_decs)
    ref_decs = _ref_decs({k: v for k, v in decs.items()
                          if type(v) is not tuple})
    ref_decs[(0, "moe.w_up")] = tuple(
        RefDec(*(None if a is None else jnp.asarray(a) for a in d))
        for d in e_decs)
    packed_r, rep_r = ref_pm.pack_plan_decs(
        dense_r, ref_decs, cfg.n_layers, RefPlan.parse("*=wanda"))
    params = bridge.params(jax.tree.map(np.asarray, dense_r), cfg.n_layers,
                           device="cpu")
    pdecs = {k: (tuple(bridge.decomposition(d, device="cpu") for d in v)
                 if type(v) is tuple else bridge.decomposition(v,
                                                               device="cpu"))
             for k, v in decs.items()}
    packed, rep = pack_model(params, pdecs, plan="*=wanda")
    _hold_report(rep, rep_r, cfg.n_layers)
    assert (0, "moe.w_up[expert 1]") in rep.fallback
    assert isinstance(packed_r["layers"]["moe"]["w_up"], ref_pm.PackedStack)
    bridged = bridge.params(packed_r, cfg.n_layers, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32))
    assert _rel(lm.forward(cfg, bridged, toks)[0],
                lm.forward(cfg, packed, toks)[0]) < 1e-4
