"""The port's grouped-expert layer against the reference on identical
numpy inputs, on the CPU:

- the plain versions of the nine grouped kernels (#12 ell_matmul_g, #13
  ell_lr_matmul_g, #14 slab_ell_matmul_g, #15 nm_matmul_g, #16
  slab_matmul_g, #17 slab_nm_matmul_g, #18 slab_lr_matmul_g, #19
  slab_nm_lr_matmul_g, #20 binlr_matmul_g) against the reference's
  ``ops.*_g`` run in interpret mode, f32 at rel < 1e-5;
- ``pack_expert_stack`` byte-identical to the reference's (groups in the
  same order, members, dense members, every plane), and the reference's
  own bucketing / dense-member / fast-path cases;
- ``pack_model`` on tuple decs: experts counted per variant, dense
  experts named;
- ``expert_matmul`` for the variants of #12, #13 and #18-#20: equal to
  each expert's own per-linear ``packed_matmul`` and to the reference's
  ``expert_matmul`` on the same decompositions;
- ``bridge`` converters default to the card (and raise without one).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packed_model as ref_pm
from repro.core.slab import SLaBDecomposition as RefDec
from repro.kernels import ops as ref_ops
from repro_torch import bridge
from repro_torch.core import packing, sparsity
from repro_torch.core.packed_model import (ExpertPackedStack, expert_matmul,
                                           pack_expert_stack, pack_linear,
                                           packed_matmul)
from repro_torch.core.slab import SLaBDecomposition, reconstruct
from repro_torch.kernels import ops


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# --------------------------------------------- grouped kernels (#12-#20)

N, K = 48, 64


def _expert_planes(rng, e, rank, pattern=None, wide_ids=False):
    """Per-expert SLaB planes from numpy, packed by the port's packers
    (the reference reads their numpy views)."""
    w = torch.from_numpy(_randn(rng, e, N, K, scale=0.1))
    score = torch.from_numpy(np.abs(_randn(rng, e, N, K)))
    signs = torch.from_numpy(np.where(_randn(rng, e, N, K) >= 0, 1, -1)
                             .astype(np.int8))
    out = {"u": torch.from_numpy(_randn(rng, e, N, rank, scale=.2)),
           "v": torch.from_numpy(_randn(rng, e, K, rank, scale=.2)),
           "b": torch.stack([packing.pack_sign_bits(signs[i])
                             for i in range(e)]),
           "dense": torch.where(score > 0.7, w, 0.0)}
    if pattern:
        nn, mm = sparsity.parse_pattern(pattern)
        nms = [packing.pack_nm(torch.where(sparsity.nm_mask(score[i], nn, mm),
                                           w[i], 0.0), nn, mm, strict=True)
               for i in range(e)]
        out["nm"] = (torch.stack([p.values for p in nms]),
                     torch.stack([p.indices for p in nms]), mm)
    else:
        ws = torch.where(score > 0.9, w, 0.0)
        k_max = max(packing.ell_row_nnz_max(ws[i]) for i in range(e))
        ells = [packing.ell_pack(ws[i], nnz=k_max) for i in range(e)]
        idx = torch.stack([p.indices for p in ells])
        if wide_ids:
            idx = packing.as_unsigned(idx).int()
        out["ell"] = (torch.stack([p.values for p in ells]), idx)
    return out


def _np_ids(idx: torch.Tensor) -> np.ndarray:
    """The reference's unsigned ELL ids of the port's int16/int32 view."""
    a = idx.numpy()
    return a.view(np.uint16 if a.dtype == np.int16 else np.uint32)


CASES = [  # (kernel, E, M, rank, pattern or id width)
    ("slab_ell", 1, 1, 1, "u16"), ("slab_ell", 3, 5, 3, "u16"),
    ("slab_ell", 4, 5, 1, "u32"), ("slab_ell", 2, 9, 1, "u16"),
    ("slab_ell", 3, 20, 3, "u32"),
    ("nm", 1, 1, 1, "2:4"), ("nm", 3, 5, 1, "4:8"), ("nm", 4, 5, 1, "2:4"),
    ("slab", 1, 1, 1, None), ("slab", 3, 5, 3, None), ("slab", 4, 1, 1, None),
    ("slab_nm", 1, 1, 1, "2:4"), ("slab_nm", 3, 5, 3, "4:8"),
    ("slab_nm", 4, 5, 1, "2:4"),
    ("ell", 1, 1, 1, "u16"), ("ell", 3, 5, 1, "u32"), ("ell", 4, 5, 1, "u16"),
    ("ell_lr", 1, 1, 1, "u16"), ("ell_lr", 3, 5, 3, "u16"),
    ("ell_lr", 4, 1, 3, "u32"),
    ("slab_lr", 1, 1, 1, None), ("slab_lr", 3, 5, 3, None),
    ("slab_lr", 4, 1, 1, None),
    ("slab_nm_lr", 1, 1, 1, "2:4"), ("slab_nm_lr", 3, 5, 3, "4:8"),
    ("slab_nm_lr", 4, 5, 1, "2:4"), ("slab_nm_lr", 2, 9, 1, "2:4"),
    ("slab_nm_lr", 3, 20, 3, "4:8"),
    ("binlr", 1, 1, 1, None), ("binlr", 3, 5, 3, None),
    ("binlr", 4, 5, 1, None),
]


@pytest.mark.parametrize("kernel,e,m,rank,opt", CASES,
                         ids=lambda c: str(c))
def test_grouped_plain_matches_reference_interpret(kernel, e, m, rank, opt):
    rng = np.random.default_rng(e * 10 + m + rank)
    pattern = opt if opt and ":" in opt else None
    p = _expert_planes(rng, e, rank, pattern, wide_ids=opt == "u32")
    x = torch.from_numpy(_randn(rng, e, m, K))
    xr, ur, vr = jnp.asarray(x.numpy()), jnp.asarray(p["u"].numpy()), \
        jnp.asarray(p["v"].numpy())
    br = jnp.asarray(p["b"].numpy().view(np.uint32))
    if kernel == "slab_ell":
        vals, idx = p["ell"]
        got = ops.slab_ell_matmul_g(x, vals, idx, p["b"], p["u"], p["v"])
        want = ref_ops.slab_ell_matmul_g(
            xr, jnp.asarray(vals.numpy()), jnp.asarray(_np_ids(idx)), br, ur,
            vr, interpret=True)
    elif kernel == "nm":
        vals, idx, mm = p["nm"]
        got = ops.nm_matmul_g(x, vals, idx, mm)
        want = ref_ops.nm_matmul_g(xr, jnp.asarray(vals.numpy()),
                                   jnp.asarray(idx.numpy()), mm,
                                   interpret=True)
    elif kernel == "slab":
        got = ops.slab_matmul_g(x, p["dense"], p["b"], p["u"], p["v"])
        want = ref_ops.slab_matmul_g(xr, jnp.asarray(p["dense"].numpy()), br,
                                     ur, vr, interpret=True)
    elif kernel in ("ell", "ell_lr"):
        vals, idx = p["ell"]
        ell_r = (jnp.asarray(vals.numpy()), jnp.asarray(_np_ids(idx)))
        if kernel == "ell":
            got = ops.ell_matmul_g(x, vals, idx)
            want = ref_ops.ell_matmul_g(xr, *ell_r, interpret=True)
        else:
            got = ops.ell_lr_matmul_g(x, vals, idx, p["u"], p["v"])
            want = ref_ops.ell_lr_matmul_g(xr, *ell_r, ur, vr,
                                           interpret=True)
    elif kernel == "slab_lr":
        got = ops.slab_lr_matmul_g(x, p["dense"], p["u"], p["v"])
        want = ref_ops.slab_lr_matmul_g(xr, jnp.asarray(p["dense"].numpy()),
                                        ur, vr, interpret=True)
    elif kernel == "slab_nm_lr":
        vals, idx, mm = p["nm"]
        got = ops.slab_nm_lr_matmul_g(x, vals, idx, mm, p["u"], p["v"])
        want = ref_ops.slab_nm_lr_matmul_g(
            xr, jnp.asarray(vals.numpy()), jnp.asarray(idx.numpy()), mm, ur,
            vr, interpret=True)
    elif kernel == "binlr":
        got = ops.binlr_g(x, p["b"], p["u"], p["v"])
        want = ref_ops.binlr_g(xr, br, ur, vr, interpret=True)
    else:
        vals, idx, mm = p["nm"]
        got = ops.slab_nm_matmul_g(x, vals, idx, mm, p["b"], p["u"], p["v"])
        want = ref_ops.slab_nm_matmul_g(
            xr, jnp.asarray(vals.numpy()), jnp.asarray(idx.numpy()), mm, br,
            ur, vr, interpret=True)
    assert got.shape == (e, m, N) and got.dtype == torch.float32
    assert _rel(got, want) < 1e-5


def test_grouped_plain_takes_each_experts_planes():
    """Expert e's output is the per-linear plain version on x[e] and
    expert e's planes alone (no mixing across the expert axis)."""
    rng = np.random.default_rng(7)
    p = _expert_planes(rng, 3, 1)
    x = torch.from_numpy(_randn(rng, 3, 2, K))
    vals, idx = p["ell"]
    got = ops.slab_ell_matmul_g(x, vals, idx, p["b"], p["u"], p["v"])
    for e in range(3):
        want = ops.slab_ell_matmul(x[e], vals[e], idx[e], p["b"][e],
                                   p["u"][e], p["v"][e])
        assert torch.equal(got[e], want)


# ------------------------------------------------------ pack_expert_stack

def _np_dec(seed, n=64, k=128, *, keep=0.4, rank=2, binary=True,
            pattern=None):
    """A numpy decomposition (w_s, u, v, w_b) in the reference's layout."""
    rng = np.random.default_rng(seed)
    w = _randn(rng, n, k, scale=0.1)
    score = np.abs(w)
    if pattern:
        nn, mm = map(int, pattern.split(":"))
        g = score.reshape(n, k // mm, mm)
        order = np.argsort(-g, axis=-1, kind="stable")[..., :nn]
        mask = np.zeros_like(g, bool)
        np.put_along_axis(mask, order, True, axis=-1)
        mask = mask.reshape(n, k)
    else:
        thr = np.quantile(score, 1 - keep, axis=1, keepdims=True)
        mask = score >= thr
    w_s = np.where(mask, w, 0.0).astype(np.float32)
    u = _randn(rng, n, rank, scale=0.2)
    v = _randn(rng, k, rank, scale=0.2)
    w_b = (np.where(rng.random((n, k)) < 0.5, 1, -1).astype(np.int8)
           if binary else np.zeros((0, 0), np.int8))
    return w_s, u, v, w_b


def _ref_dec(t):
    return RefDec(*(None if a is None else jnp.asarray(a) for a in t))


def _port_dec(t):
    return SLaBDecomposition(*(None if a is None else torch.from_numpy(a)
                               for a in t))


def _no_sparse_plane(n=64, k=128):
    return (None, np.zeros((n, 0), np.float32), np.zeros((k, 0), np.float32),
            np.zeros((0, 0), np.int8))


def _assert_same_stack(got: ExpertPackedStack, ref):
    want = bridge.expert_packed_stack(ref, device="cpu")
    assert got.members == want.members
    assert got.dense_members == want.dense_members
    assert got.n_experts == want.n_experts
    assert len(got.groups) == len(want.groups)
    for g, w in zip(got.groups, want.groups):
        assert (g.variant, g.m_pat, g.d_in, g.d_out, g.rank) == \
            (w.variant, w.m_pat, w.d_in, w.d_out, w.rank)
        for name in ("sparse_vals", "sparse_idx", "b_packed", "u", "v"):
            a, b = getattr(g, name), getattr(w, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b), name
    if want.dense is None:
        assert got.dense is None
    else:
        assert torch.equal(got.dense, want.dense)


STACKS = {
    "mixed_kmax": [dict(seed=s, keep=kp)
                   for s, kp in enumerate((0.05, 0.08, 0.4, 0.45))],
    "dense_member": [dict(seed=0, keep=0.45), None, dict(seed=2, keep=0.05),
                     dict(seed=3, keep=0.45)],
    "nm_2_4": [dict(seed=s, pattern="2:4") for s in range(3)],
    "rank_mix": [dict(seed=0, rank=1), dict(seed=1, rank=2),
                 dict(seed=2, rank=1)],
}


@pytest.mark.parametrize("case", list(STACKS))
def test_pack_expert_stack_byte_identical_to_reference(case):
    specs = STACKS[case]
    pattern = specs[0].get("pattern") if specs[0] else None
    decs = [(_no_sparse_plane() if s is None else _np_dec(**s))
            for s in specs]
    old = _randn(np.random.default_rng(9), len(decs), 128, 64)
    ref = ref_pm.pack_expert_stack(jnp.asarray(old),
                                   tuple(_ref_dec(d) for d in decs), pattern,
                                   jnp.float32)
    got = pack_expert_stack(torch.from_numpy(old),
                            tuple(_port_dec(d) for d in decs), pattern,
                            torch.float32)
    _assert_same_stack(got, ref)


def _dense_out(x, dec):
    return x @ reconstruct(dec).T


def test_mixed_kmax_buckets_pad_to_bucket_max():
    """Experts of very different realized row-nnz land in different K_max
    buckets; each bucket pads to its own realized max."""
    decs = tuple(_port_dec(_np_dec(s, keep=kp))
                 for s, kp in enumerate((0.05, 0.08, 0.4, 0.45)))
    old = torch.from_numpy(_randn(np.random.default_rng(9), 4, 128, 64))
    eps = pack_expert_stack(old, decs, None)
    assert eps.dense_members == () and eps.dense is None
    assert sorted(e for mem in eps.members for e in mem) == [0, 1, 2, 3]
    assert len(eps.groups) >= 2
    kmaxes = [packing.ell_row_nnz_max(d.w_s) for d in decs]
    for grp, mem in zip(eps.groups, eps.members):
        assert grp.sparse_idx.shape[-1] == max(kmaxes[e] for e in mem)
    x = torch.from_numpy(_randn(np.random.default_rng(10), 4, 8, 128))
    got = expert_matmul(x, eps)
    for e, d in enumerate(decs):
        torch.testing.assert_close(got[e], _dense_out(x[e], d), rtol=1e-4,
                                   atol=1e-4)


def test_expert_stack_dense_member_and_permutation():
    """An expert with no packable terms rides the dense slice of ``old``;
    the gathers restore expert order when groups interleave ids."""
    decs = tuple(_port_dec(t) for t in (
        _np_dec(0, keep=0.45), _no_sparse_plane(), _np_dec(2, keep=0.05),
        _np_dec(3, keep=0.45)))
    old = torch.from_numpy(_randn(np.random.default_rng(11), 4, 128, 64,
                                  scale=0.1))
    eps = pack_expert_stack(old, decs, None)
    assert eps.dense_members == (1,) and eps.dense.shape == (1, 128, 64)
    assert 1 not in {e for mem in eps.members for e in mem}
    x = torch.from_numpy(_randn(np.random.default_rng(12), 4, 8, 128))
    got = expert_matmul(x, eps)
    for e in (0, 2, 3):
        torch.testing.assert_close(got[e], _dense_out(x[e], decs[e]),
                                   rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[1], x[1] @ old[1], rtol=1e-4, atol=1e-4)


def test_single_bucket_full_coverage_fast_path():
    """Same-signature experts collapse to one group over every id."""
    decs = tuple(_port_dec(_np_dec(s, keep=0.4)) for s in range(4))
    old = torch.from_numpy(_randn(np.random.default_rng(13), 4, 128, 64))
    eps = pack_expert_stack(old, decs, None)
    assert len(eps.groups) == 1 and eps.members == ((0, 1, 2, 3),)
    x = torch.from_numpy(_randn(np.random.default_rng(14), 4, 8, 128))
    got = expert_matmul(x, eps)
    for e, d in enumerate(decs):
        torch.testing.assert_close(got[e], _dense_out(x[e], d), rtol=1e-4,
                                   atol=1e-4)


# ------------------------- the variants of the grouped kernels #12, #13, #18-#20

GROUPED_VARIANTS = {  # variant -> (numpy dec maker of a seed, pattern)
    "sparse-ell": (lambda s: _np_dec(s, keep=0.2, rank=0, binary=False),
                   None),
    "lowrank-ell": (lambda s: _np_dec(s, keep=0.2, binary=False), None),
    "lowrank-dense": (lambda s: _np_dec(s, keep=0.9, binary=False), None),
    "lowrank-nm": (lambda s: _np_dec(s, binary=False, pattern="2:4"), "2:4"),
    "binlr": (lambda s: (np.zeros((64, 128), np.float32),) + _np_dec(s)[1:],
              None),
}


@pytest.mark.parametrize("variant", list(GROUPED_VARIANTS))
def test_grouped_variants_serve_each_expert(variant):
    """Three experts of one variant stack into one group whose
    ``expert_matmul`` gives, expert for expert, that expert's own
    per-linear ``packed_matmul``, and what the reference's
    ``expert_matmul`` gives on its pack of the same decompositions (the
    two stacks byte-identical)."""
    make, pattern = GROUPED_VARIANTS[variant]
    np_decs = [make(s) for s in range(3)]
    decs = tuple(_port_dec(d) for d in np_decs)
    old = _randn(np.random.default_rng(4), 3, 128, 64)
    eps = pack_expert_stack(torch.from_numpy(old), decs, pattern)
    assert [g.variant for g in eps.groups] == [variant]
    assert eps.members == ((0, 1, 2),) and not eps.dense_members
    ref = ref_pm.pack_expert_stack(jnp.asarray(old),
                                   tuple(_ref_dec(d) for d in np_decs),
                                   pattern, jnp.float32)
    _assert_same_stack(eps, ref)
    x = _randn(np.random.default_rng(5), 3, 6, 128)
    got = expert_matmul(torch.from_numpy(x), eps)
    assert got.shape == (3, 6, 64)
    grp = eps.groups[0]
    k_max = grp.sparse_vals.shape[-1] if variant.endswith("-ell") else None
    for e, d in enumerate(decs):
        own = pack_linear(d, pattern, torch.float32, variant=variant,
                          ell_nnz=k_max)
        assert _rel(got[e], packed_matmul(torch.from_numpy(x[e]), own)) \
            < 1e-6
    want = ref_pm.expert_matmul(jnp.asarray(x), ref)
    assert _rel(got, want) < 1e-5


def test_pack_model_counts_experts_and_names_dense_ones():
    """pack_model on a tuple of per-expert decs: an ExpertPackedStack in
    the layer, each packed expert counted under its variant, an expert
    with no sparse plane left dense and named in the report."""
    from repro_torch.core.packed_model import pack_model
    decs = (_np_dec(0, keep=0.2, rank=0, binary=False), _no_sparse_plane(),
            _np_dec(2, keep=0.2, rank=0, binary=False))
    old = torch.from_numpy(_randn(np.random.default_rng(3), 3, 128, 64))
    params = {"layers": [{"moe": {"w_up": old}}]}
    out, rep = pack_model(params, {(0, "moe.w_up"): tuple(
        _port_dec(d) for d in decs)})
    eps = out["layers"][0]["moe"]["w_up"]
    assert isinstance(eps, ExpertPackedStack)
    assert params["layers"][0]["moe"]["w_up"] is old     # input untouched
    assert rep.by_variant == {"sparse-ell": 2} and rep.n_packed == 2
    assert rep.fallback == ((0, "moe.w_up[expert 1]"),)
    per_e = 128 * 64 * 4
    assert rep.bytes_by_variant["dense-fallback"] == (per_e, per_e)
    packed_b, dense_b = rep.bytes_by_variant["sparse-ell"]
    assert dense_b == per_e and packed_b < per_e


# ------------------------------------------- library choice and counters


@pytest.mark.parametrize("dtype,m,source", [
    (torch.bfloat16, 1, "ell.cu"), (torch.bfloat16, 2, "ell.cu"),
    (torch.bfloat16, 3, "grouped_tc.cu"), (torch.bfloat16, 32,
                                           "grouped_tc.cu"),
    (torch.float32, 6, "ell.cu")])
def test_slab_ell_g_library_choice(dtype, m, source):
    """bf16 #14 runs the tensor-core kernel from TC_MIN_ROWS rows per
    expert; fewer rows and f32 the first design, on its own counter."""
    from repro_torch.kernels import grouped as g_k
    kern = g_k.slab_ell_g_kernel(dtype, m)
    assert kern.source == source and kern.name == "slab_ell_matmul_g"
    assert kern.key == ("slab_ell_matmul_g" if source == "grouped_tc.cu"
                        else "slab_ell_matmul_g@ell.cu")


@pytest.mark.parametrize("dtype,pattern,source", [
    (torch.bfloat16, (2, 4), "grouped_tc.cu"),
    (torch.bfloat16, (4, 8), "grouped_tc.cu"),
    (torch.bfloat16, (1, 4), "slab_matmul.cu"),
    (torch.float32, (2, 4), "slab_matmul.cu")])
def test_slab_nm_lr_g_library_choice(dtype, pattern, source):
    from repro_torch.kernels import grouped as g_k
    kern = g_k.slab_nm_lr_g_kernel(dtype, *pattern)
    assert kern.source == source and kern.name == "slab_nm_lr_matmul_g"


@pytest.mark.parametrize("lowrank", [False, True], ids=("ell", "ell_lr"))
@pytest.mark.parametrize("dtype,m,k,source", [
    (torch.bfloat16, 1, 2048, "ell.cu"), (torch.bfloat16, 2, 2048, "ell.cu"),
    (torch.bfloat16, 3, 2048, "grouped_tc.cu"),
    (torch.bfloat16, 32, 1412, "grouped_tc.cu"),
    (torch.bfloat16, 6, 20000, "ell.cu"), (torch.float32, 6, 2048, "ell.cu")])
def test_ell_g_library_choice(dtype, m, k, source, lowrank):
    """bf16 #12 / #13 run grouped_tc.cu's gather kernel from
    ELL_TC_MIN_ROWS rows per expert where its tile fits shared memory;
    fewer rows, wider K and f32 the first design, on its own counter."""
    from repro_torch.kernels import grouped as g_k
    name = "ell_lr_matmul_g" if lowrank else "ell_matmul_g"
    kern = g_k.ell_g_kernel(dtype, m, k, lowrank)
    assert kern.source == source and kern.name == name
    assert kern.key == (name if source == "grouped_tc.cu"
                        else f"{name}@ell.cu")


@pytest.mark.parametrize("lowrank,k,r,idx_bytes,source", [
    (False, 11455, 0, 4, "grouped_tc.cu"), (False, 11456, 0, 4, "ell.cu"),
    (False, 12479, 0, 2, "grouped_tc.cu"), (False, 12480, 0, 2, "ell.cu"),
    (True, 11008, 24, 4, "grouped_tc.cu"), (True, 11008, 25, 4, "ell.cu"),
    (True, 11008, 32, 2, "grouped_tc.cu"), (True, 11008, 32, 4, "ell.cu")])
def test_ell_g_library_choice_by_shared_memory(lowrank, k, r, idx_bytes,
                                               source):
    """The gather kernel's one tile of x, its ring of planes (wider for
    uint32 ids) and #13's projection sums (growing with the rank) must
    fit an H100 block; where they do not, the first design runs."""
    from repro_torch.kernels import grouped as g_k
    kern = g_k.ell_g_kernel(torch.bfloat16, 6, k, lowrank, r=r,
                            idx_bytes=idx_bytes)
    assert kern.source == source
    fits = g_k.ell_tc_smem(k, r, idx_bytes) <= g_k.ELL_TC_SMEM
    assert fits == (source == "grouped_tc.cu")


def test_ell_tc_smem_counts_the_launch_bytes():
    """x at (K + 8) // 8 · 8 columns of 16 bytes, 4 ring steps for 256
    threads of 2 (uint16 ids) or 3 (uint32) 16-byte units, 9 · 8 fp32
    projection sums per rank."""
    from repro_torch.kernels import grouped as g_k
    assert g_k.ELL_TC_SMEM == 232448
    assert g_k.ell_tc_smem(11008, 32, 4) == 176256 + 49152 + 9216
    assert g_k.ell_tc_smem(2048, 0, 2) == 2056 * 16 + 32768
    assert g_k.ell_tc_smem(1412, 3, 2) == 1416 * 16 + 32768 + 864


@pytest.mark.parametrize("dtype,m,k,r,source", [
    (torch.bfloat16, 1, 2048, 1, "grouped_tc.cu"),
    (torch.bfloat16, 6, 1408, 3, "grouped_tc.cu"),
    (torch.bfloat16, 128, 2048, 1, "grouped_tc.cu"),
    (torch.bfloat16, 6, 1412, 1, "slab_matmul.cu"),
    (torch.bfloat16, 6, 11008, 1, "slab_matmul.cu"),
    (torch.float32, 6, 2048, 1, "slab_matmul.cu")])
def test_slab_lr_g_library_choice(dtype, m, k, r, source):
    """bf16 #18 runs grouped_tc.cu's kernel from LR_TC_MIN_ROWS rows per
    expert where K % 8 == 0 (16-byte bulk copies of its rows) and one
    tile fits shared memory; f32 and other shapes the first design, on
    its own counter."""
    from repro_torch.kernels import grouped as g_k
    kern = g_k.slab_lr_g_kernel(dtype, m, k, r)
    want = source if m >= g_k.LR_TC_MIN_ROWS else "slab_matmul.cu"
    assert kern.source == want and kern.name == "slab_lr_matmul_g"
    assert kern.key == ("slab_lr_matmul_g" if want == "grouped_tc.cu"
                        else "slab_lr_matmul_g@slab_matmul.cu")


def test_slab_lr_g_library_choice_below_the_crossover():
    """Fewer rows per expert than LR_TC_MIN_ROWS run the first design."""
    from repro_torch.kernels import grouped as g_k
    for m in range(0, g_k.LR_TC_MIN_ROWS):
        assert g_k.slab_lr_g_kernel(torch.bfloat16, m, 2048) \
            is g_k.SLAB_LR_G_FIRST
    assert g_k.slab_lr_g_kernel(torch.bfloat16, g_k.LR_TC_MIN_ROWS,
                                2048) is g_k.SLAB_LR_G


def test_lr_tc_smem_counts_the_launch_bytes():
    """x at K rounded up to 128 plus 8 columns of 2 bytes for 8 rows,
    9 · 8 fp32 projection sums per rank (rounded to 16 bytes), a 2-stage
    ring of 16 rows of 256 bytes for each of 8 warps and 1024 bytes to
    align it for the tensor map's swizzle; K 10,240 fits an H100 block,
    10,248 does not."""
    from repro_torch.kernels import grouped as g_k
    from repro_torch.kernels import slab_matmul as slab_k
    assert g_k.lr_tc_smem(2048, 1) == 8 * 2056 * 2 + 288 + 66560
    assert g_k.lr_tc_smem(1408, 3) == 8 * 1416 * 2 + 864 + 66560
    assert g_k.lr_tc_smem(10240, 1) <= slab_k.TC_SMEM
    assert g_k.lr_tc_smem(10248, 1) > slab_k.TC_SMEM


@pytest.mark.parametrize("dtype,pattern,m,r,source", [
    (torch.bfloat16, (2, 4), 1, 1, "grouped_tc.cu"),
    (torch.bfloat16, (2, 4), 2, 3, "grouped_tc.cu"),
    (torch.bfloat16, (4, 8), 37, 6, "grouped_tc.cu"),
    (torch.bfloat16, (2, 4), 2, 7, "slab_matmul.cu"),
    (torch.bfloat16, (1, 4), 2, 1, "slab_matmul.cu"),
    (torch.bfloat16, (2, 8), 2, 1, "slab_matmul.cu"),
    (torch.float32, (2, 4), 2, 1, "slab_matmul.cu"),
    (torch.float32, (4, 8), 20, 3, "slab_matmul.cu")])
def test_slab_nm_g_library_choice(dtype, pattern, m, r, source):
    """bf16 2:4 / 4:8 #17 runs grouped_tc.cu's ±1 body from
    SLAB_NM_G_TC_MIN_ROWS rows per expert up to rank 6 (its x and x ⊙ v_r
    tiles fit an H100 block, as #2's); f32, the other patterns, fewer
    rows and rank 7 the first design, on its own counter."""
    from repro_torch.kernels import grouped as g_k
    from repro_torch.kernels import slab_matmul as slab_k
    kern = g_k.slab_nm_g_kernel(dtype, *pattern, m, r)
    want = source if m >= g_k.SLAB_NM_G_TC_MIN_ROWS else "slab_matmul.cu"
    assert kern.source == want and kern.name == "slab_nm_matmul_g"
    assert kern.key == ("slab_nm_matmul_g" if want == "grouped_tc.cu"
                        else "slab_nm_matmul_g@slab_matmul.cu")
    assert (want == "grouped_tc.cu") == (
        slab_k.nm_tc_smem(r) <= slab_k.TC_SMEM and dtype == torch.bfloat16
        and pattern in ((2, 4), (4, 8)) and m >= g_k.SLAB_NM_G_TC_MIN_ROWS)


@pytest.mark.parametrize("dtype,m,r,source", [
    (torch.bfloat16, 1, 1, "grouped_tc.cu"),
    (torch.bfloat16, 6, 3, "grouped_tc.cu"),
    (torch.bfloat16, 37, 4, "grouped_tc.cu"),
    (torch.bfloat16, 6, 5, "slab_matmul.cu"),
    (torch.float32, 6, 1, "slab_matmul.cu"),
    (torch.float32, 1, 3, "slab_matmul.cu")])
def test_binlr_g_library_choice(dtype, m, r, source):
    """bf16 #20 runs grouped_tc.cu's ±1 body from BINLR_G_TC_MIN_ROWS rows
    per expert up to rank binlr.TC_MAX_RANK (4: an accumulator a rank in
    registers, as #9's); f32 and rank 5 the first design, on its own
    counter."""
    from repro_torch.kernels import grouped as g_k
    kern = g_k.binlr_g_kernel(dtype, m, r)
    want = source if m >= g_k.BINLR_G_TC_MIN_ROWS else "slab_matmul.cu"
    assert kern.source == want and kern.name == "binlr_matmul_g"
    assert kern.key == ("binlr_matmul_g" if want == "grouped_tc.cu"
                        else "binlr_matmul_g@slab_matmul.cu")


@pytest.mark.parametrize("dtype,pattern,m,source", [
    (torch.bfloat16, (2, 4), 1, "grouped_tc.cu"),
    (torch.bfloat16, (2, 4), 2, "grouped_tc.cu"),
    (torch.bfloat16, (4, 8), 37, "grouped_tc.cu"),
    (torch.bfloat16, (1, 4), 2, "nm_sparse.cu"),
    (torch.bfloat16, (2, 8), 2, "nm_sparse.cu"),
    (torch.float32, (2, 4), 2, "nm_sparse.cu"),
    (torch.float32, (4, 8), 20, "nm_sparse.cu")])
def test_nm_g_library_choice(dtype, pattern, m, source):
    """bf16 2:4 / 4:8 #15 runs grouped_tc.cu's body (#17's without the
    ±1 term) from NM_G_TC_MIN_ROWS rows per expert; f32, the other
    patterns and fewer rows the first design (nm_sparse.cu), on its own
    counter."""
    from repro_torch.kernels import grouped as g_k
    kern = g_k.nm_g_kernel(dtype, *pattern, m)
    want = source if m >= g_k.NM_G_TC_MIN_ROWS else "nm_sparse.cu"
    assert kern.source == want and kern.name == "nm_matmul_g"
    assert kern.key == ("nm_matmul_g" if want == "grouped_tc.cu"
                        else "nm_matmul_g@nm_sparse.cu")


def test_grouped_binary_library_choice_below_the_crossover():
    """Fewer rows per expert than the MIN_ROWS constants run the first
    design of #17 and #20."""
    from repro_torch.kernels import grouped as g_k
    for m in range(0, g_k.SLAB_NM_G_TC_MIN_ROWS):
        assert g_k.slab_nm_g_kernel(torch.bfloat16, 2, 4, m) \
            is g_k.SLAB_NM_G_FIRST
    for m in range(0, g_k.BINLR_G_TC_MIN_ROWS):
        assert g_k.binlr_g_kernel(torch.bfloat16, m) is g_k.BINLR_G_FIRST
    assert g_k.slab_nm_g_kernel(torch.bfloat16, 2, 4,
                                g_k.SLAB_NM_G_TC_MIN_ROWS) is g_k.SLAB_NM_G
    assert g_k.binlr_g_kernel(torch.bfloat16,
                              g_k.BINLR_G_TC_MIN_ROWS) is g_k.BINLR_G


def test_binlr_g_tiles_fit_at_every_rank_it_takes():
    """At the ranks grouped_tc.cu's #20 takes, its x ⊙ v_r tiles (8 batch
    rows a rank at the widest split, 16 chunks of 128 plus 8 columns, 2
    bytes each; no x tile) and the staged u of its row tiles fit an H100
    block (two blocks an SM up to rank 3)."""
    from repro_torch.kernels import binlr as binlr_k
    from repro_torch.kernels import grouped as g_k
    from repro_torch.kernels import slab_matmul as slab_k

    def smem(r):
        tiles = r * 8 * (slab_k.NM_MAX_SPLIT_CHUNKS * slab_k.CHUNK + 8) * 2
        return tiles + r * 4 * 128 * 2          # u of four row tiles
    r = binlr_k.TC_MAX_RANK
    assert smem(r) <= slab_k.TC_SMEM
    assert 2 * smem(3) <= 228 * 1024 - 2 * 1024
    assert g_k.binlr_g_kernel(torch.bfloat16, 6, r) is g_k.BINLR_G
    assert g_k.binlr_g_kernel(torch.bfloat16, 6, r + 1) \
        is g_k.BINLR_G_FIRST


def test_launch_counters_are_per_library():
    """Every library has a counter key of its own, and a reset zeroes
    them all."""
    keys = [k.key for k in ops.KERNELS]
    assert len(set(keys)) == len(keys) == 38
    assert len({k.name for k in ops.KERNELS}) == 20
    for k in ops.KERNELS:
        k.launches = 1
    assert set(ops.launch_counts()) == set(keys)
    ops.reset_launch_counts()
    assert not any(ops.launch_counts().values())


# ------------------------------------------------------------- bridge


def test_bridge_defaults_to_the_card():
    """Without a device a converter puts its tensor on the card (and
    raises without one, as every entry point does); ``device="cpu"``
    keeps it on the CPU."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    if torch.cuda.is_available():
        assert bridge.tensor(a).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bridge.tensor(a)
    got = bridge.tensor(a, device="cpu")
    assert got.device.type == "cpu" and torch.equal(got, torch.from_numpy(a))
