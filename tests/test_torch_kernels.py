"""The port's kernel wrappers (plain PyTorch versions on the CPU) and
oracles against the reference Pallas kernels run in interpret mode.

Inputs are made with numpy from a seed, packed by the reference packers
and handed to both sides (the port's planes through ``bridge``). Every
comparison is f32 at max|diff| / max|ref| < 1e-5.
"""
import functools
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as ref_packing
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro_torch import bridge
from repro_torch.core import packing
from repro_torch.kernels import common, ops, ref
from repro_torch.kernels import slab_matmul as slab_k

TOL = 1e-5
N, K = 96, 256


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _inputs(seed, m, rank, keep=0.44, pattern=None):
    """Seeded numpy x, W_S, W_B, u (N, R), v (K, R); W_S keeps the
    top-|w| ``keep`` of each row (or the best n of every m)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, K)).astype(np.float32)
    w = (rng.standard_normal((N, K)) * 0.1).astype(np.float32)
    if pattern:
        n_keep, m_pat = map(int, pattern.split(":"))
        g = np.abs(w).reshape(N, K // m_pat, m_pat)
        thr = -np.sort(-g, axis=-1)[..., n_keep - 1:n_keep]
        mask = (g >= thr).reshape(N, K)
    else:
        kk = int(keep * K)
        thr = -np.sort(-np.abs(w), axis=1)[:, kk - 1:kk]
        mask = np.abs(w) >= thr
    w_s = np.where(mask, w, 0.0).astype(np.float32)
    w_b = np.where(rng.random((N, K)) < 0.5, 1, -1).astype(np.int8)
    u = np.abs(rng.standard_normal((N, rank))).astype(np.float32) * 0.2
    v = np.abs(rng.standard_normal((K, rank))).astype(np.float32) * 0.2
    return x, w_s, w_b, u, v


def _uv_forms(u, v, rank):
    """Rank 1 goes in as vectors (the (N,) / (K,) form of the contract)."""
    return (u[:, 0], v[:, 0]) if rank == 1 else (u, v)


@pytest.mark.parametrize("m", [1, 5, 37])
@pytest.mark.parametrize("rank", [1, 3])
def test_slab_ell_matches_reference_kernel(m, rank):
    x, w_s, w_b, u, v = _inputs(m * 10 + rank, m, rank)
    ep = ref_packing.ell_pack(jnp.asarray(w_s))
    bp = ref_packing.pack_sign_bits(jnp.asarray(w_b))
    uu, vv = _uv_forms(u, v, rank)
    want = ref_ops.slab_ell_matmul(jnp.asarray(x), ep.values, ep.indices, bp,
                                   jnp.asarray(uu), jnp.asarray(vv),
                                   interpret=True)
    t = functools.partial(bridge.tensor, device="cpu")
    got = ops.slab_ell_matmul(t(x), t(ep.values), t(ep.indices), t(bp),
                              t(uu), t(vv))
    assert got.dtype == torch.float32 and got.shape == (m, N)
    assert _rel(got, want) < TOL
    oracle = ref.slab_ell_matmul_ref(t(x), t(ep.values), t(ep.indices), K,
                                     t(bp), t(uu), t(vv))
    assert _rel(oracle, ref_oracles.slab_ell_matmul_ref(
        jnp.asarray(x), ep.values, ep.indices, K, bp, jnp.asarray(uu),
        jnp.asarray(vv))) < TOL


@pytest.mark.parametrize("pattern", ["2:4", "4:8"])
@pytest.mark.parametrize("rank", [1, 3])
def test_slab_nm_matches_reference_kernel(pattern, rank):
    m = 7
    x, w_s, w_b, u, v = _inputs(41 + rank, m, rank, pattern=pattern)
    n_keep, m_pat = map(int, pattern.split(":"))
    nm = ref_packing.pack_nm(jnp.asarray(w_s), n_keep, m_pat)
    bp = ref_packing.pack_sign_bits(jnp.asarray(w_b))
    uu, vv = _uv_forms(u, v, rank)
    want = ref_ops.slab_nm_matmul(jnp.asarray(x), nm.values, nm.indices,
                                  m_pat, bp, jnp.asarray(uu),
                                  jnp.asarray(vv), interpret=True)
    t = functools.partial(bridge.tensor, device="cpu")
    got = ops.slab_nm_matmul(t(x), t(nm.values), t(nm.indices), m_pat,
                             t(bp), t(uu), t(vv))
    assert _rel(got, want) < TOL
    oracle = ref.slab_nm_matmul_ref(t(x), t(nm.values), t(nm.indices), m_pat,
                                    t(bp), t(uu), t(vv))
    assert _rel(oracle, want) < TOL


@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("rank", [1, 3])
def test_slab_dense_matches_reference_kernel(m, rank):
    x, w_s, w_b, u, v = _inputs(77 + m + rank, m, rank, keep=0.74)
    bp = ref_packing.pack_sign_bits(jnp.asarray(w_b))
    uu, vv = _uv_forms(u, v, rank)
    want = ref_ops.slab_matmul(jnp.asarray(x), jnp.asarray(w_s), bp,
                               jnp.asarray(uu), jnp.asarray(vv),
                               interpret=True)
    t = functools.partial(bridge.tensor, device="cpu")
    got = ops.slab_matmul(t(x), t(w_s), t(bp), t(uu), t(vv))
    assert _rel(got, want) < TOL
    oracle = ref.slab_matmul_ref(t(x), t(w_s), t(bp), t(uu), t(vv))
    assert _rel(oracle, want) < TOL


def test_wrappers_flatten_leading_dims():
    """(B, S, K) inputs come back (B, S, N), row for row equal to the
    flattened call — the packed forward's M = B·S path."""
    x, w_s, w_b, u, v = _inputs(5, 6, 1)
    t = functools.partial(bridge.tensor, device="cpu")
    ep = packing.ell_pack(t(w_s))
    bp = packing.pack_sign_bits(t(w_b))
    flat = ops.slab_ell_matmul(t(x), ep.values, ep.indices, bp, t(u), t(v))
    x3 = t(x).reshape(2, 3, K)
    y3 = ops.slab_ell_matmul(x3, ep.values, ep.indices, bp, t(u), t(v))
    assert y3.shape == (2, 3, N)
    assert torch.equal(y3.reshape(6, N), flat)


def _edge_signs():
    """Rows whose words are the edge patterns: all set (0xFFFFFFFF),
    only bit 31 (0x80000000, negative as int32), only bit 0, none."""
    w_b = -np.ones((4, 64), np.int8)
    w_b[0] = 1
    w_b[1, 31::32] = 1
    w_b[2, 0::32] = 1
    return w_b


def test_sign_words_bit_identical_at_edge_words():
    w_b = _edge_signs()
    want = np.asarray(ref_packing.pack_sign_bits(jnp.asarray(w_b)))
    got = packing.pack_sign_bits(torch.from_numpy(w_b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.array_equal(want[:, 0], [0xFFFFFFFF, 0x80000000, 1, 0])
    pm1 = common.unpack_bits(got, torch.float32).numpy()
    assert np.array_equal(pm1, w_b.astype(np.float32))
    assert np.array_equal(packing.unpack_sign_bits(got, 64).numpy(), w_b)


def test_binary_term_matches_reference_at_edge_words():
    """The binary ⊙ rank-1 term alone (W_S = 0) through both kernels on
    the edge-word signs: bit order and sign convention end to end."""
    rng = np.random.default_rng(3)
    w_b = _edge_signs()
    x = rng.standard_normal((3, 64)).astype(np.float32)
    u = np.abs(rng.standard_normal(4)).astype(np.float32)
    v = np.abs(rng.standard_normal(64)).astype(np.float32)
    bp = ref_packing.pack_sign_bits(jnp.asarray(w_b))
    w_s = np.zeros((4, 64), np.float32)
    want = ref_ops.slab_matmul(jnp.asarray(x), jnp.asarray(w_s), bp,
                               jnp.asarray(u), jnp.asarray(v),
                               interpret=True)
    t = functools.partial(bridge.tensor, device="cpu")
    got = ops.slab_matmul(t(x), t(w_s), t(bp), t(u), t(v))
    assert _rel(got, want) < TOL
    dense = (u[:, None] * v[None, :]) * w_b
    np.testing.assert_allclose(got.numpy(), x @ dense.T, rtol=1e-5,
                               atol=1e-5)


def test_bf16_binary_term_rounds_x_times_v_in_bf16():
    """The plain version forms x ⊙ v in x.dtype before the ±1 sum, as
    the reference kernel does: at bf16 its binary term equals the sum of
    bf16-rounded products exactly (fp32 accumulation of ±values)."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    xb, vb = x.bfloat16(), v.bfloat16()
    signs = torch.from_numpy(np.where(rng.random((3, 64)) < 0.5, 1, -1)
                             .astype(np.int8))
    bp = packing.pack_sign_bits(signs)
    got = common.binlr_term(xb, bp, torch.ones(1, 3, dtype=torch.bfloat16),
                            vb[None])
    prod = (xb * vb).float()                    # bf16-rounded products
    want = prod @ signs.float().T
    assert torch.equal(got, want)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel entry points take CUDA tensors only; the CPU path goes
    through ``ops`` to the plain version, never the other way round."""
    from repro_torch.kernels import ell as ell_k
    from repro_torch.kernels import slab_matmul as slab_k
    x, w_s, w_b, u, v = _inputs(1, 2, 1)
    t = functools.partial(bridge.tensor, device="cpu")
    ep = packing.ell_pack(t(w_s))
    bp = packing.pack_sign_bits(t(w_b))
    with pytest.raises(ValueError, match="expected"):
        ell_k.slab_ell_matmul(t(x), ep.values, ep.indices, bp, t(u).T,
                              t(v).T.contiguous())
    with pytest.raises(ValueError, match="expected"):
        slab_k.slab_matmul(t(x), t(w_s), bp, t(u).T, t(v).T.contiguous())
    assert ell_k.SLAB_ELL.launches == ell_k.SLAB_ELL_FIRST.launches == 0


# ---------------------------------- #2's library choice and split plan


@pytest.mark.parametrize("dtype,pattern,m,source", [
    (torch.bfloat16, (2, 4), 1, "grouped_tc.cu"),
    (torch.bfloat16, (2, 4), 4, "grouped_tc.cu"),
    (torch.bfloat16, (4, 8), 128, "grouped_tc.cu"),
    (torch.bfloat16, (1, 4), 4, "slab_matmul.cu"),
    (torch.bfloat16, (2, 8), 4, "slab_matmul.cu"),
    (torch.float32, (2, 4), 4, "slab_matmul.cu"),
    (torch.float32, (4, 8), 128, "slab_matmul.cu")])
def test_slab_nm_library_choice(dtype, pattern, m, source):
    """bf16 2:4 / 4:8 #2 runs grouped_tc.cu's kernel from NM_TC_MIN_ROWS
    rows; f32 and the other patterns the first design, on its own
    counter."""
    from repro_torch.kernels import slab_matmul as slab_k
    kern = slab_k.slab_nm_kernel(dtype, *pattern, m)
    want = source if m >= slab_k.NM_TC_MIN_ROWS else "slab_matmul.cu"
    assert kern.source == want and kern.name == "slab_nm_matmul"
    assert kern.key == ("slab_nm_matmul" if want == "grouped_tc.cu"
                        else "slab_nm_matmul@slab_matmul.cu")


def test_slab_nm_library_choice_by_rank():
    """grouped_tc.cu's kernel stages x and one tile of bf16(x ⊙ v_r) per
    rank for the widest split (nm_tc_smem): up to rank 6 they fit an
    H100 block, from rank 7 the first design runs."""
    from repro_torch.kernels import slab_matmul as slab_k
    assert slab_k.nm_tc_smem(1) == 2 * 8 * (16 * 128 + 8) * 2
    m = max(4, slab_k.NM_TC_MIN_ROWS)
    for r in range(1, 9):
        fits = slab_k.nm_tc_smem(r) <= slab_k.TC_SMEM
        assert fits == (r <= 6)
        assert slab_k.slab_nm_kernel(torch.bfloat16, 2, 4, m, r) is (
            slab_k.SLAB_NM if fits else slab_k.SLAB_NM_FIRST)


def test_slab_nm_library_choice_below_the_crossover():
    """Fewer rows than NM_TC_MIN_ROWS run the first design."""
    from repro_torch.kernels import slab_matmul as slab_k
    for m in range(0, slab_k.NM_TC_MIN_ROWS):
        assert slab_k.slab_nm_kernel(torch.bfloat16, 2, 4, m) \
            is slab_k.SLAB_NM_FIRST
    assert slab_k.slab_nm_kernel(torch.bfloat16, 2, 4,
                                 slab_k.NM_TC_MIN_ROWS) is slab_k.SLAB_NM


def test_slab_nm_counters_are_per_library():
    """#2's two libraries count on their own keys in ops.launch_counts,
    under one C name."""
    from repro_torch.kernels import slab_matmul as slab_k
    counts = ops.launch_counts()
    assert {"slab_nm_matmul", "slab_nm_matmul@slab_matmul.cu"} <= set(counts)
    assert slab_k.SLAB_NM.name == slab_k.SLAB_NM_FIRST.name
    assert (slab_k.SLAB_NM.source, slab_k.SLAB_NM_FIRST.source) == (
        "grouped_tc.cu", "slab_matmul.cu")
    slab_k.SLAB_NM.launches = 3
    assert ops.launch_counts()["slab_nm_matmul"] == 3
    assert ops.launch_counts()["slab_nm_matmul@slab_matmul.cu"] == 0
    ops.reset_launch_counts()


@pytest.mark.parametrize("n,k,n_sm", [
    (4096, 4096, 132), (1024, 4096, 132), (11008, 4096, 132),
    (4096, 11008, 132), (6400, 4096, 132), (32, 256, 132), (4096, 96, 132),
    (100000, 4096, 132), (100000, 11008, 132), (4096, 4096, 1),
    (1024, 4096, 78)])
def test_nm_split_plan_covers_every_column_once(n, k, n_sm):
    """plan_nm_splits is a function of the shapes alone: n_split ≥ 1 runs
    of cps whole 128-column chunks (the last may be shorter) cover
    columns 0 .. K - 1 once, no run is empty or longer than
    NM_MAX_SPLIT_CHUNKS chunks, and there are no more runs than
    chunks."""
    from repro_torch.kernels import slab_matmul as slab_k
    n_split, cps = slab_k.plan_nm_splits(n, k, n_sm)
    assert n_split >= 1 and cps >= 1
    runs = [(s * cps * 128, min(k, (s + 1) * cps * 128))
            for s in range(n_split)]
    assert all(lo < hi for lo, hi in runs)
    assert cps <= slab_k.NM_MAX_SPLIT_CHUNKS
    cover = np.zeros(k, dtype=int)
    for lo, hi in runs:
        cover[lo:hi] += 1
    assert (cover == 1).all()
    assert n_split <= -(-k // 128)
    assert slab_k.plan_nm_splits(n, k, n_sm) == (n_split, cps)


@pytest.mark.parametrize("n,k", [(4096, 4096), (1024, 4096)])
def test_nm_split_plan_fills_the_card(n, k):
    """At llama2-7b's q/k/v/o (4096, 4096) and phi3.5-moe's k/v (1024,
    4096) projections, whose 128-row tiles alone give 32 and 8 blocks,
    the split gives at least one block to each of an H100's 132 SMs."""
    from repro_torch.kernels import slab_matmul as slab_k
    n_split, _ = slab_k.plan_nm_splits(n, k, 132)
    assert n_split > 1
    assert -(-n // 128) * n_split >= 132


@pytest.mark.parametrize("n,k,want", [
    ((4096, 4096, (8, 4))), ((1024, 4096, (32, 1))),
    ((11008, 4096, (4, 8)))], ids=str)
def test_nm_split_plan_at_one_expert_is_unchanged(n, k, want):
    """#2's plan (one expert) on an H100's 132 SMs is what it was before
    plan_nm_splits counted experts: llama2-7b's (4096, 4096) and
    (11008, 4096), phi3.5-moe's (1024, 4096)."""
    from repro_torch.kernels import slab_matmul as slab_k
    assert slab_k.plan_nm_splits(n, k, 132) == want
    assert slab_k.plan_nm_splits(n, k, 132, 1) == want


@pytest.mark.parametrize("n,k,e,want", [
    (6400, 4096, 16, (2, 16)), (4096, 6400, 16, (4, 16)),
    (1408, 2048, 64, (1, 16)), (2048, 1408, 64, (1, 11)),
    (1408, 2048, 1, (16, 1))], ids=str)
def test_nm_split_plan_counts_every_experts_tiles(n, k, e, want):
    """With E experts the row tiles of all of them fill the card, so at
    phi3.5-moe's 16 experts K is split only to keep a split within
    NM_MAX_SPLIT_CHUNKS chunks (a tile of x and x ⊙ v_r that fits two
    blocks an SM); deepseek-moe-16b's 64 need no split."""
    from repro_torch.kernels import slab_matmul as slab_k
    assert slab_k.plan_nm_splits(n, k, 132, e) == want
    n_split, cps = want
    assert cps <= slab_k.NM_MAX_SPLIT_CHUNKS
    assert (n_split - 1) * cps * 128 < k <= n_split * cps * 128


@pytest.mark.parametrize("n,e,n_split,n_sm,want", [
    (1408, 64, 1, 132, 3), (2048, 64, 1, 132, 4), (6400, 16, 2, 132, 7),
    (4096, 1, 8, 132, 1), (300, 64, 1, 132, 1), (1408, 64, 1, 1, 11),
    (100000, 1, 1, 132, 3)], ids=str)
def test_tiles_per_block_plan(n, e, n_split, n_sm, want):
    """plan_tiles_per_block: the fewest row tiles a block that bring the
    launch to at most NM_SPLIT_BLOCKS_PER_SM blocks an SM, from shapes
    alone: deepseek-moe-16b's 64 experts at (1408, 2048) and (2048, 1408)
    walk 3 and 4 tiles a block (256 blocks for 132 SMs); launches that do
    not fill the card walk one; never more than an expert's tiles."""
    from repro_torch.kernels import slab_matmul as slab_k
    tpb = slab_k.plan_tiles_per_block(n, e, n_split, n_sm)
    assert tpb == want
    tiles = -(-n // 128)
    assert 1 <= tpb <= tiles
    blocks = e * n_split * -(-tiles // tpb)
    if tpb < tiles:
        assert blocks <= slab_k.NM_SPLIT_BLOCKS_PER_SM * n_sm
    if tpb > 1:
        assert e * n_split * -(-tiles // (tpb - 1)) \
            > slab_k.NM_SPLIT_BLOCKS_PER_SM * n_sm



# ------------------ #8's and #7's library choice, split plan and arithmetic


@pytest.mark.parametrize("kernel", ["nm_matmul", "slab_nm_lr_matmul"])
@pytest.mark.parametrize("dtype,pattern,m,source", [
    (torch.bfloat16, (2, 4), 1, "grouped_tc.cu"),
    (torch.bfloat16, (2, 4), 4, "grouped_tc.cu"),
    (torch.bfloat16, (4, 8), 8, "grouped_tc.cu"),
    (torch.bfloat16, (4, 8), 128, "grouped_tc.cu"),
    (torch.bfloat16, (1, 4), 4, "first"),
    (torch.bfloat16, (2, 8), 4, "first"),
    (torch.float32, (2, 4), 4, "first"),
    (torch.float32, (4, 8), 128, "first")])
def test_nm_and_nm_lr_library_choice(kernel, dtype, pattern, m, source):
    """bf16 2:4 / 4:8 #8 and #7 run grouped_tc.cu's kernel from their row
    crossovers (NM_TC_MIN_ROWS, NM_LR_TC_MIN_ROWS); f32 and the other
    patterns the first design (nm_sparse.cu, slab_matmul.cu), each on its
    own counter under one C name."""
    from repro_torch.kernels import nm_sparse as nm_k
    from repro_torch.kernels import slab_matmul as slab_k
    if kernel == "nm_matmul":
        kern = nm_k.nm_kernel(dtype, *pattern, m)
        lo, first = nm_k.NM_TC_MIN_ROWS, "nm_sparse.cu"
    else:
        kern = slab_k.slab_nm_lr_kernel(dtype, *pattern, m)
        lo, first = slab_k.NM_LR_TC_MIN_ROWS, "slab_matmul.cu"
    want = source if source == "first" or m < lo else "grouped_tc.cu"
    want = first if want == "first" else want
    assert kern.source == want and kern.name == kernel
    assert kern.key == (kernel if want == "grouped_tc.cu"
                        else f"{kernel}@{first}")


@pytest.mark.parametrize("rank", [1, 3, 5])
@pytest.mark.parametrize("n,k,m", [(4096, 4096, 4), (1024, 4096, 37),
                                   (2048, 2816, 128)], ids=str)
def test_nm_lr_scratch_holds_partial_projections(monkeypatch, n, k, m,
                                                 rank):
    """grouped_tc.cu's #7 at any rank (slab_nm_lr_kernel does not look at
    it): with K split, tc_plan's scratch holds the (n_split, M, N)
    partial sums and after them the (n_split, ⌈N/128⌉, M, R) partial
    projections, and one ticket per block column (an H100's 132 SMs)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import slab_matmul as slab_k
    monkeypatch.setattr(build, "sm_count", lambda index: 132)
    monkeypatch.setattr(slab_k, "_SCRATCH", {})
    assert slab_k.slab_nm_lr_kernel(torch.bfloat16, 2, 4, m) \
        is slab_k.SLAB_NM_LR
    dev = torch.device("cpu")
    n_split, cps, tpb, part, tickets = slab_k.tc_plan(dev, 1, m, n, k,
                                                      rank=rank)
    assert (n_split, cps) == slab_k.plan_nm_splits(n, k, 132) and tpb == 1
    cols = -(-n // 128)
    assert n_split > 1
    assert part.numel() >= n_split * m * n + n_split * cols * m * rank
    assert tickets.numel() >= cols and not tickets.any()
    assert slab_k.tc_plan(dev, 1, m, n, k)[3].numel() >= n_split * m * n


def test_nm_and_nm_lr_below_the_crossover():
    """Fewer rows than the crossover run the first design (#8, #7, #9,
    #15)."""
    from repro_torch.kernels import binlr as binlr_k
    from repro_torch.kernels import grouped as g_k
    from repro_torch.kernels import nm_sparse as nm_k
    from repro_torch.kernels import slab_matmul as slab_k
    for m in range(0, binlr_k.BINLR_TC_MIN_ROWS):
        assert binlr_k.binlr_kernel(torch.bfloat16, m) is binlr_k.BINLR_FIRST
    for m in range(0, g_k.NM_G_TC_MIN_ROWS):
        assert g_k.nm_g_kernel(torch.bfloat16, 2, 4, m) is g_k.NM_G_FIRST
    assert binlr_k.binlr_kernel(torch.bfloat16, binlr_k.BINLR_TC_MIN_ROWS) \
        is binlr_k.BINLR
    assert g_k.nm_g_kernel(torch.bfloat16, 4, 8, g_k.NM_G_TC_MIN_ROWS) \
        is g_k.NM_G
    for m in range(0, nm_k.NM_TC_MIN_ROWS):
        assert nm_k.nm_kernel(torch.bfloat16, 2, 4, m) is nm_k.NM_FIRST
    for m in range(0, slab_k.NM_LR_TC_MIN_ROWS):
        assert slab_k.slab_nm_lr_kernel(torch.bfloat16, 2, 4, m) \
            is slab_k.SLAB_NM_LR_FIRST
    assert nm_k.nm_kernel(torch.bfloat16, 4, 8, nm_k.NM_TC_MIN_ROWS) \
        is nm_k.NM
    assert slab_k.slab_nm_lr_kernel(torch.bfloat16, 4, 8,
                                    slab_k.NM_LR_TC_MIN_ROWS) \
        is slab_k.SLAB_NM_LR


@pytest.mark.parametrize("kernel", ["nm_matmul", "slab_nm_lr_matmul",
                                    "binlr_matmul", "nm_matmul_g"])
def test_nm_and_nm_lr_counters_are_per_library(kernel):
    """#8's, #7's, #9's and #15's two libraries count on their own keys
    in ops.launch_counts, under one C name."""
    from repro_torch.kernels import binlr as binlr_k
    from repro_torch.kernels import grouped as g_k
    from repro_torch.kernels import nm_sparse as nm_k
    from repro_torch.kernels import slab_matmul as slab_k
    new, first, src = {
        "nm_matmul": (nm_k.NM, nm_k.NM_FIRST, "nm_sparse.cu"),
        "slab_nm_lr_matmul": (slab_k.SLAB_NM_LR, slab_k.SLAB_NM_LR_FIRST,
                              "slab_matmul.cu"),
        "binlr_matmul": (binlr_k.BINLR, binlr_k.BINLR_FIRST,
                         "slab_matmul.cu"),
        "nm_matmul_g": (g_k.NM_G, g_k.NM_G_FIRST, "nm_sparse.cu")}[kernel]
    counts = ops.launch_counts()
    assert {kernel, f"{kernel}@{src}"} <= set(counts)
    assert new.name == first.name == kernel
    assert (new.source, first.source) == ("grouped_tc.cu", src)
    new.launches = 5
    assert ops.launch_counts()[kernel] == 5
    assert ops.launch_counts()[f"{kernel}@{src}"] == 0
    ops.reset_launch_counts()


# the (N, K) of the per-linear #8 / #7 launches on the main path: llama2-7b
# (phases e, i), phi3.5-moe's attention (p) and deepseek-moe-16b's
# attention and shared MLP (v); the plan on an H100's 132 SMs
PATH_SPLITS = [((4096, 4096), (8, 4)), ((11008, 4096), (4, 8)),
               ((4096, 11008), (9, 10)), ((1024, 4096), (32, 1)),
               ((2048, 2048), (16, 1)), ((2816, 2048), (8, 2)),
               ((2048, 2816), (11, 2))]


@pytest.mark.parametrize("shape,want", PATH_SPLITS, ids=str)
def test_nm_split_plan_at_the_path_shapes(shape, want):
    """At every (N, K) that phases e, i, p and v give #8 and #7, the split
    gives each of an H100's 132 SMs at least one block of 128 rows, its
    runs cover K once, and none is longer than NM_MAX_SPLIT_CHUNKS
    chunks."""
    from repro_torch.kernels import slab_matmul as slab_k
    n, k = shape
    assert slab_k.plan_nm_splits(n, k, 132) == want
    n_split, cps = want
    assert n_split > 1 and cps <= slab_k.NM_MAX_SPLIT_CHUNKS
    assert (n_split - 1) * cps * 128 < k <= n_split * cps * 128
    assert -(-n // 128) * n_split >= 132


def _nm_lr_np(seed, m, n, k, rank, pattern):
    """Seeded numpy x, N:M-pruned W, u (R, N), v (R, K)."""
    rng = np.random.default_rng(seed)
    n_keep, m_pat = map(int, pattern.split(":"))
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    g = np.abs(w).reshape(n, k // m_pat, m_pat)
    thr = -np.sort(-g, axis=-1)[..., n_keep - 1:n_keep]
    w = np.where((g >= thr).reshape(n, k), w, 0.0).astype(np.float32)
    u = (rng.standard_normal((rank, n)) * 0.2).astype(np.float32)
    v = (rng.standard_normal((rank, k)) * 0.2).astype(np.float32)
    return x, w, u, v


@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("rank", [1, 3])
@pytest.mark.parametrize("k,cps,pattern", [
    (256, 1, "2:4"), (384, 1, "4:8"), (320, 1, "2:4"), (512, 2, "4:8")],
    ids=str)
def test_nm_lr_split_arithmetic_matches_reference(k, cps, pattern, rank, m):
    """grouped_tc.cu's #7 under a split of K (slab_nm_lr_split_plain: each
    split's partial W_S sum and partial projection, both summed in split
    order, then acc + p·U rounded once) against the reference kernel in
    interpret mode on the same numpy inputs: 2 or 3 splits, the last one
    shorter at K 320, f32 at max|diff| / max|ref| < 1e-5."""
    from repro.kernels import slab_matmul as ref_slab
    from repro_torch.kernels import slab_matmul as slab_k
    n = 96
    n_keep, m_pat = map(int, pattern.split(":"))
    x, w, u, v = _nm_lr_np(300 + k + rank + m, m, n, k, rank, pattern)
    nm = ref_packing.pack_nm(jnp.asarray(w), n_keep, m_pat)
    want = ref_slab.slab_nm_lr_matmul(
        jnp.asarray(x), nm.values, nm.indices, m_pat, jnp.asarray(u),
        jnp.asarray(v), interpret=True)
    n_split = -(-k // (cps * 128))
    assert n_split in (2, 3)
    tt = functools.partial(bridge.tensor, device="cpu")
    got = slab_k.slab_nm_lr_split_plain(tt(x), tt(nm.values),
                                        tt(nm.indices), m_pat, tt(u), tt(v),
                                        n_split, cps)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert _rel(got, want) < TOL
    one = slab_k.slab_nm_lr_matmul_plain(tt(x), tt(nm.values),
                                         tt(nm.indices), m_pat, tt(u), tt(v))
    assert _rel(got, one) < TOL


# ------------- #1's and #5's library choice, split plan and arithmetic


@pytest.mark.parametrize("kernel", ["slab_ell_matmul", "ell_lr_matmul"])
@pytest.mark.parametrize("dtype,m,k,r,idx_bytes,source", [
    (torch.bfloat16, 1, 4096, 1, 2, "grouped_tc.cu"),
    (torch.bfloat16, 4, 4096, 1, 4, "grouped_tc.cu"),
    (torch.bfloat16, 128, 11008, 1, 2, "grouped_tc.cu"),
    (torch.bfloat16, 4, 11008, 1, 4, "grouped_tc.cu"),
    (torch.bfloat16, 4, 4096, 3, 2, "grouped_tc.cu"),
    (torch.bfloat16, 4, 11008, 2, 2, "rank"),
    (torch.bfloat16, 4, 16384, 1, 2, "first"),
    (torch.float32, 4, 4096, 1, 2, "first"),
    (torch.float32, 37, 2048, 3, 4, "first")])
def test_ell_lin_library_choice(kernel, dtype, m, k, r, idx_bytes, source):
    """bf16 #1 and #5 run grouped_tc.cu's split gather from their row
    crossovers where ell_split_smem fits an H100 block: all of x at K
    11008, not at 16384; #1's x ⊙ v_r tiles of the widest split also at
    rank 1 (not 2) at K 11008, #5's projection at any of these ranks. f32
    runs the first design (ell.cu), each library on its own counter under
    one C name."""
    from repro_torch.kernels import ell as ell_k
    binary = kernel == "slab_ell_matmul"
    pick = ell_k.slab_ell_kernel if binary else ell_k.ell_lr_kernel
    lo = ell_k.SLAB_ELL_TC_MIN_ROWS if binary else ell_k.ELL_LR_TC_MIN_ROWS
    kern = pick(dtype, m, k, r, idx_bytes)
    new = source == "grouped_tc.cu" or (source == "rank" and not binary)
    want = "grouped_tc.cu" if new and m >= lo else "ell.cu"
    assert kern.source == want and kern.name == kernel
    assert kern.key == (kernel if want == "grouped_tc.cu"
                        else f"{kernel}@ell.cu")
    if dtype == torch.bfloat16:
        fits = ell_k.ell_split_smem(k, r, idx_bytes, binary) \
            <= slab_k.TC_SMEM
        assert fits == new


def test_ell_lin_below_the_crossover():
    """Fewer rows than the crossover run the first design."""
    from repro_torch.kernels import ell as ell_k
    for m in range(0, ell_k.SLAB_ELL_TC_MIN_ROWS):
        assert ell_k.slab_ell_kernel(torch.bfloat16, m, 4096) \
            is ell_k.SLAB_ELL_FIRST
    for m in range(0, ell_k.ELL_LR_TC_MIN_ROWS):
        assert ell_k.ell_lr_kernel(torch.bfloat16, m, 4096) \
            is ell_k.ELL_LR_FIRST
    assert ell_k.slab_ell_kernel(torch.bfloat16,
                                 ell_k.SLAB_ELL_TC_MIN_ROWS, 4096) \
        is ell_k.SLAB_ELL
    assert ell_k.ell_lr_kernel(torch.bfloat16, ell_k.ELL_LR_TC_MIN_ROWS,
                               4100) is ell_k.ELL_LR


@pytest.mark.parametrize("kernel", ["slab_ell_matmul", "ell_lr_matmul"])
def test_ell_lin_counters_are_per_library(kernel):
    """#1's and #5's two libraries count on their own keys in
    ops.launch_counts, under one C name."""
    from repro_torch.kernels import ell as ell_k
    new, first = ((ell_k.SLAB_ELL, ell_k.SLAB_ELL_FIRST)
                  if kernel == "slab_ell_matmul"
                  else (ell_k.ELL_LR, ell_k.ELL_LR_FIRST))
    counts = ops.launch_counts()
    assert {kernel, f"{kernel}@ell.cu"} <= set(counts)
    assert new.name == first.name == kernel
    assert (new.source, first.source) == ("grouped_tc.cu", "ell.cu")
    new.launches = 5
    assert ops.launch_counts()[kernel] == 5
    assert ops.launch_counts()[f"{kernel}@ell.cu"] == 0
    ops.reset_launch_counts()


# the (N, K, K_max) of the per-linear #1 / #5 launches on the main path:
# llama2-7b's slab-ell (phase a; K_max 0.437·K) and lowrank-ell (g; K/2),
# phi3.5-moe's attention (m) and deepseek-moe-16b's attention and shared
# MLP (r; t at K/2); the plan on an H100's 132 SMs
ELL_PATH_SPLITS = [
    ((4096, 4096, 1789, True), (8, 256, 4)),
    ((11008, 4096, 1789, True), (3, 640, 11)),
    ((4096, 11008, 4810, True), (8, 640, 11)),
    ((1024, 4096, 1789, True), (29, 64, 2)),
    ((2048, 2048, 894, True), (15, 64, 2)),
    ((2816, 2048, 894, True), (8, 128, 2)),
    ((2048, 2816, 1230, True), (10, 128, 3)),
    ((4096, 4096, 2048, False), (7, 320, 0)),
    ((11008, 4096, 2048, False), (3, 704, 0)),
    ((4096, 11008, 5504, False), (8, 704, 0)),
    ((2048, 2048, 1024, False), (9, 128, 0)),
    ((2816, 2048, 1024, False), (9, 128, 0)),
    ((2048, 2816, 1408, False), (12, 128, 0))]


@pytest.mark.parametrize("shape,want", ELL_PATH_SPLITS, ids=str)
def test_ell_split_plan_at_the_path_shapes(shape, want):
    """At every (N, K, K_max) that phases a, g, m, r and t give #1 and #5,
    the runs cover a row's entries from any 8-entry boundary once, every
    SM gets a block and none gets more than NM_SPLIT_BLOCKS_PER_SM; #1's
    column runs cover K in at most NM_MAX_SPLIT_CHUNKS chunks each."""
    n, k, k_max, binary = shape
    assert slab_k.plan_ell_splits(n, k, k_max, 132, binary) == want
    n_split, epb, cps = want
    assert n_split > 1 and epb % slab_k.ELL_STEP == 0
    assert (n_split - 1) * epb < k_max + 7 <= n_split * epb
    tiles = -(-n // slab_k.ROWS)
    assert 132 <= tiles * n_split <= slab_k.NM_SPLIT_BLOCKS_PER_SM * 132
    if binary:
        assert 0 < cps <= slab_k.NM_MAX_SPLIT_CHUNKS
        assert n_split * cps * slab_k.CHUNK >= k


@pytest.mark.parametrize("n,k,k_max,n_sm", [
    (128, 256, 1, 132), (96, 256, 113, 132), (4096, 65536, 30000, 132),
    (50000, 4096, 2048, 132), (300, 512, 200, 8)], ids=str)
def test_ell_split_plan_covers_every_entry_once(n, k, k_max, n_sm):
    """Any shape: whole steps a run, runs covering K_max + 7 entries,
    none of them past the last step that holds an entry, and for #1
    column runs of at most NM_MAX_SPLIT_CHUNKS chunks covering K (which
    may add runs past the entries: they gather zeros)."""
    for binary in (False, True):
        n_split, epb, cps = slab_k.plan_ell_splits(n, k, k_max, n_sm,
                                                   binary)
        assert n_split >= 1 and epb % slab_k.ELL_STEP == 0
        assert n_split * epb >= k_max + 7
        if not binary:
            assert (n_split - 1) * epb < k_max + 7
            assert cps == 0
        else:
            assert 0 < cps <= slab_k.NM_MAX_SPLIT_CHUNKS
            assert (n_split - 1) * cps * slab_k.CHUNK < k \
                <= n_split * cps * slab_k.CHUNK


@pytest.mark.parametrize("binary,rank", [(True, 0), (False, 1),
                                         (False, 3), (False, 5)])
def test_ell_scratch_holds_partial_sums(monkeypatch, binary, rank):
    """A split launch's scratch holds (n_split, M, N) partial sums, for
    #5 then the (n_split, row tiles, M, R) partial projections, and one
    zero ticket per row tile (an H100's 132 SMs)."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "sm_count", lambda index: 132)
    monkeypatch.setattr(slab_k, "_SCRATCH", {})
    dev = torch.device("cpu")
    n_split, epb, cps, part, tickets = slab_k.ell_plan(
        dev, 37, 1411, 1376, 601, binary, rank)
    assert (n_split, epb, cps) == slab_k.plan_ell_splits(1411, 1376, 601,
                                                         132, binary)
    assert n_split > 1
    assert part.numel() >= n_split * 37 * 1411 + n_split * 12 * 37 * rank
    assert tickets.numel() >= 12 and not tickets.any()


def _ell_np(seed, m, n, k, rank, keep=0.44):
    """Seeded numpy x, W_S keeping the top-|w| ``keep`` of each row, ±1
    W_B, u (R, N), v (R, K)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    kk = int(keep * k)
    thr = -np.sort(-np.abs(w), axis=1)[:, kk - 1:kk]
    w = np.where(np.abs(w) >= thr, w, 0.0).astype(np.float32)
    w_b = np.where(rng.random((n, k)) < 0.5, 1, -1).astype(np.int8)
    u = (rng.standard_normal((rank, n)) * 0.2).astype(np.float32)
    v = (rng.standard_normal((rank, k)) * 0.2).astype(np.float32)
    return x, w, w_b, u, v


def _shuffled_ell(w, seed):
    """Reference ELL planes of ``w``, K_max odd and past the fullest row
    (rows start off the 8-entry boundary and end in pads), with each
    row's entries in a random order (numpy, the same permutation for vals
    and ids)."""
    w = jnp.asarray(w)
    ep = ref_packing.ell_pack(w, nnz=(ref_packing.ell_row_nnz_max(w) + 2)
                              | 1)
    vals, idx = np.asarray(ep.values), np.asarray(ep.indices)
    perm = np.argsort(np.random.default_rng(seed).random(vals.shape), axis=1)
    return (np.take_along_axis(vals, perm, 1),
            np.take_along_axis(idx, perm, 1))


@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("rank", [1, 3])
@pytest.mark.parametrize("k,epb,cps", [(256, 64, 1), (384, 128, 2),
                                       (512, 128, 2)], ids=str)
def test_slab_ell_split_arithmetic_matches_reference(k, epb, cps, rank, m):
    """grouped_tc.cu's #1 under a split (slab_ell_split_plain: each
    split's run of every row plus its columns' ±1 term in one partial,
    the partials summed in split order, rounded once) against the
    reference kernel in interpret mode on the same numpy inputs, each
    row's entries shuffled: 2 or 3 splits (K_max odd: rows start off the
    8-entry boundary), f32 at max|diff| / max|ref| < 1e-5."""
    from repro.kernels import ell as ref_ell
    from repro_torch.kernels import ell as ell_k
    n = 96
    x, w, w_b, u, v = _ell_np(500 + k + rank + m, m, n, k, rank)
    vals, idx = _shuffled_ell(w, k + rank)
    bp = ref_packing.pack_sign_bits(jnp.asarray(w_b))
    want = ref_ell.slab_ell_matmul(
        jnp.asarray(x), jnp.asarray(vals), jnp.asarray(idx), bp,
        jnp.asarray(u), jnp.asarray(v), interpret=True)
    n_split = -(-(vals.shape[1] + 7) // epb)
    assert n_split in (2, 3) and vals.shape[1] % 8
    assert n_split * cps * 128 >= k
    tt = functools.partial(bridge.tensor, device="cpu")
    got = ell_k.slab_ell_split_plain(tt(x), tt(vals), tt(idx), tt(bp),
                                     tt(u), tt(v), n_split, epb, cps)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert _rel(got, want) < TOL
    one = ell_k.slab_ell_matmul_plain(tt(x), tt(vals), tt(idx), tt(bp),
                                      tt(u), tt(v))
    assert _rel(got, one) < TOL


@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("rank", [1, 3])
@pytest.mark.parametrize("k,epb", [(256, 64), (300, 128), (512, 128)],
                         ids=str)
def test_ell_lr_split_arithmetic_matches_reference(k, epb, rank, m):
    """grouped_tc.cu's #5 under a split (ell_lr_split_plain: each split's
    run of every row summed in split order, then acc + p·U rounded once)
    against the reference kernel in interpret mode on the same numpy
    inputs, each row's entries shuffled: 2 or 3 splits, K 300 off every
    multiple of 8, f32 at max|diff| / max|ref| < 1e-5."""
    from repro.kernels import ell as ref_ell
    from repro_torch.kernels import ell as ell_k
    n = 96
    x, w, _, u, v = _ell_np(600 + k + rank + m, m, n, k, rank, keep=0.5)
    vals, idx = _shuffled_ell(w, k + rank + 1)
    want = ref_ell.ell_lr_matmul(
        jnp.asarray(x), jnp.asarray(vals), jnp.asarray(idx),
        jnp.asarray(u), jnp.asarray(v), interpret=True)
    n_split = -(-(vals.shape[1] + 7) // epb)
    assert n_split in (2, 3)
    tt = functools.partial(bridge.tensor, device="cpu")
    got = ell_k.ell_lr_split_plain(tt(x), tt(vals), tt(idx), tt(u), tt(v),
                                   n_split, epb)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert _rel(got, want) < TOL
    one = ell_k.ell_lr_matmul_plain(tt(x), tt(vals), tt(idx), tt(u), tt(v))
    assert _rel(got, one) < TOL


# ------------- #3's and #16's library choice, split plan and arithmetic


@pytest.mark.parametrize("grouped", [False, True], ids=("3", "16"))
@pytest.mark.parametrize("dtype,m,r,new", [
    (torch.bfloat16, 1, 1, True), (torch.bfloat16, 2, 1, True),
    (torch.bfloat16, 4, 3, True), (torch.bfloat16, 128, 5, True),
    (torch.bfloat16, 4, 19, True), (torch.bfloat16, 4, 20, False),
    (torch.float32, 4, 1, False), (torch.float32, 37, 3, False)])
def test_slab_dense_library_choice(grouped, dtype, m, r, new):
    """bf16 #3 and #16 run grouped_tc.cu's DenseSrc body from their row
    crossovers up to the rank where one chunk of x and x ⊙ v_r beside the
    2-stage ring no longer lets two blocks share an SM (dense_split_cap:
    rank 19); f32 and higher ranks the first design (slab_matmul.cu), each
    library on its own counter under one C name."""
    from repro_torch.kernels import grouped as g_k
    if grouped:
        kern, lo = g_k.slab_g_kernel(dtype, m, r), g_k.SLAB_G_TC_MIN_ROWS
        name = "slab_matmul_g"
    else:
        kern = slab_k.slab_dense_kernel(dtype, m, r)
        lo, name = slab_k.SLAB_DENSE_TC_MIN_ROWS, "slab_matmul"
    want = "grouped_tc.cu" if new and m >= lo else "slab_matmul.cu"
    assert kern.source == want and kern.name == name
    assert kern.key == (name if want == "grouped_tc.cu"
                        else f"{name}@slab_matmul.cu")
    assert (slab_k.dense_split_cap(r) >= 1) == (r <= 19)


def test_slab_dense_below_the_crossover():
    """Fewer rows than the crossover run the first design."""
    from repro_torch.kernels import grouped as g_k
    for m in range(0, slab_k.SLAB_DENSE_TC_MIN_ROWS):
        assert slab_k.slab_dense_kernel(torch.bfloat16, m) \
            is slab_k.SLAB_DENSE_FIRST
    for m in range(0, g_k.SLAB_G_TC_MIN_ROWS):
        assert g_k.slab_g_kernel(torch.bfloat16, m) is g_k.SLAB_G_FIRST
    assert slab_k.slab_dense_kernel(
        torch.bfloat16, slab_k.SLAB_DENSE_TC_MIN_ROWS) is slab_k.SLAB_DENSE
    assert g_k.slab_g_kernel(torch.bfloat16, g_k.SLAB_G_TC_MIN_ROWS) \
        is g_k.SLAB_G


@pytest.mark.parametrize("grouped", [False, True], ids=("3", "16"))
def test_slab_dense_counters_are_per_library(grouped):
    """#3's and #16's two libraries count on their own keys in
    ops.launch_counts, under one C name."""
    from repro_torch.kernels import grouped as g_k
    new, first = ((g_k.SLAB_G, g_k.SLAB_G_FIRST) if grouped
                  else (slab_k.SLAB_DENSE, slab_k.SLAB_DENSE_FIRST))
    counts = ops.launch_counts()
    assert {new.key, f"{new.name}@slab_matmul.cu"} <= set(counts)
    assert new.name == first.name
    assert (new.source, first.source) == ("grouped_tc.cu", "slab_matmul.cu")
    new.launches = 4
    assert ops.launch_counts()[new.key] == 4
    assert ops.launch_counts()[first.key] == 0
    ops.reset_launch_counts()


@pytest.mark.parametrize("r,m,cap", [(1, 1, 11), (1, 8, 11), (3, 4, 5),
                                     (1, 16, 5), (1, 128, 2), (5, 128, 1),
                                     (19, 1, 1)], ids=str)
def test_dense_split_cap_fits_two_blocks(r, m, cap):
    """The widest run of chunks whose tiles (the n-tiles M needs, as
    tc::pick_tc picks them, fewer where none fits) and a 2-stage ring of
    16 rows of 256 bytes for each of 8 warps, with 1024 bytes to align it,
    fit half an H100 SM's 228 KB less its 1 KB a block: 11 chunks at rank
    1 (#2's widest run of 16 would not), 5 at rank 3."""
    assert slab_k.DENSE_RING == 2 * 8 * 16 * 256 + 1024
    assert slab_k.TC_SMEM_HALF == 115712
    assert slab_k.dense_split_cap(r, m) == cap
    ntp = next(t for t in range(min(-(-m // 8), 4), 0, -1)
               if slab_k.dense_tc_smem(r, 1, t) <= slab_k.TC_SMEM_HALF)
    assert slab_k.dense_tc_smem(r, cap, ntp) <= slab_k.TC_SMEM_HALF \
        < slab_k.dense_tc_smem(r, cap + 1, ntp)
    assert slab_k.dense_tc_smem(1, 16) > slab_k.TC_SMEM_HALF


# the (N, K, E, rank) of the #3 / #16 launches on the main path (M <= 8):
# llama2-7b's attention and MLP (phase c), phi3.5-moe's attention and
# experts (o); the plan on an H100's 132 SMs
DENSE_PATH_SPLITS = [
    ((4096, 4096, 1, 1), (8, 4)), ((11008, 4096, 1, 1), (3, 11)),
    ((4096, 11008, 1, 1), (8, 11)), ((1024, 4096, 1, 1), (32, 1)),
    ((6400, 4096, 16, 1), (3, 11)), ((4096, 6400, 16, 1), (5, 11)),
    ((4096, 11008, 1, 3), (18, 5)), ((6400, 4096, 16, 3), (7, 5))]


@pytest.mark.parametrize("shape,want", DENSE_PATH_SPLITS, ids=str)
def test_dense_split_plan_at_the_path_shapes(shape, want):
    """At every (N, K) that phases c and o give #3 and #16, the split
    covers K once in runs no wider than dense_split_cap, so two blocks
    share an SM; at rank 1 #3's fills the card in one wave (at least one
    block of 128 rows for each SM, at most two), #16's 16 experts fill it
    unsplit and split only to fit, as rank 3's narrower runs do."""
    n, k, e, r = shape
    cap = slab_k.dense_split_cap(r, 4)
    assert slab_k.plan_dense_splits(n, k, 132, e, cap) == want
    n_split, cps = want
    assert cps <= cap and (n_split - 1) * cps * 128 < k <= n_split * cps * 128
    assert slab_k.dense_tc_smem(r, cps) <= slab_k.TC_SMEM_HALF
    tiles = e * -(-n // 128)
    assert tiles * n_split >= 132
    if cps < cap:
        assert tiles * n_split <= 2 * 132
    else:
        assert n_split == -(-k // (cap * 128))


def _dense_np(seed, e, m, n, k, rank):
    """Seeded numpy x (E, M, K), W_S keeping about 44 % of each row, ±1
    W_B, u (E, R, N), v (E, R, K)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, m, k)).astype(np.float32)
    w = (rng.standard_normal((e, n, k)) * 0.1).astype(np.float32)
    w = np.where(rng.random((e, n, k)) < 0.44, w, 0.0).astype(np.float32)
    w_b = np.where(rng.random((e, n, k)) < 0.5, 1, -1).astype(np.int8)
    u = (rng.standard_normal((e, rank, n)) * 0.2).astype(np.float32)
    v = (rng.standard_normal((e, rank, k)) * 0.2).astype(np.float32)
    return x, w, w_b, u, v


@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("rank", [1, 3])
@pytest.mark.parametrize("k,cps", [(256, 1), (320, 1), (512, 2)], ids=str)
def test_slab_dense_split_arithmetic_matches_reference(k, cps, rank, m):
    """grouped_tc.cu's #3 under a split of K (slab_dense_split_plain: each
    split's W_S sum and ±1 term over its columns in one partial, the
    partials summed in split order, rounded once) against the reference
    kernel in interpret mode on the same numpy inputs: 2 or 3 splits, the
    last one shorter at K 320, f32 at max|diff| / max|ref| < 1e-5."""
    from repro.kernels import slab_matmul as ref_slab
    n = 96
    x, w, w_b, u, v = (a[0] for a in _dense_np(700 + k + rank + m, 1, m, n,
                                                k, rank))
    bp = ref_packing.pack_sign_bits(jnp.asarray(w_b))
    want = ref_slab.slab_matmul(jnp.asarray(x), jnp.asarray(w), bp,
                                jnp.asarray(u), jnp.asarray(v),
                                interpret=True)
    n_split = -(-k // (cps * 128))
    assert n_split in (2, 3)
    tt = functools.partial(bridge.tensor, device="cpu")
    got = slab_k.slab_dense_split_plain(tt(x), tt(w), tt(bp), tt(u), tt(v),
                                        n_split, cps)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert _rel(got, want) < TOL
    one = slab_k.slab_matmul_plain(tt(x), tt(w), tt(bp), tt(u), tt(v))
    assert _rel(got, one) < TOL


@pytest.mark.parametrize("rank", [1, 3])
@pytest.mark.parametrize("k,cps,m", [(256, 1, 1), (384, 1, 5)], ids=str)
def test_slab_dense_g_split_arithmetic_matches_reference(k, cps, m, rank):
    """#16 under a split of K, each expert's partials summed in split order
    (slab_dense_split_plain per expert), against the reference's grouped
    kernel in interpret mode: 3 experts, 2 or 3 splits, f32 at
    max|diff| / max|ref| < 1e-5."""
    from repro.kernels import grouped as ref_g
    e, n = 3, 96
    x, w, w_b, u, v = _dense_np(800 + k + rank + m, e, m, n, k, rank)
    bp = np.stack([np.asarray(ref_packing.pack_sign_bits(jnp.asarray(b)))
                   for b in w_b])
    want = ref_g.slab_matmul_g(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(bp), jnp.asarray(u),
                               jnp.asarray(v), interpret=True)
    n_split = -(-k // (cps * 128))
    assert n_split in (2, 3)
    tt = functools.partial(bridge.tensor, device="cpu")
    got = torch.stack([slab_k.slab_dense_split_plain(
        tt(x[i]), tt(w[i]), tt(bp[i]), tt(u[i]), tt(v[i]), n_split, cps)
        for i in range(e)])
    assert got.shape == (e, m, n) and got.dtype == torch.float32
    assert _rel(got, want) < TOL


# ------------- #4's and #6's library choice, split plan and arithmetic


@pytest.mark.parametrize("dtype,m,k,idx_bytes,new", [
    (torch.bfloat16, 3, 4096, 2, True), (torch.bfloat16, 4, 4096, 4, True),
    (torch.bfloat16, 128, 11008, 2, True),
    (torch.bfloat16, 4, 11008, 4, True), (torch.bfloat16, 4, 4100, 2, True),
    (torch.bfloat16, 2, 4096, 2, True), (torch.bfloat16, 1, 4096, 2, True),
    (torch.bfloat16, 4, 16384, 2, False),
    (torch.bfloat16, 4, 12480, 2, False),
    (torch.float32, 4, 4096, 2, False), (torch.float32, 37, 2048, 4, False)],
    ids=str)
def test_ell_library_choice(dtype, m, k, idx_bytes, new):
    """bf16 #4 runs grouped_tc.cu's split gather from ELL_TC_MIN_ROWS rows
    (2) where x and the ring fit an H100 block (``new``: ell_split_smem at
    rank 0, 208 KB at K 11008 with uint16 ids, 225 KB with uint32; not at
    K 12480 or 16384), at any K; below the crossover, past that K and at
    f32 the first design (ell.cu), each library on its own counter under
    one C name."""
    from repro_torch.kernels import ell as ell_k
    assert ell_k.ELL_TC_MIN_ROWS == 2
    kern = ell_k.ell_kernel(dtype, m, k, idx_bytes)
    want = "grouped_tc.cu" if new and m >= ell_k.ELL_TC_MIN_ROWS \
        else "ell.cu"
    assert kern.source == want and kern.name == "ell_matmul"
    assert kern.key == ("ell_matmul" if want == "grouped_tc.cu"
                        else "ell_matmul@ell.cu")
    if dtype == torch.bfloat16:
        assert (ell_k.ell_split_smem(k, 0, idx_bytes) <= slab_k.TC_SMEM) \
            == new
    assert ell_k.ell_split_smem(11008, 0, 2) == 11016 * 16 + 4 * 2 * 256 * 16


@pytest.mark.parametrize("dtype,m,k,r,new", [
    (torch.bfloat16, 1, 4096, 1, True), (torch.bfloat16, 4, 4096, 3, True),
    (torch.bfloat16, 128, 11008, 1, True),
    (torch.bfloat16, 4, 2056, 163, True),
    (torch.bfloat16, 4, 4100, 1, False), (torch.bfloat16, 4, 4099, 1, False),
    (torch.bfloat16, 4, 4096, 164, False),
    (torch.float32, 4, 4096, 1, False), (torch.float32, 37, 2048, 3, False)],
    ids=str)
def test_slab_lr_library_choice(dtype, m, k, r, new):
    """bf16 #6 runs grouped_tc.cu's DenseSrc body from SLAB_LR_TC_MIN_ROWS
    rows at K % 8 == 0 (the tensor map's row stride) up to the rank whose
    projection sums beside one chunk of x and the 2-stage ring no longer
    let two blocks share an SM (dense_split_cap's low-rank form: rank
    163); f32, other K and higher ranks the first design
    (slab_matmul.cu), each library on its own counter under one C
    name."""
    kern = slab_k.slab_lr_kernel(dtype, m, k, r)
    want = "grouped_tc.cu" if new and m >= slab_k.SLAB_LR_TC_MIN_ROWS \
        else "slab_matmul.cu"
    assert kern.source == want and kern.name == "slab_lr_matmul"
    assert kern.key == ("slab_lr_matmul" if want == "grouped_tc.cu"
                        else "slab_lr_matmul@slab_matmul.cu")
    assert (slab_k.dense_split_cap(r, lowrank=True) >= 1) == (r <= 163)


def test_ell_and_slab_lr_below_the_crossover():
    """Fewer rows than the crossover run the first design."""
    from repro_torch.kernels import ell as ell_k
    for m in range(0, ell_k.ELL_TC_MIN_ROWS):
        assert ell_k.ell_kernel(torch.bfloat16, m, 4096) is ell_k.ELL_FIRST
    for m in range(0, slab_k.SLAB_LR_TC_MIN_ROWS):
        assert slab_k.slab_lr_kernel(torch.bfloat16, m, 4096) \
            is slab_k.SLAB_LR_FIRST
    assert ell_k.ell_kernel(torch.bfloat16, ell_k.ELL_TC_MIN_ROWS, 4100) \
        is ell_k.ELL
    assert slab_k.slab_lr_kernel(torch.bfloat16, slab_k.SLAB_LR_TC_MIN_ROWS,
                                 4096) is slab_k.SLAB_LR


@pytest.mark.parametrize("kernel", ["ell_matmul", "slab_lr_matmul"])
def test_ell_and_slab_lr_counters_are_per_library(kernel):
    """#4's and #6's two libraries count on their own keys in
    ops.launch_counts, under one C name."""
    from repro_torch.kernels import ell as ell_k
    new, first, src = ((ell_k.ELL, ell_k.ELL_FIRST, "ell.cu")
                       if kernel == "ell_matmul" else
                       (slab_k.SLAB_LR, slab_k.SLAB_LR_FIRST,
                        "slab_matmul.cu"))
    counts = ops.launch_counts()
    assert {kernel, f"{kernel}@{src}"} <= set(counts)
    assert new.name == first.name == kernel
    assert (new.source, first.source) == ("grouped_tc.cu", src)
    new.launches = 3
    assert ops.launch_counts()[kernel] == 3
    assert ops.launch_counts()[f"{kernel}@{src}"] == 0
    first.launches = 2
    assert ops.launch_counts()[kernel] == 3
    ops.reset_launch_counts()
    assert not ops.launch_counts()[kernel]


# the (N, K, K_max) of the per-linear #4 launches on the main path: llama2-7b
# at CR 0.6 (phase f; K_max 0.4·K) and deepseek-moe-16b's attention and
# shared MLP (s); the plan on an H100's 132 SMs
ELL4_PATH_SPLITS = [
    ((4096, 4096, 1638), (7, 256)), ((11008, 4096, 1638), (3, 576)),
    ((4096, 11008, 4403), (8, 576)), ((2048, 2048, 819), (13, 64)),
    ((2816, 2048, 819), (7, 128)), ((2048, 2816, 1126), (9, 128))]


@pytest.mark.parametrize("shape,want", ELL4_PATH_SPLITS, ids=str)
def test_ell4_split_plan_at_the_path_shapes(shape, want):
    """At every (N, K, K_max) that phases f and s give #4, each row's
    entries split (no second term: the plan without column runs), the
    runs cover a row's entries from any 8-entry boundary once, and every
    SM gets a block and none more than NM_SPLIT_BLOCKS_PER_SM."""
    n, k, k_max = shape
    n_split, epb = want
    assert slab_k.plan_ell_splits(n, k, k_max, 132) == (n_split, epb, 0)
    assert n_split > 1 and epb % slab_k.ELL_STEP == 0
    assert (n_split - 1) * epb < k_max + 7 <= n_split * epb
    tiles = -(-n // slab_k.ROWS)
    assert 132 <= tiles * n_split <= slab_k.NM_SPLIT_BLOCKS_PER_SM * 132


def test_ell4_scratch_holds_partial_sums(monkeypatch):
    """#4's split launch asks ell_plan for (n_split, M, N) partial sums
    and one zero ticket per row tile, no projection (rank 0)."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "sm_count", lambda index: 132)
    monkeypatch.setattr(slab_k, "_SCRATCH", {})
    dev = torch.device("cpu")
    n_split, epb, cps, part, tickets = slab_k.ell_plan(dev, 4, 4096, 4096,
                                                       1638)
    assert (n_split, epb, cps) == (7, 256, 0)
    assert part.numel() >= 7 * 4 * 4096 and part.dtype == torch.float32
    assert tickets.numel() >= 32 and not tickets.any()


# the (N, K) of the per-linear #6 launches on the main path: llama2-7b
# (phase h) and deepseek-moe-16b's attention and shared MLP (u), at M 4;
# the plan on an H100's 132 SMs, ranks 1 and 3
LR6_PATH_SPLITS = [
    ((4096, 4096), (8, 4)), ((11008, 4096), (3, 11)),
    ((4096, 11008), (8, 11)), ((2048, 2048), (16, 1)),
    ((2816, 2048), (8, 2)), ((2048, 2816), (11, 2))]


@pytest.mark.parametrize("rank", [1, 3])
@pytest.mark.parametrize("shape,want", LR6_PATH_SPLITS, ids=str)
def test_slab_lr_split_plan_at_the_path_shapes(monkeypatch, shape, want,
                                               rank):
    """tc_plan plans #6 by plan_dense_splits with dense_split_cap's
    low-rank form (23 chunks at M 4, ranks 1 and 3: #3's ±1 tiles would
    cap rank 3 at 5): one wave, every SM a block, at most two; runs
    cover K once; the scratch holds the partial sums and after them the
    (n_split, ⌈N/128⌉, M, R) partial projections."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "sm_count", lambda index: 132)
    monkeypatch.setattr(slab_k, "_SCRATCH", {})
    n, k = shape
    m = 4
    cap = slab_k.dense_split_cap(rank, m, lowrank=True)
    assert cap == 23 and slab_k.dense_split_cap(rank, m) < cap
    n_split, cps, tpb, part, tickets = slab_k.tc_plan(
        torch.device("cpu"), 1, m, n, k, rank=rank, dense_rank=rank)
    assert (n_split, cps) == want and tpb == 1
    assert (n_split - 1) * cps * 128 < k <= n_split * cps * 128
    tiles = -(-n // 128)
    assert 132 <= tiles * n_split <= 2 * 132
    assert part.numel() >= n_split * m * n + n_split * tiles * m * rank
    assert tickets.numel() >= tiles and not tickets.any()


@pytest.mark.parametrize("r,m,cap", [(1, 1, 23), (1, 8, 23), (3, 4, 23),
                                     (1, 16, 11), (1, 37, 5), (3, 128, 5),
                                     (64, 1, 14), (163, 1, 1)], ids=str)
def test_slab_lr_split_cap_fits_two_blocks(r, m, cap):
    """dense_tc_smem's low-rank form is tc::pick_tc<DenseSrc, LR>'s count:
    the n-tiles' rows of x over the run plus 8 columns at 2 bytes, the
    projection's sums p (r, 8·ntp) and the 8 warps' (8, r, 8·ntp) in fp32
    rounded up to 16 bytes, and the 2-stage ring with its 1024 bytes of
    alignment (no x ⊙ v_r tiles, no u); its widest run fits half an H100
    SM's 228 KB less 1 KB a block, and one chunk more does not."""
    def pick_tc(ntp, cps):
        kp = cps * 128
        lr = -(-(8 + 1) * r * 8 * ntp * 4 // 16) * 16
        return 8 * ntp * (kp + 8) * 2 + lr + 2 * 8 * 4096 + 1024
    assert slab_k.dense_split_cap(r, m, lowrank=True) == cap
    ntp = next(t for t in range(min(-(-m // 8), 4), 0, -1)
               if pick_tc(t, 1) <= slab_k.TC_SMEM_HALF)
    for cps in (1, cap, cap + 1):
        assert slab_k.dense_tc_smem(r, cps, ntp, lowrank=True) \
            == pick_tc(ntp, cps)
    assert pick_tc(ntp, cap) <= slab_k.TC_SMEM_HALF < pick_tc(ntp, cap + 1)
    assert 2 * (pick_tc(ntp, cap) + 1024) <= 228 * 1024


@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("wide", [False, True], ids=("uint16", "uint32"))
@pytest.mark.parametrize("k,epb", [(256, 64), (300, 128), (512, 128)],
                         ids=str)
def test_ell_split_arithmetic_matches_reference(k, epb, wide, m):
    """grouped_tc.cu's #4 under a split of each row's entries
    (ell_lr_split_plain with no low-rank term: each split's run of every
    row, the partial sums added in split order, rounded once) against the
    reference kernel in interpret mode on the same numpy inputs: N 97
    (odd), each row's entries shuffled, K_max odd, uint16 or uint32 ids,
    2 or 3 splits, f32 at max|diff| / max|ref| < 1e-5."""
    from repro.kernels import ell as ref_ell
    from repro_torch.kernels import ell as ell_k
    n = 97
    x, w, _, _, _ = _ell_np(900 + k + m + wide, m, n, k, 1, keep=0.4)
    vals, idx = _shuffled_ell(w, k + m)
    if wide:
        idx = idx.astype(np.uint32)
    want = ref_ell.ell_matmul(jnp.asarray(x), jnp.asarray(vals),
                              jnp.asarray(idx), interpret=True)
    n_split = -(-(vals.shape[1] + 7) // epb)
    assert n_split in (2, 3) and vals.shape[1] % 2
    tt = functools.partial(bridge.tensor, device="cpu")
    ti = tt(idx)
    assert ti.element_size() == (4 if wide else 2)
    got = ell_k.ell_lr_split_plain(tt(x), tt(vals), ti, None, None, n_split,
                                   epb)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert _rel(got, want) < TOL
    assert _rel(ell_k.ell_matmul_plain(tt(x), tt(vals), ti), got) < TOL
    assert _rel(ops.ell_matmul(tt(x), tt(vals), ti), want) < TOL


@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("rank", [1, 3])
@pytest.mark.parametrize("k,cps", [(256, 1), (320, 1), (512, 2)], ids=str)
def test_slab_lr_split_arithmetic_matches_reference(k, cps, rank, m):
    """grouped_tc.cu's #6 under a split of K (slab_lr_split_plain: each
    split's partial W_S sum and partial projection, both summed in split
    order, then acc + p·U rounded once) against the reference kernel in
    interpret mode on the same numpy inputs: N 97 (odd), 2 or 3 splits,
    the last one shorter at K 320, ranks 1 and 3, f32 at max|diff| /
    max|ref| < 1e-5."""
    from repro.kernels import slab_matmul as ref_slab
    n = 97
    x, w, _, u, v = (a[0] for a in _dense_np(1000 + k + rank + m, 1, m, n,
                                              k, rank))
    want = ref_slab.slab_lr_matmul(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(u), jnp.asarray(v),
                                   interpret=True)
    n_split = -(-k // (cps * 128))
    assert n_split in (2, 3)
    tt = functools.partial(bridge.tensor, device="cpu")
    got = slab_k.slab_lr_split_plain(tt(x), tt(w), tt(u), tt(v), n_split,
                                     cps)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert _rel(got, want) < TOL
    one = slab_k.slab_lr_matmul_plain(tt(x), tt(w), tt(u), tt(v))
    assert _rel(got, one) < TOL


# ------------- #9's and #15's library choice, split plan and arithmetic


@pytest.mark.parametrize("dtype,m,r,new", [
    (torch.bfloat16, 1, 1, True), (torch.bfloat16, 4, 3, True),
    (torch.bfloat16, 37, 4, True), (torch.bfloat16, 4, 5, False),
    (torch.float32, 4, 1, False), (torch.float32, 1, 3, False)], ids=str)
def test_binlr_library_choice(dtype, m, r, new):
    """bf16 #9 runs grouped_tc.cu's ±1 body (#20's, at one expert) from
    BINLR_TC_MIN_ROWS rows up to rank TC_MAX_RANK (4: an accumulator a
    rank in registers); f32 and rank 5 the first design (slab_matmul.cu),
    each library on its own counter under one C name."""
    from repro_torch.kernels import binlr as binlr_k
    kern = binlr_k.binlr_kernel(dtype, m, r)
    want = ("grouped_tc.cu" if new and m >= binlr_k.BINLR_TC_MIN_ROWS
            else "slab_matmul.cu")
    assert kern.source == want and kern.name == "binlr_matmul"
    assert kern.key == ("binlr_matmul" if want == "grouped_tc.cu"
                        else "binlr_matmul@slab_matmul.cu")
    assert binlr_k.TC_MAX_RANK == 4


# the (N, K) of #9's launches on the main path (M 4): llama2-7b (phase j)
# and deepseek-moe-16b's attention and shared MLP (w); (n_split, cps, row
# tiles a block) on an H100's 132 SMs
BINLR_PATH_PLANS = [
    ((4096, 4096), (8, 4, 1)), ((11008, 4096), (4, 8, 2)),
    ((4096, 11008), (9, 10, 2)), ((2048, 2048), (16, 1, 1)),
    ((2816, 2048), (8, 2, 1)), ((2048, 2816), (11, 2, 1))]


@pytest.mark.parametrize("shape,want", BINLR_PATH_PLANS, ids=str)
def test_binlr_split_plan_at_the_path_shapes(monkeypatch, shape, want):
    """At every (N, K) that phases j and w give #9, tc_plan (walk, as
    #20's) splits K into runs that cover it once, each no longer than
    NM_MAX_SPLIT_CHUNKS chunks, and lets a block walk the fewest row
    tiles that bring the launch to one wave of at most two blocks an SM;
    the scratch holds (n_split, M, N) partial sums and a ticket for each
    block column."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "sm_count", lambda index: 132)
    monkeypatch.setattr(slab_k, "_SCRATCH", {})
    n, k = shape
    m = 4
    n_split, cps, tpb, part, tickets = slab_k.tc_plan(
        torch.device("cpu"), 1, m, n, k, walk=True)
    assert (n_split, cps, tpb) == want
    assert cps <= slab_k.NM_MAX_SPLIT_CHUNKS
    assert (n_split - 1) * cps * 128 < k <= n_split * cps * 128
    cols = -(-(-(-n // 128)) // tpb)
    assert n_split * cols <= 2 * 132
    assert part.numel() >= n_split * m * n
    assert tickets.numel() >= cols and not tickets.any()


@pytest.mark.parametrize("shape,want", [((6400, 4096), (2, 16)),
                                        ((4096, 6400), (4, 16))], ids=str)
def test_nm_g_split_plan_at_the_path_shapes(monkeypatch, shape, want):
    """phi3.5-moe's 16 experts (phase p) fill the card unsplit, so #15's
    K is split only to keep a run within NM_MAX_SPLIT_CHUNKS chunks: 2
    runs of 16 at (6400, 4096), 4 at (4096, 6400) (the last shorter);
    no block walks tiles, and the scratch holds (n_split, E, M, N)
    partial sums and a ticket for each expert and block column."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "sm_count", lambda index: 132)
    monkeypatch.setattr(slab_k, "_SCRATCH", {})
    n, k = shape
    e, m = 16, 2
    n_split, cps, tpb, part, tickets = slab_k.tc_plan(
        torch.device("cpu"), e, m, n, k)
    assert (n_split, cps) == want and tpb == 1
    assert (n_split - 1) * cps * 128 < k <= n_split * cps * 128
    runs = [(s * cps * 128, min(k, (s + 1) * cps * 128))
            for s in range(n_split)]
    cover = np.zeros(k, dtype=int)
    for lo, hi in runs:
        cover[lo:hi] += 1
    assert (cover == 1).all()
    assert part.numel() >= n_split * e * m * n
    assert tickets.numel() >= e * -(-n // 128) and not tickets.any()


@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("rank", [1, 3])
@pytest.mark.parametrize("k,cps", [(256, 1), (320, 1), (512, 2)], ids=str)
def test_binlr_split_arithmetic_matches_reference(k, cps, rank, m):
    """grouped_tc.cu's #9 under a split of K (slab_dense_split_plain with
    no W_S: each split's ±1 term over its columns, the partials summed in
    split order, rounded once) against the reference kernel in interpret
    mode on the same numpy inputs: 2 or 3 splits, the last one shorter at
    K 320, f32 at max|diff| / max|ref| < 1e-5."""
    from repro.kernels import binlr as ref_binlr
    n = 96
    x, _, w_b, u, v = (a[0] for a in _dense_np(1100 + k + rank + m, 1, m,
                                                n, k, rank))
    bp = ref_packing.pack_sign_bits(jnp.asarray(w_b))
    want = ref_binlr.binlr_matmul(jnp.asarray(x), bp, jnp.asarray(u),
                                  jnp.asarray(v), interpret=True)
    n_split = -(-k // (cps * 128))
    assert n_split in (2, 3)
    tt = functools.partial(bridge.tensor, device="cpu")
    got = slab_k.slab_dense_split_plain(tt(x), None, tt(bp), tt(u), tt(v),
                                        n_split, cps)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert _rel(got, want) < TOL
    from repro_torch.kernels import binlr as binlr_k
    one = binlr_k.binlr_matmul_plain(tt(x), tt(bp), tt(u), tt(v))
    assert _rel(got, one) < TOL


@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("pattern", ["2:4", "4:8"])
@pytest.mark.parametrize("k,cps", [(256, 1), (320, 1)], ids=str)
def test_nm_g_split_arithmetic_matches_reference(k, cps, pattern, m):
    """grouped_tc.cu's #15 under a split of K, each expert's partial W_S
    sums added in split order and rounded once (slab_nm_lr_split_plain
    with no low-rank term, per expert) against the reference's grouped
    kernel in interpret mode on the same numpy inputs: 3 experts, 2 or 3
    splits, the last one shorter at K 320, f32 at max|diff| / max|ref| <
    1e-5."""
    from repro.kernels import grouped as ref_g
    e, n = 3, 96
    n_keep, m_pat = map(int, pattern.split(":"))
    planes = [_nm_lr_np(1200 + k + m + i, m, n, k, 1, pattern)
              for i in range(e)]
    x = np.stack([p[0] for p in planes])
    packed = [ref_packing.pack_nm(jnp.asarray(p[1]), n_keep, m_pat)
              for p in planes]
    vals = np.stack([np.asarray(p.values) for p in packed])
    idx = np.stack([np.asarray(p.indices) for p in packed])
    want = ref_g.nm_matmul_g(jnp.asarray(x), jnp.asarray(vals),
                             jnp.asarray(idx), m_pat, interpret=True)
    n_split = -(-k // (cps * 128))
    assert n_split in (2, 3)
    tt = functools.partial(bridge.tensor, device="cpu")
    got = torch.stack([slab_k.slab_nm_lr_split_plain(
        tt(x[i]), tt(vals[i]), tt(idx[i]), m_pat, None, None, n_split, cps)
        for i in range(e)])
    assert got.shape == (e, m, n) and got.dtype == torch.float32
    assert _rel(got, want) < TOL
    from repro_torch.kernels import grouped as g_k
    one = g_k.nm_matmul_g_plain(tt(x), tt(vals), tt(idx), m_pat)
    assert _rel(got, one) < TOL


@pytest.mark.parametrize("pattern", ["2:4", "4:8"])
@pytest.mark.parametrize("k,cps", [(256, 1), (320, 1)], ids=str)
def test_nm_split_arithmetic_matches_reference(k, cps, pattern):
    """#8 under a split of K (slab_nm_lr_split_plain with no low-rank
    term) against the reference kernel in interpret mode: 2 or 3 splits,
    M 5, f32 at max|diff| / max|ref| < 1e-5."""
    from repro.kernels import nm_sparse as ref_nm
    n_keep, m_pat = map(int, pattern.split(":"))
    x, w, _, _ = _nm_lr_np(1300 + k, 5, 96, k, 1, pattern)
    nm = ref_packing.pack_nm(jnp.asarray(w), n_keep, m_pat)
    want = ref_nm.nm_matmul(jnp.asarray(x), nm.values, nm.indices, m_pat,
                            interpret=True)
    tt = functools.partial(bridge.tensor, device="cpu")
    got = slab_k.slab_nm_lr_split_plain(tt(x), tt(nm.values),
                                        tt(nm.indices), m_pat, None, None,
                                        -(-k // (cps * 128)), cps)
    assert got.shape == (5, 96) and _rel(got, want) < TOL
