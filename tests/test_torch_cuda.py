"""The port's CUDA kernels against their plain PyTorch versions, on a
card only: slab_ell_matmul (#1), slab_nm_matmul (#2), slab_matmul (#3),
ell_matmul (#4), ell_lr_matmul (#5), slab_lr_matmul (#6),
slab_nm_lr_matmul (#7), nm_matmul (#8),
binlr_matmul (#9), flash_decode (#10) and flash_decode_paged (#11), and
the grouped ell_matmul_g (#12), ell_lr_matmul_g (#13),
slab_ell_matmul_g (#14), slab_matmul_g (#16), slab_nm_matmul_g (#17),
slab_lr_matmul_g (#18), slab_nm_lr_matmul_g (#19) and binlr_matmul_g
(#20), whose bf16 launches (#2, #7, #8, #15 and #17 at 2:4 and 4:8) run
the kernels of csrc/grouped_tc.cu; #1-#9, #15, #16, #17, #18 and #20
also through each of their two libraries, #2, #3, #6, #7, #8, #9, #15,
#16 and #17 with K split across blocks, #1, #4 and #5 with each row's
entries split across blocks and #9 and #20 with blocks walking several
row tiles (two launches bitwise equal; #4, #6, #9, #10, #11 and #15 over
20 launches). Every test skips without a card (the kernels
are CUDA C++ for sm_90a with no CPU mode).

This file imports neither JAX nor the reference package, so it runs on
a machine with PyTorch alone:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerance: max|kernel - plain| <= tol · max|plain|, tol 1e-5 at f32 and
2e-2 at bf16 (accumulation order differs; bf16 rounds its inputs).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import packing, sparsity
from repro_torch.kernels import binlr as binlr_k
from repro_torch.kernels import ell as ell_k
from repro_torch.kernels import flash_decode as fd_k
from repro_torch.kernels import grouped as g_k
from repro_torch.kernels import nm_sparse as nm_k
from repro_torch.kernels import slab_matmul as slab_k
from repro_torch.models.attention import _quantize_token

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# (KV, G, dh): stablelm-12b, an MHA cut, qwen2-vl-2b (G 6: the kernel's
# G 8 instantiation) and nemotron-4-340b (G 12: its G 16 instantiation)
FD_LAYOUTS = [(8, 4, 160), (4, 1, 128), (2, 6, 128), (8, 12, 192)]
FD_IDS = ("gqa-dh160", "mha-dh128", "g6-dh128", "g12-dh192")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a "
                    "and have no CPU mode")
    return torch.device("cuda")


def _close(got, want, dtype):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[dtype] * float(want.float().abs().max()), err


def _randn(rng, *shape, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32))


@pytest.mark.parametrize("pattern,rank", [("2:4", 1), ("4:8", 3)])
@pytest.mark.parametrize("m", [1, 4, 37])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_slab_nm_lr_matmul_kernel_matches_plain(cuda, dt, m, pattern, rank):
    dtype = DTYPES[dt]
    rng = np.random.default_rng(m + rank)
    n, k = 1000, 1032
    n_keep, m_pat = map(int, pattern.split(":"))
    w = _randn(rng, n, k, scale=0.05)
    w_nm = torch.where(sparsity.nm_mask(w.abs(), n_keep, m_pat), w, 0.0)
    nm = packing.pack_nm(w_nm.to(dtype), n_keep, m_pat, strict=True)
    x = _randn(rng, m, k).to(dtype).to(cuda)
    u = _randn(rng, rank, n, scale=0.2).to(dtype).to(cuda)
    v = _randn(rng, rank, k, scale=0.2).to(dtype).to(cuda)
    vals, idx = nm.values.to(cuda), nm.indices.to(cuda)
    got = slab_k.slab_nm_lr_matmul(x, vals, idx, m_pat, u, v)
    _close(got, slab_k.slab_nm_lr_matmul_plain(x, vals, idx, m_pat, u, v),
           dtype)


@pytest.mark.parametrize("rank", [1, 3])
@pytest.mark.parametrize("m", [1, 4, 37])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_binlr_matmul_kernel_matches_plain(cuda, dt, m, rank):
    dtype = DTYPES[dt]
    rng = np.random.default_rng(10 + m + rank)
    n, k = 1000, 1024
    signs = torch.from_numpy(np.where(rng.random((n, k)) < 0.5, 1,
                                      -1).astype(np.int8))
    bp = packing.pack_sign_bits(signs).to(cuda)
    x = _randn(rng, m, k).to(dtype).to(cuda)
    u = _randn(rng, rank, n, scale=0.2).to(dtype).to(cuda)
    v = _randn(rng, rank, k, scale=0.2).to(dtype).to(cuda)
    got = binlr_k.binlr_matmul(x, bp, u, v)
    _close(got, binlr_k.binlr_matmul_plain(x, bp, u, v), dtype)


def _cache(rng, r, s, kv, g, dh, dtype, quant, dev):
    q = (_randn(rng, r, kv, g, dh) * dh ** -0.5).to(dtype).to(dev)
    k, v = _randn(rng, r, s, kv, dh).to(dev), _randn(rng, r, s, kv, dh).to(dev)
    if quant:
        (k, ks), (v, vs) = _quantize_token(k), _quantize_token(v)
        return q, k, v, ks, vs
    return q, k.to(dtype), v.to(dtype), None, None


@pytest.mark.parametrize("quant", [False, True], ids=("model", "int8"))
@pytest.mark.parametrize("layout", FD_LAYOUTS, ids=FD_IDS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_flash_decode_kernel_matches_plain(cuda, dt, layout, quant):
    """S = 300 with the reference chunk 64 (S_pad 320); a length-0 row
    (the padded-span mean), a chunk boundary and the full cache."""
    dtype = DTYPES[dt]
    kv, g, dh = layout
    rng = np.random.default_rng(20)
    q, k, v, ks, vs = _cache(rng, 4, 300, kv, g, dh, dtype, quant, cuda)
    lens = torch.tensor([0, 64, 65, 300], dtype=torch.int32, device=cuda)
    got = fd_k.flash_decode(q, k, v, lens, ks, vs, bs=64)
    _close(got, fd_k.flash_decode_plain(q, k, v, lens, ks, vs, bs=64),
           dtype)
    assert fd_k.FLASH_DECODE.launches > 0


@pytest.mark.parametrize("paged", [False, True], ids=("contig", "paged"))
def test_flash_decode_wide_group_matches_plain(cuda, paged):
    """G 32 at dh 256: its merge buffers pass one block's shared memory,
    so the kernel takes the query heads in chunks (grid z)."""
    rng = np.random.default_rng(22)
    q, k, v, _, _ = _cache(rng, 3, 96, 2, 32, 256, torch.bfloat16, False,
                           cuda)
    lens = torch.tensor([1, 50, 96], dtype=torch.int32, device=cuda)
    if paged:
        bs = 16
        pool = lambda t: t.reshape(3 * 96 // bs, bs, *t.shape[2:])
        tables = torch.arange(3 * 96 // bs, dtype=torch.int32,
                              device=cuda).reshape(3, -1)
        args = (q, pool(k), pool(v), tables, lens)
        got = fd_k.flash_decode_paged(*args)
        want = fd_k.flash_decode_paged_plain(*args)
    else:
        got = fd_k.flash_decode(q, k, v, lens, bs=32)
        want = fd_k.flash_decode_plain(q, k, v, lens, bs=32)
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("quant", [False, True], ids=("model", "int8"))
@pytest.mark.parametrize("layout", FD_LAYOUTS, ids=FD_IDS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_flash_decode_paged_kernel_matches_plain(cuda, dt, layout, quant):
    """Scattered blocks of 16, lengths 0 / 1 / 16 / 17 / 80, junk table
    entries past each length; the empty row returns exact zeros."""
    dtype = DTYPES[dt]
    kv, g, dh = layout
    rng = np.random.default_rng(21)
    r, bs, n_bt, n_blocks = 5, 16, 5, 40
    q, k, v, ks, vs = _cache(rng, r, n_bt * bs, kv, g, dh, dtype, quant,
                             cuda)
    perm = torch.from_numpy(rng.permutation(n_blocks)[:r * n_bt]).to(cuda)

    def pool(t):
        if t is None:
            return None
        out = torch.zeros((n_blocks, bs) + tuple(t.shape[2:]),
                          dtype=t.dtype, device=cuda)
        out[perm] = t.reshape((r * n_bt, bs) + tuple(t.shape[2:]))
        return out

    lens = torch.tensor([0, 1, 16, 17, 80], dtype=torch.int32, device=cuda)
    tables = perm.reshape(r, n_bt).to(torch.int32)
    used = torch.arange(n_bt, device=cuda)[None, :] * bs < lens[:, None]
    tables = torch.where(used, tables, torch.full_like(tables, n_blocks - 1))
    args = (q, pool(k), pool(v), tables.contiguous(), lens, pool(ks),
            pool(vs))
    got = fd_k.flash_decode_paged(*args)
    _close(got, fd_k.flash_decode_paged_plain(*args), dtype)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


# (G, dh) across the head chunks: MHA, stablelm-12b's G 4, qwen2-vl-2b's
# G 6, nemotron-4-340b's G 12 and G 32 at dh 256 (two chunks of 16)
FD_SPLIT_GROUPS = [(1, 128), (4, 160), (6, 128), (12, 192), (32, 256)]


def _split_case(rng, bs, g, dh, dtype, quant, paged, dev):
    """3 rows of KV 2 over 2048 slots, lengths 0 / 700 / 2048: many
    splits, a split across 700 and splits past it; (kernel, plain)."""
    r, s = 3, 2048
    q, k, v, ks, vs = _cache(rng, r, s, 2, g, dh, dtype, quant, dev)
    lens = torch.tensor([0, 700, s], dtype=torch.int32, device=dev)
    n_split, _ = fd_k.plan_splits(r, 2, -(-g // fd_k.head_chunk(g, dh)), s,
                                  fd_k._sm_count(dev.index or 0))
    assert n_split > 1
    if not paged:
        return (lambda: fd_k.flash_decode(q, k, v, lens, ks, vs, bs=bs),
                lambda: fd_k.flash_decode_plain(q, k, v, lens, ks, vs,
                                                bs=bs))
    n_bt = s // bs
    perm = torch.from_numpy(rng.permutation(r * n_bt + 5)[:r * n_bt]).to(dev)

    def pool(t):
        if t is None:
            return None
        out = torch.zeros((r * n_bt + 5, bs) + tuple(t.shape[2:]),
                          dtype=t.dtype, device=dev)
        out[perm] = t.reshape((r * n_bt, bs) + tuple(t.shape[2:]))
        return out

    args = (q, pool(k), pool(v),
            perm.reshape(r, n_bt).to(torch.int32).contiguous(), lens,
            pool(ks), pool(vs))
    return (lambda: fd_k.flash_decode_paged(*args),
            lambda: fd_k.flash_decode_paged_plain(*args))


@pytest.mark.parametrize("paged", [False, True], ids=("contig", "paged"))
@pytest.mark.parametrize("bs", [16, 32, 512])
@pytest.mark.parametrize("gdh", FD_SPLIT_GROUPS, ids=str)
def test_flash_decode_splits_match_plain(cuda, gdh, bs, paged):
    """Rows far longer than a split, at every query-head group; the same
    launch twice is bitwise equal (splits merge in order, no atomics)."""
    g, dh = gdh
    rng = np.random.default_rng(23 + g + bs)
    kern, plain = _split_case(rng, bs, g, dh, torch.bfloat16, False, paged,
                              cuda)
    got = kern()
    _close(got, plain(), torch.bfloat16)
    assert torch.equal(got, kern())
    if paged:
        assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.parametrize("quant", [False, True], ids=("model", "int8"))
@pytest.mark.parametrize("paged", [False, True], ids=("contig", "paged"))
def test_flash_decode_splits_f32_match_plain(cuda, paged, quant):
    """The f32 and int8 caches through the split path (the engine's f32
    phases run it token-exact)."""
    rng = np.random.default_rng(24)
    kern, plain = _split_case(rng, 16, 4, 160, torch.float32, quant, paged,
                              cuda)
    _close(kern(), plain(), torch.float32)


@pytest.mark.parametrize("quant", [False, True], ids=("model", "int8"))
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("paged", [False, True], ids=("contig", "paged"))
def test_flash_decode_odd_head_width_matches_plain(cuda, paged, dt, quant):
    """dh 40, not a multiple of 16: rows are copied element by element
    into zero-padded tiles instead of by bulk copies."""
    rng = np.random.default_rng(25)
    kern, plain = _split_case(rng, 16, 3, 40, DTYPES[dt], quant, paged,
                              cuda)
    _close(kern(), plain(), DTYPES[dt])


# grouped #14 / #19 at 1-32 rows per expert: (N, K) off the 128-row
# block and the 128-column chunk (N 1411; #14 K 1376, whose sign words are
# not whole 16-byte loads; #19 K 1412, whose N:M rows start off 16 bytes)
# and deepseek-moe-16b's (1408, 2048). Planes are made on the card from a
# seeded generator (numpy at E 64 x 1408 x 2048 takes minutes).
G_M = [1, 3, 5, 6, 8, 9, 16, 20, 32]
G_E = [1, 7, 64]


def _g_shape(e, k_odd):
    return (1408, 2048) if e == 64 else (1411, k_odd)


def _g_randn(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen, device=gen.device) * scale


@pytest.mark.parametrize("e", G_E)
@pytest.mark.parametrize("m", G_M)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_slab_ell_matmul_g_kernel_matches_plain(cuda, dt, m, e):
    """Rank 3 at odd M, else 1; uint32 ids at E 7, else uint16; K_max
    three past the fullest row, so every row ends in ELL pads."""
    dtype = DTYPES[dt]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(100 + m + e)
    n, k = _g_shape(e, 1376)
    rank = 3 if m % 2 else 1
    w = _g_randn(gen, e * n, k, scale=0.05)
    ws = torch.where(_g_randn(gen, e * n, k) > 0.25, w, 0.0)
    ell = packing.ell_pack(ws.to(dtype),
                           nnz=packing.ell_row_nnz_max(ws) + 3)
    vals = ell.values.reshape(e, n, -1).contiguous()
    idx = ell.indices.reshape(e, n, -1).contiguous()
    if e == 7:
        idx = packing.as_unsigned(idx).int()
    signs = torch.where(_g_randn(gen, e * n, k) >= 0, 1, -1).to(torch.int8)
    bp = packing.pack_sign_bits(signs).reshape(e, n, k // 32)
    x = _g_randn(gen, e, m, k).to(dtype)
    u = _g_randn(gen, e, rank, n, scale=0.2).to(dtype)
    v = _g_randn(gen, e, rank, k, scale=0.2).to(dtype)
    kern = g_k.slab_ell_g_kernel(dtype, m)
    assert kern is (g_k.SLAB_ELL_G if dtype == torch.bfloat16
                    and m >= g_k.TC_MIN_ROWS else g_k.SLAB_ELL_G_FIRST)
    launches = kern.launches
    got = g_k.slab_ell_matmul_g(x, vals, idx, bp, u, v)
    assert kern.launches == launches + 1
    _close(got, g_k.slab_ell_matmul_g_plain(x, vals, idx, bp, u, v), dtype)


@pytest.mark.parametrize("order", ["reversed", "duplicates"])
def test_slab_ell_matmul_g_any_entry_order(cuda, order):
    """The ELL format does not promise sorted ids: reversed rows, and
    rows whose entries repeat a column (their values add), give the
    plain version's result."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    e, n, k, m = 3, 300, 512, 6
    w = _g_randn(gen, e * n, k, scale=0.05)
    ws = torch.where(_g_randn(gen, e * n, k) > 0.25, w, 0.0)
    ell = packing.ell_pack(ws.to(torch.bfloat16))
    vals, idx = ell.values, ell.indices
    if order == "reversed":
        vals, idx = vals.flip(1), idx.flip(1)
    else:        # every third entry takes its left neighbour's column
        idx = idx.clone()
        idx[:, 3::3] = idx[:, 2:-1:3][:, :idx[:, 3::3].shape[1]]
    vals = vals.reshape(e, n, -1).contiguous()
    idx = idx.reshape(e, n, -1).contiguous()
    signs = torch.where(_g_randn(gen, e * n, k) >= 0, 1, -1).to(torch.int8)
    bp = packing.pack_sign_bits(signs).reshape(e, n, k // 32)
    x = _g_randn(gen, e, m, k).to(torch.bfloat16)
    u = _g_randn(gen, e, 1, n, scale=0.2).to(torch.bfloat16)
    v = _g_randn(gen, e, 1, k, scale=0.2).to(torch.bfloat16)
    got = g_k.slab_ell_matmul_g(x, vals, idx, bp, u, v)
    _close(got, g_k.slab_ell_matmul_g_plain(x, vals, idx, bp, u, v),
           torch.bfloat16)


@pytest.mark.parametrize("m", [1, 2, 6, 20])
@pytest.mark.parametrize("lib", ["grouped_tc", "first"])
def test_slab_ell_matmul_g_each_library(cuda, lib, m):
    """Both libraries of the bf16 #14 at the row counts the wrapper
    gives the other one (chip_smoke times both at every M)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(300 + m)
    e, (n, k) = 7, _g_shape(7, 1376)
    w = _g_randn(gen, e * n, k, scale=0.05)
    ws = torch.where(_g_randn(gen, e * n, k) > 0.25, w, 0.0)
    ell = packing.ell_pack(ws.to(torch.bfloat16))
    vals = ell.values.reshape(e, n, -1).contiguous()
    idx = ell.indices.reshape(e, n, -1).contiguous()
    signs = torch.where(_g_randn(gen, e * n, k) >= 0, 1, -1).to(torch.int8)
    bp = packing.pack_sign_bits(signs).reshape(e, n, k // 32)
    x = _g_randn(gen, e, m, k).to(torch.bfloat16)
    u = _g_randn(gen, e, 1, n, scale=0.2).to(torch.bfloat16)
    v = _g_randn(gen, e, 1, k, scale=0.2).to(torch.bfloat16)
    kern = g_k.SLAB_ELL_G if lib == "grouped_tc" else g_k.SLAB_ELL_G_FIRST
    launches = kern.launches
    got = g_k.launch_slab_ell_g(kern, x, vals, idx, bp, u, v)
    assert kern.launches == launches + 1
    _close(got, g_k.slab_ell_matmul_g_plain(x, vals, idx, bp, u, v),
           torch.bfloat16)


@pytest.mark.parametrize("pattern", ["2:4", "4:8"])
def test_slab_nm_lr_matmul_g_first_design_bf16(cuda, pattern):
    """The first design of #19 still takes bf16 2:4 / 4:8 (chip_smoke
    times it beside the tensor-core kernel)."""
    n_keep, m_pat = map(int, pattern.split(":"))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(400 + m_pat)
    e, m, (n, k) = 7, 6, _g_shape(7, 1408)
    w = _g_randn(gen, e * n, k, scale=0.05)
    w_nm = torch.where(sparsity.nm_mask(w.abs(), n_keep, m_pat), w, 0.0)
    nm = packing.pack_nm(w_nm.to(torch.bfloat16), n_keep, m_pat,
                         strict=True)
    shape = (e, n, k // m_pat, n_keep)
    vals = nm.values.reshape(shape).contiguous()
    idx = nm.indices.reshape(shape).contiguous()
    x = _g_randn(gen, e, m, k).to(torch.bfloat16)
    u = _g_randn(gen, e, 1, n, scale=0.2).to(torch.bfloat16)
    v = _g_randn(gen, e, 1, k, scale=0.2).to(torch.bfloat16)
    kern = g_k.SLAB_NM_LR_G_FIRST
    launches = kern.launches
    got = g_k.launch_slab_nm_lr_g(kern, x, vals, idx, m_pat, u, v)
    assert kern.launches == launches + 1
    _close(got, g_k.slab_nm_lr_matmul_g_plain(x, vals, idx, m_pat, u, v),
           torch.bfloat16)


@pytest.mark.parametrize("e", G_E)
@pytest.mark.parametrize("m", G_M)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_slab_nm_lr_matmul_g_kernel_matches_plain(cuda, dt, m, e):
    """2:4 at rank 1 for even M, 4:8 at rank 3 for odd M (2:4 only at K
    1412); one stored position in 50 is moved out of [0, m) (-1 or m),
    which the kernel must skip: the plain version sees that entry as a
    zero at position 0."""
    dtype = DTYPES[dt]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(200 + m + e)
    n, k = _g_shape(e, 1412)
    n_keep, m_pat = (4, 8) if m % 2 and k % 8 == 0 else (2, 4)
    rank = 3 if m % 2 else 1
    w = _g_randn(gen, e * n, k, scale=0.05)
    w_nm = torch.where(sparsity.nm_mask(w.abs(), n_keep, m_pat), w, 0.0)
    nm = packing.pack_nm(w_nm.to(dtype), n_keep, m_pat, strict=True)
    shape = (e, n, k // m_pat, n_keep)
    vals = nm.values.reshape(shape).contiguous()
    idx = nm.indices.reshape(shape).contiguous()
    bad = torch.rand(shape, generator=gen, device=cuda) < 0.02
    off = torch.where(torch.rand(shape, generator=gen, device=cuda) < 0.5,
                      -1, m_pat).to(torch.int8)
    idx_k = torch.where(bad, off, idx)
    vals_p = torch.where(bad, torch.zeros_like(vals), vals)
    idx_p = torch.where(bad, torch.zeros_like(idx), idx)
    x = _g_randn(gen, e, m, k).to(dtype)
    u = _g_randn(gen, e, rank, n, scale=0.2).to(dtype)
    v = _g_randn(gen, e, rank, k, scale=0.2).to(dtype)
    kern = g_k.slab_nm_lr_g_kernel(dtype, n_keep, m_pat)
    assert kern is (g_k.SLAB_NM_LR_G if dtype == torch.bfloat16
                    else g_k.SLAB_NM_LR_G_FIRST)
    launches = kern.launches
    got = g_k.slab_nm_lr_matmul_g(x, vals, idx_k, m_pat, u, v)
    assert kern.launches == launches + 1
    _close(got, g_k.slab_nm_lr_matmul_g_plain(x, vals_p, idx_p, m_pat, u, v),
           dtype)


# grouped #12 / #13 at 1-32 rows per expert: deepseek-moe-16b's (1408,
# 2048) at E 64; at E 1 and in a bucket of 7 experts taken out of order
# from 12, (1411, 1412): K off every multiple of 8 (rows of x start off 16
# bytes; the staged x has a zero tail) and N off the 128-row block. K_max
# is odd and past the fullest row (every row ends in ELL pads; a row's
# 16-byte alignment follows its global row); uint32 ids in the bucket.
ELL_M = [1, 2, 3, 6, 8, 9, 20, 32]


def _ell_g_operands(gen, e, m, dtype, rank):
    """x, vals, idx, u, v of ``e`` experts (7: a bucket out of order)."""
    n, k = (1408, 2048) if e == 64 else (1411, 1412)
    e_all = 12 if e == 7 else e
    w = _g_randn(gen, e_all * n, k, scale=0.05)
    ws = torch.where(_g_randn(gen, e_all * n, k) > 0.25, w, 0.0)
    ell = packing.ell_pack(ws.to(dtype),
                           nnz=(packing.ell_row_nnz_max(ws) + 2) | 1)
    vals = ell.values.reshape(e_all, n, -1)
    idx = ell.indices.reshape(e_all, n, -1)
    u = _g_randn(gen, e_all, rank, n, scale=0.2).to(dtype)
    v = _g_randn(gen, e_all, rank, k, scale=0.2).to(dtype)
    if e == 7:
        sel = torch.tensor([9, 2, 0, 11, 5, 7, 3], device=gen.device)
        vals, u, v = (t.index_select(0, sel) for t in (vals, u, v))
        idx = packing.as_unsigned(idx.index_select(0, sel)).int()
    x = _g_randn(gen, e, m, k).to(dtype)
    return (x, vals.contiguous(), idx.contiguous(), u.contiguous(),
            v.contiguous())


def _ell_g_run(kern, lowrank, x, vals, idx, u, v):
    if lowrank:
        return (g_k.launch_ell_lr_g(kern, x, vals, idx, u, v),
                g_k.ell_lr_matmul_g_plain(x, vals, idx, u, v))
    return (g_k.launch_ell_g(kern, x, vals, idx),
            g_k.ell_matmul_g_plain(x, vals, idx))


@pytest.mark.parametrize("lowrank", [False, True], ids=("ell", "ell_lr"))
@pytest.mark.parametrize("e", G_E)
@pytest.mark.parametrize("m", ELL_M)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_ell_matmul_g_kernel_matches_plain(cuda, dt, m, e, lowrank):
    """Through the wrappers; #13 at rank 3 for odd M, else 1. The launch
    counts on the library the wrapper picks."""
    dtype = DTYPES[dt]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(500 + m + e + lowrank)
    x, vals, idx, u, v = _ell_g_operands(gen, e, m, dtype,
                                         3 if m % 2 else 1)
    kern = g_k.ell_g_kernel(dtype, m, x.shape[2], lowrank)
    new = g_k.ELL_LR_G if lowrank else g_k.ELL_G
    assert (kern is new) == (dtype == torch.bfloat16
                             and m >= g_k.ELL_TC_MIN_ROWS)
    launches = kern.launches
    if lowrank:
        got = g_k.ell_lr_matmul_g(x, vals, idx, u, v)
        want = g_k.ell_lr_matmul_g_plain(x, vals, idx, u, v)
    else:
        got = g_k.ell_matmul_g(x, vals, idx)
        want = g_k.ell_matmul_g_plain(x, vals, idx)
    assert kern.launches == launches + 1
    _close(got, want, dtype)


@pytest.mark.parametrize("lowrank", [False, True], ids=("ell", "ell_lr"))
@pytest.mark.parametrize("m", [1, 2, 6, 20])
@pytest.mark.parametrize("lib", ["grouped_tc", "first"])
def test_ell_matmul_g_each_library(cuda, lib, m, lowrank):
    """Both libraries of the bf16 #12 / #13 at the row counts the wrapper
    gives the other one (chip_smoke times both at every M)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(600 + m + lowrank)
    ops_ = _ell_g_operands(gen, 7, m, torch.bfloat16, 3 if lowrank else 1)
    kern = {(False, "grouped_tc"): g_k.ELL_G, (False, "first"):
            g_k.ELL_G_FIRST, (True, "grouped_tc"): g_k.ELL_LR_G,
            (True, "first"): g_k.ELL_LR_G_FIRST}[lowrank, lib]
    launches = kern.launches
    got, want = _ell_g_run(kern, lowrank, *ops_)
    assert kern.launches == launches + 1
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("lowrank", [False, True], ids=("ell", "ell_lr"))
@pytest.mark.parametrize("lib", ["grouped_tc", "first"])
def test_ell_matmul_g_no_rows(cuda, lib, lowrank):
    """M = 0: an empty (E, 0, N) result and no launch."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(700)
    x, vals, idx, u, v = _ell_g_operands(gen, 7, 0, torch.bfloat16, 1)
    kern = {(False, "grouped_tc"): g_k.ELL_G, (False, "first"):
            g_k.ELL_G_FIRST, (True, "grouped_tc"): g_k.ELL_LR_G,
            (True, "first"): g_k.ELL_LR_G_FIRST}[lowrank, lib]
    launches = kern.launches
    got, _ = _ell_g_run(kern, lowrank, x, vals, idx, u, v)
    assert kern.launches == launches
    assert got.shape == (7, 0, vals.shape[1]) and got.dtype == torch.bfloat16


@pytest.mark.parametrize("rank", [24, 25])
def test_ell_lr_matmul_g_shared_memory_choice(cuda, rank):
    """At K 11008 with uint32 ids one tile of the gather kernel fits an
    H100 block's shared memory up to rank 24 (grouped.ell_tc_smem); at
    rank 25 the wrapper runs the first design. Both give the plain
    version's result."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(900 + rank)
    n, k, m = 200, 11008, 6
    w = _g_randn(gen, n, k, scale=0.05)
    ws = torch.where(_g_randn(gen, n, k) > 1.5, w, 0.0)
    ell = packing.ell_pack(ws.to(torch.bfloat16))
    vals = ell.values.reshape(1, n, -1).contiguous()
    idx = packing.as_unsigned(ell.indices).int().reshape(1, n, -1)
    x = _g_randn(gen, 1, m, k).to(torch.bfloat16)
    u = _g_randn(gen, 1, rank, n, scale=0.2).to(torch.bfloat16)
    v = _g_randn(gen, 1, rank, k, scale=0.2).to(torch.bfloat16)
    kern = g_k.ELL_LR_G if rank == 24 else g_k.ELL_LR_G_FIRST
    launches = kern.launches
    got = g_k.ell_lr_matmul_g(x, vals, idx.contiguous(), u, v)
    assert kern.launches == launches + 1
    _close(got, g_k.ell_lr_matmul_g_plain(x, vals, idx, u, v),
           torch.bfloat16)


@pytest.mark.parametrize("order", ["reversed", "duplicates"])
def test_ell_matmul_g_any_entry_order(cuda, order):
    """Unsorted rows, and rows that repeat a column (their values add),
    give the plain version's result on grouped_tc.cu's kernel."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(8)
    e, n, k, m = 3, 300, 500, 6
    w = _g_randn(gen, e * n, k, scale=0.05)
    ws = torch.where(_g_randn(gen, e * n, k) > 0.25, w, 0.0)
    ell = packing.ell_pack(ws.to(torch.bfloat16))
    vals, idx = ell.values, ell.indices
    if order == "reversed":
        vals, idx = vals.flip(1), idx.flip(1)
    else:        # every third entry takes its left neighbour's column
        idx = idx.clone()
        idx[:, 3::3] = idx[:, 2:-1:3][:, :idx[:, 3::3].shape[1]]
    vals = vals.reshape(e, n, -1).contiguous()
    idx = idx.reshape(e, n, -1).contiguous()
    x = _g_randn(gen, e, m, k).to(torch.bfloat16)
    launches = g_k.ELL_G.launches
    got = g_k.ell_matmul_g(x, vals, idx)
    assert g_k.ELL_G.launches == launches + 1
    _close(got, g_k.ell_matmul_g_plain(x, vals, idx), torch.bfloat16)


# #2 slab_nm_matmul (2-D) at M 0-128 through each library: N 1411 off the
# 128-row block, K 1376 off the 128-column chunk (K % 32 == 0: sign
# words); one stored position in 50 moved out of [0, m), which the kernel
# must skip (the plain version sees a zero at position 0).
NM2_M = [0, 1, 4, 6, 8, 37, 128]


def _nm2_operands(gen, n, k, m, pattern, rank, dtype):
    """x, vals, idx (with bad positions), bp, u, v and the plain
    version's vals / idx."""
    n_keep, m_pat = map(int, pattern.split(":"))
    dev = gen.device
    w = _g_randn(gen, n, k, scale=0.05)
    w_nm = torch.where(sparsity.nm_mask(w.abs(), n_keep, m_pat), w, 0.0)
    nm = packing.pack_nm(w_nm.to(dtype), n_keep, m_pat, strict=True)
    vals, idx = nm.values.contiguous(), nm.indices.contiguous()
    bad = torch.rand(vals.shape, generator=gen, device=dev) < 0.02
    off = torch.where(torch.rand(vals.shape, generator=gen, device=dev)
                      < 0.5, -1, m_pat).to(torch.int8)
    idx_k = torch.where(bad, off, idx)
    vals_p = torch.where(bad, torch.zeros_like(vals), vals)
    idx_p = torch.where(bad, torch.zeros_like(idx), idx)
    signs = torch.where(_g_randn(gen, n, k) >= 0, 1, -1).to(torch.int8)
    bp = packing.pack_sign_bits(signs)
    x = _g_randn(gen, m, k).to(dtype)
    u = _g_randn(gen, rank, n, scale=0.2).to(dtype)
    v = _g_randn(gen, rank, k, scale=0.2).to(dtype)
    return x, vals, idx_k, bp, u, v, vals_p, idx_p


@pytest.mark.parametrize("lib", ["grouped_tc", "first"])
@pytest.mark.parametrize("pattern,rank", [("2:4", 1), ("4:8", 3)])
@pytest.mark.parametrize("m", NM2_M)
def test_slab_nm_matmul_each_library(cuda, m, pattern, rank, lib):
    """bf16 through each library; M = 0 gives an empty result and no
    launch."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1000 + m + rank)
    m_pat = int(pattern.split(":")[1])
    x, vals, idx, bp, u, v, vals_p, idx_p = _nm2_operands(
        gen, 1411, 1376, m, pattern, rank, torch.bfloat16)
    kern = slab_k.SLAB_NM if lib == "grouped_tc" else slab_k.SLAB_NM_FIRST
    launches = kern.launches
    got = slab_k.launch_slab_nm(kern, x, vals, idx, m_pat, bp, u, v)
    assert kern.launches == launches + (m > 0)
    if m == 0:
        assert got.shape == (0, 1411) and got.dtype == torch.bfloat16
        return
    _close(got, slab_k.slab_nm_matmul_plain(x, vals_p, idx_p, m_pat, bp, u,
                                            v), torch.bfloat16)


@pytest.mark.parametrize("pattern", ["2:4", "4:8"])
@pytest.mark.parametrize("m", [1, 4, 37])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_slab_nm_matmul_kernel_matches_plain(cuda, dt, m, pattern):
    """Through the wrapper: the launch counts on the library
    slab_nm_kernel picks (grouped_tc.cu for bf16 from NM_TC_MIN_ROWS)."""
    dtype = DTYPES[dt]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1100 + m)
    m_pat = int(pattern.split(":")[1])
    x, vals, idx, bp, u, v, vals_p, idx_p = _nm2_operands(
        gen, 1411, 1376, m, pattern, 1, dtype)
    kern = slab_k.slab_nm_kernel(dtype, vals.shape[-1], m_pat, m)
    assert kern is (slab_k.SLAB_NM if dtype == torch.bfloat16
                    and m >= slab_k.NM_TC_MIN_ROWS else slab_k.SLAB_NM_FIRST)
    launches = kern.launches
    got = slab_k.slab_nm_matmul(x, vals, idx, m_pat, bp, u, v)
    assert kern.launches == launches + 1
    _close(got, slab_k.slab_nm_matmul_plain(x, vals_p, idx_p, m_pat, bp, u,
                                            v), dtype)


@pytest.mark.parametrize("rank", [5, 7])
def test_slab_nm_matmul_high_ranks(cuda, rank):
    """Rank 5 (past the 4 ranks whose u values stay in registers) on
    grouped_tc.cu; at rank 7 its x ⊙ v_r tiles no longer fit a block and
    the wrapper runs the first design."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1150 + rank)
    x, vals, idx, bp, u, v, vals_p, idx_p = _nm2_operands(
        gen, 1411, 1376, 6, "2:4", rank, torch.bfloat16)
    kern = slab_k.slab_nm_kernel(torch.bfloat16, 2, 4, 6, rank)
    assert kern is (slab_k.SLAB_NM if rank == 5 else slab_k.SLAB_NM_FIRST)
    launches = kern.launches
    got = slab_k.slab_nm_matmul(x, vals, idx, 4, bp, u, v)
    assert kern.launches == launches + 1
    _close(got, slab_k.slab_nm_matmul_plain(x, vals_p, idx_p, 4, bp, u, v),
           torch.bfloat16)


@pytest.mark.parametrize("pattern", ["2:4", "4:8"])
@pytest.mark.parametrize("shape", [(4096, 4096), (1024, 4096), (300, 4096)],
                         ids=str)
def test_slab_nm_matmul_splits_are_deterministic(cuda, shape, pattern):
    """llama2-7b's (4096, 4096), phi3.5-moe's (1024, 4096) and a 3-tile
    N at M 4 split K across blocks (plan_nm_splits); the last block of a
    row tile adds the partial sums in split order, so the same launch
    twice gives the same bits."""
    n, k = shape
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1200 + n)
    m_pat = int(pattern.split(":")[1])
    x, vals, idx, bp, u, v, vals_p, idx_p = _nm2_operands(
        gen, n, k, 4, pattern, 1, torch.bfloat16)
    n_split, _ = slab_k.plan_nm_splits(n, k, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert n_split > 1
    run = lambda: slab_k.launch_slab_nm(slab_k.SLAB_NM, x, vals, idx, m_pat,
                                        bp, u, v)
    got = run()
    _close(got, slab_k.slab_nm_matmul_plain(x, vals_p, idx_p, m_pat, bp, u,
                                            v), torch.bfloat16)
    for _ in range(3):
        assert torch.equal(got, run())


# grouped #18 slab_lr_matmul_g at M 0-128 through each library, E 1 and
# 3 at (1411, 1376) (N off the 128-row block, K off the 128-column chunk:
# a partial last bulk copy) and deepseek-moe-16b's 64 experts at (1408,
# 2048); rank 3 at odd M, else 1.
LR_M = [0, 1, 4, 6, 8, 37, 128]


def _lr_g_operands(gen, e, m, k, dtype, rank, n=1411):
    w = _g_randn(gen, e, n, k, scale=0.05)
    ws = torch.where(_g_randn(gen, e, n, k) > 0.5, w, 0.0).to(dtype)
    x = _g_randn(gen, e, m, k).to(dtype)
    u = _g_randn(gen, e, rank, n, scale=0.2).to(dtype)
    v = _g_randn(gen, e, rank, k, scale=0.2).to(dtype)
    return x, ws.contiguous(), u, v


@pytest.mark.parametrize("lib", ["grouped_tc", "first"])
@pytest.mark.parametrize("e", [1, 3, 64])
@pytest.mark.parametrize("m", LR_M)
def test_slab_lr_matmul_g_each_library(cuda, m, e, lib):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1300 + m + e)
    n, k = (1408, 2048) if e == 64 else (1411, 1376)
    x, ws, u, v = _lr_g_operands(gen, e, m, k, torch.bfloat16,
                                 3 if m % 2 else 1, n)
    kern = g_k.SLAB_LR_G if lib == "grouped_tc" else g_k.SLAB_LR_G_FIRST
    launches = kern.launches
    got = g_k.launch_slab_lr_g(kern, x, ws, u, v)
    assert kern.launches == launches + (m > 0)
    if m == 0:
        assert got.shape == (e, 0, n) and got.dtype == torch.bfloat16
        return
    _close(got, g_k.slab_lr_matmul_g_plain(x, ws, u, v), torch.bfloat16)


@pytest.mark.parametrize("m", [1, 6, 37])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_slab_lr_matmul_g_kernel_matches_plain(cuda, dt, m):
    """Through the wrapper: the launch counts on the library
    slab_lr_g_kernel picks (grouped_tc.cu for bf16 from
    LR_TC_MIN_ROWS)."""
    dtype = DTYPES[dt]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1400 + m)
    x, ws, u, v = _lr_g_operands(gen, 3, m, 1376, dtype, 1)
    kern = g_k.slab_lr_g_kernel(dtype, m, 1376)
    assert kern is (g_k.SLAB_LR_G if dtype == torch.bfloat16
                    and m >= g_k.LR_TC_MIN_ROWS else g_k.SLAB_LR_G_FIRST)
    launches = kern.launches
    got = g_k.slab_lr_matmul_g(x, ws, u, v)
    assert kern.launches == launches + 1
    _close(got, g_k.slab_lr_matmul_g_plain(x, ws, u, v), dtype)


@pytest.mark.parametrize("k,m", [(2048, 32), (1408, 32), (9984, 6)],
                         ids=str)
def test_slab_lr_matmul_g_ring_depths(cuda, k, m):
    """Where x's tile and a 4-stage ring do not fit a block together the
    kernel keeps the widest tile and runs fewer stages (3 at 32 rows of
    K 2048, 2 at 8 rows of K 9984; 4 at K 1408)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1500 + k)
    x, ws, u, v = _lr_g_operands(gen, 2, m, k, torch.bfloat16, 1, n=300)
    got = g_k.launch_slab_lr_g(g_k.SLAB_LR_G, x, ws, u, v)
    _close(got, g_k.slab_lr_matmul_g_plain(x, ws, u, v), torch.bfloat16)


# grouped #17 slab_nm_matmul_g and #20 binlr_matmul_g through each library
# at M 1-37: E 1 and 3 at (1411, 1376) (N off the 128-row tile, K off the
# 128-column chunk), #17 at E 16 at (1411, 4096) (K split in two) and #20
# at deepseek-moe-16b's 64 experts at (1408, 2048) (blocks walking three
# row tiles each); rank 1 and 3, #17 at 2:4 and 4:8.
G17_M = [1, 2, 6, 20, 37]


def _nm_g_operands(gen, e, n, k, m, pattern, rank, dtype):
    """x, vals, idx, bp, u, v of e experts; the N:M planes pack the e·n
    rows as one matrix."""
    n_keep, m_pat = map(int, pattern.split(":"))
    w = _g_randn(gen, e * n, k, scale=0.05)
    w_nm = torch.where(sparsity.nm_mask(w.abs(), n_keep, m_pat), w, 0.0)
    nm = packing.pack_nm(w_nm.to(dtype), n_keep, m_pat, strict=True)
    vals = nm.values.reshape(e, n, k // m_pat, n_keep).contiguous()
    idx = nm.indices.reshape(e, n, k // m_pat, n_keep).contiguous()
    x, bp, u, v = _bin_g_operands(gen, e, n, k, m, rank, dtype)
    return x, vals, idx, bp, u, v


def _bin_g_operands(gen, e, n, k, m, rank, dtype):
    """x, bp, u, v of e experts."""
    signs = torch.where(_g_randn(gen, e * n, k) >= 0, 1, -1).to(torch.int8)
    bp = packing.pack_sign_bits(signs).reshape(e, n, k // 32)
    x = _g_randn(gen, e, m, k).to(dtype)
    u = _g_randn(gen, e, rank, n, scale=0.2).to(dtype)
    v = _g_randn(gen, e, rank, k, scale=0.2).to(dtype)
    return x, bp, u, v


@pytest.mark.parametrize("lib", ["grouped_tc", "first"])
@pytest.mark.parametrize("pattern,rank", [("2:4", 1), ("2:4", 3), ("4:8", 1),
                                          ("4:8", 3)])
@pytest.mark.parametrize("e", [1, 3, 16])
@pytest.mark.parametrize("m", G17_M)
def test_slab_nm_matmul_g_each_library(cuda, m, e, pattern, rank, lib):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1600 + m + e + rank)
    n, k = (1411, 4096) if e == 16 else (1411, 1376)
    x, vals, idx, bp, u, v = _nm_g_operands(gen, e, n, k, m, pattern, rank,
                                            torch.bfloat16)
    m_pat = int(pattern.split(":")[1])
    kern = g_k.SLAB_NM_G if lib == "grouped_tc" else g_k.SLAB_NM_G_FIRST
    launches = kern.launches
    got = g_k.launch_slab_nm_g(kern, x, vals, idx, m_pat, bp, u, v)
    assert kern.launches == launches + 1
    _close(got, g_k.slab_nm_matmul_g_plain(x, vals, idx, m_pat, bp, u, v),
           torch.bfloat16)


@pytest.mark.parametrize("lib", ["grouped_tc", "first"])
@pytest.mark.parametrize("rank", [1, 3])
@pytest.mark.parametrize("e", [1, 3, 64])
@pytest.mark.parametrize("m", G17_M)
def test_binlr_matmul_g_each_library(cuda, m, e, rank, lib):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1700 + m + e + rank)
    n, k = (1408, 2048) if e == 64 else (1411, 1376)
    x, bp, u, v = _bin_g_operands(gen, e, n, k, m, rank, torch.bfloat16)
    kern = g_k.BINLR_G if lib == "grouped_tc" else g_k.BINLR_G_FIRST
    launches = kern.launches
    got = g_k.launch_binlr_g(kern, x, bp, u, v)
    assert kern.launches == launches + 1
    _close(got, g_k.binlr_matmul_g_plain(x, bp, u, v), torch.bfloat16)


@pytest.mark.parametrize("m", [1, 6, 37])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_slab_nm_matmul_g_kernel_matches_plain(cuda, dt, m):
    """Through the wrapper: the launch counts on the library
    slab_nm_g_kernel picks (grouped_tc.cu for bf16 2:4 / 4:8 from
    SLAB_NM_G_TC_MIN_ROWS, the first design at f32: 1e-5)."""
    dtype = DTYPES[dt]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1800 + m)
    x, vals, idx, bp, u, v = _nm_g_operands(gen, 3, 1411, 1376, m, "2:4", 1,
                                            dtype)
    kern = g_k.slab_nm_g_kernel(dtype, 2, 4, m)
    assert kern is (g_k.SLAB_NM_G if dtype == torch.bfloat16
                    and m >= g_k.SLAB_NM_G_TC_MIN_ROWS
                    else g_k.SLAB_NM_G_FIRST)
    launches = kern.launches
    got = g_k.slab_nm_matmul_g(x, vals, idx, 4, bp, u, v)
    assert kern.launches == launches + 1
    _close(got, g_k.slab_nm_matmul_g_plain(x, vals, idx, 4, bp, u, v), dtype)


@pytest.mark.parametrize("m", [1, 6, 37])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_binlr_matmul_g_kernel_matches_plain(cuda, dt, m):
    """Through the wrapper: the launch counts on the library
    binlr_g_kernel picks (grouped_tc.cu for bf16 from
    BINLR_G_TC_MIN_ROWS, the first design at f32: 1e-5)."""
    dtype = DTYPES[dt]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1900 + m)
    x, bp, u, v = _bin_g_operands(gen, 3, 1411, 1376, m, 1, dtype)
    kern = g_k.binlr_g_kernel(dtype, m)
    assert kern is (g_k.BINLR_G if dtype == torch.bfloat16
                    and m >= g_k.BINLR_G_TC_MIN_ROWS else g_k.BINLR_G_FIRST)
    launches = kern.launches
    got = g_k.binlr_matmul_g(x, bp, u, v)
    assert kern.launches == launches + 1
    _close(got, g_k.binlr_matmul_g_plain(x, bp, u, v), dtype)


@pytest.mark.parametrize("lib", ["grouped_tc", "first"])
@pytest.mark.parametrize("kernel", ["slab_nm_matmul_g", "binlr_matmul_g"])
def test_grouped_binary_no_rows(cuda, kernel, lib):
    """M = 0 gives an empty (E, 0, N) result and no launch."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1950)
    if kernel == "slab_nm_matmul_g":
        x, vals, idx, bp, u, v = _nm_g_operands(gen, 3, 300, 256, 0, "2:4",
                                                1, torch.bfloat16)
        kern = g_k.SLAB_NM_G if lib == "grouped_tc" else g_k.SLAB_NM_G_FIRST
        run = lambda: g_k.launch_slab_nm_g(kern, x, vals, idx, 4, bp, u, v)
    else:
        x, bp, u, v = _bin_g_operands(gen, 3, 300, 256, 0, 1, torch.bfloat16)
        kern = g_k.BINLR_G if lib == "grouped_tc" else g_k.BINLR_G_FIRST
        run = lambda: g_k.launch_binlr_g(kern, x, bp, u, v)
    launches = kern.launches
    got = run()
    assert kern.launches == launches
    assert got.shape == (3, 0, 300) and got.dtype == torch.bfloat16


@pytest.mark.parametrize("kernel,e,n,k", [
    ("slab_nm_matmul_g", 16, 4096, 6400), ("slab_nm_matmul_g", 16, 6400, 4096),
    ("binlr_matmul_g", 16, 4096, 6400), ("binlr_matmul_g", 64, 1408, 2048),
    ("binlr_matmul_g", 64, 2048, 1408)], ids=str)
def test_grouped_binary_launches_are_deterministic(cuda, kernel, e, n, k):
    """phi3.5-moe's 16 experts at K 6400 and 4096 split K (partial sums
    (splits, E, M, N), a ticket per expert and block column) and
    deepseek-moe-16b's 64 walk several row tiles a block (#20): the same
    launch twice gives the same bits, and matches the plain version."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2000 + n)
    m = 2 if e == 16 else 6
    n_split, _ = slab_k.plan_nm_splits(
        n, k, torch.cuda.get_device_properties(cuda).multi_processor_count, e)
    if kernel == "slab_nm_matmul_g":
        x, vals, idx, bp, u, v = _nm_g_operands(gen, e, n, k, m, "2:4", 1,
                                                torch.bfloat16)
        run = lambda: g_k.launch_slab_nm_g(g_k.SLAB_NM_G, x, vals, idx, 4,
                                           bp, u, v)
        plain = lambda: g_k.slab_nm_matmul_g_plain(x, vals, idx, 4, bp, u, v)
    else:
        x, bp, u, v = _bin_g_operands(gen, e, n, k, m, 1, torch.bfloat16)
        run = lambda: g_k.launch_binlr_g(g_k.BINLR_G, x, bp, u, v)
        plain = lambda: g_k.binlr_matmul_g_plain(x, bp, u, v)
    assert n_split > 1 or e == 64
    got = run()
    _close(got, plain(), torch.bfloat16)
    for _ in range(3):
        assert torch.equal(got, run())


# #8 nm_matmul and #7 slab_nm_lr_matmul per linear: through each library
# at M 0-128 (37 and 128 take several 32-row passes of the tensor-core
# kernel, each with its own partial projections), N 1411 off the 128-row
# block, K 1376 off the 128-column chunk, one stored position in 50 moved
# out of [0, m); #7 at ranks 1, 3 and 5.
NM_LIN_M = [0, 1, 4, 8, 37, 128]


def _nm_lin_operands(gen, n, k, m, pattern, rank, dtype):
    """x, vals, idx (with bad positions), u, v and the plain version's
    vals / idx (no sign words: any K the pattern divides)."""
    n_keep, m_pat = map(int, pattern.split(":"))
    dev = gen.device
    w = _g_randn(gen, n, k, scale=0.05)
    w_nm = torch.where(sparsity.nm_mask(w.abs(), n_keep, m_pat), w, 0.0)
    nm = packing.pack_nm(w_nm.to(dtype), n_keep, m_pat, strict=True)
    vals, idx = nm.values.contiguous(), nm.indices.contiguous()
    bad = torch.rand(vals.shape, generator=gen, device=dev) < 0.02
    off = torch.where(torch.rand(vals.shape, generator=gen, device=dev)
                      < 0.5, -1, m_pat).to(torch.int8)
    idx_k = torch.where(bad, off, idx)
    vals_p = torch.where(bad, torch.zeros_like(vals), vals)
    idx_p = torch.where(bad, torch.zeros_like(idx), idx)
    x = _g_randn(gen, m, k).to(dtype)
    u = _g_randn(gen, rank, n, scale=0.2).to(dtype)
    v = _g_randn(gen, rank, k, scale=0.2).to(dtype)
    return x, vals, idx_k, u, v, vals_p, idx_p


def _nm_lin(kernel, kern, x, vals, idx, m_pat, u, v):
    """One launch of #8 (kernel "nm_matmul") or #7 through ``kern``'s
    library, and its plain version's call."""
    if kernel == "nm_matmul":
        return (lambda: nm_k.launch_nm(kern, x, vals, idx, m_pat),
                lambda vp, ip: nm_k.nm_matmul_plain(x, vp, ip, m_pat))
    return (lambda: slab_k.launch_slab_nm_lr(kern, x, vals, idx, m_pat, u, v),
            lambda vp, ip: slab_k.slab_nm_lr_matmul_plain(x, vp, ip, m_pat,
                                                          u, v))


def _nm_lin_libs(kernel):
    return ((nm_k.NM, nm_k.NM_FIRST) if kernel == "nm_matmul"
            else (slab_k.SLAB_NM_LR, slab_k.SLAB_NM_LR_FIRST))


@pytest.mark.parametrize("lib", ["grouped_tc", "first"])
@pytest.mark.parametrize("pattern", ["2:4", "4:8"])
@pytest.mark.parametrize("m", NM_LIN_M)
def test_nm_matmul_each_library(cuda, m, pattern, lib):
    """#8 at bf16 through each library; M = 0 gives an empty result and
    no launch."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3000 + m)
    m_pat = int(pattern.split(":")[1])
    x, vals, idx, u, v, vals_p, idx_p = _nm_lin_operands(
        gen, 1411, 1376, m, pattern, 1, torch.bfloat16)
    kern = _nm_lin_libs("nm_matmul")[lib == "first"]
    run, plain = _nm_lin("nm_matmul", kern, x, vals, idx, m_pat, u, v)
    launches = kern.launches
    got = run()
    assert kern.launches == launches + (m > 0)
    if m == 0:
        assert got.shape == (0, 1411) and got.dtype == torch.bfloat16
        return
    _close(got, plain(vals_p, idx_p), torch.bfloat16)


@pytest.mark.parametrize("lib", ["grouped_tc", "first"])
@pytest.mark.parametrize("pattern,rank", [("2:4", 1), ("4:8", 3), ("2:4", 5)])
@pytest.mark.parametrize("m", NM_LIN_M)
def test_slab_nm_lr_matmul_each_library(cuda, m, pattern, rank, lib):
    """#7 at bf16 through each library, ranks 1, 3 and 5; M = 0 gives an
    empty result and no launch."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3100 + m + rank)
    m_pat = int(pattern.split(":")[1])
    x, vals, idx, u, v, vals_p, idx_p = _nm_lin_operands(
        gen, 1411, 1376, m, pattern, rank, torch.bfloat16)
    kern = _nm_lin_libs("slab_nm_lr_matmul")[lib == "first"]
    run, plain = _nm_lin("slab_nm_lr_matmul", kern, x, vals, idx, m_pat, u,
                         v)
    launches = kern.launches
    got = run()
    assert kern.launches == launches + (m > 0)
    if m == 0:
        assert got.shape == (0, 1411) and got.dtype == torch.bfloat16
        return
    _close(got, plain(vals_p, idx_p), torch.bfloat16)


@pytest.mark.parametrize("kernel", ["nm_matmul", "slab_nm_lr_matmul"])
@pytest.mark.parametrize("pattern", ["2:4", "4:8"])
@pytest.mark.parametrize("m", [1, 4, 37])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_nm_lin_kernel_matches_plain(cuda, dt, m, pattern, kernel):
    """#8 and #7 through the wrapper at bf16 and f32: the launch counts on
    the library nm_kernel / slab_nm_lr_kernel picks (grouped_tc.cu for
    bf16 from the crossover)."""
    dtype = DTYPES[dt]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3200 + m)
    n_keep, m_pat = map(int, pattern.split(":"))
    x, vals, idx, u, v, vals_p, idx_p = _nm_lin_operands(
        gen, 1411, 1376, m, pattern, 3, dtype)
    if kernel == "nm_matmul":
        kern = nm_k.nm_kernel(dtype, n_keep, m_pat, m)
        lo = nm_k.NM_TC_MIN_ROWS
        got = lambda: nm_k.nm_matmul(x, vals, idx, m_pat)
    else:
        kern = slab_k.slab_nm_lr_kernel(dtype, n_keep, m_pat, m)
        lo = slab_k.NM_LR_TC_MIN_ROWS
        got = lambda: slab_k.slab_nm_lr_matmul(x, vals, idx, m_pat, u, v)
    new, first = _nm_lin_libs(kernel)
    assert kern is (new if dtype == torch.bfloat16 and m >= lo else first)
    launches = kern.launches
    out = got()
    assert kern.launches == launches + 1
    _, plain = _nm_lin(kernel, kern, x, vals, idx, m_pat, u, v)
    _close(out, plain(vals_p, idx_p), dtype)


@pytest.mark.parametrize("kernel", ["nm_matmul", "slab_nm_lr_matmul"])
@pytest.mark.parametrize("m", [1, 4, 37])
def test_nm_lin_odd_shape(cuda, kernel, m):
    """chip_smoke.py's ODD_SHAPE (4099, 4100) at 2:4: K % 32 != 0, so the
    tensor-core kernel reads the planes entry by entry, and its last
    128-column chunk holds 4 columns; through the wrapper."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3300 + m)
    x, vals, idx, u, v, vals_p, idx_p = _nm_lin_operands(
        gen, 4099, 4100, m, "2:4", 3, torch.bfloat16)
    new, _ = _nm_lin_libs(kernel)
    _, plain = _nm_lin(kernel, new, x, vals, idx, 4, u, v)
    launches = new.launches
    if kernel == "nm_matmul":
        got = nm_k.nm_matmul(x, vals, idx, 4)
    else:
        got = slab_k.slab_nm_lr_matmul(x, vals, idx, 4, u, v)
    assert new.launches == launches + 1
    _close(got, plain(vals_p, idx_p), torch.bfloat16)


@pytest.mark.parametrize("kernel", ["nm_matmul", "slab_nm_lr_matmul"])
@pytest.mark.parametrize("pattern", ["2:4", "4:8"])
@pytest.mark.parametrize("shape", [(4096, 4096), (1024, 4096), (2048, 2816)],
                         ids=str)
def test_nm_lin_splits_are_deterministic(cuda, shape, pattern, kernel):
    """llama2-7b's (4096, 4096), phi3.5-moe's (1024, 4096) (32 splits of
    one chunk) and deepseek-moe-16b's shared w_down (2048, 2816) at M 4
    split K across blocks; the last block of a row tile adds the partial
    sums (and #7's partial projections) in split order, so the same
    launch twice gives the same bits."""
    n, k = shape
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3400 + n + k)
    m_pat = int(pattern.split(":")[1])
    x, vals, idx, u, v, vals_p, idx_p = _nm_lin_operands(
        gen, n, k, 4, pattern, 3, torch.bfloat16)
    n_split, _ = slab_k.plan_nm_splits(n, k, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert n_split > 1
    new, _ = _nm_lin_libs(kernel)
    run, plain = _nm_lin(kernel, new, x, vals, idx, m_pat, u, v)
    got = run()
    _close(got, plain(vals_p, idx_p), torch.bfloat16)
    for _ in range(3):
        assert torch.equal(got, run())


# #1 slab_ell_matmul and #5 ell_lr_matmul per linear: through each library
# at M 0-128 (37 and 128 take several passes of the split kernel, each
# restaging x), N 1411 off the 128-row tile, K 1376 off the 128-column
# chunk, ranks 1, 3 and 5. K_max is odd and past the fullest row: every row
# ends in ELL pads and starts off a 16-byte boundary.
ELL_LIN_M = [0, 1, 4, 8, 37, 128]


def _ell_lin_operands(gen, n, k, m, rank, dtype, binary, wide=False,
                      order=None, per_row=None):
    """x, vals, idx, bp (None without ``binary``), u, v of one linear;
    ``wide``: int32 ids; ``order``: each row's entries "shuffled",
    "reversed" or with every third entry repeating its left neighbour's
    column ("duplicates", whose values add); ``per_row``: that many
    nonzeros in each row (else ~44 % of K)."""
    dev = gen.device
    w = _g_randn(gen, n, k, scale=0.05)
    score = _g_randn(gen, n, k)
    if per_row is not None:
        keep = torch.zeros_like(score, dtype=torch.bool)
        keep.scatter_(1, score.topk(per_row, dim=1).indices, True)
    else:
        keep = score > 0.15
    ws = torch.where(keep, w, 0.0)
    ell = packing.ell_pack(ws.to(dtype),
                           nnz=(packing.ell_row_nnz_max(ws) + 2) | 1)
    vals, idx = ell.values, ell.indices
    if order == "shuffled":
        perm = torch.argsort(torch.rand(vals.shape, generator=gen,
                                        device=dev), dim=1)
        vals, idx = vals.gather(1, perm), idx.gather(1, perm)
    elif order == "reversed":
        vals, idx = vals.flip(1), idx.flip(1)
    elif order == "duplicates":
        idx = idx.clone()
        idx[:, 3::3] = idx[:, 2:-1:3][:, :idx[:, 3::3].shape[1]]
    if wide:
        idx = packing.as_unsigned(idx).int()
    bp = None
    if binary:
        signs = torch.where(_g_randn(gen, n, k) >= 0, 1, -1).to(torch.int8)
        bp = packing.pack_sign_bits(signs)
    x = _g_randn(gen, m, k).to(dtype)
    u = _g_randn(gen, rank, n, scale=0.2).to(dtype)
    v = _g_randn(gen, rank, k, scale=0.2).to(dtype)
    return (x, vals.contiguous(), idx.contiguous(), bp, u.contiguous(),
            v.contiguous())


def _ell_lin(kernel, kern, x, vals, idx, bp, u, v):
    """One launch of #1 (kernel "slab_ell_matmul") or #5 through
    ``kern``'s library, and its plain version's call."""
    if kernel == "slab_ell_matmul":
        return (lambda: ell_k.launch_slab_ell(kern, x, vals, idx, bp, u, v),
                lambda: ell_k.slab_ell_matmul_plain(x, vals, idx, bp, u, v))
    return (lambda: ell_k.launch_ell_lr(kern, x, vals, idx, u, v),
            lambda: ell_k.ell_lr_matmul_plain(x, vals, idx, u, v))


def _ell_lin_libs(kernel):
    return ((ell_k.SLAB_ELL, ell_k.SLAB_ELL_FIRST)
            if kernel == "slab_ell_matmul"
            else (ell_k.ELL_LR, ell_k.ELL_LR_FIRST))


@pytest.mark.parametrize("kernel", ["slab_ell_matmul", "ell_lr_matmul"])
@pytest.mark.parametrize("lib", ["grouped_tc", "first"])
@pytest.mark.parametrize("rank", [1, 3, 5])
@pytest.mark.parametrize("m", ELL_LIN_M)
def test_ell_lin_each_library(cuda, m, rank, lib, kernel):
    """#1 and #5 at bf16 through each library, ranks 1, 3 and 5; M = 0
    gives an empty result and no launch."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4000 + m + rank)
    x, vals, idx, bp, u, v = _ell_lin_operands(
        gen, 1411, 1376, m, rank, torch.bfloat16,
        kernel == "slab_ell_matmul")
    kern = _ell_lin_libs(kernel)[lib == "first"]
    run, plain = _ell_lin(kernel, kern, x, vals, idx, bp, u, v)
    launches = kern.launches
    got = run()
    assert kern.launches == launches + (m > 0)
    if m == 0:
        assert got.shape == (0, 1411) and got.dtype == torch.bfloat16
        return
    _close(got, plain(), torch.bfloat16)


@pytest.mark.parametrize("kernel", ["slab_ell_matmul", "ell_lr_matmul"])
@pytest.mark.parametrize("m", [1, 4, 37])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_ell_lin_kernel_matches_plain(cuda, dt, m, kernel):
    """#1 and #5 through the wrapper at bf16 and f32, rank 3: the launch
    counts on the library slab_ell_kernel / ell_lr_kernel picks
    (grouped_tc.cu for bf16 from the crossover)."""
    dtype = DTYPES[dt]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4100 + m)
    binary = kernel == "slab_ell_matmul"
    x, vals, idx, bp, u, v = _ell_lin_operands(gen, 1411, 1376, m, 3, dtype,
                                               binary)
    if binary:
        kern = ell_k.slab_ell_kernel(dtype, m, 1376, 3, 2)
        lo = ell_k.SLAB_ELL_TC_MIN_ROWS
        got = lambda: ell_k.slab_ell_matmul(x, vals, idx, bp, u, v)
    else:
        kern = ell_k.ell_lr_kernel(dtype, m, 1376, 3, 2)
        lo = ell_k.ELL_LR_TC_MIN_ROWS
        got = lambda: ell_k.ell_lr_matmul(x, vals, idx, u, v)
    new, first = _ell_lin_libs(kernel)
    assert kern is (new if dtype == torch.bfloat16 and m >= lo else first)
    launches = kern.launches
    out = got()
    assert kern.launches == launches + 1
    _, plain = _ell_lin(kernel, kern, x, vals, idx, bp, u, v)
    _close(out, plain(), dtype)


# the SSM / hybrid families' #1 shapes (N, K): mamba2-1.3b's in_z / in_x
# and out, zamba2-7b's in_z / in_x and out, its shared block's attention,
# w_gate / w_up and w_down (K 14336, past the split gather's staged x)
SSM_SHAPES = [(4096, 2048), (2048, 4096), (7168, 3584), (3584, 7168),
              (3584, 3584), (14336, 3584), (3584, 14336)]


@pytest.mark.parametrize("n,k", SSM_SHAPES)
@pytest.mark.parametrize("m", [1, 4])
def test_slab_ell_matmul_ssm_shapes(cuda, n, k, m):
    """#1 through the wrapper at bf16, rank 1, at every SSM / hybrid
    shape: grouped_tc.cu's split gather where its staged x fits a block,
    the first design at K 14336."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4400 + m)
    x, vals, idx, bp, u, v = _ell_lin_operands(gen, n, k, m, 1,
                                               torch.bfloat16, True)
    kern = ell_k.slab_ell_kernel(torch.bfloat16, m, k, 1, 2)
    assert kern is (ell_k.SLAB_ELL_FIRST if k == 14336 else ell_k.SLAB_ELL)
    launches = kern.launches
    got = ell_k.slab_ell_matmul(x, vals, idx, bp, u, v)
    assert kern.launches == launches + 1
    _close(got, ell_k.slab_ell_matmul_plain(x, vals, idx, bp, u, v),
           torch.bfloat16)


@pytest.mark.parametrize("kernel", ["slab_ell_matmul", "ell_lr_matmul"])
@pytest.mark.parametrize("m", [1, 4, 37])
def test_ell_lin_int32_ids(cuda, kernel, m):
    """uint32 ids (ELL planes past D_in 2^16) on the split kernel."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4200 + m)
    x, vals, idx, bp, u, v = _ell_lin_operands(
        gen, 1411, 1376, m, 1, torch.bfloat16, kernel == "slab_ell_matmul",
        wide=True)
    assert idx.dtype == torch.int32
    run, plain = _ell_lin(kernel, _ell_lin_libs(kernel)[0], x, vals, idx, bp,
                          u, v)
    _close(run(), plain(), torch.bfloat16)


@pytest.mark.parametrize("m", [1, 4, 37])
def test_ell_lr_matmul_odd_shape(cuda, m):
    """chip_smoke.py's ODD_SHAPE (4099, 4100): K off every multiple of 8
    (rows of x start off 16 bytes, the staged x has a zero tail), through
    the wrapper and through the split kernel."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4300 + m)
    x, vals, idx, _, u, v = _ell_lin_operands(gen, 4099, 4100, m, 3,
                                              torch.bfloat16, False)
    want = ell_k.ell_lr_matmul_plain(x, vals, idx, u, v)
    kern = ell_k.ell_lr_kernel(torch.bfloat16, m, 4100, 3, 2)
    launches = kern.launches
    _close(ell_k.ell_lr_matmul(x, vals, idx, u, v), want, torch.bfloat16)
    assert kern.launches == launches + 1
    _close(ell_k.launch_ell_lr(ell_k.ELL_LR, x, vals, idx, u, v), want,
           torch.bfloat16)


@pytest.mark.parametrize("kernel", ["slab_ell_matmul", "ell_lr_matmul"])
@pytest.mark.parametrize("order", ["shuffled", "reversed", "duplicates"])
def test_ell_lin_any_entry_order(cuda, order, kernel):
    """The ELL format does not promise sorted ids: each row's entries in
    any order, and rows that repeat a column (their values add), give the
    plain version's result on the split kernel."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4400)
    x, vals, idx, bp, u, v = _ell_lin_operands(
        gen, 1411, 1376, 4, 1, torch.bfloat16, kernel == "slab_ell_matmul",
        order=order)
    new = _ell_lin_libs(kernel)[0]
    run, plain = _ell_lin(kernel, new, x, vals, idx, bp, u, v)
    _close(run(), plain(), torch.bfloat16)


@pytest.mark.parametrize("kernel", ["slab_ell_matmul", "ell_lr_matmul"])
@pytest.mark.parametrize("shape", [(4096, 4096), (1024, 4096), (2048, 2816)],
                         ids=str)
def test_ell_lin_splits_are_deterministic(cuda, shape, kernel):
    """llama2-7b's (4096, 4096), phi3.5-moe's (1024, 4096) (the widest
    split) and deepseek-moe-16b's shared w_down (2048, 2816) at M 4 split
    each row's entries across blocks; the last block of a row tile adds
    the partial sums in split order, so the same launch twice gives the
    same bits."""
    n, k = shape
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4500 + n + k)
    binary = kernel == "slab_ell_matmul"
    x, vals, idx, bp, u, v = _ell_lin_operands(gen, n, k, 4, 3,
                                               torch.bfloat16, binary)
    n_split, _, _ = slab_k.plan_ell_splits(
        n, k, vals.shape[1],
        torch.cuda.get_device_properties(cuda).multi_processor_count, binary)
    assert n_split > 1
    new = _ell_lin_libs(kernel)[0]
    run, plain = _ell_lin(kernel, new, x, vals, idx, bp, u, v)
    got = run()
    _close(got, plain(), torch.bfloat16)
    for _ in range(3):
        assert torch.equal(got, run())


@pytest.mark.parametrize("kernel", ["slab_ell_matmul", "ell_lr_matmul"])
@pytest.mark.parametrize("rank", [1, 3])
@pytest.mark.parametrize("m", [1, 4, 37])
@pytest.mark.parametrize("n,k,per_row", [(300, 256, 40), (17000, 512, 150)],
                         ids=["short_rows", "many_tiles"])
def test_ell_lin_one_split(cuda, n, k, per_row, m, rank, kernel):
    """Where the plan gives one split (K_max + 7 <= 64 entries a row, or
    more than NM_SPLIT_BLOCKS_PER_SM blocks an SM of row tiles alone) the
    split kernel stores y itself, #5 with its projection over all of K
    added at the stores: the plain version's result, the same bits
    twice."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4600 + n + m + rank)
    binary = kernel == "slab_ell_matmul"
    x, vals, idx, bp, u, v = _ell_lin_operands(
        gen, n, k, m, rank, torch.bfloat16, binary, per_row=per_row)
    n_split, _, _ = slab_k.plan_ell_splits(
        n, k, vals.shape[1],
        torch.cuda.get_device_properties(cuda).multi_processor_count, binary)
    assert n_split == 1
    new = _ell_lin_libs(kernel)[0]
    run, plain = _ell_lin(kernel, new, x, vals, idx, bp, u, v)
    got = run()
    _close(got, plain(), torch.bfloat16)
    assert torch.equal(got, run())


@pytest.mark.parametrize("kernel", ["slab_ell_matmul", "ell_lr_matmul"])
def test_ell_lin_shared_memory_edge(cuda, kernel):
    """At the widest K whose x (and #1's widest x ⊙ v_r tiles, or #5's
    projection sums) ell.ell_split_smem fits an H100 block, at 8 rows
    (one full tile), the wrapper runs the split kernel and it launches
    and agrees with the plain version (the C side's layout is no larger
    than the Python mirror's); 32 columns wider, the first design
    runs."""
    binary = kernel == "slab_ell_matmul"
    fits = lambda kk: ell_k.ell_split_smem(kk, 1, 2, binary) \
        <= slab_k.TC_SMEM  # noqa: E731
    k = 16384
    while not fits(k):
        k -= 32
    pick = ell_k.slab_ell_kernel if binary else ell_k.ell_lr_kernel
    new, first = _ell_lin_libs(kernel)
    assert pick(torch.bfloat16, 8, k, 1, 2) is new
    assert pick(torch.bfloat16, 8, k + 32, 1, 2) is first
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4700)
    x, vals, idx, bp, u, v = _ell_lin_operands(
        gen, 256, k, 8, 1, torch.bfloat16, binary)
    call = (lambda: ell_k.slab_ell_matmul(x, vals, idx, bp, u, v)) \
        if binary else (lambda: ell_k.ell_lr_matmul(x, vals, idx, u, v))
    launches = new.launches
    got = call()
    assert new.launches == launches + 1
    _, plain = _ell_lin(kernel, new, x, vals, idx, bp, u, v)
    _close(got, plain(), torch.bfloat16)


# #3 slab_matmul and #16 slab_matmul_g (dense W_S + the ±1 term): through
# each library at M 0-37, N 1411 off the 128-row tile, K 1376 off the
# 128-column chunk (a partial last bulk copy and sign-word chunk), ranks
# 1, 3 and 5; #16 at 16 experts and at a bucket of 5 of them gathered out
# of order. Through the wrapper at bf16 and f32; the widest splits of the
# main path (#3 at (4096, 11008), #16 at K 6400) bitwise repeatable.
DENSE_M = [0, 1, 2, 4, 8, 37]
DENSE_BUCKET = (3, 14, 0, 9, 6)


def _dense_operands(gen, e, n, k, m, rank, dtype):
    """x, ws, bp, u, v of ``e`` experts (e = 0: one linear, no expert
    dim)."""
    ee = max(e, 1)
    w = _g_randn(gen, ee, n, k, scale=0.05)
    ws = torch.where(_g_randn(gen, ee, n, k) > 0.5, w, 0.0).to(dtype)
    x, bp, u, v = _bin_g_operands(gen, ee, n, k, m, rank, dtype)
    ops_ = (x, ws.contiguous(), bp, u, v)
    return ops_ if e else tuple(t[0].contiguous() for t in ops_)


def _dense_run(kern, x, ws, bp, u, v):
    """One launch through ``kern``'s library (#3 or #16 by x's dims) and
    its plain version's call."""
    if x.dim() == 3:
        return (lambda: g_k.launch_slab_g(kern, x, ws, bp, u, v),
                lambda: g_k.slab_matmul_g_plain(x, ws, bp, u, v))
    return (lambda: slab_k.launch_slab_dense(kern, x, ws, bp, u, v),
            lambda: slab_k.slab_matmul_plain(x, ws, bp, u, v))


def _dense_libs(e):
    return ((g_k.SLAB_G, g_k.SLAB_G_FIRST) if e
            else (slab_k.SLAB_DENSE, slab_k.SLAB_DENSE_FIRST))


@pytest.mark.parametrize("lib", ["grouped_tc", "first"])
@pytest.mark.parametrize("rank", [1, 3, 5])
@pytest.mark.parametrize("e", [0, 16, 5], ids=("3", "16-e16", "16-bucket"))
@pytest.mark.parametrize("m", DENSE_M)
def test_slab_matmul_each_library(cuda, m, e, rank, lib):
    """bf16 through each library; M = 0 gives an empty result and no
    launch. The bucket is 5 of 16 experts' planes gathered out of
    order, as expert_matmul hands a group its experts."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4800 + m + e + rank)
    n, k = 1411, 1376
    if e == 5:
        sel = torch.tensor(DENSE_BUCKET, device=cuda)
        x, ws, bp, u, v = (t.index_select(0, sel).contiguous() for t in
                           _dense_operands(gen, 16, n, k, m, rank,
                                           torch.bfloat16))
    else:
        x, ws, bp, u, v = _dense_operands(gen, e, n, k, m, rank,
                                          torch.bfloat16)
    new, first = _dense_libs(e)
    kern = new if lib == "grouped_tc" else first
    run, plain = _dense_run(kern, x, ws, bp, u, v)
    launches = kern.launches
    got = run()
    assert kern.launches == launches + (m > 0)
    if m == 0:
        assert got.shape == x.shape[:-1] + (n,)
        assert got.dtype == torch.bfloat16
        return
    _close(got, plain(), torch.bfloat16)


@pytest.mark.parametrize("e", [0, 16], ids=("3", "16"))
@pytest.mark.parametrize("m", [1, 2, 4, 8, 37])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_slab_matmul_kernel_matches_plain(cuda, dt, m, e):
    """Through the wrapper: the launch counts on the library
    slab_dense_kernel / slab_g_kernel picks (grouped_tc.cu for bf16 from
    the crossover, the first design at f32: 1e-5)."""
    dtype = DTYPES[dt]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4900 + m + e)
    x, ws, bp, u, v = _dense_operands(gen, e, 1411, 1376, m, 1, dtype)
    if e:
        kern = g_k.slab_g_kernel(dtype, m)
        call = lambda: g_k.slab_matmul_g(x, ws, bp, u, v)
    else:
        kern = slab_k.slab_dense_kernel(dtype, m)
        call = lambda: slab_k.slab_matmul(x, ws, bp, u, v)
    lo = g_k.SLAB_G_TC_MIN_ROWS if e else slab_k.SLAB_DENSE_TC_MIN_ROWS
    new, first = _dense_libs(e)
    assert kern is (new if dtype == torch.bfloat16 and m >= lo else first)
    launches = kern.launches
    got = call()
    assert kern.launches == launches + 1
    _close(got, _dense_run(kern, x, ws, bp, u, v)[1](), dtype)


@pytest.mark.parametrize("e,n,k,m,rank", [
    (0, 4096, 11008, 4, 1), (0, 4096, 4096, 4, 3), (0, 1024, 4096, 2, 1),
    (16, 4096, 6400, 2, 1), (16, 6400, 4096, 2, 3)], ids=str)
def test_slab_matmul_splits_are_deterministic(cuda, e, n, k, m, rank):
    """The widest splits of the main path (#3 at (4096, 11008): 8 runs of
    11 chunks; #16 at K 6400: 5 runs of 11) and rank 3's narrower runs:
    the last block of a row tile adds the partial sums in split order,
    so the same launch twice gives the same bits, and both agree with the
    plain version."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5000 + n + k)
    x, ws, bp, u, v = _dense_operands(gen, e, n, k, m, rank, torch.bfloat16)
    n_split, _ = slab_k.plan_dense_splits(
        n, k, torch.cuda.get_device_properties(cuda).multi_processor_count,
        max(e, 1), slab_k.dense_split_cap(rank, m))
    assert n_split > 1
    run, plain = _dense_run(_dense_libs(e)[0], x, ws, bp, u, v)
    got = run()
    _close(got, plain(), torch.bfloat16)
    for _ in range(3):
        assert torch.equal(got, run())


# #4 ell_matmul (the split gather with no second term) and #6
# slab_lr_matmul (DenseSrc's ring with the projection through the K split):
# through each library at M 0-128, N 1411 off the 128-row tile, K 1376 off
# the 128-column chunk; through the wrapper at bf16 and f32; #4 with int32
# ids and at (4099, 4100); #6 at K off a multiple of 8 (the first design
# only); the splits of the main path bitwise repeatable over 20 calls.
LIN46_M = [0, 1, 2, 3, 4, 8, 37, 128]


def _ell4_run(kern, x, vals, idx):
    return (lambda: ell_k.launch_ell(kern, x, vals, idx),
            lambda: ell_k.ell_matmul_plain(x, vals, idx))


def _lr6_operands(gen, n, k, m, rank, dtype):
    x, ws, u, v = _lr_g_operands(gen, 1, m, k, dtype, rank, n)
    return x[0].contiguous(), ws[0].contiguous(), u[0].contiguous(), \
        v[0].contiguous()


def _lr6_run(kern, x, ws, u, v):
    return (lambda: slab_k.launch_slab_lr(kern, x, ws, u, v),
            lambda: slab_k.slab_lr_matmul_plain(x, ws, u, v))


@pytest.mark.parametrize("lib", ["grouped_tc", "first"])
@pytest.mark.parametrize("m", LIN46_M)
def test_ell_matmul_each_library(cuda, m, lib):
    """#4 at bf16 through each library; M = 0 gives an empty result and
    no launch."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5100 + m)
    x, vals, idx, _, _, _ = _ell_lin_operands(gen, 1411, 1376, m, 1,
                                              torch.bfloat16, False)
    kern = ell_k.ELL if lib == "grouped_tc" else ell_k.ELL_FIRST
    run, plain = _ell4_run(kern, x, vals, idx)
    launches = kern.launches
    got = run()
    assert kern.launches == launches + (m > 0)
    if m == 0:
        assert got.shape == (0, 1411) and got.dtype == torch.bfloat16
        return
    _close(got, plain(), torch.bfloat16)


@pytest.mark.parametrize("m", [1, 2, 3, 4, 37])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_ell_matmul_kernel_matches_plain(cuda, dt, m):
    """#4 through the wrapper: the launch counts on the library
    ell_kernel picks (grouped_tc.cu for bf16 from ELL_TC_MIN_ROWS, the
    first design at f32: 1e-5)."""
    dtype = DTYPES[dt]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5200 + m)
    x, vals, idx, _, _, _ = _ell_lin_operands(gen, 1411, 1376, m, 1, dtype,
                                              False)
    kern = ell_k.ell_kernel(dtype, m, 1376, 2)
    assert kern is (ell_k.ELL if dtype == torch.bfloat16
                    and m >= ell_k.ELL_TC_MIN_ROWS else ell_k.ELL_FIRST)
    launches = kern.launches
    got = ell_k.ell_matmul(x, vals, idx)
    assert kern.launches == launches + 1
    _close(got, ell_k.ell_matmul_plain(x, vals, idx), dtype)


@pytest.mark.parametrize("order", [None, "shuffled", "duplicates"])
@pytest.mark.parametrize("m", [1, 4, 37])
def test_ell_matmul_int32_ids(cuda, m, order):
    """uint32 ids (ELL planes past D_in 2^16) on the split kernel, each
    row's entries in any order."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5300 + m)
    x, vals, idx, _, _, _ = _ell_lin_operands(
        gen, 1411, 1376, m, 1, torch.bfloat16, False, wide=True,
        order=order)
    assert idx.dtype == torch.int32
    run, plain = _ell4_run(ell_k.ELL, x, vals, idx)
    _close(run(), plain(), torch.bfloat16)


@pytest.mark.parametrize("m", [1, 4, 37])
def test_ell_matmul_odd_shape(cuda, m):
    """chip_smoke.py's ODD_SHAPE (4099, 4100), K_max odd: through the
    wrapper and through the split kernel."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5400 + m)
    x, vals, idx, _, _, _ = _ell_lin_operands(gen, 4099, 4100, m, 1,
                                              torch.bfloat16, False)
    want = ell_k.ell_matmul_plain(x, vals, idx)
    _close(ell_k.ell_matmul(x, vals, idx), want, torch.bfloat16)
    _close(ell_k.launch_ell(ell_k.ELL, x, vals, idx), want, torch.bfloat16)


@pytest.mark.parametrize("shape", [(4096, 4096), (1024, 4096), (2048, 2816),
                                   (4096, 11008)], ids=str)
def test_ell_matmul_splits_are_deterministic(cuda, shape):
    """The main path's #4 shapes at M 4 split each row's entries across
    blocks; the last block of a row tile adds the partial sums in split
    order, so 20 launches give the same bits."""
    n, k = shape
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5500 + n + k)
    x, vals, idx, _, _, _ = _ell_lin_operands(gen, n, k, 4, 1,
                                              torch.bfloat16, False)
    n_split, _, _ = slab_k.plan_ell_splits(
        n, k, vals.shape[1],
        torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert n_split > 1
    run, plain = _ell4_run(ell_k.ELL, x, vals, idx)
    got = run()
    _close(got, plain(), torch.bfloat16)
    for _ in range(20):
        assert torch.equal(got, run())


@pytest.mark.parametrize("lib", ["grouped_tc", "first"])
@pytest.mark.parametrize("rank", [1, 3, 5])
@pytest.mark.parametrize("m", LIN46_M)
def test_slab_lr_matmul_each_library(cuda, m, rank, lib):
    """#6 at bf16 through each library, ranks 1, 3 and 5; M = 0 gives an
    empty result and no launch."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5600 + m + rank)
    x, ws, u, v = _lr6_operands(gen, 1411, 1376, m, rank, torch.bfloat16)
    kern = slab_k.SLAB_LR if lib == "grouped_tc" else slab_k.SLAB_LR_FIRST
    run, plain = _lr6_run(kern, x, ws, u, v)
    launches = kern.launches
    got = run()
    assert kern.launches == launches + (m > 0)
    if m == 0:
        assert got.shape == (0, 1411) and got.dtype == torch.bfloat16
        return
    _close(got, plain(), torch.bfloat16)


@pytest.mark.parametrize("m", [1, 2, 4, 8, 37])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_slab_lr_matmul_kernel_matches_plain(cuda, dt, m):
    """#6 through the wrapper, rank 3: the launch counts on the library
    slab_lr_kernel picks (grouped_tc.cu for bf16 from
    SLAB_LR_TC_MIN_ROWS, the first design at f32: 1e-5)."""
    dtype = DTYPES[dt]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5700 + m)
    x, ws, u, v = _lr6_operands(gen, 1411, 1376, m, 3, dtype)
    kern = slab_k.slab_lr_kernel(dtype, m, 1376, 3)
    assert kern is (slab_k.SLAB_LR if dtype == torch.bfloat16
                    and m >= slab_k.SLAB_LR_TC_MIN_ROWS
                    else slab_k.SLAB_LR_FIRST)
    launches = kern.launches
    got = slab_k.slab_lr_matmul(x, ws, u, v)
    assert kern.launches == launches + 1
    _close(got, slab_k.slab_lr_matmul_plain(x, ws, u, v), dtype)


@pytest.mark.parametrize("m", [1, 4, 37])
def test_slab_lr_matmul_k_off_eight(cuda, m):
    """At K % 8 != 0 (rows of W_S off 16 bytes: no tensor map) the wrapper
    runs the first design, and the new library refuses the launch."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5800 + m)
    x, ws, u, v = _lr6_operands(gen, 1411, 1380, m, 1, torch.bfloat16)
    assert slab_k.slab_lr_kernel(torch.bfloat16, m, 1380, 1) \
        is slab_k.SLAB_LR_FIRST
    first = slab_k.SLAB_LR_FIRST.launches
    _close(slab_k.slab_lr_matmul(x, ws, u, v),
           slab_k.slab_lr_matmul_plain(x, ws, u, v), torch.bfloat16)
    assert slab_k.SLAB_LR_FIRST.launches == first + 1
    with pytest.raises(RuntimeError, match="failed to launch"):
        slab_k.launch_slab_lr(slab_k.SLAB_LR, x, ws, u, v)


@pytest.mark.parametrize("rank", [1, 3])
@pytest.mark.parametrize("shape", [(4096, 4096), (4096, 11008), (2048, 2048),
                                   (2048, 2816)], ids=str)
def test_slab_lr_matmul_splits_are_deterministic(cuda, shape, rank):
    """The main path's #6 shapes at M 4 split K across blocks; the last
    block of a row tile adds the partial sums and the partial projections
    in split order, so 20 launches give the same bits."""
    n, k = shape
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5900 + n + k + rank)
    x, ws, u, v = _lr6_operands(gen, n, k, 4, rank, torch.bfloat16)
    n_split, _ = slab_k.plan_dense_splits(
        n, k, torch.cuda.get_device_properties(cuda).multi_processor_count,
        1, slab_k.dense_split_cap(rank, 4, lowrank=True))
    assert n_split > 1
    run, plain = _lr6_run(slab_k.SLAB_LR, x, ws, u, v)
    got = run()
    _close(got, plain(), torch.bfloat16)
    for _ in range(20):
        assert torch.equal(got, run())


@pytest.mark.parametrize("quant", [False, True], ids=("model", "int8"))
@pytest.mark.parametrize("paged", [False, True], ids=("contig", "paged"))
@pytest.mark.parametrize("gdh", [(1, 128), (4, 160)], ids=str)
def test_flash_decode_ring_refills_are_deterministic(cuda, gdh, paged,
                                                     quant):
    """#10 and #11 refill a ring stage by bulk copies only after a proxy
    fence behind the generic reads of it: 20 launches over many splits
    and tiles give the same bits, and the plain version's result."""
    g, dh = gdh
    rng = np.random.default_rng(31 + g + paged + 2 * quant)
    kern, plain = _split_case(rng, 16, g, dh, torch.bfloat16, quant, paged,
                              cuda)
    got = kern()
    _close(got, plain(), torch.bfloat16)
    for _ in range(20):
        assert torch.equal(got, kern())


# #15 nm_matmul_g and #9 binlr_matmul through each library: #15 at E 1
# (1411, 1376), a bucket of 5 experts gathered out of order from 16 and
# E 16 at (1411, 6408) (K % 32 != 0: the planes read entry by entry, K
# split in four runs, the last chunk 8 columns), 2:4 and 4:8; #9 at
# (1411, 1376) (N off the 128-row tile, K off the 128-column chunk, K
# split in 11 runs), ranks 1 and 3; M 0 gives an empty result and no
# launch.
G15_M = [0, 1, 2, 6, 20]
BUCKET = (3, 14, 0, 9, 6)


def _nm15_operands(gen, e, n, k, m, pattern, dtype):
    """x, vals, idx of e experts (E 5: a bucket of BUCKET gathered from
    16); the N:M planes pack the experts' rows as one matrix."""
    n_keep, m_pat = map(int, pattern.split(":"))
    e_all = 16 if e == len(BUCKET) else e
    w = _g_randn(gen, e_all * n, k, scale=0.05)
    w_nm = torch.where(sparsity.nm_mask(w.abs(), n_keep, m_pat), w, 0.0)
    nm = packing.pack_nm(w_nm.to(dtype), n_keep, m_pat, strict=True)
    vals = nm.values.reshape(e_all, n, k // m_pat, n_keep)
    idx = nm.indices.reshape(e_all, n, k // m_pat, n_keep)
    if e_all != e:
        sel = torch.tensor(BUCKET, device=gen.device)
        vals, idx = vals.index_select(0, sel), idx.index_select(0, sel)
    x = _g_randn(gen, e, m, k).to(dtype)
    return x, vals.contiguous(), idx.contiguous()


def _nm15_libs():
    return {"grouped_tc": g_k.NM_G, "first": g_k.NM_G_FIRST}


@pytest.mark.parametrize("lib", ["grouped_tc", "first"])
@pytest.mark.parametrize("pattern", ["2:4", "4:8"])
@pytest.mark.parametrize("e", [1, 5, 16])
@pytest.mark.parametrize("m", G15_M)
def test_nm_matmul_g_each_library(cuda, m, e, pattern, lib):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(6000 + m + e)
    n, k = (1411, 6408) if e == 16 else (1411, 1376)
    m_pat = int(pattern.split(":")[1])
    x, vals, idx = _nm15_operands(gen, e, n, k, m, pattern, torch.bfloat16)
    kern = _nm15_libs()[lib]
    launches = kern.launches
    got = g_k.launch_nm_g(kern, x, vals, idx, m_pat)
    assert kern.launches == launches + (m > 0)
    if m == 0:
        assert got.shape == (e, 0, n) and got.dtype == torch.bfloat16
        return
    _close(got, g_k.nm_matmul_g_plain(x, vals, idx, m_pat), torch.bfloat16)


@pytest.mark.parametrize("lib", ["grouped_tc", "first"])
@pytest.mark.parametrize("rank", [1, 3])
@pytest.mark.parametrize("m", [0, 1, 2, 4, 8, 20, 37])
def test_binlr_matmul_each_library(cuda, m, rank, lib):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(6100 + m + rank)
    x, bp, u, v = (t[0] for t in _bin_g_operands(gen, 1, 1411, 1376, m,
                                                 rank, torch.bfloat16))
    kern = binlr_k.BINLR if lib == "grouped_tc" else binlr_k.BINLR_FIRST
    launches = kern.launches
    got = binlr_k.launch_binlr(kern, x, bp, u, v)
    assert kern.launches == launches + (m > 0)
    if m == 0:
        assert got.shape == (0, 1411) and got.dtype == torch.bfloat16
        return
    _close(got, binlr_k.binlr_matmul_plain(x, bp, u, v), torch.bfloat16)


@pytest.mark.parametrize("kernel", ["nm_matmul_g", "binlr_matmul"])
@pytest.mark.parametrize("m", [1, 6])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_nm_g_and_binlr_wrappers_pick_the_library(cuda, dt, m, kernel):
    """Through the wrapper: the launch counts on the library nm_g_kernel /
    binlr_kernel picks (grouped_tc.cu for bf16 from the crossover, the
    first design at f32: 1e-5)."""
    dtype = DTYPES[dt]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(6200 + m)
    if kernel == "nm_matmul_g":
        x, vals, idx = _nm15_operands(gen, 5, 1411, 1376, m, "2:4", dtype)
        kern = g_k.nm_g_kernel(dtype, 2, 4, m)
        new, first = g_k.NM_G, g_k.NM_G_FIRST
        lo = g_k.NM_G_TC_MIN_ROWS
        run = lambda: g_k.nm_matmul_g(x, vals, idx, 4)
        plain = lambda: g_k.nm_matmul_g_plain(x, vals, idx, 4)
    else:
        x, bp, u, v = (t[0] for t in _bin_g_operands(gen, 1, 1411, 1376, m,
                                                     3, dtype))
        kern = binlr_k.binlr_kernel(dtype, m, 3)
        new, first = binlr_k.BINLR, binlr_k.BINLR_FIRST
        lo = binlr_k.BINLR_TC_MIN_ROWS
        run = lambda: binlr_k.binlr_matmul(x, bp, u, v)
        plain = lambda: binlr_k.binlr_matmul_plain(x, bp, u, v)
    assert kern is (new if dtype == torch.bfloat16 and m >= lo else first)
    launches = kern.launches
    got = run()
    assert kern.launches == launches + 1
    _close(got, plain(), dtype)


@pytest.mark.parametrize("case", [
    ("nm_matmul_g", 16, 6400, 4096), ("nm_matmul_g", 16, 4096, 6400),
    ("binlr_matmul", 1, 4096, 4096), ("binlr_matmul", 1, 11008, 4096),
    ("binlr_matmul", 1, 4096, 11008)], ids=str)
def test_nm_g_and_binlr_splits_are_deterministic(cuda, case):
    """The main path's shapes: #15 at phi3.5-moe's 16 experts, M 2 (K
    split in 2 and 4 runs), #9 at llama2-7b's, M 4 (K split, blocks
    walking 2 row tiles at the MLP shapes); the last block of an expert's
    block column adds the partial sums in split order and resets its
    ticket, so 20 launches give the same bits."""
    kernel, e, n, k = case
    gen = torch.Generator(device=cuda)
    gen.manual_seed(6300 + n + k)
    if kernel == "nm_matmul_g":
        x, vals, idx = _nm15_operands(gen, e, n, k, 2, "2:4", torch.bfloat16)
        run = lambda: g_k.launch_nm_g(g_k.NM_G, x, vals, idx, 4)
        plain = lambda: g_k.nm_matmul_g_plain(x, vals, idx, 4)
    else:
        x, bp, u, v = (t[0] for t in _bin_g_operands(gen, 1, n, k, 4, 1,
                                                     torch.bfloat16))
        run = lambda: binlr_k.launch_binlr(binlr_k.BINLR, x, bp, u, v)
        plain = lambda: binlr_k.binlr_matmul_plain(x, bp, u, v)
    n_split, _ = slab_k.plan_nm_splits(
        n, k, torch.cuda.get_device_properties(cuda).multi_processor_count, e)
    assert n_split > 1
    got = run()
    _close(got, plain(), torch.bfloat16)
    for _ in range(20):
        assert torch.equal(got, run())
