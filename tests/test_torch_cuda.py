"""The port's CUDA kernels of the third slice against their plain
PyTorch versions, on a card only: slab_nm_lr_matmul (#7), binlr_matmul
(#9), flash_decode (#10) and flash_decode_paged (#11). Every test skips
without a card (the kernels are CUDA C++ for sm_90a with no CPU mode).

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
from repro_torch.kernels import flash_decode as fd_k
from repro_torch.kernels import slab_matmul as slab_k
from repro_torch.models.attention import _quantize_token

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
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
@pytest.mark.parametrize("layout", [(8, 4, 160), (4, 1, 128)],
                         ids=("gqa-dh160", "mha-dh128"))
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


@pytest.mark.parametrize("quant", [False, True], ids=("model", "int8"))
@pytest.mark.parametrize("layout", [(8, 4, 160), (4, 1, 128)],
                         ids=("gqa-dh160", "mha-dh128"))
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
