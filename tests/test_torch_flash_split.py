"""The split plan of the flash-decode kernels (#10, #11) and their
split-then-combine arithmetic, on the CPU: ``plan_splits`` covers every
token of every row once, and ``split_attend_plain`` equals the masked
softmax (``_attend``) and the reference Pallas kernels in interpret mode
on the same numpy inputs. (The CUDA kernels against the plain versions:
``tests/test_torch_cuda.py``, on a card.)

Tolerance: f32, max|split - ref| <= 1e-5 · max|ref| (the splits sum in
another order than one softmax).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode, flash_decode_paged
from repro_torch import bridge
from repro_torch.kernels import flash_decode as fd_k
from test_torch_flash_decode import _mk, _quant, _scatter_to_pool

t = functools.partial(bridge.tensor, device="cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PLANS = [  # (rows, kv, head chunks, n_max, SMs)
    (8, 32, 1, 4096, 132),      # chip_smoke's FD_TIMED
    (8, 8, 1, 4096, 132),       # stablelm-12b
    (8, 32, 1, 4100, 132),      # S not a multiple of the reference chunk
    (4, 32, 1, 320, 132),       # the engine's decode shape
    (4, 32, 1, 48, 132),        # one split, shorter than a tile multiple
    (4, 32, 1, 256, 132),       # one split per row
    (1, 1, 1, 100_000, 132),    # capped by MAX_SPLITS' reach
    (3, 2, 2, 7, 1),
]


@pytest.mark.parametrize("plan", PLANS, ids=str)
def test_plan_splits_covers_every_token_once(plan):
    rows, kv, chunks, n_max, n_sm = plan
    n_split, split_len = fd_k.plan_splits(rows, kv, chunks, n_max, n_sm)
    assert 1 <= n_split <= fd_k.MAX_SPLITS
    assert split_len % fd_k.TILE == 0
    assert (n_split - 1) * split_len < n_max <= n_split * split_len
    if n_split > 1:
        assert split_len >= fd_k.MIN_SPLIT
    for length in {0, 1, 31, 32, 33, split_len - 1, split_len,
                   split_len + 1, n_max - 1, n_max}:
        if not 0 <= length <= n_max:
            continue
        seen = np.zeros(n_max, np.int64)
        for i in range(n_split):                 # the live splits
            t0 = i * split_len
            if t0 < length:
                seen[t0:min(t0 + split_len, length)] += 1
        assert (seen[:length] == 1).all() and (seen[length:] == 0).all()


def test_plan_splits_one_split_when_the_grid_is_full_or_rows_short():
    """Rows x heads that already fill the card, or rows shorter than two
    MIN_SPLIT runs, get one split (the kernel then writes out itself and
    the merge is not launched)."""
    full = fd_k.SPLIT_BLOCKS_PER_SM * 132 // 32          # rows at KV 32
    assert fd_k.plan_splits(full, 32, 1, 4096, 132) == (1, 4096)
    assert fd_k.plan_splits(4, 32, 1, 2 * fd_k.MIN_SPLIT - 1, 132)[0] == 1
    assert fd_k.plan_splits(4, 32, 1, 2 * fd_k.MIN_SPLIT, 132)[0] == 2


@pytest.mark.parametrize("g,dh", [(1, 128), (4, 160), (6, 128), (12, 192),
                                  (32, 256), (300, 16), (7, 20)])
def test_head_chunk_covers_the_group(g, dh):
    gc = fd_k.head_chunk(g, dh)
    units = -(-dh // 16) * 2
    assert 1 <= gc <= min(g, fd_k.MAX_HEADS)
    assert gc * units <= fd_k.MAX_UNITS
    n = -(-g // gc)
    assert (n - 1) * gc < g                      # no empty chunk
    if g * units <= fd_k.MAX_UNITS and g <= fd_k.MAX_HEADS:
        assert gc == g


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


CONTIG = [  # (case (B, KV, G, dh, S, bs), lengths, split_len)
    ((4, 2, 3, 32, 100, 32), [0, 33, 64, 100], 32),   # S_pad 128
    ((3, 1, 4, 16, 96, 64), [65, 0, 96], 64),
    ((2, 2, 1, 32, 70, 512), [69, 1], 32),            # one reference chunk
]


@pytest.mark.parametrize("quant", [False, True], ids=("model", "int8"))
@pytest.mark.parametrize("case,lengths,split_len", CONTIG, ids=str)
def test_split_combine_matches_contiguous_reference(case, lengths,
                                                    split_len, quant):
    """Length 0 (the padded-span mean), lengths across a split boundary;
    against the reference flash_decode in interpret mode and, for the
    rows with tokens, _attend."""
    q, k, v, lens = _mk(case, seed=31, lengths=lengths)
    ks = vs = None
    if quant:
        (k, ks), (v, vs) = _quant(k), _quant(v)
    s, bs = case[4], case[5]
    kf = fd_k._deq(t(k), None if ks is None else t(ks))
    vf = fd_k._deq(t(v), None if vs is None else t(vs))
    got = fd_k.split_attend_plain(t(q), kf, vf, t(lens), split_len,
                                  pad_count=fd_k._padded(s, bs) - s,
                                  skip_empty=False)
    want = flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(lens),
                        None if ks is None else jnp.asarray(ks),
                        None if vs is None else jnp.asarray(vs), bs=bs,
                        interpret=True)
    assert _rel(got, want) < 1e-5
    pos = torch.arange(s)
    valid = pos[None, :] < t(lens).long()[:, None]
    live = [i for i, l in enumerate(lengths) if l]
    assert _rel(got[live], fd_k._attend(t(q), kf, vf, valid)[live]) < 1e-5


@pytest.mark.parametrize("quant", [False, True], ids=("model", "int8"))
def test_split_combine_matches_paged_reference(quant):
    """Blocks of 16 scattered in a pool, splits of 32: a zero-length row
    (exact zeros), one token, a length across a split boundary and the
    full table."""
    case = (4, 2, 2, 32, 80, 16)
    q, k, v, lens = _mk(case, seed=32, lengths=[0, 1, 33, 80])
    ks = vs = None
    if quant:
        (k, ks), (v, vs) = _quant(k), _quant(v)
    kp, bt = _scatter_to_pool(k, 16, 24, seed=2)
    vp, _ = _scatter_to_pool(v, 16, 24, seed=2)
    ksp = vsp = None
    if quant:
        ksp, _ = _scatter_to_pool(ks, 16, 24, seed=2)
        vsp, _ = _scatter_to_pool(vs, 16, 24, seed=2)
    opt = lambda a, f: None if a is None else f(a)
    kf = fd_k.gather_rows(t(kp), opt(ksp, t), t(bt))
    vf = fd_k.gather_rows(t(vp), opt(vsp, t), t(bt))
    got = fd_k.split_attend_plain(t(q), kf, vf, t(lens), 32)
    want = flash_decode_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lens), opt(ksp, jnp.asarray), opt(vsp, jnp.asarray),
        interpret=True)
    assert _rel(got, want) < 1e-5
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    valid = torch.arange(kf.shape[1])[None, :] < t(lens).long()[:, None]
    assert _rel(got[1:], fd_k._attend(t(q), kf, vf, valid)[1:]) < 1e-5
