"""The flash-decode kernels of the port (#10 contiguous, #11 paged): their
plain versions on the CPU against the reference Pallas kernels in
interpret mode, on the same numpy inputs. (The CUDA kernels against the
plain versions: ``tests/test_torch_cuda.py``, on a card.)

Tolerances: f32 rel/abs 1e-5; bf16 rel/abs 2e-2 (as the reference's own
``tests/test_flash_decode.py``).
"""
import functools
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_oracles
from repro.kernels.flash_decode import flash_decode, flash_decode_paged
from repro_torch import bridge
from repro_torch.kernels import ops, ref

CASES = [  # (B, KV, G, dh, S, bs) — the reference suite's
    (2, 4, 3, 32, 256, 64),
    (1, 8, 4, 64, 512, 128),
    (4, 2, 12, 64, 128, 128),
    (2, 1, 1, 128, 256, 64),
]
NONDIV = [
    (2, 2, 2, 32, 100, 32),
    (1, 4, 2, 16, 7, 32),
    (2, 1, 1, 16, 33, 32),
]
DTYPES = {"f32": (jnp.float32, 1e-5), "bf16": (jnp.bfloat16, 2e-2)}
t = functools.partial(bridge.tensor, device="cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several worker
    processes at once, and oversubscribed torch threads slow these
    small CPU models by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk(case, dtype=jnp.float32, seed=0, lengths=None):
    """Seeded q (pre-scaled), k, v (as ``dtype``) and lengths in 1..S."""
    b, kv, g, dh, s, _ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv, g, dh)).astype(np.float32) * dh ** -0.5
    k = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    if lengths is None:
        lengths = rng.integers(1, s + 1, size=b)
    cast = lambda a: np.asarray(jnp.asarray(a).astype(dtype))
    return cast(q), cast(k), cast(v), np.asarray(lengths, np.int32)


def _quant(a):
    """The reference's per-(token, head) absmax int8 quantization."""
    sc = np.maximum(np.abs(a).max(-1) / 127.0, 1e-8).astype(np.float32)
    qv = np.clip(np.round(a / sc[..., None]), -127, 127).astype(np.int8)
    return qv, sc


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _contig(q, k, v, lengths, bs, ks=None, vs=None):
    """(port plain, reference interpret) outputs of kernel #10."""
    want = flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(lengths),
                        None if ks is None else jnp.asarray(ks),
                        None if vs is None else jnp.asarray(vs), bs=bs,
                        interpret=True)
    got = ops.flash_decode_attention(
        t(q), t(k), t(v), t(lengths), None if ks is None else t(ks),
        None if vs is None else t(vs), bs=bs)
    return got, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_flash_decode_plain_matches_reference_kernel(case, dt):
    dtype, tol = DTYPES[dt]
    q, k, v, lengths = _mk(case, dtype)
    got, want = _contig(q, k, v, lengths, case[-1])
    assert got.dtype == t(q).dtype and got.shape == q.shape
    _close(got, want, tol)


@pytest.mark.parametrize("case", CASES[:2], ids=str)
def test_flash_decode_plain_int8(case):
    q, k, v, lengths = _mk(case)
    (kq, ks), (vq, vs) = _quant(k), _quant(v)
    got, want = _contig(q, kq, vq, lengths, case[-1], ks, vs)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("case", NONDIV, ids=str)
def test_flash_decode_plain_nondivisible(case):
    q, k, v, lengths = _mk(case)
    got, want = _contig(q, k, v, lengths, case[-1])
    _close(got, want, 1e-5)


def test_flash_decode_plain_ragged_int8():
    case = (4, 2, 3, 32, 96, 32)
    q, k, v, lengths = _mk(case, seed=3, lengths=[1, 17, 96, 40])
    (kq, ks), (vq, vs) = _quant(k), _quant(v)
    got, want = _contig(q, kq, vq, lengths, 32, ks, vs)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("quant", [False, True], ids=("model", "int8"))
def test_flash_decode_length_zero_averages_the_padded_span(quant):
    """Trap (a): the reference kernel never skips a chunk, so a length-0
    row weighs every slot of S padded to its chunk (padding as zeros)
    equally. The port's #10 returns the same; the reference's own oracle
    (softmax over the unpadded S) disagrees there."""
    case = (2, 2, 2, 16, 100, 32)           # S_pad = 128
    q, k, v, lengths = _mk(case, seed=11, lengths=[0, 37])
    ks = vs = None
    if quant:
        (k, ks), (v, vs) = _quant(k), _quant(v)
    got, want = _contig(q, k, v, lengths, 32, ks, vs)
    _close(got, want, 1e-5)
    vf = v.astype(np.float32) * (1.0 if vs is None else vs[..., None])
    mean = vf[0].sum(0) / 128.0                     # (KV, dh)
    np.testing.assert_allclose(np.asarray(got[0]),
                               np.broadcast_to(mean[:, None], got[0].shape),
                               rtol=1e-5, atol=1e-6)
    oracle = np.asarray(ref_oracles.flash_decode_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs)))
    assert not np.allclose(oracle[0], want[0], atol=1e-5)
    port_oracle = ref.flash_decode_ref(t(q), t(k), t(v), t(lengths),
                                       None if ks is None else t(ks),
                                       None if vs is None else t(vs))
    _close(port_oracle, oracle, 1e-5)


def test_flash_decode_plain_respects_length():
    case = (1, 2, 2, 16, 128, 32)
    q, k, v, _ = _mk(case, lengths=[64])
    lengths = np.array([64], np.int32)
    base = ops.flash_decode_attention(t(q), t(k), t(v), t(lengths), bs=32)
    k2, v2 = k.copy(), v.copy()
    k2[:, 64:] = 999.0
    v2[:, 64:] = -999.0
    poisoned = ops.flash_decode_attention(t(q), t(k2), t(v2), t(lengths),
                                          bs=32)
    assert torch.equal(base, poisoned)


# ---------------------------------------------------------------- paged

def _scatter_to_pool(a, bs_blk, n_blocks, seed=0):
    """Lay a contiguous (B, S, ...) cache into a shuffled block pool;
    returns the pool and the (B, n_bt) block table."""
    b, s = a.shape[:2]
    n_bt = -(-s // bs_blk)
    perm = np.random.default_rng(seed).permutation(n_blocks)[:b * n_bt]
    perm = perm.reshape(b, n_bt).astype(np.int32)
    pool = np.zeros((n_blocks, bs_blk) + a.shape[2:], a.dtype)
    pad = [(0, 0), (0, n_bt * bs_blk - s)] + [(0, 0)] * (a.ndim - 2)
    ac = np.pad(a, pad)
    for r in range(b):
        for j in range(n_bt):
            pool[perm[r, j]] = ac[r, j * bs_blk:(j + 1) * bs_blk]
    return pool, perm


def _paged(q, kp, vp, bt, lengths, ksp=None, vsp=None):
    """(port plain, reference interpret) outputs of kernel #11."""
    opt = lambda a, f: None if a is None else f(a)
    want = flash_decode_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lengths), opt(ksp, jnp.asarray), opt(vsp, jnp.asarray),
        interpret=True)
    got = ops.flash_decode_paged_attention(
        t(q), t(kp), t(vp), t(bt), t(lengths), opt(ksp, t), opt(vsp, t))
    return got, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_flash_decode_paged_plain_matches_reference_kernel(dt):
    dtype, tol = DTYPES[dt]
    q, k, v, lengths = _mk((3, 2, 2, 32, 60, 16), dtype, seed=5,
                           lengths=[60, 13, 1])
    kp, bt = _scatter_to_pool(k, 16, 16)
    vp, _ = _scatter_to_pool(v, 16, 16)
    got, want = _paged(q, kp, vp, bt, lengths)
    _close(got, want, tol)


def test_flash_decode_paged_plain_int8():
    q, k, v, lengths = _mk((2, 2, 2, 32, 48, 16), seed=7, lengths=[48, 29])
    (kq, ks), (vq, vs) = _quant(k), _quant(v)
    kp, bt = _scatter_to_pool(kq, 16, 8)
    vp, _ = _scatter_to_pool(vq, 16, 8)
    ksp, _ = _scatter_to_pool(ks, 16, 8)
    vsp, _ = _scatter_to_pool(vs, 16, 8)
    got, want = _paged(q, kp, vp, bt, lengths, ksp, vsp)
    _close(got, want, 1e-5)


def test_flash_decode_paged_plain_zero_length_rows():
    """Inactive slots (length 0) come back as exact zeros."""
    q, k, v, lengths = _mk((2, 2, 2, 16, 32, 16), seed=9, lengths=[32, 0])
    kp, bt = _scatter_to_pool(k, 16, 8)
    vp, _ = _scatter_to_pool(v, 16, 8)
    got, want = _paged(q, kp, vp, bt, lengths)
    _close(got, want, 1e-5)
    assert torch.equal(got[1], torch.zeros_like(got[1]))


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("quant", [False, True], ids=["model", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_chip_smoke_flash_bound_counts_only_the_needed_bytes(paged, quant):
    """chip_smoke's byte bound for #10/#11 counts what the function must
    read: K and V (and their scales) of each valid token; for a length-0
    row of the contiguous kernel (whose output is the mean of V) all S
    tokens of V and no K; for the paged kernel only the table entries a
    row's length reaches — plus q, out and lengths."""
    cs = _chip_smoke()
    r, kv, g, dh, s, bs = 3, 2, 2, 8, 10, 4
    lens = [0, 5, 10]
    elt = 1 if quant else 2
    kd = torch.int8 if quant else torch.bfloat16
    key = "k_pool" if paged else "k"
    a = {"q": torch.zeros((r, kv, g, dh), dtype=torch.bfloat16),
         key: torch.zeros((1, 1, kv, dh), dtype=kd),
         "lengths": torch.tensor(lens, dtype=torch.int32),
         "k_scale": torch.zeros((1, 1, kv)) if quant else None}
    k_tok = kv * dh * elt + (kv * 4 if quant else 0)     # = V per token
    v_tok = k_tok
    want = sum(l * (k_tok + v_tok) for l in lens)
    if paged:
        want += 4 * sum((l + bs - 1) // bs for l in lens)
    else:
        want += s * v_tok                                # the length-0 row
    want += 2 * r * kv * g * dh * 2 + 4 * r              # q, out, lengths
    assert cs._fd_bytes(a, s, bs, paged) == want
    ops_want = 4 * sum(lens) * kv * g * dh
    if not paged:
        ops_want += 2 * s * kv * g * dh
    assert cs._fd_ops(a, s, paged) == ops_want
