"""The per-linear kernels of the port's second and third slices (plain
versions on the CPU) against the reference Pallas kernels in interpret
mode, and the packed variants of the port against the reference's on
bridged planes.

Inputs are numpy arrays from a seed, handed to both sides (the port's
through ``bridge``). Kernel comparisons are f32 at max|diff| / max|ref|
< 1e-5 and run at K = 344, the llama2_7b SMOKE d_ff (not a multiple of
32: these kernels carry no sign words), except binlr's at K = 128.
"""
import functools
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packed_model as ref_pm
from repro.core import packing as ref_packing
from repro.core.slab import SLaBDecomposition as RefDec
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro_torch import bridge
from repro_torch.core import packed_model
from repro_torch.kernels import ops, ref

TOL = 1e-5
N, K = 96, 344
t = functools.partial(bridge.tensor, device="cpu")


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _keep_rows(w, keep):
    """The top-|w| ``keep`` fraction of each row of w."""
    kk = max(1, int(keep * w.shape[1]))
    thr = -np.sort(-np.abs(w), axis=1)[:, kk - 1:kk]
    return np.where(np.abs(w) >= thr, w, 0.0).astype(np.float32)


def _keep_nm(w, pattern):
    n_keep, m_pat = map(int, pattern.split(":"))
    g = np.abs(w).reshape(w.shape[0], -1, m_pat)
    thr = -np.sort(-g, axis=-1)[..., n_keep - 1:n_keep]
    return np.where((g >= thr).reshape(w.shape), w, 0.0).astype(np.float32)


def _inputs(seed, m, rank, k=K, n=N):
    """Seeded x (m, k), w (n, k), u (n, R), v (k, R)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    u = rng.standard_normal((n, rank)).astype(np.float32) * 0.2
    v = rng.standard_normal((k, rank)).astype(np.float32) * 0.2
    return x, w, u, v


def _uv(u, v, rank):
    """Rank 1 goes in as vectors (the (N,) / (K,) form of the contract)."""
    return (u[:, 0], v[:, 0]) if rank == 1 else (u, v)


def _ell(w_s, wide):
    """Reference ELL planes; ``wide`` re-types the ids as uint32."""
    ep = ref_packing.ell_pack(jnp.asarray(w_s))
    idx = ep.indices.astype(jnp.uint32) if wide else ep.indices
    return ep.values, idx


# ------------------------------------------------------------- kernels

@pytest.mark.parametrize("m", [1, 5, 37])
@pytest.mark.parametrize("ids", ["int16", "int32"])
def test_ell_matmul_matches_reference_kernel(m, ids):
    x, w, _, _ = _inputs(m, m, 1)
    vals, idx = _ell(_keep_rows(w, 0.41), ids == "int32")
    want = ref_ops.ell_matmul(jnp.asarray(x), vals, idx, interpret=True)
    got = ops.ell_matmul(t(x), t(vals), t(idx))
    assert t(idx).dtype == getattr(torch, ids)
    assert got.dtype == torch.float32 and got.shape == (m, N)
    assert _rel(got, want) < TOL
    oracle = ref.ell_matmul_ref(t(x), t(vals), t(idx), K)
    assert _rel(oracle, ref_oracles.ell_matmul_ref(
        jnp.asarray(x), vals, idx, K)) < TOL


@pytest.mark.parametrize("m", [1, 5, 37])
@pytest.mark.parametrize("rank", [1, 3])
def test_ell_lr_matmul_matches_reference_kernel(m, rank):
    x, w, u, v = _inputs(10 + m + rank, m, rank)
    vals, idx = _ell(_keep_rows(w, 0.49), wide=(m == 5))
    uu, vv = _uv(u, v, rank)
    want = ref_ops.ell_lr_matmul(jnp.asarray(x), vals, idx, jnp.asarray(uu),
                                 jnp.asarray(vv), interpret=True)
    got = ops.ell_lr_matmul(t(x), t(vals), t(idx), t(uu), t(vv))
    assert got.shape == (m, N)
    assert _rel(got, want) < TOL
    oracle = ref.ell_lr_matmul_ref(t(x), t(vals), t(idx), K, t(uu), t(vv))
    assert _rel(oracle, ref_oracles.ell_lr_matmul_ref(
        jnp.asarray(x), vals, idx, K, jnp.asarray(uu),
        jnp.asarray(vv))) < TOL


@pytest.mark.parametrize("m", [1, 5, 37])
@pytest.mark.parametrize("rank", [1, 3])
def test_slab_lr_matmul_matches_reference_kernel(m, rank):
    x, w, u, v = _inputs(20 + m + rank, m, rank)
    w_s = _keep_rows(w, 0.6)
    uu, vv = _uv(u, v, rank)
    want = ref_ops.slab_lr_matmul(jnp.asarray(x), jnp.asarray(w_s),
                                  jnp.asarray(uu), jnp.asarray(vv),
                                  interpret=True)
    got = ops.slab_lr_matmul(t(x), t(w_s), t(uu), t(vv))
    assert got.shape == (m, N)
    assert _rel(got, want) < TOL
    oracle = ref.slab_lr_matmul_ref(t(x), t(w_s), t(uu), t(vv))
    assert _rel(oracle, ref_oracles.slab_lr_matmul_ref(
        jnp.asarray(x), jnp.asarray(w_s), jnp.asarray(uu),
        jnp.asarray(vv))) < TOL


@pytest.mark.parametrize("m", [1, 5, 37])
@pytest.mark.parametrize("pattern", ["2:4", "4:8"])
def test_nm_matmul_matches_reference_kernel(m, pattern):
    x, w, _, _ = _inputs(30 + m, m, 1)
    n_keep, m_pat = map(int, pattern.split(":"))
    nm = ref_packing.pack_nm(jnp.asarray(_keep_nm(w, pattern)), n_keep,
                             m_pat)
    want = ref_ops.nm_matmul(jnp.asarray(x), nm.values, nm.indices, m_pat,
                             interpret=True)
    got = ops.nm_matmul(t(x), t(nm.values), t(nm.indices), m_pat)
    assert got.shape == (m, N)
    assert _rel(got, want) < TOL
    oracle = ref.nm_matmul_ref(t(x), t(nm.values), t(nm.indices), m_pat)
    assert _rel(oracle, want) < TOL


@pytest.mark.parametrize("m", [1, 5, 37])
@pytest.mark.parametrize("pattern,rank", [("2:4", 1), ("4:8", 3)])
def test_slab_nm_lr_matmul_matches_reference_kernel(m, pattern, rank):
    x, w, u, v = _inputs(40 + m + rank, m, rank)
    n_keep, m_pat = map(int, pattern.split(":"))
    nm = ref_packing.pack_nm(jnp.asarray(_keep_nm(w, pattern)), n_keep,
                             m_pat)
    uu, vv = _uv(u, v, rank)
    want = ref_ops.slab_nm_lr_matmul(jnp.asarray(x), nm.values, nm.indices,
                                     m_pat, jnp.asarray(uu), jnp.asarray(vv),
                                     interpret=True)
    got = ops.slab_nm_lr_matmul(t(x), t(nm.values), t(nm.indices), m_pat,
                                t(uu), t(vv))
    assert got.shape == (m, N)
    assert _rel(got, want) < TOL
    oracle = ref.slab_nm_lr_matmul_ref(t(x), t(nm.values), t(nm.indices),
                                       m_pat, t(uu), t(vv))
    assert _rel(oracle, ref_oracles.slab_nm_lr_matmul_ref(
        jnp.asarray(x), nm.values, nm.indices, m_pat, jnp.asarray(uu),
        jnp.asarray(vv))) < TOL


@pytest.mark.parametrize("m", [1, 5, 37])
@pytest.mark.parametrize("rank", [1, 3])
def test_binlr_matmul_matches_reference_kernel(m, rank):
    x, _, u, v = _inputs(50 + m + rank, m, rank, k=128)
    signs = np.where(np.random.default_rng(m).random((N, 128)) < 0.5, 1,
                     -1).astype(np.int8)
    bp = ref_packing.pack_sign_bits(jnp.asarray(signs))
    uu, vv = _uv(u, v, rank)
    want = ref_ops.binlr(jnp.asarray(x), bp, jnp.asarray(uu),
                         jnp.asarray(vv), interpret=True)
    got = ops.binlr(t(x), t(bp), t(uu), t(vv))
    assert got.shape == (m, N)
    assert _rel(got, want) < TOL
    assert _rel(ref.binlr_ref(t(x), t(bp), t(uu), t(vv)), want) < TOL


def test_lowrank_projection_is_not_rounded_through_bf16():
    """The plain low-rank term forms x @ Vᵀ from fp32 copies, as the
    reference kernels do (the binary term rounds x ⊙ v to x.dtype)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((2, 5)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32))
    xb, ub, vb = x.bfloat16(), u.bfloat16(), v.bfloat16()
    from repro_torch.kernels.common import lowrank_term
    want = (xb.double() @ vb.double().T) @ ub.double()
    got = lowrank_term(xb, ub, vb)
    assert got.dtype == torch.float32
    assert _rel(got, want) < 1e-6


# ------------------------------------------------------ packed variants
#
# One decomposition per kind, at (N, 128): K a multiple of 32 so that the
# slab-* and binlr kinds have sign words.

KP = 128


def _dec(kind, seed=0):
    """A reference decomposition of the given kind: (dec, pattern)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((N, KP)) * 0.1).astype(np.float32)
    u = np.abs(rng.standard_normal((N, 2))).astype(np.float32) * 0.2
    v = np.abs(rng.standard_normal((KP, 2))).astype(np.float32) * 0.2
    w_b = np.where(rng.random((N, KP)) < 0.5, 1, -1).astype(np.int8)
    empty_u = np.zeros((N, 0), np.float32)
    empty_v = np.zeros((KP, 0), np.float32)
    empty_b = np.zeros((0, 0), np.int8)
    sparse, terms = kind.split("-") if "-" in kind else ("", kind)
    pattern = "2:4" if sparse == "nm" else None
    w_s = {"ell": _keep_rows(w, 0.3), "dense": _keep_rows(w, 0.8),
           "half": _keep_rows(w, 0.5), "nm": _keep_nm(w, "2:4"),
           "": np.zeros_like(w)}[sparse]
    uu, vv, bb = {"slab": (u, v, w_b), "binlr": (u, v, w_b),
                  "lowrank": (u, v, empty_b),
                  "sparse": (empty_u, empty_v, empty_b)}[terms]
    dec = RefDec(jnp.asarray(w_s), jnp.asarray(uu), jnp.asarray(vv),
                 jnp.asarray(bb))
    return dec, pattern


# the kind names read "<sparse part>-<other terms>"
KINDS = ["ell-slab", "nm-slab", "dense-slab", "binlr", "ell-lowrank",
         "nm-lowrank", "dense-lowrank", "lowrank", "ell-sparse", "nm-sparse",
         "dense-sparse", "half-sparse", "half-lowrank"]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_variant_of_equals_reference(kind, itemsize):
    dec, pattern = _dec(kind)
    want = ref_pm.variant_of(dec, pattern, itemsize=itemsize)
    got = packed_model.variant_of(bridge.decomposition(dec, device="cpu"), pattern,
                                  itemsize=itemsize)
    assert got == want
    if kind.startswith("half"):     # K_max = D_in/2: ELL only at f32
        assert got.endswith("-ell" if itemsize == 4 else "-dense")


def test_all_eleven_variants_are_classified():
    seen = {ref_pm.variant_of(_dec(kind)[0], _dec(kind)[1], itemsize=4)
            for kind in KINDS}
    assert seen == set(packed_model.VARIANTS)


PORTED = [k for k in KINDS if not k.startswith("half")]


@pytest.mark.parametrize("kind", PORTED)
def test_packed_matmul_matches_reference(kind):
    """The reference's packed planes, bridged, through the port's
    ``packed_matmul``; and the port's own packing of the same bridged
    decomposition is byte-identical to them."""
    dec, pattern = _dec(kind, seed=3)
    pl_r = ref_pm.pack_linear(dec, pattern, jnp.float32)
    pl = bridge.packed_linear(pl_r, device="cpu")
    assert pl.variant in packed_model.VARIANTS
    x = np.random.default_rng(5).standard_normal((2, 3, KP)).astype(
        np.float32)
    want = ref_pm.packed_matmul(jnp.asarray(x), pl_r, interpret=True)
    got = packed_model.packed_matmul(t(x), pl)
    assert got.shape == (2, 3, N)
    assert _rel(got, want) < TOL
    own = packed_model.pack_linear(bridge.decomposition(dec, device="cpu"), pattern,
                                   torch.float32)
    for f in ("sparse_vals", "sparse_idx", "b_packed", "u", "v"):
        a, b = getattr(own, f), getattr(pl, f)
        assert (a is None) == (b is None), f
        assert a is None or torch.equal(a, b), f
    assert own.nbytes() == pl.nbytes()


def test_new_cuda_wrappers_refuse_cpu_tensors():
    """The kernel entry points take CUDA tensors only; ``ops`` routes a
    CPU tensor to the plain version, never the other way round."""
    from repro_torch.kernels import ell as ell_k
    from repro_torch.kernels import nm_sparse as nm_k
    from repro_torch.kernels import slab_matmul as slab_k
    x, w, u, v = _inputs(1, 2, 1)
    vals, idx = _ell(_keep_rows(w, 0.4), False)
    u2, v2 = t(u).T.contiguous(), t(v).T.contiguous()
    with pytest.raises(ValueError, match="expected"):
        ell_k.ell_matmul(t(x), t(vals), t(idx))
    with pytest.raises(ValueError, match="expected"):
        ell_k.ell_lr_matmul(t(x), t(vals), t(idx), u2, v2)
    with pytest.raises(ValueError, match="expected"):
        slab_k.slab_lr_matmul(t(x), t(w), u2, v2)
    nm = ref_packing.pack_nm(jnp.asarray(_keep_nm(w, "2:4")), 2, 4)
    with pytest.raises(ValueError, match="expected"):
        nm_k.nm_matmul(t(x), t(nm.values), t(nm.indices), 4)
    assert ell_k.ELL.launches == ell_k.ELL_LR.launches == 0
    assert slab_k.SLAB_LR.launches == nm_k.NM.launches == 0
    assert nm_k.NM_FIRST.launches == ell_k.ELL_LR_FIRST.launches == 0


def test_slice3_cuda_wrappers_refuse_cpu_tensors():
    """binlr, slab_nm_lr and both flash-decode entry points take CUDA
    tensors only; nothing is launched or counted for a CPU tensor."""
    from repro_torch.kernels import binlr as binlr_k
    from repro_torch.kernels import flash_decode as fd_k
    from repro_torch.kernels import slab_matmul as slab_k
    x, w, u, v = _inputs(2, 2, 1)
    u2, v2 = t(u).T.contiguous(), t(v).T.contiguous()
    nm = ref_packing.pack_nm(jnp.asarray(_keep_nm(w, "2:4")), 2, 4)
    with pytest.raises(ValueError, match="expected"):
        slab_k.slab_nm_lr_matmul(t(x), t(nm.values), t(nm.indices), 4, u2,
                                 v2)
    xb = torch.zeros(2, 128)
    with pytest.raises(ValueError, match="expected"):
        binlr_k.binlr_matmul(xb, torch.zeros(3, 4, dtype=torch.int32),
                             torch.zeros(1, 3), torch.zeros(1, 128))
    q = torch.zeros(2, 2, 1, 16)
    cache = torch.zeros(2, 8, 2, 16)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="expected"):
        fd_k.flash_decode(q, cache, cache, lens)
    with pytest.raises(ValueError, match="expected"):
        fd_k.flash_decode_paged(q, cache, cache,
                                torch.zeros(2, 1, dtype=torch.int32), lens)
    assert slab_k.SLAB_NM_LR.launches == binlr_k.BINLR.launches == 0
    assert binlr_k.BINLR_FIRST.launches == 0
    assert slab_k.SLAB_NM_LR_FIRST.launches == 0
    assert fd_k.FLASH_DECODE.launches == fd_k.FLASH_DECODE_PAGED.launches \
        == 0


def test_serve_cli_packs_hassle_2_4_as_lowrank_nm(capsys):
    """HASSLE-free under 2:4 on llama2_7b SMOKE packs every linear as
    lowrank-nm (kernel #7's plain version on the CPU). One intra-op
    thread: the float64 SVDs crawl when the suite's parallel workers
    oversubscribe the cores."""
    from repro_torch.launch import serve
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        serve.main(["--arch", "llama2_7b", "--compress", "hassle",
                    "--pattern", "2:4", "--packed", "--device", "cpu",
                    "--iters", "1", "--calib-seqs", "2", "--calib-len",
                    "16", "--batch", "2", "--prompt-len", "4",
                    "--gen-len", "2"])
    finally:
        torch.set_num_threads(n_threads)
    out = capsys.readouterr().out
    assert "packed serving: 14 linears" in out
    assert "[lowrank-nm=14]" in out
    assert "sample generation:" in out


def test_ctypes_argtypes_match_the_c_signatures():
    """Every wrapper's ctypes argtypes list has one entry per parameter
    of its ``extern "C"`` entry, a pointer (c_void_p) exactly where the C
    side takes one: ctypes passes an extra argument as a 32-bit int and
    cuts a pointer. A second library under one C name may take its own
    parameters (``by_source``)."""
    import ctypes
    import re
    from pathlib import Path

    from repro_torch.kernels import binlr as binlr_k
    from repro_torch.kernels import build
    from repro_torch.kernels import ell as ell_k
    from repro_torch.kernels import flash_decode as fd_k
    from repro_torch.kernels import grouped as g_k
    from repro_torch.kernels import nm_sparse as nm_k
    from repro_torch.kernels import slab_matmul as slab_k
    argtypes = {
        "slab_ell_matmul": ell_k._ARGS, "ell_matmul": ell_k._ELL_ARGS,
        "ell_lr_matmul": ell_k._ELL_LR_ARGS,
        "slab_matmul": slab_k._DENSE_ARGS, "slab_nm_matmul": slab_k._NM_ARGS,
        "slab_lr_matmul": slab_k._LR_ARGS,
        "slab_nm_lr_matmul": slab_k._NM_LR_ARGS, "nm_matmul": nm_k._ARGS,
        "binlr_matmul": binlr_k._ARGS, "flash_decode": fd_k._CONTIG_ARGS,
        "flash_decode_paged": fd_k._PAGED_ARGS,
        "slab_ell_matmul_g": g_k._SLAB_ELL_ARGS, "nm_matmul_g": g_k._NM_ARGS,
        "slab_matmul_g": g_k._SLAB_ARGS, "slab_nm_matmul_g": g_k._SLAB_NM_ARGS,
        "ell_matmul_g": g_k._ELL_ARGS, "ell_lr_matmul_g": g_k._ELL_LR_ARGS,
        "slab_lr_matmul_g": g_k._LR_ARGS,
        "slab_nm_lr_matmul_g": g_k._NM_LR_ARGS,
        "binlr_matmul_g": g_k._BINLR_ARGS}
    assert set(argtypes) == {k.name for k in ops.KERNELS}
    by_source = {("slab_nm_matmul", "grouped_tc.cu"): slab_k._NM_TC_ARGS,
                 ("slab_nm_matmul_g", "grouped_tc.cu"): g_k._SLAB_NM_TC_ARGS,
                 ("binlr_matmul_g", "grouped_tc.cu"): g_k._BINLR_TC_ARGS,
                 ("binlr_matmul", "grouped_tc.cu"): binlr_k._TC_ARGS,
                 ("nm_matmul_g", "grouped_tc.cu"): g_k._NM_TC_ARGS,
                 ("nm_matmul", "grouped_tc.cu"): nm_k._TC_ARGS,
                 ("slab_nm_lr_matmul", "grouped_tc.cu"):
                     slab_k._NM_LR_TC_ARGS,
                 ("slab_ell_matmul", "grouped_tc.cu"):
                     ell_k._SLAB_ELL_TC_ARGS,
                 ("ell_lr_matmul", "grouped_tc.cu"): ell_k._ELL_LR_TC_ARGS,
                 ("slab_matmul", "grouped_tc.cu"): slab_k._DENSE_TC_ARGS,
                 ("slab_matmul_g", "grouped_tc.cu"): g_k._SLAB_TC_ARGS,
                 ("ell_matmul", "grouped_tc.cu"): ell_k._ELL_TC_ARGS,
                 ("slab_lr_matmul", "grouped_tc.cu"): slab_k._LR_TC_ARGS}
    seen, seen_by_source = set(), set()
    for src in build.SOURCES:
        text = (Path(build.CSRC) / src).read_text()
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', text):
            kinds = [ctypes.c_void_p if ("*" in p_) else ctypes.c_int
                     for p_ in params.split(",")]
            assert by_source.get((name, src), argtypes[name]) == kinds, name
            seen.add(name)
            seen_by_source.add((name, src))
    assert seen == set(argtypes)
    assert set(by_source) <= seen_by_source
