"""Tensor-parallel packed serving on 2 gloo processes on the CPU, under
meshes (data 1, model 2) and (data 2, model 1), against the port's
single-process run and the reference's single-device ``greedy_decode``.

One process group per mesh shape (``runtime.mesh.spawn``, one thread a
rank, its own timeout) runs every case (``torch_tp_worker.run_cases``)
and hands the results back; each test reads its case. Cases, f32:

- ``mixed``: stablelm_12b SMOKE under the reference test's mixed plan
  (``attn.wo=wanda; attn.wq=sparsegpt@pattern=2:4;
  mlp.w_gate=hassle@rank=4; *=slab``): every rank packs the
  decompositions and cuts its shards as it packs;
- ``odd``: llama2_7b SMOKE with d_ff 345 under ``*=hassle@rank=8``: the
  MLP's w_gate / w_up (d_out 345) replicate, the rest row-shard with u
  (rank 8) sharded too;
- ``phi`` / ``deepseek``: the MoE SMOKE configs (deepseek with shared
  experts), slab, expert-parallel;
- ``vlm``: qwen2_vl_2b SMOKE, slab, on M-RoPE positions;
- ``dense``: ``mixed``'s dense-equivalent weights served unpacked:
  dense weights shard over "model" (column- or row-parallel) and over
  "data", half of each linear a rank;
- ``int8``: the ``mixed`` model on an int8 KV cache: under "model" 2
  the contiguous cache shards its positions, int8 payloads and scales;
- ``engine`` / ``engine8``: the ``mixed`` model through the engine on
  kv-head-sharded pools (``engine8``: int8 pools and scales), rank 0
  scheduling.

Logits are held within rel 1e-5 of the port's single-process run, and
greedy tokens equal the reference's single-device ``greedy_decode`` on
the same dense-equivalent weights, carried to the reference's
layer-stacked layout (``mixed``'s logits also within rel 1e-4 of the
reference's decode of them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_worker as worker
from repro import configs as ref_configs
from repro.launch import serve as ref_serve
from repro.models import lm as ref_lm
from repro.models.common import positions_for as ref_positions_for
from repro_torch.core.packed_model import pack_model
from repro_torch.core.pipeline import compress_model
from repro_torch.core.slab import SLaBConfig
from repro_torch.data import calibration_batch
from repro_torch.launch.serve import greedy_decode
from repro_torch.models import lm
from repro_torch.runtime.mesh import spawn

MIXED = ("attn.wo=wanda; attn.wq=sparsegpt@pattern=2:4; "
         "mlp.w_gate=hassle@rank=4; *=slab")
# s_max of both greedy_decode (PROMPT + GEN) and the teacher-forced decode
# (PROMPT + 2) even: under "model" 2 the contiguous cache shards its
# positions and the softmax combines across the ranks
B, PROMPT, GEN = 2, 6, 4
GROUP_TIMEOUT = 240.0


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _prompts(case, vocab, seed):
    case["prompts"] = _tokens(seed, (B, PROMPT), vocab)
    case["gen_len"] = GEN
    case["teacher"] = _tokens(seed + 1, (B, PROMPT + 2), vocab)


def _port_case(arch, plan, over=None, seed=2):
    """The port compresses ``arch`` SMOKE (f32) under ``plan``."""
    case = {"arch": arch, "plan": plan, "over": over or {}}
    cfg = worker.case_cfg(case)
    params = lm.init(cfg, seed=0, device="cpu")
    calib = calibration_batch(cfg.vocab, seed=0, n_seq=2, seq_len=32)
    case["dense"], _, case["decs"] = compress_model(
        cfg, params, calib, plan=plan, scfg=SLaBConfig(cr=0.5, iters=2),
        keep_decompositions=True, device="cpu")
    _prompts(case, cfg.vocab, seed)
    return case


def _ref_params(params: dict) -> dict:
    """The port's (dense) params in the reference's layout: the layer
    list stacked leaf by leaf on a leading L dim."""
    def stack(ls):
        if isinstance(ls[0], dict):
            return {k: stack([d[k] for d in ls]) for k in ls[0]}
        return jnp.asarray(np.stack([t.numpy() for t in ls]))
    out = {k: jax.tree.map(lambda t: jnp.asarray(t.numpy()), v)
           for k, v in params.items() if k != "layers"}
    out["layers"] = stack(params["layers"])
    return out


def _ref_cfg(case):
    return ref_configs.get(case["arch"], smoke=True).with_(
        dtype=jnp.float32, **case.get("over", {}))


def _ref_tokens(case) -> np.ndarray:
    """The reference's greedy_decode of ``case``'s prompts on the port's
    dense-equivalent weights."""
    return np.asarray(ref_serve.greedy_decode(
        _ref_cfg(case), _ref_params(case["dense"]),
        jnp.asarray(case["prompts"]), case["gen_len"]))


def _ref_logits(case) -> np.ndarray:
    """The reference's teacher-forced decode logits (B, S, V) of
    ``case``'s teacher tokens on the same weights."""
    cfg_r, params_r = _ref_cfg(case), _ref_params(case["dense"])
    step = jax.jit(ref_lm.decode_step, static_argnums=0)
    t = case["teacher"]
    cache = ref_lm.init_cache(cfg_r, t.shape[0], t.shape[1])
    out = []
    for i in range(t.shape[1]):
        lg, cache = step(cfg_r, params_r, cache, jnp.asarray(t[:, i:i + 1]),
                         ref_positions_for(cfg_r, t.shape[0], 1, offset=i))
        out.append(np.asarray(lg[:, 0]))
    return np.stack(out, 1)


def _engine_case(mixed, over=None):
    rng = np.random.default_rng(7)
    vocab = worker.case_cfg(mixed).vocab
    reqs = [(rng.integers(0, vocab, n).astype(np.int32), g, a)
            for n, g, a in ((3, 4, 0), (9, 3, 0), (6, 5, 1), (4, 3, 2),
                            (7, 4, 3))]
    return {"arch": mixed["arch"], "plan": mixed["plan"],
            "over": over or {}, "dense": mixed["dense"],
            "decs": mixed["decs"],
            "engine": dict(n_slots=2, n_blocks=12, block_size=4,
                           max_len=16, prefill_chunk=4),
            "requests": reqs}


def _single(case):
    """The port's single-process run of ``case``."""
    cfg = worker.case_cfg(case)
    params = case["dense"]
    if case["decs"] is not None:
        params, _ = pack_model(params, case["decs"], plan=case["plan"],
                               dtype=torch.float32)
    if "engine" in case:
        return worker.run_engine(cfg, params, case, None)
    return {"tokens": greedy_decode(cfg, params, case["prompts"],
                                    case["gen_len"], device="cpu").numpy(),
            "logits": worker.decode_logits(cfg, params, case["teacher"])}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread in this process while the module runs, as in the
    ranks: its tiny ops gain nothing from more, and beside other busy
    processes a team of threads waits on every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cases():
    mixed = _port_case("stablelm_12b", MIXED, seed=1)
    cs = {"mixed": mixed,
          "odd": _port_case("llama2_7b", "*=hassle@rank=8",
                            over={"d_ff": 345}),
          "phi": _port_case("phi3_5_moe", "*=slab"),
          "deepseek": _port_case("deepseek_moe_16b", "*=slab"),
          "vlm": _port_case("qwen2_vl_2b", "*=slab"),
          "dense": {**mixed, "decs": None},
          "int8": {**mixed, "over": {"kv_quant": True}},
          "engine": _engine_case(mixed),
          "engine8": _engine_case(mixed, {"kv_quant": True})}
    single = {k: _single(c) for k, c in cs.items()}
    tokens = {k: _ref_tokens(c) for k, c in cs.items()
              if "engine" not in c and k != "dense"}
    tokens["dense"] = tokens["mixed"]        # the same dense-equivalent
    return cs, single, {"tokens": tokens, "logits": _ref_logits(mixed)}


@pytest.fixture(scope="module", params=["1x2", "2x1"])
def tp(request, cases, tmp_path_factory):
    """Every case on one (data, model) process group: (mesh, results by
    rank, the cases, the single-process results, the reference's)."""
    data, model = map(int, request.param.split("x"))
    cs, single, ref = cases
    init = tmp_path_factory.mktemp(f"pg{request.param}") / "store"
    per_rank = spawn(worker.run_cases, data * model, "cpu", str(init),
                     args=(data, model, cs), timeout=GROUP_TIMEOUT,
                     threads=1)
    return (data, model), per_rank, cs, single, ref


def _held(tp, name):
    (data, model), per_rank, cs, single, ref = tp
    got = per_rank[0][name]
    for other in per_rank[1:]:
        if "tokens" in got:
            np.testing.assert_array_equal(other[name]["tokens"],
                                          got["tokens"])
    if "logits" in got:
        assert got["logits"].shape == single[name]["logits"].shape
        assert _rel(got["logits"], single[name]["logits"]) < 1e-5
        np.testing.assert_array_equal(got["tokens"], single[name]["tokens"])
        np.testing.assert_array_equal(got["tokens"], ref["tokens"][name])
    return (data, model), got, per_rank


def test_mixed_plan_matches_single_process_and_reference(tp):
    (data, model), got, per_rank = _held(tp, "mixed")
    assert _rel(got["logits"], tp[4]["logits"]) < 1e-4
    variants = {v[3] for v in got["layouts"].values()}
    assert {"sparse-nm", "lowrank-ell", "slab-ell"} <= variants
    for path, (rows, d_out, u_rows, var, rank) in got["layouts"].items():
        assert rows * model == d_out, path      # every d_out divides
        if u_rows is not None:                  # ranks < 8: u whole
            assert u_rows == d_out, path
    if model > 1:
        assert got["bytes"] < got["bytes_whole"]
    else:
        assert got["bytes"] == got["bytes_whole"]
    for res in per_rank:                 # tree_shard / unshard / PackPlacer
        rt = res["mixed"]["roundtrip"]
        assert rt["placed_equal"] and rt["unshard_exact"] and rt["n"], rt


def test_odd_d_out_replicates(tp):
    (data, model), got, _ = _held(tp, "odd")
    lay = got["layouts"]
    for l in range(2):
        for name in ("mlp.w_gate", "mlp.w_up"):
            rows, d_out, *_ = lay[f"{l}/{name}"]
            assert d_out == 345 and rows == 345
        rows, d_out, *_ = lay[f"{l}/mlp.w_down"]
        assert rows * model == d_out == 128


def test_u_row_sharded_at_rank_8(tp):
    (data, model), got, _ = _held(tp, "odd")
    rows, d_out, u_rows, var, rank = got["layouts"]["0/attn.wq"]
    assert var == "lowrank-ell" and rank == 8
    assert u_rows == rows == d_out // model


@pytest.mark.parametrize("name", ["phi", "deepseek"])
def test_moe_expert_parallel(tp, name):
    (data, model), got, _ = _held(tp, name)
    groups = [g for k, v in got["layouts"].items() if isinstance(v, list)
              for g in v]
    assert groups
    for n_mem, held, rows, d_out in groups:
        if model > 1 and n_mem % model == 0:
            assert (held, rows) == (n_mem // model, d_out)   # experts
        elif model > 1 and d_out % model == 0:
            assert (held, rows) == (n_mem, d_out // model)   # rows
        else:
            assert (held, rows) == (n_mem, d_out)
    if model > 1:
        assert any(h < n for n, h, _, _ in groups)
    if name == "deepseek":
        assert any(".shared." in k for k in got["layouts"])


def test_vlm_on_mrope_positions(tp):
    _held(tp, "vlm")


def test_dense_weights_shard_over_model(tp):
    """Served unpacked, every dense linear is cut by its specs: over
    "model" on its heads / kv / ffn dim and over "data" on its embed dim,
    so a rank holds half of each (the norms only over "data"), and the
    logits equal the single process's (``_held``)."""
    (data, model), got, per_rank = _held(tp, "dense")
    assert got["bytes"] == 0
    for res in per_rank:
        shards = dict(res["dense"]["dense_shards"])
        held = res["dense"]["dense_held"]
        linears = [p for p in held if ".attn." in p or ".mlp." in p]
        assert len(linears) == 2 * 7
        for path in linears:
            local, whole = held[path]
            assert 2 * local == whole, path
        if model > 1:
            assert "model" in shards["embed."]
            assert shards["layers.0.attn.wq."][1] == "model"
            assert shards["layers.0.mlp.w_down."][0] == "model"
            assert "layers.0.attn_norm." not in shards
        if data > 1:                        # FSDP: norms and linears
            assert shards["layers.0.attn.wq."][0] == "data"
            assert shards["layers.0.attn_norm."] == ("data",)


def test_int8_kv_cache_on_split_positions(tp):
    (data, model), got, _ = _held(tp, "int8")
    assert got["cache"]["k"] == "torch.int8"
    assert got["cache"]["seq_lo"] == 0      # rank 0's positions first
    assert got["cache"]["positions"] == (PROMPT + GEN) // model


def _engine_held(tp, name):
    (data, model), per_rank, cs, single, _ = tp
    got, want = per_rank[0][name], single[name]
    assert got["statuses"] == want["statuses"] == ["finished"] * 5
    assert got["streams"] == want["streams"]
    assert got["free"] == got["n_blocks"]
    cfg = worker.case_cfg(cs[name])
    assert got["kv_local"][2] == cfg.n_kv // model
    return got


def test_engine_streams_equal_single_process(tp):
    assert _engine_held(tp, "engine")["kv_dtype"] == "torch.float32"


def test_engine_on_int8_pools(tp):
    assert _engine_held(tp, "engine8")["kv_dtype"] == "torch.int8"


def test_serve_cli_mesh_under_torchrun(capsys):
    """``serve --mesh 1,2`` launched by torchrun on the CPU: the mesh and
    backend lines, every rank's packed leaves checksummed equal, half the
    plane bytes a rank, and the sample generation of the single-process
    CLI."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    from repro_torch.launch import serve
    args = ["--arch", "stablelm_12b", "--packed", "--device", "cpu",
            "--iters", "1", "--calib-seqs", "2", "--calib-len", "16",
            "--batch", "2", "--prompt-len", "4", "--gen-len", "4"]
    serve.main(args)
    want = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("sample generation:"))
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve", *args,
         "--mesh", "1,2"], capture_output=True, text=True, env=env,
        timeout=GROUP_TIMEOUT, cwd=root)
    assert run.returncode == 0, run.stderr[-3000:]
    out = run.stdout.splitlines()
    assert "process group: backend gloo over 2 ranks (CPU tensors)" in out
    assert ("mesh: data=1 x model=2 over 2 ranks (backend gloo, device "
            "cpu)") in out
    placed = next(ln for ln in out if ln.startswith("placed:"))
    assert placed.startswith("placed: 14 packed leaves, checksums equal "
                             "on 2 ranks")
    assert [ln for ln in out if ln.startswith("sample generation:")] == [
        want]                                   # rank 0 alone prints
