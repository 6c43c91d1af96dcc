"""The ssm, hybrid, audio, vlm and moe families on a (data, model) mesh of
2 gloo processes on the CPU, under meshes (1, 2) and (2, 1), against the
port's single process and the reference's single device. Cases, SMOKE
configs at f32:

- ``mamba`` / ``zamba``: mamba2_1_3b and zamba2_7b (the hybrid's shared
  block firing before layers 2 and 5) compressed by the port under
  ``*=slab`` and served packed: greedy tokens, square and ragged, equal
  to the single process's and to the reference's ``greedy_decode`` on
  the dense-equivalent weights; teacher-forced logits within rel 1e-5 of
  the single process's; under "model" 2 each rank holds half of every
  Mamba layer's state ``h`` (its heads) and of ``conv_x`` (its channels),
  and the shared block's KV cache half of the positions;
- ``hubert``: hubert_xlarge compressed and packed, its non-causal
  encoder prefilled on frame embeddings (``make_prefill_fn(planner=)``):
  logits within rel 1e-5 of the single process's and 1e-4 of the
  reference's ``lm.prefill``;
- ``vlm`` (on (2, 1)): one ``make_train_fn(planner=)`` step of
  qwen2_vl_2b on embeddings whose rows have different (t, h, w) layouts:
  the causal mask reads the global batch's first row on every rank.
  Loss, aux and the state after the step (its first moments are the
  clipped gradients) within rel 1e-5 of the single device's, the loss
  within 1e-4 of the reference's ``loss_fn`` on the whole batch;
- ``phi`` / ``deepseek`` (on (2, 1)): the same for the MoE SMOKE configs
  (deepseek with shared experts) at capacity factor 0.5, so that
  experts drop tokens, in each of the three group cases of the routing
  over the flattened global batch: groups within one rank (S 32), a
  group across both ranks (S 48) and the one group of a token count
  that ``moe_group`` does not divide (S 20).

The processes: one gloo group per mesh shape, each with its own
timeout and one torch thread a rank (``tests/torch_families_worker.py``
on the rank side). Then ``serve --mesh`` and ``train --data-par`` under
torchrun.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_families_worker as worker
from repro import configs as ref_configs
from repro.launch import serve as ref_serve
from repro.models import lm as ref_lm
from repro_torch.core.pipeline import compress_model
from repro_torch.core.slab import SLaBConfig
from repro_torch.data import SyntheticCorpus, calibration_batch
from repro_torch.models import lm
from repro_torch.runtime.mesh import spawn
from repro_torch.runtime.step import make_prefill_fn

ROOT = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT = 240.0
B, PROMPT, GEN = 2, 6, 4          # s_max PROMPT + GEN even: "model" 2
LENGTHS = np.array([6, 3])        # splits the shared block's positions
MOE_CASES = {"local": 32, "spanning": 48, "one_group": 20}
ROWS = 4                          # the train batch's rows, 2 a rank
MOE_OVER = {"capacity_factor": 0.5}


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _norm_rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _compressed(arch: str) -> dict:
    """The port's ``*=slab`` compression of ``arch`` SMOKE (f32)."""
    case = {"arch": arch, "plan": "*=slab"}
    cfg = worker.case_cfg(case)
    params = lm.init(cfg, seed=0, device="cpu")
    calib = calibration_batch(cfg.vocab, seed=0, n_seq=2, seq_len=32)
    if cfg.family == "audio":
        calib = np.random.default_rng(3).standard_normal(
            (2, 32, cfg.d_model)).astype(np.float32)
    case["dense"], _, case["decs"] = compress_model(
        cfg, params, calib, plan="*=slab", scfg=SLaBConfig(cr=0.5, iters=2),
        keep_decompositions=True, device="cpu")
    return case


def _serve_case(arch: str, seed: int) -> dict:
    case = {**_compressed(arch), "kind": "serve", "gen_len": GEN,
            "lengths": LENGTHS}
    vocab = worker.case_cfg(case).vocab
    rng = np.random.default_rng(seed)
    case["prompts"] = rng.integers(0, vocab, (B, PROMPT)).astype(np.int32)
    case["teacher"] = rng.integers(0, vocab, (B, PROMPT + GEN)).astype(
        np.int32)
    return case


def _vlm_batch(cfg) -> dict:
    """Embeddings and (t, h, w) ids of a different layout in every row:
    row 0's t ids differ from row 2's (rank 1's first row under "data"
    2), so a mask that read a rank's own first row would differ."""
    rng = np.random.default_rng(5)
    b = SyntheticCorpus(cfg.vocab, seed=0).batch(0, ROWS, 32)
    b["inputs"] = rng.standard_normal((ROWS, 32, cfg.d_model),
                                      dtype=np.float32)
    b["positions"] = np.cumsum(rng.integers(0, 2, (ROWS, 32, 3)),
                               axis=1).astype(np.int32)
    assert not np.array_equal(b["positions"][0, :, 0],
                              b["positions"][ROWS // 2, :, 0])
    return b


def _step_cases() -> dict:
    cases = {"vlm": {"kind": "step", "arch": "qwen2_vl_2b"}}
    cases["vlm"]["batch"] = _vlm_batch(worker.case_cfg(cases["vlm"]))
    for arch in ("phi3_5_moe", "deepseek_moe_16b"):
        for name, s in MOE_CASES.items():
            case = {"kind": "step", "arch": arch, "over": MOE_OVER}
            case["batch"] = SyntheticCorpus(
                worker.case_cfg(case).vocab, seed=1).batch(0, ROWS, s)
            cases[f"{arch}/{name}"] = case
    return cases


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


def _reference(cases) -> dict:
    """The reference's single device on the same weights: greedy tokens of
    the served cases (square and ragged), the encoder's prefill logits,
    the step cases' loss at their initial params."""
    out = {}
    for name, case in cases.items():
        cfg_r = _ref_cfg(case)
        if case["kind"] == "serve":
            p = _ref_params(case["dense"])
            prompts = jnp.asarray(case["prompts"])
            out[name] = {
                "tokens": np.asarray(ref_serve.greedy_decode(
                    cfg_r, p, prompts, GEN)),
                "ragged": np.asarray(ref_serve.greedy_decode(
                    cfg_r, p, prompts, GEN,
                    lengths=jnp.asarray(LENGTHS, jnp.int32)))}
        elif case["kind"] == "prefill":
            out[name] = {"logits": np.asarray(ref_lm.prefill(
                cfg_r, _ref_params(case["dense"]),
                jnp.asarray(case["frames"])))}
        else:
            p = _ref_params(lm.init(worker.case_cfg(case), seed=0,
                                    device="cpu"))
            batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
            out[name] = {"loss": float(ref_lm.loss_fn(cfg_r, p, batch)[0])}
    return out


def _single(cases) -> dict:
    """The port's single process on every case."""
    out = {}
    for name, case in cases.items():
        cfg = worker.case_cfg(case)
        if case["kind"] == "step":
            out[name] = worker.train_step(cfg, case["batch"])
        elif case["kind"] == "prefill":
            out[name] = {"logits": make_prefill_fn(cfg)(
                worker.packed(case), torch.from_numpy(case["frames"]))
                .numpy()}
        else:
            out[name] = worker.serve(cfg, worker.packed(case), case)
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread in this process while the module runs, as in the
    ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cases():
    serve = {"mamba": _serve_case("mamba2_1_3b", 1),
             "zamba": _serve_case("zamba2_7b", 2)}
    hubert = {**_compressed("hubert_xlarge"), "kind": "prefill"}
    hubert["frames"] = np.random.default_rng(4).standard_normal(
        (B, 16, worker.case_cfg(hubert).d_model)).astype(np.float32)
    serve["hubert"] = hubert
    steps = _step_cases()
    every = {**serve, **steps}
    return serve, steps, _single(every), _reference(every)


@pytest.fixture(scope="module", params=["1x2", "2x1"])
def mesh(request, cases, tmp_path_factory):
    """The serve and prefill cases on one (data, model) process group, and
    on (2, 1) the train steps too: ((data, model), results by rank)."""
    data, model = map(int, request.param.split("x"))
    serve, steps, _, _ = cases
    run = dict(serve, **(steps if data > 1 else {}))
    init = tmp_path_factory.mktemp(f"pg{request.param}") / "store"
    per_rank = spawn(worker.run_cases, data * model, "cpu", str(init),
                     args=(data, model, run), timeout=GROUP_TIMEOUT,
                     threads=1)
    return (data, model), per_rank


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("name", ["mamba", "zamba"])
def test_ssm_greedy_tokens_equal_single_and_reference(mesh, cases, name,
                                                      ragged):
    key = "ragged" if ragged else "tokens"
    _, _, single, ref = cases
    for res in mesh[1]:
        np.testing.assert_array_equal(res[name][key], single[name][key])
        np.testing.assert_array_equal(res[name][key], ref[name][key])


@pytest.mark.parametrize("name", ["mamba", "zamba"])
def test_ssm_logits_equal_single_process(mesh, cases, name):
    single = cases[2][name]["logits"]
    for res in mesh[1]:
        assert res[name]["logits"].shape == single.shape
        assert _rel(res[name]["logits"], single) < 1e-5


@pytest.mark.parametrize("name", ["mamba", "zamba"])
def test_mamba_state_held_by_heads(mesh, cases, name):
    """Under "model" 2 a rank holds half of the heads' state and of
    conv_x's channels, conv_b / conv_c whole; under "data" 2 half of the
    rows."""
    (data, model), per_rank = mesh
    whole = cases[2][name]["mamba"]
    cfg = worker.case_cfg(cases[0][name])
    for res in per_rank:
        got = res[name]["mamba"]
        b, k1, di = whole["conv_x"]
        assert got["conv_x"] == (b // data, k1, di // model)
        assert got["conv_b"] == (b // data,) + whole["conv_b"][1:]
        assert got["h"] == (b // data, cfg.ssm_heads // model,
                            cfg.ssm_headdim, cfg.ssm_state)
        if name == "zamba":                 # the shared block's positions
            assert res[name]["shared_kv"][1] == (PROMPT + GEN) // model


def test_hubert_prefill_equals_single_and_reference(mesh, cases):
    single, ref = cases[2]["hubert"], cases[3]["hubert"]
    for res in mesh[1]:
        assert _rel(res["hubert"]["logits"], single["logits"]) < 1e-5
        assert _rel(res["hubert"]["logits"], ref["logits"]) < 1e-4


def _held_step(mesh, cases, name):
    want, ref = cases[2][name], cases[3][name]
    for res in mesh[1]:
        got = res[name]
        for key in ("loss", "aux", "grad_norm"):
            assert _rel(got[key], want[key]) < 1e-5, (key, got[key],
                                                      want[key])
        assert got["state"].keys() == want["state"].keys()
        for k, v in want["state"].items():
            assert _norm_rel(got["state"][k], v) < 1e-5, (name, k)
        assert _rel(got["loss"], ref["loss"]) < 1e-4


@pytest.mark.parametrize("mesh", ["2x1"], indirect=True)
def test_vlm_rows_of_different_t_layouts_train_as_one_device(mesh, cases):
    """Each rank's rows masked by the global batch's first row's t ids,
    not by its own first row's."""
    _held_step(mesh, cases, "vlm")


@pytest.mark.parametrize("mesh", ["2x1"], indirect=True)
@pytest.mark.parametrize("group", list(MOE_CASES))
@pytest.mark.parametrize("arch", ["phi3_5_moe", "deepseek_moe_16b"])
def test_moe_trains_over_data_as_one_device(mesh, cases, arch, group):
    """Routing, capacity and the aux loss of the global batch: loss, aux,
    grad norm and the state after the step equal the single device's."""
    _held_step(mesh, cases, f"{arch}/{group}")


def _torchrun(module, args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", module, *args],
        capture_output=True, text=True, env=env, timeout=GROUP_TIMEOUT,
        cwd=ROOT)
    assert run.returncode == 0, run.stderr[-3000:]
    return run.stdout.splitlines()


def test_serve_cli_mesh_serves_mamba2_under_torchrun(capsys):
    """``serve --packed --mesh 1,2`` on mamba2_1_3b: every rank's packed
    leaves checksummed equal, half the plane bytes a rank, and the
    single-process CLI's sample generation."""
    from repro_torch.launch import serve
    args = ["--arch", "mamba2_1_3b", "--packed", "--device", "cpu",
            "--iters", "1", "--calib-seqs", "2", "--calib-len", "16",
            "--batch", "2", "--prompt-len", "4", "--gen-len", "4"]
    serve.main(args)
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("sample generation:")]
    out = _torchrun("repro_torch.launch.serve", args + ["--mesh", "1,2"])
    assert ("mesh: data=1 x model=2 over 2 ranks (backend gloo, device "
            "cpu)") in out
    placed = next(ln for ln in out if ln.startswith("placed:"))
    assert placed.startswith("placed: 6 packed leaves, checksums equal "
                             "on 2 ranks")
    assert [ln for ln in out if ln.startswith("sample generation:")] == want


def _loss_part(lines):
    return [ln.split(" gnorm")[0] for ln in lines if ln.startswith("step ")]


def test_train_cli_data_parallel_moe_under_torchrun(capsys):
    """``train --data-par 2`` on phi3_5_moe: rank 0 prints the single
    process's step-0 loss (SMOKE trains in bf16: the grad norm, summed
    from the ranks' bf16 gradients, is not compared)."""
    from repro_torch.launch.train import main
    args = ["--arch", "phi3_5_moe", "--device", "cpu", "--batch", "4",
            "--seq", "32", "--steps", "1"]
    main(args)
    want = _loss_part(capsys.readouterr().out.splitlines())
    out = _torchrun("repro_torch.launch.train", args + ["--data-par", "2"])
    assert ("mesh: data=2 x model=1 over 2 ranks (backend gloo, device "
            "cpu)") in out
    assert _loss_part(out) == want and len(want) == 1
