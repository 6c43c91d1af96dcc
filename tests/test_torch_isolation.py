"""Guards of the port's boundaries: ``src/repro_torch`` and
``chip_smoke.py`` import neither JAX nor the reference package, and the
entry points refuse to run on the CPU unless asked to."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_tp_worker.py",
    ROOT / "tests" / "torch_train_worker.py",
    ROOT / "tests" / "torch_families_worker.py"] + sorted(
    (ROOT / "examples").glob("torch_*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_files_exist():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "bridge.py", "lm.py", "serve.py", "ell.py",
            "slab_matmul.py", "nm_sparse.py", "ops.py", "packed_model.py",
            "baselines.py", "compressor.py", "binlr.py", "flash_decode.py",
            "paged_cache.py", "scheduler.py", "faults.py",
            "engine.py", "moe.py", "grouped.py",
            "deepseek_moe_16b.py", "plan.py", "allocator.py",
            "llama3_2_3b.py", "mistral_nemo_12b.py",
            "nemotron_4_340b.py", "apply.py", "adamw.py", "compress.py",
            "step.py", "fault.py", "elastic.py", "manager.py", "train.py",
            "tree.py", "torch_quickstart.py", "torch_auto_allocate.py",
            "torch_train_e2e.py", "mamba2.py", "mamba2_1_3b.py",
            "zamba2_7b.py", "qwen2_vl_2b.py", "hubert_xlarge.py",
            "sharding.py", "mesh.py", "meshctx.py",
            "torch_tp_worker.py", "ddp.py", "specs.py",
            "torch_train_worker.py", "torch_families_worker.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")


def test_entry_points_refuse_the_cpu_unless_asked(no_card):
    from repro_torch import configs
    from repro_torch.core.allocator import allocate_plan
    from repro_torch.core.pipeline import collect_model_stats, compress_model
    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg = configs.get("stablelm_12b", smoke=True).with_(
        dtype=torch.float32, n_layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init(cfg)
    params = lm.init(cfg, device="cpu")
    calib = np.zeros((1, 8), np.int32)
    prompts = np.zeros((1, 4), np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compress_model(cfg, params, calib)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        collect_model_stats(cfg, params, calib)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        allocate_plan(cfg, params, calib, budget=0.5)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--arch", "stablelm_12b", "--budget", "0.5"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.greedy_decode(cfg, params, prompts, 2)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--arch", "stablelm_12b"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--arch", "stablelm_12b", "--mesh", "1,2"])
    out = serve.greedy_decode(cfg, params, prompts, 2, device="cpu")
    assert out.shape == (1, 2)
    taps = collect_model_stats(cfg, params, calib, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        allocate_plan(cfg, params, budget=0.5, stats=taps)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compress_model(cfg, params, None, stats=taps)
    alloc = allocate_plan(cfg, params, budget=0.5, stats=taps, device="cpu")
    assert alloc.stats.n_forwards == taps.n_forwards
    _, stats = compress_model(cfg, params, calib, device="cpu")
    assert len(stats) == 7
    moe_cfg = configs.get("phi3_5_moe", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init(moe_cfg)
    assert "moe" in lm.init(moe_cfg, device="cpu")["layers"][0]


def _example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_and_examples_refuse_the_cpu_unless_asked(no_card):
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train("llama2_7b", True, 1, 2, 8, None)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--steps", "1"])
    for name in ("torch_quickstart", "torch_auto_allocate",
                 "torch_train_e2e"):
        with pytest.raises(RuntimeError, match="--device cpu"):
            _example(name).main([])
    _, losses = train.train("llama2_7b", True, 2, 2, 8, None, device="cpu")
    assert len(losses) == 2


def test_quickstart_example_runs_on_the_cpu_when_asked(capsys):
    _example("torch_quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "achieved CR (Eq. 9):    0.5000" in out
    assert "kernel (its plain version, bf16)" in out


def test_serve_cli_runs_packed_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "stablelm_12b", "--packed", "--device", "cpu",
                "--iters", "1", "--calib-seqs", "2", "--calib-len", "16",
                "--batch", "2", "--prompt-len", "4", "--gen-len", "2"])
    out = capsys.readouterr().out
    assert "packed serving: 14 linears" in out
    assert "across 7 paths [slab-ell=14]" in out
    assert "sample generation:" in out


CLI_SMALL = ["--arch", "stablelm_12b", "--packed", "--device", "cpu",
             "--iters", "1", "--calib-seqs", "4", "--calib-len", "16",
             "--calib-batch", "2", "--batch", "2", "--prompt-len", "4",
             "--gen-len", "2"]


def _cr_table(out):
    """The per-linear CR table's rows: (layer, path, method, cr_req, cr)."""
    lines = out.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.split()[:4] == ["layer", "path", "method", "cr_req"])
    rows = []
    for ln in lines[start + 1:]:
        f = ln.split()
        if len(f) != 7 or not f[0].isdigit():
            break
        rows.append((int(f[0]), f[1], f[2], float(f[3]), float(f[4])))
    return rows


def test_serve_cli_plan_streams_and_packs_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(CLI_SMALL + ["--plan", "0/attn.wo=skip; "
                            "attn.*=sparsegpt@cr=0.6; "
                            "0/mlp.*=wanda@pattern=2:4; *=slab"])
    out = capsys.readouterr().out
    assert "compressed 13 linears (slab/sparsegpt/wanda)" in out
    rows = _cr_table(out)
    assert [(l, p) for l, p, *_ in rows if p == "attn.wo"] == [(1, "attn.wo")]
    for l, p, method, cr_req, cr in rows:
        want = ("sparsegpt" if p.startswith("attn.")
                else "wanda" if l == 0 else "slab")
        assert method == want, (l, p)
        assert cr_req == (0.6 if method == "sparsegpt" else 0.5)
        assert abs(cr - cr_req) < 0.02
    assert len(rows) == 13
    assert ("packed serving: 13 linears on the kernel path across 7 paths "
            "[slab-ell=3 sparse-ell=7 sparse-nm=3]") in out
    assert "sample generation:" in out


def test_serve_cli_budget_allocates_in_one_pass_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(CLI_SMALL + ["--budget", "0.5"])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("allocated"))
    assert line.startswith("allocated 14 CR groups at budget 0.500 "
                           "(achieved 0.5")
    assert line.endswith("one calibration pass, 4 layer forwards)")
    rows = _cr_table(out)
    assert len(rows) == 14 and {r[2] for r in rows} == {"slab"}
    assert len({r[3] for r in rows}) > 1
    assert "packed serving: 14 linears" in out
    with pytest.raises(SystemExit):
        serve.main(CLI_SMALL + ["--budget", "0.5", "--compress", "none"])


def test_serve_cli_packs_the_ssm_family_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "mamba2_1_3b", "--compress", "slab", "--packed",
                "--device", "cpu", "--iters", "1", "--calib-seqs", "2",
                "--calib-len", "16", "--batch", "2", "--prompt-len", "4",
                "--gen-len", "2"])
    out = capsys.readouterr().out
    assert ("packed serving: 6 linears on the kernel path across 3 paths "
            "[slab-ell=6]; dense fallback: 0") in out
    assert "sample generation:" in out


def test_serve_cli_engine_refuses_the_hybrid_family():
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="paged cache"):
        serve.main(["--arch", "zamba2_7b", "--compress", "none", "--engine",
                    "--device", "cpu"])


@pytest.mark.parametrize("engine", [False, True], ids=("greedy", "engine"))
def test_serve_cli_packs_and_serves_the_vlm_on_the_cpu(capsys, engine):
    """qwen2_vl_2b through ``serve --packed``: every linear slab-ell, the
    tied embedding left as it is; greedy_decode or the engine's trace."""
    from repro_torch.launch import serve
    serve.main(["--arch", "qwen2_vl_2b", "--packed", "--device", "cpu",
                "--iters", "1", "--calib-seqs", "2", "--calib-len", "16",
                "--batch", "2", "--prompt-len", "4", "--gen-len", "2",
                "--requests", "3"] + (["--engine"] if engine else []))
    out = capsys.readouterr().out
    assert ("packed serving: 14 linears on the kernel path across 7 paths "
            "[slab-ell=14]; dense fallback: 0") in out
    if engine:
        assert "engine: 3 requests [finished=3]" in out
    assert "sample generation:" in out


def test_serve_mesh_usage_errors(monkeypatch, capsys):
    """``serve --mesh``: the audio encoder (no decode path, mesh or not)
    and a world size other than DATA x MODEL are usage errors, raised
    before any process group starts; the ssm and hybrid families pass the
    family check and stop only at the world size."""
    from repro_torch.launch import serve
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit):
        serve.main(["--arch", "hubert_xlarge", "--device", "cpu", "--mesh",
                    "1,2"])
    err = capsys.readouterr().err
    assert "encoder-only" in err and "A7b" not in err
    for arch in ("mamba2_1_3b", "zamba2_7b"):
        with pytest.raises(SystemExit):
            serve.main(["--arch", arch, "--device", "cpu", "--mesh", "1,2"])
        assert "needs 2 ranks, launched with 1" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve.main(["--arch", "stablelm_12b", "--device", "cpu",
                    "--mesh", "1,2"])
    err = capsys.readouterr().err
    assert "needs 2 ranks, launched with 1" in err
    assert "torch.distributed.run" in err
    with pytest.raises(SystemExit):
        serve.main(["--arch", "stablelm_12b", "--device", "cpu",
                    "--mesh", "two"])
    assert "expected DATA,MODEL" in capsys.readouterr().err
