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
    ROOT / "chip_smoke.py"]
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
            "deepseek_moe_16b.py"} <= names


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
    from repro_torch.core.pipeline import compress_model
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
        serve.greedy_decode(cfg, params, prompts, 2)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--arch", "stablelm_12b"])
    out = serve.greedy_decode(cfg, params, prompts, 2, device="cpu")
    assert out.shape == (1, 2)
    _, stats = compress_model(cfg, params, calib, device="cpu")
    assert len(stats) == 7
    moe_cfg = configs.get("phi3_5_moe", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init(moe_cfg)
    assert "moe" in lm.init(moe_cfg, device="cpu")["layers"][0]


def test_serve_cli_runs_packed_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "stablelm_12b", "--packed", "--device", "cpu",
                "--iters", "1", "--calib-seqs", "2", "--calib-len", "16",
                "--batch", "2", "--prompt-len", "4", "--gen-len", "2"])
    out = capsys.readouterr().out
    assert "packed serving: 14 linears" in out
    assert "across 7 paths [slab-ell=14]" in out
    assert "sample generation:" in out
