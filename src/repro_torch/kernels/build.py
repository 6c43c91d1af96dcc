"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds. Libraries go to
``kernels/_build/`` (listed in ``.gitignore``), named by a hash of the
sources and flags, so an edited source never loads a stale build.
``build()`` starts one ``nvcc`` per source, all at once; ``function``
builds what it needs at first use. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("ell.cu", "slab_matmul.cu", "nm_sparse.cu",
           "flash_decode.cu", "grouped_tc.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class CudaKernel:
    """One hand-written kernel: its C symbol, its source under csrc/, the
    TPU kernel it replaces, and a plain count of its launches. ``key``
    names its launch counter: the C symbol, or ``symbol@source`` for a
    second library that a wrapper launches under the same symbol."""

    name: str
    source: str
    replaces: str
    launches: int = 0
    key: str = ""

    def __post_init__(self):
        self.key = self.key or self.name


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def lib_path(source: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source started
    together. Returns the wall seconds per source built; the compiler's
    register/spill report goes to ``<lib>.log`` beside each library."""
    todo = [s for s in sources if not lib_path(s).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    t0 = time.monotonic()
    for s in todo:
        out = lib_path(s)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / s)]
        procs.append((s, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    times: Dict[str, float] = {}
    failed: List[str] = []
    for s, out, tmp, p in procs:
        log, _ = p.communicate()
        times[s] = time.monotonic() - t0
        out.with_suffix(".log").write_text(log)
        if p.returncode != 0:
            failed.append(f"{s}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return times


def build_log(source: str) -> str:
    """The compiler's output (``-Xptxas -v``) of the current build."""
    log = lib_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def function(source: str, symbol: str, argtypes: List) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of ``source``'s library (built on demand)."""
    lib = _LIBS.get(source)
    if lib is None:
        build([source])
        lib = ctypes.CDLL(str(lib_path(source)))
        _LIBS[source] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as an int handle."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_operand(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given dtype,
    shape and device — what a kernel takes as a raw pointer."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check_aligned(t, name: str) -> None:
    """Raise unless ``t`` starts on a 16-byte boundary (the kernels read
    weight planes with 16-byte vector loads)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} does not start on a 16-byte boundary")


def dtype_code(dtype) -> int:
    """The C interface's value-type code: 0 = float32, 1 = bfloat16."""
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, "
                        f"not {dtype}")
    return codes[dtype]


def check_launch(err: int, name: str, detail: Optional[str] = None) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}" + (f" ({detail})"
                                                 if detail else ""))
