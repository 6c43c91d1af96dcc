#!/usr/bin/env python3
"""Time the ELL gather kernels of several checkouts on one CUDA card.

    python3 scripts/time_trees.py TREE [TREE ...]
    python3 scripts/time_trees.py .proof/parent .

Each TREE is a checkout (``git archive`` of a commit, unpacked under a
gitignored directory, or a copy with one design choice changed). The
script builds every tree's CUDA kernels at once (one process a tree),
then runs the trees in turn and again in reverse order (A B ... B A), one
process each, so that a drift of the card over the run falls on every
tree alike. A tree's process imports its own ``src/`` and times, through
its wrappers' ``launch_*`` with the split library of grouped_tc.cu, #1
slab_ell_matmul and #5 ell_lr_matmul at the main path's per-linear (N,
K) and M 1, 4 and 8 (at M 1 also through the first design, ell.cu), and
#12 ell_matmul_g / #13 ell_lr_matmul_g at deepseek-moe-16b's expert
shapes (E 64, M 6); bf16, rank 1, synthetic planes from this checkout's
chip_smoke.py, timed as chip_smoke.py times a kernel (CUDA events, L2
flushed, a device sleep before each call), each result first held to its
plain version at chip_smoke.TOL. One line per case: each tree's mean of
its two runs, then the two runs.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LIN_SHAPES = ((4096, 4096), (11008, 4096), (4096, 11008), (1024, 4096),
              (2048, 2048))
LIN_M = (1, 4, 8)
G_SHAPES = ((1408, 2048), (2048, 1408))
G_E, G_M = 64, 6


def _cases(torch, cs):
    """(label, launch, plain) of every case, operands made on the card."""
    from repro_torch.kernels import ell as ell_k
    from repro_torch.kernels import grouped as g_k
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    bf16 = torch.bfloat16
    for n, k in LIN_SHAPES:
        p = cs._planes(n, k, bf16, 1, gen)
        u, v, b = p["u"], p["v"], p["b"]
        sv, si = p["slab"]
        lv, li = p["ell_lr"]
        for m in LIN_M:
            x = torch.randn((m, k), generator=gen, device="cuda").to(bf16)
            libs = [("", ell_k.SLAB_ELL, ell_k.ELL_LR)]
            if m == 1:
                libs.append((" first design", ell_k.SLAB_ELL_FIRST,
                             ell_k.ELL_LR_FIRST))
            for tag, one, five in libs:
                yield (f"#1{tag} ({n}, {k}) M {m}",
                       lambda x=x, one=one: ell_k.launch_slab_ell(
                           one, x, sv, si, b, u, v),
                       lambda x=x: ell_k.slab_ell_matmul_plain(
                           x, sv, si, b, u, v))
                yield (f"#5{tag} ({n}, {k}) M {m}",
                       lambda x=x, five=five: ell_k.launch_ell_lr(
                           five, x, lv, li, u, v),
                       lambda x=x: ell_k.ell_lr_matmul_plain(
                           x, lv, li, u, v))
        del p
    for n, k in G_SHAPES:
        p = cs._g_planes(G_E, n, k, bf16, 1, gen,
                         ("ell_matmul_g", "ell_lr_matmul_g"))
        x = torch.randn((G_E, G_M, k), generator=gen,
                        device="cuda").to(bf16)
        u, v = p["u"], p["v"]
        ev, ei = p["ell"]
        yield (f"#12 ({n}, {k}) E {G_E} M {G_M}",
               lambda: g_k.launch_ell_g(g_k.ELL_G, x, ev, ei),
               lambda: g_k.ell_matmul_g_plain(x, ev, ei))
        lv, li = p["ell_lr"]
        yield (f"#13 ({n}, {k}) E {G_E} M {G_M}",
               lambda: g_k.launch_ell_lr_g(g_k.ELL_LR_G, x, lv, li, u, v),
               lambda: g_k.ell_lr_matmul_g_plain(x, lv, li, u, v))
        del p


def worker(tree: Path, build_only: bool) -> int:
    """In ``tree``: build its kernels, or time every case (one JSON object
    {label: ms} on the last line of standard output)."""
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    assert Path(build.__file__).resolve().is_relative_to(tree.resolve())
    build.build()
    if build_only:
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for label, launch, plain in _cases(torch, cs):
        got, want = launch().float(), plain().float()
        rel = float((got - want).abs().max() / want.abs().max())
        if not rel < cs.TOL[torch.bfloat16]:
            raise AssertionError(f"{tree}: {label}: rel {rel}")
        out[label] = cs.time_ms(launch, flush, reps=30)
    print(json.dumps(out))
    return 0


def _run(tree: Path, build_only: bool) -> subprocess.Popen:
    cmd = [sys.executable, __file__, "--worker", str(tree)]
    if build_only:
        cmd.append("--build-only")
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", help="checkouts to time")
    ap.add_argument("--worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(Path(args.trees[0]), args.build_only)
    import torch
    if not torch.cuda.is_available():
        print("time_trees: torch.cuda.is_available() is false; this script "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    trees = [Path(t).resolve() for t in args.trees]
    for t in trees:
        if not (t / "src" / "repro_torch").is_dir():
            print(f"time_trees: no src/repro_torch in {t}", file=sys.stderr)
            return 3
    builds = [_run(t, True) for t in trees]
    if any(p.wait() for p in builds):
        print("time_trees: a build failed", file=sys.stderr)
        return 1
    runs = {i: [] for i in range(len(trees))}
    for i in [*range(len(trees)), *reversed(range(len(trees)))]:
        p = _run(trees[i], False)
        text, _ = p.communicate()
        if p.returncode:
            print(f"time_trees: {trees[i]} failed", file=sys.stderr)
            return 1
        runs[i].append(json.loads(text.strip().splitlines()[-1]))
    print(f"card: {torch.cuda.get_device_name(0)}; trees: "
          + " ".join(f"[{i}] {t}" for i, t in enumerate(trees)))
    for label in runs[0][0]:
        cells = []
        for i in runs:
            a, b = (r[label] for r in runs[i])
            cells.append(f"[{i}] {(a + b) / 2:.4f} ({a:.4f} {b:.4f})")
        print(f"{label}: " + "  ".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
