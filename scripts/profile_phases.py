#!/usr/bin/env python3
"""Profile main-path phases of a checkout's chip_smoke.py on one CUDA card.

    python3 scripts/profile_phases.py [--tree DIR] PHASE[:WHAT:NAME] ...
    python3 scripts/profile_phases.py --tree .proof/parent \\
        "e:#8 nm_matmul:slab::nm_kernel<"

Imports ``chip_smoke.py`` and ``src/`` from DIR (default: the checkout
this script is in), builds its CUDA kernels and runs each named phase of
its ``PHASES`` once with the device profile on: torch.profiler over one
greedy_decode, busy / wall ms per decode step, the kernels that take the
most, and with WHAT:NAME the device time per step of the kernels whose
demangled names hold NAME (spaces ignored). The phase's own checks (launch
counts per library, logits against the dense-equivalent) run as in
chip_smoke.py. This profiles a phase on an earlier tree whose
chip_smoke.py ran it unprofiled: put that tree (``git archive``) under a
gitignored directory and run both trees in one call.
"""
from __future__ import annotations

import argparse
import importlib.util
import sys
import time
from pathlib import Path

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose chip_smoke.py and src/ to run")
    ap.add_argument("phases", nargs="+",
                    help="PHASE or PHASE:WHAT:NAME (NAME: part of the "
                         "kernel names to total per decode step)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_phases: torch.cuda.is_available() is false; this "
              "script runs on a CUDA card only", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    if not (tree / "chip_smoke.py").is_file():
        print(f"profile_phases: no chip_smoke.py in {tree}", file=sys.stderr)
        return 3
    sys.path.insert(0, str(tree / "src"))
    spec = importlib.util.spec_from_file_location(
        "tree_chip_smoke", tree / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    phases = dict(smoke.PHASES)
    todo = []
    for arg in args.phases:
        tag, _, focus = arg.partition(":")
        if tag not in phases:
            print(f"profile_phases: no phase {tag!r} in {tree}",
                  file=sys.stderr)
            return 3
        what, _, name = focus.partition(":")
        todo.append((tag, (what, name) if name else None))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.log(f"profile_phases: tree {tree}")
    smoke.environment()
    for tag, focus in todo:
        t0 = time.monotonic()
        kw = dict(phases[tag], profiled=True)
        if focus:
            kw["focus"] = focus
        launched = smoke.model_phase(tag, **kw)
        smoke.log(f"phase {tag} ({tree.name}): launches "
                  + " ".join(f"{k}={v}" for k, v in launched.items())
                  + f"; {time.monotonic() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
