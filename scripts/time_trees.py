#!/usr/bin/env python3
"""Time kernels of several checkouts on one CUDA card.

    python3 scripts/time_trees.py [--cases ell|dense|flash|binlr|nm_g] \
        TREE [TREE ...]
    python3 scripts/time_trees.py .proof/parent .
    python3 scripts/time_trees.py --cases dense . .proof/variant

Each TREE is a checkout (``git archive`` of a commit, unpacked under a
gitignored directory, or a copy with one design choice changed). The
script builds every tree's CUDA kernels at once (one process a tree),
then runs the trees in turn and again in reverse order (A B ... B A), one
process each, so that a drift of the card over the run falls on every
tree alike. A tree's process imports its own ``src/`` and times, through
its wrappers' ``launch_*``:

- ``ell`` (the default): with the split library of grouped_tc.cu, #1
  slab_ell_matmul and #5 ell_lr_matmul at the main path's per-linear (N,
  K) and M 1, 4 and 8 (at M 1 also through the first design, ell.cu),
  #4 ell_matmul at the same (N, K) and M (through ``ell.ell_matmul``:
  the library it picks in that tree), and #12 ell_matmul_g / #13
  ell_lr_matmul_g at deepseek-moe-16b's expert shapes (E 64, M 6);
- ``dense``: the DenseSrc kernels of grouped_tc.cu, #3 slab_matmul at
  the per-linear (N, K) and M 1, 4 and 8, #16 slab_matmul_g at
  phi3.5-moe's expert shapes (E 16, M 2) and #18 slab_lr_matmul_g at
  deepseek-moe-16b's (E 64, M 6), with the first design of #3 and #16 at
  M 4 / 2 and one torch.matmul / torch.bmm on W_S's bytes beside them
  (the trees that have ``slab_matmul.launch_slab_dense``), and #6
  slab_lr_matmul at the per-linear (N, K) and M 1, 4 and 8 (through
  ``slab_matmul.slab_lr_matmul``: the library it picks in that tree);
- ``flash``: #11 flash_decode_paged and #10 flash_decode at chip_smoke's
  timed shapes (llama2-7b R 8, KV 32, G 1, dh 128, blocks of 16, lengths
  0-4096; the engine's 4 rows up to 320 tokens);
- ``binlr``: #9 binlr_matmul at llama2-7b's (N, K) and M 4 and 8 (through
  ``binlr.binlr_matmul``: the library it picks in that tree), with one
  torch.matmul on the dense W_L ⊙ W_B at M 4 beside it;
- ``nm_g``: #15 nm_matmul_g (2:4) at phi3.5-moe's expert shapes (E 16, M
  2, through ``grouped.nm_matmul_g``), with one torch.bmm on the dense
  (E, K, N) stack beside it;

bf16, rank 1, synthetic planes from this checkout's chip_smoke.py, timed
as chip_smoke.py times a kernel (CUDA events, L2 flushed, a device sleep
before each call), each kernel's result first held to its plain version
at chip_smoke.TOL. One line per case: each tree's mean of its two runs,
then the two runs.
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
DENSE_SHAPES = LIN_SHAPES[:4]
PHI_SHAPES = ((6400, 4096), (4096, 6400))
PHI_E, PHI_M = 16, 2


def _dense_cases(torch, cs):
    """(label, launch, plain) of the ``dense`` set; plain is None for a
    library call."""
    from repro_torch.kernels import grouped as g_k
    from repro_torch.kernels import slab_matmul as slab_k
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    bf16 = torch.bfloat16
    for n, k in DENSE_SHAPES:
        p = cs._planes(n, k, bf16, 1, gen)
        u, v, b, ws = p["u"], p["v"], p["b"], p["dense"]
        del p
        for m in LIN_M:
            x = torch.randn((m, k), generator=gen, device="cuda").to(bf16)
            yield (f"#6 ({n}, {k}) M {m}",
                   lambda x=x: slab_k.slab_lr_matmul(x, ws, u, v),
                   lambda x=x: slab_k.slab_lr_matmul_plain(x, ws, u, v))
            libs = [("", slab_k.SLAB_DENSE)]
            if m == 4:
                libs.append((" first design", slab_k.SLAB_DENSE_FIRST))
                yield (f"torch.matmul ({n}, {k}) M {m}",
                       lambda x=x: torch.matmul(x, ws.T), None)
            for tag, kern in libs:
                yield (f"#3{tag} ({n}, {k}) M {m}",
                       lambda x=x, kern=kern: slab_k.launch_slab_dense(
                           kern, x, ws, b, u, v),
                       lambda x=x: slab_k.slab_matmul_plain(x, ws, b, u, v))
    for n, k in PHI_SHAPES:
        p = cs._g_planes(PHI_E, n, k, bf16, 1, gen, ("slab_matmul_g",))
        x = torch.randn((PHI_E, PHI_M, k), generator=gen,
                        device="cuda").to(bf16)
        u, v, b, ws = p["u"], p["v"], p["b"], p["dense"]
        del p
        for tag, kern in (("", g_k.SLAB_G), (" first design",
                                             g_k.SLAB_G_FIRST)):
            yield (f"#16{tag} ({n}, {k}) E {PHI_E} M {PHI_M}",
                   lambda kern=kern: g_k.launch_slab_g(kern, x, ws, b, u, v),
                   lambda: g_k.slab_matmul_g_plain(x, ws, b, u, v))
        w_t = ws.transpose(1, 2).contiguous()
        yield (f"torch.bmm ({n}, {k}) E {PHI_E} M {PHI_M}",
               lambda w_t=w_t: torch.bmm(x, w_t), None)
    for n, k in G_SHAPES:
        p = cs._g_planes(G_E, n, k, bf16, 1, gen, ("slab_lr_matmul_g",))
        x = torch.randn((G_E, G_M, k), generator=gen,
                        device="cuda").to(bf16)
        u, v, ws = p["u"], p["v"], p["dense"]
        del p
        yield (f"#18 ({n}, {k}) E {G_E} M {G_M}",
               lambda: g_k.launch_slab_lr_g(g_k.SLAB_LR_G, x, ws, u, v),
               lambda: g_k.slab_lr_matmul_g_plain(x, ws, u, v))


def _flash_cases(torch, cs):
    """(label, launch, plain) of the ``flash`` set."""
    from repro_torch.kernels import flash_decode as fd_k
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    bs = cs.FD_TIMED["bs"]
    for lengths, s in ((cs._fd_lengths(bs), cs.FD_MAX),
                       (list(cs.FD_ENGINE["lengths"]), cs.FD_ENGINE["s"])):
        for name, paged in (("#11", True), ("#10", False)):
            a = cs._fd_inputs("llama2-7b", bs, s, torch.bfloat16, False, gen,
                              paged, lengths)
            args = {kk: vv for kk, vv in a.items() if not kk.startswith("_")}
            label = f"{name} llama2-7b R {len(lengths)} S {s}"
            if paged:
                yield (label, lambda args=args: fd_k.flash_decode_paged(**args),
                       lambda args=args: fd_k.flash_decode_paged_plain(**args))
            else:
                yield (label,
                       lambda args=args: fd_k.flash_decode(**args, bs=bs),
                       lambda args=args: fd_k.flash_decode_plain(**args,
                                                                 bs=bs))


def _binlr_cases(torch, cs):
    """(label, launch, plain) of the ``binlr`` set."""
    from repro_torch.core.packing import unpack_sign_bits
    from repro_torch.kernels import binlr as binlr_k
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    bf16 = torch.bfloat16
    for n, k in LIN_SHAPES[:3]:
        p = cs._planes(n, k, bf16, 1, gen)
        u, v, b = p["u"], p["v"], p["b"]
        del p
        w_hat = ((u.float().T @ v.float())
                 * unpack_sign_bits(b, k, torch.float32)).to(bf16)
        for m in (4, 8):
            x = torch.randn((m, k), generator=gen, device="cuda").to(bf16)
            yield (f"#9 ({n}, {k}) M {m}",
                   lambda x=x: binlr_k.binlr_matmul(x, b, u, v),
                   lambda x=x: binlr_k.binlr_matmul_plain(x, b, u, v))
            if m == 4:
                yield (f"torch.matmul ({n}, {k}) M {m}",
                       lambda x=x, w_hat=w_hat: torch.matmul(x, w_hat.T),
                       None)


def _nm_g_cases(torch, cs):
    """(label, launch, plain) of the ``nm_g`` set."""
    from repro_torch.core.packing import NMPacked, unpack_nm
    from repro_torch.kernels import grouped as g_k
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    bf16 = torch.bfloat16
    for n, k in PHI_SHAPES:
        p = cs._g_planes(PHI_E, n, k, bf16, 1, gen, ("nm_matmul_g",))
        nv, ni = p["2:4"]
        del p
        x = torch.randn((PHI_E, PHI_M, k), generator=gen,
                        device="cuda").to(bf16)
        yield (f"#15 ({n}, {k}) E {PHI_E} M {PHI_M}",
               lambda nv=nv, ni=ni: g_k.nm_matmul_g(x, nv, ni, 4),
               lambda nv=nv, ni=ni: g_k.nm_matmul_g_plain(x, nv, ni, 4))
        w_t = torch.stack([unpack_nm(NMPacked(nv[e], ni[e], 2, 4, k))
                           for e in range(PHI_E)]).transpose(1, 2)
        w_t = w_t.contiguous()
        yield (f"torch.bmm ({n}, {k}) E {PHI_E} M {PHI_M}",
               lambda x=x, w_t=w_t: torch.bmm(x, w_t), None)


def _cases(torch, cs, which="ell"):
    """(label, launch, plain) of every case, operands made on the card."""
    if which == "dense":
        yield from _dense_cases(torch, cs)
        return
    if which == "flash":
        yield from _flash_cases(torch, cs)
        return
    if which == "binlr":
        yield from _binlr_cases(torch, cs)
        return
    if which == "nm_g":
        yield from _nm_g_cases(torch, cs)
        return
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
        ev, ei = p["ell"]
        for m in LIN_M:
            x = torch.randn((m, k), generator=gen, device="cuda").to(bf16)
            yield (f"#4 ({n}, {k}) M {m}",
                   lambda x=x: ell_k.ell_matmul(x, ev, ei),
                   lambda x=x: ell_k.ell_matmul_plain(x, ev, ei))
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


def worker(tree: Path, build_only: bool, which: str) -> int:
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
    for label, launch, plain in _cases(torch, cs, which):
        if plain is not None:
            got, want = launch().float(), plain().float()
            rel = float((got - want).abs().max() / want.abs().max())
            if not rel < cs.TOL[torch.bfloat16]:
                raise AssertionError(f"{tree}: {label}: rel {rel}")
            del got, want
        out[label] = cs.time_ms(launch, flush, reps=30)
    print(json.dumps(out))
    return 0


def _run(tree: Path, build_only: bool, which: str) -> subprocess.Popen:
    cmd = [sys.executable, __file__, "--worker", "--cases", which, str(tree)]
    if build_only:
        cmd.append("--build-only")
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", help="checkouts to time")
    ap.add_argument("--cases",
                    choices=("ell", "dense", "flash", "binlr", "nm_g"),
                    default="ell",
                    help="which kernels to time (see above)")
    ap.add_argument("--worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(Path(args.trees[0]), args.build_only, args.cases)
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
    builds = [_run(t, True, args.cases) for t in trees]
    if any(p.wait() for p in builds):
        print("time_trees: a build failed", file=sys.stderr)
        return 1
    runs = {i: [] for i in range(len(trees))}
    for i in [*range(len(trees)), *reversed(range(len(trees)))]:
        p = _run(trees[i], False, args.cases)
        text, _ = p.communicate()
        if p.returncode:
            print(f"time_trees: {trees[i]} failed", file=sys.stderr)
            return 1
        runs[i].append(json.loads(text.strip().splitlines()[-1]))
    print(f"card: {torch.cuda.get_device_name(0)}; trees: "
          + " ".join(f"[{i}] {t}" for i, t in enumerate(trees)))
    for label in dict.fromkeys(k for i in runs for k in runs[i][0]):
        cells = []
        for i in runs:
            if label not in runs[i][0]:
                cells.append(f"[{i}] -")
                continue
            a, b = (r[label] for r in runs[i])
            cells.append(f"[{i}] {(a + b) / 2:.4f} ({a:.4f} {b:.4f})")
        print(f"{label}: " + "  ".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
