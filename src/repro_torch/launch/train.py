"""Training driver (port of ``repro.launch.train``): config-driven,
checkpointed, fault-tolerant, on one device or a (data, model) mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama2_7b \\
        --steps 200 --batch 16 --seq 256 --ckpt-dir runs/run1

It runs on the CUDA card unless ``--device cpu`` is given. Exercised end
to end: synthetic batches keyed by (seed, step), microbatched gradient
accumulation, a remat policy, AdamW with the cosine schedule, atomic
async checkpoints, and supervision with restore-and-replay (``--restore``
resumes from the latest commit, made on any mesh shape or on one
device). ``--data-par D --model-par M`` trains on a mesh of D x M
``torch.distributed`` ranks launched by torchrun:

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 2 -m repro_torch.launch.train --data-par 2 ...

the params and moments placed on the ranks' shards, each rank running
its rows of every microbatch (``runtime.step.make_train_fn``), rank 0
alone writing the commits and printing.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticCorpus
from repro_torch.launch.serve import open_mesh
from repro_torch.models import lm
from repro_torch.models.common import ArchConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.elastic import elastic_restore, place_train_state
from repro_torch.runtime.fault import FaultConfig, Supervisor
from repro_torch.runtime.sharding import Planner
from repro_torch.runtime.step import make_train_fn


def make_batch(cfg: ArchConfig, corpus: SyntheticCorpus, step: int,
               batch: int, seq: int, device) -> dict:
    """Step ``step``'s batch of ``batch`` x ``seq`` synthetic tokens on
    ``device``. A stub-frontend family (``input_mode="embeds"``: the vlm
    and the audio encoder) takes standard-normal f32 embeddings (batch,
    seq, d_model) from ``np.random.default_rng(step)`` as its inputs and
    the corpus's labels, as the reference does."""
    b = corpus.batch(step, batch, seq)
    if cfg.input_mode == "embeds":
        rng = np.random.default_rng(step)
        b["inputs"] = rng.standard_normal((batch, seq, cfg.d_model),
                                          dtype=np.float32)
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in b.items()}


def train(arch, smoke: bool, steps: int, batch: int, seq: int,
          ckpt_dir: Optional[str], microbatches: int = 1,
          remat: str = "none", lr: float = 3e-4, seed: int = 0,
          log_every: int = 10, ckpt_every: int = 50, restore: bool = False,
          inject_failure_at: Optional[int] = None, device=None,
          mesh=None):
    """Train ``arch`` (a config name, or an ``ArchConfig``) for ``steps``
    steps of ``batch`` x ``seq`` synthetic tokens from
    ``lm.init(cfg, seed)``. With ``ckpt_dir`` a supervisor
    commits every ``ckpt_every`` steps (the last two kept) and replays
    from the last commit after a failure; ``inject_failure_at`` fails
    that step once. With ``mesh`` (``runtime.mesh.make_mesh``) every rank
    calls this together and trains on its shards, on the mesh's device.
    Returns ({"params", "opt"}, under a mesh this rank's shards; the loss
    of every step run, replays included)."""
    dev = resolve_device(device) if mesh is None else mesh.device
    cfg = (arch if isinstance(arch, ArchConfig)
           else configs.get(arch, smoke=smoke))
    acfg = AdamWConfig(lr=lr, total_steps=max(steps, 2),
                       warmup_steps=max(steps // 20, 1))
    params = lm.init(cfg, seed=seed, device=dev)
    state = {"params": params, "opt": adamw_init(params, acfg)}
    del params
    planner = None
    if mesh is not None:
        planner = Planner(mesh, cfg)
        state = place_train_state(state, cfg, acfg, mesh)
    corpus = SyntheticCorpus(cfg.vocab, seed=seed)
    step_fn_inner = make_train_fn(cfg, acfg, microbatches=microbatches,
                                  remat=remat, planner=planner)

    mgr = (CheckpointManager(ckpt_dir, keep=2, mesh=mesh) if ckpt_dir
           else None)
    start = 0
    if restore and mgr and mgr.latest_step() is not None:
        state = elastic_restore(mgr, cfg, acfg, device=dev, mesh=mesh)
        start = mgr.latest_step()
        print(f"restored step {start}")

    losses = []

    def step_fn(state, step):
        if inject_failure_at is not None and step == inject_failure_at:
            # one-shot injection: only the first time the step is reached
            state.setdefault("_failed", False)
            if not state["_failed"]:
                state["_failed"] = True
                raise RuntimeError("injected")
        p, o, m = step_fn_inner(state["params"], state["opt"],
                                make_batch(cfg, corpus, step, batch, seq,
                                           dev))
        new = {"params": p, "opt": o}
        if "_failed" in state:
            new["_failed"] = state["_failed"]
        return new, m

    def restore_fn(at_step):
        st = elastic_restore(mgr, cfg, acfg, step=at_step, device=dev,
                             mesh=mesh)
        st["_failed"] = True
        return st

    def on_metrics(step, m):
        losses.append(float(m["loss"]))
        if step % log_every == 0:
            print(f"step {step:5d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} "
                  f"lr {float(m['lr']):.2e}", flush=True)

    t0 = time.monotonic()
    if mgr:
        sup = Supervisor(_CommitView(mgr), FaultConfig(ckpt_every=ckpt_every),
                         device=dev)
        state = sup.run(state, start, steps, step_fn, restore_fn, on_metrics)
        print(f"restarts={sup.stats.restarts} "
              f"stragglers={sup.stats.stragglers}")
    else:
        for s in range(start, steps):
            state, m = step_fn(state, s)
            on_metrics(s, m)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.monotonic() - t0
    print(f"trained {steps - start} steps in {dt:.1f}s "
          f"({(steps - start) / max(dt, 1e-9):.2f} steps/s); "
          f"final loss {losses[-1]:.4f}")
    return state, losses


class _CommitView:
    """The manager, committing only {"params", "opt"} of the loop's
    state (not its bookkeeping keys)."""

    def __init__(self, mgr: CheckpointManager):
        self.m = mgr

    def save(self, step, tree):
        self.m.save(step, {"params": tree["params"], "opt": tree["opt"]})

    def __getattr__(self, k):
        return getattr(self.m, k)


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama2_7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    kw = dict(microbatches=args.microbatches, remat=args.remat, lr=args.lr,
              seed=args.seed, ckpt_every=args.ckpt_every,
              restore=args.restore)
    run = (args.arch, args.smoke, args.steps, args.batch, args.seq,
           args.ckpt_dir)
    d, m = args.data_par, args.model_par
    if d == m == 1:
        return train(*run, device=args.device, **kw)
    if d < 1 or m < 1:
        ap.error(f"--data-par {d} --model-par {m}: each at least 1")
    mesh, _ = open_mesh(ap, d, m, resolve_device(args.device),
                          "repro_torch.launch.train",
                          f"--data-par {d} --model-par {m}")
    quiet = (contextlib.redirect_stdout(io.StringIO()) if mesh.rank
             else contextlib.nullcontext())
    try:
        with quiet:
            return train(*run, mesh=mesh, **kw)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
