"""Training driver on one device (port of ``repro.launch.train`` without
the mesh): config-driven, checkpointed, fault-tolerant.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama2_7b \\
        --steps 200 --batch 16 --seq 256 --ckpt-dir runs/run1

It runs on the CUDA card unless ``--device cpu`` is given. Exercised end
to end: synthetic batches keyed by (seed, step), microbatched gradient
accumulation, a remat policy, AdamW with the cosine schedule, atomic
async checkpoints, and supervision with restore-and-replay (``--restore``
resumes from the latest commit). ``--data-par`` / ``--model-par`` other
than 1 need the port's mesh runtime, which is not written yet.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticCorpus
from repro_torch.models import lm
from repro_torch.models.common import ArchConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.elastic import elastic_restore
from repro_torch.runtime.fault import FaultConfig, Supervisor
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
          data_par: int = 1, model_par: int = 1):
    """Train ``arch`` (a config name, or an ``ArchConfig``) for ``steps``
    steps of ``batch`` x ``seq`` synthetic tokens from
    ``lm.init(cfg, seed)``. With ``ckpt_dir`` a supervisor
    commits every ``ckpt_every`` steps (the last two kept) and replays
    from the last commit after a failure; ``inject_failure_at`` fails
    that step once. Returns ({"params", "opt"}, the loss of every step
    run, replays included)."""
    if data_par != 1 or model_par != 1:
        raise NotImplementedError(
            "--data-par / --model-par > 1 need the port's mesh runtime "
            "(ROADMAP A7 / A8); the port trains on one device")
    dev = resolve_device(device)
    cfg = (arch if isinstance(arch, ArchConfig)
           else configs.get(arch, smoke=smoke))
    acfg = AdamWConfig(lr=lr, total_steps=max(steps, 2),
                       warmup_steps=max(steps // 20, 1))
    params = lm.init(cfg, seed=seed, device=dev)
    opt = adamw_init(params, acfg)
    corpus = SyntheticCorpus(cfg.vocab, seed=seed)
    step_fn_inner = make_train_fn(cfg, acfg, microbatches=microbatches,
                                  remat=remat)

    mgr = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None
    start = 0
    state = {"params": params, "opt": opt}
    if restore and mgr and mgr.latest_step() is not None:
        state = elastic_restore(mgr, cfg, acfg, device=dev)
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
        st = elastic_restore(mgr, cfg, acfg, step=at_step, device=dev)
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
    return train(args.arch, args.smoke, args.steps, args.batch, args.seq,
                 args.ckpt_dir, microbatches=args.microbatches,
                 remat=args.remat, lr=args.lr, seed=args.seed,
                 ckpt_every=args.ckpt_every, restore=args.restore,
                 device=args.device, data_par=args.data_par,
                 model_par=args.model_par)


if __name__ == "__main__":
    main()
