"""End to end (PyTorch port): train a llama-geometry LM on the synthetic
corpus with the training stack (microbatched gradient accumulation,
remat, checkpoints, the supervisor), SLaB-compress the result under one
plan, and report dense and compressed perplexity.

    PYTHONPATH=src python examples/torch_train_e2e.py [--steps 300] \\
        [--tiny] [--ckpt-dir runs/e2e] [--device cpu]

``--tiny`` shrinks the model for a quick run; the default is a ~100M
parameter model (12 layers, d_model 768, vocab 8192). It runs on the
CUDA card unless ``--device cpu`` is given.
"""
import argparse

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core.pipeline import compress_model
from repro_torch.core.plan import CalibrationSpec, plan_for_method
from repro_torch.core.slab import SLaBConfig
from repro_torch.data import SyntheticCorpus, calibration_batch
from repro_torch.launch.train import train
from repro_torch.models import lm


def model_100m():
    # llama geometry, ~100M params: 12L, d=768, 12H, ff=2048, vocab=8192
    return configs.get("llama2_7b").with_(
        name="llama-100m", n_layers=12, d_model=768, n_heads=12, n_kv=4,
        d_head=64, d_ff=2048, vocab=8192, q_chunk=128, dtype=torch.float32)


@torch.no_grad()
def eval_ppl(cfg, params, n=4, b=8, s=128):
    corpus = SyntheticCorpus(cfg.vocab, seed=0)
    tot = 0.0
    for batch in corpus.eval_batches(n, b, s):
        _, parts = lm.loss_fn(cfg, params, batch)
        tot += float(parts["ce"])
    return float(np.exp(tot / n))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = model_100m()
    if args.tiny:
        cfg = cfg.with_(n_layers=2, d_model=128, n_heads=4, n_kv=2,
                        d_head=32, d_ff=256, vocab=512)
    print(f"model: {cfg.name}  params={lm.param_count(cfg) / 1e6:.1f}M")
    state, _ = train(cfg, smoke=True, steps=args.steps,
                     batch=8 if args.tiny else 16,
                     seq=128 if args.tiny else 256, ckpt_dir=args.ckpt_dir,
                     microbatches=2, remat="nothing", lr=3e-3, log_every=20,
                     ckpt_every=100, device=dev)
    params = state["params"]
    print(f"dense ppl: {eval_ppl(cfg, params):.3f}  "
          f"(uniform would be {cfg.vocab})")

    # calibration streamed through the taps in chunks of 4 sequences
    cal = CalibrationSpec(calibration_batch(cfg.vocab, n_seq=8,
                                            seq_len=128), batch_size=4)
    plan = plan_for_method("slab", SLaBConfig(cr=0.5, iters=8))
    new, _ = compress_model(cfg, params, cal, plan=plan, device=dev)
    print(f"slab@CR50 ppl: {eval_ppl(cfg, new):.3f}")


if __name__ == "__main__":
    main()
