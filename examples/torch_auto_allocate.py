"""Sensitivity-driven per-linear CR allocation (PyTorch port).

One streamed calibration pass taps every layer's activation norms; the
allocator samples each linear's CR -> error frontier from them,
water-fills a global budget, and emits a concrete CompressionPlan that
compress_model runs from the SAME statistics, with no second pass.

    PYTHONPATH=src python examples/torch_auto_allocate.py [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given.
"""
import argparse

import torch

from repro_torch import configs, resolve_device
from repro_torch.core.allocator import allocate_plan
from repro_torch.core.pipeline import compress_model
from repro_torch.data import calibration_batch
from repro_torch.models import lm


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = configs.get("llama2_7b", smoke=True).with_(dtype=torch.float32)
    params = lm.init(cfg, seed=0, device=dev)
    cal = calibration_batch(cfg.vocab, n_seq=8, seq_len=64)

    # probe + solve: per-(layer, path) CRs meeting a 0.5 global budget
    alloc = allocate_plan(cfg, params, cal, budget=0.5,
                          template="*=slab@iters=4", device=dev)
    print(alloc.table())

    # compress from the probe's statistics: no extra forwards
    _, stats = compress_model(cfg, params, None, plan=alloc.plan,
                              stats=alloc.stats, device=dev)
    # the uniform plan at the same budget, from the same statistics
    _, uni = compress_model(cfg, params, None, plan="*=slab@cr=0.5,iters=4",
                            stats=alloc.stats, device=dev)
    err_a = sum(s.err_after for s in stats)
    err_u = sum(s.err_after for s in uni)
    print(f"\nsummed err_after: allocated {err_a:.4g} vs uniform "
          f"{err_u:.4g} ({100 * (err_u - err_a) / err_u:.1f}% better)")

    # the one-liner: an @auto plan allocates inside compress_model
    new2, _ = compress_model(cfg, params, cal,
                             plan="*=slab@auto,iters=4; budget=0.5",
                             device=dev)
    t = torch.randint(0, cfg.vocab, (2, 16),
                      generator=torch.Generator().manual_seed(1)).to(dev)
    logits, _ = lm.forward(cfg, new2, t)
    print("@auto plan forward ok:", bool(torch.isfinite(logits).all()))


if __name__ == "__main__":
    main()
