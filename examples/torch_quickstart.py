"""Quickstart (PyTorch port): decompose one weight matrix with SLaB,
inspect every piece of the paper's Eq. (1), W ≈ W_S + W_L ⊙ W_B, and
serve it through the fused CUDA kernel.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given (there the
kernel wrapper runs its plain PyTorch version).
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import baselines, compressor, packing
from repro_torch.core.apply import slab_linear
from repro_torch.core.slab import (SLaBConfig, compression_ratio,
                                   keep_fraction, reconstruct,
                                   slab_decompose)
from repro_torch.kernels import ops


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = resolve_device(ap.parse_args(argv).device)
    gen = torch.Generator(device=dev).manual_seed(0)

    # a fake linear layer's weight and its calibration activations
    d_out, d_in = 512, 1024
    w = torch.randn(d_out, d_in, generator=gen, device=dev) * 0.02
    x_cal = torch.randn(256, d_in, generator=gen, device=dev)
    act_norms = x_cal.norm(dim=0)                  # ‖X_j‖₂ (Wanda stats)

    # --- decompose at 50 % compression (the paper's headline setting) ---
    cfg = SLaBConfig(cr=0.5, bits=16, iters=20)
    dec = slab_decompose(w, act_norms, cfg)
    print(f"keep fraction (Eq. 10): "
          f"{keep_fraction(0.5, 16, d_out, d_in):.4f}")
    print(f"nnz(W_S)/total:         "
          f"{float((dec.w_s != 0).float().mean()):.4f}")
    print(f"achieved CR (Eq. 9):    {compression_ratio(dec):.4f}")
    print(f"W_B values:             {torch.unique(dec.w_b).tolist()}")
    print(f"W_L factors >= 0:       u {bool((dec.u >= 0).all())}, "
          f"v {bool((dec.v >= 0).all())}   (Prop. 2)")
    err = float((w - reconstruct(dec)).norm() / w.norm())
    print(f"relative recon error:   {err:.4f}")

    # --- vs pruning alone at the same storage budget --------------------
    w_wanda = baselines.wanda_prune(w, act_norms, 0.5)
    err_w = float((w - w_wanda).norm() / w.norm())
    print(f"wanda@same budget:      {err_w:.4f}  "
          f"(SLaB recovers {100 * (1 - err / err_w):.1f}% of its error)")

    # --- the same decomposition through the compressor registry ---------
    print(f"registered compressors: {compressor.available()}")
    cl = compressor.get("slab", cfg).compress(
        w, compressor.LinearStats(norms=act_norms))
    print(f"registry slab:          measured CR {cl.cr:.4f}, "
          f"dense-equivalent matches: "
          f"{bool(torch.allclose(cl.dense, reconstruct(dec)))}")

    # --- serve it: the plain form and the fused kernel (bf16) -----------
    x = torch.randn(8, d_in, generator=gen, device=dev)
    y_ref = x @ reconstruct(dec).T
    y_plain = slab_linear(x, dec)
    pk = packing.pack_decomposition(dec)           # ELL W_S + sign words
    y_kern = ops.slab_linear_kernel(x.bfloat16(), pk).float()
    where = "#3 slab_matmul" if dev.type == "cuda" else "its plain version"
    print(f"plain path max err:     "
          f"{float((y_plain - y_ref).abs().max()):.2e}")
    print(f"kernel ({where}, bf16) max err / max|y|: "
          f"{float((y_kern - y_ref).abs().max() / y_ref.abs().max()):.2e}")
    print(f"packed B matrix:        {tuple(pk.b_packed.shape)} 32-bit words "
          f"(16x smaller than bf16)")


if __name__ == "__main__":
    main()
