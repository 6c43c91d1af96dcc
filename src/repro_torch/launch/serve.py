"""Serving entry point (port of ``repro.launch.serve``): init -> optional
compression from synthetic calibration (SLaB or one of the paper's
baselines, ``--compress``) -> optional packing onto the CUDA kernels ->
prefill + greedy decode.

  python -m repro_torch.launch.serve --arch llama2_7b --no-smoke --packed
  python -m repro_torch.launch.serve --arch llama2_7b --compress wanda \
      --pattern 2:4 --packed --device cpu

Runs on the CUDA card unless ``--device cpu`` is given; with no card it
refuses to start.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core import compressor as compressor_lib
from repro_torch.core.pipeline import compress_model
from repro_torch.core.slab import SLaBConfig
from repro_torch.data import SyntheticCorpus, calibration_batch
from repro_torch.models import lm
from repro_torch.models.common import positions_for


def _check_params_on(params: dict, dev: torch.device) -> None:
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params live on {params['embed'].device}, "
                         f"greedy_decode was asked to run on {dev}")


@torch.no_grad()
def greedy_decode(cfg, params, prompts, gen_len: int,
                  lengths=None, device=None) -> torch.Tensor:
    """Prefill + greedy generation: the prompt is fed one decode step per
    position (the cache tracks its own write offset), then ``gen_len``
    tokens are sampled by argmax. Returns (B, gen_len) token ids.

    ``lengths`` (B,) serves a right-padded ragged batch: row ``r``'s
    prompt is ``prompts[r, :lengths[r]]``. At step t a row feeds its next
    prompt token while t < length and its previously sampled token
    after, so every row's stream stays contiguous from position 0 and
    the shared cache offset and positions are exact for all rows."""
    dev = resolve_device(device)
    _check_params_on(params, dev)
    prompts = torch.as_tensor(prompts, device=dev).long()
    b, s = prompts.shape
    if lengths is not None:
        return _greedy_decode_ragged(
            cfg, params, prompts, gen_len,
            torch.as_tensor(lengths, device=dev).long(), dev)
    cache = lm.init_cache(cfg, b, s + gen_len, device=dev)
    logits = None
    for t in range(s):
        pos = positions_for(cfg, b, 1, offset=t, device=dev)
        logits, cache = lm.decode_step(cfg, params, cache,
                                       prompts[:, t:t + 1], pos)
    tok = logits[:, -1].argmax(-1)
    out = [tok]
    for t in range(s, s + gen_len - 1):
        pos = positions_for(cfg, b, 1, offset=t, device=dev)
        logits, cache = lm.decode_step(cfg, params, cache, tok[:, None], pos)
        tok = logits[:, -1].argmax(-1)
        out.append(tok)
    return torch.stack(out, dim=1)


def _greedy_decode_ragged(cfg, params, prompts, gen_len, lengths, dev):
    b, s = prompts.shape
    n_steps = s + gen_len - 1               # longest row: s-1 prompt
    cache = lm.init_cache(cfg, b, s + gen_len, device=dev)
    fed = torch.cat([prompts, torch.zeros((b, n_steps - s), dtype=torch.long,
                                          device=dev)], dim=1)
    prev = torch.zeros(b, dtype=torch.long, device=dev)
    sampled = []
    for t in range(n_steps):
        tok = torch.where(t < lengths, fed[:, t], prev)
        pos = positions_for(cfg, b, 1, offset=t, device=dev)
        logits, cache = lm.decode_step(cfg, params, cache, tok[:, None], pos)
        prev = logits[:, -1].argmax(-1)
        sampled.append(prev)
    sampled = torch.stack(sampled, dim=1)   # (B, n_steps)
    idx = lengths[:, None] - 1 + torch.arange(gen_len, device=dev)[None, :]
    return torch.gather(sampled, 1, idx)


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2_7b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced smoke geometry (--no-smoke for the "
                         "full-size config)")
    ap.add_argument("--compress",
                    choices=["none"] + compressor_lib.available(),
                    default="slab")
    ap.add_argument("--packed", action="store_true",
                    help="serve through the hand-written CUDA kernels "
                         "(their plain versions on --device cpu)")
    ap.add_argument("--cr", type=float, default=0.5)
    ap.add_argument("--pattern", default=None)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--calib-seqs", type=int, default=16)
    ap.add_argument("--calib-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch, smoke=args.smoke)
    params = lm.init(cfg, seed=args.seed, device=dev)
    n_params = sum(t.numel() for t in _tensors(params))
    print(f"{cfg.name}: {n_params / 1e6:.2f}M params on {dev}")

    if args.compress != "none":
        scfg = SLaBConfig(cr=args.cr, pattern=args.pattern, iters=args.iters)
        calib = calibration_batch(cfg.vocab, seed=args.seed,
                                  n_seq=args.calib_seqs,
                                  seq_len=args.calib_len)
        t0 = time.monotonic()
        params, stats, decs = compress_model(cfg, params, calib,
                                             method=args.compress, scfg=scfg,
                                             keep_decompositions=True,
                                             device=dev)
        cr_meas = float(np.mean([s.cr for s in stats])) if stats else 0.0
        print(f"compressed {len(stats)} linears ({args.compress}) at "
              f"measured CR={cr_meas:.3f} in {time.monotonic() - t0:.1f}s")
        if args.packed:
            from repro_torch.core.packed_model import pack_model
            params, rep = pack_model(params, decs, pattern=args.pattern,
                                     dtype=cfg.dtype)
            variants = " ".join(f"{v}={c}"
                                for v, c in sorted(rep.by_variant.items()))
            print(f"packed serving: {rep.n_packed} linears on the kernel "
                  f"path across {len(rep.paths)} paths [{variants}]")
            for var, (pb, db) in sorted(rep.bytes_by_variant.items()):
                flag = "  <-- exceeds dense" if pb > db else ""
                print(f"  bytes/{var}: {pb / 1e3:.1f} kB packed vs "
                      f"{db / 1e3:.1f} kB dense ({pb / db:.2f}x){flag}")

    corpus = SyntheticCorpus(cfg.vocab, seed=args.seed)
    prompts = corpus.batch(0, args.batch, args.prompt_len)["inputs"]
    t0 = time.monotonic()
    gen = greedy_decode(cfg, params, prompts, args.gen_len, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.monotonic() - t0
    n_tok = args.batch * (args.prompt_len + args.gen_len)
    print(f"served {args.batch} seqs x ({args.prompt_len}+{args.gen_len}) "
          f"tokens in {dt:.1f}s ({n_tok / dt:.1f} tok/s)")
    print("sample generation:", gen[0, :16].cpu().numpy())


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


if __name__ == "__main__":
    main()
