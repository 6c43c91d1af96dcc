"""Serving entry point (port of ``repro.launch.serve``): init -> optional
compression from synthetic calibration (SLaB or one of the paper's
baselines, ``--compress``; a per-linear ``CompressionPlan``, ``--plan``;
per-linear CRs from the budget allocator, ``--budget``; calibration
streamed in chunks, ``--calib-batch``) -> optional packing onto the CUDA
kernels -> prefill + greedy decode of one static batch, or (``--engine``) an
open-loop request trace through the continuous-batching engine on a
paged KV cache (``--kv-quant`` for an int8 cache).

  python -m repro_torch.launch.serve --arch llama2_7b --no-smoke --packed
  python -m repro_torch.launch.serve --arch llama2_7b --compress wanda \
      --pattern 2:4 --packed --device cpu
  python -m repro_torch.launch.serve --arch stablelm_12b --packed --engine \
      --kv-quant --chaos 0 --device cpu
  python -m repro_torch.launch.serve --arch phi3_5_moe --packed --device cpu
  python -m repro_torch.launch.serve --arch deepseek_moe_16b --packed \
      --compress hassle --pattern 2:4 --device cpu
  python -m repro_torch.launch.serve --arch stablelm_12b --packed \
      --plan '0/attn.wo=skip; attn.*=sparsegpt@cr=0.6; *=slab' \
      --calib-batch 4 --device cpu
  python -m repro_torch.launch.serve --arch stablelm_12b --packed \
      --budget 0.5 --device cpu
  python -m repro_torch.launch.serve --arch mamba2_1_3b --packed --device cpu
  python -m repro_torch.launch.serve --arch zamba2_7b --packed \
      --plan '0/mamba.out=skip; *=slab' --device cpu
  python -m repro_torch.launch.serve --arch qwen2_vl_2b --packed \
      --engine --device cpu
  python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m repro_torch.launch.serve --arch mamba2_1_3b --packed \
      --mesh 1,2 --device cpu

The ssm and hybrid families serve through ``greedy_decode`` only,
with or without ``--mesh``: ``--engine`` refuses them (they keep no
paged KV cache). The vlm serves text prompts (token ids, M-RoPE
positions with t = h = w) both ways. The audio encoder (hubert_xlarge)
has no decode path: this entry point refuses it, with or without a
mesh, and it serves through ``lm.prefill``
(``runtime.step.make_prefill_fn``, which takes a planner for a mesh) on
frame embeddings. Under ``--mesh`` every family but audio serves on a
(data, model) mesh: packed leaves and dense weights cut over "model"
run tensor-parallel, a Mamba layer on its heads.

Runs on the CUDA card unless ``--device cpu`` is given; with no card it
refuses to start.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core import compressor as compressor_lib
from repro_torch.core.pipeline import compress_model
from repro_torch.core.plan import CalibrationSpec, CompressionPlan
from repro_torch.core.slab import SLaBConfig
from repro_torch.data import SyntheticCorpus, calibration_batch
from repro_torch.models import lm
from repro_torch.models.common import positions_for
from repro_torch.runtime import meshctx


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
    the shared cache offset and positions are exact for all rows.

    Under a mesh (``runtime.meshctx.use_mesh``) the batch rows split over
    the data axes where the planner's "batch" rule puts them (the moe
    family excepted: capacity routing couples the rows of a dispatch
    group, so every rank runs every row), each rank decodes its rows and
    the tokens are gathered: every rank returns the whole batch."""
    dev = resolve_device(device)
    lm.check_params_on(params, dev, "greedy_decode")
    prompts = torch.as_tensor(prompts, device=dev).long()
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=dev).long()
    rows = meshctx.batch_rows(cfg, prompts.shape[0]) \
        if cfg.family != "moe" else None
    if rows is None:
        return _greedy_decode_rows(cfg, params, prompts, gen_len, lengths,
                                   dev)
    lo, hi, axes = rows
    out = _greedy_decode_rows(cfg, params, prompts[lo:hi], gen_len,
                              None if lengths is None else lengths[lo:hi],
                              dev)
    return meshctx.gather_data(out, 0, axes)


def _greedy_decode_rows(cfg, params, prompts, gen_len, lengths, dev):
    b, s = prompts.shape
    if lengths is not None:
        return _greedy_decode_ragged(cfg, params, prompts, gen_len, lengths,
                                     dev)
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
                    default="slab",
                    help="single-method sugar for --plan '*=<method>'")
    ap.add_argument("--plan", default=None,
                    help="CompressionPlan spec: inline DSL "
                         "('attn.*=sparsegpt; *=slab@cr=0.4'), JSON, or "
                         "@/path/to/plan.json; overrides --compress")
    ap.add_argument("--budget", type=float, default=None,
                    help="global CR budget: allocate per-layer CRs by "
                         "sensitivity water-filling (core.allocator) "
                         "over --plan/--compress, from one calibration "
                         "pass")
    ap.add_argument("--packed", action="store_true",
                    help="serve through the hand-written CUDA kernels "
                         "(their plain versions on --device cpu)")
    ap.add_argument("--engine", action="store_true",
                    help="serve an open-loop request trace through the "
                         "continuous-batching engine (paged KV cache + "
                         "scheduler) instead of one static greedy_decode "
                         "batch; composes with --packed")
    ap.add_argument("--requests", type=int, default=8,
                    help="--engine: requests in the synthetic trace")
    ap.add_argument("--block-size", type=int, default=16,
                    help="--engine: paged-cache tokens per block")
    ap.add_argument("--deadline", type=float, default=None,
                    help="--engine: per-request TTL in seconds — a "
                         "request not finished by arrival+TTL times "
                         "out (status 'timeout', partial output kept)")
    ap.add_argument("--max-waiting", type=int, default=None,
                    help="--engine: bound the waiting queue; overflow "
                         "arrivals are load-shed (status 'shed')")
    ap.add_argument("--shed", default="reject",
                    choices=["reject", "evict-oldest-waiting"],
                    help="--engine: load-shedding policy when "
                         "--max-waiting overflows")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="--engine: run under a seeded FaultPlan "
                         "(pool-shrink, forced NaNs, arrival burst — "
                         "serving/faults.py); same seed, same faults")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache with per-(token, head) scales")
    ap.add_argument("--cr", type=float, default=0.5)
    ap.add_argument("--pattern", default=None)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--calib-seqs", type=int, default=16)
    ap.add_argument("--calib-batch", type=int, default=0,
                    help="stream calibration in chunks of this many "
                         "sequences (0 = single batch)")
    ap.add_argument("--calib-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="serve tensor-parallel on a (data, model) mesh of "
                         "DATA x MODEL torch.distributed ranks, launched by "
                         "python -m torch.distributed.run --nproc-per-node "
                         "DATA*MODEL: weights planner-placed, each packed "
                         "leaf cut to this rank's shards as it is packed")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch, smoke=args.smoke)
    if cfg.family == "audio":
        ap.error(f"--arch {args.arch}: {cfg.name} is an encoder-only model "
                 "(family 'audio') with no decode path; it serves through "
                 "lm.prefill (runtime.step.make_prefill_fn) on frame "
                 "embeddings, not through this entry point")
    if args.budget is not None and not args.plan and args.compress == "none":
        ap.error("--budget needs something to allocate: give --plan or "
                 "a --compress method")
    dev = resolve_device(args.device)
    if args.mesh is None:
        _serve(args, cfg, dev, None)
        return
    try:
        d, m = (int(x) for x in args.mesh.split(","))
    except ValueError:
        ap.error(f"--mesh {args.mesh!r}: expected DATA,MODEL, e.g. 1,2")
    mesh, dev = open_mesh(ap, d, m, dev, "repro_torch.launch.serve",
                          f"--mesh {d},{m}")
    quiet = (contextlib.redirect_stdout(io.StringIO()) if mesh.rank
             else contextlib.nullcontext())
    try:
        with quiet:
            _serve(args, cfg, dev, mesh)
    finally:
        torch.distributed.destroy_process_group()


def open_mesh(ap, d: int, m: int, dev, module: str, flags: str):
    """A (data ``d``, model ``m``) mesh: the process group from torchrun's
    environment and the mesh over it, and the mesh line on rank 0. A
    usage error for a world size other than d x m, naming the torchrun
    command of ``module`` with ``flags``."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != d * m:
        ap.error(f"{flags} needs {d * m} ranks, launched with "
                 f"{world}: python -m torch.distributed.run --standalone "
                 f"--nproc-per-node {d * m} -m {module} {flags} ...")
    from repro_torch.runtime.mesh import init_from_env, make_mesh
    dev = init_from_env(dev)
    mesh = make_mesh(d, m, dev)
    if mesh.rank == 0:
        print(f"mesh: data={d} x model={m} over {world} ranks (backend "
              f"{mesh.backend}, device {dev})", flush=True)
    return mesh, dev


def _serve(args, cfg, dev, mesh):
    """Init, compress and pack, then serve, on this rank's shards under
    ``mesh``."""
    if args.kv_quant:
        cfg = cfg.with_(kv_quant="int8")
    params = lm.init(cfg, seed=args.seed, device=dev)
    n_params = sum(t.numel() for t in _tensors(params))
    print(f"{cfg.name}: {n_params / 1e6:.2f}M params on {dev}")

    scfg = SLaBConfig(cr=args.cr, pattern=args.pattern, iters=args.iters)
    plan = (CompressionPlan.parse(args.plan, base=scfg)
            if args.plan else None)
    placer = None
    if mesh is not None:
        from repro_torch.runtime.sharding import PackPlacer, Planner
        placer = PackPlacer(Planner(mesh, cfg), mesh)
    if plan is not None or args.compress != "none":
        params = compress_and_pack(cfg, params, args, scfg, plan, dev,
                                   place=placer)
    if mesh is not None:
        params = place_params(cfg, params, placer)

    if args.engine:
        serve_engine(cfg, params, args, dev, mesh)
        return

    corpus = SyntheticCorpus(cfg.vocab, seed=args.seed)
    prompts = corpus.batch(0, args.batch, args.prompt_len)["inputs"]
    t0 = time.monotonic()
    with meshctx.use_mesh(mesh):
        gen = greedy_decode(cfg, params, prompts, args.gen_len, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.monotonic() - t0
    n_tok = args.batch * (args.prompt_len + args.gen_len)
    print(f"served {args.batch} seqs x ({args.prompt_len}+{args.gen_len}) "
          f"tokens in {dt:.1f}s ({n_tok / dt:.1f} tok/s)")
    print("sample generation:", gen[0, :16].cpu().numpy())


def place_params(cfg, params, placer):
    """The dense leaves cut to this rank's shards by the planner (the
    packed ones were as they were packed), and every rank's packed leaves
    checked equal; prints the packed planes' bytes this rank holds."""
    from repro_torch.runtime.sharding import (dense_bytes, packed_bytes,
                                              tree_shard)
    planner, mesh = placer.planner, placer.mesh
    params = tree_shard(params, planner.tree_specs(lm.param_axes(cfg),
                                                   params), mesh)
    n = placer.verify()
    if n:
        print(f"placed: {n} packed leaves, checksums equal on {mesh.size} "
              f"ranks; packed planes held {packed_bytes(params) / 1e6:.2f} "
              f"MB of {placer.bytes_whole / 1e6:.2f} MB")
    held, total = dense_bytes(params)
    print(f"dense leaves held {held / 1e6:.2f} MB of {total / 1e6:.2f} MB")
    return params


def compress_and_pack(cfg, params, args, scfg, plan, dev, place=None):
    """Compress ``params`` under ``plan`` (or ``--compress``), after
    allocating per-layer CRs when ``--budget`` is given, print the
    compressed linears and, with ``--plan`` or ``--budget``, each one's
    requested and measured CR and weighted errors; with ``--packed``,
    pack the decompositions. Returns the params to serve."""
    calib = calibration_batch(cfg.vocab, seed=args.seed,
                              n_seq=args.calib_seqs, seq_len=args.calib_len)
    if args.calib_batch:
        calib = CalibrationSpec(calib, batch_size=args.calib_batch)
    t0 = time.monotonic()
    stats_pre = None
    if args.budget is not None:
        from repro_torch.core.allocator import allocate_plan
        alloc = allocate_plan(
            cfg, params, calib, budget=args.budget,
            template=plan if plan is not None else f"*={args.compress}",
            base=scfg, device=dev)
        plan, stats_pre = alloc.plan, alloc.stats
        print(f"allocated {len(alloc.crs)} CR groups at budget "
              f"{alloc.budget:.3f} (achieved {alloc.achieved:.3f}, one "
              f"calibration pass, {alloc.stats.n_forwards} layer forwards)")
    params, stats, decs = compress_model(
        cfg, params, calib, method=args.compress, scfg=scfg, plan=plan,
        keep_decompositions=True, stats=stats_pre, device=dev)
    by_method = sorted({s.method for s in stats})
    cr_meas = float(np.mean([s.cr for s in stats])) if stats else 0.0
    print(f"compressed {len(stats)} linears ({'/'.join(by_method)}) at "
          f"measured CR={cr_meas:.3f} in {time.monotonic() - t0:.1f}s")
    if args.plan is not None or args.budget is not None:
        # per-linear CR table: the plan's and the allocator's decisions
        print(f"{'layer':>5}  {'path':<20} {'method':<10} "
              f"{'cr_req':>7} {'cr':>7} {'err_before':>11} "
              f"{'err_after':>10}")
        for s in stats:
            print(f"{s.layer:>5}  {s.name:<20} {s.method:<10} "
                  f"{s.cr_requested:>7.3f} {s.cr:>7.3f} "
                  f"{s.err_before:>11.4g} {s.err_after:>10.4g}")
    if not args.packed:
        return params
    from repro_torch.core.packed_model import pack_model
    params, rep = pack_model(
        params, decs, dtype=cfg.dtype,
        plan=(plan if plan is not None else
              CompressionPlan.parse(f"*={args.compress}", base=scfg)),
        place=place)
    variants = " ".join(f"{v}={c}"
                        for v, c in sorted(rep.by_variant.items()))
    print(f"packed serving: {rep.n_packed} linears on the kernel "
          f"path across {len(rep.paths)} paths [{variants}]; dense "
          f"fallback: {len(rep.fallback)}")
    if rep.fallback:
        print("  dense-fallback linears:",
              ", ".join(f"L{l}/{p}" for l, p in rep.fallback))
    print(f"segment layout: {len(rep.segments)} segment(s) over "
          f"{cfg.n_layers} layers")
    for seg in rep.segments:
        span = (f"L{seg.lo}" if seg.hi == seg.lo + 1
                else f"L{seg.lo}-L{seg.hi - 1}")
        print(f"  {span}: " + "  ".join(f"{p}={d}" for p, d in seg.sig))
    for var, (pb, db) in sorted(rep.bytes_by_variant.items()):
        flag = "  <-- exceeds dense" if pb > db else ""
        print(f"  bytes/{var}: {pb / 1e3:.1f} kB packed vs "
              f"{db / 1e3:.1f} kB dense ({pb / db:.2f}x){flag}")
    print_experts(params, rep)
    return params


def print_experts(params: dict, rep) -> None:
    """The packed MoE leaves: experts per variant, experts left dense,
    and each leaf's groups (one grouped-kernel launch each)."""
    from repro_torch.core.packed_model import expert_stacks
    stacks = expert_stacks(params)
    if not stacks:
        return
    counts: dict = {}
    for _, _, eps in stacks:
        for var, c in eps.variant_counts().items():
            counts[var] = counts.get(var, 0) + c
    n_groups = [len(eps.groups) for _, _, eps in stacks]
    print(f"experts: {len(stacks)} leaves ["
          + " ".join(f"{v}={c}" for v, c in sorted(counts.items()))
          + f"]; dense experts: "
          f"{sum('[expert ' in p for _, p in rep.fallback)}; groups per leaf "
          f"{min(n_groups)}-{max(n_groups)}")
    for l, path, eps in stacks:
        print(f"  L{l}/{path}: {len(eps.groups)} groups {eps.describe()}")


def engine_trace(cfg, args):
    """The synthetic open-loop trace of ``--engine``: prompt and output
    lengths uniform in [len/2, len], exponential inter-arrivals of mean
    0.2 s, all from ``np.random.default_rng(seed)``."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(args.seed)
    reqs = []
    t_arr = 0.0
    for i in range(args.requests):
        p_len = int(rng.integers(max(args.prompt_len // 2, 1),
                                 args.prompt_len + 1))
        n_new = int(rng.integers(max(args.gen_len // 2, 1),
                                 args.gen_len + 1))
        reqs.append(Request(
            rid=i, prompt=rng.integers(0, cfg.vocab, size=p_len),
            max_new=n_new, arrival=t_arr,
            deadline=(t_arr + args.deadline
                      if args.deadline is not None else None)))
        t_arr += float(rng.exponential(0.2))
    return reqs


def serve_engine(cfg, params, args, dev, mesh=None):
    """``--engine``: the synthetic trace through the engine; prints the
    statuses, tok/s, goodput, steps, evictions and the TTFT / per-token
    latency percentiles."""
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.serving.engine import summarize
    from repro_torch.serving.faults import FaultPlan
    from repro_torch.serving.paged_cache import blocks_needed
    reqs = engine_trace(cfg, args)
    max_len = args.prompt_len + args.gen_len
    per_req = blocks_needed(max_len, args.block_size)
    ecfg = EngineConfig(
        n_slots=args.batch, block_size=args.block_size,
        n_blocks=per_req * args.batch, max_len=max_len,
        prefill_chunk=min(8, args.prompt_len),
        max_waiting=args.max_waiting, shed=args.shed)
    eng = Engine(cfg, params, ecfg, device=dev, mesh=mesh)
    faults = None
    if args.chaos is not None:
        faults = FaultPlan.chaos(args.chaos, vocab=cfg.vocab,
                                 n_rows=args.batch)
        print(f"chaos: {faults!r}")
    t0 = time.monotonic()
    done = eng.run(reqs, clock="wall", faults=faults)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    m = summarize(done, time.monotonic() - t0)
    statuses = " ".join(f"{k}={v}" for k, v
                        in sorted(m["statuses"].items()))
    print(f"engine: {m['n_requests']} requests [{statuses}], "
          f"{m['n_tokens_out']} tokens in {m['wall_s']:.1f}s "
          f"({m['tokens_per_s']:.1f} tok/s, goodput "
          f"{m['goodput_tokens_per_s']:.1f} tok/s, "
          f"{eng.n_steps} steps, {m['n_evictions']} evictions)")
    print(f"  ttft p50/p95/p99: {m['ttft']['p50']:.3f}/"
          f"{m['ttft']['p95']:.3f}/{m['ttft']['p99']:.3f}s")
    lat = m['per_token_latency']
    print(f"  per-token p50/p95/p99: {lat['p50'] * 1e3:.1f}/"
          f"{lat['p95'] * 1e3:.1f}/{lat['p99'] * 1e3:.1f}ms")
    print("sample generation:", np.asarray(reqs[0].out, np.int32)[:16])


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
