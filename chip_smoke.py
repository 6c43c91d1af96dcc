#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py        # every phase, one CUDA card

Phases:
  1. environment: card name and power limit, torch/CUDA versions, and
     the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``
     (one nvcc per source, started together), with each source's
     register and spill summary from ``-Xptxas -v``; while nvcc runs,
     phase s's, phase M's and phase F's compressions (they launch no
     kernel; AHEAD_PHASES, mesh_ahead, families_ahead);
  2. each of the nine per-linear kernels against its plain PyTorch
     version at llama2-7b full-width planes, (N, K) in {(4096, 4096),
     (11008, 4096), (4096, 11008)}, M in {1, 4, 37}, bf16 and f32, rank 1
     and 3 for the kernels with a low-rank term, 2:4 and 4:8 for the N:M
     kernels, int32 ELL ids at (4096, 4096), and the kernels without sign
     words also at (4099, 4100) (K not a multiple of 32, odd K_max); times
     at M = 4, bf16, rank 1 beside the byte bound, the plain version and
     one torch.matmul against the reconstructed dense W; #2
     slab_nm_matmul, #8 nm_matmul, #7 slab_nm_lr_matmul, #3 slab_matmul,
     #6 slab_lr_matmul and #9 binlr_matmul (K split across blocks) and #1
     slab_ell_matmul, #5 ell_lr_matmul and #4 ell_matmul (each row's
     entries split across blocks; also with int32 ids) at bf16 also
     through each of their two libraries (grouped_tc.cu and the first
     design), and timed through the wrapper and through each at M 1, 2,
     3, 4, 8, 16 at (4096, 4096), #2, #8 and #7 at 2:4 and 4:8 (the "M
     sweep" lines); every f32 call of a kernel with two libraries must
     run its first design. Then both
     flash-decode kernels (paged #11, contiguous #10) against their plain
     versions at the decode shapes of llama2-7b (R 8, KV 32, G 1, dh 128)
     and stablelm-12b (R 8, KV 8, G 4, dh 160), and at qwen2-vl-2b's
     (KV 2, G 6, dh 128) and nemotron-4-340b's (KV 8, G 12, dh 192)
     wider groups: block size 16 and 32,
     lengths 0 to 4096 with exact chunk boundaries, scattered block
     tables, the model dtype and int8, bf16 and f32, and for #10 also
     S = 4100; and at the engine's decode shape (4 rows of llama2-7b,
     lengths 33-320); times (bf16, blocks of 16) at llama2-7b's and
     stablelm-12b's R 8 shapes and at the engine's, beside the byte
     bound, the plain version and one scaled_dot_product_attention
     call, with the splits the kernels ran. Then the nine grouped-expert
     kernels (G_SPECS): #14-#17 at phi3.5-moe's expert planes (16
     experts and a bucket of 5 gathered out of order, (N, K) in {(6400,
     4096), (4096, 6400)}, M in {1, 2, 20}, nm_matmul_g also at K = 6408)
     and #12-#14, #18-#20 at deepseek-moe-16b's (64 experts and a bucket
     of 7, (N, K) in {(1408, 2048), (2048, 1408)}, M in {1, 6, 20}, the
     kernels without sign words also at (1411, 1412), K_max odd); bf16
     and f32, rank 1 and 3, 2:4 and 4:8, int32 ELL ids; times at the
     decode step's M per expert (2 and 6), all experts, bf16, rank 1
     beside the byte bound, the plain version and one torch.bmm on the
     reconstructed dense (E, K, N) stack, and at the first shape the
     kernel alone at each other M (the "M sweep" lines); #14 on both
     models, #15 and #17 on phi3.5-moe's and #12, #13, #18, #19 and #20 on
     deepseek-moe-16b's also checked and timed at M = 1, 2, 3, 4, 6, 8,
     9, 16, 20, 32 (bf16, rank 1), through the wrapper (the line names
     the library it ran at each M) and through each of their two
     libraries, grouped_tc.cu and the first design (#16 on phi3.5-moe's
     too); #15, #16, #17, #18 and #20 also through each library at the
     timed M; the first design of #12, #13, #17, #19 and #20 also timed at
     f32; then #1 at the SSM and hybrid families' (N, K) (mamba2-1.3b's
     in_z / in_x (4096, 2048) and out (2048, 4096), zamba2-7b's (7168,
     3584) and (3584, 7168), its shared block's (3584, 3584), (14336,
     3584) and (3584, 14336)) through the wrapper at M 1 and 4 (bf16) and
     4 (f32), each call's library the one ``ell.slab_ell_kernel`` names
     (K 14336 past the split gather's staged x: the first design), each
     shape timed at M 4, bf16, rank 1; then #1 the same at the vlm and
     audio families' (N, K) (qwen2-vl-2b's (1536, 1536), (256, 1536),
     (8960, 1536), (1536, 8960); hubert-xlarge's (1280, 1280), (5120,
     1280), (1280, 5120)) at M 1, 4 and 37, and at hubert-xlarge's also
     at M 512 (its packed prefill's rows), each library held to the plain
     version at M 4 and 512 before the shape is timed there beside one
     torch.matmul;
  3. the port's main paths at full width with cut depth: compress_model
     (16x128 calibration) -> pack_model -> greedy_decode (batch 4, prompt
     32, gen 16, square and ragged), once per packed variant, llama2-7b:
       a  slab 8 iterations, CR 0.5                  -> slab-ell
       b  slab, CR 0.5 2:4                           -> slab-nm
       c  slab, CR 0.2                               -> slab-dense
       d  slab, CR 0.5, f32                          -> slab-ell
       e  wanda, CR 0.5 2:4                          -> sparse-nm
       f  sparsegpt, CR 0.6, 1 layer                 -> sparse-ell
       g  slab W_S + W_L (no binary), CR 0.5         -> lowrank-ell
       h  slab W_S + W_L (no binary), CR 0.4         -> lowrank-dense
       i  slab W_S + W_L (no binary), CR 0.5 2:4     -> lowrank-nm
       j  slab, CR 0.5, then W_S := 0 (W_L ⊙ W_B)    -> binlr
     (2 layers and bf16 unless stated), and phi3.5-moe (16 experts,
     top-2, 1 layer, bf16), attention and every expert packed alike:
       m  slab, CR 0.5                               -> slab-ell (#1, #14)
       n  slab, CR 0.5 2:4                           -> slab-nm (#2, #17)
       o  slab, CR 0.2                               -> slab-dense (#3, #16)
       p  wanda, CR 0.5 2:4                          -> sparse-nm (#8, #15)
     and deepseek-moe-16b (64 experts, top-6, the shared experts' SwiGLU
     MLP of width 2816 beside them, 1 layer, bf16), attention, shared
     and routed experts packed alike:
       r  slab, CR 0.5                               -> slab-ell (#1, #14)
       s  sparsegpt, CR 0.6                          -> sparse-ell (#4, #12)
       t  slab W_S + W_L (no binary), CR 0.5         -> lowrank-ell (#5, #13)
       u  slab W_S + W_L (no binary), CR 0.4         -> lowrank-dense (#6,
                                                        #18)
       v  slab W_S + W_L (no binary), CR 0.5 2:4     -> lowrank-nm (#7, #19)
       w  slab, CR 0.5, then W_S := 0                -> binlr (#9, #20)
     Launch counts are zeroed just before each greedy_decode and read
     just after, one counter per library: phase m's #14 (2 rows per
     expert) must run only the first design (ell.cu), phases a, l, m and
     r's #1, phases g and t's #5, phases f and s's #4, phases h and u's
     #6, phases b and n's #2, phases c and o's
     #3, phases e and p's #8, phases i and v's #7, phases j and w's #9,
     phase n's #17, phase o's #16, phase p's #15 and phases r, s, t, u, v
     and w's grouped kernel only grouped_tc.cu, and phases d, k, q and x
     (f32) only ell.cu;
     final-step logits are held against the dense-equivalent
     (reconstructed-W) model — for the MoE models against dense experts
     (and dense shared experts) behind the same packed attention, whose
     expert choices must agree token for token (_hold_moe_logits says
     why); phases a, b, c, e, f, g, h, i, j, m, n, o, p, r, s, t, u, v
     and w are profiled (a, b, c, e, f, g, h, i, j, n, o, p, s, u and w
     with #1's, #2's, #3's, #8's, #4's, #5's, #6's, #7's, #9's, #17's,
     #16's, #15's and #8's, #12's and #4's, #18's and #6's and #20's and
     #9's device time per step and share of the busy time; warm-ups and
     profiles run the first 8 prompt tokens);
     phases e-i also print the eval perplexity (lm.loss_fn) of the
     uncompressed and the compressed model.
     Then the continuous-batching engine on the paged KV cache, slab-ell
     packed:
       k  llama2-7b f32, 2 layers: a mixed-arrival trace of 10 requests
          (prompts 16-256, outputs 8-64, 4 slots, block size 16), then its
          first 6 requests on a pool that forces evictions; every stream
          token-equal to greedy_decode, no block leaked;
       l  llama2-7b bf16, int8 KV, 2 layers: the ``serve --engine``
          synthetic trace under FaultPlan.chaos(0) on the steps clock;
          every request terminal, no block leaked, tok/s, goodput, TTFT
          and per-token latency, the device-busy share of a decode step
          and #11's device time in it, and paged_decode_step held
          against decode_step;
       q  phi3.5-moe f32, 1 layer: logits against the dense-equivalent,
          then a mixed-arrival trace of 8 requests (prompts 16-128,
          outputs 8-32) at the drop-free capacity factor (every stream
          token-equal to greedy_decode) and at the published 1.25 (every
          request terminal); no block leaked;
       x  deepseek-moe-16b f32, 1 layer: the same as q, drop-free at
          factor 64/6;
     then compression plans and the budget allocator, bf16, 2 layers,
     calibration 16x128 streamed as CalibrationSpec(batch_size=4):
       y  llama3.2-3b (d_model 3072, 24 x 128 heads, kv 8, d_ff 8192,
          vocab 128256, rope theta 500000), compress_model under the plan
          '1/attn.wo=skip; attn.*=sparsegpt@cr=0.6;
          0/mlp.*=wanda@pattern=2:4; *=slab' (slab 8 iterations), then
          pack_model(plan=...): #4 (sparse-ell attention), #8 (sparse-nm,
          layer 0's MLP) and #1 (slab-ell, layer 1's MLP) in one model
          beside a dense attn.wo; every stats row's variant is what
          pack_model packed, each kernel only through grouped_tc.cu;
       z  llama2-7b: collect_model_stats once (n_forwards = layers x
          chunks), allocate_plan(budget=0.5, template='*=slab') from those
          statistics (the CR table and the probe's time logged),
          compress_model(stats=...) with no forwards; the achieved and
          the measured global CR within 0.025 of 0.5, every linear packed
          (slab-ell #1, or slab-dense #3 where a CR falls below ELL's byte
          crossover);
     both with their busy / wall ms a step against the dense-equivalent
     model's and the last-position logits within 3e-2 of it;
     then ``ops.slab_linear_kernel`` (a ``SLaBPacked`` bundle) at (4096,
     4096), M 4, bf16: a 2:4 bundle through #2 and an unstructured one
     (ELL, unpacked) through #3, each counted once on grouped_tc.cu and
     held against ``apply.slab_linear`` within 3e-2; then training:
       T  llama2-7b, 2 layers, bf16 parameters, f32 moments:
          make_train_fn(microbatches=2, remat="nothing") fitting one
          batch of 8 x 512 synthetic tokens for 10 steps (finite losses,
          the last below the first; step 1 under "none", "dots" and
          "blocks:2" gives the
          same loss; step ms, tokens/s, the profiled busy share and peak
          memory); launch.train at 1 layer with commits every 4 steps
          and a failure injected at step 6, bitwise equal to an
          uninterrupted run, and one timed commit (in a temporary
          directory of the checkout, removed after); then the trained
          model SLaB-compressed (CR 0.5), packed slab-ell and served
          through #1 (grouped_tc.cu) as phase a, logits within 3e-2 of
          the trained dense-equivalent, with its perplexities;
     then the SSM and hybrid families at full width, bf16, slab CR 0.5
     (8 iterations, 16x128 calibration), packed slab-ell and served by
     greedy_decode square and ragged (launches exact; busy / wall ms a
     step against the dense-equivalent):
       S  mamba2-1.3b, 12 of its 48 layers (d_model 2048, d_inner 4096,
          64 SSD heads of 64, state 128, vocab 50280; 0.52 G parameters):
          36 linears (in_z, in_x, out) through #1 on grouped_tc.cu; then
          the same at 2 layers and f32 (#1 on ell.cu), whose greedy
          tokens must equal the dense-equivalent's;
       H  zamba2-7b, 12 layers (d_model 3584, d_inner 7168, 112 SSD
          heads, the shared block of 32 x 112 heads and d_ff 14336 before
          layers 5 and 11): 36 Mamba linears and the shared block's 7,
          packed once and run by both invocations; #1 on grouped_tc.cu,
          its shared mlp.w_down (K 14336) on ell.cu;
     both held at bf16 as HOLD_LAYERS says (3e-2 against the
     dense-equivalent on the first 2 layers; at the phase's depth
     against the dense-equivalent evaluated in f32, within 0.07 on S and
     0.04 on H), the chunked SSD forward against the recurrent decode
     (512 tokens, two chunks: the packed model's first 2 layers within
     3e-2 at bf16 and 1e-4 at f32, the dense-equivalent's first 6 at f32
     within 1e-4), and the Mamba cache's bytes a layer equal at s_max
     128 and 524288;
     then the vlm and audio families at full width, depth cut, slab
     CR 0.5 (8 iterations), every linear packed slab-ell through #1 (or
     slab-dense through #3 where ELL loses on bytes), the tied
     embedding and the lm_head as they are:
       V  qwen2-vl-2b, 8 of its 28 layers (V_LAYERS), bf16, 16 x 128
          calibration tokens: greedy_decode as S (square and ragged,
          launches exact, profiled over 5 decode steps), an embeds
          prefill of 8 text embeddings and a 4 x 4 x 2 (t, h, w) patch
          grid (launches exact; the logits must move when the grid's
          ids become text ids), and the engine over 6 requests (prompts 16-128, outputs
          8-32, 4 slots; #11 at G 6): every request finished, no block
          leaked; then the same at 2 layers and f32, whose greedy tokens
          equal the dense-equivalent's and whose engine streams equal
          greedy_decode's;
       A  hubert-xlarge, 16 of its 48 layers (A_LAYERS), bf16,
          calibrated on 16 x 128 x 1280 seeded frame embeddings: the
          packed prefill (runtime.step.make_prefill_fn) at 4 x 128
          frames, M 512 a linear (launches exact, profiled, against the
          dense-equivalent), then one make_train_fn step at 2 layers on
          launch.train.make_batch's embeddings; then the prefill at 2
          layers and f32, logits within 1e-4;
     both held as S and H are at bf16 (3e-2 on the first 2 layers; at
     their depth against the f32 evaluation, within V_DEEP_TOL /
     A_DEEP_TOL);
     then tensor-parallel packed serving:
       M  a (data 1, model 2) mesh of two processes on the one card
          (``runtime.mesh.spawn``; gloo carrying CUDA tensors: NCCL takes
          one rank a card). The parent packs each model once (its
          compression made while nvcc builds) and saves it; each rank
          loads it, cuts its shards leaf by leaf (checksums compared
          across ranks) and serves it through the kernels the parent
          built (a rank never runs nvcc): llama2-7b, 2 layers, slab CR
          0.5, at bf16, each rank's #1 at its local shapes (N 2048 /
          5504 at K 4096, 2048 at K 11008; checked against the plain
          version and timed on rank 0), final logits within 3e-2 of the
          dense-equivalent and within 1e-2 of the single-process packed
          model's; at f32, greedy tokens equal to the
          single-process model's and the engine on kv-head-sharded pools
          (#11 at 16 of 32 heads, rank 0 scheduling) token-equal to the
          single-process engine; phi3.5-moe, 1 layer, f32, 8 of 16
          experts a rank through #14, tokens equal and logits within
          1e-4 of the single-process model's. Per rank: the plane bytes
          held against the single device's and the launches (added to
          the JSON line's); rank 0's profile of a decode step and the
          collectives' share of it (host clock, synchronised);
     then the distributed training runtime:
       P  a (data 2, model 1) mesh of two processes on the one card
          (``runtime.mesh.spawn``, gloo carrying CUDA tensors), llama2-7b
          at full width, bf16 params and f32 moments, init and batch as
          phase T's: P1 ``make_train_fn(planner=...)`` at 2 layers,
          batch 8 x 512 global (4 rows a rank), microbatches 2, remat
          "nothing", 3 steps on batch 0: losses finite and falling, step
          1 within 1e-3 of phase T's; the step's wall, the collectives'
          calls, seconds and bytes (``Mesh.timed``), rank 0's profile,
          max_memory_allocated and the bytes of params and moments a
          rank holds; P2 the same at 1 layer for 2 steps, committed by
          rank 0 into a temporary directory of the checkout (removed
          afterwards) and restored by this process on the card, bitwise
          equal (SHA-256 of every leaf) to the state the ranks assembled;
          P3 ``ddp.build_compressed_ddp_step`` at 1 layer, 4 compressed
          and 4 uncompressed steps from the same init on batch 0 at lr
          1e-4 (P3_LR): the compressed loss falls, the last losses within
          5 %, the error buffers not zero, and each variant's bytes sent
          a step and step wall. Phase P launches no packed kernel;
     then the families under a mesh:
       F  the same two processes, on a (data 1, model 2) mesh and then a
          (data 2, model 1) one; the parent packs each model once (its
          compression made while nvcc builds), runs the single-process
          yardsticks and saves the models. F1 mamba2-1.3b (2 layers) and
          F2 zamba2-7b (6 layers: the shared block fires once), slab CR
          0.5, each rank on its SSD heads: bf16 final logits within 1e-2
          of the single process's on 2 layers and, at F2's depth, no
          farther from the f32 packed model's than twice the single
          process's bf16 logits are, f32 greedy tokens equal, each rank
          holding half of every layer's state h; F3 hubert-xlarge (2
          layers), the packed prefill at 4 x 128 frames, bf16 within
          1e-2 and f32 within 1e-4 of the single process's; F4 llama2-7b
          (2 layers) dense and unpacked at f32, half of the dense bytes a
          rank, tokens equal; F5 deepseek-moe-16b (1 layer) and F6
          qwen2-vl-2b (2 layers, rows of different t layouts), 2
          ``make_train_fn(planner=...)`` steps on (2, 1), step 1 within
          1e-3 of the single process's. #1 at every new local shape
          checked against its plain version and timed on rank 0; each
          rank's launches added to the JSON line's; each decode's
          collectives' share (host clock, synchronised);
  4. one JSON line listing every ported kernel (all twenty; #1-#9 and
     #12-#20 once per library, each with its own launch counter:
     thirty-eight entries), then the result line.

Any failed check raises, and the script exits non-zero. It needs
``torch.cuda.is_available()`` and the repository's ``src/`` beside it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS = {torch.bfloat16: 989e12,   # bf16 dense tensor-core rate
            torch.float32: 67e12}     # fp32 outside the tensor cores
SHAPES = ((4096, 4096), (11008, 4096), (4096, 11008))
BATCHES = (1, 4, 37)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
TIMED = dict(m=4, dtype=torch.bfloat16, rank=1)
JSON_SHAPE = (4096, 4096)          # q/k/v/o: 4 of the 7 linears per layer
SLEEP_CYCLES = 400_000             # ~0.2 ms of device sleep before a timed call
# kernels whose two libraries are also checked and timed one by one at
# every bf16 timed case (the JSON line reports each library's time)
LIB_TIMED = ("slab_nm_matmul", "nm_matmul", "slab_nm_lr_matmul",
             "slab_ell_matmul", "ell_lr_matmul", "slab_matmul",
             "ell_matmul", "slab_lr_matmul", "binlr_matmul",
             "slab_lr_matmul_g", "slab_nm_matmul_g", "binlr_matmul_g",
             "slab_matmul_g", "nm_matmul_g")
# the per-linear M sweep of #2, #8 and #7 (2:4 and 4:8) and of #1, #5, #3,
# #4, #6 and #9 at JSON_SHAPE (bf16, rank 1)
NM_SWEEP = ("slab_nm_matmul", "nm_matmul", "slab_nm_lr_matmul",
            "slab_ell_matmul", "ell_lr_matmul", "slab_matmul", "ell_matmul",
            "slab_lr_matmul", "binlr_matmul")
NM_SWEEP_M = (1, 2, 3, 4, 8, 16)


CARD = ["card not read yet"]       # nvidia-smi's name and power limit


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


# ---------------------------------------------------------------- phase 1

def environment(ahead=None):
    """The card's name and power limit (logged, returned), the versions,
    and the build of every kernel source (one nvcc each, all at once),
    with each source's register and spill summary. ``ahead``, where
    given, runs while nvcc builds (work that launches no kernel)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi: " + smi.stderr.strip()
    CARD[0] = card
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    t0 = time.monotonic()
    built = {}

    def run():
        try:
            built["times"] = build.build()
        except Exception as e:              # raised again below
            built["error"] = e

    nvcc_thread = threading.Thread(target=run, daemon=True)
    nvcc_thread.start()
    if ahead is not None:
        ahead()
    nvcc_thread.join()
    if "error" in built:
        raise built["error"]
    per_src = built["times"]
    log(f"kernel build: {time.monotonic() - t0:.2f}s wall "
        + " ".join(f"{s}={t:.2f}s" for s, t in per_src.items()))
    for s in build.SOURCES:
        log(f"  ptxas {s}: {_ptxas_summary(build.build_log(s))}")
    log("  ptxas grouped_tc.cu tc bodies <Src, n-tiles, LR, BIN> "
        "(tc_kernel: #19, #18; tc_bin_kernel: #2, #3, #9; tc_g_kernel: "
        "#17, #20, #16, #15; tc_nm_kernel: #8, #7, #6): "
        + _ptxas_tc(build.build_log("grouped_tc.cu")))
    log("  ptxas grouped_tc.cu ell_split_kernel<ids, LR (#5, #13), BIN "
        "(#1; #12 and #4 neither), n-tiles, rows a column, split>: "
        + _ptxas_ell_split(build.build_log("grouped_tc.cu")))
    return card


def _ptxas_summary(text: str) -> str:
    """One line from a ``-Xptxas -v`` report: entries compiled, the most
    registers any uses, and the entries that spill."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores", text)]
    spilling = [b for b in spills if b]
    return (f"{len(regs)} entries, at most {max(regs, default=0)} registers"
            f", {len(spilling)} spilling (at most "
            f"{max(spilling, default=0)} bytes of spill stores)")


def _ptxas_tc(text: str) -> str:
    """Registers and spill-store bytes of each tc_kernel / tc_bin_kernel /
    tc_g_kernel / tc_nm_kernel entry of a ``-Xptxas -v`` report, as
    kernel<source, n-tiles, LR, BIN>."""
    out = []
    pat = re.compile(r"Compiling entry function '_ZN2tc(\d+)"
                     r"(tc_(?:bin_|g_|nm_)?kernel)"
                     r"INS_(?:\d+)(NmSrc|DenseSrc|NoSrc)(?:ILi(\d)ELi(\d)EE)?"
                     r"ELi(\d)ELb([01])ELb([01])E")
    lines = text.splitlines()
    for i, line in enumerate(lines):
        m = pat.search(line)
        if not m:
            continue
        _, kern, src, nk, mg, ntp, lr, bn = m.groups()
        src = f"{src}<{nk},{mg}>" if nk else src
        tail = " ".join(lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", tail)
        spill = re.search(r"(\d+) bytes spill stores", tail)
        out.append(f"{kern}<{src},{ntp},{lr},{bn}> "
                   f"{regs.group(1) if regs else '?'}r"
                   f"/{spill.group(1) if spill else '?'}sp")
    return " ".join(out)


def _ptxas_ell_split(text: str) -> str:
    """Registers and spill-store bytes of each ell_split_kernel entry (#1,
    #4, #5, #12, #13) of a ``-Xptxas -v`` report, as <ids, LR, BIN, n-tiles,
    rows a column, SPLIT>."""
    out = []
    pat = re.compile(r"Compiling entry function '_ZN2tc\d+ell_split_kernel"
                     r"I([tj])Lb([01])ELb([01])ELi(\d)ELi(\d)ELb([01])E")
    lines = text.splitlines()
    for i, line in enumerate(lines):
        m = pat.search(line)
        if not m:
            continue
        ids, lr, bn, ntp, mr, split = m.groups()
        tail = " ".join(lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", tail)
        spill = re.search(r"(\d+) bytes spill stores", tail)
        out.append(f"<{'u16' if ids == 't' else 'u32'},{lr},{bn},{ntp},"
                   f"{mr},{split}> "
                   f"{regs.group(1) if regs else '?'}r"
                   f"/{spill.group(1) if spill else '?'}sp")
    return " ".join(out)


# ---------------------------------------------------------------- phase 2

# ELL keep fractions of the synthetic planes, per kernel, as the main path
# packs them: slab-ell (SLaB CR 0.5, b 16: 0.5 - 1/16 - r/D), sparse-ell
# (a pruner at CR 0.6) and lowrank-ell (W_S + W_L at CR 0.5: 0.5 - r/D).
KEEP = {"slab": 0.437, "ell": 0.4, "ell_lr": 0.4995}
# a shape off every multiple: N and K not multiples of 32 (no sign words,
# so only the kernels without a binary term), K_max odd for lowrank-ell
ODD_SHAPE = (4099, 4100)


def _planes(n, k, dtype, rank, gen):
    """Synthetic full-width planes for every kernel, made on the card."""
    from repro_torch.core import packing, sparsity
    dev = "cuda"

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    w = randn(n, k, scale=0.05)
    score = randn(n, k).abs()

    def ell(keep):
        p = packing.ell_pack(
            torch.where(sparsity.group_topk_mask(score, keep), w, 0.0)
            .to(dtype))
        return p.values.contiguous(), p.indices.contiguous()

    w_dense = torch.where(sparsity.group_topk_mask(score, 0.737), w, 0.0)
    planes = {"u": (randn(rank, n, scale=0.2).abs()).to(dtype).contiguous(),
              "v": (randn(rank, k, scale=0.2).abs()).to(dtype).contiguous(),
              "dense": w_dense.to(dtype).contiguous()}
    planes.update({kind: ell(keep) for kind, keep in KEEP.items()})
    if k % 32 == 0:
        signs = torch.where(randn(n, k) >= 0, 1, -1).to(torch.int8)
        planes["b"] = packing.pack_sign_bits(signs)
    for pat in ("2:4", "4:8"):
        nn, mm = sparsity.parse_pattern(pat)
        if k % mm:
            continue
        w_nm = torch.where(sparsity.nm_mask(score, nn, mm), w, 0.0)
        p = packing.pack_nm(w_nm.to(dtype), nn, mm, strict=True)
        planes[pat] = (p.values.contiguous(), p.indices.contiguous())
    return planes


class Case:
    """One kernel call on one set of planes: the kernel and its plain
    version, the planes it reads (for the byte bound), the dense Ŵ it
    stands for (for the library matmul) and the operations it does."""

    def __init__(self, label, kernel, kern, plain, read, w_hat, ops,
                 libs=None):
        self.label, self.kernel = label, kernel
        self.kern, self.plain, self.read = kern, plain, read
        self.w_hat, self.ops = w_hat, ops
        # a kernel with two libraries: the call through each, by counter
        self.libs = libs or {}


def _cases(planes, x, rank, wide_ids=False):
    """Every kernel's Case on these planes. Kernels without a low-rank
    term run at rank 1 only; the binary ones only where K has sign words.
    ``wide_ids`` adds the ELL kernels with int32 id views."""
    from repro_torch.core.packing import (ELLPacked, NMPacked, as_unsigned,
                                          ell_unpack, unpack_nm,
                                          unpack_sign_bits)
    from repro_torch.kernels import binlr as binlr_k
    from repro_torch.kernels import ell as ell_k
    from repro_torch.kernels import nm_sparse as nm_k
    from repro_torch.kernels import slab_matmul as slab_k
    u, v = planes["u"], planes["v"]
    m, k = x.shape
    n = u.shape[1]
    lr = lambda: u.float().T @ v.float()                     # (N, K)

    def ell_libs(new, first, call, idx, binary, r=rank):
        """#1's / #5's / #4's (r 0) libraries by counter key: the split
        kernel only where its x fits a block (ell.ell_split_smem: the
        wrapper never picks it elsewhere)."""
        fits = ell_k.ell_split_smem(k, r, idx.element_size(),
                                    binary) <= slab_k.TC_SMEM
        return {kk.key: (lambda kk=kk: call(kk))
                for kk in (new, first) if fits or kk is first}

    def ell_dense(p):
        return lambda: ell_unpack(ELLPacked(p[0], p[1], k)).float()

    def ops(stored, lowrank=False, binary=False):
        o = 2 * m * stored
        if lowrank:      # the projection x @ Vᵀ and its application
            o += 2 * m * k * rank + 2 * m * n * rank
        if binary:       # x ⊙ v_r, a sign-add per weight, the u_r scale
            o += m * k * rank + 2 * m * n * k * rank + 2 * m * n * rank
        return o

    out = []
    if "b" in planes:
        b = planes["b"]
        w_b = lambda: lr() * unpack_sign_bits(b, k, torch.float32)
        slabs = [("", planes["slab"])]
        if wide_ids:
            slabs.append(("[int32]", (planes["slab"][0],
                                      as_unsigned(planes["slab"][1]).int())))
        for tag, (vals, idx) in slabs:
            out.append(Case(
                f"slab_ell_matmul{tag}", "slab_ell_matmul",
                lambda vals=vals, idx=idx: ell_k.slab_ell_matmul(
                    x, vals, idx, b, u, v),
                lambda vals=vals, idx=idx: ell_k.slab_ell_matmul_plain(
                    x, vals, idx, b, u, v),
                (vals, idx, b, u, v),
                lambda vals=vals, idx=idx: ell_dense((vals, idx))() + w_b(),
                ops(vals.numel(), binary=True),
                libs=ell_libs(ell_k.SLAB_ELL, ell_k.SLAB_ELL_FIRST,
                              lambda kk, vals=vals, idx=idx:
                              ell_k.launch_slab_ell(kk, x, vals, idx, b, u,
                                                    v), idx, True)))
        for pat in ("2:4", "4:8"):
            nv, ni = planes[pat]
            nn, mm = map(int, pat.split(":"))
            out.append(Case(
                f"slab_nm_matmul[{pat}]", "slab_nm_matmul",
                lambda nv=nv, ni=ni, mm=mm: slab_k.slab_nm_matmul(
                    x, nv, ni, mm, b, u, v),
                lambda nv=nv, ni=ni, mm=mm: slab_k.slab_nm_matmul_plain(
                    x, nv, ni, mm, b, u, v),
                (nv, ni, b, u, v),
                lambda nv=nv, ni=ni, nn=nn, mm=mm: unpack_nm(
                    NMPacked(nv, ni, nn, mm, k)).float() + w_b(),
                ops(nv.numel(), binary=True),
                libs={kk.key: (lambda kk=kk, nv=nv, ni=ni, mm=mm:
                               slab_k.launch_slab_nm(kk, x, nv, ni, mm, b, u,
                                                     v))
                      for kk in (slab_k.SLAB_NM, slab_k.SLAB_NM_FIRST)}))
        ws = planes["dense"]
        out.append(Case(
            "slab_matmul", "slab_matmul",
            lambda: slab_k.slab_matmul(x, ws, b, u, v),
            lambda: slab_k.slab_matmul_plain(x, ws, b, u, v),
            (ws, b, u, v), lambda: ws.float() + w_b(),
            ops(ws.numel(), binary=True),
            libs={kk.key: (lambda kk=kk: slab_k.launch_slab_dense(
                kk, x, ws, b, u, v))
                  for kk in (slab_k.SLAB_DENSE, slab_k.SLAB_DENSE_FIRST)}))
        out.append(Case(
            "binlr_matmul", "binlr_matmul",
            lambda: binlr_k.binlr_matmul(x, b, u, v),
            lambda: binlr_k.binlr_matmul_plain(x, b, u, v),
            (b, u, v), w_b, ops(0, binary=True),
            libs={kk.key: (lambda kk=kk: binlr_k.launch_binlr(kk, x, b, u,
                                                              v))
                  for kk in (binlr_k.BINLR, binlr_k.BINLR_FIRST)}))
    ells = [("", planes["ell"], planes["ell_lr"])]
    if wide_ids:
        ells.append(("[int32]",
                     (planes["ell"][0], as_unsigned(planes["ell"][1]).int()),
                     (planes["ell_lr"][0],
                      as_unsigned(planes["ell_lr"][1]).int())))
    for tag, (ev, ei), (lv, li) in ells:
        if rank == 1:
            out.append(Case(
                f"ell_matmul{tag}", "ell_matmul",
                lambda ev=ev, ei=ei: ell_k.ell_matmul(x, ev, ei),
                lambda ev=ev, ei=ei: ell_k.ell_matmul_plain(x, ev, ei),
                (ev, ei), ell_dense((ev, ei)), ops(ev.numel()),
                libs=ell_libs(ell_k.ELL, ell_k.ELL_FIRST,
                              lambda kk, ev=ev, ei=ei:
                              ell_k.launch_ell(kk, x, ev, ei), ei, False,
                              r=0)))
        out.append(Case(
            f"ell_lr_matmul{tag}", "ell_lr_matmul",
            lambda lv=lv, li=li: ell_k.ell_lr_matmul(x, lv, li, u, v),
            lambda lv=lv, li=li: ell_k.ell_lr_matmul_plain(x, lv, li, u, v),
            (lv, li, u, v), lambda lv=lv, li=li: ell_dense((lv, li))() + lr(),
            ops(lv.numel(), lowrank=True),
            libs=ell_libs(ell_k.ELL_LR, ell_k.ELL_LR_FIRST,
                          lambda kk, lv=lv, li=li:
                          ell_k.launch_ell_lr(kk, x, lv, li, u, v), li,
                          False)))
    ws = planes["dense"]
    out.append(Case(
        "slab_lr_matmul", "slab_lr_matmul",
        lambda: slab_k.slab_lr_matmul(x, ws, u, v),
        lambda: slab_k.slab_lr_matmul_plain(x, ws, u, v),
        (ws, u, v), lambda: ws.float() + lr(),
        ops(ws.numel(), lowrank=True),
        # (the tensor map's rows need K % 8 == 0: the wrapper never picks
        # grouped_tc.cu elsewhere)
        libs={kk.key: (lambda kk=kk: slab_k.launch_slab_lr(kk, x, ws, u, v))
              for kk in (slab_k.SLAB_LR, slab_k.SLAB_LR_FIRST)
              if k % 8 == 0 or kk is slab_k.SLAB_LR_FIRST}))
    for pat in ("2:4", "4:8"):
        if pat not in planes:
            continue
        nv, ni = planes[pat]
        nn, mm = map(int, pat.split(":"))
        out.append(Case(
            f"slab_nm_lr_matmul[{pat}]", "slab_nm_lr_matmul",
            lambda nv=nv, ni=ni, mm=mm: slab_k.slab_nm_lr_matmul(
                x, nv, ni, mm, u, v),
            lambda nv=nv, ni=ni, mm=mm: slab_k.slab_nm_lr_matmul_plain(
                x, nv, ni, mm, u, v),
            (nv, ni, u, v),
            lambda nv=nv, ni=ni, nn=nn, mm=mm: unpack_nm(
                NMPacked(nv, ni, nn, mm, k)).float() + lr(),
            ops(nv.numel(), lowrank=True),
            libs={kk.key: (lambda kk=kk, nv=nv, ni=ni, mm=mm:
                           slab_k.launch_slab_nm_lr(kk, x, nv, ni, mm, u, v))
                  for kk in (slab_k.SLAB_NM_LR, slab_k.SLAB_NM_LR_FIRST)}))
    if rank == 1:
        for pat in ("2:4", "4:8"):
            if pat not in planes:
                continue
            nv, ni = planes[pat]
            nn, mm = map(int, pat.split(":"))
            out.append(Case(
                f"nm_matmul[{pat}]", "nm_matmul",
                lambda nv=nv, ni=ni, mm=mm: nm_k.nm_matmul(x, nv, ni, mm),
                lambda nv=nv, ni=ni, mm=mm: nm_k.nm_matmul_plain(
                    x, nv, ni, mm),
                (nv, ni),
                lambda nv=nv, ni=ni, nn=nn, mm=mm: unpack_nm(
                    NMPacked(nv, ni, nn, mm, k)).float(),
                ops(nv.numel()),
                libs={kk.key: (lambda kk=kk, nv=nv, ni=ni, mm=mm:
                               nm_k.launch_nm(kk, x, nv, ni, mm))
                      for kk in (nm_k.NM, nm_k.NM_FIRST)}))
    return out


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def time_ms(fn, flush, reps=20) -> float:
    """Median device time of one call over ``reps``, by CUDA events, with
    the 50 MB L2 flushed before each call (the serve path streams cold
    weights); the median, so that one stalled call does not move it. A
    device sleep of SLEEP_CYCLES after the flush keeps the card busy
    while the host runs the wrapper, so the events see the call's device
    time and none of its host-side launch cost."""
    fn()
    sync()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    mid = len(times) // 2
    return times[mid] if len(times) % 2 else (times[mid - 1] + times[mid]) / 2


def _check_case(c, x, n, dtype, rank, worst, where, kern=None, ref=None):
    """Run one case's kernel (or ``kern``) and plain version (unless
    ``ref`` is given); raise unless they agree. Returns (kernel output,
    plain output)."""
    got = (kern or c.kern)()
    ref = c.plain() if ref is None else ref
    sync()
    err = float((got.float() - ref.float()).abs().max())
    rel = err / max(float(ref.float().abs().max()), 1e-30)
    worst[c.label] = max(worst.get(c.label, 0.0), rel)
    want_shape = tuple(x.shape[:-1]) + (n,)
    if not (bool(torch.isfinite(got).all()) and tuple(got.shape) ==
            want_shape and rel < TOL[dtype]):
        raise AssertionError(
            f"{c.label} {where} {dtype} r{rank}: max|err|/max|ref| = "
            f"{rel:.3g} (tolerance {TOL[dtype]}), shape "
            f"{tuple(got.shape)}")
    return got, ref


def _first_design_at_f32(c, dtype, before, where):
    """Raise unless an f32 call through the wrapper of a kernel with two
    libraries (``c.libs``) launched its first design (the counter key
    ``symbol@source``): the redesigned kernels take bf16 only."""
    from repro_torch.kernels import ops
    if dtype != torch.float32 or not c.libs:
        return
    ran = {kk for kk, v in ops.launch_counts().items()
           if v > before[kk]} & set(c.libs)
    first = {kk for kk in c.libs if "@" in kk}
    if ran != first:
        raise AssertionError(f"{c.label} {where} f32 launched {sorted(ran)}"
                             f", expected the first design {sorted(first)}")


def kernel_checks():
    """Every kernel vs its plain version; returns per-kernel records."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    worst = {}
    timed = {}
    n_checks = 0
    for (n, k) in SHAPES + (ODD_SHAPE,):
        for dtype in (torch.bfloat16, torch.float32):
            for rank in (1, 3):
                planes = _planes(n, k, dtype, rank, gen)
                for m in BATCHES:
                    x = torch.randn((m, k), generator=gen,
                                    device="cuda").to(dtype)
                    wide = (n, k) == JSON_SHAPE
                    for c in _cases(planes, x, rank, wide_ids=wide):
                        where = f"N={n} K={k} M={m}"
                        before = ops.launch_counts()
                        got, ref = _check_case(c, x, n, dtype, rank, worst,
                                               where)
                        _first_design_at_f32(c, dtype, before, where)
                        n_checks += 1
                        libs = {}
                        if c.kernel in LIB_TIMED and dtype == torch.bfloat16:
                            for key, fn in c.libs.items():
                                g2, _ = _check_case(
                                    c, x, n, dtype, rank, worst,
                                    f"{where} through {key}", kern=fn,
                                    ref=ref)
                                n_checks += 1
                                libs[key] = (fn, float(
                                    (g2.float() - ref.float()).abs().max()))
                        if ((n, k) in SHAPES and m == TIMED["m"]
                                and dtype == TIMED["dtype"]
                                and rank == TIMED["rank"]):
                            timed[(c.label, n, k)] = _time_case(
                                c, x, rank, got, ref, flush, libs=libs)
                del planes
    ops.reset_launch_counts()        # comparison launches do not count
    log(f"kernel checks: {n_checks} cases passed; worst max|err|/max|ref|: "
        + " ".join(f"{l}={w:.3g}" for l, w in worst.items()))
    return timed, worst


def nm_sweep(flush):
    """#2 slab_nm_matmul, #8 nm_matmul and #7 slab_nm_lr_matmul (2:4 and
    4:8), #1 slab_ell_matmul, #5 ell_lr_matmul and #4 ell_matmul (uint16
    ids), #3 slab_matmul, #6 slab_lr_matmul and #9 binlr_matmul at
    JSON_SHAPE, bf16, rank 1, at every M of NM_SWEEP_M:
    checked against their plain versions and timed through the wrapper
    (each M tagged with the library it ran) and through each of their two
    libraries."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    n, k = JSON_SHAPE
    dtype = torch.bfloat16
    planes = _planes(n, k, dtype, 1, gen)
    source = {kk.key: kk.source for kk in ops.KERNELS}
    worst, n_checks, ms = {}, 0, {}
    for m in NM_SWEEP_M:
        x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        for c in _cases(planes, x, 1):
            if c.kernel not in NM_SWEEP:
                continue
            where = f"N={n} K={k} M={m} (sweep)"
            before = ops.launch_counts()
            _, ref = _check_case(c, x, n, dtype, 1, worst, where)
            ran = " ".join(source[kk] for kk, v in ops.launch_counts().items()
                           if v > before[kk])
            ms.setdefault((c.label, None), {})[m] = (time_ms(c.kern, flush),
                                                     ran)
            n_checks += 1
            for key, fn in c.libs.items():
                _check_case(c, x, n, dtype, 1, worst,
                            f"{where} through {source[key]}", kern=fn,
                            ref=ref)
                n_checks += 1
                ms.setdefault((c.label, key), {})[m] = (time_ms(fn, flush),
                                                        "")
    del planes
    torch.cuda.empty_cache()
    ops.reset_launch_counts()        # comparison launches do not count
    for (label, key), by_m in ms.items():
        how = f" through {source[key]}" if key else ""
        log(f"  M sweep {label} N={n} K={k} bf16 r1{how}: "
            + " ".join(f"M={m}: {t:.4f} ms" + (f" ({ran})" if ran else "")
                       for m, (t, ran) in sorted(by_m.items())))
    log(f"per-linear sweep (#2, #8, #7, #1, #5, #3, #4, #6, #9): {n_checks} "
        "cases passed; "
        "worst "
        "max|err|/max|ref|: "
        + " ".join(f"{l}={w:.3g}" for l, w in worst.items()))


def _time_case(c, x, rank, got, ref, flush, plain_reps=20, libs=None):
    """Kernel, plain and library times of one case; the library call is
    one torch.matmul on the dense Ŵ, or for a grouped case (x (E, M, K))
    one torch.bmm on the dense (E, K, N) stack. ``libs`` (counter key ->
    (call, max|err|)): each library of a kernel that has two, timed too
    (rec["libs"])."""
    k = x.shape[-1]
    w_hat = c.w_hat().to(x.dtype)
    if x.dim() == 3:
        w_t = w_hat.transpose(1, 2).contiguous()
        del w_hat
        lib = lambda: torch.bmm(x, w_t)
    else:
        lib = lambda: torch.matmul(x, w_hat.T)
    y_bytes = got.numel() * got.element_size()
    n_bytes = _nbytes(x, *c.read) + y_bytes
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = c.ops / PEAK_OPS[x.dtype] * 1e3
    rec = {"ms": time_ms(c.kern, flush),
           "plain_ms": time_ms(c.plain, flush, plain_reps),
           "library_ms": time_ms(lib, flush),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": n_bytes,
           "max_abs_err": float((got.float() - ref.float()).abs().max()),
           "m": x.shape[-2], "dtype": str(x.dtype).replace("torch.", "")}
    n = got.shape[-1]
    m = x.shape[-2]
    e = f" E={x.shape[0]}" if x.dim() == 3 else ""
    dt = "bf16" if x.dtype == torch.bfloat16 else "f32"
    log(f"  time {c.label:22s}{e} N={n:5d} K={k:5d} M={m} {dt} "
        f"r{rank}: kernel_ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
        f"library_ms={rec['library_ms']:.4f} bound_ms={rec['bound_ms']:.4f}"
        f" ({rec['bound_by']}, {n_bytes / 1e6:.2f} MB) "
        f"roofline={rec['bound_ms'] / rec['ms']:.3f}")
    if libs:
        rec["libs"] = {key: {"ms": time_ms(fn, flush), "max_abs_err": err}
                       for key, (fn, err) in libs.items()}
        log(f"    {c.label} by library: " + " ".join(
            f"{key}={v['ms']:.4f} ms ({rec['bound_ms'] / v['ms']:.3f} of "
            "bound)" for key, v in rec["libs"].items()))
    return rec


# grouped-expert kernels at each MoE configuration's expert planes, (N, K)
# of w_gate / w_up, then w_down: phi3.5-moe's 16 experts for #14-#17
# (M = 2: a decode step's capacity per expert at batch 4, top-2, capacity
# factor 1.25) and deepseek-moe-16b's 64 for #12, #13, #18-#20 (M = 6:
# max(int(4·6·1.25/64), 6)); M = 20 is a calibration-sized case. A
# bucket of a few experts gathered out of order stands for what
# expert_matmul hands a group's kernel. ``odd`` is an (N, K) off every
# multiple of 32 (no sign words), where only the kernels that take any K
# run: nm_matmul_g on phi3.5-moe; ell / ell_lr (odd K_max), slab_lr and
# slab_nm_lr (2:4) on deepseek-moe-16b. The first shape is the one the
# JSON line reports, at the last model whose kernels name the kernel.
# ``sweep`` names the kernels that are also checked and timed alone at
# every M of G_SWEEP_M (bf16, rank 1, all experts, first shape), through
# the wrapper and through each of their libraries. ``timed_f32`` names
# cases also timed at f32 (launches that only the first design of #12,
# #13 and #19 takes).
G_SWEEP_M = (1, 2, 3, 4, 6, 8, 9, 16, 20, 32)
G_SPECS = {
    "phi3.5-moe": dict(
        kernels=("slab_ell_matmul_g", "nm_matmul_g", "slab_matmul_g",
                 "slab_nm_matmul_g"),
        shapes=((6400, 4096), (4096, 6400)), experts=16,
        bucket=(3, 14, 0, 9, 6), batches=(1, 2, 20), timed_m=2,
        odd=(4096, 6408), seed=2,
        sweep=("slab_ell_matmul_g", "slab_nm_matmul_g", "slab_matmul_g",
               "nm_matmul_g"),
        timed_f32=("slab_nm_matmul_g[2:4]",)),
    "deepseek-moe-16b": dict(
        kernels=("slab_ell_matmul_g", "ell_matmul_g", "ell_lr_matmul_g",
                 "slab_lr_matmul_g", "slab_nm_lr_matmul_g",
                 "binlr_matmul_g"),
        shapes=((1408, 2048), (2048, 1408)), experts=64,
        bucket=(9, 61, 0, 33, 17, 48, 5), batches=(1, 6, 20), timed_m=6,
        odd=(1411, 1412), seed=4,
        sweep=("slab_ell_matmul_g", "slab_nm_lr_matmul_g", "ell_matmul_g",
               "ell_lr_matmul_g", "slab_lr_matmul_g", "binlr_matmul_g"),
        timed_f32=("slab_nm_lr_matmul_g[2:4]", "ell_matmul_g",
                   "ell_lr_matmul_g", "binlr_matmul_g")),
}
G_TIMED = dict(dtype=torch.bfloat16, rank=1)
READS_NM = ("nm_matmul_g", "slab_nm_matmul_g", "slab_nm_lr_matmul_g")
READS_SIGNS = ("slab_ell_matmul_g", "slab_matmul_g", "slab_nm_matmul_g",
            "binlr_matmul_g")


def _g_planes(e, n, k, dtype, rank, gen, kernels):
    """Synthetic planes of E experts for ``kernels``, made on the card row
    by row (every mask and packer works per row, so the E·N rows pack as
    one matrix and reshape to (E, N, ...)). The ELL planes of ell /
    ell_lr pad K_max to an odd width, so that a row's 16-byte alignment
    follows its global row e·N + row."""
    from repro_torch.core import packing, sparsity
    dev = "cuda"
    need = set(kernels)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    w = randn(e * n, k, scale=0.05)
    score = randn(e * n, k).abs()
    planes = {}
    for pat in ("2:4", "4:8"):
        nn, mm = sparsity.parse_pattern(pat)
        if k % mm or not need & set(READS_NM):
            continue
        p = packing.pack_nm(torch.where(sparsity.nm_mask(score, nn, mm), w,
                                        0.0).to(dtype), nn, mm, strict=True)
        planes[pat] = (p.values.reshape(e, n, k // mm, nn).contiguous(),
                       p.indices.reshape(e, n, k // mm, nn).contiguous())

    def ell(keep, odd):
        ws = torch.where(sparsity.group_topk_mask(score, keep), w,
                         0.0).to(dtype)
        nnz = packing.ell_row_nnz_max(ws)
        p = packing.ell_pack(ws, nnz=nnz | 1 if odd else nnz)
        return (p.values.reshape(e, n, -1).contiguous(),
                p.indices.reshape(e, n, -1).contiguous())

    for kern, kind, odd in (("slab_ell_matmul_g", "slab", False),
                            ("ell_matmul_g", "ell", True),
                            ("ell_lr_matmul_g", "ell_lr", True)):
        if kern in need:
            planes[kind] = ell(KEEP[kind], odd)
    if need & {"slab_matmul_g", "slab_lr_matmul_g"}:
        planes["dense"] = torch.where(sparsity.group_topk_mask(score, 0.737),
                                      w, 0.0).to(dtype).reshape(e, n, k)
    del w, score
    if k % 32 == 0 and need & set(READS_SIGNS):
        signs = torch.where(randn(e * n, k) >= 0, 1, -1).to(torch.int8)
        planes["b"] = packing.pack_sign_bits(signs).reshape(e, n, k // 32)
    planes["u"] = randn(e, rank, n, scale=0.2).abs().to(dtype).contiguous()
    planes["v"] = randn(e, rank, k, scale=0.2).abs().to(dtype).contiguous()
    return planes


def _g_cases(planes, x, rank, kernels, wide_ids=False):
    """The Case of each of ``kernels`` whose planes exist (kernel layout u
    (E, R, N), v (E, R, K)); w_hat is the dense (E, N, K) stack. Kernels
    without a low-rank term run at rank 1 only; ``wide_ids`` adds the ELL
    kernels with int32 id views."""
    from repro_torch.core.packing import (ELLPacked, NMPacked, as_unsigned,
                                          ell_unpack, unpack_nm,
                                          unpack_sign_bits)
    from repro_torch.kernels import grouped as g_k
    e, m, k = x.shape
    u, v = planes["u"], planes["v"]
    n = u.shape[2]
    want = set(kernels)

    def stack(fn, *planes_e):
        return lambda: torch.stack([fn(*(p[i] for p in planes_e))
                                    for i in range(e)])

    def ops(stored, lowrank=False, binary=False):
        o = 2 * m * stored
        if lowrank:  # the projection x @ Vᵀ and its application
            o += e * rank * (2 * m * k + 2 * m * n)
        if binary:   # x ⊙ v_r, a sign-add per weight, the u_r scale
            o += e * rank * (m * k + 2 * m * n * k + 2 * m * n)
        return o

    def lr():
        return torch.einsum("ern,erk->enk", u.float(), v.float())

    def w_b():
        return lr() * unpack_sign_bits(planes["b"].reshape(e * n, -1), k,
                                       torch.float32).reshape(e, n, k)

    def ell_dense(vals, idx):
        return stack(lambda a, c: ell_unpack(ELLPacked(a, c, k)).float(),
                     vals, idx)

    def nm_dense(nv, ni, nn, mm):
        return stack(lambda a, b: unpack_nm(NMPacked(a, b, nn, mm, k))
                     .float(), nv, ni)

    def ells(kind):
        out = [("", planes[kind])]
        if wide_ids:
            out.append(("[int32]", (planes[kind][0],
                                    as_unsigned(planes[kind][1]).int())))
        return out

    def nms():
        return [(pat, *planes[pat], *map(int, pat.split(":")))
                for pat in ("2:4", "4:8") if pat in planes]

    out = []
    b = planes.get("b")
    if b is not None and "slab_ell_matmul_g" in want:
        for tag, (vals, idx) in ells("slab"):
            out.append(Case(
                f"slab_ell_matmul_g{tag}", "slab_ell_matmul_g",
                lambda vals=vals, idx=idx: g_k.slab_ell_matmul_g(
                    x, vals, idx, b, u, v),
                lambda vals=vals, idx=idx: g_k.slab_ell_matmul_g_plain(
                    x, vals, idx, b, u, v),
                (vals, idx, b, u, v),
                lambda vals=vals, idx=idx: ell_dense(vals, idx)() + w_b(),
                ops(vals.numel(), binary=True),
                libs={kk.key: (lambda kk=kk, vals=vals, idx=idx:
                               g_k.launch_slab_ell_g(kk, x, vals, idx, b,
                                                     u, v))
                      for kk in (g_k.SLAB_ELL_G, g_k.SLAB_ELL_G_FIRST)}))
    if b is not None and "slab_nm_matmul_g" in want:
        for pat, nv, ni, nn, mm in nms():
            out.append(Case(
                f"slab_nm_matmul_g[{pat}]", "slab_nm_matmul_g",
                lambda nv=nv, ni=ni, mm=mm: g_k.slab_nm_matmul_g(
                    x, nv, ni, mm, b, u, v),
                lambda nv=nv, ni=ni, mm=mm: g_k.slab_nm_matmul_g_plain(
                    x, nv, ni, mm, b, u, v),
                (nv, ni, b, u, v),
                lambda nv=nv, ni=ni, nn=nn, mm=mm:
                    nm_dense(nv, ni, nn, mm)() + w_b(),
                ops(nv.numel(), binary=True),
                libs={kk.key: (lambda kk=kk, nv=nv, ni=ni, mm=mm:
                               g_k.launch_slab_nm_g(kk, x, nv, ni, mm, b, u,
                                                    v))
                      for kk in (g_k.SLAB_NM_G, g_k.SLAB_NM_G_FIRST)}))
    if b is not None and "slab_matmul_g" in want:
        ws = planes["dense"]
        out.append(Case(
            "slab_matmul_g", "slab_matmul_g",
            lambda: g_k.slab_matmul_g(x, ws, b, u, v),
            lambda: g_k.slab_matmul_g_plain(x, ws, b, u, v),
            (ws, b, u, v), lambda: ws.float() + w_b(),
            ops(ws.numel(), binary=True),
            libs={kk.key: (lambda kk=kk: g_k.launch_slab_g(kk, x, ws, b, u,
                                                           v))
                  for kk in (g_k.SLAB_G, g_k.SLAB_G_FIRST)}))
    if b is not None and "binlr_matmul_g" in want:
        out.append(Case(
            "binlr_matmul_g", "binlr_matmul_g",
            lambda: g_k.binlr_matmul_g(x, b, u, v),
            lambda: g_k.binlr_matmul_g_plain(x, b, u, v),
            (b, u, v), w_b, ops(0, binary=True),
            libs={kk.key: (lambda kk=kk: g_k.launch_binlr_g(kk, x, b, u, v))
                  for kk in (g_k.BINLR_G, g_k.BINLR_G_FIRST)}))
    if rank == 1 and "nm_matmul_g" in want:
        for pat, nv, ni, nn, mm in nms():
            out.append(Case(
                f"nm_matmul_g[{pat}]", "nm_matmul_g",
                lambda nv=nv, ni=ni, mm=mm: g_k.nm_matmul_g(x, nv, ni, mm),
                lambda nv=nv, ni=ni, mm=mm: g_k.nm_matmul_g_plain(
                    x, nv, ni, mm),
                (nv, ni), nm_dense(nv, ni, nn, mm), ops(nv.numel()),
                libs={kk.key: (lambda kk=kk, nv=nv, ni=ni, mm=mm:
                               g_k.launch_nm_g(kk, x, nv, ni, mm))
                      for kk in (g_k.NM_G, g_k.NM_G_FIRST)}))
    if rank == 1 and "ell_matmul_g" in want:
        for tag, (vals, idx) in ells("ell"):
            out.append(Case(
                f"ell_matmul_g{tag}", "ell_matmul_g",
                lambda vals=vals, idx=idx: g_k.ell_matmul_g(x, vals, idx),
                lambda vals=vals, idx=idx: g_k.ell_matmul_g_plain(
                    x, vals, idx),
                (vals, idx), ell_dense(vals, idx), ops(vals.numel()),
                libs={kk.key: (lambda kk=kk, vals=vals, idx=idx:
                               g_k.launch_ell_g(kk, x, vals, idx))
                      for kk in (g_k.ELL_G, g_k.ELL_G_FIRST)}))
    if "ell_lr_matmul_g" in want:
        for tag, (vals, idx) in ells("ell_lr"):
            out.append(Case(
                f"ell_lr_matmul_g{tag}", "ell_lr_matmul_g",
                lambda vals=vals, idx=idx: g_k.ell_lr_matmul_g(
                    x, vals, idx, u, v),
                lambda vals=vals, idx=idx: g_k.ell_lr_matmul_g_plain(
                    x, vals, idx, u, v),
                (vals, idx, u, v),
                lambda vals=vals, idx=idx: ell_dense(vals, idx)() + lr(),
                ops(vals.numel(), lowrank=True),
                libs={kk.key: (lambda kk=kk, vals=vals, idx=idx:
                               g_k.launch_ell_lr_g(kk, x, vals, idx, u, v))
                      for kk in (g_k.ELL_LR_G, g_k.ELL_LR_G_FIRST)}))
    if "slab_lr_matmul_g" in want:
        ws = planes["dense"]
        out.append(Case(
            "slab_lr_matmul_g", "slab_lr_matmul_g",
            lambda: g_k.slab_lr_matmul_g(x, ws, u, v),
            lambda: g_k.slab_lr_matmul_g_plain(x, ws, u, v),
            (ws, u, v), lambda: ws.float() + lr(),
            ops(ws.numel(), lowrank=True),
            libs={kk.key: (lambda kk=kk: g_k.launch_slab_lr_g(kk, x, ws, u,
                                                              v))
                  for kk in (g_k.SLAB_LR_G, g_k.SLAB_LR_G_FIRST)}))
    if "slab_nm_lr_matmul_g" in want:
        for pat, nv, ni, nn, mm in nms():
            out.append(Case(
                f"slab_nm_lr_matmul_g[{pat}]", "slab_nm_lr_matmul_g",
                lambda nv=nv, ni=ni, mm=mm: g_k.slab_nm_lr_matmul_g(
                    x, nv, ni, mm, u, v),
                lambda nv=nv, ni=ni, mm=mm: g_k.slab_nm_lr_matmul_g_plain(
                    x, nv, ni, mm, u, v),
                (nv, ni, u, v),
                lambda nv=nv, ni=ni, nn=nn, mm=mm:
                    nm_dense(nv, ni, nn, mm)() + lr(),
                ops(nv.numel(), lowrank=True),
                libs={kk.key: (lambda kk=kk, nv=nv, ni=ni, mm=mm:
                               g_k.launch_slab_nm_lr_g(kk, x, nv, ni, mm, u,
                                                       v))
                      for kk in (g_k.SLAB_NM_LR_G, g_k.SLAB_NM_LR_G_FIRST)}))
    return out


def grouped_checks(flush, model):
    """The grouped kernels of G_SPECS[model] against their plain versions
    at that model's expert planes; times at G_TIMED and the spec's M.
    Returns (timed records by (label, N, K), worst)."""
    from repro_torch.kernels import ops
    spec = G_SPECS[model]
    kernels, n_exp = spec["kernels"], spec["experts"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(spec["seed"])
    worst, timed, n_checks = {}, {}, 0
    by_m = {}            # kernel ms at the other M of the first shape
    sel = torch.tensor(spec["bucket"], device="cuda")
    for (n, k) in spec["shapes"]:
        for dtype in (torch.bfloat16, torch.float32):
            for rank in (1, 3):
                planes = _g_planes(n_exp, n, k, dtype, rank, gen, kernels)
                bucket = {kk: (tuple(t.index_select(0, sel).contiguous()
                                     for t in vv) if isinstance(vv, tuple)
                               else vv.index_select(0, sel).contiguous())
                          for kk, vv in planes.items()}
                runs = [(planes, n_exp, m) for m in spec["batches"]] + [
                    (bucket, len(spec["bucket"]), spec["timed_m"])]
                for pl, e, m in runs:
                    x = torch.randn((e, m, k), generator=gen,
                                    device="cuda").to(dtype)
                    wide = (n, k) == spec["shapes"][0] and e == n_exp
                    for c in _g_cases(pl, x, rank, kernels, wide_ids=wide):
                        before = ops.launch_counts()
                        got, ref = _check_case(c, x, n, dtype, rank, worst,
                                               f"E={e} N={n} K={k} M={m}")
                        _first_design_at_f32(c, dtype, before,
                                             f"E={e} N={n} K={k} M={m}")
                        n_checks += 1
                        at_timed = (e == n_exp and dtype == G_TIMED["dtype"]
                                    and rank == G_TIMED["rank"])
                        if at_timed and m == spec["timed_m"]:
                            libs = {}
                            if c.kernel in LIB_TIMED:
                                for key, fn in c.libs.items():
                                    g2, _ = _check_case(
                                        c, x, n, dtype, rank, worst,
                                        f"E={e} N={n} K={k} M={m} through "
                                        f"{key}", kern=fn, ref=ref)
                                    n_checks += 1
                                    libs[key] = (fn, float(
                                        (g2.float() - ref.float()).abs()
                                        .max()))
                                    del g2
                            # the plain loops take up to ~100 ms: 3 reps
                            timed[(c.label, n, k)] = _time_case(
                                c, x, rank, got, ref, flush, plain_reps=3,
                                libs=libs)
                        elif (e == n_exp and m == spec["timed_m"]
                              and dtype == torch.float32 and rank == 1
                              and c.label in spec.get("timed_f32", ())):
                            timed[(c.label + " f32", n, k)] = _time_case(
                                c, x, rank, got, ref, flush, plain_reps=3)
                        elif at_timed and (n, k) == spec["shapes"][0]:
                            by_m.setdefault(c.label, {})[m] = time_ms(
                                c.kern, flush)
                        del got, ref
                del planes, bucket
                torch.cuda.empty_cache()
    n, k = spec["odd"]
    any_k = [kk for kk in kernels if kk not in READS_SIGNS]
    for dtype in (torch.bfloat16, torch.float32):
        planes = _g_planes(n_exp, n, k, dtype, 1, gen, any_k)
        for m in spec["batches"]:
            x = torch.randn((n_exp, m, k), generator=gen,
                            device="cuda").to(dtype)
            for c in _g_cases(planes, x, 1, any_k):
                _check_case(c, x, n, dtype, 1, worst,
                            f"E={n_exp} N={n} K={k} M={m}")
                n_checks += 1
        del planes
    torch.cuda.empty_cache()
    n, k = spec["shapes"][0]
    sweep = spec["sweep"]
    dtype, rank = G_TIMED["dtype"], G_TIMED["rank"]
    planes = _g_planes(n_exp, n, k, dtype, rank, gen, sweep)
    source = {kk.key: kk.source for kk in ops.KERNELS}
    picked = {}          # the library the wrapper ran, by label and M
    by_lib = {}          # ms of each library alone, by (label, key) and M
    for m in G_SWEEP_M:
        x = torch.randn((n_exp, m, k), generator=gen, device="cuda").to(dtype)
        for c in _g_cases(planes, x, rank, sweep):
            before = ops.launch_counts()
            where = f"E={n_exp} N={n} K={k} M={m} (sweep)"
            _, ref = _check_case(c, x, n, dtype, rank, worst, where)
            n_checks += 1
            picked.setdefault(c.label, {})[m] = " ".join(
                source[kk] for kk, v in ops.launch_counts().items()
                if v > before[kk])
            if m != spec["timed_m"]:
                by_m.setdefault(c.label, {})[m] = time_ms(c.kern, flush)
            for key, fn in c.libs.items():
                _check_case(c, x, n, dtype, rank, worst,
                            f"{where} through {source[key]}", kern=fn,
                            ref=ref)
                n_checks += 1
                by_lib.setdefault((c.label, key), {})[m] = time_ms(fn, flush)
            del ref
    del planes
    torch.cuda.empty_cache()
    ops.reset_launch_counts()        # comparison launches do not count
    for label, ms in by_m.items():
        ms[spec["timed_m"]] = timed[(label, n, k)]["ms"]
        on = picked.get(label, {})
        log(f"  M sweep {label} E={n_exp} N={n} K={k} bf16 r1: "
            + " ".join(f"M={m}: {t:.4f} ms"
                       + (f" ({on[m]})" if m in on else "")
                       for m, t in sorted(ms.items())))
    for (label, key), ms in by_lib.items():
        log(f"  M sweep {label} E={n_exp} N={n} K={k} bf16 r1 through "
            f"{source[key]}: "
            + " ".join(f"M={m}: {t:.4f} ms" for m, t in sorted(ms.items())))
    log(f"grouped kernel checks ({model}): {n_checks} cases passed; worst "
        "max|err|/max|ref|: "
        + " ".join(f"{l}={w:.3g}" for l, w in worst.items()))
    return timed, worst


# flash-decode (#10, #11) at the decode shapes of the two ported attention
# layouts, R = 8 rows: llama2-7b (MHA, KV 32, G 1, dh 128) and stablelm-12b
# (GQA, KV 8, G 4, dh 160); and at two wider groups the reference's
# configs carry: qwen2-vl-2b (12 heads over KV 2: G 6, dh 128) and
# nemotron-4-340b (96 over KV 8: G 12, dh 192). Lengths: an empty row, one
# token, exact chunk boundaries and their neighbours, up to 4096. Then the
# engine's decode shape: 4 rows of llama2-7b up to 320 tokens, blocks of
# 16. Timed (bf16, model dtype, blocks of 16): FD_TIMED, the JSON line's;
# the GQA layout; the engine's shape.
FD_LAYOUTS = {"llama2-7b": (32, 1, 128), "stablelm-12b": (8, 4, 160),
              "qwen2-vl-2b": (2, 6, 128), "nemotron-4-340b": (8, 12, 192)}
FD_MAX = 4096
FD_TIMED = dict(layout="llama2-7b", bs=16, dtype=torch.bfloat16, quant=False)
FD_ENGINE = dict(layout="llama2-7b", lengths=(33, 100, 257, 320), s=320)
FD_TIMES = (("llama2-7b", FD_MAX), ("stablelm-12b", FD_MAX),
            ("llama2-7b", FD_ENGINE["s"]))


def _fd_lengths(bs):
    return [0, 1, bs, bs + 1, 777, 2048, FD_MAX - 1, FD_MAX]


def _fd_inputs(layout, bs, s, dtype, quant, gen, paged, lengths):
    """q, the cache (contiguous (R, S, KV, dh) or a pool of scattered
    blocks with tables) and lengths, made on the card; R = len(lengths)."""
    from repro_torch.models.attention import _quantize_token
    kv, g, dh = FD_LAYOUTS[layout]
    dev = "cuda"
    rows = len(lengths)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    lengths = lengths.clamp(max=s)
    q = (torch.randn((rows, kv, g, dh), generator=gen, device=dev)
         * dh ** -0.5).to(dtype)
    k = torch.randn((rows, s, kv, dh), generator=gen, device=dev)
    v = torch.randn((rows, s, kv, dh), generator=gen, device=dev)
    ks = vs = None
    if quant:
        k, ks = _quantize_token(k)
        v, vs = _quantize_token(v)
    else:
        k, v = k.to(dtype), v.to(dtype)
    if not paged:
        return dict(q=q, k=k, v=v, lengths=lengths, k_scale=ks, v_scale=vs)
    n_bt = -(-s // bs)
    n_blocks = rows * n_bt + 7
    perm = torch.randperm(n_blocks, generator=gen, device=dev)
    tables = perm[:rows * n_bt].reshape(rows, n_bt).to(torch.int32)

    def pool(t):
        if t is None:
            return None
        pad = n_bt * bs - s
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        out = torch.zeros((n_blocks, bs) + tuple(t.shape[2:]),
                          dtype=t.dtype, device=dev)
        out[tables.long().reshape(-1)] = t.reshape(
            (rows * n_bt, bs) + tuple(t.shape[2:]))
        return out

    # table entries past a row's length may name any block: scramble them
    junk = torch.randint(0, n_blocks, tables.shape, generator=gen,
                         device=dev, dtype=torch.int32)
    col = torch.arange(n_bt, device=dev)[None, :]
    used = (col * bs) < lengths[:, None]
    return dict(q=q, k_pool=pool(k), v_pool=pool(v),
                block_tables=torch.where(used, tables, junk).contiguous(),
                lengths=lengths, k_scale=pool(ks), v_scale=pool(vs),
                _contig=(k, v, ks, vs))


def _fd_bytes(a, s, bs, paged):
    """Bytes the function must move: each valid token's K and V (and their
    scales) once — on a length-0 row of the contiguous kernel, whose output
    is the mean of V, all S tokens of V (and v_scale) and no K — plus q,
    out, lengths and the table entries a row's length reaches."""
    q = a["q"]
    kv, dh = q.shape[1], q.shape[3]
    k = a["k_pool"] if paged else a["k"]
    half = kv * dh * k.element_size()          # K or V of one token
    if a["k_scale"] is not None:
        half += kv * 4
    lens = a["lengths"].tolist()
    n = sum(2 * l * half if (l or paged) else s * half for l in lens)
    if paged:
        n += 4 * sum(-(-l // bs) for l in lens)
    return n + 2 * _nbytes(q) + _nbytes(a["lengths"])


def _fd_ops(a, s, paged):
    """Operations the function must do: per valid token and query head a
    q·k and a p·v of dh multiply-adds each; on a length-0 contiguous row
    only the sum of V over S."""
    kv, g, dh = a["q"].shape[1:]
    lens = a["lengths"].tolist()
    toks = sum(lens)
    empty = 0 if paged else s * sum(1 for l in lens if l == 0)
    return (4 * toks + 2 * empty) * kv * g * dh


def _sdpa(a, paged):
    """One torch scaled_dot_product_attention call on the contiguous
    (R, KV, S, dh) layout with a boolean length mask — the yardstick; the
    transpose (and, for the paged kernel, the gather from the pool) into
    that layout is done before and not timed."""
    F = torch.nn.functional
    k, v, ks, vs = a["_contig"] if paged else (a["k"], a["v"], a["k_scale"],
                                               a["v_scale"])
    dt = a["q"].dtype
    if ks is not None:
        k = (k.float() * ks[..., None]).to(dt)
        v = (v.float() * vs[..., None]).to(dt)
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    pos = torch.arange(kt.shape[2], device="cuda")
    mask = (pos[None, :] < a["lengths"][:, None].long())[:, None, None, :]
    q = a["q"]
    return lambda: F.scaled_dot_product_attention(q, kt, vt, attn_mask=mask,
                                                  scale=1.0)


def _fd_time(name, layout, bs, s, paged, a, kern, plain, err, flush):
    """Time one case: kernel, plain version and SDPA, beside the bound."""
    from repro_torch.kernels import flash_decode as fd_k
    n_bytes = _fd_bytes(a, s, bs, paged)
    kv, g, dh = FD_LAYOUTS[layout]
    rows = a["q"].shape[0]
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = _fd_ops(a, s, paged) / PEAK_OPS[torch.float32] * 1e3
    n_max = -(-s // bs) * bs if paged else s
    n_split, split_len = fd_k.plan_splits(
        rows, kv, -(-g // fd_k.head_chunk(g, dh)), n_max,
        torch.cuda.get_device_properties(0).multi_processor_count)
    rec = {"ms": time_ms(kern, flush),
           "plain_ms": time_ms(plain, flush),
           "library_ms": time_ms(_sdpa(a, paged), flush),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": n_bytes, "max_abs_err": err,
           "shape": {"R": rows, "KV": kv, "G": g, "dh": dh, "S": s,
                     "bs": bs, "lengths": a["lengths"].tolist(),
                     "dtype": "bfloat16", "int8": False,
                     "splits": [n_split, split_len]}}
    log(f"  time {name:22s} {layout} R={rows} bs={bs} S={s} bf16 "
        f"splits={n_split}x{split_len}: kernel_ms={rec['ms']:.4f} "
        f"plain_ms={rec['plain_ms']:.4f} library_ms="
        f"{rec['library_ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
        f"({rec['bound_by']}, {n_bytes / 1e6:.2f} MB) roofline="
        f"{rec['bound_ms'] / rec['ms']:.3f}")
    return rec


def flash_checks(flush):
    """#11 and #10 against their plain versions on the card; times at
    FD_TIMES. Returns (timed records by (kernel name, layout, S), worst
    rel errors)."""
    from repro_torch.kernels import flash_decode as fd_k
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    worst, timed, n_checks = {}, {}, 0
    plans = []
    for layout in FD_LAYOUTS:
        for bs in (16, 32):
            plans.append(("flash_decode_paged", layout, bs, FD_MAX, True,
                          _fd_lengths(bs)))
            plans.append(("flash_decode", layout, bs, FD_MAX, False,
                          _fd_lengths(bs)))
        plans.append(("flash_decode", layout, 512, FD_MAX + 4, False,
                      _fd_lengths(512)))
    for name, paged in (("flash_decode_paged", True),
                        ("flash_decode", False)):
        plans.append((name, FD_ENGINE["layout"], 16, FD_ENGINE["s"], paged,
                      list(FD_ENGINE["lengths"])))
    for name, layout, bs, s, paged, lengths in plans:
        for dtype in (torch.bfloat16, torch.float32):
            for quant in (False, True):
                a = _fd_inputs(layout, bs, s, dtype, quant, gen, paged,
                               lengths)
                args = {kk: vv for kk, vv in a.items()
                        if not kk.startswith("_")}
                if paged:
                    kern = lambda: fd_k.flash_decode_paged(**args)
                    plain = lambda: fd_k.flash_decode_paged_plain(**args)
                else:
                    kern = lambda: fd_k.flash_decode(**args, bs=bs)
                    plain = lambda: fd_k.flash_decode_plain(**args, bs=bs)
                got, ref = kern(), plain()
                sync()
                err = float((got.float() - ref.float()).abs().max())
                rel = err / max(float(ref.float().abs().max()), 1e-30)
                label = f"{name}[{'int8' if quant else 'model'}]"
                worst[label] = max(worst.get(label, 0.0), rel)
                n_checks += 1
                ok = (bool(torch.isfinite(got).all()) and rel < TOL[dtype]
                      and tuple(got.shape) == tuple(a["q"].shape))
                empty = [i for i, l in enumerate(a["lengths"].tolist())
                         if l == 0]
                if paged:                       # empty rows: exact zeros
                    ok = ok and all(bool((got[i] == 0).all())
                                    for i in empty)
                if not ok:
                    raise AssertionError(
                        f"{label} {layout} bs={bs} S={s} {dtype}: "
                        f"max|err|/max|ref| = {rel:.3g} (tolerance "
                        f"{TOL[dtype]})")
                if ((layout, s) in FD_TIMES and bs == FD_TIMED["bs"]
                        and dtype == FD_TIMED["dtype"]
                        and quant == FD_TIMED["quant"]):
                    timed[(name, layout, s)] = _fd_time(
                        name, layout, bs, s, paged, a, kern, plain, err,
                        flush)
                del a, args, got, ref
    ops.reset_launch_counts()        # comparison launches do not count
    log(f"flash-decode checks: {n_checks} cases passed; worst "
        "max|err|/max|ref|: "
        + " ".join(f"{l}={w:.3g}" for l, w in worst.items()))
    return timed, worst


# ---------------------------------------------------------------- phase 3

PROMPT, GEN, BATCH = 32, 16, 4
PROF_PROMPT = 8                    # prompt tokens of a warm-up or a profile
RAGGED = (32, 20, 27, 9)
ENGINE_REQUESTS = 10
EVICT_REQUESTS = 6       # phase k's evicting run: the trace's first 6


def _final_logits(cfg, params, seq):
    """Teacher-forced decode of ``seq``; the last step's logits (f32)."""
    from repro_torch.models import lm
    from repro_torch.models.common import positions_for
    b, s = seq.shape
    cache = lm.init_cache(cfg, b, s, device="cuda")
    logits = None
    for t in range(s):
        pos = positions_for(cfg, b, 1, offset=t, device="cuda")
        logits, cache = lm.decode_step(cfg, params, cache, seq[:, t:t + 1],
                                       pos)
    return logits[:, -1].float()


@contextlib.contextmanager
def _routing_spy():
    """Record, in call order, every MoE layer's expert choices: the
    sorted top-k of the router's probabilities per token, (tokens, k)."""
    from repro_torch.models import moe
    calls = []
    orig = moe.moe_ffn

    def spy(cfg, p, x, rows=None):
        xt = x.reshape(-1, x.shape[-1])
        probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
        calls.append(probs.topk(cfg.top_k, dim=-1).indices.sort(-1).values)
        return orig(cfg, p, x, rows)

    moe.moe_ffn = spy
    try:
        yield calls
    finally:
        moe.moe_ffn = orig


def _final_logits_routed(cfg, params, seq):
    """``_final_logits`` and the expert choices of every MoE call."""
    with _routing_spy() as calls:
        logits = _final_logits(cfg, params, seq)
    return logits, calls


def _choices_differing(a, b) -> int:
    """Tokens whose expert choices differ between two runs' MoE calls."""
    return sum(int((x != y).any(-1).sum()) for x, y in zip(a, b, strict=True))


SHARED_PATHS = ("moe.shared.w_gate", "moe.shared.w_up", "moe.shared.w_down")


def _experts_dense(packed, dense):
    """The packed model with every expert leaf swapped for its
    dense-equivalent (E, D_in, D_out) weight, and the shared experts'
    linears (deepseek-moe) for theirs: the same attention kernels (so
    the same router inputs and expert choices, bit for bit, in a 1-layer
    model), dense experts."""
    from repro_torch.core.packed_model import expert_stacks
    from repro_torch.core.pipeline import _copy_tree, _get, _set
    out = dict(packed)
    out["layers"] = _copy_tree(packed["layers"])
    for l, pth, _ in expert_stacks(packed):
        _set(out["layers"][l], pth, _get(dense["layers"][l], pth))
    for l, lp in enumerate(out["layers"]):
        for pth in SHARED_PATHS:
            if _get(lp, pth) is not None:
                _set(lp, pth, _get(dense["layers"][l], pth))
    return out


def _greedy_profile(cfg, params, prompts, step_ms, label, focus=None,
                    prompt=PROF_PROMPT):
    """``_device_profile`` over one greedy_decode of the first ``prompt``
    prompt tokens and 4 new ones: ``prompt`` + 4 - 1 decode steps (the
    profiler's cost grows with the host ops it records)."""
    from repro_torch.launch.serve import greedy_decode
    _device_profile(lambda: greedy_decode(cfg, params, prompts[:, :prompt],
                                          4, device="cuda"),
                    prompt + 4 - 1, step_ms, label, focus)


def _device_profile(run, steps, step_ms, label, focus=None,
                    unit="decode step"):
    """Device busy time per step from torch.profiler (kernel events
    only) over ``run()``, which takes ``steps`` steps, set against
    ``step_ms``, the same step's unprofiled wall time: busy / wall is the
    card's busy share, the rest is time the host holds it back. Prints
    the five kernels that take the most, and with ``focus`` = (what,
    name part), or a tuple of such pairs, the device time per step of
    the kernels whose names hold that part (spaces ignored; a part may be
    a tuple of strings that must all appear) and its share of the busy
    time. Returns the busy share (None when the profiler saw no device
    time), and with ``focus`` also the first focus's time per step."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        sync()
    kern = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    if busy_ms <= 0:
        log(f"  profile {label}: the profiler saw no device time "
            "(busy share not measured)")
        return (None, None) if focus else None
    share = min(busy_ms / step_ms, 1.0)
    log(f"  profile {label}: device busy {busy_ms:.3f} ms per {unit} "
        f"of {step_ms:.3f} ms wall (busy share {share:.3f})")
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    for e in top:
        log(f"    {e.self_device_time_total / 1e3 / steps:8.4f} ms/step "
            f"x{e.count // steps:<3d} {e.key[:90]}")
    if not focus:
        return share
    first = None
    for what, part in ((focus,) if isinstance(focus[0], str) else focus):
        parts = [p.replace(" ", "") for p in
                 ((part,) if isinstance(part, str) else part)]
        hit = [e for e in kern
               if all(p in e.key.replace(" ", "") for p in parts)]
        ms = sum(e.self_device_time_total for e in hit) / 1e3 / steps
        log(f"  profile {label}: {what} {ms:.4f} ms per step "
            f"({ms / busy_ms:.3f} of busy) in "
            f"{sum(e.count for e in hit) / steps:g} launches ("
            + ", ".join(e.key.split("(")[0][:60] for e in hit) + ")")
        first = ms if first is None else first
    return share, first


def _perplexity(cfg, params, batch) -> float:
    """exp(cross-entropy) of one eval batch through ``lm.loss_fn``."""
    from repro_torch.models import lm
    _, parts = lm.loss_fn(cfg, params, batch)
    return float(torch.exp(parts["ce"]))


def _zero_sparse_part(cfg, dense_c, decs, dtype):
    """W_S := 0 in every decomposition, each expert's of a MoE leaf too
    (what remains is W_L ⊙ W_B, the binlr variant), and the
    dense-equivalent params rebuilt to match."""
    from repro_torch.core.pipeline import _set
    from repro_torch.core.slab import reconstruct

    def zero(dec):
        return dec._replace(w_s=torch.zeros_like(dec.w_s))

    out = {}
    for (l, name), dec in decs.items():
        if type(dec) is tuple:          # one dec per expert
            dec = tuple(zero(d) for d in dec)
            w = torch.stack([reconstruct(d).T for d in dec])
        else:
            dec = zero(dec)
            w = reconstruct(dec).T
        _set(dense_c["layers"][l], name, w.to(dtype).contiguous())
        out[(l, name)] = dec
    return out


def _check_packed(cfg, packed, rep, variant):
    """Every linear of every layer packed as ``variant``: each 2-D linear a
    PackedLinear, each expert of a MoE leaf in a group of that variant
    with no expert left dense. Returns the number of linears (an expert
    counts as one) and, for a MoE model, the groups of each leaf."""
    from repro_torch.core.packed_model import (ExpertPackedStack,
                                               PackedLinear, expert_stacks)
    from repro_torch.core.pipeline import _get, linear_paths
    n_lin = 0
    for l, lp in enumerate(packed["layers"]):
        for pth in linear_paths(cfg):
            w = _get(lp, pth)
            if isinstance(w, ExpertPackedStack):
                if (w.variant_counts() != {variant: cfg.n_experts}
                        or w.dense_members):
                    raise AssertionError(f"L{l}/{pth} packed as "
                                         f"{w.describe()}, expected "
                                         f"{variant} for every expert")
                n_lin += cfg.n_experts
            elif isinstance(w, PackedLinear) and w.variant == variant:
                n_lin += 1
            else:
                raise AssertionError(f"L{l}/{pth} packed as "
                                     f"{getattr(w, 'variant', 'dense')}, "
                                     f"expected {variant}")
    if rep.by_variant != {variant: n_lin} or rep.fallback:
        raise AssertionError(f"pack report {rep.by_variant}, dense experts "
                             f"{rep.fallback}")
    groups = {f"L{l}/{pth}": len(eps.groups)
              for l, pth, eps in expert_stacks(packed)}
    return n_lin, groups


def _expert_bytes(packed, dense):
    """Packed bytes of every MoE leaf against its dense bytes."""
    from repro_torch.core.packed_model import expert_stacks
    from repro_torch.core.pipeline import _get
    pb = db = 0
    for l, pth, eps in expert_stacks(packed):
        pb += sum(g.nbytes() for g in eps.groups)
        w = _get(dense["layers"][l], pth)
        db += w.numel() * w.element_size()
    return pb, db


def _only_through(counts, key, where, allowed=()):
    """Raise if a kernel that counts per library launched through another
    library than ``key`` or those ``allowed`` (every launch of a phase's
    kernel should run the library the phase names)."""
    from repro_torch.kernels import ops
    name = {kk.key: kk.name for kk in ops.KERNELS}
    for other, c in counts.items():
        if (c and other != key and other not in allowed
                and name[other] == name[key]):
            raise AssertionError(
                f"{where}: {other} launched {c} times; every "
                f"{name[key]} launch here should count on {key}")


def _serve_and_hold(tag, cfg, packed, dense_c, need, tol, profiled=True,
                    focus=None, hold=None, prof_prompt=PROF_PROMPT):
    """greedy_decode of ``packed`` (BATCH prompts of PROMPT tokens, GEN
    new ones), square and then RAGGED, each run with the launch counts
    zeroed just before and read just after: every kernel of ``need`` must
    launch at least its count in each run, only through the libraries
    ``need`` names. Then the dense-equivalent model's square decode (the
    yardstick), both profiled with ``profiled`` (busy / wall ms a step,
    ``focus`` as _greedy_profile takes it, over ``prof_prompt`` prompt
    tokens and 4 new ones; each model warmed up first on PROF_PROMPT
    prompt tokens); the ragged run's full-length row must
    equal the square run's, and the last-position logits must lie within
    ``tol`` of the dense-equivalent's (_hold_moe_logits on a MoE model;
    ``hold(seq, square tokens, dense-equivalent's tokens)`` instead where
    given). Returns the launches of ``need``'s kernels over both runs."""
    from repro_torch.data import SyntheticCorpus
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import greedy_decode
    prompts = SyntheticCorpus(cfg.vocab, seed=0).batch(
        0, BATCH, PROMPT)["inputs"]
    warm = prompts[:, :PROF_PROMPT]
    greedy_decode(cfg, packed, warm, 2, device="cuda")   # warm-up
    sync()
    steps = PROMPT + GEN - 1
    launched = dict.fromkeys(need, 0)
    runs = {}
    for mode, lengths in (("square", None), ("ragged", RAGGED)):
        ops.reset_launch_counts()
        sync()
        t0 = time.monotonic()
        gen = greedy_decode(cfg, packed, prompts, GEN, lengths=lengths,
                            device="cuda")
        sync()
        dt = time.monotonic() - t0
        counts = ops.launch_counts()
        for kname, n_need in need.items():
            if counts[kname] < n_need:
                raise AssertionError(
                    f"phase {tag}: {kname} launched {counts[kname]} times "
                    f"in the {mode} run, expected >= {n_need}")
            _only_through(counts, kname, f"phase {tag} {mode} run",
                          allowed=need)
            launched[kname] += counts[kname]
        if tuple(gen.shape) != (BATCH, GEN) or not bool(
                ((gen >= 0) & (gen < cfg.vocab)).all()):
            raise AssertionError(f"phase {tag}: bad generation "
                                 f"{tuple(gen.shape)}")
        n_tok = BATCH * (PROMPT + GEN) if lengths is None \
            else sum(lengths) + BATCH * GEN
        log(f"  greedy_decode {mode}: {n_tok / dt:.1f} tok/s, "
            f"{dt / steps * 1e3:.2f} ms per decode step, launches "
            + " ".join(f"{kk}={c}" for kk, c in counts.items() if c))
        runs[mode] = (gen, dt)
    # the yardstick: the same model served dense (reconstructed Ŵ)
    greedy_decode(cfg, dense_c, warm, 2, device="cuda")
    sync()
    t0 = time.monotonic()
    dense_gen = greedy_decode(cfg, dense_c, prompts, GEN, device="cuda")
    sync()
    dt_dense = time.monotonic() - t0
    log(f"  dense-equivalent greedy_decode square: "
        f"{BATCH * (PROMPT + GEN) / dt_dense:.1f} tok/s, "
        f"{dt_dense / steps * 1e3:.2f} ms per decode step")
    if profiled:
        _greedy_profile(cfg, packed, prompts,
                        runs["square"][1] / steps * 1e3, "packed", focus,
                        prof_prompt)
        _greedy_profile(cfg, dense_c, prompts, dt_dense / steps * 1e3,
                        "dense-equivalent", prompt=prof_prompt)
    sq, rg = runs["square"][0], runs["ragged"][0]
    if cfg.family != "moe" and not torch.equal(sq[0], rg[0]):
        # (a MoE row's output depends on its step's other rows through
        # the expert capacity, so the ragged batch may route it apart)
        raise AssertionError(f"phase {tag}: ragged row 0 (full-length "
                             f"prompt) differs from the square run")
    seq = torch.cat([torch.as_tensor(prompts, device="cuda").long(),
                     sq[:, :-1]], dim=1)
    if hold is not None:
        hold(seq, sq, dense_gen)
    elif cfg.family == "moe":
        _hold_moe_logits(tag, cfg, packed, dense_c, seq, tol)
    else:
        _hold_logits(tag, _final_logits(cfg, packed, seq),
                     _final_logits(cfg, dense_c, seq), tol,
                     "packed vs dense-equivalent")
    return launched


# compressions made while the kernels build (``compress_ahead``), by
# phase tag; a phase takes its own and makes it itself where there is none
AHEAD = {}
# the phases whose compression runs while nvcc builds: phase s's SparseGPT
# of 199 linears (Hessian taps, 64 experts a leaf) took 87-116 s of the
# script's time on its own, the build 132-221 s
AHEAD_PHASES = ("s",)


def compress_ahead():
    """``_phase_front`` of every AHEAD_PHASES phase, kept in AHEAD until
    the phase runs (the compressed model stays on the card until then)."""
    t0 = time.monotonic()
    kw = dict(PHASES)
    for tag in AHEAD_PHASES:
        AHEAD[tag] = _phase_front(**kw[tag])
    mesh_ahead()
    families_ahead()
    log(f"compressed ahead while the kernels built: phase "
        f"{', '.join(AHEAD_PHASES)}, phase M's two models and phase F's "
        f"three in {time.monotonic() - t0:.1f}s")


def _phase_front(n_layers, dtype, cr, pattern, method="slab", options=None,
                 ppl=False, arch="llama2_7b", **_):
    """``model_phase``'s compression, which launches no kernel: ``arch`` at
    full width cut to ``n_layers``, random weights from seed 0, the
    uncompressed model's perplexity with ``ppl``, then compress_model
    under ``method``'s plan (CR ``cr``, ``pattern``, ``options``) on 16 x
    128 calibration tokens. Returns its results by name."""
    from repro_torch import configs
    from repro_torch.core.pipeline import compress_model
    from repro_torch.core.plan import plan_for_method
    from repro_torch.core.slab import SLaBConfig
    from repro_torch.data import SyntheticCorpus, calibration_batch
    from repro_torch.models import lm
    full = configs.get(arch, smoke=False)
    cfg = full.with_(n_layers=n_layers, dtype=dtype)
    options = dict(iters=8) if options is None else options
    params = lm.init(cfg, seed=0, device="cuda")
    calib = calibration_batch(cfg.vocab, seed=0, n_seq=16, seq_len=128)
    eval_batch = next(SyntheticCorpus(cfg.vocab, seed=0).eval_batches(
        1, BATCH, 129))
    ppl_orig = _perplexity(cfg, params, eval_batch) if ppl else None
    t0 = time.monotonic()
    plan = plan_for_method(method, SLaBConfig(cr=cr, pattern=pattern,
                                              **options))
    dense_c, stats, decs = compress_model(
        cfg, params, calib, plan=plan, keep_decompositions=True,
        device="cuda")
    sync()
    return dict(full=full, cfg=cfg, options=options, eval_batch=eval_batch,
                ppl_orig=ppl_orig, plan=plan, dense_c=dense_c, stats=stats,
                decs=decs, t_comp=time.monotonic() - t0)


def model_phase(tag, n_layers, dtype, cr, pattern, variant, kernel, tol,
                profiled=False, method="slab", options=None, note="",
                ppl=False, zero_ws=False, arch="llama2_7b",
                expert_kernel=None, focus=None):
    """compress_model (``_phase_front``, or its result made ahead) ->
    pack_model -> greedy_decode of ``arch`` at full width cut to
    ``n_layers``; ``kernel`` serves every 2-D linear and, on a MoE model,
    ``expert_kernel`` every expert leaf (one launch per group). ``focus``
    (what, kernel name part): the profile's device time of that kernel.
    Returns the launches of the main-path runs per kernel."""
    from repro_torch.core.packed_model import pack_model

    front = AHEAD.pop(tag, None) or _phase_front(
        n_layers, dtype, cr, pattern, method, options, ppl, arch)
    full, cfg, options, plan = (front[k] for k in ("full", "cfg", "options",
                                                   "plan"))
    dense_c, stats, decs = front["dense_c"], front["stats"], front["decs"]
    eval_batch, ppl_orig, t_comp = (front[k] for k in (
        "eval_batch", "ppl_orig", "t_comp"))
    del front
    opt_s = "".join(f" {k}={v}" for k, v in options.items())
    moe_s = (f" experts {cfg.n_experts} top-{cfg.top_k} capacity factor "
             f"{cfg.capacity_factor}" if cfg.family == "moe" else "")
    if cfg.shared_ff:
        moe_s += f" shared_ff {cfg.shared_ff}"
    log(f"phase {tag}: {full.name} d_model {cfg.d_model} heads "
        f"{cfg.n_heads}x{cfg.d_head} kv {cfg.n_kv} d_ff {cfg.d_ff}{moe_s} "
        f"vocab {cfg.vocab} {dtype} {method}{opt_s} cr {cr} pattern "
        f"{pattern}; reduced: n_layers {full.n_layers}->{n_layers}"
        + (f"; {note}" if note else ""))
    if zero_ws:
        decs = _zero_sparse_part(cfg, dense_c, decs, dtype)
    packed, rep = pack_model(dense_c, decs, plan=plan, dtype=dtype)
    del decs
    n_lin, groups = _check_packed(cfg, packed, rep, variant)
    err_rel = max(s.err_after / s.err_before for s in stats)
    log(f"  compressed {len(stats)} leaves in {t_comp:.1f}s (measured CR "
        f"{sum(s.cr for s in stats) / len(stats):.4f}, worst weighted "
        f"err_after/err_before {err_rel:.4f}"
        + ("; then W_S := 0" if zero_ws else "")
        + f"); packed {rep.n_packed} [{variant}={rep.by_variant[variant]}]")
    for var, (pb, db) in sorted(rep.bytes_by_variant.items()):
        log(f"  bytes/{var}: {pb / 1e6:.3f} MB packed vs {db / 1e6:.3f} MB "
            f"dense per linear ({pb / db:.4f}x)")
    if groups:
        pb, db = _expert_bytes(packed, dense_c)
        log(f"  experts: every one of {cfg.n_experts} per leaf {variant}, "
            f"0 dense; {pb / 1e6:.1f} MB packed vs {db / 1e6:.1f} MB dense "
            f"({pb / db:.4f}x); groups per leaf "
            + " ".join(f"{k}={v}" for k, v in groups.items()))
    if ppl:
        log(f"  eval perplexity (lm.loss_fn, {BATCH}x128 synthetic tokens): "
            f"uncompressed {ppl_orig:.2f}, compressed packed "
            f"{_perplexity(cfg, packed, eval_batch):.2f}, compressed "
            f"dense-equivalent {_perplexity(cfg, dense_c, eval_batch):.2f}")

    steps = PROMPT + GEN - 1
    n_flat = n_lin - cfg.n_experts * len(groups)      # 2-D linears
    need = {kernel: n_flat * steps}
    if expert_kernel:
        need[expert_kernel] = len(groups) * steps     # >= 1 per leaf
    launched = _serve_and_hold(tag, cfg, packed, dense_c, need, tol,
                               profiled=profiled, focus=focus)
    del packed, dense_c
    torch.cuda.empty_cache()
    return launched


def _hold_logits(tag, got, want, tol, what) -> float:
    """Raise unless both are finite and max|got - want| / max|want| <
    tol; returns that ratio."""
    if not (bool(torch.isfinite(got).all())
            and bool(torch.isfinite(want).all())):
        raise AssertionError(f"phase {tag}: non-finite logits")
    rel = float((got - want).abs().max() / want.abs().max())
    log(f"  final-step logits {what}: max|diff|/max|ref| = {rel:.3g} "
        f"(tolerance {tol})")
    if not rel < tol:
        raise AssertionError(f"phase {tag}: logits rel {rel} >= {tol}")
    return rel


def _hold_moe_logits(tag, cfg, packed, dense_c, seq, tol):
    """A MoE model's routing is discontinuous: at bf16 a last-bit
    difference in a router input can flip a token's expert choice (or, by
    the capacity, a neighbour's), and no logits tolerance then holds. The
    packed model is held against the same packed attention with
    dense-equivalent experts, whose expert choices must agree token for
    token in every MoE call of the teacher-forced run; against the whole
    dense-equivalent model the logits and the differing choices are
    reported."""
    lp, calls_p = _final_logits_routed(cfg, packed, seq)
    le, calls_e = _final_logits_routed(cfg, _experts_dense(packed, dense_c),
                                       seq)
    n_tok = sum(int(c.shape[0]) for c in calls_p)
    n_diff = _choices_differing(calls_p, calls_e)
    log(f"  expert choices, packed vs dense experts behind the same "
        f"attention: {n_diff} of {n_tok} tokens differ")
    if n_diff:
        raise AssertionError(f"phase {tag}: {n_diff} expert choices differ")
    _hold_logits(tag, lp, le, tol, "packed vs dense-equivalent experts")
    ld, calls_d = _final_logits_routed(cfg, dense_c, seq)
    rel = float((lp - ld).abs().max() / ld.abs().max())
    log(f"  against the whole dense-equivalent model (not held): "
        f"max|diff|/max|ref| = {rel:.3g}, expert choices of "
        f"{_choices_differing(calls_p, calls_d)} of {n_tok} tokens differ")


def _packed_model(arch, n_layers, dtype, keep_dense=False, **cfg_kw):
    """``arch`` at full width, cut to ``n_layers``, SLaB-compressed (CR
    0.5, 8 iterations, 16x128 calibration) and packed: slab-ell
    everywhere. Returns (cfg, packed) and, with ``keep_dense``, the
    dense-equivalent params too."""
    from repro_torch import configs
    from repro_torch.core.packed_model import pack_model
    from repro_torch.core.pipeline import compress_model
    from repro_torch.core.slab import SLaBConfig
    from repro_torch.data import calibration_batch
    from repro_torch.models import lm
    cfg = configs.get(arch, smoke=False).with_(
        n_layers=n_layers, dtype=dtype, **cfg_kw)
    params = lm.init(cfg, seed=0, device="cuda")
    calib = calibration_batch(cfg.vocab, seed=0, n_seq=16, seq_len=128)
    dense_c, _, decs = compress_model(
        cfg, params, calib, method="slab",
        scfg=SLaBConfig(cr=0.5, iters=8), keep_decompositions=True,
        device="cuda")
    del params
    packed, rep = pack_model(dense_c, decs, dtype=dtype)
    _check_packed(cfg, packed, rep, "slab-ell")
    del decs
    if keep_dense:
        return cfg, packed, dense_c
    del dense_c
    return cfg, packed


def _check_no_leak(eng, tag):
    s = eng.sched
    if s.slots or s.alloc.n_reserved or s.alloc.n_free != eng.ecfg.n_blocks:
        raise AssertionError(
            f"{tag}: block leak (slots {sorted(s.slots)}, reserved "
            f"{s.alloc.n_reserved}, free {s.alloc.n_free}/"
            f"{eng.ecfg.n_blocks})")


def _run_engine(eng, reqs, tag, need, **kw):
    """One engine run with the launch counts zeroed just before and read
    just after; every kernel in ``need`` must have launched."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    sync()
    t0 = time.monotonic()
    done = eng.run(reqs, **kw)
    sync()
    wall = time.monotonic() - t0
    counts = ops.launch_counts()
    for kname in need:
        if counts[kname] <= 0:
            raise AssertionError(f"{tag}: {kname} was never launched")
        _only_through(counts, kname, tag)
    _check_no_leak(eng, tag)
    return done, wall, counts


def engine_phase_k():
    """Phase k: the engine at f32 on slab-ell packed llama2-7b (2 layers):
    a mixed-arrival trace, then its first EVICT_REQUESTS requests on a
    pool that forces evictions; every stream token-equal to greedy_decode
    of the same packed params."""
    import numpy as np
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.serving import Engine, EngineConfig, Request
    from repro_torch.serving.paged_cache import blocks_needed
    log("phase k: engine, llama2-7b full width f32, slab cr 0.5 -> "
        "slab-ell; reduced: n_layers 32->2")
    cfg, packed = _packed_model("llama2_7b", 2, torch.float32)
    rng = np.random.default_rng(0)
    specs = [(int(rng.integers(16, 257)), int(rng.integers(8, 65)),
              float(3 * i)) for i in range(ENGINE_REQUESTS)]
    prompts = [rng.integers(0, cfg.vocab, size=p).astype(np.int32)
               for p, _, _ in specs]

    def trace(n_req):
        return [Request(rid=i, prompt=prompts[i], max_new=n, arrival=a)
                for i, (p, n, a) in enumerate(specs[:n_req])]

    max_len = 256 + 64
    big = blocks_needed(max(p + n - 1 for p, n, _ in
                            specs[:EVICT_REQUESTS]), 16)
    pools = (("mixed arrivals", 4 * blocks_needed(max_len, 16),
              ENGINE_REQUESTS),
             ("evicting pool", big + 4, EVICT_REQUESTS))
    # the oracle: one ragged greedy_decode of every prompt
    s_max = max(p for p, _, _ in specs)
    padded = np.zeros((len(specs), s_max), np.int32)
    for i, pr in enumerate(prompts):
        padded[i, :len(pr)] = pr
    lengths = [p for p, _, _ in specs]
    t0 = time.monotonic()
    want = greedy_decode(cfg, packed, padded, max(n for _, n, _ in specs),
                         lengths=lengths, device="cuda").cpu().numpy()
    log(f"  oracle greedy_decode (ragged, {len(specs)} rows): "
        f"{time.monotonic() - t0:.1f}s")
    launches = {}
    for tag, n_blocks, n_req in pools:
        eng = Engine(cfg, packed, EngineConfig(
            n_slots=4, n_blocks=n_blocks, block_size=16, max_len=max_len,
            prefill_chunk=8), device="cuda")
        done, wall, counts = _run_engine(
            eng, trace(n_req), f"phase k {tag}",
            ("slab_ell_matmul@ell.cu", "flash_decode_paged"), clock="steps")
        for r in done:
            if r.status != "finished":
                raise AssertionError(f"phase k: rid {r.rid} {r.status}")
            got = np.asarray(r.out)
            ref = want[r.rid, :r.max_new]
            if not np.array_equal(got, ref):
                at = int(np.flatnonzero(got != ref)[0])
                raise AssertionError(
                    f"phase k {tag}: rid {r.rid} differs from greedy_decode "
                    f"at token {at}: {got[at]} != {ref[at]}")
        n_tok = sum(r.n_generated for r in done)
        log(f"  {tag}: {len(done)} requests token-equal to greedy_decode, "
            f"{n_tok} tokens, {eng.n_steps} steps, "
            f"{eng.sched.n_evictions} evictions, {wall:.1f}s, pool "
            f"{n_blocks} blocks back on the free list; launches "
            + " ".join(f"{kk}={c}" for kk, c in counts.items() if c))
        if tag == "evicting pool" and eng.sched.n_evictions == 0:
            raise AssertionError("phase k: the small pool forced no eviction")
        for kk, c in counts.items():
            launches[kk] = launches.get(kk, 0) + c
    del packed
    torch.cuda.empty_cache()
    return launches


def _decode_steady(eng, n_rows, steps):
    """Admit ``n_rows`` requests (prompt 32, long outputs), prefill them,
    then time ``steps`` pure-decode engine steps by the host clock.
    Returns (ms per step, a callable that runs ``steps`` more)."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(1)
    for i in range(n_rows):
        eng.sched.submit(Request(
            rid=100 + i, prompt=rng.integers(0, eng.cfg.vocab, size=32),
            max_new=10 * steps))
    eng.sched.admit(0.0)

    def step():
        tokens, n_valid, _ = eng.sched.plan_step()
        last, ok = eng._run_step(tokens, n_valid,
                                 np.zeros(n_valid.shape, bool))
        eng.sched.commit_step(n_valid, last, 0.0)

    while any(sl.phase == "prefill" for sl in eng.sched.slots.values()):
        step()
    step()
    sync()
    t0 = time.monotonic()
    for _ in range(steps):
        step()
    sync()
    ms = (time.monotonic() - t0) / steps * 1e3

    def more():
        for _ in range(steps):
            step()
    return ms, more


def engine_phase_l():
    """Phase l: the engine at bf16 with an int8 KV cache on slab-ell packed
    llama2-7b (2 layers): the ``serve --engine`` synthetic trace under
    FaultPlan.chaos(0) on the steps clock; every request terminal, no
    leaked block; the decode step's device-busy share; paged_decode_step
    held against decode_step."""
    import argparse as ap
    import numpy as np
    from repro_torch.launch.serve import engine_trace
    from repro_torch.models import lm
    from repro_torch.models.common import positions_for
    from repro_torch.serving import (Engine, EngineConfig, FaultPlan,
                                     init_paged_cache)
    from repro_torch.serving.engine import summarize
    from repro_torch.serving.paged_cache import blocks_needed
    log("phase l: engine, llama2-7b full width bf16, int8 KV, slab cr 0.5 "
        "-> slab-ell, serve --engine trace under chaos seed 0; reduced: "
        "n_layers 32->2")
    cfg, packed = _packed_model("llama2_7b", 2, torch.bfloat16,
                                kv_quant="int8")
    args = ap.Namespace(requests=8, prompt_len=32, gen_len=16, seed=0,
                        deadline=None)
    reqs = engine_trace(cfg, args)
    max_len = args.prompt_len + args.gen_len
    ecfg = EngineConfig(n_slots=4, block_size=16,
                        n_blocks=4 * blocks_needed(max_len, 16),
                        max_len=max_len, prefill_chunk=8)
    faults = FaultPlan.chaos(0, vocab=cfg.vocab, n_rows=4)
    eng = Engine(cfg, packed, ecfg, device="cuda")
    done, wall, counts = _run_engine(
        eng, reqs, "phase l", ("slab_ell_matmul", "flash_decode_paged"),
        clock="steps", faults=faults)
    if not all(r.terminal for r in done):
        raise AssertionError("phase l: a request is not terminal")
    m = summarize(done, wall)
    step_ms = wall / eng.n_steps * 1e3
    statuses = " ".join(f"{k}={v}" for k, v in sorted(m["statuses"].items()))
    ttft, lat = m["ttft"], m["per_token_latency"]
    log(f"  {faults!r}: {m['n_requests']} requests [{statuses}], "
        f"{m['n_tokens_out']} tokens in {wall:.2f}s ({m['tokens_per_s']:.1f} "
        f"tok/s, goodput {m['goodput_tokens_per_s']:.1f} tok/s), "
        f"{eng.n_steps} steps ({step_ms:.2f} ms per step), "
        f"{m['n_evictions']} evictions; no block leaked; launches "
        + " ".join(f"{kk}={c}" for kk, c in counts.items() if c))
    log(f"  ttft p50/p95: {ttft['p50']:.1f}/{ttft['p95']:.1f} steps "
        f"({ttft['p50'] * step_ms:.1f}/{ttft['p95'] * step_ms:.1f} ms at "
        f"the mean step); per-token p50/p95: {lat['p50']:.2f}/"
        f"{lat['p95']:.2f} steps ({lat['p50'] * step_ms:.2f}/"
        f"{lat['p95'] * step_ms:.2f} ms)")
    # the device-busy share of a pure-decode step (4 rows, one token each)
    eng2 = Engine(cfg, packed, EngineConfig(
        n_slots=4, block_size=16, n_blocks=4 * blocks_needed(256, 16),
        max_len=256, prefill_chunk=8), device="cuda")
    dec_ms, more = _decode_steady(eng2, 4, 8)
    share, fd_ms = _device_profile(more, 8, dec_ms, "engine decode step",
                                   focus=("#11 flash_decode_paged", "fd::"))
    # paged_decode_step against decode_step on the same tokens
    b, s = 4, 24
    toks = torch.randint(0, cfg.vocab, (b, s), device="cuda",
                         generator=torch.Generator(device="cuda"
                                                   ).manual_seed(3))
    n_bt = blocks_needed(s, 16)
    paged = init_paged_cache(cfg, b * n_bt, 16, device="cuda")
    tables = torch.randperm(b * n_bt, device="cuda").reshape(b, n_bt).to(
        torch.int32)
    cache = lm.init_cache(cfg, b, s, device="cuda")
    active = torch.ones(b, dtype=torch.bool)
    for t in range(s):
        lens = torch.full((b,), t, dtype=torch.int32, device="cuda")
        lp, _ = lm.paged_decode_step(cfg, packed, paged, tables, lens,
                                     toks[:, t:t + 1], active)
        ld, cache = lm.decode_step(cfg, packed, cache, toks[:, t:t + 1],
                                   positions_for(cfg, b, 1, offset=t,
                                                 device="cuda"))
    lp, ld = lp[:, 0].float(), ld[:, -1].float()
    rel = float((lp - ld).abs().max() / ld.abs().max())
    log(f"  paged_decode_step vs decode_step, int8 KV, {s} tokens: "
        f"max|diff|/max|ref| = {rel:.3g} (tolerance 3e-2)")
    if not (bool(torch.isfinite(lp).all()) and rel < 3e-2):
        raise AssertionError(f"phase l: paged vs contiguous logits {rel}")
    del packed
    torch.cuda.empty_cache()
    return counts, {"tokens_per_s": m["tokens_per_s"],
                    "goodput_tokens_per_s": m["goodput_tokens_per_s"],
                    "step_ms": step_ms, "decode_step_ms": dec_ms,
                    "decode_busy_share": share,
                    "flash_decode_paged_ms_per_step": fd_ms}


MOE_REQUESTS = 8


def moe_engine_phase(tag, arch):
    """Phases q (phi3.5-moe) and x (deepseek-moe-16b): the engine at f32
    on slab-ell packed ``arch`` (1 layer, every expert through the grouped
    kernel #14, attention and any shared experts through #1): a
    mixed-arrival trace of MOE_REQUESTS requests (prompts 16-128, outputs
    8-32, 4 slots, blocks of 16), twice. At a drop-free capacity factor
    (n_experts / top_k: no token is ever dropped, so a row's output does
    not depend on the other rows of its step) every stream is token-equal
    to greedy_decode; at the published capacity factor, where the rows of
    a step compete for the experts' slots, every request ends in a
    terminal state. No block leaks in either run."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.serving import Engine, EngineConfig, Request
    from repro_torch.serving.paged_cache import blocks_needed
    full = configs.get(arch, smoke=False)
    shared = ", shared" if full.shared_ff else ""
    log(f"phase {tag}: engine, {full.name} full width f32, slab cr 0.5 -> "
        f"slab-ell (attention{shared} and all {full.n_experts} experts); "
        f"reduced: n_layers {full.n_layers}->1")
    cfg, packed, dense_c = _packed_model(arch, 1, torch.float32,
                                         keep_dense=True)
    rng = np.random.default_rng(0)
    specs = [(int(rng.integers(16, 129)), int(rng.integers(8, 33)),
              float(2 * i)) for i in range(MOE_REQUESTS)]
    prompts = [rng.integers(0, cfg.vocab, size=p).astype(np.int32)
               for p, _, _ in specs]
    max_len = 128 + 32
    free = cfg.with_(capacity_factor=cfg.n_experts / cfg.top_k)
    padded = np.zeros((len(specs), max(p for p, _, _ in specs)), np.int32)
    for i, pr in enumerate(prompts):
        padded[i, :len(pr)] = pr
    want = greedy_decode(free, packed, padded, max(n for _, n, _ in specs),
                         lengths=[p for p, _, _ in specs],
                         device="cuda").cpu().numpy()
    # at f32 the packed model is held against the whole dense-equivalent
    seq = torch.as_tensor(padded[:4, :16], device="cuda").long()
    lp, calls_p = _final_logits_routed(cfg, packed, seq)
    ld, calls_d = _final_logits_routed(cfg, dense_c, seq)
    log(f"  expert choices packed vs dense-equivalent: "
        f"{_choices_differing(calls_p, calls_d)} of "
        f"{sum(int(c.shape[0]) for c in calls_p)} tokens differ")
    _hold_logits(tag, lp, ld, 1e-4, "packed vs dense-equivalent (4 x 16 "
                 "prompt tokens)")
    del dense_c
    launches = {}
    for run, c in (("drop-free capacity", free), ("published capacity",
                                                   cfg)):
        eng = Engine(c, packed, EngineConfig(
            n_slots=4, n_blocks=4 * blocks_needed(max_len, 16),
            block_size=16, max_len=max_len, prefill_chunk=8),
            device="cuda")
        reqs = [Request(rid=i, prompt=prompts[i], max_new=n, arrival=a)
                for i, (p, n, a) in enumerate(specs)]
        done, wall, counts = _run_engine(
            eng, reqs, f"phase {tag} {run}",
            ("slab_ell_matmul@ell.cu", "slab_ell_matmul_g@ell.cu",
             "flash_decode_paged"),
            clock="steps")
        n_equal = 0
        for r in done:
            if not r.terminal:
                raise AssertionError(f"phase {tag} {run}: rid {r.rid} "
                                     f"{r.status}")
            equal = np.array_equal(np.asarray(r.out),
                                   want[r.rid, :r.max_new])
            n_equal += equal
            if c is free and (r.status != "finished" or not equal):
                raise AssertionError(
                    f"phase {tag} {run}: rid {r.rid} {r.status}, differs "
                    "from greedy_decode")
        statuses = sorted({r.status for r in done})
        log(f"  {run} (factor {c.capacity_factor:.4g}): {len(done)} requests "
            f"{statuses}, {n_equal} token-equal to greedy_decode at the "
            f"drop-free factor, {sum(r.n_generated for r in done)} tokens, "
            f"{eng.n_steps} steps, {wall:.1f}s, every block back on the "
            "free list; launches "
            + " ".join(f"{kk}={v}" for kk, v in counts.items() if v))
        for kk, v in counts.items():
            launches[kk] = launches.get(kk, 0) + v
    del packed
    torch.cuda.empty_cache()
    return launches


PLAN_Y = ("1/attn.wo=skip; attn.*=sparsegpt@cr=0.6; "
          "0/mlp.*=wanda@pattern=2:4; *=slab")
CALIB_CHUNK = 4          # phases y and z stream 16 x 128 tokens in 4 chunks


@contextlib.contextmanager
def _count_layer_forwards():
    """Count ``models.lm._layer_fwd`` calls (the calibration forwards of
    the compression pipeline) while the context is open."""
    from repro_torch.models import lm
    orig, n = lm._layer_fwd, [0]

    def counted(*a, **kw):
        n[0] += 1
        return orig(*a, **kw)

    lm._layer_fwd = counted
    try:
        yield n
    finally:
        lm._layer_fwd = orig


def _packed_variants(cfg, packed):
    """(layer, path) -> the variant pack_model gave each 2-D linear, or
    "dense" for a weight it left dense."""
    from repro_torch.core.packed_model import PackedLinear
    from repro_torch.core.pipeline import _get, linear_paths
    out = {}
    for l, lp in enumerate(packed["layers"]):
        for pth in linear_paths(cfg):
            w = _get(lp, pth)
            out[(l, pth)] = (w.variant if isinstance(w, PackedLinear)
                             else "dense")
    return out


def _cut_model(arch, n_layers, what):
    """``arch`` at full width cut to ``n_layers``, bf16, random weights
    from seed 0, and its 16 x 128 calibration tokens streamed in chunks
    of CALIB_CHUNK."""
    from repro_torch import configs
    from repro_torch.core.plan import CalibrationSpec
    from repro_torch.data import calibration_batch
    from repro_torch.models import lm
    full = configs.get(arch, smoke=False)
    cfg = full.with_(n_layers=n_layers, dtype=torch.bfloat16)
    log(f"  {full.name} d_model {cfg.d_model} heads {cfg.n_heads}x"
        f"{cfg.d_head} kv {cfg.n_kv} d_ff {cfg.d_ff} vocab {cfg.vocab} "
        f"rope theta {cfg.rope_theta:g} bf16, {what}; reduced: n_layers "
        f"{full.n_layers}->{n_layers}")
    params = lm.init(cfg, seed=0, device="cuda")
    spec = CalibrationSpec(calibration_batch(cfg.vocab, seed=0, n_seq=16,
                                             seq_len=128),
                           batch_size=CALIB_CHUNK)
    return cfg, params, spec


def plan_phase_y():
    """Phase y: llama3.2-3b at full width, 2 layers, bf16, compressed by
    ``compress_model`` under the mixed plan PLAN_Y (SparseGPT attention at
    CR 0.6 with layer 1's attn.wo left dense, Wanda 2:4 on layer 0's MLP,
    SLaB 8 iterations on layer 1's) from 16 x 128 calibration tokens
    streamed in chunks of 4, then ``pack_model(plan=...)``: one model
    serves #4 (sparse-ell), #8 (sparse-nm) and #1 (slab-ell) side by side
    with a dense linear. Every stats row's variant must be what pack_model
    packed; each of the three kernels launches through grouped_tc.cu."""
    from repro_torch.core.packed_model import pack_model
    from repro_torch.core.pipeline import compress_model
    from repro_torch.core.plan import CompressionPlan
    from repro_torch.core.slab import SLaBConfig
    log("phase y: compression plan '" + PLAN_Y + "'")
    cfg, params, spec = _cut_model("llama3_2_3b", 2,
                                   "plan base: slab iters 8")
    plan = CompressionPlan.parse(PLAN_Y, base=SLaBConfig(iters=8))
    t0 = time.monotonic()
    with _count_layer_forwards() as n_fwd:
        dense_c, rows, decs = compress_model(
            cfg, params, spec, plan=plan, keep_decompositions=True,
            device="cuda")
    sync()
    t_comp = time.monotonic() - t0
    del params
    chunks = len(spec.batches())
    log(f"  compressed {len(rows)} linears "
        f"({'/'.join(sorted({s.method for s in rows}))}) in {t_comp:.1f}s "
        f"from {chunks} calibration chunks of {CALIB_CHUNK}: n_forwards "
        f"{n_fwd[0]} (capture {cfg.n_layers * chunks} + propagation "
        f"{cfg.n_layers * chunks})")
    if n_fwd[0] != 2 * cfg.n_layers * chunks:
        raise AssertionError(f"phase y: {n_fwd[0]} layer forwards")
    packed, rep = pack_model(dense_c, decs, dtype=cfg.dtype, plan=plan)
    del decs
    got = _packed_variants(cfg, packed)
    want = {(l, pth): ("dense" if (l, pth) == (1, "attn.wo")
                       else "sparse-ell" if pth.startswith("attn.")
                       else "sparse-nm" if l == 0 else "slab-ell")
            for l, pth in got}
    for s in rows:
        log(f"    L{s.layer} {s.name:<12} {s.method:<9} cr_req "
            f"{s.cr_requested:.3f} cr {s.cr:.4f} err {s.err_before:.4g} -> "
            f"{s.err_after:.4g}  row {s.variant}, packed "
            f"{got[(s.layer, s.name)]}")
        if s.variant != got[(s.layer, s.name)]:
            raise AssertionError(
                f"phase y: L{s.layer}/{s.name} row variant {s.variant}, "
                f"packed {got[(s.layer, s.name)]}")
    if got != want:
        raise AssertionError(f"phase y: packed {got}, expected {want}")
    log(f"  packed {rep.n_packed} ["
        + " ".join(f"{v}={c}" for v, c in sorted(rep.by_variant.items()))
        + "], left dense: "
        + ", ".join(f"L{l}/{p}" for (l, p), v in got.items() if v == "dense"))
    steps = PROMPT + GEN - 1
    counts = _serve_and_hold("y", cfg, packed, dense_c, {
        "ell_matmul": 7 * steps, "nm_matmul": 3 * steps,
        "slab_ell_matmul": 3 * steps}, 3e-2)
    del packed, dense_c
    torch.cuda.empty_cache()
    return counts


def budget_phase_z():
    """Phase z: llama2-7b at full width, 2 layers, bf16: one streamed
    calibration pass (``collect_model_stats``, 16 x 128 tokens in chunks
    of 4), ``allocate_plan(budget=0.5, template="*=slab")`` from those
    statistics, ``compress_model(stats=...)`` (no further forwards),
    ``pack_model(plan=...)`` and greedy_decode. Holds n_forwards =
    n_layers x chunks, the achieved and the measured global CR within
    0.025 of 0.5, and every linear packed: slab-ell (#1), or slab-dense
    (#3) where a CR lands below ELL's byte crossover at bf16."""
    from repro_torch.core.allocator import allocate_plan, measured_global_cr
    from repro_torch.core.packed_model import pack_model
    from repro_torch.core.pipeline import collect_model_stats, compress_model
    from repro_torch.core.slab import SLaBConfig
    log("phase z: budget allocation, allocate_plan(budget=0.5, "
        "template='*=slab')")
    cfg, params, spec = _cut_model("llama2_7b", 2, "slab iters 8")
    chunks = len(spec.batches())
    t0 = time.monotonic()
    stats = collect_model_stats(cfg, params, spec, plan="*=slab",
                                device="cuda")
    sync()
    t_stats = time.monotonic() - t0
    log(f"  one calibration pass in {t_stats:.2f}s: n_forwards "
        f"{stats.n_forwards} ({cfg.n_layers} layers x {chunks} chunks)")
    if stats.n_forwards != cfg.n_layers * chunks:
        raise AssertionError(f"phase z: n_forwards {stats.n_forwards}")
    t0 = time.monotonic()
    alloc = allocate_plan(cfg, params, budget=0.5, template="*=slab",
                          stats=stats, base=SLaBConfig(iters=8),
                          device="cuda")
    t_probe = time.monotonic() - t0
    log(f"  allocated {len(alloc.crs)} CR groups in {t_probe:.2f}s (probe "
        f"and water-filling, float64 sums): achieved {alloc.achieved:.4f}")
    for ln in alloc.table().splitlines():
        log("    " + ln)
    if abs(alloc.achieved - 0.5) > 0.025:
        raise AssertionError(f"phase z: achieved {alloc.achieved}")
    t0 = time.monotonic()
    with _count_layer_forwards() as n_fwd:
        dense_c, rows, decs = compress_model(
            cfg, params, None, plan=alloc.plan, stats=alloc.stats,
            keep_decompositions=True, device="cuda")
    sync()
    t_comp = time.monotonic() - t0
    if n_fwd[0]:
        raise AssertionError(f"phase z: compress_model(stats=) ran "
                             f"{n_fwd[0]} layer forwards")
    g = measured_global_cr(dense_c, rows)
    log(f"  compressed {len(rows)} linears from the statistics in "
        f"{t_comp:.2f}s (0 layer forwards): measured global CR {g:.4f}")
    if abs(g - 0.5) > 0.025:
        raise AssertionError(f"phase z: measured global CR {g}")
    del params
    packed, rep = pack_model(dense_c, decs, dtype=cfg.dtype,
                             plan=alloc.plan)
    del decs
    got = _packed_variants(cfg, packed)
    if set(got.values()) - {"slab-ell", "slab-dense"}:
        raise AssertionError(f"phase z: packed {got}")
    for s in rows:
        log(f"    L{s.layer} {s.name:<12} cr_req {s.cr_requested:.2f} cr "
            f"{s.cr:.4f} packed {got[(s.layer, s.name)]}")
    log(f"  packed {rep.n_packed} ["
        + " ".join(f"{v}={c}" for v, c in sorted(rep.by_variant.items()))
        + "]")
    steps = PROMPT + GEN - 1
    need = {{"slab-ell": "slab_ell_matmul", "slab-dense": "slab_matmul"}[v]:
            c * steps for v, c in rep.by_variant.items()}
    counts = _serve_and_hold("z", cfg, packed, dense_c, need, 3e-2)
    del packed, dense_c
    torch.cuda.empty_cache()
    return counts


SLK_SHAPE = (4096, 4096)     # llama2-7b's q/k/v/o
SLK_M = 4


def slab_linear_kernel_check():
    """``ops.slab_linear_kernel`` (the entry point of a ``SLaBPacked``
    bundle) at SLK_SHAPE, M 4, bf16: a SLaB decomposition at CR 0.5 2:4
    packs N:M and goes through #2 slab_nm_matmul, one at CR 0.5
    unstructured packs ELL (every row keeps the same count), is unpacked
    and goes through #3 slab_matmul; each only through grouped_tc.cu
    (counts zeroed just before the call, read just after), held against
    ``apply.slab_linear`` at f32 within 3e-2."""
    from repro_torch.core.apply import slab_linear
    from repro_torch.core.packing import NMPacked, pack_decomposition
    from repro_torch.core.slab import SLaBConfig, slab_decompose
    from repro_torch.kernels import ops
    n, k = SLK_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(7)
    w = torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5
    norms = torch.rand(k, generator=gen, device="cuda") + 0.5
    x = torch.randn(SLK_M, k, generator=gen, device="cuda")
    launched = {}
    for pattern, key in (("2:4", "slab_nm_matmul"), (None, "slab_matmul")):
        dec = slab_decompose(w, norms, SLaBConfig(cr=0.5, iters=4,
                                                  pattern=pattern))
        pk = pack_decomposition(dec, pattern)
        ops.reset_launch_counts()
        sync()
        y = ops.slab_linear_kernel(x.bfloat16(), pk)
        sync()
        counts = ops.launch_counts()
        if counts[key] != 1:
            raise AssertionError(f"slab_linear_kernel ({pattern}): {key} "
                                 f"launched {counts[key]} times")
        _only_through(counts, key, f"slab_linear_kernel ({pattern})")
        launched[key] = launched.get(key, 0) + counts[key]
        want = slab_linear(x, dec)
        kind = "N:M" if isinstance(pk.sparse, NMPacked) else \
            type(pk.sparse).__name__
        log(f"  slab_linear_kernel {n}x{k} M {SLK_M} bf16, sparse part "
            f"{kind} ({pattern or 'unstructured'}): {key} x"
            f"{counts[key]}, y {tuple(y.shape)} {y.dtype}")
        _hold_logits("slab_linear_kernel", y.float(), want, 3e-2,
                     f"{key} vs apply.slab_linear (f32)")
    return launched


TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_MB = 8, 512, 10, 2
REPLAY_STEPS = 8


def _train_setup(n_layers):
    from repro_torch import configs
    from repro_torch.optim.adamw import AdamWConfig
    full = configs.get("llama2_7b", smoke=False)
    cfg = full.with_(n_layers=n_layers, dtype=torch.bfloat16)
    acfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    return full, cfg, acfg


def _tree_equal(a, b) -> bool:
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def train_phase():
    """Phase T: llama2-7b at full width, 2 layers, bf16 parameters, f32
    moments. ``make_train_fn(microbatches=2, remat="nothing")`` takes
    TRAIN_STEPS steps on one SyntheticCorpus batch (batch 8, seq 512):
    every loss finite, the last below the first; step 1 under "none",
    "dots" and "blocks:2" gives the loss of "nothing". Then
    ``launch.train`` at 1 layer, commits every 4 steps (the last 2 kept),
    a failure injected at step 6, in a temporary directory of the
    checkout removed afterwards: its final parameters and moments
    bitwise equal to an uninterrupted run's. Then the 2-layer trained
    model is SLaB-compressed (CR 0.5, 8 iterations, 16 x 128 calibration
    tokens from the corpus), packed (slab-ell) and served through
    ``_serve_and_hold``: #1 only through grouped_tc.cu, logits within
    3e-2 of the trained dense-equivalent."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import save_pytree
    from repro_torch.core.packed_model import pack_model
    from repro_torch.core.pipeline import compress_model
    from repro_torch.core.plan import plan_for_method
    from repro_torch.core.slab import SLaBConfig
    from repro_torch.data import SyntheticCorpus, calibration_batch
    from repro_torch.launch.train import train
    from repro_torch.models import lm
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.step import make_train_fn
    from repro_torch.tree import tree_map

    full, cfg, acfg = _train_setup(2)
    n_par = lm.param_count(cfg)
    log(f"phase T: {full.name} d_model {cfg.d_model} heads {cfg.n_heads}x"
        f"{cfg.d_head} d_ff {cfg.d_ff} vocab {cfg.vocab}, bf16 params "
        f"({n_par / 1e6:.1f} M), f32 moments, AdamW lr {acfg.lr} warm-up "
        f"{acfg.warmup_steps}, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
        f"microbatches {TRAIN_MB}; reduced: n_layers {full.n_layers}->2")
    corpus = SyntheticCorpus(cfg.vocab, seed=0)

    def batch(step):
        return {k: torch.from_numpy(v).cuda() for k, v in
                corpus.batch(step, TRAIN_BATCH, TRAIN_SEQ).items()}

    params0 = lm.init(cfg, seed=0, device="cuda")
    first = {}
    for remat in ("none", "dots", "blocks:2"):
        p = tree_map(torch.clone, params0)
        torch.cuda.reset_peak_memory_stats()
        _, _, m = make_train_fn(cfg, acfg, TRAIN_MB, remat)(
            p, adamw_init(p, acfg), batch(0))
        first[remat] = float(m["loss"])
        log(f"  step 1 under remat {remat!r}: loss {first[remat]:.6f}, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del p, m
    torch.cuda.empty_cache()
    step = make_train_fn(cfg, acfg, TRAIN_MB, "nothing")
    params, opt = params0, adamw_init(params0, acfg)
    del params0
    torch.cuda.reset_peak_memory_stats()
    # one batch, every step: at full width ten steps of fresh batches
    # show no falling loss (each token is seen ~1.3 times in all, too
    # few to learn the corpus's chains), fitting one batch does
    fit = batch(0)
    losses, times = [], []
    for s in range(TRAIN_STEPS - 1):
        sync()
        t0 = time.monotonic()
        params, opt, m = step(params, opt, fit)
        losses.append(float(m["loss"]))
        times.append(time.monotonic() - t0)
    peak = torch.cuda.max_memory_allocated()
    step_ms = float(np.median(times[1:])) * 1e3
    last = TRAIN_STEPS - 1

    def run_last():
        nonlocal params, opt
        params, opt, mm = step(params, opt, fit)
        losses.append(float(mm["loss"]))

    share = _device_profile(run_last, 1, step_ms, "train step",
                            unit="train step")
    YARDSTICKS["T step 1"] = losses[0]
    log(f"  losses (remat 'nothing', batch 0 every step): "
        + " ".join(f"{x:.4f}" for x in losses))
    log(f"  train step {step_ms:.2f} ms (median of steps 2-{last}), "
        f"{TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3:.0f} tokens/s, busy "
        f"share {share}, max_memory_allocated {peak / 2**30:.2f} GiB "
        f"[{CARD[0]}]")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"phase T: losses {losses}")
    for remat, v in first.items():
        if abs(v - losses[0]) > 1e-6 * abs(losses[0]):
            raise AssertionError(f"phase T: step 1 under {remat!r} "
                                 f"{v} != {losses[0]} under 'nothing'")
    t_dur = {}

    # ---- launch.train at 1 layer: injected failure, replay ----
    _, cfg1, _ = _train_setup(1)
    root = Path(__file__).resolve().parent
    tmp = tempfile.mkdtemp(prefix=".chip_smoke_ckpt_", dir=root)
    try:
        free = shutil.disk_usage(tmp).free
        per_commit = lm.param_count(cfg1) * (2 + 4 + 4)
        log(f"  replay: llama2-7b 1 layer ({lm.param_count(cfg1) / 1e6:.1f}"
            f" M params), a commit ~{per_commit / 1e9:.2f} GB; free disk "
            f"{free / 1e9:.1f} GB")
        if free < 3.5 * per_commit:
            raise AssertionError(f"phase T: {free / 1e9:.1f} GB free, "
                                 f"the replay needs ~{3.5 * per_commit / 1e9:.1f}")
        kw = dict(smoke=False, steps=REPLAY_STEPS, batch=TRAIN_BATCH,
                  seq=TRAIN_SEQ, microbatches=TRAIN_MB, remat="nothing",
                  lr=acfg.lr, log_every=REPLAY_STEPS, device="cuda")
        t0 = time.monotonic()
        clean, l_clean = train(cfg1, ckpt_dir=None, **kw)
        t_dur["uninterrupted"] = time.monotonic() - t0
        t0 = time.monotonic()
        faulty, l_faulty = train(cfg1, ckpt_dir=os.path.join(tmp, "run"),
                                 ckpt_every=4, inject_failure_at=6, **kw)
        t_dur["with failure"] = time.monotonic() - t0
        same = (_tree_equal(clean["params"], faulty["params"])
                and _tree_equal(clean["opt"], faulty["opt"]))
        log(f"  replay: {len(l_faulty)} steps run for {REPLAY_STEPS} "
            f"(restored the step-4 commit after the failure at 6), losses "
            f"{'equal' if l_faulty[6:] == l_clean[4:] else 'DIFFER'} "
            f"after the replay; final params and moments bitwise "
            f"{'equal' if same else 'DIFFERENT'}; seconds {t_dur}")
        if not same or l_faulty[6:] != l_clean[4:]:
            raise AssertionError("phase T: the replayed run differs")
        shutil.rmtree(os.path.join(tmp, "run"))
        state = {"params": faulty["params"], "opt": faulty["opt"]}
        sync()
        t0 = time.monotonic()
        save_pytree(state, os.path.join(tmp, "timed"))
        t_commit = time.monotonic() - t0
        log(f"  one commit (save_pytree, synchronous): {t_commit:.2f} s for "
            f"{per_commit / 1e9:.2f} GB ({per_commit / 1e9 / t_commit:.2f} "
            f"GB/s, host copy included) [{CARD[0]}]")
        del clean, faulty, state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- compress the trained 2-layer model, pack, serve ----
    eval_batch = next(corpus.eval_batches(1, BATCH, 129))
    with torch.no_grad():
        ppl_dense = _perplexity(cfg, params, eval_batch)
    calib = calibration_batch(cfg.vocab, seed=0, n_seq=16, seq_len=128)
    plan = plan_for_method("slab", SLaBConfig(cr=0.5, iters=8))
    t0 = time.monotonic()
    dense_c, stats, decs = compress_model(
        cfg, params, calib, plan=plan, keep_decompositions=True,
        device="cuda")
    sync()
    t_comp = time.monotonic() - t0
    del params, opt
    packed, rep = pack_model(dense_c, decs, plan=plan, dtype=cfg.dtype)
    del decs
    n_lin, _ = _check_packed(cfg, packed, rep, "slab-ell")
    with torch.no_grad():
        ppl_c = _perplexity(cfg, dense_c, eval_batch)
        ppl_p = _perplexity(cfg, packed, eval_batch)
    log(f"  compressed the trained model in {t_comp:.1f}s (measured CR "
        f"{sum(x.cr for x in stats) / len(stats):.4f}), packed "
        f"{rep.n_packed} [slab-ell={rep.by_variant['slab-ell']}]; "
        f"perplexity ({BATCH}x128 eval tokens): trained dense "
        f"{ppl_dense:.2f}, compressed dense-equivalent {ppl_c:.2f}, "
        f"packed {ppl_p:.2f} [{CARD[0]}]")
    steps = PROMPT + GEN - 1
    launched = _serve_and_hold("T", cfg, packed, dense_c,
                               {"slab_ell_matmul": n_lin * steps}, 3e-2,
                               profiled=False)
    del packed, dense_c
    torch.cuda.empty_cache()
    return launched


# ---------------------------------------------------------------- SSM / hybrid

# #1 at the new families' (N, K): mamba2-1.3b's in_z / in_x and out,
# zamba2-7b's in_z / in_x and out, and its shared block's attention,
# w_gate / w_up and w_down (K 14336: past the split gather's staged x, the
# first design).
SSM_SHAPES = (("mamba2-1.3b in_z/in_x", 4096, 2048),
              ("mamba2-1.3b out", 2048, 4096),
              ("zamba2-7b in_z/in_x", 7168, 3584),
              ("zamba2-7b out", 3584, 7168),
              ("zamba2-7b shared attn", 3584, 3584),
              ("zamba2-7b shared w_gate/w_up", 14336, 3584),
              ("zamba2-7b shared w_down", 3584, 14336))
SSM_M = (1, 4)
SCAN_LEN = 512           # the chunked forward's prompt: two SSD chunks
# bf16 noise: a random 48-layer mamba2-1.3b's bf16 logits sit ~0.05 from
# the same weights evaluated in f32 (0.039 at 24, 0.026 at zamba2-7b's 12
# layers), so 3e-2 holds packed against dense-equivalent only on the first
# HOLD_LAYERS layers; at the phase's depth the packed model is held against
# the f32 evaluation within a fixed limit of its own (ssm_phase's deep_tol,
# 0.07 for S and 0.04 for H in main(), set from the readings on an H100:
# S 0.0439 at 24 layers and 0.0585 at 48, H 0.0285)
HOLD_LAYERS = 2
# phase S's depth: all 48 layers took S 70-113 s and the whole script up
# to 1037 s of its 1200 s limit on a slow host; 24 layers took 44-52 s,
# and 12 (18-32 s) leave room for phases V and A
S_LAYERS = 12


# #1 at qwen2-vl-2b's and hubert-xlarge's linears, (N, K): the vlm's
# attention q / o, its k / v (kv 2 x 128) and its MLP; the encoder's
# attention and MLP. M 1, 4 and 37 at every shape (decode and a
# calibration-sized case) and, at the encoder's, PREFILL_M: the packed
# prefill's rows (VA_PREFILL frames of VA_FRAMES).
VA_SHAPES = (("qwen2-vl-2b wq/wo", 1536, 1536),
             ("qwen2-vl-2b wk/wv", 256, 1536),
             ("qwen2-vl-2b w_gate/w_up", 8960, 1536),
             ("qwen2-vl-2b w_down", 1536, 8960),
             ("hubert-xlarge attn", 1280, 1280),
             ("hubert-xlarge w_up", 5120, 1280),
             ("hubert-xlarge w_down", 1280, 5120))
VA_M = (1, 4, 37)
VA_PREFILL, VA_FRAMES = 4, 128
PREFILL_M = VA_PREFILL * VA_FRAMES


def ell_shape_checks(flush, shapes, seed, title):
    """#1 slab_ell_matmul through its wrapper at every (what, N, K, Ms) of
    ``shapes``, bf16 at each M of Ms and f32 at M 4, against its plain
    version; the library each call ran must be the one
    ``ell.slab_ell_kernel`` names (grouped_tc.cu's split gather at bf16
    where ``ell_split_smem`` fits an H100 block, else and at f32 ell.cu).
    At M 4 and PREFILL_M (bf16, rank 1) each library the wrapper may pick
    is checked against the plain version, then the shape is timed
    (kernel, bound, plain, one torch.matmul, each library). Returns {M:
    {(N, K): timed record}}."""
    from repro_torch.kernels import ell as ell_k
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    source = {kk.key: kk.source for kk in ops.KERNELS}
    worst, timed, n_checks, ran_by = {}, {4: {}}, 0, {}
    for what, n, k, bf16_ms in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            planes = _planes(n, k, dtype, 1, gen)
            for m in (bf16_ms if dtype == torch.bfloat16 else (4,)):
                x = torch.randn((m, k), generator=gen,
                                device="cuda").to(dtype)
                (c,) = [c for c in _cases(planes, x, 1)
                        if c.label == "slab_ell_matmul"]
                where = f"{what} N={n} K={k} M={m}"
                before = ops.launch_counts()
                got, ref = _check_case(c, x, n, dtype, 1, worst, where)
                ran = [kk for kk, v in ops.launch_counts().items()
                       if v > before[kk]]
                want = ell_k.slab_ell_kernel(dtype, m, k).key
                if ran != [want]:
                    raise AssertionError(f"#1 {where} {dtype} ran {ran}, "
                                         f"expected {want}")
                ran_by[(what, n, k, m, dtype)] = source[want]
                n_checks += 1
                if m in (4, PREFILL_M) and dtype == torch.bfloat16:
                    libs = {}
                    for key, fn in c.libs.items():
                        g2, _ = _check_case(
                            c, x, n, dtype, 1, worst,
                            f"{where} through {source[key]}", kern=fn,
                            ref=ref)
                        n_checks += 1
                        libs[key] = (fn, float(
                            (g2.float() - ref.float()).abs().max()))
                    timed.setdefault(m, {})[(n, k)] = _time_case(
                        c, x, 1, got, ref, flush, libs=libs)
            del planes
    torch.cuda.empty_cache()
    ops.reset_launch_counts()        # comparison launches do not count
    for (what, n, k, m, dtype), src in ran_by.items():
        if m in timed:
            log(f"  #1 {what} N={n} K={k} M={m} "
                f"{str(dtype).replace('torch.', '')}: {src}")
    for (n, k), r in timed.get(PREFILL_M, {}).items():
        log(f"  #1 N={n} K={k} M={PREFILL_M}: kernel {r['ms']:.4f} ms = "
            f"{r['ms'] / r['library_ms']:.2f}x torch.matmul "
            f"({r['library_ms']:.4f} ms), {r['bound_ms'] / r['ms']:.3f} of "
            f"its {r['bound_by']} bound [{CARD[0]}]")
    log(f"#1 at {title}: {n_checks} cases passed; worst "
        f"max|err|/max|ref| {worst['slab_ell_matmul']:.3g} [{CARD[0]}]")
    return timed


def ssm_shape_checks(flush):
    """#1 at every SSM_SHAPES (N, K) (``ell_shape_checks``): bf16 at M 1
    and 4, timed at M 4. Returns {(N, K): timed record}."""
    return ell_shape_checks(flush, [(what, n, k, SSM_M)
                                    for what, n, k in SSM_SHAPES], 7,
                            "the SSM / hybrid shapes")[4]


def _cache_bytes(cfg, s_max):
    """(one layer's Mamba cache, one shared-block invocation's KV cache)
    bytes of ``lm.init_cache`` at batch BATCH and ``s_max``, counted on
    the meta device (nothing is allocated)."""
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if torch.is_tensor(t))

    c = lm.init_cache(cfg, BATCH, s_max, device="meta")
    return nbytes(c.mamba[0]), (nbytes(c.shared_kv[0]) if c.shared_kv
                                else 0)


def _check_ssm_packed(tag, cfg, packed, dense_c, rep):
    """Every ``mamba.*`` linear of every layer packed slab-ell and, on the
    hybrid, the shared block's seven linears packed once into
    ``packed["shared_attn"]`` (the dense-equivalent's stay dense).
    Returns the number of linears packed."""
    from repro_torch.core.packed_model import PackedLinear
    from repro_torch.core.pipeline import _get, linear_paths
    from repro_torch.core.pipeline import shared_linear_paths
    n_lin = 0
    for l, lp in enumerate(packed["layers"]):
        for pth in linear_paths(cfg):
            w = _get(lp, pth)
            if not (isinstance(w, PackedLinear) and w.variant == "slab-ell"):
                raise AssertionError(f"phase {tag}: L{l}/{pth} packed as "
                                     f"{getattr(w, 'variant', 'dense')}")
            n_lin += 1
    shared = shared_linear_paths(cfg)
    for pth in shared:
        sub = pth.split(".", 1)[1]
        w = _get(packed["shared_attn"], sub)
        if not (isinstance(w, PackedLinear) and w.variant == "slab-ell"
                and not isinstance(_get(dense_c["shared_attn"], sub),
                                   PackedLinear)):
            raise AssertionError(f"phase {tag}: {pth} packed as "
                                 f"{getattr(w, 'variant', 'dense')}")
        n_lin += 1
    if (rep.by_variant != {"slab-ell": n_lin} or rep.fallback
            or rep.paths[len(rep.paths) - len(shared):] != sorted(shared)):
        raise AssertionError(f"phase {tag}: pack report {rep.by_variant}, "
                             f"fallback {rep.fallback}, paths {rep.paths}")
    return n_lin


def _shared_calls(cfg, packed):
    """Calls of each shared-block PackedLinear (by identity) over one
    decode step: the block is packed once, so every invocation must run
    the same objects."""
    from repro_torch.core import packed_model
    from repro_torch.core.pipeline import _get, shared_linear_paths
    from repro_torch.models import lm
    from repro_torch.models.common import positions_for
    ids = {id(_get(packed["shared_attn"], p.split(".", 1)[1])): p
           for p in shared_linear_paths(cfg)}
    calls = dict.fromkeys(ids.values(), 0)
    orig = packed_model.packed_matmul

    def spy(x, w):
        if id(w) in ids:
            calls[ids[id(w)]] += 1
        return orig(x, w)

    packed_model.packed_matmul = spy
    try:
        cache = lm.init_cache(cfg, BATCH, 1, device="cuda")
        tok = torch.zeros((BATCH, 1), dtype=torch.long, device="cuda")
        lm.decode_step(cfg, packed, cache, tok,
                       positions_for(cfg, BATCH, 1, device="cuda"))
        sync()
    finally:
        packed_model.packed_matmul = orig
    return calls


def _first_layers(cfg, params, n_layers, f32=False):
    """The model cut to its first ``n_layers`` layers (the same weights),
    with every floating tensor upcast to f32 where ``f32`` (a dense
    model: packed planes are not upcast)."""
    from repro_torch.tree import tree_map
    cfg = cfg.with_(n_layers=n_layers)
    params = dict(params, layers=params["layers"][:n_layers])
    if f32:
        cfg = cfg.with_(dtype=torch.float32)
        params = tree_map(lambda t: t.float() if torch.is_tensor(t)
                          and t.is_floating_point() else t, params)
    return cfg, params


def _scan_vs_recurrence(tag, cfg, params, tol, n_layers, f32=False):
    """The chunked SSD forward's last-position logits (SCAN_LEN tokens,
    SCAN_LEN / ssm_chunk chunks) against the recurrent decode's after the
    same prompt (one decode_step a token), held within ``tol``, on the
    model's first ``n_layers`` layers (upcast to f32 with ``f32``)."""
    from repro_torch.data import SyntheticCorpus
    from repro_torch.models import lm
    cfg, params = _first_layers(cfg, params, n_layers, f32)
    seq = torch.as_tensor(SyntheticCorpus(cfg.vocab, seed=1).batch(
        0, 1, SCAN_LEN)["inputs"], device="cuda").long()
    t0 = time.monotonic()
    with torch.no_grad():
        fwd = lm.forward(cfg, params, seq)[0][:, -1].float()
    rec = _final_logits(cfg, params, seq)
    sync()
    _hold_logits(tag, fwd, rec, tol,
                 f"chunked forward ({SCAN_LEN // cfg.ssm_chunk} chunks of "
                 f"{cfg.ssm_chunk}) vs {SCAN_LEN} recurrent decode steps, "
                 f"{n_layers} layers, "
                 f"{str(cfg.dtype).replace('torch.', '')}, "
                 f"{time.monotonic() - t0:.1f}s")


def _hold_to_f32(tag, cfg, packed, dense_c, tol, deep_tol):
    """The logits hold of phases S and H at bf16 (``_serve_and_hold``'s
    ``hold``): on the first HOLD_LAYERS layers the packed model within
    ``tol`` of the dense-equivalent; at the phase's depth the packed model
    within ``deep_tol`` of the dense-equivalent evaluated in f32. The
    packed-vs-dense-equivalent distance at that depth and the bf16
    dense-equivalent's own distance from the f32 evaluation are logged."""
    def hold(seq, gen, dense_gen):
        c, p = _first_layers(cfg, packed, HOLD_LAYERS)
        _, d = _first_layers(cfg, dense_c, HOLD_LAYERS)
        _hold_logits(tag, _final_logits(c, p, seq), _final_logits(c, d, seq),
                     tol, f"packed vs dense-equivalent, first "
                     f"{HOLD_LAYERS} layers")
        lp = _final_logits(cfg, packed, seq)
        ld = _final_logits(cfg, dense_c, seq)
        c32, d32 = _first_layers(cfg, dense_c, cfg.n_layers, f32=True)
        l32 = _final_logits(c32, d32, seq)
        del d32
        torch.cuda.empty_cache()
        rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
        floor = rel(ld, l32)
        log(f"  all {cfg.n_layers} layers: packed vs dense-equivalent "
            f"{rel(lp, ld):.4g} (not held); against the dense-equivalent "
            f"in f32: bf16 dense-equivalent {floor:.4g}, packed "
            f"{rel(lp, l32):.4g} [{CARD[0]}]")
        _hold_logits(tag, lp, l32, deep_tol,
                     f"packed vs f32 dense-equivalent, all {cfg.n_layers} "
                     "layers")
    return hold


def _hold_tokens(tag, cfg, packed, dense_c, tol):
    """The hold of phase S's f32 pass: the packed model's greedy tokens
    equal to the dense-equivalent's and its last-position logits within
    ``tol`` of them."""
    def hold(seq, gen, dense_gen):
        same = int((gen == dense_gen).sum())
        log(f"  greedy tokens equal to the dense-equivalent's: {same} of "
            f"{gen.numel()}")
        if not torch.equal(gen, dense_gen):
            raise AssertionError(f"phase {tag}: greedy tokens differ")
        _hold_logits(tag, _final_logits(cfg, packed, seq),
                     _final_logits(cfg, dense_c, seq), tol,
                     "packed vs dense-equivalent")
    return hold


def ssm_phase(tag, arch, n_layers, plan_spec, dtype=torch.bfloat16,
              deep_tol=None, scan_layers=6, iters=8):
    """Phase S (mamba2-1.3b) / H (zamba2-7b): the model at full width cut
    to ``n_layers``, ``dtype``, random weights from seed 0, compressed
    under ``plan_spec`` (slab at CR 0.5, ``iters`` iterations, 16 x 128
    calibration tokens), packed (slab-ell everywhere: the Mamba blocks'
    in_z / in_x / out and, on the hybrid, the shared block once) and
    served by greedy_decode through ``_serve_and_hold`` (square and
    ragged, launches exact: #1 on grouped_tc.cu at bf16 where its x fits
    a block, ell.cu for K 14336 and at f32). At bf16 the busy and wall ms
    a step against the dense-equivalent, and ``_hold_to_f32``'s logits
    hold (``deep_tol`` at the phase's depth); at f32 (phase S's f32 pass)
    greedy tokens equal to the dense-equivalent's and logits within 1e-4.
    Then the shared block's calls per decode step; the chunked forward
    against the recurrent decode: the packed model's first HOLD_LAYERS
    layers (3e-2 at bf16, 1e-4 at f32) and the dense-equivalent's first
    ``scan_layers`` at f32 within 1e-4; and the decode cache's bytes at
    two ``s_max``."""
    from repro_torch import configs
    from repro_torch.core.packed_model import pack_model
    from repro_torch.core.pipeline import compress_model
    from repro_torch.core.plan import CompressionPlan
    from repro_torch.core.slab import SLaBConfig
    from repro_torch.data import calibration_batch
    from repro_torch.kernels import ell as ell_k
    from repro_torch.models import lm
    f32 = dtype == torch.float32
    tol = 1e-4 if f32 else 3e-2
    full = configs.get(arch, smoke=False)
    cfg = full.with_(n_layers=n_layers, dtype=dtype)
    n_par = lm.param_count(cfg)
    shared_s = (f"; shared block {cfg.n_heads}x{cfg.d_head} heads d_ff "
                f"{cfg.d_ff} before layers "
                + ",".join(str(l) for l in range(n_layers)
                           if lm.shared_fires(cfg, l))
                if cfg.family == "hybrid" else "")
    log(f"phase {tag}: {full.name} d_model {cfg.d_model} d_inner "
        f"{cfg.d_inner} {cfg.ssm_heads} SSD heads of {cfg.ssm_headdim} "
        f"state {cfg.ssm_state} chunk {cfg.ssm_chunk} vocab {cfg.vocab}"
        f"{shared_s}; {str(dtype).replace('torch.', '')}, plan "
        f"'{plan_spec}' (slab iters={iters} cr 0.5); {n_par / 1e9:.3f} G "
        f"parameters ({n_par * torch.finfo(dtype).bits / 8e9:.2f} GB); "
        + (f"reduced: n_layers {full.n_layers}->{n_layers}"
           if n_layers < full.n_layers else f"all {n_layers} layers")
        + f" [{CARD[0]}]")
    params = lm.init(cfg, seed=0, device="cuda")
    calib = calibration_batch(cfg.vocab, seed=0, n_seq=16, seq_len=128)
    plan = CompressionPlan.parse(plan_spec,
                                 base=SLaBConfig(cr=0.5, iters=iters))
    t0 = time.monotonic()
    dense_c, stats, decs = compress_model(
        cfg, params, calib, plan=plan, keep_decompositions=True,
        device="cuda")
    sync()
    t_comp = time.monotonic() - t0
    del params
    packed, rep = pack_model(dense_c, decs, plan=plan, dtype=cfg.dtype)
    del decs
    n_lin = _check_ssm_packed(tag, cfg, packed, dense_c, rep)
    log(f"  compressed {len(stats)} linears in {t_comp:.1f}s (measured CR "
        f"{sum(s.cr for s in stats) / len(stats):.4f}, worst weighted "
        f"err_after/err_before "
        f"{max(s.err_after / s.err_before for s in stats):.4f}); packed "
        f"{rep.n_packed} [slab-ell={rep.by_variant['slab-ell']}] across "
        f"{len(rep.paths)} paths, {len(rep.segments)} segment(s)")
    for var, (pb, db) in sorted(rep.bytes_by_variant.items()):
        log(f"  bytes/{var}: {pb / 1e6:.3f} MB packed vs {db / 1e6:.3f} MB "
            f"dense per linear ({pb / db:.4f}x)")
    # launches a decode step, by library (M = BATCH rows a call)
    per_step: dict = {}
    for pth, k in ([(p, cfg.d_model if p != "mamba.out" else cfg.d_inner)
                    for p in ("mamba.in_z", "mamba.in_x", "mamba.out")]
                   * n_layers):
        key = ell_k.slab_ell_kernel(cfg.dtype, BATCH, k).key
        per_step[key] = per_step.get(key, 0) + 1
    n_inv = lm.n_shared_invocations(cfg)
    for pth in (["attn.w" + x for x in "qkvo"] + ["mlp.w_gate", "mlp.w_up",
                                                  "mlp.w_down"]
                if n_inv else []):
        k = cfg.d_ff if pth == "mlp.w_down" else cfg.d_model
        key = ell_k.slab_ell_kernel(cfg.dtype, BATCH, k).key
        per_step[key] = per_step.get(key, 0) + n_inv
    if sum(per_step.values()) != 3 * n_layers + 7 * n_inv:
        raise AssertionError(f"phase {tag}: {per_step} for {n_lin} linears")
    log("  #1 launches a decode step: " + " ".join(
        f"{kk}={c}" for kk, c in per_step.items()))
    if n_inv:
        calls = _shared_calls(cfg, packed)
        log(f"  shared block: {len(calls)} PackedLinears, packed once, "
            f"called {sorted(set(calls.values()))} times a decode step "
            f"({n_inv} invocations)")
        if set(calls.values()) != {n_inv}:
            raise AssertionError(f"phase {tag}: shared calls {calls}")
    steps = PROMPT + GEN - 1
    need = {kk: c * steps for kk, c in per_step.items()}
    focus = tuple((f"#1 slab_ell_matmul ({src})", part) for src, part in (
        ("grouped_tc.cu", "ell_split_kernel<unsigned short, false, true"),
        ("ell.cu", "slab_ell_kernel<")))
    hold = (_hold_tokens(tag, cfg, packed, dense_c, tol) if f32 else
            _hold_to_f32(tag, cfg, packed, dense_c, tol, deep_tol))
    launched = _serve_and_hold(tag, cfg, packed, dense_c, need, tol,
                               profiled=not f32, focus=focus, hold=hold)
    for kk, c in need.items():
        if launched[kk] != 2 * c:
            raise AssertionError(f"phase {tag}: {kk} launched "
                                 f"{launched[kk]}, expected {2 * c}")
    _scan_vs_recurrence(tag, cfg, packed, tol, min(HOLD_LAYERS, n_layers))
    _scan_vs_recurrence(tag, cfg, dense_c, 1e-4, min(scan_layers, n_layers),
                        f32=True)
    by_s = {s_max: _cache_bytes(cfg, s_max) for s_max in (128, 524288)}
    log("  decode cache at batch " + str(BATCH) + ": " + ", ".join(
        f"s_max {s_max}: {m / 1e6:.3f} MB a layer"
        + (f" + {kv / 1e6:.3f} MB KV an invocation" if n_inv else "")
        for s_max, (m, kv) in by_s.items()))
    if by_s[128][0] != by_s[524288][0] or by_s[128][0] == 0:
        raise AssertionError(f"phase {tag}: Mamba cache bytes {by_s}")
    del packed, dense_c
    torch.cuda.empty_cache()
    return launched


# ------------------------------------- the vlm and audio families (V, A)

# phase V's embeds prefill: 8 text embeddings (t = h = w = index), then a
# patch grid of 4 frames x 4 rows x 2 columns whose (t, h, w) ids start
# after the text, as Qwen2-VL numbers them
V_TEXT, V_GRID = 8, (4, 4, 2)
# phase V's engine trace: prompts 16-128, outputs 8-32, 4 slots
V_REQUESTS = 6
# phase V's profiles: 2 prompt tokens and 4 new ones (5 decode steps); the
# profiler took ~30 s over PROF_PROMPT's 11 steps of the 28-layer model
V_PROF_PROMPT = 2
# the full-depth holds against the dense-equivalent's f32 evaluation (the
# bf16 noise of a random model at depth: see HOLD_LAYERS), set from two
# runs on an H100 that read the same: V's bf16 dense-equivalent 0.01345
# (decode) and 0.01652 (embeds prefill) from its f32 evaluation, the
# packed model 0.0179 and 0.0193; A's 0.01371, packed 0.0161. Each limit
# is at most 1.5x its phase's largest floor.
V_DEEP_TOL = 0.0245
A_DEEP_TOL = 0.02
# phases V's and A's depth: all 28 and 48 layers took V 83-104 s and A
# 20-32 s, and with phase F the whole script 1140.8 s of its 1200 s on a
# slow host (measured on one H100); the holds at depth only loosen with
# fewer layers (the bf16 noise grows with depth)
V_LAYERS, A_LAYERS = 8, 16


def va_shape_checks(flush):
    """#1 at every VA_SHAPES (N, K) (``ell_shape_checks``): bf16 at M 1, 4
    and 37, and at hubert-xlarge's also at PREFILL_M, then timed there.
    Returns ({(N, K): M 4 record}, {(N, K): PREFILL_M record})."""
    timed = ell_shape_checks(
        flush, [(what, n, k, VA_M + ((PREFILL_M,) if what.startswith(
            "hubert") else ())) for what, n, k in VA_SHAPES], 9,
        "the vlm / audio shapes")
    return timed[4], timed[PREFILL_M]


def _va_front(tag, arch, n_layers, dtype, iters=8):
    """Phase V's / A's compression and packing, which launch no kernel:
    ``arch`` at full width cut to ``n_layers`` at ``dtype``, random
    weights from seed 0, ``*=slab`` (CR 0.5, ``iters`` iterations) on 16 x
    128 calibration tokens (the vlm) or 16 x 128 frame embeddings from
    ``np.random.default_rng(0)`` (the encoder), then pack_model at the
    model dtype. Every linear of every layer must pack slab-ell, or
    slab-dense where ``packing.ell_wins_bytes`` says ELL loses on bytes;
    the ``embed`` and ``lm_head`` leaves never pack. Returns (cfg, the
    full config, dense-equivalent params, packed params, the variant of
    each (layer, path), the lines to log)."""
    from repro_torch import configs
    from repro_torch.data import calibration_batch
    from repro_torch.core.packed_model import PackedLinear, pack_model
    from repro_torch.core.packing import ell_wins_bytes
    from repro_torch.core.pipeline import _get, compress_model, linear_paths
    from repro_torch.core.plan import CompressionPlan
    from repro_torch.core.slab import SLaBConfig
    from repro_torch.models import lm
    full = configs.get(arch, smoke=False)
    cfg = full.with_(n_layers=n_layers, dtype=dtype)
    calib = (np.random.default_rng(0).standard_normal(
        (16, 128, cfg.d_model), dtype=np.float32)
        if cfg.input_mode == "embeds" and cfg.family == "audio" else
        calibration_batch(cfg.vocab, seed=0, n_seq=16, seq_len=128))
    params = lm.init(cfg, seed=0, device="cuda")
    plan = CompressionPlan.parse("*=slab", base=SLaBConfig(cr=0.5,
                                                           iters=iters))
    t0 = time.monotonic()
    dense_c, stats, decs = compress_model(
        cfg, params, calib, plan=plan, keep_decompositions=True,
        device="cuda")
    sync()
    t_comp = time.monotonic() - t0
    del params
    packed, rep = pack_model(dense_c, decs, plan=plan, dtype=cfg.dtype)
    del decs
    variants = {}
    itemsize = torch.finfo(cfg.dtype).bits // 8
    for l, lp in enumerate(packed["layers"]):
        for pth in linear_paths(cfg):
            w = _get(lp, pth)
            var = getattr(w, "variant", "dense")
            want = ("slab-ell" if isinstance(w, PackedLinear) and
                    ell_wins_bytes(w.sparse_vals.shape[1], w.d_in, itemsize)
                    else "slab-dense")
            if not isinstance(w, PackedLinear) or var != want:
                raise AssertionError(f"phase {tag}: L{l}/{pth} packed as "
                                     f"{var}, expected {want}")
            variants[(l, pth)] = var
    by = {}
    for var in variants.values():
        by[var] = by.get(var, 0) + 1
    if rep.by_variant != by or rep.fallback or any(
            isinstance(packed.get(k), PackedLinear)
            or packed.get(k) is not dense_c.get(k)
            for k in ("embed", "lm_head")):
        raise AssertionError(f"phase {tag}: pack report {rep.by_variant} vs "
                             f"{by}, fallback {rep.fallback}")
    lines = [
        f"  compressed {len(stats)} linears in {t_comp:.1f}s (measured CR "
        f"{sum(s.cr for s in stats) / len(stats):.4f}, worst weighted "
        f"err_after/err_before "
        f"{max(s.err_after / s.err_before for s in stats):.4f}); packed "
        f"{rep.n_packed} [" + " ".join(f"{v}={c}" for v, c in
                                        sorted(by.items()))
        + f"] across {len(rep.paths)} paths; "
        + ", ".join(f"{k} {tuple(packed[k].shape)} left as it is"
                    for k in ("embed", "lm_head") if k in packed)]
    lines += [f"  bytes/{var}: {pb / 1e6:.3f} MB packed vs {db / 1e6:.3f} "
              f"MB dense per linear ({pb / db:.4f}x)"
              for var, (pb, db) in sorted(rep.bytes_by_variant.items())]
    return cfg, full, dense_c, packed, variants, lines


def _va_header(tag, cfg, full, front, what):
    """Phase V's / A's first lines: the model, its size and its cut, then
    the compression's lines (``front``'s)."""
    from repro_torch.models import lm
    n_par = lm.param_count(cfg)
    log(f"phase {tag}: {full.name} {what}; "
        f"{str(cfg.dtype).replace('torch.', '')}, plan '*=slab' (slab "
        f"iters=8 cr 0.5); {n_par / 1e9:.3f} G parameters "
        f"({n_par * torch.finfo(cfg.dtype).bits / 8e9:.2f} GB); "
        + (f"reduced: n_layers {full.n_layers}->{cfg.n_layers}"
           if cfg.n_layers < full.n_layers else f"all {cfg.n_layers} layers")
        + f" [{CARD[0]}]")
    for line in front[-1]:
        log(line)


def _launch_keys(cfg, packed, variants, m):
    """{counter key: launches} of one pass over every packed linear at
    ``m`` rows: #1 (slab-ell) or #3 (slab-dense), the library each
    wrapper picks there."""
    from repro_torch.core.pipeline import _get
    from repro_torch.kernels import ell as ell_k
    from repro_torch.kernels import slab_matmul as slab_k
    keys = {}
    for (l, pth), var in variants.items():
        w = _get(packed["layers"][l], pth)
        key = (ell_k.slab_ell_kernel(cfg.dtype, m, w.d_in).key
               if var == "slab-ell" else
               slab_k.slab_dense_kernel(cfg.dtype, m).key)
        keys[key] = keys.get(key, 0) + 1
    return keys


def _va_focus(variants):
    """The profile's focus: #1's split gather, and #3 where a linear packed
    slab-dense."""
    focus = (("#1 slab_ell_matmul (grouped_tc.cu)",
              "ell_split_kernel<unsigned short, false, true"),)
    if "slab-dense" in variants.values():
        focus += (("#3 slab_matmul (grouped_tc.cu)",
                   "tc_bin_kernel<tc::DenseSrc"),)
    return focus


def _counted(run, need, tag, what):
    """``run()`` with the launch counts zeroed just before and read just
    after; every kernel of ``need`` must launch exactly its count, only
    through the libraries ``need`` names. Returns (run's result, the
    counts of ``need``'s kernels, wall seconds)."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    sync()
    t0 = time.monotonic()
    out = run()
    sync()
    dt = time.monotonic() - t0
    counts = ops.launch_counts()
    for kname, c in need.items():
        if counts[kname] != c:
            raise AssertionError(f"phase {tag} {what}: {kname} launched "
                                 f"{counts[kname]}, expected {c}")
        _only_through(counts, kname, f"phase {tag} {what}", allowed=need)
    return out, {kk: counts[kk] for kk in need}, dt


def _merge(total, counts):
    for kk, c in counts.items():
        total[kk] = total.get(kk, 0) + c
    return total


def _prefill_logits(cfg, params, x, positions=None):
    from repro_torch.models import lm
    return lm.prefill(cfg, params, x, positions).float()


def _hold_prefill(tag, cfg, packed, dense_c, x, positions, tol, deep_tol,
                  what):
    """A prefill's logits (every position): at f32 (``deep_tol`` None) the
    packed model within ``tol`` of the dense-equivalent; at bf16 within
    ``tol`` on the first HOLD_LAYERS layers and, at the phase's depth,
    within ``deep_tol`` of the dense-equivalent evaluated in f32 (the
    packed-vs-dense-equivalent distance there and the bf16
    dense-equivalent's own distance from the f32 evaluation logged)."""
    lp = _prefill_logits(cfg, packed, x, positions)
    if deep_tol is None:
        _hold_logits(tag, lp, _prefill_logits(cfg, dense_c, x, positions),
                     tol, f"{what}: packed vs dense-equivalent")
        return
    c, p = _first_layers(cfg, packed, HOLD_LAYERS)
    _, d = _first_layers(cfg, dense_c, HOLD_LAYERS)
    _hold_logits(tag, _prefill_logits(c, p, x, positions),
                 _prefill_logits(c, d, x, positions), tol,
                 f"{what}: packed vs dense-equivalent, first {HOLD_LAYERS} "
                 "layers")
    ld = _prefill_logits(cfg, dense_c, x, positions)
    c32, d32 = _first_layers(cfg, dense_c, cfg.n_layers, f32=True)
    l32 = _prefill_logits(c32, d32, x.float(), positions)
    del d32
    torch.cuda.empty_cache()
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    log(f"  {what}, all {cfg.n_layers} layers: packed vs dense-equivalent "
        f"{rel(lp, ld):.4g} (not held); against the dense-equivalent in "
        f"f32: bf16 dense-equivalent {rel(ld, l32):.4g}, packed "
        f"{rel(lp, l32):.4g} [{CARD[0]}]")
    _hold_logits(tag, lp, l32, deep_tol,
                 f"{what}: packed vs f32 dense-equivalent, all "
                 f"{cfg.n_layers} layers")


def _vlm_grid(cfg, packed, prompts):
    """Phase V's embeds prefill input: each row's first V_TEXT prompt
    tokens embedded through the tied table, then a patch grid of V_GRID
    (t, h, w) whose embeddings are seeded normals at the table's scale;
    returns (embeds (B, S, D), grid ids (B, S, 3), text-stream ids)."""
    from repro_torch.models.common import positions_for
    b = prompts.shape[0]
    ft, fh, fw = V_GRID
    ids = [(i, i, i) for i in range(V_TEXT)]
    ids += [(V_TEXT + t, V_TEXT + h, V_TEXT + w) for t in range(ft)
            for h in range(fh) for w in range(fw)]
    pos = torch.tensor(ids, dtype=torch.int32, device="cuda")[None].expand(
        b, len(ids), 3)
    gen = torch.Generator(device="cuda").manual_seed(4)
    patches = torch.randn((b, ft * fh * fw, cfg.d_model), generator=gen,
                          device="cuda") * 0.02
    text = packed["embed"][prompts[:, :V_TEXT]]
    x = torch.cat([text.to(cfg.dtype), patches.to(cfg.dtype)], dim=1)
    return x, pos, positions_for(cfg, b, len(ids), device="cuda")


def _engine_trace(cfg, seed=0):
    """V_REQUESTS requests: prompts 16-128 tokens, outputs 8-32, arriving
    every 2 steps, from ``np.random.default_rng(seed)``."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    specs = [(int(rng.integers(16, 129)), int(rng.integers(8, 33)),
              float(2 * i)) for i in range(V_REQUESTS)]
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=p)
                    .astype(np.int32), max_new=n, arrival=a)
            for i, (p, n, a) in enumerate(specs)]


def _vlm_engine(tag, cfg, packed, need_step, oracle):
    """The engine over _engine_trace on ``packed`` (4 slots, blocks of 16,
    a pool that holds every stream): every request finished, no block
    leaked, #11 at the model's G; with ``oracle`` every stream
    token-equal to a ragged greedy_decode of the same prompts. Returns
    the run's launches."""
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.serving.paged_cache import blocks_needed
    reqs = _engine_trace(cfg)
    max_len = 128 + 32
    eng = Engine(cfg, packed, EngineConfig(
        n_slots=4, n_blocks=4 * blocks_needed(max_len, 16), block_size=16,
        max_len=max_len, prefill_chunk=8), device="cuda")
    done, wall, counts = _run_engine(
        eng, reqs, f"phase {tag} engine",
        tuple(need_step) + ("flash_decode_paged",), clock="steps")
    if any(r.status != "finished" for r in done):
        raise AssertionError(f"phase {tag}: engine statuses "
                             f"{[r.status for r in done]}")
    n_tok = sum(r.n_generated for r in done)
    log(f"  engine: {len(done)} requests [finished={len(done)}] (prompts "
        f"{min(len(r.prompt) for r in done)}-"
        f"{max(len(r.prompt) for r in done)}, outputs "
        f"{min(r.max_new for r in done)}-{max(r.max_new for r in done)}), "
        f"{n_tok} tokens in {eng.n_steps} steps, {wall:.2f}s "
        f"({n_tok / wall:.1f} tok/s), {eng.sched.n_evictions} evictions, no "
        f"block leaked; #11 flash_decode_paged at G "
        f"{cfg.n_heads // cfg.n_kv} (KV {cfg.n_kv}, dh {cfg.d_head}); "
        "launches " + " ".join(f"{kk}={c}" for kk, c in counts.items() if c))
    if oracle:
        s_max = max(len(r.prompt) for r in done)
        padded = np.zeros((len(done), s_max), np.int32)
        for r in done:
            padded[r.rid, :len(r.prompt)] = r.prompt
        want = greedy_decode(cfg, packed, padded,
                             max(r.max_new for r in done),
                             lengths=[len(r.prompt) for r in done],
                             device="cuda").cpu().numpy()
        for r in done:
            if not np.array_equal(np.asarray(r.out), want[r.rid, :r.max_new]):
                raise AssertionError(f"phase {tag}: engine rid {r.rid} "
                                     "differs from greedy_decode")
        log(f"  engine streams token-equal to greedy_decode: {len(done)} of "
            f"{len(done)}")
    return {kk: c for kk, c in counts.items() if c}


def vlm_phase(tag, n_layers, dtype=torch.bfloat16, deep_tol=None):
    """Phase V (qwen2-vl-2b at full width, ``n_layers``, bf16) / V f32 (2
    layers): random weights from seed 0, ``*=slab`` at CR 0.5 (8
    iterations) on 16 x 128 calibration tokens (their positions (B, S, 3)
    with t = h = w), packed (every linear through #1, or #3 where ELL
    loses on bytes; the tied embedding as it is) and served by
    greedy_decode through ``_serve_and_hold`` (square and ragged,
    launches exact, profiled at bf16; at bf16 ``_hold_to_f32``'s logits
    hold at ``deep_tol``, at f32 greedy tokens equal to the
    dense-equivalent's and logits within 1e-4). Then an embeds prefill
    (_vlm_grid, launches counted) held as ``_hold_prefill`` says, whose
    logits must move when the grid's ids become text ids; then the engine
    (_vlm_engine; at f32 token-equal to greedy_decode). Returns the
    main-path runs' launches."""
    from repro_torch.data import SyntheticCorpus
    f32 = dtype == torch.float32
    tol = 1e-4 if f32 else 3e-2
    front = _va_front(tag, "qwen2_vl_2b", n_layers, dtype)
    cfg, full, dense_c, packed, variants = front[:5]
    _va_header(tag, cfg, full, front, f"d_model {cfg.d_model} heads "
               f"{cfg.n_heads}x{cfg.d_head} kv {cfg.n_kv} d_ff {cfg.d_ff} "
               f"vocab {cfg.vocab} M-RoPE sections {cfg.mrope_sections} "
               "tied embeddings")
    del front
    per_step = _launch_keys(cfg, packed, variants, BATCH)
    log("  launches a decode step: " + " ".join(
        f"{kk}={c}" for kk, c in per_step.items()))
    steps = PROMPT + GEN - 1
    need = {kk: c * steps for kk, c in per_step.items()}
    focus = _va_focus(variants)
    hold = (_hold_tokens(tag, cfg, packed, dense_c, tol) if f32 else
            _hold_to_f32(tag, cfg, packed, dense_c, tol, deep_tol))
    launched = _serve_and_hold(tag, cfg, packed, dense_c, need, tol,
                               profiled=not f32, focus=focus, hold=hold,
                               prof_prompt=V_PROF_PROMPT)
    for kk, c in need.items():
        if launched[kk] != 2 * c:
            raise AssertionError(f"phase {tag}: {kk} launched "
                                 f"{launched[kk]}, expected {2 * c}")
    # the embeds prefill on a (t, h, w) patch grid
    prompts = torch.as_tensor(SyntheticCorpus(cfg.vocab, seed=0).batch(
        0, BATCH, PROMPT)["inputs"], device="cuda").long()
    x, grid, text_ids = _vlm_grid(cfg, packed, prompts)
    m = x.shape[0] * x.shape[1]
    _prefill_logits(cfg, packed, x, grid)        # warm-up
    logits, counts, dt = _counted(
        lambda: _prefill_logits(cfg, packed, x, grid),
        _launch_keys(cfg, packed, variants, m), tag, "embeds prefill")
    _merge(launched, counts)
    ft, fh, fw = V_GRID
    log(f"  embeds prefill: {BATCH} rows x ({V_TEXT} text + {ft}x{fh}x{fw} "
        f"(t, h, w) patches) = {x.shape[1]} positions, M {m} a linear, "
        f"{dt * 1e3:.2f} ms wall; logits {tuple(logits.shape)}; launches "
        + " ".join(f"{kk}={c}" for kk, c in counts.items()))
    if tuple(logits.shape) != (BATCH, x.shape[1], cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"phase {tag}: embeds prefill logits "
                             f"{tuple(logits.shape)}")
    as_text = _prefill_logits(cfg, packed, x, text_ids)
    moved = float((as_text - logits).abs().max() / logits.abs().max())
    log(f"  the grid's (t, h, w) ids against text ids on the same "
        f"embeddings: logits move {moved:.4g}")
    if not moved > 1e-3:
        raise AssertionError(f"phase {tag}: M-RoPE grid ids moved the "
                             f"logits {moved}")
    _hold_prefill(tag, cfg, packed, dense_c, x, grid, tol, deep_tol,
                  "embeds prefill")
    _merge(launched, _vlm_engine(tag, cfg, packed, per_step, oracle=f32))
    del packed, dense_c
    torch.cuda.empty_cache()
    return launched


def audio_phase(tag, n_layers, dtype=torch.bfloat16, deep_tol=None):
    """Phase A (hubert-xlarge at full width, ``n_layers``, bf16) / A f32
    (2 layers): random weights from seed 0, ``*=slab`` at CR 0.5 (8
    iterations) on 16 x 128 frame embeddings from
    ``np.random.default_rng(0)``, packed (every linear through #1, or #3
    where ELL loses on bytes; ``lm_head`` as it is) and run by the packed
    prefill (``runtime.step.make_prefill_fn``) on VA_PREFILL x VA_FRAMES
    frame embeddings: M = PREFILL_M rows a linear, launches exact; at
    bf16 wall ms against the dense-equivalent's and a device profile. The
    logits held as ``_hold_prefill`` says. At bf16 then one
    ``make_train_fn`` step at 2 layers on ``launch.train.make_batch``'s
    embeddings (loss finite). Returns the main-path runs' launches."""
    from repro_torch.data import SyntheticCorpus
    from repro_torch.launch.train import make_batch
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.runtime.step import make_prefill_fn, make_train_fn
    f32 = dtype == torch.float32
    tol = 1e-4 if f32 else 3e-2
    front = _va_front(tag, "hubert_xlarge", n_layers, dtype)
    cfg, full, dense_c, packed, variants = front[:5]
    _va_header(tag, cfg, full, front, f"(encoder, causal={cfg.causal}, "
               f"rope {cfg.rope!r}) d_model {cfg.d_model} heads "
               f"{cfg.n_heads}x{cfg.d_head} d_ff {cfg.d_ff} ({cfg.act}) "
               f"vocab {cfg.vocab}")
    del front
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (VA_PREFILL, VA_FRAMES, cfg.d_model), dtype=np.float32)).to(
        "cuda", dtype)
    need = _launch_keys(cfg, packed, variants, PREFILL_M)
    prefill = make_prefill_fn(cfg)
    prefill(packed, x)                           # warm-up
    logits, launched, dt = _counted(lambda: prefill(packed, x), need, tag,
                                    "packed prefill")
    if tuple(logits.shape) != (VA_PREFILL, VA_FRAMES, cfg.vocab) or not \
            bool(torch.isfinite(logits).all()):
        raise AssertionError(f"phase {tag}: prefill logits "
                             f"{tuple(logits.shape)}")
    prefill(dense_c, x)
    sync()
    t0 = time.monotonic()
    prefill(dense_c, x)
    sync()
    dt_dense = time.monotonic() - t0
    log(f"  packed prefill {VA_PREFILL} x {VA_FRAMES} frames (M {PREFILL_M} "
        f"a linear): {dt * 1e3:.2f} ms wall, dense-equivalent "
        f"{dt_dense * 1e3:.2f} ms; launches "
        + " ".join(f"{kk}={c}" for kk, c in launched.items()))
    if not f32:
        _device_profile(lambda: prefill(packed, x), 1, dt * 1e3, "packed",
                        focus=_va_focus(variants), unit="prefill")
        _device_profile(lambda: prefill(dense_c, x), 1, dt_dense * 1e3,
                        "dense-equivalent", unit="prefill")
    _hold_prefill(tag, cfg, packed, dense_c, x, None, tol, deep_tol,
                  "prefill")
    del packed, dense_c
    torch.cuda.empty_cache()
    if not f32:
        cfg2 = cfg.with_(n_layers=2)
        acfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
        params = lm.init(cfg2, seed=0, device="cuda")
        opt = adamw_init(params, acfg)
        step = make_train_fn(cfg2, acfg, remat="nothing")
        corpus = SyntheticCorpus(cfg2.vocab, seed=0)
        losses = []
        for s in range(2):
            batch = make_batch(cfg2, corpus, s, VA_PREFILL, VA_FRAMES, "cuda")
            sync()
            t0 = time.monotonic()
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            dt_step = time.monotonic() - t0
        log(f"  make_train_fn at 2 layers ({lm.param_count(cfg2) / 1e6:.1f} M"
            f" parameters), batch {VA_PREFILL} x {VA_FRAMES} frame embeddings"
            f" (make_batch): losses {losses[0]:.4f} {losses[1]:.4f}, the "
            f"second step {dt_step * 1e3:.1f} ms")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"phase {tag}: train losses {losses}")
        del params, opt
        torch.cuda.empty_cache()
    return launched


# kernel-name parts of the profiles: #4 is ell_split_kernel with neither
# term and SPLIT (every main-path launch splits), #12 the same unsplit;
# #6 runs DenseSrc under tc_nm_kernel (#18 under tc_kernel)
ELL4_SPLIT = ("ell_split_kernel<unsigned short, false, false", ", true>")
ELL12 = ("ell_split_kernel<unsigned short, false, false", ", false>")
LR6 = "tc_nm_kernel<tc::DenseSrc"
# #9 runs NoSrc under tc_bin_kernel (#20 under tc_g_kernel); #15 NmSrc
# under tc_g_kernel without the ±1 term (#17 with it)
BIN9 = "tc_bin_kernel<tc::NoSrc"
NM15 = ("tc_g_kernel<tc::NmSrc<2, 4>", "false, false>")
# ---------------------------------------------------------------- phase M

M_MESH = (1, 2)            # (data, model): two ranks on the one card
M_PROMPT = 16              # phase M's engine trace: prompts up to this
M_REQUESTS = 4
M_ENGINE = dict(n_slots=4, n_blocks=24, block_size=16, max_len=64,
                prefill_chunk=8)
M_DIR = ".chip_smoke_mesh"  # the packed models handed to the ranks
M_TIMEOUT = 600.0
# bf16 final-step logits under the mesh against the single-process packed
# model's: the same arithmetic, summed in another order (the split
# softmax over two ranks' positions, the vocab slices' matmuls)
M_BF16_TOL = 1e-2


def _tree_to(tree, device):
    """A dict / list / NamedTuple tree with every tensor on ``device``."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(device) if torch.is_tensor(t) else t,
                    tree)


def mesh_ahead():
    """Phase M's compressions (llama2-7b 2 layers bf16, phi3.5-moe 1 layer
    f32), made while nvcc builds and kept on the host until phase M."""
    AHEAD["M"] = _tree_to(_phase_front(2, torch.bfloat16, 0.5, None), "cpu")
    AHEAD["M phi"] = _tree_to(_phase_front(
        1, torch.float32, 0.5, None, arch="phi3_5_moe"), "cpu")


def _m_engine_trace(cfg):
    from repro_torch.serving import Request
    rng = np.random.default_rng(1)
    return [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab, size=int(rng.integers(M_PROMPT // 2, M_PROMPT + 1)))
        .astype(np.int32), max_new=int(rng.integers(8, 17)),
        arrival=float(2 * i)) for i in range(M_REQUESTS)]


def _m_kernel_at(leaf, flush, m=4, tag="M"):
    """#1 on one local (row-sharded) leaf at ``m`` rows, bf16: the wrapper
    held to its plain version on the same inputs, then timed beside the
    plain version, one torch.matmul on the reconstructed local Ŵ and the
    bound (``_time_case``)."""
    from repro_torch.core.packing import (ELLPacked, ell_unpack,
                                          unpack_sign_bits)
    from repro_torch.kernels import ell as ell_k
    from repro_torch.kernels import ops
    n, k = leaf.sparse_vals.shape[0], leaf.d_in
    x = torch.randn((m, k), generator=torch.Generator("cuda").manual_seed(
        n + k), device="cuda").to(torch.bfloat16)
    u, v = ops._rank_stack(leaf.u, leaf.v, x.dtype)
    vals, idx, b = leaf.sparse_vals, leaf.sparse_idx, leaf.b_packed
    got = ell_k.slab_ell_matmul(x, vals, idx, b, u, v)
    ref = ell_k.slab_ell_matmul_plain(x, vals, idx, b, u, v)
    err = float((got.float() - ref.float()).abs().max()
                / ref.float().abs().max())
    if not err < TOL[torch.bfloat16]:
        raise AssertionError(f"phase {tag}: #1 at ({n}, {k}) M {m} rel "
                             f"{err}")
    r = u.shape[0]
    ops_n = (2 * m * vals.numel() + m * k * r + 2 * m * n * k * r
             + 2 * m * n * r)
    case = Case(
        "slab_ell_matmul TP", "slab_ell_matmul",
        lambda: ell_k.slab_ell_matmul(x, vals, idx, b, u, v),
        lambda: ell_k.slab_ell_matmul_plain(x, vals, idx, b, u, v),
        (vals, idx, b, u, v),
        lambda: ell_unpack(ELLPacked(vals, idx, k)).float()
        + (u.float().T @ v.float()) * unpack_sign_bits(b, k, torch.float32),
        ops_n)
    rec = _time_case(case, x, r, got, ref, flush)
    rec["rel_err"] = err
    return rec


def _m_place(cfg, path, mesh, dev):
    """A packed model saved by the parent, loaded (memory-mapped) and
    placed on this rank: each packed leaf moved to the card and cut to
    its shards at once (``PackPlacer``: checksummed), then the dense
    leaves (``serve.place_params``, every rank's checksums compared)."""
    import contextlib
    import io
    from repro_torch.core.packed_model import (ExpertPackedStack, PackedLinear,
                                               packed_axes)
    from repro_torch.launch.serve import place_params
    from repro_torch.runtime.sharding import PackPlacer, Planner, _map
    tree = torch.load(path, mmap=True, map_location="cpu", weights_only=False)
    placer = PackPlacer(Planner(mesh, cfg), mesh)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        if isinstance(t, (PackedLinear, ExpertPackedStack)):
            return placer(_map(lambda ax, p, plane: p.to(dev),
                               packed_axes(t), t))
        return t.to(dev) if isinstance(t, torch.Tensor) else t

    params = walk(tree)
    with contextlib.redirect_stdout(io.StringIO()):
        params = place_params(cfg, params, placer)
    return params, placer


def _m_greedy(cfg, params, prompts, dev, need):
    """One greedy_decode (BATCH x PROMPT, GEN new) with the launch counts
    zeroed just before and read just after, each of ``need`` exactly."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import greedy_decode
    greedy_decode(cfg, params, prompts[:, :PROF_PROMPT], 2, device=dev)
    ops.reset_launch_counts()
    sync()
    t0 = time.monotonic()
    gen = greedy_decode(cfg, params, prompts, GEN, device=dev)
    sync()
    wall = time.monotonic() - t0
    counts = {k: c for k, c in ops.launch_counts().items() if c}
    for kname, n in need.items():
        if counts.get(kname, 0) != n:
            raise AssertionError(f"phase M: {kname} launched "
                                 f"{counts.get(kname, 0)} times, expected {n}")
    return gen, wall, counts


def _mesh_worker(rank, world, dev, data, model, files, prompts, seqs):
    """One rank of phase M: every model placed on this rank's shards and
    served under the mesh; returns what the parent holds and logs. The
    final logits are taken over the parent's sequences ``seqs`` (its
    prompts and single-process tokens), so both see the same inputs."""
    from repro_torch import configs
    from repro_torch.kernels import build, ops
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.runtime.mesh import make_mesh
    from repro_torch.runtime.meshctx import use_mesh
    from repro_torch.runtime.sharding import packed_bytes
    from repro_torch.core.packed_model import PackedLinear, _row_slice
    missing = [s for s in build.SOURCES if not build.lib_path(s).exists()]
    if missing:
        raise RuntimeError(f"rank {rank}: kernels not built by the parent: "
                           f"{missing} (a rank never runs nvcc)")
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(data, model, dev)
    prompts = torch.as_tensor(prompts, device=dev)
    steps = PROMPT + GEN - 1
    out = {"counts": {}}

    def add(counts):
        for kk, c in counts.items():
            out["counts"][kk] = out["counts"].get(kk, 0) + c

    # llama2-7b, 2 layers, bf16: #1 at the local shapes, greedy_decode,
    # the final logits, a profile on rank 0, the collectives' share
    full = configs.get("llama2_7b")
    cfg = full.with_(n_layers=2, dtype=torch.bfloat16)
    params, placer = _m_place(cfg, files["llama_bf16"], mesh, dev)
    leaves = [w for lp in params["layers"] for sub in lp.values()
              if isinstance(sub, dict) for w in sub.values()
              if isinstance(w, PackedLinear)]
    shapes = sorted({(w.sparse_vals.shape[0], w.d_in) for w in leaves})
    res = {"shapes": shapes, "bytes": packed_bytes(params),
           "bytes_whole": placer.bytes_whole, "n_leaves": len(leaves)}
    if rank == 0:       # alone on the card while it times
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        res["kernel"] = {}
        for n, k in shapes:
            leaf = next(w for w in leaves
                        if (w.sparse_vals.shape[0], w.d_in) == (n, k))
            with use_mesh(mesh):        # u (rank 1) cut to the rank's rows
                leaf = _row_slice(leaf, n)
            res["kernel"][(n, k)] = _m_kernel_at(leaf, flush)
        del flush
    torch.distributed.barrier()
    with use_mesh(mesh):
        gen, wall, counts = _m_greedy(cfg, params, prompts, dev,
                                      {"slab_ell_matmul": 14 * steps})
        add(counts)
        seq = torch.as_tensor(seqs["llama"], device=dev)
        res |= {"tokens": gen.cpu().numpy(), "wall": wall,
                "launches": counts,
                "logits": _final_logits(cfg, params, seq).cpu().numpy()}
        run = lambda: greedy_decode(cfg, params, prompts[:, :PROF_PROMPT],
                                    4, device=dev)
        if rank == 0:
            import contextlib
            import io
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                _device_profile(run, PROF_PROMPT + 3, wall / steps * 1e3,
                                "rank 0", ("#1 slab_ell_matmul",
                                           "ell_split_kernel"))
            res["profile"] = buf.getvalue()
        else:
            run()
        sync()
        mesh.timed = True
        t0 = time.monotonic()
        run()
        sync()
        res["comm"] = (mesh.comm_s, mesh.comm_calls, time.monotonic() - t0)
        mesh.timed = False
    out["llama_bf16"] = res
    del params, leaves
    torch.cuda.empty_cache()

    # llama2-7b, 2 layers, f32: greedy tokens, then the engine on
    # kv-head-sharded pools
    cfg = full.with_(n_layers=2, dtype=torch.float32)
    params, _ = _m_place(cfg, files["llama_f32"], mesh, dev)
    with use_mesh(mesh):
        gen, wall, counts = _m_greedy(
            cfg, params, prompts, dev,
            {"slab_ell_matmul@ell.cu": 14 * steps})
        add(counts)
        res = {"tokens": gen.cpu().numpy(), "wall": wall, "launches": counts}
    from repro_torch.serving import Engine, EngineConfig
    eng = Engine(cfg, params, EngineConfig(**M_ENGINE), device=dev,
                 mesh=mesh)
    ops.reset_launch_counts()
    sync()
    t0 = time.monotonic()
    done = eng.run(_m_engine_trace(cfg), clock="steps")
    sync()
    counts = {k: c for k, c in ops.launch_counts().items() if c}
    add(counts)
    for kname in ("slab_ell_matmul@ell.cu", "flash_decode_paged"):
        if not counts.get(kname):
            raise AssertionError(f"phase M engine: rank {rank} never "
                                 f"launched {kname}")
    res["engine"] = {"wall": time.monotonic() - t0, "launches": counts,
                     "kv_local": tuple(eng.paged[0].k.shape),
                     "steps": eng.n_steps}
    if rank == 0:
        _check_no_leak(eng, "phase M engine")
        res["engine"]["streams"] = [(r.status, list(map(int, r.out)))
                                    for r in done]
    out["llama_f32"] = res
    del params, eng
    torch.cuda.empty_cache()

    # phi3.5-moe, 1 layer, f32: experts 8 of 16 a rank
    cfg = configs.get("phi3_5_moe").with_(n_layers=1, dtype=torch.float32)
    params, placer = _m_place(cfg, files["phi"], mesh, dev)
    groups = {name: [(len(m), g.sparse_vals.shape[0]) for m, g in
                     zip(w.members, w.groups)]
              for name, w in params["layers"][0]["moe"].items()
              if hasattr(w, "groups")}
    n_groups = sum(len(g) for g in groups.values())
    prompts = prompts % cfg.vocab
    with use_mesh(mesh):
        gen, wall, counts = _m_greedy(
            cfg, params, prompts, dev,
            {"slab_ell_matmul@ell.cu": 4 * steps,
             "slab_ell_matmul_g@ell.cu": n_groups * steps})
        add(counts)
        seq = torch.as_tensor(seqs["phi"], device=dev)
        out["phi"] = {"tokens": gen.cpu().numpy(), "wall": wall,
                      "launches": counts, "groups": groups,
                      "bytes": packed_bytes(params),
                      "bytes_whole": placer.bytes_whole,
                      "logits": _final_logits(cfg, params, seq)
                      .cpu().numpy()}
    return out


def mesh_phase():
    """Phase M: tensor-parallel packed serving on a (data 1, model 2) mesh
    of two processes on the one card (gloo: NCCL takes one rank a card).
    The parent compresses and packs each model once (made ahead), serves
    it single-process for the yardsticks, and saves it; each rank loads
    it, cuts its shards leaf by leaf (checksums compared across ranks) and
    serves it under the mesh through the kernels the parent built:
    llama2-7b (2 layers, slab CR 0.5) at bf16, #1 on its local rows (N
    2048 / 5504 at K 4096, 2048 at K 11008), logits within 3e-2 of the
    dense-equivalent and M_BF16_TOL of the single-process packed
    model's; the same at f32, tokens equal to the
    single-process model's, then the engine on kv-head-sharded pools
    (#11 at 16 of 32 heads), streams equal to the single-process
    engine's; phi3.5-moe (1 layer, f32), 8 of 16 experts a rank through
    #14, tokens equal and logits within 1e-4 of the single-process
    model's. Returns every rank's main-path launches, summed, and #1's
    records at the local shapes."""
    import shutil
    data, model = M_MESH
    log(f"phase M: tensor-parallel packed serving, mesh data={data} x "
        f"model={model} as {data * model} processes on the one card "
        f"({CARD[0]})")
    root = Path(__file__).resolve().parent / f"{M_DIR}_{os.getpid()}"
    root.mkdir()
    files = {k: str(root / f"{k}.pt") for k in ("llama_bf16", "llama_f32",
                                                  "phi")}
    try:
        return _mesh_phase(data, model, files, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _mesh_phase(data, model, files, root):
    from repro_torch.core.packed_model import pack_model
    from repro_torch.tree import tree_map
    from repro_torch.data import SyntheticCorpus
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.runtime.mesh import spawn
    from repro_torch.serving import Engine, EngineConfig
    t0 = time.monotonic()
    front = _tree_to(AHEAD.pop("M", None) or _phase_front(
        2, torch.bfloat16, 0.5, None), "cuda")
    cfg, dense_c, decs, plan = (front[k] for k in ("cfg", "dense_c", "decs",
                                                   "plan"))
    prompts = torch.as_tensor(SyntheticCorpus(cfg.vocab, seed=0).batch(
        0, BATCH, PROMPT)["inputs"], device="cuda")
    steps = PROMPT + GEN - 1
    single = {}
    packed, rep = pack_model(dense_c, decs, plan=plan, dtype=cfg.dtype)
    _check_packed(cfg, packed, rep, "slab-ell")
    greedy_decode(cfg, packed, prompts[:, :PROF_PROMPT], 2, device="cuda")
    sync()
    t1 = time.monotonic()
    gen = greedy_decode(cfg, packed, prompts, GEN, device="cuda")
    sync()
    single["bf16_wall"] = time.monotonic() - t1
    # PROMPT + GEN positions: an s_max the "model" axis divides, so the
    # ranks' held logits come through the position-sharded cache
    seq = torch.cat([prompts.long(), gen], dim=1)
    seqs = {"llama": seq.cpu().numpy()}
    single["bf16_tokens"] = gen.cpu().numpy()
    single["bf16_logits"] = _final_logits(cfg, packed, seq)
    single["dense_logits"] = _final_logits(cfg, dense_c, seq)
    torch.save(packed, files["llama_bf16"])
    del packed
    # the same decompositions packed at f32 over the f32 dense-equivalent
    cfg32 = cfg.with_(dtype=torch.float32)
    dense32 = tree_map(lambda t: t.float() if torch.is_tensor(t)
                       and t.is_floating_point() else t, dense_c)
    packed, _ = pack_model(dense32, decs, plan=plan, dtype=torch.float32)
    del dense32, dense_c, decs, front
    single["f32_tokens"] = greedy_decode(cfg32, packed, prompts, GEN,
                                         device="cuda").cpu().numpy()
    eng = Engine(cfg32, packed, EngineConfig(**M_ENGINE), device="cuda")
    done = eng.run(_m_engine_trace(cfg32), clock="steps")
    _check_no_leak(eng, "phase M single-process engine")
    single["streams"] = [(r.status, list(map(int, r.out))) for r in done]
    torch.save(packed, files["llama_f32"])
    del packed, eng
    # phi3.5-moe, 1 layer, f32
    front = _tree_to(AHEAD.pop("M phi", None) or _phase_front(
        1, torch.float32, 0.5, None, arch="phi3_5_moe"), "cuda")
    pcfg = front["cfg"]
    packed, rep = pack_model(front["dense_c"], front["decs"],
                             plan=front["plan"], dtype=torch.float32)
    del front
    _check_packed(pcfg, packed, rep, "slab-ell")
    pprompts = prompts % pcfg.vocab
    gen = greedy_decode(pcfg, packed, pprompts, GEN, device="cuda")
    seq = torch.cat([pprompts.long(), gen], dim=1)
    seqs["phi"] = seq.cpu().numpy()
    single["phi_tokens"] = gen.cpu().numpy()
    single["phi_logits"] = _final_logits(pcfg, packed, seq)
    torch.save(packed, files["phi"])
    del packed
    torch.cuda.empty_cache()
    log(f"  single-process yardsticks and the saved models: "
        f"{time.monotonic() - t0:.1f}s; bf16 greedy_decode "
        f"{single['bf16_wall'] / steps * 1e3:.2f} ms a decode step")

    t0 = time.monotonic()
    per_rank = spawn(_mesh_worker, data * model, "cuda",
                     str(root / "store"),
                     args=(data, model, files, prompts.cpu().numpy(),
                           seqs),
                     timeout=M_TIMEOUT)
    log(f"  {data * model} ranks spawned, placed and served in "
        f"{time.monotonic() - t0:.1f}s")
    return _mesh_report(per_rank, single, model, steps, cfg)


def _mesh_report(per_rank, single, model, steps, cfg):
    """Hold every rank's results, log them, and return (launches summed
    over the ranks, #1's records at the local shapes)."""
    r0 = per_rank[0]
    # llama2-7b's q/k/v/o, w_gate/w_up and w_down rows cut over "model"
    want = sorted({(cfg.d_q // model, cfg.d_model),
                   (cfg.d_ff // model, cfg.d_model),
                   (cfg.d_model // model, cfg.d_ff)})
    for rank, res in enumerate(per_rank):
        a = res["llama_bf16"]
        if a["shapes"] != want or a["n_leaves"] != 14:
            raise AssertionError(f"phase M: rank {rank} holds #1 leaves "
                                 f"{a['shapes']}, expected {want}")
        log(f"  rank {rank}: 14 slab-ell leaves at local (N, K) "
            f"{a['shapes']}; packed planes held {a['bytes'] / 1e6:.1f} MB "
            f"of {a['bytes_whole'] / 1e6:.1f} MB single-device "
            f"({a['bytes'] / a['bytes_whole']:.4f}); phi3.5-moe "
            f"{res['phi']['bytes'] / 1e6:.1f} of "
            f"{res['phi']['bytes_whole'] / 1e6:.1f} MB "
            f"({res['phi']['bytes'] / res['phi']['bytes_whole']:.4f}), "
            f"expert groups (members, held) {res['phi']['groups']}")
        for g in res["phi"]["groups"].values():
            for n_mem, held in g:
                if n_mem % model == 0 and held != n_mem // model:
                    raise AssertionError(f"phase M: rank {rank} holds "
                                         f"{held} of {n_mem} experts")
        log(f"  rank {rank} launches: " + " ".join(
            f"{k}={c}" for k, c in sorted(res["counts"].items())))
        kv = res["llama_f32"]["engine"]["kv_local"]
        if kv[2] != cfg.n_kv // model:
            raise AssertionError(f"phase M: rank {rank} pool {kv}")
        for tag in ("llama_bf16", "llama_f32", "phi"):
            if not np.array_equal(res[tag]["tokens"], r0[tag]["tokens"]):
                raise AssertionError(f"phase M: rank {rank}'s {tag} tokens "
                                     "differ from rank 0's")
    a, f, p = r0["llama_bf16"], r0["llama_f32"], r0["phi"]
    _hold_logits("M", torch.as_tensor(a["logits"]),
                 single["dense_logits"].cpu(), 3e-2,
                 "llama2-7b bf16, mesh vs dense-equivalent")
    _hold_logits("M", torch.as_tensor(a["logits"]),
                 single["bf16_logits"].cpu(), M_BF16_TOL,
                 "llama2-7b bf16, mesh vs single-process packed")
    same = int((a["tokens"] == single["bf16_tokens"]).sum())
    log(f"  llama2-7b bf16 mesh vs single-process packed: greedy tokens "
        f"{same} of {a['tokens'].size} equal")
    if not np.array_equal(f["tokens"], single["f32_tokens"]):
        raise AssertionError("phase M: f32 mesh tokens differ from the "
                             "single-process packed model's")
    log(f"  llama2-7b f32: greedy tokens equal to the single-process "
        f"packed model's: {f['tokens'].size} of {f['tokens'].size}")
    e = f["engine"]
    if e["streams"] != single["streams"]:
        raise AssertionError("phase M: engine streams differ from the "
                             "single-process engine's")
    log(f"  engine on kv-head-sharded pools {e['kv_local']} "
        f"({e['kv_local'][2]} of {cfg.n_kv} heads): {len(e['streams'])} "
        f"requests "
        f"{sorted({s for s, _ in e['streams']})}, token-equal to the "
        f"single-process engine, {e['steps']} steps in {e['wall']:.1f}s, "
        f"no block leaked; launches " + " ".join(
            f"{k}={c}" for k, c in sorted(e["launches"].items())))
    if not np.array_equal(p["tokens"], single["phi_tokens"]):
        raise AssertionError("phase M: phi3.5-moe mesh tokens differ")
    _hold_logits("M", torch.as_tensor(p["logits"]),
                 single["phi_logits"].cpu(), 1e-4,
                 "phi3.5-moe f32, mesh vs single-process packed")
    comm_s, calls, wall = a["comm"]
    log(f"  llama2-7b bf16 decode step: {a['wall'] / steps * 1e3:.2f} ms "
        f"wall under the mesh vs {single['bf16_wall'] / steps * 1e3:.2f} "
        f"single-process; collectives (synchronised, host clock) "
        f"{comm_s * 1e3:.1f} ms in {calls} calls of a {wall * 1e3:.1f} ms "
        f"run of {PROF_PROMPT + 3} steps (share {comm_s / wall:.3f})")
    for line in a["profile"].splitlines():
        log("  " + line.strip())
    for (n, k), rec in a["kernel"].items():
        log(f"  #1 at rank 0's ({n}, {k}): rel {rec['rel_err']:.3g}, "
            f"{rec['ms']:.4f} ms (bound {rec['bound_ms']:.4f}, plain "
            f"{rec['plain_ms']:.4f}, matmul {rec['library_ms']:.4f})")
    total = {}
    for res in per_rank:
        for kk, c in res["counts"].items():
            total[kk] = total.get(kk, 0) + c
    return total, a["kernel"]


# ---------------------------------------------------------------- phase P

P_MESH = (2, 1)          # (data, model): two ranks on the one card
P_STEPS, P2_STEPS, P3_STEPS = 3, 2, 4
P_TIMEOUT = 600.0
P_LOSS_TOL = 1e-3        # P1's step 1 against phase T's
P3_CLOSE = 0.05          # compressed vs uncompressed after P3_STEPS
# P3's learning rate: at phase T's 1e-3 both runs fit batch 0 to a loss
# near 0 by step 4 (0.0087 vs 0.0100), where a relative bound measures
# the floor's noise, and on fresh batches the loss does not fall in 4
# steps at full width (10.7432 -> 10.7448)
P3_LR = 1e-4
YARDSTICKS = {}          # numbers a later phase holds: phase T's step-1 loss


def _nbytes_held(tree) -> int:
    from repro_torch.runtime.sharding import local_tensors
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size()
               for t in tree_leaves(local_tensors(tree)))


def _digests(tree) -> list:
    """SHA-256 of every leaf's bytes, in flatten order."""
    import hashlib
    from repro_torch.tree import tree_leaves
    return [hashlib.sha256(t.detach().contiguous().view(-1).view(
        torch.uint8).cpu().numpy()).hexdigest() for t in tree_leaves(tree)]


def _p_timed_step(mesh, run):
    """``run()`` with the collectives timed (``Mesh.timed``): (its
    result, wall seconds, (collective seconds, calls, bytes sent))."""
    mesh.timed = True
    mesh.comm_s, mesh.comm_calls, mesh.comm_bytes = 0.0, 0, 0
    sync()
    t0 = time.monotonic()
    out = run()
    sync()
    wall = time.monotonic() - t0
    mesh.timed = False
    return out, wall, (mesh.comm_s, mesh.comm_calls, mesh.comm_bytes)


def _p_worker(rank, world, dev, data, model, commit):
    """One rank of phase P: P1 (make_train_fn on the mesh, 2 layers), P2
    (1 layer, committed by rank 0) and P3 (the int8 error-feedback DDP
    step against the plain f32 mean); returns what the parent holds and
    logs."""
    import contextlib
    import dataclasses
    import io
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import SyntheticCorpus
    from repro_torch.models import lm
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime import ddp
    from repro_torch.runtime.elastic import place_train_state
    from repro_torch.runtime.mesh import make_mesh
    from repro_torch.runtime.sharding import Planner, gather_shards
    from repro_torch.runtime.step import make_train_fn
    from repro_torch.tree import tree_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(data, model, dev)
    out = {}

    def placed(cfg, acfg):
        params = lm.init(cfg, seed=0, device=dev)
        state = {"params": params, "opt": adamw_init(params, acfg)}
        single = (_nbytes_held(state["params"]),
                  _nbytes_held((state["opt"].mu, state["opt"].nu)))
        state = place_train_state(state, cfg, acfg, mesh)
        del params
        torch.cuda.empty_cache()
        return state, single

    # ---- P1: 2 layers, P_STEPS steps on batch 0
    _, cfg, acfg = _train_setup(2)
    fit = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticCorpus(
        cfg.vocab, seed=0).batch(0, TRAIN_BATCH, TRAIN_SEQ).items()}
    state, single = placed(cfg, acfg)
    held = (_nbytes_held(state["params"]),
            _nbytes_held((state["opt"].mu, state["opt"].nu)))
    step = make_train_fn(cfg, acfg, TRAIN_MB, "nothing",
                         planner=Planner(mesh, cfg))
    torch.cuda.reset_peak_memory_stats(dev)
    p, o = state["params"], state["opt"]
    losses, walls, comm, profile = [], [], None, ""
    for s in range(P_STEPS):
        if s == 1:            # the collectives timed
            (p, o, m), wall, comm = _p_timed_step(
                mesh, lambda: step(p, o, fit))
        elif s == 2 and rank == 0:
            box = []
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                _device_profile(lambda: box.append(step(p, o, fit)), 1,
                                walls[1] * 1e3, "rank 0 train step",
                                unit="train step")
            p, o, m = box[0]
            profile, wall = buf.getvalue(), float("nan")
        else:
            sync()
            t0 = time.monotonic()
            p, o, m = step(p, o, fit)
            sync()
            wall = time.monotonic() - t0
        losses.append(float(m["loss"]))
        walls.append(wall)
    out["P1"] = {"losses": losses, "walls": walls, "comm": comm,
                 "profile": profile, "held": held, "single": single,
                 "peak": torch.cuda.max_memory_allocated(dev)}
    del p, o, state, step, m
    torch.cuda.empty_cache()

    # ---- P2: 1 layer, P2_STEPS steps, committed by rank 0
    _, cfg1, acfg1 = _train_setup(1)
    state, _ = placed(cfg1, acfg1)
    step = make_train_fn(cfg1, acfg1, TRAIN_MB, "nothing",
                         planner=Planner(mesh, cfg1))
    p, o = state["params"], state["opt"]
    losses = []
    for s in range(P2_STEPS):
        p, o, m = step(p, o, fit)
        losses.append(float(m["loss"]))
    sync()
    t0 = time.monotonic()
    assembled = gather_shards({"params": p, "opt": o}, mesh)
    sync()
    t_gather = time.monotonic() - t0
    digests = _digests(assembled) if rank == 0 else None
    mgr = CheckpointManager(commit, keep=1, mesh=mesh)
    t0 = time.monotonic()
    mgr.save(P2_STEPS, assembled)
    mgr.wait()
    out["P2"] = {"losses": losses, "digests": digests,
                 "gather_s": t_gather, "commit_s": time.monotonic() - t0,
                 "local": [tuple(t.local.shape) for t in
                           [p["layers"][0]["attn"]["wq"]]]}
    del p, o, state, step, assembled, m
    torch.cuda.empty_cache()

    # ---- P3: the compressed DDP step against the plain f32 mean, 1 layer,
    # on batch 0 at P3_LR
    acfg3 = dataclasses.replace(acfg1, lr=P3_LR)
    for compress in (True, False):
        params = lm.init(cfg1, seed=0, device=dev)
        opt = adamw_init(params, acfg3)
        err = ddp.init_error_buffers(params)
        step = ddp.build_compressed_ddp_step(cfg1, acfg3, mesh,
                                             compress=compress)
        losses, walls, comms = [], [], []
        for s in range(P3_STEPS):
            (params, opt, err, m), wall, c = _p_timed_step(
                mesh, lambda: step(params, opt, err, fit))
            losses.append(float(m["loss"]))
            walls.append(wall)
            comms.append(c)
        out[f"P3 {compress}"] = {
            "losses": losses, "walls": walls, "comm": comms,
            "err_nonzero": any(bool(e.abs().max() > 0)
                               for e in tree_leaves(err))}
        del params, opt, err, step, m
        torch.cuda.empty_cache()
    return out


def ddp_train_phase():
    """Phase P: the distributed training runtime on a (data 2, model 1)
    mesh of two processes on the one card (gloo carrying CUDA tensors);
    see the module docstring. Launches no packed kernel."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import lm
    from repro_torch.runtime.elastic import elastic_restore
    from repro_torch.runtime.mesh import spawn
    data, model = P_MESH
    full, cfg, acfg = _train_setup(2)
    log(f"phase P: distributed training, mesh data={data} x model={model} "
        f"as {data * model} processes on the one card ({CARD[0]}); "
        f"{full.name} full width, bf16 params, f32 moments, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} global ({TRAIN_BATCH // data} rows a "
        f"rank), microbatches {TRAIN_MB}, remat 'nothing'")
    t_first = YARDSTICKS["T step 1"]
    root = Path(__file__).resolve().parent
    tmp = tempfile.mkdtemp(prefix=".chip_smoke_ckpt_", dir=root)
    try:
        _, cfg1, acfg1 = _train_setup(1)
        per_commit = lm.param_count(cfg1) * (2 + 4 + 4)
        free = shutil.disk_usage(tmp).free
        if free < 2.5 * per_commit:
            raise AssertionError(f"phase P: {free / 1e9:.1f} GB free, the "
                                 f"commit needs ~{per_commit / 1e9:.1f}")
        commit = os.path.join(tmp, "commit")
        t0 = time.monotonic()
        per_rank = spawn(_p_worker, data * model, "cuda",
                         os.path.join(tmp, "store"),
                         args=(data, model, commit), timeout=P_TIMEOUT)
        log(f"  {data * model} ranks spawned and ran P1-P3 in "
            f"{time.monotonic() - t0:.1f}s")
        _p1_report(per_rank, t_first)
        # P2: the parent restores the commit on the card
        r0 = per_rank[0]["P2"]
        t0 = time.monotonic()
        state = elastic_restore(CheckpointManager(commit), cfg1, acfg1,
                                device="cuda")
        sync()
        t_restore = time.monotonic() - t0
        same = _digests(state) == r0["digests"]
        log(f"  P2: llama2-7b 1 layer, {P2_STEPS} steps on the mesh (losses "
            + " ".join(f"{x:.4f}" for x in r0["losses"]) + f"), rank 0's "
            f"wq shard {r0['local'][0]}; gathered whole in "
            f"{r0['gather_s']:.2f}s, committed by rank 0 in "
            f"{r0['commit_s']:.2f}s (~{per_commit / 1e9:.2f} GB); the "
            f"parent's restore on the card ({t_restore:.2f}s) "
            f"{'bitwise equal' if same else 'DIFFERS from'} the state the "
            f"ranks assembled ({len(r0['digests'])} leaves, SHA-256)")
        if not same:
            raise AssertionError("phase P: the restored commit differs")
        del state
        torch.cuda.empty_cache()
        _p3_report(per_rank)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _p1_report(per_rank, t_first):
    for rank, res in enumerate(per_rank):
        r = res["P1"]
        losses = r["losses"]
        log(f"  P1 rank {rank}: losses " + " ".join(
            f"{x:.6f}" for x in losses) + f"; holds params "
            f"{r['held'][0] / 1e9:.3f} of {r['single'][0] / 1e9:.3f} GB, "
            f"moments {r['held'][1] / 1e9:.3f} of {r['single'][1] / 1e9:.3f}"
            f" GB single-process; max_memory_allocated "
            f"{r['peak'] / 2**30:.2f} GiB")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"phase P: P1 losses {losses}")
        rel = abs(losses[0] - t_first) / abs(t_first)
        if not rel < P_LOSS_TOL:
            raise AssertionError(f"phase P: P1 step 1 loss {losses[0]} vs "
                                 f"phase T's {t_first} (rel {rel})")
    r = per_rank[0]["P1"]
    comm_s, calls, sent = r["comm"]
    log(f"  P1 step 1 loss {r['losses'][0]:.6f} vs phase T's "
        f"{t_first:.6f} (rel {abs(r['losses'][0] - t_first) / t_first:.2e}"
        f", tolerance {P_LOSS_TOL}); train step {r['walls'][1] * 1e3:.1f} "
        f"ms wall (step 2; step 1 {r['walls'][0] * 1e3:.1f}), collectives "
        f"(synchronised, host clock) {comm_s * 1e3:.1f} ms in {calls} "
        f"calls (share {comm_s / r['walls'][1]:.3f}), {sent / 1e9:.3f} GB "
        f"sent by rank 0 [{CARD[0]}]")
    for line in r["profile"].splitlines():
        log("  " + line.strip())


def _p3_report(per_rank):
    r0 = per_rank[0]
    c, u = r0["P3 True"], r0["P3 False"]
    log(f"  P3: build_compressed_ddp_step, 1 layer, batch 0, lr {P3_LR}")
    for tag, r in (("compressed (int8, error feedback)", c),
                   ("uncompressed (f32 mean)", u)):
        ms = float(np.median(r["walls"][1:])) * 1e3
        comm_s, calls, sent = r["comm"][-1]
        log(f"  P3 {tag}: losses " + " ".join(
            f"{x:.4f}" for x in r["losses"]) + f"; step {ms:.1f} ms wall "
            f"(median of steps 2-{P3_STEPS}), {sent / 1e6:.1f} MB sent a "
            f"step by rank 0 in {calls} collectives ({comm_s * 1e3:.1f} ms)")
    rel = abs(c["losses"][-1] - u["losses"][-1]) / abs(u["losses"][-1])
    log(f"  P3 after {P3_STEPS} steps: compressed vs uncompressed loss rel "
        f"{rel:.4f} (tolerance {P3_CLOSE}); error buffers non-zero: "
        f"{all(r['P3 True']['err_nonzero'] for r in per_rank)}; bytes a "
        f"step {u['comm'][-1][2] / max(c['comm'][-1][2], 1):.2f}x fewer "
        f"compressed [{CARD[0]}]")
    if not c["losses"][-1] < c["losses"][0]:
        raise AssertionError(f"phase P: P3 compressed losses {c['losses']}")
    if not rel < P3_CLOSE:
        raise AssertionError(f"phase P: P3 compressed vs uncompressed {rel}")
    if not all(r["P3 True"]["err_nonzero"] for r in per_rank):
        raise AssertionError("phase P: P3 error buffers are zero")


# ---------------------------------------------------------------- phase F

F_SERVE_MESH = (1, 2)     # F1-F4 (data, model): two ranks on the one card
F_TRAIN_MESH = (2, 1)     # F5, F6: the same two ranks, a second mesh
# greedy_decode's prompt and new tokens: s_max 24, which "model" 2
# divides, so the hybrid's shared block runs on position-sharded KV
F_PROMPT, F_GEN = 16, 8
# (tag, arch, layers) served packed under (1, 2): at least 6 zamba2-7b
# layers so that its shared block fires (before layer 5)
F_SERVED = (("F1", "mamba2_1_3b", 2), ("F2", "zamba2_7b", 6),
            ("F3", "hubert_xlarge", 2))
F_DENSE_LAYERS = 2        # F4: llama2-7b, dense and unpacked, f32
# (tag, arch, layers) trained under (2, 1)
F_TRAINED = (("F5", "deepseek_moe_16b", 1), ("F6", "qwen2_vl_2b", 2))
F_TRAIN_BATCH, F_TRAIN_SEQ, F_TRAIN_STEPS = 4, 128, 2
F_TIMEOUT = 900.0
F_BF16_TOL = 1e-2         # bf16 logits under the mesh vs one process (as M)
# F1 / F2 at bf16: F_BF16_TOL holds on the first HOLD_LAYERS layers; at
# the phase's depth the mesh's logits are held against the f32 packed
# model's, within F_BF16_NOISE times the single process's own bf16
# distance from them (the ranks' #1 on half the rows splits its f32 sums
# otherwise, and a random model's bf16 rounding grows with depth: zamba2-
# 7b's 6 layers sat 0.0138 from the single process, measured on one H100)
F_BF16_NOISE = 2.0
F_F32_TOL = 1e-4          # F3's f32 prefill logits
F_LOSS_TOL = 1e-3         # F5 / F6 step 1 vs one process (as P)
F_DIR = ".chip_smoke_families"


def _f_front(arch, n_layers):
    """Phase F's compression of ``arch`` (full width cut to ``n_layers``,
    bf16, random weights from seed 0): ``*=slab`` at CR 0.5, 8
    iterations, on 16 x 128 calibration tokens or, for the encoder,
    frame embeddings from ``np.random.default_rng(0)`` (as S, H and A).
    Launches no kernel."""
    from repro_torch import configs
    from repro_torch.core.pipeline import compress_model
    from repro_torch.core.plan import CompressionPlan
    from repro_torch.core.slab import SLaBConfig
    from repro_torch.data import calibration_batch
    from repro_torch.models import lm
    cfg = configs.get(arch).with_(n_layers=n_layers, dtype=torch.bfloat16)
    calib = (np.random.default_rng(0).standard_normal(
        (16, 128, cfg.d_model), dtype=np.float32) if cfg.family == "audio"
        else calibration_batch(cfg.vocab, seed=0, n_seq=16, seq_len=128))
    plan = CompressionPlan.parse("*=slab", base=SLaBConfig(cr=0.5, iters=8))
    params = lm.init(cfg, seed=0, device="cuda")
    dense_c, _, decs = compress_model(cfg, params, calib, plan=plan,
                                      keep_decompositions=True,
                                      device="cuda")
    return {"cfg": cfg, "dense_c": dense_c, "decs": decs, "plan": plan}


def families_ahead():
    """Phase F's three compressions, made while nvcc builds and kept on
    the host until phase F."""
    for tag, arch, n in F_SERVED:
        AHEAD[tag] = _tree_to(_f_front(arch, n), "cpu")


def _f_packed_leaves(params):
    """Every PackedLinear of a (placed) params tree, the hybrid's shared
    block's too."""
    from repro_torch.core.packed_model import PackedLinear
    out = []

    def walk(t):
        if isinstance(t, PackedLinear):
            out.append(t)
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
    walk(params)
    return out


def _f_need(cfg, packed, m, passes):
    """{counter key: launches} of ``passes`` passes of the model at ``m``
    rows a linear: one launch a PackedLinear a layer (#1, or #3 where it
    packed slab-dense), the hybrid's shared block once an invocation."""
    from repro_torch.kernels import ell as ell_k
    from repro_torch.kernels import slab_matmul as slab_k
    from repro_torch.models import lm
    n_inv = lm.n_shared_invocations(cfg)
    need = {}
    for lp, calls in ([(lp, 1) for lp in packed["layers"]]
                      + ([(packed["shared_attn"], n_inv)] if n_inv else [])):
        for w in _f_packed_leaves(lp):
            key = (ell_k.slab_ell_kernel(cfg.dtype, m, w.d_in).key
                   if w.variant == "slab-ell"
                   else slab_k.slab_dense_kernel(cfg.dtype, m).key)
            need[key] = need.get(key, 0) + calls * passes
    return need


def _f_train_setup(arch, n_layers):
    """F5 / F6: ``arch`` at full width cut to ``n_layers``, bf16, AdamW as
    phase T's, and the global batch on the card: tokens (deepseek-moe),
    or frame-free embeddings and (t, h, w) ids of a different layout in
    every row (qwen2-vl), all from seeds."""
    from repro_torch import configs
    from repro_torch.data import SyntheticCorpus
    from repro_torch.optim.adamw import AdamWConfig
    cfg = configs.get(arch).with_(n_layers=n_layers, dtype=torch.bfloat16)
    acfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    batch = SyntheticCorpus(cfg.vocab, seed=0).batch(0, F_TRAIN_BATCH,
                                                     F_TRAIN_SEQ)
    if cfg.family == "vlm":
        rng = np.random.default_rng(5)
        batch["inputs"] = rng.standard_normal(
            (F_TRAIN_BATCH, F_TRAIN_SEQ, cfg.d_model), dtype=np.float32)
        batch["positions"] = np.cumsum(rng.integers(
            0, 2, (F_TRAIN_BATCH, F_TRAIN_SEQ, 3)), axis=1).astype(np.int32)
        half = F_TRAIN_BATCH // 2
        if np.array_equal(batch["positions"][0, :, 0],
                          batch["positions"][half, :, 0]):
            raise AssertionError("phase F: F6's rows share a t layout")
    return cfg, acfg, {k: torch.from_numpy(v).to("cuda")
                       for k, v in batch.items()}


def _f_train(cfg, acfg, batch, planner=None, mesh=None):
    """F_TRAIN_STEPS ``make_train_fn`` steps (remat "nothing") from
    ``lm.init(cfg, seed=0)``, on one process or on ``planner``'s mesh
    (the state placed by its specs): (losses, aux, the second step's
    wall and its collectives' (seconds, calls, bytes sent))."""
    from repro_torch.models import lm
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.elastic import place_train_state
    from repro_torch.runtime.step import make_train_fn
    params = lm.init(cfg, seed=0, device="cuda")
    state = {"params": params, "opt": adamw_init(params, acfg)}
    if mesh is not None:
        state = place_train_state(state, cfg, acfg, mesh)
    del params
    step = make_train_fn(cfg, acfg, 1, "nothing", planner=planner)
    p, o = state["params"], state["opt"]
    losses, aux, wall, comm = [], [], None, None
    for s in range(F_TRAIN_STEPS):
        if s == 1 and mesh is not None:
            (p, o, m), wall, comm = _p_timed_step(mesh,
                                                  lambda: step(p, o, batch))
        else:
            sync()
            t0 = time.monotonic()
            p, o, m = step(p, o, batch)
            sync()
            wall = time.monotonic() - t0
        losses.append(float(m["loss"]))
        aux.append(float(m["aux"]))
    del p, o, state, step
    torch.cuda.empty_cache()
    return losses, aux, wall, comm


def _f_worker(rank, world, dev, files, feeds):
    """One rank of phase F: F1-F4 on the (1, 2) mesh, F5 and F6 on the
    (2, 1) mesh of the same two processes; returns what the parent holds
    and logs."""
    import io
    from repro_torch import configs
    from repro_torch.core.packed_model import _row_slice
    from repro_torch.kernels import build
    from repro_torch.launch.serve import greedy_decode, place_params
    from repro_torch.models import lm
    from repro_torch.runtime.mesh import make_mesh
    from repro_torch.runtime.meshctx import use_mesh
    from repro_torch.runtime.sharding import (PackPlacer, Planner,
                                              dense_bytes, packed_bytes)
    from repro_torch.runtime.step import make_prefill_fn
    missing = [s for s in build.SOURCES if not build.lib_path(s).exists()]
    if missing:
        raise RuntimeError(f"rank {rank}: kernels not built by the parent: "
                           f"{missing} (a rank never runs nvcc)")
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(*F_SERVE_MESH, dev)
    tmesh = make_mesh(*F_TRAIN_MESH, dev)
    prompts = torch.as_tensor(feeds["prompts"], device=dev)
    out = {"counts": {}, "timed": {}}

    def add(counts):
        for kk, c in counts.items():
            out["counts"][kk] = out["counts"].get(kk, 0) + c

    def comm_share(run):
        sync()
        mesh.timed = True
        mesh.comm_s, mesh.comm_calls = 0.0, 0
        t0 = time.monotonic()
        run()
        sync()
        wall = time.monotonic() - t0
        mesh.timed = False
        return mesh.comm_s, mesh.comm_calls, wall

    for tag, arch, n in F_SERVED:
        feed = feeds[tag]
        res = {}
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).replace("torch.", "")
            cfg = configs.get(arch).with_(n_layers=n, dtype=dt)
            params, placer = _m_place(cfg, files[f"{tag} {name}"], mesh, dev)
            r = {"bytes": packed_bytes(params),
                 "bytes_whole": placer.bytes_whole}
            leaves = _f_packed_leaves(params)
            m_rows = PREFILL_M if cfg.family == "audio" else BATCH
            shapes = sorted({(w.sparse_vals.shape[0], w.d_in) for w in leaves
                             if w.variant == "slab-ell"})
            r["shapes"] = shapes
            if rank == 0 and dt == torch.bfloat16:
                flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
                for nn, k in shapes:
                    leaf = next(w for w in leaves if w.variant == "slab-ell"
                                and (w.sparse_vals.shape[0], w.d_in) == (nn, k))
                    with use_mesh(mesh):    # u (rank 1) cut to the rows
                        leaf = _row_slice(leaf, nn)
                    out["timed"][(nn, k, m_rows)] = _m_kernel_at(
                        leaf, flush, m=m_rows, tag="F")
                del flush
            torch.distributed.barrier()
            need = feed["need"][name]
            with use_mesh(mesh):
                if cfg.family == "audio":
                    x = torch.as_tensor(feed["x"], device=dev).to(dt)
                    prefill = make_prefill_fn(cfg, Planner(mesh, cfg))
                    prefill(params, x)                      # warm-up
                    logits, counts, wall = _counted(
                        lambda: prefill(params, x), need, tag,
                        f"{name} prefill under the mesh")
                    r |= {"logits": logits.float().cpu(), "wall": wall}
                else:
                    greedy_decode(cfg, params, prompts[:, :PROF_PROMPT], 2,
                                  device=dev)
                    gen, counts, wall = _counted(
                        lambda: greedy_decode(cfg, params, prompts, F_GEN,
                                              device=dev),
                        need, tag, f"{name} greedy_decode under the mesh")
                    r |= {"tokens": gen.cpu().numpy(), "wall": wall}
                    cache = lm.init_cache(cfg, BATCH, F_PROMPT + F_GEN,
                                          device=dev)
                    r["h"] = tuple(cache.mamba[0].h.shape)
                    if cache.shared_kv:
                        r["shared_kv"] = tuple(cache.shared_kv[0].k.shape)
                    if dt == torch.bfloat16:
                        seq = torch.as_tensor(feed["seq"], device=dev)
                        r["logits"] = _final_logits(cfg, params, seq).cpu()
                        r["first"] = _final_logits(*_first_layers(
                            cfg, params, HOLD_LAYERS), seq).cpu()
                        r["comm"] = comm_share(lambda: greedy_decode(
                            cfg, params, prompts[:, :PROF_PROMPT], 4,
                            device=dev))
                add(counts)
                r["launches"] = counts
            res[name] = r
            del params, leaves
            torch.cuda.empty_cache()
        out[tag] = res

    # F4: llama2-7b dense and unpacked, f32, every dense leaf cut by its
    # specs (linears over "model" too)
    cfg = configs.get("llama2_7b").with_(n_layers=F_DENSE_LAYERS,
                                          dtype=torch.float32)
    whole = lm.init(cfg, seed=0, device=dev)       # the parent's weights
    placer = PackPlacer(Planner(mesh, cfg), mesh)
    with contextlib.redirect_stdout(io.StringIO()):
        params = place_params(cfg, whole, placer)
    del whole
    torch.cuda.empty_cache()
    p4 = prompts % cfg.vocab
    with use_mesh(mesh):
        sync()
        t0 = time.monotonic()
        gen = greedy_decode(cfg, params, p4, F_GEN, device=dev)
        sync()
        out["F4"] = {"bytes": dense_bytes(params), "tokens": gen.cpu().numpy(),
                     "wall": time.monotonic() - t0,
                     "comm": comm_share(lambda: greedy_decode(
                         cfg, params, p4[:, :PROF_PROMPT], 4, device=dev))}
    del params
    torch.cuda.empty_cache()

    # F5, F6: make_train_fn on the (2, 1) mesh, each rank its rows
    for tag, arch, n in F_TRAINED:
        cfg, acfg, batch = _f_train_setup(arch, n)
        batch = {k: v.to(dev) for k, v in batch.items()}
        losses, aux, wall, comm = _f_train(cfg, acfg, batch,
                                           Planner(tmesh, cfg), tmesh)
        out[tag] = {"losses": losses, "aux": aux, "wall": wall,
                    "comm": comm}
    return out


def families_phase():
    """Phase F: the families under a mesh, two processes on the one card
    (gloo carrying CUDA tensors), the models at full width (depth cut).
    The parent packs each model once (its compression made while nvcc
    builds), runs the single-process yardsticks and saves the models;
    the ranks load them, cut their shards and run them through the
    kernels the parent built. On (data 1, model 2): F1 mamba2-1.3b (2
    layers) and F2 zamba2-7b (6 layers: the shared block fires), slab CR
    0.5, each rank on its heads: bf16 final logits within F_BF16_TOL of
    the single process's on HOLD_LAYERS layers and within F_BF16_NOISE
    times the single process's distance of the f32 packed model's at
    the phase's depth, f32 greedy tokens equal, each rank holding
    half of every layer's state h; F3 hubert-xlarge (2 layers), the
    packed prefill at VA_PREFILL x VA_FRAMES frames: bf16 within
    F_BF16_TOL, f32 within F_F32_TOL; F4 llama2-7b (2 layers) dense and
    unpacked at f32: half of the dense bytes a rank, tokens equal. On
    (data 2, model 1): F5 deepseek-moe-16b (1 layer) and F6 qwen2-vl-2b
    (2 layers, rows of different t layouts), F_TRAIN_STEPS
    ``make_train_fn(planner=)`` steps: step 1 within F_LOSS_TOL of the
    single process's. #1 at every new local shape checked and timed on
    rank 0. Returns (launches summed over the ranks, #1's records by (N,
    K, M))."""
    import shutil
    log(f"phase F: the families under a mesh, data={F_SERVE_MESH[0]} x "
        f"model={F_SERVE_MESH[1]} (F1-F4) and data={F_TRAIN_MESH[0]} x "
        f"model={F_TRAIN_MESH[1]} (F5, F6) over the same two processes on "
        f"the one card ({CARD[0]})")
    root = Path(__file__).resolve().parent / f"{F_DIR}_{os.getpid()}"
    root.mkdir()
    try:
        return _families_phase(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _families_phase(root):
    from repro_torch import configs
    from repro_torch.core.packed_model import pack_model
    from repro_torch.data import SyntheticCorpus
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.models import lm
    from repro_torch.runtime.mesh import spawn
    from repro_torch.runtime.step import make_prefill_fn
    from repro_torch.tree import tree_map
    t_phase = time.monotonic()
    files, feeds, single = {}, {}, {}
    steps = F_PROMPT + F_GEN - 1
    prompts = torch.as_tensor(SyntheticCorpus(32000, seed=0).batch(
        0, BATCH, F_PROMPT)["inputs"], device="cuda")
    feeds["prompts"] = prompts.cpu().numpy()
    for tag, arch, n in F_SERVED:
        front = _tree_to(AHEAD.pop(tag, None) or _f_front(arch, n), "cuda")
        cfg, dense_c, decs, plan = (front[k] for k in ("cfg", "dense_c",
                                                       "decs", "plan"))
        del front
        cfg32 = cfg.with_(dtype=torch.float32)
        packed, rep = pack_model(dense_c, decs, plan=plan, dtype=cfg.dtype)
        dense32 = tree_map(lambda t: t.float() if torch.is_tensor(t)
                           and t.is_floating_point() else t, dense_c)
        packed32, _ = pack_model(dense32, decs, plan=plan,
                                 dtype=torch.float32)
        del dense32, dense_c, decs
        feed, s = {}, {"n_packed": rep.n_packed,
                       "variants": dict(rep.by_variant)}
        if cfg.family == "audio":
            x = torch.from_numpy(np.random.default_rng(1).standard_normal(
                (VA_PREFILL, VA_FRAMES, cfg.d_model), dtype=np.float32))
            feed["x"] = x.numpy()
            x = x.to("cuda")
            s["bf16"] = make_prefill_fn(cfg)(packed, x.to(cfg.dtype)
                                             ).float().cpu()
            s["f32"] = make_prefill_fn(cfg32)(packed32, x).cpu()
            feed["need"] = {"bfloat16": _f_need(cfg, packed, PREFILL_M, 1),
                            "float32": _f_need(cfg32, packed32, PREFILL_M,
                                               1)}
        else:
            p = prompts % cfg.vocab
            greedy_decode(cfg, packed, p[:, :PROF_PROMPT], 2, device="cuda")
            sync()
            t0 = time.monotonic()
            gen = greedy_decode(cfg, packed, p, F_GEN, device="cuda")
            sync()
            s["wall"] = time.monotonic() - t0
            seq = torch.cat([p.long(), gen], dim=1)
            feed["seq"] = seq.cpu().numpy()
            s["logits"] = _final_logits(cfg, packed, seq).cpu()
            s["first"] = _final_logits(*_first_layers(cfg, packed,
                                                      HOLD_LAYERS), seq).cpu()
            s["f32_logits"] = _final_logits(cfg32, packed32, seq).cpu()
            s["f32_tokens"] = greedy_decode(cfg32, packed32, p, F_GEN,
                                            device="cuda").cpu().numpy()
            s["h"] = tuple(lm.init_cache(cfg, BATCH, 1, device="meta")
                           .mamba[0].h.shape)
            feed["need"] = {"bfloat16": _f_need(cfg, packed, BATCH, steps),
                            "float32": _f_need(cfg32, packed32, BATCH,
                                               steps)}
        files[f"{tag} bfloat16"] = str(root / f"{tag}_bf16.pt")
        files[f"{tag} float32"] = str(root / f"{tag}_f32.pt")
        torch.save(packed, files[f"{tag} bfloat16"])
        torch.save(packed32, files[f"{tag} float32"])
        del packed, packed32
        torch.cuda.empty_cache()
        feeds[tag], single[tag] = feed, s
    cfg4 = configs.get("llama2_7b").with_(n_layers=F_DENSE_LAYERS,
                                           dtype=torch.float32)
    params = lm.init(cfg4, seed=0, device="cuda")
    single["F4"] = {"tokens": greedy_decode(
        cfg4, params, prompts % cfg4.vocab, F_GEN, device="cuda")
        .cpu().numpy()}
    del params
    torch.cuda.empty_cache()
    for tag, arch, n in F_TRAINED:
        cfg, acfg, batch = _f_train_setup(arch, n)
        losses, aux, wall, _ = _f_train(cfg, acfg, batch)
        single[tag] = {"losses": losses, "aux": aux, "wall": wall}
        del batch
        torch.cuda.empty_cache()
    log(f"  single-process yardsticks and the saved models: "
        f"{time.monotonic() - t_phase:.1f}s")
    t0 = time.monotonic()
    per_rank = spawn(_f_worker, 2, "cuda", str(root / "store"),
                     args=(files, feeds), timeout=F_TIMEOUT)
    log(f"  2 ranks spawned, placed, served and trained in "
        f"{time.monotonic() - t0:.1f}s")
    out = _families_report(per_rank, single, steps)
    log(f"  phase F wall {time.monotonic() - t_phase:.1f}s [{CARD[0]}]")
    return out


def _f_rel(a, b) -> float:
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    return float((a - b).abs().max() / b.abs().max())


def _families_report(per_rank, single, steps):
    """Hold every rank's results against the single process's, log them,
    and return (launches summed over the ranks, rank 0's #1 records).
    Every line is logged before the first failed hold raises."""
    from repro_torch import configs
    model = F_SERVE_MESH[1]
    failed = []

    def hold(ok, what):
        if not ok:
            failed.append(what)

    for rank, res in enumerate(per_rank):
        for tag, arch, n in F_SERVED:
            cfg = configs.get(arch)
            b, f = res[tag]["bfloat16"], res[tag]["float32"]
            s = single[tag]
            held = b["bytes"] / b["bytes_whole"]
            launches = " ".join(f"{k}={c}" for k, c in sorted(
                {**b["launches"], **f["launches"]}.items()))
            if cfg.family == "audio":
                e16 = _f_rel(b["logits"], s["bf16"])
                e32 = _f_rel(f["logits"], s["f32"])
                hold(e16 < F_BF16_TOL and e32 < F_F32_TOL,
                     f"{tag} rank {rank}: prefill logits rel {e16} / {e32}")
                log(f"  {tag} {cfg.name} {n} layers, rank {rank}: packed "
                    f"prefill {VA_PREFILL} x {VA_FRAMES} frames under the "
                    f"mesh {b['wall'] * 1e3:.1f} ms bf16 (rel {e16:.3g} "
                    f"to one process), f32 rel {e32:.3g}; planes held "
                    f"{held:.4f}; #1 local (N, K) {b['shapes']}; launches "
                    f"{launches}")
                continue
            e_first = _f_rel(b["first"], s["first"])
            e16 = _f_rel(b["logits"], s["logits"])
            noise = _f_rel(s["logits"], s["f32_logits"])
            e_f32 = _f_rel(b["logits"], s["f32_logits"])
            same = np.array_equal(f["tokens"], s["f32_tokens"])
            h_want = (s["h"][0], s["h"][1] // model) + s["h"][2:]
            hold(e_first < F_BF16_TOL,
                 f"{tag} rank {rank}: bf16 logits rel {e_first} on "
                 f"{HOLD_LAYERS} layers")
            hold(e_f32 < F_BF16_NOISE * noise,
                 f"{tag} rank {rank}: bf16 logits {e_f32} from the f32 "
                 f"model's, one process {noise}")
            hold(same, f"{tag} rank {rank}: f32 greedy tokens differ")
            hold(b["h"] == h_want, f"{tag} rank {rank}: state h {b['h']}")
            hold(np.array_equal(b["tokens"],
                                per_rank[0][tag]["bfloat16"]["tokens"]),
                 f"{tag} rank {rank}: tokens differ from rank 0's")
            comm_s, calls, wall = b["comm"]
            log(f"  {tag} {cfg.name} {n} layers, rank {rank}: bf16 final "
                f"logits rel {e_first:.3g} to one process on "
                f"{HOLD_LAYERS} layers, {e16:.3g} on {n}; from the f32 "
                f"packed model's {e_f32:.3g} (one process {noise:.3g}); "
                f"f32 greedy tokens equal: {same} ({f['tokens'].size}); "
                f"state h {b['h']} of {s['h']} a layer"
                + (f", shared-block KV {b['shared_kv']}"
                   if "shared_kv" in b else "")
                + f"; planes held {held:.4f}; decode step "
                f"{b['wall'] / steps * 1e3:.2f} ms under the mesh vs "
                f"{s['wall'] / steps * 1e3:.2f} one process, collectives "
                f"{comm_s * 1e3:.1f} ms in {calls} calls of a "
                f"{wall * 1e3:.1f} ms run of {PROF_PROMPT + 3} steps "
                f"(share {comm_s / wall:.3f}); #1 local (N, K) "
                f"{b['shapes']}; launches {launches}")
        r4 = res["F4"]
        held, whole = r4["bytes"]
        same = np.array_equal(r4["tokens"], single["F4"]["tokens"])
        hold(0.49 < held / whole < 0.51 and same,
             f"F4 rank {rank}: holds {held} of {whole} dense bytes, tokens "
             f"equal {same}")
        comm_s, calls, wall = r4["comm"]
        log(f"  F4 llama2-7b {F_DENSE_LAYERS} layers dense unpacked f32, "
            f"rank {rank}: dense bytes held {held / 1e9:.3f} of "
            f"{whole / 1e9:.3f} GB ({held / whole:.4f}); greedy tokens "
            f"equal: {same}; {r4['wall'] / steps * 1e3:.2f} ms a decode "
            f"step, collectives {comm_s * 1e3:.1f} ms in {calls} calls of "
            f"a {wall * 1e3:.1f} ms run (share {comm_s / wall:.3f})")
        for tag, arch, n in F_TRAINED:
            r, s = res[tag], single[tag]
            rel = abs(r["losses"][0] - s["losses"][0]) / abs(s["losses"][0])
            hold(rel < F_LOSS_TOL and all(np.isfinite(r["losses"])),
                 f"{tag} rank {rank}: losses {r['losses']} vs "
                 f"{s['losses']}")
            comm_s, calls, sent = r["comm"]
            log(f"  {tag} {configs.get(arch).name} {n} layer(s), rank "
                f"{rank}: losses " + " ".join(f"{x:.6f}" for x in
                                              r["losses"])
                + " vs one process " + " ".join(f"{x:.6f}" for x in
                                                s["losses"])
                + f" (step 1 rel {rel:.3g}); aux {r['aux'][0]:.6f} vs "
                f"{s['aux'][0]:.6f}; step {r['wall']:.2f}s vs "
                f"{s['wall']:.2f}s one process, collectives {comm_s:.2f}s "
                f"in {calls} calls, {sent / 1e9:.2f} GB sent")
    for (n, k, m), rec in per_rank[0]["timed"].items():
        log(f"  #1 at rank 0's ({n}, {k}) M {m}: rel {rec['rel_err']:.3g}, "
            f"{rec['ms']:.4f} ms (bound {rec['bound_ms']:.4f}, plain "
            f"{rec['plain_ms']:.4f}, matmul {rec['library_ms']:.4f}) "
            f"[{CARD[0]}]")
    if failed:
        raise AssertionError("phase F: " + "; ".join(failed))
    total = {}
    for res in per_rank:
        for kk, c in res["counts"].items():
            total[kk] = total.get(kk, 0) + c
    return total, per_rank[0]["timed"]


PHASES = (
    ("a", dict(n_layers=2, dtype=torch.bfloat16, cr=0.5, pattern=None,
               variant="slab-ell", kernel="slab_ell_matmul", tol=3e-2,
               profiled=True,
               focus=("#1 slab_ell_matmul",
                      "ell_split_kernel<unsigned short, false, true"))),
    ("b", dict(n_layers=2, dtype=torch.bfloat16, cr=0.5, pattern="2:4",
               variant="slab-nm", kernel="slab_nm_matmul", tol=3e-2,
               profiled=True,
               focus=("#2 slab_nm_matmul", "NmSrc<2, 4>, 1, false, true>"))),
    ("c", dict(n_layers=2, dtype=torch.bfloat16, cr=0.2, pattern=None,
               variant="slab-dense", kernel="slab_matmul", tol=3e-2,
               profiled=True,
               focus=("#3 slab_matmul", "tc_bin_kernel<tc::DenseSrc"))),
    ("d", dict(n_layers=2, dtype=torch.float32, cr=0.5, pattern=None,
               variant="slab-ell", kernel="slab_ell_matmul@ell.cu",
               tol=1e-4)),
    ("e", dict(n_layers=2, dtype=torch.bfloat16, cr=0.5, pattern="2:4",
               variant="sparse-nm", kernel="nm_matmul", tol=3e-2,
               method="wanda", options={}, ppl=True, profiled=True,
               focus=("#8 nm_matmul", "tc_nm_kernel<tc::NmSrc<2, 4>"))),
    ("f", dict(n_layers=1, dtype=torch.bfloat16, cr=0.6, pattern=None,
               variant="sparse-ell", kernel="ell_matmul", tol=3e-2,
               method="sparsegpt", options={}, ppl=True, profiled=True,
               focus=("#4 ell_matmul", ELL4_SPLIT),
               note="CR 0.6, not 0.5: at CR 0.5 and bf16 a pruner's "
                    "K_max is D_in/2, ELL does not win on bytes, the "
                    "linears pack as sparse-dense (a plain matmul) and "
                    "no kernel runs")),
    ("g", dict(n_layers=2, dtype=torch.bfloat16, cr=0.5, pattern=None,
               variant="lowrank-ell", kernel="ell_lr_matmul", tol=3e-2,
               options=dict(iters=8, include_binary=False), ppl=True,
               profiled=True,
               focus=("#5 ell_lr_matmul",
                      "ell_split_kernel<unsigned short, true, false"))),
    ("h", dict(n_layers=2, dtype=torch.bfloat16, cr=0.4, pattern=None,
               variant="lowrank-dense", kernel="slab_lr_matmul", tol=3e-2,
               options=dict(iters=8, include_binary=False), ppl=True,
               profiled=True, focus=("#6 slab_lr_matmul", LR6))),
    ("i", dict(n_layers=2, dtype=torch.bfloat16, cr=0.5, pattern="2:4",
               variant="lowrank-nm", kernel="slab_nm_lr_matmul", tol=3e-2,
               options=dict(iters=8, include_binary=False), ppl=True,
               profiled=True,
               focus=("#7 slab_nm_lr_matmul",
                      "tc_nm_kernel<tc::NmSrc<2, 4>"))),
    ("j", dict(n_layers=2, dtype=torch.bfloat16, cr=0.5, pattern=None,
               variant="binlr", kernel="binlr_matmul", tol=3e-2,
               zero_ws=True, profiled=True, focus=("#9 binlr_matmul", BIN9),
               note="phase a's slab decompositions with W_S := 0, served "
                    "as W_L ⊙ W_B; logits against that dense-equivalent")),
    # phi3.5-moe: attention through the per-linear kernel, every expert
    # leaf through its grouped kernel; 1 layer, so that the yardstick's
    # expert choices equal the packed model's bit for bit
    # (_hold_moe_logits)
    # (its decode steps give 2 rows per expert: the first design of #14)
    ("m", dict(arch="phi3_5_moe", n_layers=1, dtype=torch.bfloat16, cr=0.5,
               pattern=None, variant="slab-ell", kernel="slab_ell_matmul",
               expert_kernel="slab_ell_matmul_g@ell.cu", tol=3e-2,
               profiled=True)),
    ("n", dict(arch="phi3_5_moe", n_layers=1, dtype=torch.bfloat16, cr=0.5,
               pattern="2:4", variant="slab-nm", kernel="slab_nm_matmul",
               expert_kernel="slab_nm_matmul_g", tol=3e-2, profiled=True,
               focus=("#17 slab_nm_matmul_g", "tc_g_kernel<tc::NmSrc<2, 4>"))),
    ("o", dict(arch="phi3_5_moe", n_layers=1, dtype=torch.bfloat16, cr=0.2,
               pattern=None, variant="slab-dense", kernel="slab_matmul",
               expert_kernel="slab_matmul_g", tol=3e-2, profiled=True,
               focus=("#16 slab_matmul_g", "tc_g_kernel<tc::DenseSrc"))),
    ("p", dict(arch="phi3_5_moe", n_layers=1, dtype=torch.bfloat16, cr=0.5,
               pattern="2:4", variant="sparse-nm", kernel="nm_matmul",
               expert_kernel="nm_matmul_g", tol=3e-2, method="wanda",
               options={}, profiled=True,
               focus=(("#15 nm_matmul_g", NM15),
                      ("#8 nm_matmul", "tc_nm_kernel<tc::NmSrc<2, 4>")))),
    # deepseek-moe-16b (64 experts, top-6, shared experts): attention and
    # the shared MLP through the per-linear kernel, every routed expert
    # leaf through its grouped kernel; 1 layer (_hold_moe_logits). At 6
    # rows per expert, #14 (r), #12 (s), #13 (t) and #19 (v) run
    # grouped_tc.cu's kernels.
    ("r", dict(arch="deepseek_moe_16b", n_layers=1, dtype=torch.bfloat16,
               cr=0.5, pattern=None, variant="slab-ell",
               kernel="slab_ell_matmul", expert_kernel="slab_ell_matmul_g",
               tol=3e-2, profiled=True)),
    ("s", dict(arch="deepseek_moe_16b", n_layers=1, dtype=torch.bfloat16,
               cr=0.6, pattern=None, variant="sparse-ell",
               kernel="ell_matmul", expert_kernel="ell_matmul_g", tol=3e-2,
               method="sparsegpt", options={}, profiled=True,
               focus=(("#12 ell_matmul_g", ELL12),
                      ("#4 ell_matmul", ELL4_SPLIT)),
               note="CR 0.6, not 0.5: at CR 0.5 and bf16 a pruner's K_max "
                    "is D_in/2 and ELL does not win on bytes")),
    ("t", dict(arch="deepseek_moe_16b", n_layers=1, dtype=torch.bfloat16,
               cr=0.5, pattern=None, variant="lowrank-ell",
               kernel="ell_lr_matmul", expert_kernel="ell_lr_matmul_g",
               tol=3e-2, options=dict(iters=8, include_binary=False),
               profiled=True)),
    ("u", dict(arch="deepseek_moe_16b", n_layers=1, dtype=torch.bfloat16,
               cr=0.4, pattern=None, variant="lowrank-dense",
               kernel="slab_lr_matmul", expert_kernel="slab_lr_matmul_g",
               tol=3e-2, options=dict(iters=8, include_binary=False),
               profiled=True,
               focus=(("#18 slab_lr_matmul_g", "tc_kernel<tc::DenseSrc"),
                      ("#6 slab_lr_matmul", LR6)))),
    ("v", dict(arch="deepseek_moe_16b", n_layers=1, dtype=torch.bfloat16,
               cr=0.5, pattern="2:4", variant="lowrank-nm",
               kernel="slab_nm_lr_matmul",
               expert_kernel="slab_nm_lr_matmul_g", tol=3e-2,
               options=dict(iters=8, include_binary=False), profiled=True)),
    ("w", dict(arch="deepseek_moe_16b", n_layers=1, dtype=torch.bfloat16,
               cr=0.5, pattern=None, variant="binlr", kernel="binlr_matmul",
               expert_kernel="binlr_matmul_g", tol=3e-2, zero_ws=True,
               profiled=True,
               focus=(("#20 binlr_matmul_g", "tc_g_kernel<tc::NoSrc"),
                      ("#9 binlr_matmul", BIN9)),
               note="phase r's slab decompositions with W_S := 0, served "
                    "as W_L ⊙ W_B")),
)
# the timed case of each kernel that the JSON line reports, by C name:
# both libraries of #1-#8 (ell_matmul and ell_matmul@ell.cu, ...) report
# the same case, each with its own time (LIB_TIMED: the case's "libs")
JSON_LABEL = {"slab_ell_matmul": "slab_ell_matmul",
              "slab_nm_matmul": "slab_nm_matmul[2:4]",
              "slab_matmul": "slab_matmul", "ell_matmul": "ell_matmul",
              "ell_lr_matmul": "ell_lr_matmul",
              "slab_lr_matmul": "slab_lr_matmul",
              "slab_nm_lr_matmul": "slab_nm_lr_matmul[2:4]",
              "nm_matmul": "nm_matmul[2:4]", "binlr_matmul": "binlr_matmul"}
# ... and of each grouped kernel's library, by counter key: the G_SPECS
# model and the timed case (at that model's first shape). #14's first
# design reports phi3.5-moe at M 2, where its decode runs it; #12's, #13's
# and #19's their f32 launches; #15's, #16's, #17's, #18's and #20's (and
# #1's-#9's, above) each library at the timed case (LIB_TIMED: the case's
# "libs").
G_JSON = {"slab_ell_matmul_g": ("deepseek-moe-16b", "slab_ell_matmul_g"),
          "slab_ell_matmul_g@ell.cu": ("phi3.5-moe", "slab_ell_matmul_g"),
          "nm_matmul_g": ("phi3.5-moe", "nm_matmul_g[2:4]"),
          "nm_matmul_g@nm_sparse.cu": ("phi3.5-moe", "nm_matmul_g[2:4]"),
          "slab_matmul_g": ("phi3.5-moe", "slab_matmul_g"),
          "slab_matmul_g@slab_matmul.cu": ("phi3.5-moe", "slab_matmul_g"),
          "slab_nm_matmul_g": ("phi3.5-moe", "slab_nm_matmul_g[2:4]"),
          "slab_nm_matmul_g@slab_matmul.cu": ("phi3.5-moe",
                                              "slab_nm_matmul_g[2:4]"),
          "ell_matmul_g": ("deepseek-moe-16b", "ell_matmul_g"),
          "ell_matmul_g@ell.cu": ("deepseek-moe-16b", "ell_matmul_g f32"),
          "ell_lr_matmul_g": ("deepseek-moe-16b", "ell_lr_matmul_g"),
          "ell_lr_matmul_g@ell.cu": ("deepseek-moe-16b",
                                     "ell_lr_matmul_g f32"),
          "slab_lr_matmul_g": ("deepseek-moe-16b", "slab_lr_matmul_g"),
          "slab_lr_matmul_g@slab_matmul.cu": ("deepseek-moe-16b",
                                              "slab_lr_matmul_g"),
          "slab_nm_lr_matmul_g": ("deepseek-moe-16b",
                                  "slab_nm_lr_matmul_g[2:4]"),
          "slab_nm_lr_matmul_g@slab_matmul.cu": (
              "deepseek-moe-16b", "slab_nm_lr_matmul_g[2:4] f32"),
          "binlr_matmul_g": ("deepseek-moe-16b", "binlr_matmul_g"),
          "binlr_matmul_g@slab_matmul.cu": ("deepseek-moe-16b",
                                            "binlr_matmul_g")}
FLASH = ("flash_decode", "flash_decode_paged")


def main():
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 3
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()

    seconds, last = {}, [t_start]

    def mark(label):
        now = time.monotonic()
        seconds[label] = round(now - last[0], 1)
        last[0] = now

    card = environment(ahead=compress_ahead)
    mark("build")
    from repro_torch.kernels import ops
    timed, worst = kernel_checks()
    mark("kernels")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    nm_sweep(flush)
    mark("per-linear sweep")
    fd_timed, fd_worst = flash_checks(flush)
    mark("flash")
    g_timed, g_worst = {}, {}
    for model in G_SPECS:
        t, w = grouped_checks(flush, model)
        g_timed[model], g_worst[model] = t, w
        mark(f"grouped {model}")
    ssm_timed = ssm_shape_checks(flush)
    mark("#1 SSM shapes")
    va_timed, va_prefill = va_shape_checks(flush)
    mark("#1 vlm / audio shapes")
    del flush
    launches = {k.key: 0 for k in ops.KERNELS}
    for tag, kw in PHASES:
        for kname, c in model_phase(tag, **kw).items():
            launches[kname] += c
        mark(tag)
    for kname, c in engine_phase_k().items():
        launches[kname] += c
    mark("k")
    counts_l, engine_l = engine_phase_l()
    for kname, c in counts_l.items():
        launches[kname] += c
    mark("l")
    for tag, arch in (("q", "phi3_5_moe"), ("x", "deepseek_moe_16b")):
        for kname, c in moe_engine_phase(tag, arch).items():
            launches[kname] += c
        mark(tag)
    for tag, phase in (("y", plan_phase_y), ("z", budget_phase_z),
                       ("slab_linear_kernel", slab_linear_kernel_check),
                       ("T", train_phase),
                       ("S", lambda: ssm_phase("S", "mamba2_1_3b", S_LAYERS,
                                               "*=slab", deep_tol=0.07)),
                       ("S f32", lambda: ssm_phase(
                           "S f32", "mamba2_1_3b", 2, "*=slab",
                           dtype=torch.float32)),
                       ("H", lambda: ssm_phase("H", "zamba2_7b", 12, "*=slab",
                                               deep_tol=0.04)),
                       ("V", lambda: vlm_phase("V", V_LAYERS,
                                               deep_tol=V_DEEP_TOL)),
                       ("V f32", lambda: vlm_phase("V f32", 2,
                                                   dtype=torch.float32)),
                       ("A", lambda: audio_phase("A", A_LAYERS,
                                                 deep_tol=A_DEEP_TOL)),
                       ("A f32", lambda: audio_phase("A f32", 2,
                                                     dtype=torch.float32))):
        if tag == "slab_linear_kernel":
            log("slab_linear_kernel: the SLaBPacked entry point")
        for kname, c in phase().items():
            launches[kname] += c
        mark(tag)
    counts_m, tp_timed = mesh_phase()
    for kname, c in counts_m.items():
        launches[kname] += c
    mark("M")
    ddp_train_phase()
    mark("P")
    counts_f, f_timed = families_phase()
    for kname, c in counts_f.items():
        launches[kname] += c
    mark("F")

    def by_lib(rec, key):
        """The record with the library ``key``'s own time where it was
        timed alone (LIB_TIMED)."""
        lib = rec.get("libs", {}).get(key)
        return {**rec, **lib} if lib else rec

    entries = []
    for kern in ops.KERNELS:
        if kern.key in G_JSON:
            model, label = G_JSON[kern.key]
            spec = G_SPECS[model]
            rec = by_lib(g_timed[model][(label,) + spec["shapes"][0]],
                         kern.key)
            entries.append({
                "name": kern.name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{kern.source}",
                "replaces": kern.replaces.split(" ")[0],
                "launches": launches[kern.key], "counter": kern.key,
                **{kk: rec[kk] for kk in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")},
                "shape": {"model": model, "E": spec["experts"],
                          "M": rec["m"], "N": spec["shapes"][0][0],
                          "K": spec["shapes"][0][1], "dtype": rec["dtype"],
                          "rank": 1},
                "worst_rel_err": g_worst[model][label.split(" ")[0]],
                "by_shape": {f"{n}x{k}": {
                    kk: by_lib(g_timed[model][(label, n, k)], kern.key)[kk]
                    for kk in ("ms", "plain_ms", "library_ms", "bound_ms")}
                    for (n, k) in spec["shapes"]}})
            continue
        if kern.name in FLASH:
            rec = fd_timed[(kern.name, FD_TIMED["layout"], FD_MAX)]
            entries.append({
                "name": kern.name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{kern.source}",
                "replaces": kern.replaces.split(" ")[0],
                "launches": launches[kern.name],
                **{kk: rec[kk] for kk in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms", "shape")},
                "worst_rel_err": fd_worst,
                "by_shape": {f"{layout} S={s}": {
                    kk: fd_timed[(kern.name, layout, s)][kk]
                    for kk in ("ms", "plain_ms", "library_ms", "bound_ms")}
                    for layout, s in FD_TIMES}})
            continue
        label = JSON_LABEL[kern.name]
        rec = by_lib(timed[(label,) + JSON_SHAPE], kern.key)
        by_shape = {f"{n}x{k}": {
            kk: by_lib(timed[(label, n, k)], kern.key)[kk]
            for kk in ("ms", "plain_ms", "library_ms", "bound_ms")}
            for (n, k) in SHAPES}
        if kern.key == "slab_ell_matmul":
            # phase M's rank-0 local shapes (row-sharded over model 2)
            by_shape.update({f"{n}x{k} TP rank 0": {
                kk: r[kk] for kk in ("ms", "plain_ms", "library_ms",
                                     "bound_ms")}
                for (n, k), r in tp_timed.items()})
            # phase F's rank-0 local shapes (the families under (1, 2))
            by_shape.update({f"{n}x{k} F rank 0"
                             + (f" M={m}" if m != 4 else ""): {
                kk: r[kk] for kk in ("ms", "plain_ms", "library_ms",
                                     "bound_ms")}
                for (n, k, m), r in f_timed.items()})
        if kern.name == "slab_ell_matmul":
            # null where the wrapper never picks this library (grouped_tc.cu
            # at K 14336); the vlm / audio shapes at M 4, the encoder's
            # also at its prefill's M
            by_shape.update({f"{n}x{k}" + (f" M={m}" if m != 4 else ""): {
                kk: by_lib(r, kern.key)[kk]
                for kk in ("ms", "plain_ms", "library_ms", "bound_ms")}
                if kern.key in r["libs"] else None
                for m, recs in ((4, ssm_timed), (4, va_timed),
                                (PREFILL_M, va_prefill))
                for (n, k), r in recs.items()})
        entries.append({
            "name": kern.name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{kern.source}",
            "replaces": kern.replaces.split(" ")[0],
            "launches": launches[kern.key], "counter": kern.key,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "shape": {"M": TIMED["m"], "N": JSON_SHAPE[0],
                      "K": JSON_SHAPE[1], "dtype": "bfloat16", "rank": 1},
            "worst_rel_err": worst[label], "by_shape": by_shape})
    log(f"engine (phase l): {json.dumps(engine_l)}")
    log(f"seconds per phase: {json.dumps(seconds)}")
    log(f"card: {card}; total {time.monotonic() - t_start:.1f}s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
