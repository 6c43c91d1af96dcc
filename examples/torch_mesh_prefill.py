"""The audio encoder's prefill on a (data, model) mesh (PyTorch port):
hubert-xlarge (SMOKE unless ``--full``) with random weights from a seed,
placed on each rank's shards by the sharding planner, its non-causal
encoder run tensor-parallel on frame embeddings
(``runtime.step.make_prefill_fn(cfg, planner)``), and the logits held
against the same prefill in one process.

    PYTHONPATH=src OMP_NUM_THREADS=1 python -m torch.distributed.run \\
        --standalone --nproc-per-node 2 examples/torch_mesh_prefill.py \\
        --mesh 1,2 --device cpu

It runs on the CUDA card unless ``--device cpu`` is given; rank 0 alone
prints.
"""
import argparse
import contextlib
import io

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.launch.serve import place_params
from repro_torch.models import lm
from repro_torch.runtime.mesh import init_from_env, make_mesh
from repro_torch.runtime.sharding import PackPlacer, Planner, dense_bytes
from repro_torch.runtime.step import make_prefill_fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="hubert_xlarge")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--mesh", default="1,2", metavar="DATA,MODEL")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    data, model = (int(x) for x in args.mesh.split(","))
    dev = init_from_env(resolve_device(args.device))
    mesh = make_mesh(data, model, dev)
    cfg = configs.get(args.arch, smoke=not args.full).with_(
        dtype=torch.float32)
    params = lm.init(cfg, seed=0, device=dev)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (args.batch, args.frames, cfg.d_model), dtype=np.float32)).to(dev)
    want = make_prefill_fn(cfg)(params, x)          # one process's
    planner = Planner(mesh, cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        placed = place_params(cfg, params, PackPlacer(planner, mesh))
    got = make_prefill_fn(cfg, planner)(placed, x)
    rel = float((got - want).abs().max() / want.abs().max())
    held, whole = dense_bytes(placed)
    if mesh.rank == 0:
        print(f"mesh: data={data} x model={model}; {cfg.name} prefill "
              f"{tuple(got.shape)} on {args.batch} x {args.frames} frames; "
              f"dense leaves held {held / 1e6:.2f} of {whole / 1e6:.2f} MB "
              f"a rank; logits rel {rel:.2e} to one process")
    torch.distributed.destroy_process_group()
    if not rel < 1e-5:
        raise SystemExit(f"prefill under the mesh differs: rel {rel}")


if __name__ == "__main__":
    main()
