"""The rank side of ``tests/test_torch_dist_train.py``: run in processes
spawned by ``repro_torch.runtime.mesh.spawn``, it imports the port only
(no JAX, no reference package). Every case of one mesh shape runs in one
process group; the results travel back pickled as numpy arrays."""
from __future__ import annotations

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.compress import int8_compress
from repro_torch.runtime import ddp
from repro_torch.runtime.elastic import elastic_restore, place_train_state
from repro_torch.runtime.mesh import make_mesh
from repro_torch.runtime.meshctx import Shard
from repro_torch.runtime.sharding import Planner, gather_shards
from repro_torch.runtime.step import make_train_fn
from repro_torch.tree import leaves_with_path, tree_map

STEP_MB, STEP_REMAT = 2, "nothing"


def smoke_cfg(arch: str):
    return configs.get(arch, smoke=True).with_(dtype=torch.float32)


def as_numpy(tree) -> dict:
    """{path: array} of every leaf of a whole tree."""
    return {"/".join(p): t.detach().cpu().numpy().copy()
            for p, t in leaves_with_path(tree)}


def local_shapes(tree) -> dict:
    """{path: this rank's shape} of a placed tree (a Shard's local)."""
    return {"/".join(p): tuple((t.local if isinstance(t, Shard) else t).shape)
            for p, t in leaves_with_path(tree)}


def run_steps(cfg, acfg, batches, mesh=None, seed=0):
    """``make_train_fn`` (microbatches 2, remat "nothing") over
    ``batches`` from ``lm.init(cfg, seed)``, on one process or on
    ``mesh``: (losses, grad norms, the whole final state, the placed
    state or None)."""
    params = lm.init(cfg, seed=seed, device="cpu")
    state = {"params": params, "opt": adamw_init(params, acfg)}
    planner = None
    if mesh is not None:
        planner = Planner(mesh, cfg)
        state = place_train_state(state, cfg, acfg, mesh)
    step = make_train_fn(cfg, acfg, STEP_MB, STEP_REMAT, planner=planner)
    losses, norms = [], []
    p, o = state["params"], state["opt"]
    for b in batches:
        p, o, m = step(p, o, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    placed = {"params": p, "opt": o}
    whole = placed if mesh is None else gather_shards(placed, mesh)
    return losses, norms, whole, (placed if mesh is not None else None)


def _allreduce_case(mesh, case):
    r = mesh.index(("data",))
    out = []
    for g_all, e_all in case["inputs"]:
        g = torch.from_numpy(g_all[r])
        e = torch.from_numpy(e_all[r])
        q, _ = int8_compress(g.float() + e)
        mean, err = ddp._compressed_allreduce_mean(g, e, mesh)
        out.append({"q": q.numpy(), "mean": mean.numpy(),
                    "err": err.numpy()})
    return out


def _ddp_run(mesh, cfg, acfg, params, batches, compress, timed=False):
    params = tree_map(lambda t: t.clone(), params)
    opt = adamw_init(params, acfg)
    err = ddp.init_error_buffers(params)
    step = ddp.build_compressed_ddp_step(cfg, acfg, mesh, compress=compress)
    losses, sent = [], []
    for b in batches:
        mesh.timed, mesh.comm_bytes = timed, 0
        params, opt, err, m = step(params, opt, err, b)
        sent.append(mesh.comm_bytes)
        losses.append(float(m["loss"]))
    mesh.timed = False
    nonzero = any(bool(e.abs().max() > 0)
                  for _, e in leaves_with_path(err))
    return {"losses": losses, "params": as_numpy(params),
            "err_nonzero": nonzero, "sent": sent}


def _ddp_cases(mesh, case):
    cfg = smoke_cfg("llama2_7b")
    out = {}
    acfg = AdamWConfig(**case["acfg"])
    for compress in (True, False):
        out[f"parity_{compress}"] = _ddp_run(
            mesh, cfg, acfg, case["params"], case["batches"], compress,
            timed=True)
    params = lm.init(cfg, seed=0, device="cpu")
    out["learns"] = _ddp_run(mesh, cfg, AdamWConfig(lr=3e-3, warmup_steps=1),
                             params, case["learn_batches"], True)
    for compress in (True, False):
        out[f"close_{compress}"] = _ddp_run(
            mesh, cfg, AdamWConfig(lr=1e-3, warmup_steps=1), params,
            case["learn_batches"][:4], compress)["losses"]
    return out


def _step_case(mesh, case):
    cfg = smoke_cfg(case["arch"])
    acfg = AdamWConfig(**case["acfg"])
    try:
        losses, norms, whole, placed = run_steps(cfg, acfg, case["batches"],
                                                 mesh)
    except ValueError as e:
        return {"refused": str(e)}
    res = {"losses": losses, "norms": norms, "state": as_numpy(whole),
           "local": local_shapes(placed)}
    if "commit" in case:
        mgr = CheckpointManager(case["commit"], mesh=mesh)
        mgr.save(len(case["batches"]), placed)
        mgr.wait()
    return res


def _restore_case(mesh, case):
    cfg = smoke_cfg(case["arch"])
    acfg = AdamWConfig(**case["acfg"])
    mgr = CheckpointManager(case["commit"], mesh=mesh)
    placed = elastic_restore(mgr, cfg, acfg, device="cpu", mesh=mesh)
    return {"step": mgr.latest_step(), "local": local_shapes(placed),
            "state": as_numpy(gather_shards(placed, mesh))}


RUNNERS = {"allreduce": _allreduce_case, "ddp": _ddp_cases,
           "step": _step_case, "restore": _restore_case}


def run_cases(rank, world, dev, data, model, cases):
    torch.manual_seed(0)
    mesh = make_mesh(data, model, dev)
    return {name: RUNNERS[case["kind"]](mesh, case)
            for name, case in cases.items()}
