"""The rank side of ``tests/test_torch_mesh_families.py``: run in processes
spawned by ``repro_torch.runtime.mesh.spawn``, it imports the port only
(no JAX, no reference package). Every case of one mesh shape runs in one
process group; the results travel back pickled as numpy arrays."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.packed_model import pack_model
from repro_torch.launch.serve import greedy_decode, place_params
from repro_torch.models import lm
from repro_torch.models.common import positions_for
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.elastic import place_train_state
from repro_torch.runtime.mesh import make_mesh
from repro_torch.runtime.meshctx import batch_rows, use_mesh
from repro_torch.runtime.sharding import PackPlacer, Planner, gather_shards
from repro_torch.runtime.step import make_prefill_fn, make_train_fn
from repro_torch.tree import leaves_with_path

STEP_REMAT = "nothing"


def case_cfg(case: dict):
    return configs.get(case["arch"], smoke=True).with_(
        dtype=torch.float32, **case.get("over", {}))


def as_numpy(tree) -> dict:
    """{path: array} of every leaf of a whole tree."""
    return {"/".join(p): t.detach().cpu().numpy().copy()
            for p, t in leaves_with_path(tree)}


def packed(case: dict, place=None):
    """The case's model: its dense-equivalent weights packed by its plan
    (each leaf placed as it is packed, with ``place``), or as they are."""
    if case.get("decs") is None:
        return case["dense"]
    params, _ = pack_model(case["dense"], case["decs"], plan=case["plan"],
                           dtype=torch.float32, place=place)
    return params


def decode_logits(cfg, params, tokens: np.ndarray) -> np.ndarray:
    """Teacher-forced ``decode_step`` logits (B, S, V) over ``tokens``."""
    b, s = tokens.shape
    toks = torch.from_numpy(tokens).long()
    cache = lm.init_cache(cfg, b, s, device="cpu")
    out = []
    for t in range(s):
        logits, cache = lm.decode_step(cfg, params, cache, toks[:, t:t + 1],
                                       positions_for(cfg, b, 1, offset=t))
        out.append(logits[:, 0])
    return torch.stack(out, 1).numpy()


def serve(cfg, params, case) -> dict:
    """Greedy tokens (square and ragged), teacher-forced logits and the
    Mamba cache's shapes (on a mesh: this rank's part of the cache of
    this rank's rows)."""
    res = {"tokens": greedy_decode(cfg, params, case["prompts"],
                                   case["gen_len"], device="cpu").numpy(),
           "ragged": greedy_decode(cfg, params, case["prompts"],
                                   case["gen_len"], lengths=case["lengths"],
                                   device="cpu").numpy(),
           "logits": decode_logits(cfg, params, case["teacher"])}
    b = case["prompts"].shape[0]
    rows = batch_rows(cfg, b)
    cache = lm.init_cache(cfg, b if rows is None else rows[1] - rows[0],
                          case["teacher"].shape[1], device="cpu")
    res["mamba"] = {k: tuple(v.shape) for k, v in
                    cache.mamba[0]._asdict().items()}
    if cache.shared_kv:
        res["shared_kv"] = tuple(cache.shared_kv[0].k.shape)
    return res


def train_step(cfg, batch, mesh=None, seed: int = 0) -> dict:
    """One ``make_train_fn`` step (remat "nothing", one microbatch) from
    ``lm.init(cfg, seed)``, on one process or on ``mesh``: the loss, aux
    and grad norm, and the whole state after the step (its first moments
    are the clipped gradients times 1 - beta1)."""
    acfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = lm.init(cfg, seed=seed, device="cpu")
    state = {"params": params, "opt": adamw_init(params, acfg)}
    planner = None
    if mesh is not None:
        planner = Planner(mesh, cfg)
        state = place_train_state(state, cfg, acfg, mesh)
    step = make_train_fn(cfg, acfg, 1, STEP_REMAT, planner=planner)
    p, o, m = step(state["params"], state["opt"], batch)
    whole = {"params": p, "opt": o}
    if mesh is not None:
        whole = gather_shards(whole, mesh)
    return {"loss": float(m["loss"]), "aux": float(m["aux"]),
            "grad_norm": float(m["grad_norm"]), "state": as_numpy(whole)}


def run_cases(rank, world, dev, data, model, cases):
    torch.manual_seed(0)
    mesh = make_mesh(data, model, dev)
    out = {}
    for name, case in cases.items():
        cfg = case_cfg(case)
        if case["kind"] == "step":
            out[name] = train_step(cfg, case["batch"], mesh)
            continue
        planner = Planner(mesh, cfg)
        placer = PackPlacer(planner, mesh)
        params = place_params(cfg, packed(case, placer), placer)
        if case["kind"] == "prefill":
            out[name] = {"logits": make_prefill_fn(cfg, planner)(
                params, torch.from_numpy(case["frames"])).numpy()}
            continue
        with use_mesh(mesh):
            out[name] = serve(cfg, params, case)
    return out
