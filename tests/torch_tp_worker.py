"""The rank side of ``tests/test_torch_tp.py``: run in processes spawned by
``repro_torch.runtime.mesh.spawn``, it imports the port only (no JAX, no
reference package). Every case of one mesh shape runs in one process
group; the results travel back pickled as numpy arrays."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.packed_model import (ExpertPackedStack, PackedLinear,
                                           merge_packed_axes, pack_model)
from repro_torch.launch.serve import greedy_decode, place_params
from repro_torch.models import lm
from repro_torch.models.common import positions_for
from repro_torch.runtime.mesh import make_mesh
from repro_torch.runtime.meshctx import Shard, use_mesh
from repro_torch.runtime.sharding import (PackPlacer, Planner, packed_bytes,
                                          tree_shard, unshard)


def case_cfg(case: dict):
    return configs.get(case["arch"], smoke=True).with_(
        dtype=torch.float32, **case.get("over", {}))


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


def layouts(params) -> dict:
    """Per packed leaf, what this rank holds: for a PackedLinear (rows of
    its first plane, d_out, u's rows or None); for an expert stack, per
    group (members, experts held, rows held, d_out)."""
    out = {}
    for l, lp in enumerate(params["layers"]):
        for sub, d in lp.items():
            if not isinstance(d, dict):
                continue
            for name, w in d.items():
                if isinstance(w, dict):          # moe.shared
                    for n2, w2 in w.items():
                        if isinstance(w2, PackedLinear):
                            out[f"{l}/{sub}.{name}.{n2}"] = _pl(w2)
                elif isinstance(w, PackedLinear):
                    out[f"{l}/{sub}.{name}"] = _pl(w)
                elif isinstance(w, ExpertPackedStack):
                    out[f"{l}/{sub}.{name}"] = [
                        (len(m), _first(g).shape[0], _first(g).shape[1],
                         g.d_out) for m, g in zip(w.members, w.groups)]
    return out


def _first(w: PackedLinear) -> torch.Tensor:
    for a in (w.sparse_vals, w.sparse_idx, w.b_packed, w.u):
        if a is not None:
            return a


def _pl(w: PackedLinear):
    return (_first(w).shape[0], w.d_out,
            None if w.u is None else w.u.shape[0], w.variant, w.rank)


def dense_shards(tree, path="") -> list:
    """(path, spec) of every dense leaf this rank holds a shard of."""
    if isinstance(tree, Shard):
        return [(path, tree.spec)]
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in dense_shards(v, f"{path}{k}.")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in dense_shards(v, f"{path}{i}.")]
    return []


def dense_held(tree, path="") -> dict:
    """{path: (elements this rank holds, elements of the whole)} of every
    dense tensor of a placed params tree."""
    if isinstance(tree, Shard):
        return {path: (tree.local.numel(), int(np.prod(tree.shape)))}
    if isinstance(tree, torch.Tensor):
        return {path: (tree.numel(), tree.numel())}
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in dense_held(v, f"{path}{k}.").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in dense_held(v, f"{path}{i}.").items()}
    return {}


def run_engine(cfg, params, case, mesh):
    from repro_torch.serving import Engine, EngineConfig, Request
    ecfg = EngineConfig(**case["engine"])
    eng = Engine(cfg, params, ecfg, device="cpu", mesh=mesh)
    reqs = [Request(rid=i, prompt=p, max_new=n, arrival=a)
            for i, (p, n, a) in enumerate(case["requests"])]
    done = eng.run(reqs, clock="steps")
    return {"streams": [list(map(int, r.out)) for r in done],
            "statuses": [r.status for r in done],
            "free": eng.sched.alloc.n_free, "n_blocks": ecfg.n_blocks,
            "kv_local": tuple(eng.paged[0].k.shape),
            "kv_dtype": str(eng.paged[0].k.dtype)}


def _planes(tree):
    """Every tensor of a placed or whole params tree, in a fixed order
    (a Shard as its local slice)."""
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif isinstance(t, PackedLinear):
            walk([t.sparse_vals, t.sparse_idx, t.b_packed, t.u, t.v])
        elif isinstance(t, ExpertPackedStack):
            walk([t.groups, t.dense])
        elif isinstance(t, torch.Tensor):
            out.append(t)
        elif t is not None:
            out.append(t.local)              # a Shard
    walk(tree)
    return out


def placement_roundtrip(cfg, case, mesh, placed) -> dict:
    """The whole packed model cut by ``tree_shard`` equals what the
    PackPlacer placed while packing, leaf for leaf; ``unshard`` gathers it
    back bit for bit."""
    whole, _ = pack_model(case["dense"], case["decs"], plan=case["plan"],
                          dtype=torch.float32)
    specs = Planner(mesh, cfg).tree_specs(
        merge_packed_axes(lm.param_axes(cfg), whole), whole)
    local = tree_shard(whole, specs, mesh)
    back = unshard(local, specs, mesh)
    same = [torch.equal(a, b) for a, b in zip(_planes(local),
                                               _planes(placed))]
    exact = [torch.equal(a, b) for a, b in zip(_planes(back),
                                                _planes(whole))]
    return {"placed_equal": len(same) == len(_planes(placed)) and all(same),
            "unshard_exact": len(exact) == len(_planes(whole))
            and all(exact), "n": len(exact)}


def run_cases(rank, world, dev, data, model, cases):
    mesh = make_mesh(data, model, dev)
    out = {}
    for name, case in cases.items():
        cfg = case_cfg(case)
        placer = PackPlacer(Planner(mesh, cfg), mesh)
        params = case["dense"]
        if case["decs"] is not None:
            params, _ = pack_model(params, case["decs"], plan=case["plan"],
                                   dtype=torch.float32, place=placer)
        params = place_params(cfg, params, placer)
        res = {"layouts": layouts(params), "bytes": packed_bytes(params),
               "bytes_whole": placer.bytes_whole,
               "dense_shards": dense_shards(params),
               "dense_held": dense_held(params)}
        if name == "mixed":
            res["roundtrip"] = placement_roundtrip(cfg, case, mesh, params)
        with use_mesh(mesh):
            if "engine" in case:
                res |= run_engine(cfg, params, case, mesh)
            else:
                res["tokens"] = greedy_decode(
                    cfg, params, case["prompts"], case["gen_len"],
                    device="cpu").numpy()
                res["logits"] = decode_logits(cfg, params, case["teacher"])
                b, s = case["prompts"].shape
                cache = lm.init_cache(cfg, b, s + case["gen_len"],
                                      device="cpu")[0]
                res["cache"] = {"k": str(cache.k.dtype),
                                "seq_lo": cache.seq_lo,
                                "positions": cache.k.shape[1]}
        out[name] = res
    return out
