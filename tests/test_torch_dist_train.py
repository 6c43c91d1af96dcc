"""The port's distributed training runtime on the CPU, against the
reference and against its own single-device step:

- ``runtime.specs`` in process: global shapes, dtypes and specs of
  ``abstract_params`` / ``abstract_opt_state`` / ``batch_specs`` /
  ``decode_specs`` equal the reference's on
  ``jax.sharding.AbstractMesh`` (meshes (2, 4) and (1, 2), every config
  at full width; the reference's "layers" lead dropped, as the port keeps
  one leaf per layer);
- ``runtime.ddp`` against the reference on 2 fake CPU devices (one
  subprocess, ``XLA_FLAGS=--xla_force_host_platform_device_count=2``):
  ``_compressed_allreduce_mean``'s int8 payload, mean and error buffer
  bit for bit on fixed per-rank f32 inputs (3, 5) and (64, 129);
  ``build_compressed_ddp_step`` for 3 steps on bridged llama2_7b SMOKE
  f32 params (batch 8 x 64): losses at rel < 1e-4 with and without
  compression, params within 1e-4 (uncompressed) and 1e-3 (compressed,
  where a rounding flip moves single elements) norm-relative; the
  reference's own "learns" (8 steps: the loss falls, the error buffers
  are not zero) and "close" (4 steps: within 5 %) checks on the port
  alone;
- ``make_train_fn(planner=...)`` (microbatches 2, remat "nothing", f32)
  against the port's single-device step: llama2_7b SMOKE on (2, 1) and
  (1, 2), qwen2_vl_2b SMOKE (embeddings and M-RoPE positions split over
  "data") and a loss mask uneven over the ranks on (2, 1), loss and
  grad_norm at rel < 1e-5 and every
  assembled param and moment leaf within 1e-5 norm-relative; a moe
  config equal to the single device on (2, 1) and (1, 2); dense leaves
  held at their specs' shares (over "model" too);
- elastic restore: a commit made on (2, 1) after 2 steps, restored on
  (1, 2) (each rank's local shapes as the placement gives them) and in
  one process, bitwise equal to the state the ranks assembled; the
  reference's ``elastic_restore`` on a (1, 1) mesh reads it bitwise too;
- ``launch.train --data-par 2`` under torchrun, committing, then
  ``--model-par 2 --restore``: the loss lines of the single-process CLI,
  printed by rank 0 alone.

The processes: one gloo group per mesh shape, (2, 1) then (1, 2), each
with its own timeout and one torch thread a rank
(``tests/torch_train_worker.py`` on the rank side).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import torch_train_worker as worker
from repro import configs as ref_configs
from repro.checkpoint import CheckpointManager as RefManager
from repro.models import lm as ref_lm
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.runtime import elastic as ref_elastic
from repro.runtime import specs as ref_specs
from repro.runtime.sharding import Planner as RefPlanner
from repro_torch import bridge, configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticCorpus
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import specs
from repro_torch.runtime.elastic import elastic_restore, train_state_specs
from repro_torch.runtime.mesh import make_test_mesh, spawn
from repro_torch.runtime.meshctx import Shard
from repro_torch.runtime.sharding import Planner
from repro_torch.tree import leaves_with_path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(ref_configs.ARCH_IDS) + ["llama2_7b"]
GROUP_TIMEOUT = 240.0
REF_TIMEOUT = 300.0
STEP_ACFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)
DDP_ACFG = dict(lr=1e-3, warmup_steps=1)
ALLREDUCE_SHAPES = ((3, 5), (64, 129))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _norm_rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _hold_states(got: dict, want: dict, tol: float, what: str):
    assert got.keys() == want.keys(), what
    for k in want:
        assert got[k].shape == want[k].shape, (what, k)
        assert _norm_rel(got[k], want[k]) < tol, (what, k)


def _equal_states(got: dict, want: dict, what: str):
    assert got.keys() == want.keys(), what
    for k in want:
        assert got[k].dtype == want[k].dtype, (what, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


# ------------------------------------------------------------------ specs

def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def _ref_leaves(tree) -> dict:
    """{path: (shape, dtype name, spec)} of a reference abstract tree,
    the "layers" lead dropped (shape and spec)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(_key(k) for k in path)
        shape, spec = tuple(leaf.shape), tuple(leaf.sharding.spec)
        spec = spec + (None,) * (len(shape) - len(spec))
        if "layers" in keys or keys[:1] in (("kv",), ("mamba",),
                                           ("shared_kv",)):
            shape, spec = shape[1:], spec[1:]
        out[tuple(k for k in keys if k != "layers")] = (
            shape, jnp.dtype(leaf.dtype).name, spec)
    return out


def _port_leaves(tree, cache=False) -> dict:
    """{path: (shape, dtype name, spec)} of a port abstract tree, one
    entry per path with the layer (or cache invocation) index dropped,
    every layer checked alike."""
    out = {}
    for path, leaf in leaves_with_path(tree):
        if not isinstance(leaf, Shard):
            continue
        assert leaf.local.device.type == "meta"
        keys = tuple(k for i, k in enumerate(path)
                     if not (k.isdigit() and (cache or path[i - 1]
                                              == "layers")))
        keys = tuple(k for k in keys if k != "layers")
        entry = (leaf.shape, str(leaf.dtype).replace("torch.", ""),
                 leaf.spec)
        assert out.setdefault(keys, entry) == entry, keys
    return out


def _hold_local(tree, mesh):
    for _, leaf in leaves_with_path(tree):
        if isinstance(leaf, Shard):
            want = tuple(n // mesh.n(() if e is None else
                                     (e if isinstance(e, tuple) else (e,)))
                         for n, e in zip(leaf.shape, leaf.spec))
            assert tuple(leaf.local.shape) == want


@pytest.mark.parametrize("mesh", ["2x4", "1x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_reference(arch, mesh):
    data, model = map(int, mesh.split("x"))
    cfg_r, cfg = ref_configs.get(arch), configs.get(arch)
    rp = RefPlanner(AbstractMesh((data, model), ("data", "model")), cfg_r)
    pm = make_test_mesh(data, model)
    pp = Planner(pm, cfg)

    got, _ = specs.abstract_params(cfg, pp)
    want, _ = ref_specs.abstract_params(cfg_r, rp)
    assert _port_leaves(got) == _ref_leaves(want)
    _hold_local(got, pm)
    got = specs.abstract_opt_state(cfg, pp, AdamWConfig())[0]
    want = ref_specs.abstract_opt_state(cfg_r, rp, RefAdamWConfig())[0]
    assert _port_leaves(got) == _ref_leaves(want)
    for shape in (ref_configs.SHAPES["train_4k"],
                  ref_configs.ShapeSpec("odd", "train", 64, 3)):
        port_shape = configs.ShapeSpec(shape.name, shape.kind,
                                       shape.seq_len, shape.global_batch)
        got = specs.batch_specs(cfg, port_shape, pp)
        want = ref_specs.batch_specs(cfg_r, shape, rp)
        assert _port_leaves(got) == _ref_leaves(want)
    if cfg.family == "audio":           # encoder-only: no decode cell
        return
    shape = ref_configs.ShapeSpec("dec", "decode", 4096, 8)
    port_shape = configs.ShapeSpec("dec", "decode", 4096, 8)
    cache, tok, pos = specs.decode_specs(cfg, port_shape, pp)
    rcache, rtok, rpos = ref_specs.decode_specs(cfg_r, shape, rp)
    assert _port_leaves({"t": tok, "p": pos}) == _ref_leaves(
        {"t": rtok, "p": rpos})
    rc = {k: v for k, v in rcache._asdict().items() if v is not None}
    want = {k: v for k, v in _ref_leaves(rc).items() if k[-1] != "length"}
    if isinstance(cache, list):
        assert all(c.length == 4096 for c in cache)
        got = _port_leaves({"kv": cache}, cache=True)
    else:
        got = _port_leaves({"mamba": cache.mamba,
                            "shared_kv": cache.shared_kv}, cache=True)
    assert got == want
    _hold_local(cache, pm)


# ------------------------------------------------------------- processes

REF_DDP = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro import configs
    from repro.models import lm
    from repro.optim.adamw import AdamWConfig, adamw_init
    from repro.optim.compress import int8_compress
    from repro.runtime import ddp

    d = np.load(sys.argv[1])
    out = {}
    mesh = jax.make_mesh((2,), ("data",))

    def local(g, e):
        mean, err = ddp._compressed_allreduce_mean(g[0], e[0], 2)
        return mean[None], err[None]

    f = jax.jit(shard_map(local, mesh=mesh, in_specs=(P("data"), P("data")),
                          out_specs=(P("data"), P("data")), check_rep=False))
    for i in range(int(d["n_inputs"])):
        g, e = d[f"g{i}"], d[f"e{i}"]
        mean, err = f(jnp.asarray(g), jnp.asarray(e))
        out[f"mean{i}"], out[f"err{i}"] = np.asarray(mean), np.asarray(err)
        out[f"q{i}"] = np.stack([np.asarray(int8_compress(
            jnp.asarray(g[r]) + jnp.asarray(e[r]))[0]) for r in range(2)])
    cfg = configs.get("llama2_7b", smoke=True).with_(dtype=jnp.float32)
    acfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    params0, _ = lm.init(cfg, jax.random.PRNGKey(0))
    for compress in (True, False):
        p = params0
        opt, err = adamw_init(p, acfg), ddp.init_error_buffers(p)
        step = ddp.build_compressed_ddp_step(cfg, acfg, mesh,
                                             compress=compress)
        losses = []
        for s in range(int(d["n_steps"])):
            batch = {"inputs": jnp.asarray(d[f"in{s}"]),
                     "labels": jnp.asarray(d[f"lab{s}"])}
            p, opt, err, m = step(p, opt, err, batch)
            losses.append(float(m["loss"]))
        out[f"losses_{compress}"] = np.asarray(losses)
        for j, leaf in enumerate(jax.tree.leaves(p)):
            out[f"p_{compress}_{j}"] = np.asarray(leaf)
    np.savez(sys.argv[2], **out)
    print("REF_DDP_OK")
""")


def _allreduce_inputs():
    rng = np.random.default_rng(11)
    return [(rng.standard_normal((2,) + s).astype(np.float32),
             (rng.standard_normal((2,) + s) * 0.01).astype(np.float32))
            for s in ALLREDUCE_SHAPES]


def _ref_params_llama():
    cfg_r = ref_configs.get("llama2_7b", smoke=True).with_(
        dtype=jnp.float32)
    params, _ = ref_lm.init(cfg_r, jax.random.PRNGKey(0))
    return cfg_r, jax.tree.map(np.asarray, params)


def _start_reference(tmp, inputs, batches):
    feed = {"n_inputs": len(inputs), "n_steps": len(batches)}
    for i, (g, e) in enumerate(inputs):
        feed[f"g{i}"], feed[f"e{i}"] = g, e
    for s, b in enumerate(batches):
        feed[f"in{s}"], feed[f"lab{s}"] = b["inputs"], b["labels"]
    np.savez(tmp / "feed.npz", **feed)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    return subprocess.Popen(
        [sys.executable, "-c", REF_DDP, str(tmp / "feed.npz"),
         str(tmp / "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _vlm_batches(cfg, n):
    """Embeddings and (t, h, w) ids of one layout in every row (rows of
    different layouts, whose mask reads the global batch's first row on
    every rank, are held in ``tests/test_torch_mesh_families.py``)."""
    rng = np.random.default_rng(5)
    corpus = SyntheticCorpus(cfg.vocab, seed=0)
    out = []
    for s in range(n):
        b = corpus.batch(s, 8, 32)
        b["inputs"] = rng.standard_normal((8, 32, cfg.d_model),
                                          dtype=np.float32)
        grid = np.cumsum(rng.integers(0, 2, (32, 3)), axis=0)
        b["positions"] = np.broadcast_to(grid, (8, 32, 3)).astype(np.int32)
        out.append(b)
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's DDP subprocess beside the port's two process
    groups, (2, 1) then (1, 2); the single-device yardsticks."""
    tmp = tmp_path_factory.mktemp("dist_train")
    llama = worker.smoke_cfg("llama2_7b")
    corpus = SyntheticCorpus(llama.vocab, seed=0)
    ddp_batches = [corpus.batch(s, 8, 64) for s in range(3)]
    inputs = _allreduce_inputs()
    ref = _start_reference(tmp, inputs, ddp_batches)
    try:
        cfg_r, ref_params = _ref_params_llama()
        step_batches = [corpus.batch(s, 8, 64) for s in range(2)]
        vlm_batches = _vlm_batches(worker.smoke_cfg("qwen2_vl_2b"), 2)
        moe_batches = [SyntheticCorpus(256, seed=0).batch(s, 8, 32)
                       for s in range(2)]
        # a loss mask with more tokens in rank 0's rows than in rank 1's
        masked = [dict(b, mask=(np.arange(64)[None, :] < np.array(
            [64, 50, 40, 64, 10, 3, 30, 0])[:, None]).astype(np.float32))
            for b in step_batches]
        commit = str(tmp / "commit")
        step = lambda arch, b, **kw: {"kind": "step", "arch": arch,
                                      "acfg": STEP_ACFG, "batches": b, **kw}
        cases_21 = {
            "allreduce": {"kind": "allreduce", "inputs": inputs},
            "ddp": {"kind": "ddp", "acfg": DDP_ACFG,
                    "params": bridge.params(ref_params, llama.n_layers,
                                            device="cpu"),
                    "batches": ddp_batches,
                    "learn_batches": [corpus.batch(s, 16, 64)
                                      for s in range(8)]},
            "llama": step("llama2_7b", step_batches, commit=commit),
            "vlm": step("qwen2_vl_2b", vlm_batches),
            "masked": step("llama2_7b", masked),
            "moe": step("phi3_5_moe", moe_batches)}
        cases_12 = {"llama": step("llama2_7b", step_batches),
                    "moe": step("phi3_5_moe", moe_batches),
                    "restore": {"kind": "restore", "arch": "llama2_7b",
                                "acfg": STEP_ACFG, "commit": commit}}
        per_mesh = {}
        for (data, model), cases in (((2, 1), cases_21), ((1, 2), cases_12)):
            per_mesh[(data, model)] = spawn(
                worker.run_cases, 2, "cpu", str(tmp / f"pg{data}{model}"),
                args=(data, model, cases), timeout=GROUP_TIMEOUT, threads=1)
        single = {}
        for name, arch, b in (("llama", "llama2_7b", step_batches),
                              ("vlm", "qwen2_vl_2b", vlm_batches),
                              ("masked", "llama2_7b", masked),
                              ("moe", "phi3_5_moe", moe_batches)):
            losses, norms, whole, _ = worker.run_steps(
                worker.smoke_cfg(arch), AdamWConfig(**STEP_ACFG), b)
            single[name] = {"losses": losses, "norms": norms,
                            "state": worker.as_numpy(whole)}
        out, err = ref.communicate(timeout=REF_TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "REF_DDP_OK" in out, err[-4000:]
    return {"mesh": per_mesh, "single": single, "commit": commit,
            "ref": dict(np.load(tmp / "ref.npz")), "cfg_r": cfg_r,
            "ref_params": ref_params, "inputs": inputs}


def test_compressed_allreduce_bitwise_equal_reference(runs):
    """The int8 payload bit for bit. XLA's CPU compiler contracts two
    multiply-adds into fused ones (one rounding) where the port rounds
    the product and the sum apart: the error buffer g32 - q·scale, held
    within one f32 rounding of the product, and the dequantized sum of
    the ranks' shards, whose last bit moves the requantization's scale:
    the mean held within 2^-22 relative (one rounding of that scale)."""
    ref = runs["ref"]
    for i, _ in enumerate(ALLREDUCE_SHAPES):
        g, e = runs["inputs"][i]
        for r, res in enumerate(runs["mesh"][(2, 1)]):
            got = res["allreduce"][i]
            np.testing.assert_array_equal(got["q"], ref[f"q{i}"][r])
            np.testing.assert_allclose(got["mean"], ref[f"mean{i}"][r],
                                       rtol=2.0 ** -22, atol=0)
            ulp = float(np.spacing(np.abs(g[r] + e[r]).max()))
            assert np.abs(got["err"] - ref[f"err{i}"][r]).max() <= ulp
        means = [res["allreduce"][i]["mean"] for res in runs["mesh"][(2, 1)]]
        np.testing.assert_array_equal(means[0], means[1])
        g, e = runs["inputs"][i]
        assert _rel(means[0], (g + e).mean(0)) < 0.05     # ~2 quanta


def _ref_tree(runs, compress):
    leaves = [runs["ref"][f"p_{compress}_{j}"] for j in
              range(len(jax.tree.leaves(runs["ref_params"])))]
    tree = jax.tree.unflatten(jax.tree.structure(runs["ref_params"]),
                              leaves)
    return worker.as_numpy(bridge.params(
        tree, runs["cfg_r"].n_layers, device="cpu"))


@pytest.mark.parametrize("compress,param_tol", [(True, 1e-3), (False, 1e-4)])
def test_ddp_step_matches_reference(runs, compress, param_tol):
    ref = runs["ref"][f"losses_{compress}"]
    for res in runs["mesh"][(2, 1)]:
        got = res["ddp"][f"parity_{compress}"]
        assert len(got["losses"]) == len(ref)
        for a, b in zip(got["losses"], ref):
            assert _rel(a, b) < 1e-4, (got["losses"], ref)
        _hold_states(got["params"], _ref_tree(runs, compress), param_tol,
                     f"ddp compress={compress}")
    a, b = (res["ddp"][f"parity_{compress}"]["params"]
            for res in runs["mesh"][(2, 1)])
    _equal_states(a, b, "ranks' replicated params")


def test_ddp_compressed_sends_a_quarter_of_the_bytes(runs):
    """int8 shards out, int8 shards back, against a ring's f32 all-reduce
    (the ``Mesh.comm_bytes`` model): ~4x fewer bytes a step."""
    res = runs["mesh"][(2, 1)][0]["ddp"]
    c, u = res["parity_True"]["sent"], res["parity_False"]["sent"]
    assert len(set(c)) == 1 and len(set(u)) == 1
    assert 3.5 < u[0] / c[0] < 4.1, (u, c)


def test_ddp_compressed_learns(runs):
    res = runs["mesh"][(2, 1)][0]["ddp"]["learns"]
    assert res["losses"][-1] < res["losses"][0], res["losses"]
    assert res["err_nonzero"]


def test_ddp_compressed_close_to_uncompressed(runs):
    res = runs["mesh"][(2, 1)][0]["ddp"]
    c, u = res["close_True"][-1], res["close_False"][-1]
    assert abs(c - u) / abs(u) < 0.05, (c, u)


def _held_step(runs, mesh, name):
    want = runs["single"][name]
    per_rank = runs["mesh"][mesh]
    for res in per_rank:
        got = res[name]
        for key in ("losses", "norms"):
            for a, b in zip(got[key], want[key], strict=True):
                assert _rel(a, b) < 1e-5, (key, got[key], want[key])
        _hold_states(got["state"], want["state"], 1e-5, f"{name} {mesh}")
    return per_rank


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)])
def test_parallel_step_matches_single_device(runs, mesh):
    per_rank = _held_step(runs, mesh, "llama")
    data, model = mesh
    for rank, res in enumerate(per_rank):
        local = res["llama"]["local"]
        if data > 1:                 # FSDP: a norm and a linear cut
            assert local["params/final_norm"] == (64,)
            assert local["opt/mu/layers/0/attn/wq"] == (64, 128)
        else:                        # heads and the vocab over "model"
            assert local["params/embed"] == (256, 128)
            assert local["params/layers/0/attn/wq"] == (128, 64)
            assert local["opt/nu/layers/0/mlp/w_down"] == (172, 128)


def test_parallel_step_vlm_on_mrope_positions(runs):
    _held_step(runs, (2, 1), "vlm")


def test_parallel_step_masked_loss_is_the_global_mean(runs):
    """A mask with more tokens in one rank's rows: the ranks' weighted
    losses and gradients give the microbatch's mean over its tokens."""
    _held_step(runs, (2, 1), "masked")


def test_moe_equal_over_data_and_over_model(runs):
    """phi3.5-moe trains over "data" (each rank its rows, routed by the
    global batch's groups: ``tests/test_torch_mesh_families.py`` holds
    the three group cases) and over "model" as on one device."""
    _held_step(runs, (2, 1), "moe")
    _held_step(runs, (1, 2), "moe")


def test_elastic_restore_across_mesh_shapes(runs):
    """Committed on (2, 1) after 2 steps: restored on (1, 2), in one
    process and by the reference, each bitwise equal to the state the
    (2, 1) ranks assembled."""
    assembled = runs["mesh"][(2, 1)][0]["llama"]["state"]
    cfg = worker.smoke_cfg("llama2_7b")
    acfg = AdamWConfig(**STEP_ACFG)
    for rank, res in enumerate(runs["mesh"][(1, 2)]):
        got = res["restore"]
        assert got["step"] == 2
        _equal_states(got["state"], assembled, f"(1, 2) rank {rank}")
        mesh = make_test_mesh(1, 2, rank=rank)
        want = {}
        specs_tree = train_state_specs(cfg, acfg, Planner(mesh, cfg))
        shapes = {k: v.shape for k, v in assembled.items()}
        for path, spec in _spec_leaves(specs_tree):
            want[path] = tuple(
                n // mesh.n(() if e is None else
                            (e if isinstance(e, tuple) else (e,)))
                for n, e in zip(shapes[path], spec))
        assert got["local"] == want
        assert got["local"]["params/embed"] == (256, 128)
    one = elastic_restore(CheckpointManager(runs["commit"]), cfg, acfg,
                          device="cpu")
    _equal_states(worker.as_numpy(one), assembled, "one process")
    cfg_r = runs["cfg_r"]
    st = ref_elastic.elastic_restore(
        RefManager(runs["commit"]), cfg_r, RefAdamWConfig(**STEP_ACFG),
        jax.make_mesh((1, 1), ("data", "model")))
    st = jax.tree.map(np.asarray, st)
    n = cfg_r.n_layers
    ref_state = {"params": bridge.params(st["params"], n, device="cpu"),
                 "opt": type(one["opt"])(
                     bridge.params(st["opt"].mu, n, device="cpu"),
                     bridge.params(st["opt"].nu, n, device="cpu"),
                     torch.from_numpy(st["opt"].count))}
    _equal_states(worker.as_numpy(ref_state), assembled, "the reference")


def _spec_leaves(tree, path=()):
    """(path, spec) of a specs tree (tuples of axis entries are leaves)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _spec_leaves(v, path + (f,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _torchrun(args, par):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *args,
         *par], capture_output=True, text=True, env=env,
        timeout=GROUP_TIMEOUT, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert "process group: backend gloo over 2 ranks (CPU tensors)" in lines
    d, m = (2, 1) if "--data-par" in par else (1, 2)
    assert (f"mesh: data={d} x model={m} over 2 ranks (backend gloo, "
            f"device cpu)") in lines
    return _loss_lines(lines)


def _loss_lines(lines):
    return [ln for ln in lines if ln.startswith(("step ", "restored "))]


def test_train_cli_data_then_model_parallel_under_torchrun(tmp_path,
                                                           capsys):
    """``launch.train --data-par 2`` under torchrun commits, and
    ``--model-par 2 --restore`` resumes that commit: each prints, on rank
    0 alone, the loss lines of the single-process CLI running the same
    command (the second on a copy of the same commit: SMOKE trains in
    bf16, where the ranks' bf16 gradients round apart from one process's
    after the first step)."""
    import shutil
    from repro_torch.launch.train import main
    args = ["--arch", "llama2_7b", "--device", "cpu", "--batch", "4",
            "--seq", "32", "--ckpt-every", "10", "--lr", "1e-3"]
    one, two, three = (str(tmp_path / n) for n in ("one", "two", "three"))
    main(args + ["--steps", "10", "--ckpt-dir", one])
    want = _loss_lines(capsys.readouterr().out.splitlines())
    assert _torchrun(args + ["--steps", "10", "--ckpt-dir", two],
                     ["--data-par", "2"]) == want == [want[0]]
    shutil.copytree(two, three)
    resume = ["--steps", "21", "--restore", "--ckpt-dir"]
    main(args + resume + [three])
    want = _loss_lines(capsys.readouterr().out.splitlines())
    assert [ln.split(" loss")[0] for ln in want] == [
        "restored step 10", "step    10", "step    20"]
    assert _torchrun(args + resume + [two], ["--model-par", "2"]) == want
