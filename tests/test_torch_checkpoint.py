"""The port's checkpoints, supervisor and train launcher on the CPU:

- a tree of f32, bf16, int32 and scalar leaves saved by the reference's
  ``save_pytree`` loads bitwise in the port, and the reverse (one format:
  a ``.npy`` per leaf, ``manifest.json``, bf16 as raw bytes);
- the port's versions of the reference's checkpoint and fault tests
  (``tests/test_substrates.py``): atomic commits, the async writer,
  restore-and-replay, giving up after ``max_restarts``, stragglers;
- ``launch.train`` on llama2_7b SMOKE for 6 steps with a failure
  injected at step 3 ends bitwise equal to an uninterrupted run, and
  ``restore=True`` resumes from the last commit.
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as ref_load
from repro.checkpoint import save_pytree as ref_save
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.launch.train import train
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.elastic import elastic_restore, train_state_template
from repro_torch.runtime.fault import FaultConfig, Supervisor
from repro_torch.tree import tree_leaves

RNG = np.random.default_rng(0)
F32 = RNG.standard_normal((3, 4)).astype(np.float32)
BF16_BITS = RNG.integers(-(1 << 15), 1 << 15, (2, 5)).astype(np.int16)
I32 = RNG.integers(-1000, 1000, (6,)).astype(np.int32)


def _ref_tree():
    import ml_dtypes
    return {"a": jnp.asarray(F32),
            "b": {"c": jnp.asarray(BF16_BITS.view(ml_dtypes.bfloat16)),
                  "d": jnp.asarray(I32),
                  "s": jnp.asarray(7, jnp.int32)},
            "list": [jnp.asarray(2.5, jnp.float32), jnp.asarray(F32[0])]}


def _port_tree():
    return {"a": torch.from_numpy(F32.copy()),
            "b": {"c": torch.from_numpy(BF16_BITS.copy()).view(
                torch.bfloat16),
                "d": torch.from_numpy(I32.copy()),
                "s": torch.tensor(7, dtype=torch.int32)},
            "list": [torch.tensor(2.5), torch.from_numpy(F32[0].copy())]}


def _bits(a) -> np.ndarray:
    """The raw bytes of a leaf of either package."""
    if torch.is_tensor(a):
        t = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return t.numpy().reshape(-1).view(np.uint8)
    return np.asarray(a).reshape(-1).view(np.uint8)


def _dtype(a) -> str:
    return str(a.dtype).replace("torch.", "")


def test_reference_checkpoint_loads_bitwise_in_the_port(tmp_path):
    ref_save(_ref_tree(), str(tmp_path / "ck"))
    got = load_pytree(_port_tree(), str(tmp_path / "ck"), device="cpu")
    for a, b in zip(tree_leaves(got), jax.tree.leaves(_ref_tree())):
        assert _dtype(a) == _dtype(b) and tuple(a.shape) == b.shape
        assert np.array_equal(_bits(a), _bits(b))


def test_port_checkpoint_loads_bitwise_in_the_reference(tmp_path):
    save_pytree(_port_tree(), str(tmp_path / "ck"))
    got = ref_load(_ref_tree(), str(tmp_path / "ck"))
    for a, b in zip(jax.tree.leaves(got), tree_leaves(_port_tree())):
        assert _dtype(a) == _dtype(b) and a.shape == tuple(b.shape)
        assert np.array_equal(_bits(a), _bits(b))
    # the same file names and manifest as the reference's own save
    ref_save(_ref_tree(), str(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "ck")) == \
        sorted(os.listdir(tmp_path / "ref"))


def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(2, dtype=torch.bfloat16),
                  "d": torch.tensor(3, dtype=torch.int32)}}


def test_save_load_roundtrip(tmp_path):
    save_pytree(_tree(), str(tmp_path / "ck"))
    out = load_pytree(_tree(), str(tmp_path / "ck"), device="cpu")
    for a, b in zip(tree_leaves(_tree()), tree_leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_atomic_commit_no_partial_state(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    mgr.save(1, _tree())
    mgr.save(2, _tree())
    mgr.save(3, _tree())
    assert mgr.steps() == [2, 3]          # keep=2 removed step 1
    assert mgr.latest_step() == 3
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_async_writer(tmp_path):
    """The writer serializes a host copy taken at save(): writing into
    the tensors after save() returns does not reach the commit."""
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    t = _tree()
    mgr.save(5, t)
    t["a"].add_(100.0)
    mgr.wait()
    assert mgr.latest_step() == 5
    out = mgr.restore(_tree(), device="cpu")
    assert torch.equal(out["a"], _tree()["a"])


def test_restore_refuses_the_cpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, _tree())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mgr.restore(_tree())


def test_supervisor_restores_and_replays(tmp_path):
    """A failure mid-run: the supervisor restores the last commit and
    reaches the state of an uninterrupted run."""
    def run(fail_at):
        mgr = CheckpointManager(str(tmp_path / f"f{fail_at}"),
                                async_write=False)
        failed = {"done": False}

        def step_fn(state, step):
            return {"x": state["x"] + step}, {"loss": float(state["x"])}

        def fail_hook(step):
            if fail_at is not None and step == fail_at and not failed["done"]:
                failed["done"] = True
                return True
            return False

        sup = Supervisor(mgr, FaultConfig(ckpt_every=4, max_restarts=2),
                         failure_hook=fail_hook)
        out = sup.run({"x": torch.zeros(())}, 0, 10, step_fn,
                      restore_fn=lambda s: mgr.restore(
                          {"x": torch.zeros(())}, device="cpu"))
        return float(out["x"]), sup.stats.restarts

    clean, r0 = run(None)
    faulty, r1 = run(6)
    assert r0 == 0 and r1 == 1
    assert clean == faulty == float(sum(range(10)))


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(0, {"x": torch.zeros(())})
    sup = Supervisor(mgr, FaultConfig(ckpt_every=100, max_restarts=1),
                     failure_hook=lambda s: True)   # always failing
    with pytest.raises(RuntimeError):
        sup.run({"x": torch.zeros(())}, 0, 5, lambda st, s: (st, {}),
                restore_fn=lambda s: mgr.restore({"x": torch.zeros(())},
                                                 device="cpu"))


def test_straggler_detection():
    class NoopMgr:
        def wait(self):
            pass

        def save(self, *a):
            pass

    sup = Supervisor(NoopMgr(), FaultConfig(ckpt_every=1000,
                                            straggler_factor=3.0))

    def step_fn(state, step):
        time.sleep(0.05 if step == 8 else 0.002)
        return state, {}

    sup.run({}, 0, 12, step_fn, restore_fn=lambda s: {})
    assert sup.stats.stragglers >= 1


# ------------------------------------------------------------------
# the launcher: replay after an injected failure, resume
# ------------------------------------------------------------------

TRAIN = dict(arch="llama2_7b", smoke=True, batch=2, seq=16, ckpt_every=2,
             device="cpu", log_every=100)


def test_train_replay_is_bitwise_and_restore_resumes(tmp_path, capsys):
    clean, l_clean = train(steps=6, ckpt_dir=str(tmp_path / "a"), **TRAIN)
    faulty, l_faulty = train(steps=6, ckpt_dir=str(tmp_path / "b"),
                             inject_failure_at=3, **TRAIN)
    assert "restarts=1" in capsys.readouterr().out
    # steps 0-2, the failure at 3, the replay of 2-5 from the step-2 commit
    assert l_faulty[:3] == l_clean[:3] and l_faulty[3:] == l_clean[2:]
    for a, b in zip(tree_leaves(clean["params"]) + tree_leaves(clean["opt"]),
                    tree_leaves(faulty["params"]) + tree_leaves(faulty["opt"])):
        assert torch.equal(a, b)
    # the last commit (step 6) holds the final state; --restore resumes it
    cfg = configs.get("llama2_7b", smoke=True)
    acfg = AdamWConfig(lr=3e-4, total_steps=6, warmup_steps=1)
    mgr = CheckpointManager(str(tmp_path / "a"))
    assert mgr.steps() == [4, 6]
    st = elastic_restore(mgr, cfg, acfg, device="cpu")
    for a, b in zip(tree_leaves(st), tree_leaves({"params": clean["params"],
                                                  "opt": clean["opt"]})):
        assert a.dtype == b.dtype and torch.equal(a, b)
    tpl = train_state_template(cfg, acfg)
    assert all(t.device.type == "meta" for t in tree_leaves(tpl))
    assert sum(t.numel() for t in tree_leaves(tpl["params"])) == \
        lm.param_count(cfg)
    resumed, l_res = train(steps=8, ckpt_dir=str(tmp_path / "a"),
                           restore=True, **TRAIN)
    assert "restored step 6" in capsys.readouterr().out
    assert len(l_res) == 2 and all(np.isfinite(l_res))
    assert int(resumed["opt"].count) == 8


def test_train_refuses_the_cpu_unless_asked_and_the_mesh(monkeypatch,
                                                         capsys):
    """A mesh the launch cannot run is a usage error before any process
    group starts: a world size other than DATA x MODEL, for the moe
    family with "data" > 1 too (which trains over "data" under
    torchrun)."""
    from repro_torch.launch.train import main
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit):
        main(["--data-par", "2", "--device", "cpu"])
    err = capsys.readouterr().err
    assert "needs 2 ranks, launched with 1" in err
    assert "torch.distributed.run" in err
    with pytest.raises(SystemExit):
        main(["--arch", "phi3_5_moe", "--data-par", "2", "--device", "cpu"])
    err = capsys.readouterr().err
    assert "needs 2 ranks, launched with 1" in err and "A7b" not in err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train("llama2_7b", True, 1, 2, 8, None)
