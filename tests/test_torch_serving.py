"""The port's continuous-batching engine against the reference on the
CPU: the host-side allocator, scheduler and fault plans give equal
results on identical call sequences; ``paged_decode_step`` matches the
reference's over scattered physical blocks (f32 logits rel < 1e-4,
model-dtype and int8 caches); engine traces are token-exact against the
port's ``greedy_decode`` (mixed arrivals, evictions, a packed 2:4 model,
int8 KV, chaos seed 0 with no block leak), and one trace equals the
reference engine's per request.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import lm as ref_lm
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import FaultPlan as RefFaultPlan
from repro.serving import Request as RefRequest
from repro.serving import Scheduler as RefScheduler
from repro.serving import init_paged_cache as ref_init_paged_cache
from repro.serving.paged_cache import BlockAllocator as RefAllocator
from repro_torch import bridge, configs
from repro_torch.core.packed_model import pack_model
from repro_torch.core.pipeline import compress_model
from repro_torch.core.plan import plan_for_method
from repro_torch.core.slab import SLaBConfig
from repro_torch.data import calibration_batch
from repro_torch.launch.serve import greedy_decode
from repro_torch.models import lm
from repro_torch.serving import (BlockAllocator, Engine, EngineConfig,
                                 FaultEvent, FaultPlan, Request, Scheduler,
                                 init_paged_cache)
from repro_torch.serving.paged_cache import paged_write


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several worker
    processes at once, and oversubscribed torch threads slow these
    small CPU models by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------ host-side units

def test_allocator_matches_reference_call_for_call():
    ops = [("alloc", 3), ("reserve", 2), ("alloc", 4), ("free", 0),
           ("alloc", 2), ("release", 1), ("reserve", 9), ("alloc", 1),
           ("free", 1), ("release", None), ("alloc", 5), ("free", 1)]
    a, r = BlockAllocator(9), RefAllocator(9)
    held_a, held_r = [], []
    for op, arg in ops:
        if op == "free":
            ga, gr = held_a.pop(arg), held_r.pop(arg)
            a.free(ga)
            r.free(gr)
        else:
            ga, gr = getattr(a, op)(arg), getattr(r, op)(arg)
            assert ga == gr, (op, arg)
            if op == "alloc" and ga is not None:
                held_a.append(ga)
                held_r.append(gr)
        assert (a.n_free, a.n_reserved) == (r.n_free, r.n_reserved)
        assert a._free == r._free and a._reserved == r._reserved
    a.free(held_a[0])
    with pytest.raises(ValueError, match="double free"):
        a.free(held_a[0])
    with pytest.raises(ValueError, match="out-of-range"):
        a.free([9])


def _sched_state(s):
    return ({row: (sl.req.rid, list(sl.blocks), sl.n_prefilled, sl.phase,
                   sl.next_token) for row, sl in s.slots.items()},
            s.block_table.tolist(), s.lengths.tolist(),
            [q.rid for q in s.waiting], [q.rid for q in s.pending],
            s.n_evictions, s.alloc.n_free)


SCHED_CASES = {
    # name: (scheduler kwargs, (p_len, max_new, arrival, deadline) specs)
    "lifo-eviction": (dict(n_slots=3, n_blocks=6, block_size=4, max_len=24,
                           prefill_chunk=4),
                      [(8, 6, 0.0, None), (6, 7, 1.0, None),
                       (7, 5, 1.0, None), (5, 4, 2.0, None)]),
    "shed-reject": (dict(n_slots=1, n_blocks=8, block_size=4, max_len=16,
                         prefill_chunk=4, max_waiting=1),
                    [(4, 3, 0.0, None), (4, 3, 0.0, None),
                     (4, 3, 1.0, None), (4, 3, 1.0, None)]),
    "shed-oldest": (dict(n_slots=1, n_blocks=8, block_size=4, max_len=16,
                         prefill_chunk=4, max_waiting=1,
                         shed="evict-oldest-waiting"),
                    [(4, 3, 0.0, None), (4, 3, 0.0, None),
                     (4, 3, 1.0, None)]),
    "deadlines": (dict(n_slots=2, n_blocks=8, block_size=4, max_len=16,
                       prefill_chunk=4),
                  [(6, 6, 0.0, 3.0), (5, 3, 0.0, None), (4, 8, 1.0, 2.0),
                   (30, 3, 0.0, None)]),
}


@pytest.mark.parametrize("case", list(SCHED_CASES))
def test_scheduler_matches_reference_step_for_step(case):
    """Admission order, chunked prefill, LIFO eviction with replay,
    shedding, deadlines and rejection: the port's scheduler and the
    reference's, fed the same calls and the same sampled tokens, keep
    equal state after every call."""
    kw, specs = SCHED_CASES[case]
    s, r = Scheduler(**kw), RefScheduler(**kw)
    reqs, refs = [], []
    for i, (p, n, a, d) in enumerate(specs):
        prompt = np.arange(1, p + 1, dtype=np.int32) + i
        reqs.append(Request(rid=i, prompt=prompt, max_new=n, arrival=a,
                            deadline=d))
        refs.append(RefRequest(rid=i, prompt=prompt, max_new=n, arrival=a,
                               deadline=d))
        assert s.submit(reqs[-1]) == r.submit(refs[-1])
    rng = np.random.default_rng(0)
    for now in range(40):
        assert [q.rid for q in s.expire(float(now))] == \
            [q.rid for q in r.expire(float(now))]
        assert s.admit(float(now)) == r.admit(float(now))
        plan_s, plan_r = s.plan_step(), r.plan_step()
        assert (plan_s is None) == (plan_r is None)
        if plan_s is not None:
            for x, y in zip(plan_s, plan_r):
                np.testing.assert_array_equal(x, y)
            sampled = rng.integers(0, 100, size=kw["n_slots"])
            done_s = s.commit_step(plan_s[1], sampled, float(now) + 0.5)
            done_r = r.commit_step(plan_r[1], sampled, float(now) + 0.5)
            assert [q.rid for q in done_s] == [q.rid for q in done_r]
        assert _sched_state(s) == _sched_state(r), now
        assert s.diagnose_stall() == r.diagnose_stall()
    for a, b in zip(reqs, refs):
        assert (a.status, a.out, a.error, a.ttft, a.finish, a.n_evictions) \
            == (b.status, b.out, b.error, b.ttft, b.finish, b.n_evictions)
    statuses = {a.status for a in reqs}
    assert {"lifo-eviction": s.n_evictions > 0,
            "shed-reject": "shed" in statuses,
            "shed-oldest": "shed" in statuses,
            "deadlines": {"timeout", "rejected"} <= statuses}[case]


@pytest.mark.parametrize("seed", range(5))
def test_fault_plan_chaos_equals_reference(seed):
    a = FaultPlan.chaos(seed, vocab=512, n_rows=4, horizon=24)
    b = RefFaultPlan.chaos(seed, vocab=512, n_rows=4, horizon=24)
    assert [dataclasses.astuple(e) for e in a.events] == \
        [dataclasses.astuple(e) for e in b.events]
    assert a.events == FaultPlan.chaos(seed, vocab=512, n_rows=4,
                                       horizon=24).events
    assert repr(a) == repr(b)


def test_paged_write_masks_inactive_rows_in_place():
    pool = torch.zeros(4, 2, 3, 8)
    new = torch.ones(3, 8)
    out = paged_write(pool, torch.stack([new, new * 5]),
                      block_ids=torch.tensor([1, 1]),
                      offsets=torch.tensor([0, 0]),
                      active=torch.tensor([True, False]))
    assert out is pool                       # in place
    assert torch.equal(pool[1, 0], new)      # the inactive row's 5s nowhere
    assert float(pool.abs().sum()) == float(new.sum())


def test_init_paged_cache_rejects_cacheless_families():
    cfg = configs.get("llama2_7b", smoke=True).with_(family="ssm")
    with pytest.raises(ValueError):
        init_paged_cache(cfg, 8, 16, device="cpu")
    cfg8 = configs.get("llama2_7b", smoke=True).with_(kv_quant="int8")
    pools = init_paged_cache(cfg8, 8, 16, device="cpu")
    assert len(pools) == cfg8.n_layers
    assert pools[0].k.dtype == torch.int8 and pools[0].k_scale.shape == (
        8, 16, cfg8.n_kv)


# ------------------------------------------------ model: paged decoding

@pytest.fixture(scope="module")
def llama():
    """llama2_7b SMOKE at f32: the reference's params and the port's
    bridged copy."""
    cfg_r = ref_configs.get("llama2_7b", smoke=True).with_(
        dtype=jnp.float32)
    cfg = configs.get("llama2_7b", smoke=True).with_(dtype=torch.float32)
    params_r, _ = ref_lm.init(cfg_r, jax.random.PRNGKey(0))
    params = bridge.params(jax.tree.map(np.asarray, params_r), cfg.n_layers, device="cpu")
    return cfg_r, cfg, params_r, params


_ref_paged_step = jax.jit(ref_lm.paged_decode_step, static_argnums=0)


@pytest.mark.parametrize("quant", [False, True], ids=("model", "int8"))
def test_paged_decode_step_matches_reference(llama, quant):
    """6 steps over scattered physical blocks, one row idle from step 3:
    logits against the reference's paged step and against the port's
    own contiguous ``decode_step``; the pools end equal."""
    cfg_r, cfg, params_r, params = llama
    if quant:
        cfg_r, cfg = cfg_r.with_(kv_quant="int8"), cfg.with_(kv_quant="int8")
    b, n_blocks, bs = 3, 16, 4
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, size=(b, 6)).astype(np.int32)
    bt = np.zeros((b, 4), np.int32)
    bt[:, :2] = rng.permutation(n_blocks)[:b * 2].reshape(b, 2)
    paged_r = ref_init_paged_cache(cfg_r, n_blocks, bs)
    paged = init_paged_cache(cfg, n_blocks, bs, device="cpu")
    cache = lm.init_cache(cfg, b, 8, device="cpu")
    lengths = np.zeros((b,), np.int32)
    from repro_torch.models.common import positions_for
    for step in range(6):
        active = np.array([True, True, step < 3])
        lr, paged_r = _ref_paged_step(
            cfg_r, params_r, paged_r, jnp.asarray(bt),
            jnp.asarray(lengths), jnp.asarray(toks[:, step:step + 1]),
            jnp.asarray(active))
        lp, paged = lm.paged_decode_step(
            cfg, params, paged, torch.from_numpy(bt),
            torch.from_numpy(lengths), torch.from_numpy(toks[:, step:step + 1]),
            torch.from_numpy(active))
        ld, cache = lm.decode_step(
            cfg, params, cache, torch.from_numpy(toks[:, step:step + 1]),
            positions_for(cfg, b, 1, offset=step))
        assert _rel(lp[:2], np.asarray(lr)[:2]) < 1e-4, step
        assert _rel(lp[:2, 0], ld[:2, -1]) < 1e-4, step
        lengths = lengths + active
    ref_pools = bridge.paged_kv_cache(jax.tree.map(np.asarray, paged_r), device="cpu")
    for mine, theirs in zip(paged, ref_pools):
        if quant:
            assert (mine.k != theirs.k).float().mean() < 1e-3
            torch.testing.assert_close(mine.k_scale, theirs.k_scale,
                                       rtol=1e-5, atol=1e-8)
        else:
            torch.testing.assert_close(mine.k, theirs.k, rtol=1e-4,
                                       atol=1e-5)
            torch.testing.assert_close(mine.v, theirs.v, rtol=1e-4,
                                       atol=1e-5)


_ref_decode = jax.jit(ref_lm.decode_step, static_argnums=0)


def test_int8_decode_step_matches_reference(llama):
    """The contiguous int8 cache (greedy_decode's, the engine's oracle):
    the reference's arithmetic — scales folded into the scores and the
    probabilities — gives logits within rel 1e-4 of the reference's over
    6 steps, and the bridged reference cache equals the port's."""
    cfg_r, cfg, params_r, params = llama
    cfg_r, cfg = cfg_r.with_(kv_quant="int8"), cfg.with_(kv_quant="int8")
    b, s = 2, 6
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)
    cache_r = ref_lm.init_cache(cfg_r, b, s)
    cache = lm.init_cache(cfg, b, s, device="cpu")
    from repro.models.common import positions_for as ref_positions_for
    from repro_torch.models.common import positions_for
    for step in range(s):
        lr, cache_r = _ref_decode(cfg_r, params_r, cache_r,
                                  jnp.asarray(toks[:, step:step + 1]),
                                  ref_positions_for(cfg_r, b, 1, offset=step))
        lp, cache = lm.decode_step(cfg, params, cache,
                                   torch.from_numpy(toks[:, step:step + 1]),
                                   positions_for(cfg, b, 1, offset=step))
        assert _rel(lp, lr) < 1e-4, step
    bridged = bridge.kv_cache(jax.tree.map(np.asarray, cache_r.kv), device="cpu")
    for mine, theirs in zip(cache, bridged):
        assert mine.length == theirs.length == s
        assert mine.k.dtype == theirs.k.dtype == torch.int8
        assert (mine.k != theirs.k).float().mean() < 1e-3
        torch.testing.assert_close(mine.v_scale, theirs.v_scale, rtol=1e-5,
                                   atol=1e-8)


# ------------------------------------------ engine traces vs greedy_decode

@pytest.fixture
def make_engine():
    """Engine factory whose teardown runs the leak check on every engine
    a test built: all streams terminal, nothing reserved, every block
    back on the free list."""
    engines = []

    def factory(cfg, params, ecfg):
        eng = Engine(cfg, params, ecfg, device="cpu")
        engines.append(eng)
        return eng

    yield factory
    for eng in engines:
        assert not eng.sched.slots, "slots still occupied after trace"
        assert eng.sched.alloc.n_reserved == 0, "reserved blocks leaked"
        assert eng.sched.alloc.n_free == eng.ecfg.n_blocks, "block leak"


def _trace(cfg, specs, seed=0, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab, size=p,
                                           dtype=np.int64).astype(np.int32),
                max_new=n, arrival=a)
            for i, (p, n, a) in enumerate(specs)]


def _greedy(cfg, params, req):
    return greedy_decode(cfg, params, req.prompt[None, :], req.max_new,
                         device="cpu")[0].numpy()


def _check_against_greedy(cfg, params, reqs, prefix_ok=False):
    for r in reqs:
        want = _greedy(cfg, params, r)
        got = np.asarray(r.out, np.int64)
        if prefix_ok and r.status != "finished":
            want = want[:len(got)]
        assert np.array_equal(got, want), (
            f"rid={r.rid}: engine {got} != greedy {want}")


def test_engine_mixed_arrival_trace_matches_greedy(llama, make_engine):
    """More requests than slots, admitted at different steps."""
    _, cfg, _, params = llama
    reqs = _trace(cfg, [(9, 6, 0.0), (17, 9, 2.0), (5, 12, 5.0),
                        (23, 4, 5.0)])
    eng = make_engine(cfg, params, EngineConfig(
        n_slots=3, n_blocks=32, block_size=4, max_len=64, prefill_chunk=4))
    done = eng.run(reqs, clock="steps", max_steps=500)
    assert all(r.status == "finished" for r in done)
    assert len({r.ttft + r.arrival for r in done}) > 1
    _check_against_greedy(cfg, params, done)


def test_engine_eviction_replay_is_exact(llama, make_engine):
    """An undersized pool forces evict -> requeue -> recompute."""
    _, cfg, _, params = llama
    reqs = _trace(cfg, [(10, 8, 0.0), (12, 8, 0.0), (8, 8, 0.0)], seed=1)
    eng = make_engine(cfg, params, EngineConfig(
        n_slots=3, n_blocks=8, block_size=4, max_len=32, prefill_chunk=4))
    done = eng.run(reqs, clock="steps", max_steps=2000)
    assert eng.sched.n_evictions > 0
    _check_against_greedy(cfg, params, done)


def test_engine_int8_kv_trace(llama, make_engine):
    """int8 paged cache (kernel #11 dequantizes K/V before the dot)
    against greedy_decode's int8 contiguous cache (scales folded into the
    scores and probabilities)."""
    _, cfg, _, params = llama
    cfg8 = cfg.with_(kv_quant="int8")
    reqs = _trace(cfg8, [(8, 5, 0.0), (14, 6, 1.0), (6, 7, 2.0)], seed=3)
    eng = make_engine(cfg8, params, EngineConfig(
        n_slots=3, n_blocks=32, block_size=4, max_len=64, prefill_chunk=4))
    done = eng.run(reqs, clock="steps", max_steps=500)
    assert all(r.status == "finished" for r in done)
    _check_against_greedy(cfg8, params, done)


def test_engine_packed_slab_2_4_trace(make_engine):
    """The port's own compress -> pack (stablelm_12b SMOKE, GQA, slab
    2:4 -> slab-nm) served by the engine, token-exact vs greedy_decode
    of the same packed params."""
    cfg = configs.get("stablelm_12b", smoke=True).with_(dtype=torch.float32)
    params = lm.init(cfg, seed=0, device="cpu")
    cal = calibration_batch(cfg.vocab, n_seq=4, seq_len=32)
    plan = plan_for_method("slab", SLaBConfig(cr=0.5, iters=3,
                                              pattern="2:4"))
    dense_c, _, decs = compress_model(cfg, params, cal, plan=plan,
                                      keep_decompositions=True,
                                      device="cpu")
    packed, rep = pack_model(dense_c, decs, plan=plan)
    assert rep.by_variant == {"slab-nm": 14}
    reqs = _trace(cfg, [(7, 5, 0.0), (13, 7, 3.0), (4, 9, 6.0)], seed=2)
    eng = make_engine(cfg, packed, EngineConfig(
        n_slots=2, n_blocks=24, block_size=4, max_len=48, prefill_chunk=4))
    done = eng.run(reqs, clock="steps", max_steps=1000)
    assert all(r.status == "finished" for r in done)
    _check_against_greedy(cfg, packed, done)


def test_engine_chaos_seed0_no_leak_and_replays_byte_identical(
        llama, make_engine):
    """FaultPlan.chaos(0): every request ends terminal, finished streams
    are token-exact, failed ones keep a greedy prefix, no block leaks
    (the factory's teardown), and a second run is identical."""
    _, cfg, _, params = llama
    specs = [(9, 10, 0.0), (12, 12, 1.0), (7, 12, 2.0), (10, 9, 3.0)]
    faults = FaultPlan.chaos(seed=0, vocab=cfg.vocab, n_rows=2, horizon=24,
                             burst_prompt=5, burst_new=2)
    runs = []
    for _ in range(2):
        eng = make_engine(cfg, params, EngineConfig(
            n_slots=2, n_blocks=12, block_size=4, max_len=32,
            prefill_chunk=4))
        done = eng.run(_trace(cfg, specs, seed=6), clock="steps",
                       max_steps=2000, faults=faults)
        assert all(r.terminal for r in done)
        runs.append({r.rid: (r.status, tuple(r.out), r.n_evictions,
                             r.error) for r in done})
    assert runs[0] == runs[1]
    assert len(runs[0]) > len(specs)
    assert any(s[0] == "finished" for s in runs[0].values())
    _check_against_greedy(cfg, params, done, prefix_ok=True)


def test_engine_forced_nan_quarantines_victim_only(llama, make_engine):
    _, cfg, _, params = llama
    reqs = _trace(cfg, [(6, 10, 0.0), (7, 10, 0.0)], seed=2)
    eng = make_engine(cfg, params, EngineConfig(
        n_slots=2, n_blocks=24, block_size=4, max_len=32, prefill_chunk=4))
    faults = FaultPlan([FaultEvent(step=s, kind="nan", rows=(0,))
                        for s in range(5, 40)])
    done = eng.run(reqs, clock="steps", max_steps=500, faults=faults)
    victim, neighbor = done
    assert victim.status == "failed" and "non-finite" in victim.error
    assert victim.n_nan_retries == 1 and 0 < victim.n_generated
    assert neighbor.status == "finished"
    _check_against_greedy(cfg, params, done, prefix_ok=True)


def test_engine_equals_reference_engine_per_request(llama):
    """One mixed-arrival trace through both engines on bridged weights:
    equal out, status, ttft and finish for every request."""
    cfg_r, cfg, params_r, params = llama
    specs = [(9, 6, 0.0), (17, 5, 2.0), (5, 7, 3.0), (11, 4, 3.0)]
    kw = dict(n_slots=2, n_blocks=7, block_size=4, max_len=28,
              prefill_chunk=4)
    mine = Engine(cfg, params, EngineConfig(**kw), device="cpu").run(
        _trace(cfg, specs, seed=8), clock="steps", max_steps=500)
    ref_eng = RefEngine(cfg_r, params_r, RefEngineConfig(**kw))
    theirs = ref_eng.run(_trace(cfg, specs, seed=8, cls=RefRequest),
                         clock="steps", max_steps=500)
    assert ref_eng.sched.n_evictions > 0          # the replay path too
    for a, b in zip(mine, theirs):
        assert (a.rid, a.status, a.out, a.ttft, a.finish) == \
            (b.rid, b.status, b.out, b.ttft, b.finish)


def test_engine_refuses_params_on_another_device(llama):
    _, cfg, _, params = llama
    with pytest.raises(ValueError):
        Engine(cfg.with_(family="ssm"), params, EngineConfig(),
               device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine(cfg, params, EngineConfig())


def test_serve_cli_engine_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "llama2_7b", "--engine", "--kv-quant",
                "--compress", "none", "--device", "cpu", "--requests", "4",
                "--batch", "2", "--prompt-len", "8", "--gen-len", "4",
                "--chaos", "0"])
    out = capsys.readouterr().out
    assert "chaos: FaultPlan(seed=0," in out
    assert "engine: " in out and "requests [" in out and "goodput" in out
    assert "per-token p50/p95/p99" in out
