"""A (data, model) mesh over ``torch.distributed`` processes (the port's
counterpart of ``repro.launch.mesh`` and ``jax.make_mesh``), its
process bootstrap, and a ``spawn`` helper for tests and smoke runs.

One process per rank; rank r sits at row-major coordinates of the mesh
shape (``model`` the fastest axis, as in ``jax.make_mesh``). Every
subset of the mesh axes has its process groups (the ranks that differ
only along those axes), made by every rank at construction.

Backend, by rule, printed on a line of its own by ``init_process``:

  * ``gloo`` on the CPU;
  * ``nccl`` where each rank has a card of its own;
  * ``gloo`` where ranks outnumber cards (NCCL refuses two ranks on one
    device): CUDA tensors then go through gloo.

Nothing switches backend or device when a collective fails. The
gather of the serving path is an ``all_reduce`` (sum) of a zero-filled
buffer holding this rank's slice at its place, viewed as integer words:
each element has one non-zero term, so the result is exact bit for bit,
and it runs on every backend, CUDA tensors through gloo included. The
data-parallel step's int8 exchange uses the native ``all_to_all`` and
``all_gather_native`` instead (``dist.all_to_all_single``,
``dist.all_gather_into_tensor``), so that each shard crosses the wire
once. Both carry the tensors where they lie, under either backend: gloo
takes CUDA tensors (int8, bf16 and f32) for both, as for ``all_reduce``
(checked on the H100 with torch 2.11, two ranks on one card).

The TPU hardware constants of the reference's ``launch/mesh.py`` are not
ported here.
"""
from __future__ import annotations

import itertools
import math
import os
import pickle
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class Mesh:
    """``axis_names`` and ``shape`` (an ordered dict of axis sizes) as
    ``jax.sharding.Mesh`` has them, this process's ``rank`` and its
    coordinates, and, once ``make_mesh`` gave them, the process groups
    of the collectives. A mesh without groups only places (planner and
    ``sharding.shard`` tests)."""

    def __init__(self, shape: Dict[str, int], rank: int = 0,
                 device=None, backend: Optional[str] = None):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.device = torch.device("cpu" if device is None else device)
        self.backend = backend
        self.coords: Dict[str, int] = {}
        r = rank
        for a in reversed(self.axis_names):
            self.coords[a] = r % self.shape[a]
            r //= self.shape[a]
        self._groups: Dict[Tuple[str, ...], Any] = {}
        # host seconds spent in collectives while ``timed`` (each then
        # synchronises the card before and after it), and the bytes this
        # rank sent in them (``_run``'s ``sent``)
        self.timed = False
        self.comm_s = 0.0
        self.comm_calls = 0
        self.comm_bytes = 0

    def __repr__(self) -> str:
        dims = " x ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({dims}, rank {self.rank})"

    def index(self, axes: Sequence[str]) -> int:
        """This rank's position along ``axes`` taken together (row-major in
        the order given; axes absent from the mesh are skipped)."""
        i = 0
        for a in axes:
            if a in self.shape:
                i = i * self.shape[a] + self.coords[a]
        return i

    def n(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes if a in self.shape)

    def _group(self, axes: Sequence[str]):
        key = tuple(a for a in self.axis_names if a in axes)
        if key not in self._groups:
            raise RuntimeError(f"{self!r} has no process group over {key}: "
                               "make it with make_mesh")
        return self._groups[key]

    def _make_groups(self) -> None:
        """Every subset of axes: the groups of ranks differing only along
        it, made in the same order on every rank (``new_group`` is
        collective)."""
        names = self.axis_names
        for k in range(1, len(names) + 1):
            for sub in itertools.combinations(names, k):
                rest = [a for a in names if a not in sub]
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in rest)):
                    pin = dict(zip(rest, fixed))
                    ranks = [r for r in range(self.size)
                             if all(Mesh(self.shape, r).coords[a] == c
                                    for a, c in pin.items())]
                    g = dist.new_group(ranks)
                    if all(self.coords[a] == c for a, c in pin.items()):
                        self._groups[sub] = g

    # -- collectives ------------------------------------------------------

    def _run(self, fn, sent: float = 0):
        """``fn()``, a collective; while ``timed``, its host seconds and
        ``sent``, the bytes this rank puts on the wire by the collective's
        algorithm: a ring's 2 (n-1)/n of the buffer for ``all_reduce``,
        (n-1)/n of it for ``all_to_all``, (n-1) slices for
        ``all_gather_native``."""
        if not self.timed:
            return fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.comm_s += time.perf_counter() - t0
        self.comm_calls += 1
        self.comm_bytes += int(sent)
        return out

    def _ring(self, t: torch.Tensor, axes: Sequence[str]) -> float:
        n = self.n(axes)
        return 2 * (n - 1) / n * t.numel() * t.element_size()

    def merge(self, t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """Elementwise over the ranks of ``axes``, where at most one holds
        a non-zero word: that rank's value everywhere, bit for bit."""
        if self.n(axes) == 1:
            return t
        return self._merge_(t.contiguous().clone(), axes)

    def _merge_(self, buf: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        words = buf.view(-1).view(torch.uint8)
        if words.numel() % 4 == 0:
            words = words.view(torch.int32)
        group = self._group(axes)
        self._run(lambda: dist.all_reduce(words, group=group),
                  self._ring(words, axes))
        return buf

    def all_gather(self, t: torch.Tensor, axes: Sequence[str],
                   dim: int) -> torch.Tensor:
        """The slices of the ranks of ``axes`` concatenated along ``dim``
        in their order (``index``)."""
        n = self.n(axes)
        if n == 1:
            return t
        buf = torch.zeros((n,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        buf[self.index(axes)] = t
        return torch.cat(self._merge_(buf, axes).unbind(0), dim=dim)

    def all_reduce(self, t: torch.Tensor, axes: Sequence[str],
                   op: str = "sum") -> torch.Tensor:
        if self.n(axes) == 1:
            return t
        t = t.contiguous().clone()
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        group = self._group(axes)
        self._run(lambda: dist.all_reduce(t, op=red, group=group),
                  self._ring(t, axes))
        return t

    def all_to_all(self, t: torch.Tensor, axes: Sequence[str]
                   ) -> torch.Tensor:
        """Dim 0 of ``t`` split into one slice per rank of ``axes`` (in
        ``index`` order): slice i goes to rank i, and slice i of the result
        is what rank i sent this rank."""
        n = self.n(axes)
        if n == 1:
            return t
        if t.shape[0] % n:
            raise ValueError(f"all_to_all: dim 0 of {tuple(t.shape)} does "
                             f"not split over {n} ranks")
        t = t.contiguous()
        out = torch.empty_like(t)
        group = self._group(axes)
        self._run(lambda: dist.all_to_all_single(out, t, group=group),
                  (n - 1) / n * t.numel() * t.element_size())
        return out

    def all_gather_native(self, t: torch.Tensor, axes: Sequence[str]
                          ) -> torch.Tensor:
        """The ranks' ``t`` of ``axes`` concatenated along dim 0 in their
        order, each slice sent once (``all_gather_into_tensor``), where
        ``all_gather`` sends a zero-filled buffer of all of them."""
        n = self.n(axes)
        if n == 1:
            return t
        t = t.contiguous()
        out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        group = self._group(axes)
        self._run(lambda: dist.all_gather_into_tensor(out, t, group=group),
                  (n - 1) * t.numel() * t.element_size())
        return out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` from global rank ``src`` to every rank (in place)."""
        if self.size > 1:
            sent = t.numel() * t.element_size() if self.rank == src else 0
            self._run(lambda: dist.broadcast(t, src=src), sent)
        return t

    def barrier(self) -> None:
        """Every rank of the mesh waits here for the others."""
        if self.size > 1:
            dist.barrier()

    def comm_device(self) -> torch.device:
        """Where host-side arrays travel: the card under nccl (it moves
        CUDA tensors only), else the host."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


def make_test_mesh(data: int = 1, model: int = 1, pod: int = 0,
                   rank: int = 0) -> Mesh:
    """A mesh of the given shape seen from ``rank``, without process
    groups: for the planner and for placement (``sharding.shard``)."""
    if pod:
        return Mesh({"pod": pod, "data": data, "model": model}, rank)
    return Mesh({"data": data, "model": model}, rank)


def make_mesh(data: int, model: int, device=None) -> Mesh:
    """The (data, model) mesh over the initialised process group: world
    size data x model, this process at ``dist.get_rank()``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(init_process / init_from_env)")
    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(f"a mesh of data={data} x model={model} needs "
                         f"{data * model} ranks, the process group has "
                         f"{world}")
    mesh = Mesh({"data": data, "model": model}, dist.get_rank(), device,
                dist.get_backend())
    mesh._make_groups()
    return mesh


def backend_for(device: torch.device, local_world: int) -> Tuple[str, str]:
    """(backend, why) by the rule of this module's docstring."""
    if device.type == "cpu":
        return "gloo", "CPU tensors"
    n_cards = torch.cuda.device_count()
    if local_world <= n_cards:
        return "nccl", f"{local_world} ranks on {n_cards} cards, one each"
    return "gloo", (f"{local_world} ranks on {n_cards} card(s): CUDA "
                    "tensors through gloo, all_to_all and "
                    "all_gather_into_tensor included")


def rank_device(device: torch.device, local_rank: int) -> torch.device:
    """This rank's device: the CPU, or card ``local_rank`` modulo the
    cards present."""
    if device.type == "cpu":
        return device
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_process(rank: int, world: int, device, init_method: str,
                 local_rank: Optional[int] = None,
                 local_world: Optional[int] = None,
                 timeout_s: float = 600.0) -> torch.device:
    """Initialise the default process group for this rank and return its
    device. Prints the backend line on rank 0."""
    device = torch.device(device)
    local_rank = rank if local_rank is None else local_rank
    local_world = world if local_world is None else local_world
    backend, why = backend_for(device, local_world)
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    import datetime
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    if rank == 0:
        print(f"process group: backend {backend} over {world} ranks "
              f"({why})", flush=True)
    return dev


def init_from_env(device) -> torch.device:
    """Bootstrap under ``torchrun`` (``python -m torch.distributed.run``):
    RANK, WORLD_SIZE, LOCAL_RANK and LOCAL_WORLD_SIZE from its
    environment, the rendezvous at MASTER_ADDR / MASTER_PORT."""
    env = os.environ
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in env]
    if missing:
        raise RuntimeError(f"no torchrun environment ({', '.join(missing)} "
                           "unset): launch with python -m "
                           "torch.distributed.run --nproc-per-node N")
    world = int(env["WORLD_SIZE"])
    return init_process(int(env["RANK"]), world, device, "env://",
                        int(env.get("LOCAL_RANK", env["RANK"])),
                        int(env.get("LOCAL_WORLD_SIZE", world)))


# ----------------------------------------------------------------------
# spawn: one process per rank, results back to the caller
# ----------------------------------------------------------------------

def _worker(fn, rank, world, device, init_file, payload, queue, threads):
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = init_process(rank, world, device, f"file://{init_file}")
        try:
            out = fn(rank, world, dev, *pickle.loads(payload))
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, pickle.dumps(out)))
    except BaseException:  # reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world: int, device, init_file: str,
          args: tuple = (), timeout: float = 600.0,
          threads: int = 0) -> List[Any]:
    """Run ``fn(rank, world, device, *args)`` in ``world`` fresh processes
    (the ``spawn`` start method) joined by a process group rendezvoused
    through the file ``init_file`` (a FileStore: no TCP port to compete
    for; it must not exist yet). ``fn`` must be importable by name;
    ``args`` and the results travel pickled. Returns the results in rank
    order. Raises with the worker's traceback if any rank fails, and
    kills every rank still running when ``timeout`` seconds pass."""
    import multiprocessing as mp
    import queue as queue_lib
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    payload = pickle.dumps(tuple(args))
    procs = [ctx.Process(target=_worker, args=(fn, r, world, str(device),
                                                init_file, payload, q,
                                                threads), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    errors: List[str] = []
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            try:
                rank, ok, body = q.get(timeout=min(max(left, 0.01), 1.0))
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and p.exitcode not in (0, None)
                        and r not in results]
                if left <= 0 or dead:
                    errors.append(
                        f"{world - len(results)} rank(s) gave no result ("
                        + (f"exited: ranks {dead}" if dead else
                           f"after {timeout:.0f} s") + ")")
                    break
                continue
            if ok:
                results[rank] = pickle.loads(body)
            else:
                # the first failure often takes its peers down: give them
                # a moment to report theirs too
                errors.append(f"rank {rank}:\n{body}")
                deadline = min(deadline, time.monotonic() + 5.0)
        if errors:
            raise RuntimeError("spawn: a rank failed\n" + "\n".join(errors))
    finally:
        for p in procs:
            p.join(timeout=5 if not errors else 0.5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    return [results[r] for r in range(world)]
