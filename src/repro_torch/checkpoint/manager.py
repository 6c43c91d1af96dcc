"""Fault-tolerant checkpointing (port of ``repro.checkpoint.manager``):
atomic commits, an async writer, restore onto a given device.

The on-disk format is the reference's, so a tree saved by one package
loads in the other: ``<dir>/`` holds one ``.npy`` per leaf, named by
its tree path joined with ``__`` (dict keys in sorted order, list
items by index, NamedTuple fields by name), and ``manifest.json`` with
each leaf's shape and dtype name. A "layers" list (the port's one entry
per layer) is stored as the reference holds its layers: each leaf
stacked over the layers on a leading dim, named without the layer
index, so a train state committed by either package restores in the
other. bfloat16, which numpy lacks, is
stored as its raw bytes (uint8, a trailing dim of 2) under the name
``bfloat16`` and rebuilt with ``Tensor.view(torch.bfloat16)``. A save
writes ``<dir>.tmp`` and renames it into place, so a crash mid-write
never leaves a partial commit (rename is atomic on POSIX).

Under a mesh (``CheckpointManager(mesh=...)``) every rank calls ``save``
and ``restore`` together: a save gathers the state whole
(``sharding.gather_shards``) and rank 0 alone writes it; ``wait`` joins
rank 0's writer and then holds every rank at a barrier, so no rank reads
the directory while a commit is half written or being collected.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.runtime.sharding import gather_shards
from repro_torch.tree import (_is_namedtuple, leaves_with_path, tree_map,
                              unflatten_like)

SEP = "__"


def _host_copy(x):
    """A tensor leaf copied to the host (the async writer serializes the
    copy while the train loop updates the original in place)."""
    return x.detach().to("cpu", copy=True) if torch.is_tensor(x) else x


def _to_native(leaf):
    """A leaf -> (numpy array, dtype name), bit-exact; bf16 as its raw
    bytes, a trailing dim of 2 (uint8)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).numpy().reshape(-1).view(
                np.uint8).reshape(tuple(t.shape) + (2,)), "bfloat16")
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _from_native(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16).reshape(
            arr.shape[:-1])
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    if arr.dtype.name != dtype_name:
        raise ValueError(f"leaf stored as {arr.dtype.name}, manifest says "
                         f"{dtype_name}")
    return torch.from_numpy(np.array(arr, copy=True))


def _on_layers(tree: Any, fn) -> Any:
    """``tree`` with every "layers" list replaced by ``fn(list)``."""
    if isinstance(tree, dict):
        return {k: fn(v) if k == "layers" and isinstance(v, list)
                else _on_layers(v, fn) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_on_layers(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_layers(v, fn) for v in tree)
    return tree


def _stack(*xs):
    return torch.stack([torch.as_tensor(x) for x in xs])


def _unstack(loaded: Any, template: Any) -> Any:
    """The stacked "layers" subtrees of ``loaded`` split back into
    ``template``'s lists, a copy per layer."""
    if isinstance(template, dict):
        return {k: [tree_map(lambda t: t[i].clone(), loaded[k])
                    for i in range(len(v))]
                if k == "layers" and isinstance(v, list)
                else _unstack(loaded[k], v) for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(_unstack(a, b)
                                for a, b in zip(loaded, template)))
    if isinstance(template, (list, tuple)):
        return type(template)(_unstack(a, b)
                              for a, b in zip(loaded, template))
    return loaded


def save_pytree(tree: Any, directory: str) -> None:
    """Atomic: write ``<directory>.tmp``, then rename it into place."""
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {}
    tree = _on_layers(tree, lambda ls: tree_map(_stack, *ls))
    for path, leaf in leaves_with_path(tree):
        key = SEP.join(path)
        native, dtype_name = _to_native(leaf)
        np.save(os.path.join(tmp, key + ".npy"), native)
        shape = native.shape[:-1] if dtype_name == "bfloat16" else \
            native.shape
        manifest[key] = {"shape": list(shape), "dtype": dtype_name}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def load_pytree(template: Any, directory: str, device=None) -> Any:
    """``template``'s structure (any leaves: tensors, meta tensors,
    arrays) rebuilt from ``directory`` as tensors on
    ``resolve_device(device)``: the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    disk = _on_layers(template, lambda ls: ls[0])
    leaves = []
    for path, _ in leaves_with_path(disk):
        key = SEP.join(path)
        arr = np.load(os.path.join(directory, key + ".npy"))
        leaves.append(_from_native(arr, manifest[key]["dtype"]))
    tree = _unstack(unflatten_like(disk, leaves), template)
    return tree_map(lambda t: t.to(dev), tree)


class CheckpointManager:
    """Keeps the last ``keep`` commits under ``root`` (``step_<n>``);
    with ``async_write`` a writer thread serializes each commit while
    the train loop goes on."""

    def __init__(self, root: str, keep: int = 3, async_write: bool = True,
                 mesh=None):
        self.root = root
        self.keep = keep
        self.async_write = async_write
        self.mesh = mesh
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(root, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def steps(self) -> List[int]:
        return sorted(int(n[5:]) for n in os.listdir(self.root)
                      if n.startswith("step_") and not n.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.mesh is not None:
            self.mesh.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any) -> None:
        self.wait()                      # one save in flight at a time
        if self.mesh is not None:
            tree = gather_shards(tree, self.mesh)
            if self.mesh.rank != 0:
                return
        # copy to the host NOW: the train loop updates the tensors in
        # place once this returns
        host_tree = tree_map(_host_copy, tree)

        def work():
            try:
                save_pytree(host_tree, self._step_dir(step))
                self._gc()
            except BaseException as e:   # surfaced by the next wait()
                self._error = e

        if self.async_write:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self.wait()

    def restore(self, template: Any, step: Optional[int] = None,
                device=None) -> Any:
        """The commit at ``step`` (default: the latest) on
        ``resolve_device(device)``."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return load_pytree(template, self._step_dir(step), device)

    def _gc(self) -> None:
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
