"""Atomic, async, keep-k checkpointing (port of
``repro.checkpoint.manager``), in the JAX package's format, so either
package restores the other's checkpoints.

Layout (one directory per step)::

    <root>/step_000000123.tmp/       # written here ...
        manifest.json                # leaf keys + metadata, "format": 1
        shard_00000.npz              # leaf arrays (one host)
    <root>/step_000000123/           # ... atomically renamed on commit

A tree is dataclasses (fields in order), dicts (sorted keys), lists and
tuples (``[i]``) and ``None`` (no leaves) over tensors, arrays and
Python scalars; a leaf's manifest key is its path joined by ``/``
(``params/cell/ui``, ``opt/mu/head``, ``opt/step``), as
``jax.tree_util.tree_flatten_with_path`` names it.  bfloat16 is stored
as its ``uint16`` bits with dtype ``"bfloat16"`` in the manifest.

Fault-tolerance properties:

  - **Atomic**: the rename is the commit point; a crash mid-save leaves
    only a ``.tmp`` dir that restore ignores and the next manager purges.
  - **Async**: ``save(..., blocking=False)`` copies every tensor to host
    memory before it returns (the trainer's next step overwrites the
    same tensors in place) and writes in a background thread.
  - **Keep-k**: the newest k commits survive.

Restore puts every array leaf on ``device`` (the card unless the caller
asks for the CPU); Python-scalar leaves of ``like`` come back as Python
scalars.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

PyTree = Any

_SEP = "/"       # key-path separator in the manifest


def _children(tree: PyTree) -> Optional[List[Tuple[str, Any]]]:
    """``(path element, child)`` pairs of a node; ``None`` for a leaf."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(tree)]
    if tree is None:
        return []
    return None


def _rebuild(tree: PyTree, children: List[Any]) -> PyTree:
    """``tree``'s node with its children replaced, in ``_children``
    order."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: c for f, c in zip(dataclasses.fields(tree), children)})
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), children))
    if isinstance(tree, (list, tuple)):
        return type(tree)(children)
    return tree


def _flatten_with_paths(tree: PyTree, prefix: str = ""
                        ) -> List[Tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for name, child in kids:
        out += _flatten_with_paths(
            child, f"{prefix}{_SEP}{name}" if prefix else name)
    return out


def _map(f: Callable[[str, Any], Any], tree: PyTree, prefix: str = ""
         ) -> PyTree:
    """``f(path, leaf)`` over the leaves, the structure kept."""
    kids = _children(tree)
    if kids is None:
        return f(prefix, tree)
    return _rebuild(tree, [
        _map(f, child, f"{prefix}{_SEP}{name}" if prefix else name)
        for name, child in kids])


def _host_copy(leaf: Any) -> Any:
    """A copy in host memory that later in-place writes cannot reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    return leaf


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """The array to store and the dtype name for the manifest."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def save_tree(tree: PyTree, directory: str, *, step: int) -> str:
    """Synchronous one-shot save (the async path calls this in a thread)."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest: Dict[str, Any] = {"step": step, "format": 1, "leaves": {}}
    packed: Dict[str, np.ndarray] = {}
    for i, (key, leaf) in enumerate(_flatten_with_paths(tree)):
        arr, dtype = _to_numpy(leaf)
        name = f"a{i:06d}"
        manifest["leaves"][key] = {
            "array": name, "shape": list(arr.shape), "dtype": dtype}
        packed[name] = arr
    np.savez(os.path.join(tmp, "shard_00000.npz"), **packed)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                     # commit point
    return final


def _shape(leaf: Any) -> List[int]:
    return list(leaf.shape) if isinstance(leaf, torch.Tensor) \
        else list(np.shape(leaf))


def restore_tree(directory: str, like: PyTree, *,
                 step: Optional[int] = None, device="cuda",
                 ) -> Tuple[PyTree, int]:
    """Restore into the structure of ``like`` (the newest commit unless
    ``step`` is given): array leaves as tensors on ``device`` with the
    checkpoint's dtype, Python-scalar leaves as Python scalars.  A leaf
    missing from the checkpoint raises ``KeyError``, a shape that differs
    ``ValueError``."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "shard_00000.npz")) as data:

        def load(key: str, leaf: Any) -> Any:
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[meta["array"]]
            if list(arr.shape) != _shape(leaf):
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs model {_shape(leaf)}")
            if isinstance(leaf, (int, float, bool)):
                return type(leaf)(arr.item())
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            return t.to(device)

        return _map(load, like), step


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            s = int(m.group(1))
            best = s if best is None else max(best, s)
    return best


class CheckpointManager:
    """Keep-k async checkpointing for a training loop."""

    def __init__(self, directory: str, *, keep: int = 3,
                 save_interval_steps: int = 100):
        self.directory = directory
        self.keep = keep
        self.save_interval_steps = save_interval_steps
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)
        self._purge_tmp()

    # -- policy -------------------------------------------------------------
    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_interval_steps == 0

    # -- save ---------------------------------------------------------------
    def save(self, tree: PyTree, step: int, *, blocking: bool = False) -> None:
        self.wait()                           # one in-flight save at a time
        # Copy to host memory NOW: the caller's next step overwrites these
        # tensors in place.  This is the only synchronous cost.
        host = _map(lambda _k, x: _host_copy(x), tree)

        def work():
            try:
                save_tree(host, self.directory, step=step)
                self._gc()
            except BaseException as e:        # surfaced on next wait()
                self._last_error = e

        if blocking:
            work()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._last_error is not None:
            e, self._last_error = self._last_error, None
            raise e

    # -- restore ------------------------------------------------------------
    def restore(self, like: PyTree, *, step: Optional[int] = None,
                device="cuda") -> Tuple[PyTree, int]:
        self.wait()
        return restore_tree(self.directory, like, step=step, device=device)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    # -- retention ----------------------------------------------------------
    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1)) for m in
            (re.fullmatch(r"step_(\d+)", n)
             for n in os.listdir(self.directory)) if m)
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)

    def _purge_tmp(self) -> None:
        for name in os.listdir(self.directory):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
