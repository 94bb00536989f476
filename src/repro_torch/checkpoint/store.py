"""Atomic, async checkpointing (counterpart of ``repro.checkpoint``).

The on-disk layout is the reference's, so either package reads what
the other wrote:

* ``<dir>/step_<step:010d>/arrays.npz`` holds one array per leaf, keyed
  by the leaf's path with ``|`` between the parts: a dict key as
  itself, a list or tuple position as its index, a dataclass field as
  ``.<name>`` (the reference's rendering of a NamedTuple field), and
  ``_root`` for a bare leaf;
* ``manifest.json`` beside it holds ``step``, ``meta`` (the loop puts
  the data cursor there) and the sorted ``keys``.

* **Atomic** — a checkpoint is written to ``step_XXXX.tmp/`` and
  ``os.replace``d into place only after every array and the manifest
  are on disk; a crash mid-save never corrupts the latest checkpoint.
* **Async** — :class:`CheckpointManager` copies the state to the host
  synchronously (so the next step may overwrite the device tensors)
  and writes the files on a thread; errors surface on the next
  ``wait()``.
* **Restore onto the live device** — :func:`restore` rebuilds the
  structure of a ``like`` state and places each tensor leaf on the
  device of the ``like`` leaf; shapes and dtypes come from disk.

The state is a tree of dicts, lists, tuples and dataclasses
(``TrainState``, ``KFACState``) whose leaves are tensors, numpy arrays
or host ints (``KFACState.step``: a 0-d array on disk, an int again on
restore).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_SEP = "|"      # path separator inside npz keys ('/' is reserved)


def _is_dataclass(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def _leaves(tree: Any, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[str, Any]]:
    """``(key, leaf)`` in the tree's order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif _is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), path + ("." + f.name,))
    else:
        yield _SEP.join(path) or "_root", tree


def _rebuild(like: Any, leaf_fn, path: Tuple[str, ...] = ()) -> Any:
    """``like``'s structure with every leaf replaced by
    ``leaf_fn(key, like_leaf)``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, leaf_fn, path + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_rebuild(v, leaf_fn, path + (str(i),))
               for i, v in enumerate(like)]
        return out if isinstance(like, list) else type(like)(out)
    if _is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), leaf_fn,
                             path + ("." + f.name,))
            for f in dataclasses.fields(like) if f.init})
    return leaf_fn(_SEP.join(path) or "_root", like)


def _to_host(leaf: Any) -> np.ndarray:
    """A host copy that later in-place writes to ``leaf`` cannot reach."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return t.numpy().copy() if t.device.type == "cpu" \
            else t.cpu().numpy()
    if isinstance(leaf, (int, np.ndarray)):
        return np.array(leaf)
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf)!r}")


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    flat = {}
    for key, leaf in _leaves(tree):
        if key in flat:
            raise ValueError(f"two leaves share the checkpoint key {key!r}")
        flat[key] = _to_host(leaf)
    return flat


def save(directory: str, step: int, tree: Any, *,
         meta: Optional[dict] = None) -> str:
    """Synchronous atomic save of one state. Returns the final path."""
    return _write(directory, step, _flatten(tree), meta)


def _write(directory: str, step: int, arrays: Dict[str, np.ndarray],
           meta: Optional[dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "meta": meta or {},
                "keys": sorted(arrays.keys())}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp") \
                and os.path.exists(os.path.join(directory, name,
                                                "manifest.json")):
            steps.append(int(name[5:]))
    return max(steps) if steps else None


def restore(directory: str, like: Any, *,
            step: Optional[int] = None) -> Tuple[Any, dict]:
    """Restore a state shaped ``like`` (same structure; shapes and
    dtypes are taken from disk). A tensor leaf lands on the device of
    the ``like`` leaf, an int leaf comes back an int and any other leaf
    a numpy array. Returns ``(state, manifest)``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    final = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(final, "arrays.npz")) as stored:

        def leaf(key, like_leaf):
            if key not in stored:
                raise KeyError(f"checkpoint {final} missing leaf {key!r}")
            host = stored[key]
            if isinstance(like_leaf, torch.Tensor):
                return torch.from_numpy(host).to(like_leaf.device)
            if isinstance(like_leaf, int):
                return int(host)
            return host

        tree = _rebuild(like, leaf)
    return tree, manifest


class CheckpointManager:
    """Async manager: snapshot-on-call, write-in-background, keep-last-k.

    The step's tensors are copied device->host synchronously (so the
    next train step may overwrite device tensors), then the filesystem
    write happens on a daemon thread. ``wait()`` joins the in-flight
    write and raises its error, if any; it is also called before
    starting the next one. ``write_s`` lists each finished write's
    seconds on the thread (files and garbage collection).
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self.write_s: list = []
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Any, *,
                   meta: Optional[dict] = None):
        self.wait()
        arrays = _flatten(tree)          # sync snapshot to the host

        def work():
            try:
                t0 = time.perf_counter()
                _write(self.directory, step, arrays, meta)
                self._gc()
                self.write_s.append(time.perf_counter() - t0)
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(
            int(n[5:]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:010d}"),
                ignore_errors=True)
