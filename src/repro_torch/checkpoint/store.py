"""Checkpoint store, the JAX package's ``checkpoint/store.py`` on torch
tensors, with its on-disk layout byte for byte where bytes are defined.

Layout: one directory ``step_%010d`` per step, written into ``<dir>.tmp``
and renamed (a killed save never leaves a complete-looking directory;
``latest_step`` skips partials), holding

* ``index.json``: ``step``, ``time``, ``treedef_repr``, ``meta`` and one
  entry per leaf (``shape``, ``dtype``, ``is_key``, ``key``, ``file``,
  ``crc32``);
* ``leaf_%05d.npy``: one ``np.save`` file per leaf, the crc32 of its bytes
  in the index, checked by ``restore``.

The tree walk gives the JAX package's leaf order and path keys: dicts in
sorted-key order, lists and tuples by index, ``None`` and ``()`` no leaf,
:class:`~repro_torch.analog.modules.AnalogState` as ``(w, maps, seed)``
(``(w, seed)`` without maps) and :class:`~repro_torch.core.device.
DeviceMaps` as ``(dw_up, dw_dn, bound)``, path parts joined with ``/``.
A host key (``prng.Key``, a tuple of two Python ints; the port's trees
hold no other such pair) is one leaf, written as its key data, ``(2,)``
uint32, under ``dtype`` ``"key<fry>"`` (JAX's name for a threefry key),
shape ``[]`` and ``is_key`` true; a :class:`~repro_torch.utils.prng.
KeyStack` (the stacked seeds of an LM's layers) is one such leaf of shape
``[n]``.  bfloat16 is written through a uint16
view.  ``AnalogMeta`` is static structure: never written, and ``restore``
takes it from ``like``.

``restore``'s ``device`` is the counterpart of the JAX store's
``shardings``: the leaves land on it, or on the device of ``like``'s leaf.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analog.modules import AnalogState
from repro_torch.core.device import DeviceMaps
from repro_torch.utils import prng

PyTree = Any
KEY_DTYPE = "key<fry>"


def _is_key(leaf) -> bool:
    return isinstance(leaf, prng.KeyStack) or (
        type(leaf) is tuple and len(leaf) == 2
        and all(type(v) is int for v in leaf))


def _shape(leaf) -> Tuple[int, ...]:
    if isinstance(leaf, prng.KeyStack):
        return leaf.shape
    return () if _is_key(leaf) else tuple(np.shape(leaf))


def _map_leaves(tree: PyTree, fn: Callable[[str, Any], Any],
                path: Tuple[str, ...] = ()) -> PyTree:
    """``tree`` with each leaf replaced by ``fn(path key, leaf)``, the
    leaves visited in the JAX package's flattening order."""
    def sub(node, part):
        return _map_leaves(node, fn, path + (str(part),))

    if tree is None:
        return None
    if _is_key(tree):
        return fn("/".join(path), tree)
    if isinstance(tree, AnalogState):
        w = sub(tree.w, 0)
        if tree.maps is None:
            return AnalogState(w, None, sub(tree.seed, 1), tree.meta)
        maps = sub(tree.maps, 1)
        return AnalogState(w, maps, sub(tree.seed, 2), tree.meta)
    if isinstance(tree, DeviceMaps):
        return DeviceMaps(*(sub(getattr(tree, f), i) for i, f in
                            enumerate(("dw_up", "dw_dn", "bound"))))
    if isinstance(tree, dict):
        new = {k: sub(tree[k], k) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(sub(v, i) for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _flatten_with_paths(tree: PyTree) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []
    _map_leaves(tree, lambda k, leaf: out.append((k, leaf)))
    return out


def _treedef_repr(leaves: List[Tuple[str, Any]]) -> str:
    """The tree's leaf paths (the JAX store writes its treedef's repr
    here; nothing reads it back)."""
    return f"{len(leaves)} leaves: " + " ".join(k for k, _ in leaves)


def _dtype_name(leaf) -> str:
    if _is_key(leaf):
        return KEY_DTYPE
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(leaf.dtype) if hasattr(leaf, "dtype") else "float32"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, prng.KeyStack):
        return leaf.data
    if _is_key(leaf):
        return prng.key_data(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _leaf_meta(leaf) -> Dict:
    dt = _dtype_name(leaf)
    return {"shape": list(_shape(leaf)), "dtype": dt,
            "is_key": dt == KEY_DTYPE}


def _write_delay_s() -> float:
    """Per-leaf write delay (seconds): ``REPRO_CKPT_WRITE_DELAY`` holds a
    background write open so that a kill lands inside it (the
    kill-and-resume tests); a run without it pays one getenv per save."""
    return float(os.environ.get("REPRO_CKPT_WRITE_DELAY", "0") or 0.0)


def save(directory: str, step: int, tree: PyTree,
         extra_meta: Optional[Dict] = None) -> str:
    """Synchronous atomic checkpoint write; returns the final path."""
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    delay = _write_delay_s()

    leaves = _flatten_with_paths(tree)
    index = {"step": step, "time": time.time(),
             "treedef_repr": _treedef_repr(leaves),
             "leaves": [], "meta": extra_meta or {}}
    for i, (key, leaf) in enumerate(leaves):
        if delay:
            time.sleep(delay)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), _to_numpy(leaf))
        with open(os.path.join(tmp, fname), "rb") as f:
            crc = zlib.crc32(f.read())
        entry = _leaf_meta(leaf)
        entry.update({"key": key, "file": fname, "crc32": crc})
        index["leaves"].append(entry)
    with open(os.path.join(tmp, "index.json"), "w") as f:
        json.dump(index, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _step_of(name: str) -> Optional[int]:
    """Step number of a well-formed final step dir name, else None."""
    if not name.startswith("step_") or name.endswith(".tmp"):
        return None
    try:
        return int(name[len("step_"):])
    except ValueError:
        return None


def _is_complete(path: str) -> bool:
    """A step dir is complete iff its index parses and every listed leaf
    file exists (a dir this store renamed into place always is; this
    guards against partial copies and torn foreign dirs)."""
    try:
        with open(os.path.join(path, "index.json")) as f:
            index = json.load(f)
        return all(os.path.exists(os.path.join(path, e["file"]))
                   for e in index["leaves"])
    except (OSError, ValueError, KeyError, TypeError):
        return False


def latest_step(directory: str) -> Optional[int]:
    """Newest *complete* checkpoint step (skips ``.tmp`` partials from
    killed saves, malformed names, and corrupt or incomplete step dirs)."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        s = _step_of(name)
        if s is not None and _is_complete(os.path.join(directory, name)):
            steps.append(s)
    return max(steps) if steps else None


def _restore_leaf(arr: np.ndarray, meta: Dict, device):
    if meta["is_key"]:
        if meta["shape"]:
            return prng.KeyStack(arr)
        return prng.from_key_data(arr)
    if meta["dtype"] == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.astype(meta["dtype"]))
    return t.to(device)


def restore(directory: str, step: int, like: PyTree, device=None,
            verify: bool = True) -> Tuple[PyTree, Dict]:
    """Restore step ``step`` into the structure of ``like`` (its
    ``AnalogMeta`` included); returns ``(tree, meta)``.  Leaves land on
    ``device``, or on the device of ``like``'s leaf when it is None (the
    CPU for a leaf that is not a tensor).  Raises ``IOError`` on a crc32
    mismatch (``verify``) and ``ValueError`` on a leaf count, key or shape
    that ``like`` does not have."""
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    entries = index["leaves"]
    n_like = len(_flatten_with_paths(like))
    if n_like != len(entries):
        raise ValueError(f"checkpoint has {len(entries)} leaves, model "
                         f"expects {n_like}")
    it = iter(entries)

    def load(key, leaf):
        entry = next(it)
        fpath = os.path.join(path, entry["file"])
        want = _shape(leaf)
        if entry["key"] != key or tuple(entry["shape"]) != want:
            raise ValueError(f"{fpath}: leaf {entry['key']!r} of shape "
                             f"{tuple(entry['shape'])}, model expects "
                             f"{key!r} of shape {want}")
        with open(fpath, "rb") as f:
            raw = f.read()
        if verify and zlib.crc32(raw) != entry["crc32"]:
            raise IOError(f"checksum mismatch in {fpath}")
        dev = device if device is not None else getattr(leaf, "device",
                                                        "cpu")
        return _restore_leaf(np.load(fpath), entry, dev)

    return _map_leaves(like, load), index["meta"]


def _to_numpy_host(leaf):
    """A host copy of one leaf, taken on the training thread before the
    background write: a blocking device-to-host copy on the card, and a
    real copy on the CPU too, where ``t.cpu()`` and ``t.numpy()`` share the
    tensor's storage and the next epoch's in-place update would tear the
    checkpoint being written."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    return leaf


class AsyncCheckpointer:
    """One-in-flight background checkpoint writer with retention."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree: PyTree,
             extra_meta: Optional[Dict] = None) -> None:
        self.wait()
        host_tree = _map_leaves(tree, lambda k, leaf: _to_numpy_host(leaf))
        # the metadata too: a caller's list (the trainer's history) grows
        # while the write is in flight
        host_meta = copy.deepcopy(extra_meta)

        def work():
            try:
                save(self.directory, step, host_tree, host_meta)
                self._gc()
            except BaseException as e:   # noqa: BLE001 - raised by wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def _gc(self) -> None:
        steps = []
        for n in os.listdir(self.directory):
            if n.endswith(".tmp") and n.startswith("step_"):
                # a stale partial of a killed save (one save is in flight
                # at a time, and it renames its own tmp before this runs)
                shutil.rmtree(os.path.join(self.directory, n),
                              ignore_errors=True)
                continue
            s = _step_of(n)
            if s is not None:
                steps.append(s)
        for s in sorted(steps)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)
