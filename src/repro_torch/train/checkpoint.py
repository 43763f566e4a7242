"""Checkpointing: the JAX package's ``train/checkpoint.py`` and its on-disk
layout, so that a checkpoint written by either package restores in the
other.

  * one ``step_XXXXXXXX/`` directory per step, holding ``manifest.json``
    (``step``, ``extra``, and each leaf's shape and dtype) and one ``.npy``
    per leaf, named by its tree path joined with ``__`` (the tree walked in
    ``jax.tree`` order, ``models.convert.flatten``);
  * written into a temporary directory, then renamed into place, so a
    worker dying mid-save never corrupts the latest checkpoint;
  * ``AsyncCheckpointer`` snapshots to host memory synchronously and
    writes in a background thread;
  * elastic restore: the files hold whole leaves whatever mesh wrote them
    (over data and model ranks, rank 0 writes the leaves gathered by their
    layouts), and ``restore(..., shardings=, mesh=)`` places each leaf as
    this rank's block on any other mesh: a spec's block, or the block a
    function of the whole leaf cuts (a leaf's executed layout,
    ``models.convert.Leaf.take``).

A tree is nested dicts / lists whose leaves are tensors (or numpy arrays).
bfloat16 leaves: numpy writes an ``ml_dtypes.bfloat16`` array with the
descr ``'<V2'``, and the port has no ``ml_dtypes``, so it writes and reads
the bits as ``uint16`` under that descr, the dtype named in the manifest.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time

import numpy as np
import torch

from ..models.convert import flatten, nest, to_numpy
from ..parallel.sharding import local_shard

MANIFEST = "manifest.json"
BF16 = "bfloat16"


def _flatten_with_names(tree) -> list:
    return [("__".join(map(str, path)), leaf)
            for path, leaf in flatten(tree)]


def _host(leaf) -> tuple:
    """(numpy array, dtype name) of a leaf, a copy that later writes to the
    leaf do not reach; bfloat16 as its uint16 bits."""
    if torch.is_tensor(leaf):
        arr = to_numpy(leaf)
        if leaf.device.type == "cpu":          # to_numpy shares its memory
            arr = arr.copy()
        return arr, str(leaf.dtype).removeprefix("torch.")
    arr = np.asarray(leaf)
    if arr.dtype.name == BF16:                  # an ml_dtypes array
        return arr.view(np.uint16), BF16
    return arr, str(arr.dtype)


def _save_leaf(path: pathlib.Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != BF16:
        np.save(path, arr)
        return
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:          # np.save's bytes for a bf16 array
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(arr.tobytes())


def _load_leaf(path: pathlib.Path, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _write(directory, step: int, named: list, extra) -> pathlib.Path:
    d = pathlib.Path(directory)
    final = d / f"step_{step:08d}"
    tmp = d / f".tmp_step_{step:08d}_{time.time_ns()}"
    tmp.mkdir(parents=True, exist_ok=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for name, (arr, dtype) in named:
        _save_leaf(tmp / f"{name}.npy", arr, dtype)
        manifest["leaves"][name] = {"shape": list(arr.shape), "dtype": dtype}
    (tmp / MANIFEST).write_text(json.dumps(manifest, indent=2))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def save(directory, step: int, tree, extra: dict | None = None
         ) -> pathlib.Path:
    """Synchronous atomic checkpoint of ``tree`` at ``step``."""
    return _write(directory, step, [(name, _host(leaf)) for name, leaf
                                    in _flatten_with_names(tree)], extra)


class AsyncCheckpointer:
    """Snapshot to host synchronously, write in a daemon thread."""

    def __init__(self, directory, keep_last: int = 3):
        self.directory = pathlib.Path(directory)
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree, extra: dict | None = None):
        self.wait()                                  # one in flight at a time
        named = [(name, _host(leaf)) for name, leaf
                 in _flatten_with_names(tree)]

        def _write_and_clean():
            _write(self.directory, step, named, extra)
            cleanup(self.directory, self.keep_last)

        self._thread = threading.Thread(target=_write_and_clean, daemon=True)
        self._thread.start()


def steps(directory) -> list:
    d = pathlib.Path(directory)
    if not d.exists():
        return []
    out = []
    for p in d.iterdir():
        if p.is_dir() and p.name.startswith("step_") \
                and (p / MANIFEST).exists():
            out.append(int(p.name.split("_")[1]))
    return sorted(out)


def latest_step(directory):
    s = steps(directory)
    return s[-1] if s else None


def cleanup(directory, keep_last: int = 3):
    for s in steps(directory)[:-keep_last]:
        shutil.rmtree(pathlib.Path(directory) / f"step_{s:08d}",
                      ignore_errors=True)


def _at(tree, path):
    """The entry of ``tree`` at ``path`` (a spec tuple is an entry)."""
    for key in path:
        tree = tree[key]
    return tree


def restore(directory, step: int, like, shardings=None, mesh=None) -> tuple:
    """Load a checkpoint into the structure of ``like`` (a tree of tensors
    with the leaves' whole shapes): ``(tree, extra)``, each leaf cast to
    its ``like`` leaf's dtype and put on its device.

    ``shardings``: the elastic path — the structure of ``like`` with a spec
    (``parallel.sharding``), a function of the whole leaf, or ``None`` at
    each leaf; a leaf with a spec comes back as this rank's block of it on
    ``mesh``, one with a function as what it returns (a rank's block under
    the executed layout: ``like`` then has the whole shapes)."""
    d = pathlib.Path(directory) / f"step_{step:08d}"
    manifest = json.loads((d / MANIFEST).read_text())
    pairs = []
    for path, ref in flatten(like):
        name = "__".join(map(str, path))
        t = _load_leaf(d / f"{name}.npy", manifest["leaves"][name]["dtype"])
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)} != "
                             f"{tuple(ref.shape)}")
        s = None if shardings is None else _at(shardings, path)
        if callable(s):
            t = s(t).clone()
        elif s is not None:
            t = local_shard(t, s, mesh).clone()
        pairs.append((path, t.to(device=ref.device, dtype=ref.dtype)))
    return nest(pairs), manifest["extra"]
