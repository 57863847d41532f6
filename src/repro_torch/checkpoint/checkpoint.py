"""Checkpointing: atomic, restart-safe directories of ``.npy`` leaves.

Port of ``repro.checkpoint.checkpoint`` (``save_checkpoint``, ``_gc``,
``latest_step``, ``load_checkpoint``), in the reference's format, so that
either package reads the other's checkpoints: one directory per step,
``step_NNNNNNNNNN``, holding ``leafNNNNN.npy`` files (the leaves in sorted
key order) and a ``manifest.json`` with the step, each leaf's key, file,
logical dtype and shape, the caller's ``extra`` and the time.

A tree is a nested dict / list / tuple / NamedTuple of tensors (or numpy
arrays); its leaves are keyed by their path joined with "/"
(``cache/attn/k``; a NamedTuple field as ``.name``, so a training state
``(params, AdamWState)`` has ``1/.m/embed/tok``), as the reference keys a
pytree. bfloat16, which numpy cannot hold, is saved as
the uint16 view of its bits with the logical dtype "bfloat16" in the
manifest, and loaded back by reinterpreting those bits in torch; numpy
leaves load as torch tensors on the CPU.

Writes go to a ``.tmp-<step>-<pid>`` directory; every file, the directory
and, after ``os.replace`` publishes it, the parent directory are fsync'd,
so once ``save_checkpoint`` returns the step survives a power cut, and a
kill mid-write leaves the previous steps untouched. Stale ``.tmp-*``
directories of writers that died are swept at the next save and are
invisible to ``latest_step`` and ``load_checkpoint``.

``CheckpointManager`` is the training loop's writer: ``maybe_save`` copies
the tree to host memory synchronously (so the loop may go on updating its
tensors) and writes it on a thread; a write's error surfaces at the next
``wait`` (or ``maybe_save``); ``restore_or_none`` resumes from the latest
step.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _items(tree):
    """(key, child) pairs of a tree node, None for a leaf: dict items,
    NamedTuple fields as ".name" (jax's GetAttrKey), list and tuple items
    by index."""
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{"a/b/c": leaf} over nested dicts, lists, tuples and NamedTuples,
    the reference's pytree keys."""
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _to_numpy(leaf):
    """(numpy array, logical dtype name) of a tensor or array leaf; bf16,
    which numpy cannot hold, as the uint16 view of its bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _fsync_path(path):
    """fsync a file or directory by path: its data (or a directory's
    entries) on disk, not only in the page cache."""
    fd = os.open(str(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_checkpoint(ckpt_dir: str, step: int, tree,
                    extra: Optional[dict] = None, keep: int = 3) -> str:
    """Publish ``tree`` as step ``step`` under ``ckpt_dir`` atomically and
    durably, keep the newest ``keep`` steps; returns the step directory."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    # leftovers of writers that died mid-save: published steps never match
    for stale in ckpt_dir.glob(".tmp-*"):
        shutil.rmtree(stale, ignore_errors=True)
    tmp = ckpt_dir / f".tmp-{step}-{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "keys": [], "extra": extra or {},
                "time": time.time()}
    for i, (key, leaf) in enumerate(sorted(_flatten(tree).items())):
        arr, logical = _to_numpy(leaf)
        fname = f"leaf{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["keys"].append({"key": key, "file": fname,
                                 "dtype": logical,
                                 "shape": list(arr.shape)})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    # the durability barrier, in dependency order: the files' data, the
    # tmp dir's entries, the rename, then the parent dir holding it
    for f in tmp.iterdir():
        _fsync_path(f)
    _fsync_path(tmp)
    final = ckpt_dir / f"step_{step:010d}"
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    _fsync_path(ckpt_dir)
    _gc(ckpt_dir, keep)
    return str(final)


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(ckpt_dir.glob("step_*"))
    for old in steps[:-keep]:
        shutil.rmtree(old, ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = sorted(Path(ckpt_dir).glob("step_*"))
    if not steps:
        return None
    return int(steps[-1].name.split("_")[1])


def _rebuild(tree_like, by_key, prefix: str = ""):
    items = _items(tree_like)
    if items is None:
        return by_key[prefix]
    out = [_rebuild(v, by_key, f"{prefix}/{k}" if prefix else str(k))
           for k, v in items]
    if isinstance(tree_like, dict):
        return dict(zip(tree_like, out))
    if hasattr(tree_like, "_fields"):
        return type(tree_like)(*out)
    return type(tree_like)(out)


def load_checkpoint(ckpt_dir: str, tree_like,
                    step: Optional[int] = None) -> Tuple[Any, int, dict]:
    """Restore into the structure of ``tree_like`` (its leaves only name
    the keys). Returns (tree of CPU tensors, step, extra)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:010d}"
    manifest = json.loads((d / "manifest.json").read_text())
    by_key = {}
    for e in manifest["keys"]:
        arr = np.load(d / e["file"])
        if e["dtype"] == "bfloat16":
            by_key[e["key"]] = torch.from_numpy(arr.view(np.int16)).view(
                torch.bfloat16)
        else:
            by_key[e["key"]] = torch.from_numpy(arr)
    flat_like = _flatten(tree_like)
    if set(flat_like) != set(by_key):
        raise ValueError(f"checkpoint/tree mismatch: "
                         f"{sorted(set(flat_like) ^ set(by_key))}")
    return _rebuild(tree_like, by_key), manifest["step"], manifest["extra"]


def _host_copy(tree):
    """The tree with every tensor leaf copied to host memory (a
    synchronous device-to-host copy) and every numpy leaf copied."""
    items = _items(tree)
    if items is None:
        if isinstance(tree, torch.Tensor):
            return tree.detach().to("cpu", copy=True)
        return np.array(tree)
    out = [_host_copy(v) for _, v in items]
    if isinstance(tree, dict):
        return dict(zip(tree, out))
    if hasattr(tree, "_fields"):
        return type(tree)(*out)
    return type(tree)(out)


class CheckpointManager:
    """Async save and resume for a training loop. ``maybe_save`` snapshots
    the tree to host memory synchronously (cheap next to a step) and
    writes it on a worker thread; one write is in flight at a time."""

    def __init__(self, ckpt_dir: str, keep: int = 3, every: int = 100):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.every = every
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def maybe_save(self, step: int, tree, extra: Optional[dict] = None,
                   blocking: bool = False):
        """Save ``tree`` as ``step`` if ``step`` is a multiple of
        ``every``: after the previous write has ended (its error raised
        here), from a host copy taken now, on a thread (``blocking``:
        waited for)."""
        if step % self.every:
            return
        self.wait()
        host_tree = _host_copy(tree)

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree, extra,
                                self.keep)
            except BaseException as e:   # noqa: BLE001 — raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        """Join the write in flight; raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_or_none(self, tree_like):
        """(tree of CPU tensors, step, extra) of the latest step, or None
        when the directory holds none."""
        try:
            return load_checkpoint(self.ckpt_dir, tree_like)
        except FileNotFoundError:
            return None
