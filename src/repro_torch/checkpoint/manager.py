"""Checkpoint manager: step-granular, atomic, async (port of
``repro/checkpoint/manager.py``).

Fault-tolerance contract (DESIGN.md §6):
  * **atomic commit** — writes go to a ``.tmp-*`` sibling and are renamed
    into place only after every array + the manifest are written and the
    manifest fsynced; a crash mid-save never corrupts the latest good
    checkpoint.
  * **async** — ``save(...)`` copies the tree to host memory and returns
    (single writer thread, newest-wins queue); the training loop never
    blocks on the file system.
  * **resumable data** — the manifest carries the data-iterator step and
    anything else the caller puts in ``extra``.
  * retention — keeps the last ``keep`` checkpoints, deletes older ones.

The files are the reference's: ``arrays.npz`` with one array ``a{i}`` a
leaf, in JAX's flatten order, and ``manifest.json`` with the leaves'
``keystr`` names, ``extra`` and the leaves' logical PartitionSpecs as
their ``repr`` (``"specs": null`` when the caller gives none).  Leaves are
stored whole: a leaf placed on a mesh (``repro_torch.sharding.Placed``) is
gathered to the host.  **Elastic restore**: given a mesh and specs,
``restore_pytree`` places each leaf onto that mesh, so a checkpoint saved
on a 4 × 2 mesh restores onto 2 × 4, 8 × 1 or one device unchanged.  A
bfloat16 leaf is stored as the reference stores one, its 16-bit pattern as
numpy's ``|V2``.  So a checkpoint written by either package restores in the
other.  ``tmp_sibling`` also serves the durable FliX layer's snapshots.
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.core.state import resolve_device
from repro_torch.pytree import flatten_with_names, tree_leaves, tree_unflatten

_TMP_COUNTER = itertools.count()
_BF16_FILE = np.dtype("V2")  # what np.asarray of a JAX bfloat16 array saves as


def tmp_sibling(path: Path) -> Path:
    """A unique scratch sibling for atomic directory commits.

    ``path.with_suffix(".tmp")`` mangles dotted names (``step_0.5k`` →
    ``step_0.tmp``) and collides across concurrent savers; appending a
    ``.tmp-<pid>-<counter>`` suffix to the *full* name does neither.  Names
    containing ``.tmp`` are skipped by every directory listing here, so an
    abandoned scratch dir from a crashed save is inert until its owner (or
    a fresh save of the same target) cleans it up.
    """
    path = Path(path)
    return path.parent / f"{path.name}.tmp-{os.getpid()}-{next(_TMP_COUNTER)}"


def _flatten_with_names(tree):
    pairs = flatten_with_names(tree)
    return [n for n, _ in pairs], [leaf for _, leaf in pairs]


def _host_array(leaf) -> np.ndarray:
    """A leaf as a numpy array that owns its memory: a CPU tensor is copied
    too (``.numpy()`` would share it), so that a step that writes the tensor
    in place after an async ``save`` cannot reach the pending save."""
    if isinstance(leaf, sharding.Placed):  # gathered straight to the host
        leaf = leaf.tensor("cpu")
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    t = leaf.detach()
    t = t.clone() if t.device.type == "cpu" else t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_FILE)
    return t.numpy()


def _leaf_tensor(a: np.ndarray, like, dev: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")  # a copy the tensor may own and write
    if a.dtype == _BF16_FILE:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if isinstance(like, (torch.Tensor, sharding.Placed)) and tuple(like.shape) != tuple(t.shape):
        raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} for {tuple(like.shape)}")
    return t.to(dev)


def save_pytree(path: Path, tree, *, specs=None, extra: dict | None = None):
    """Synchronous atomic save of a pytree of tensors or arrays (+ optional
    PartitionSpecs, a tree of ``repro_torch.sharding.P`` parallel to it)."""
    path = Path(path)
    tmp = tmp_sibling(path)
    tmp.mkdir(parents=True)
    try:
        names, leaves = _flatten_with_names(tree)
        arrays = {f"a{i}": _host_array(leaf) for i, leaf in enumerate(leaves)}
        np.savez(tmp / "arrays.npz", **arrays)
        manifest = {"names": names, "extra": extra or {}, "specs": None}
        if specs is not None:
            manifest["specs"] = [repr(s) for s in tree_leaves(specs)]
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if path.exists():
            shutil.rmtree(path)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def restore_pytree(path: Path, like, *, device=None, mesh=None, specs=None):
    """Restore into the structure of ``like``: tensors on the card unless
    ``device`` names another, or, given ``mesh`` and ``specs``, each leaf
    read to the host and placed onto ``mesh`` by its spec (elastic restore
    onto any mesh).  Returns ``(tree, extra)``."""
    path = Path(path)
    with open(path / "manifest.json") as f:
        manifest = json.load(f)
    names, leaves = _flatten_with_names(like)
    if names != manifest["names"]:
        # the reference asserts; an AssertionError that -O cannot remove
        raise AssertionError("checkpoint/model structure mismatch")
    if mesh is not None and specs is not None:
        leaf_specs = tree_leaves(sharding.map_specs(lambda _, s: s, like, specs))
        cpu = torch.device("cpu")
        with np.load(path / "arrays.npz") as data:
            restored = [sharding.place_tensor(_leaf_tensor(data[f"a{i}"], like_leaf, cpu),
                                              s, mesh)
                        for i, (like_leaf, s) in enumerate(zip(leaves, leaf_specs))]
        return tree_unflatten(like, restored), manifest["extra"]
    dev = resolve_device(device)
    with np.load(path / "arrays.npz") as data:
        restored = [_leaf_tensor(data[f"a{i}"], like_leaf, dev)
                    for i, like_leaf in enumerate(leaves)]
    return tree_unflatten(like, restored), manifest["extra"]


class CheckpointManager:
    def __init__(self, directory: str | Path, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self._error: Exception | None = None

    # -- async API -----------------------------------------------------
    def save(self, step: int, tree, *, specs=None, extra: dict | None = None):
        """Copy ``tree`` to host memory and enqueue an async save; the
        newest request wins if the writer lags."""
        if self._error:
            raise self._error
        _, leaves = _flatten_with_names(tree)
        host_tree = tree_unflatten(tree, [_host_array(leaf) for leaf in leaves])
        try:
            self._q.put_nowait((step, host_tree, specs, extra))
        except queue.Full:
            try:
                self._q.get_nowait()  # drop the stale pending save
            except queue.Empty:
                pass
            else:
                # the dropped item still counts toward join(); without this
                # a wait() after any superseded save deadlocks
                self._q.task_done()
            self._q.put_nowait((step, host_tree, specs, extra))

    def wait(self):
        self._q.join()
        if self._error:
            raise self._error

    def _run(self):
        while True:
            step, tree, specs, extra = self._q.get()
            try:
                kw = {} if specs is None else {"specs": specs}
                save_pytree(self.dir / f"step_{step:08d}", tree, extra=extra, **kw)
                self._gc()
            except Exception as e:  # noqa: BLE001 — surface on next call
                self._error = e
            finally:
                self._q.task_done()

    # -- sync API --------------------------------------------------------
    def latest_step(self) -> int | None:
        steps = sorted(
            int(p.name.split("_")[1])
            for p in self.dir.glob("step_*")
            if p.is_dir() and ".tmp" not in p.name
        )
        return steps[-1] if steps else None

    def restore_latest(self, like, *, device=None, mesh=None, specs=None):
        """``(step, tree, extra)`` of the newest checkpoint, or three Nones."""
        step = self.latest_step()
        if step is None:
            return None, None, None
        tree, extra = restore_pytree(self.dir / f"step_{step:08d}", like, device=device,
                                     mesh=mesh, specs=specs)
        return step, tree, extra

    def _gc(self):
        steps = sorted(p for p in self.dir.glob("step_*") if ".tmp" not in p.name)
        for p in steps[: -self.keep]:
            shutil.rmtree(p, ignore_errors=True)
