"""Checkpoints of the port's training state: atomic, async, with retention.

Port of `repro.checkpoint.manager`, in the same on-disk format, so a
checkpoint either package writes restores in the other:

  * `<dir>/step-%010d/arrays.npz` holds every leaf packed by `qsave`
    (integer payloads + pow2 grid exponents; `packed=False` writes dense
    arrays) and `meta.json` holds {"step", "aux", "time", "qsave",
    "report"};
  * leaves are keyed by their path in the tree, as the reference keys a
    JAX pytree path: dict keys in sorted order, list and tuple indices,
    dataclass field names (`MomentumState`'s "acc" and "step", as the
    reference's NamedTuple gives them; a QTensor's tensor fields), joined
    by "/"; a Python int (`MomentumState.step`) is an int32 0-d leaf.  So
    `(params, opt_state)` keys as "0/layers/wq", "1/acc/layers/wq", "1/step";
  * writes go to `<dir>/tmp-<step>` and publish by os.rename, so a crash
    mid-write never corrupts the latest checkpoint; stale `tmp-*` dirs are
    swept at construction;
  * `save` copies every leaf to host memory on the caller's thread before
    it returns (the training step updates parameters and accumulators in
    place, and a CPU tensor's `.numpy()` shares its memory), then packs
    and writes on a writer thread; `wait()` joins it and re-raises its
    error;
  * retention keeps the newest `keep` checkpoints;
  * `restore(target)` copies into the target's tensors IN PLACE, on their
    device and in their dtype, and sets a `MomentumState`'s step.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.core.qtensor import QTensor

from . import qsave


def _children(tree):
    """(key, slot, child) of a container node in the reference's pytree
    order, or None for a leaf: `key` names the child in a checkpoint key,
    `slot` is where it sits (dict key, index or field).  None children are
    empty subtrees, as in a JAX pytree."""
    if isinstance(tree, dict):
        items = [(str(k), k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), i, v) for i, v in enumerate(tree)]
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        if isinstance(tree, QTensor):
            names.remove("k")              # static in the reference's pytree
        items = [(n, n, getattr(tree, n)) for n in names]
    else:
        return None
    return [item for item in items if item[2] is not None]


def tree_keys(tree, prefix: str = "") -> list:
    """(key, leaf) of every leaf of `tree`, in the reference's order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [kv for k, _, v in kids
            for kv in tree_keys(v, f"{prefix}/{k}" if prefix else k)]


def _host_array(leaf) -> np.ndarray:
    """A host copy of a leaf that no later in-place update can reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    if type(leaf) is int:       # MomentumState.step: the reference's int32
        return np.asarray(leaf, np.int32)
    return np.array(leaf, copy=True)


def flatten_with_paths(tree) -> dict:
    """{key: host copy} of every leaf of `tree`."""
    return {key: _host_array(leaf) for key, leaf in tree_keys(tree)}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True,
                 packed: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self.packed = packed
        os.makedirs(directory, exist_ok=True)
        # staging dirs of a killed writer are never restorable (publish is
        # the rename), and a later save of the same step starts clean
        for name in os.listdir(directory):
            if name.startswith("tmp-"):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)
        self._lock = threading.Lock()
        self._pending: threading.Thread | None = None
        self._write_error: BaseException | None = None
        self._fail_next_write = False       # chaos hook: die before publish
        self.last_report: dict | None = None

    # ------------- save -------------

    def save(self, step: int, tree, aux: dict | None = None,
             block: bool = False) -> None:
        """Snapshot on the caller's thread (a host copy of every leaf),
        then write on the writer thread (or here if `block` or not
        async_write)."""
        arrays = flatten_with_paths(tree)
        meta = {"step": int(step), "aux": aux or {}, "time": time.time()}
        if self.async_write and not block:
            self.wait()
            t = threading.Thread(target=self._write_guarded,
                                 args=(step, arrays, meta), daemon=True)
            t.start()
            self._pending = t
        else:
            self._write(step, arrays, meta)

    def _write_guarded(self, step, arrays, meta):
        try:
            self._write(step, arrays, meta)
        except BaseException as e:  # noqa: BLE001 - re-raised by wait()
            self._write_error = e

    def _write(self, step, arrays, meta):
        with self._lock:
            tmp = os.path.join(self.dir, f"tmp-{step}")
            final = os.path.join(self.dir, f"step-{step:010d}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            if self.packed:
                payload, fmt = qsave.pack_tree(arrays)
                meta = dict(meta, qsave=fmt, report=qsave.report(fmt))
            else:
                payload = arrays
            np.savez(os.path.join(tmp, "arrays.npz"), **payload)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if self._fail_next_write:       # simulated kill mid-save: tmp
                self._fail_next_write = False   # written, never published
                raise RuntimeError(f"injected writer crash at step {step}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)           # atomic publish
            self.last_report = meta.get("report")
            self._gc()

    def wait(self) -> None:
        """Join the pending write; re-raise the writer thread's error."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._write_error is not None:
            e, self._write_error = self._write_error, None
            raise e

    def _gc(self):
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step-{s:010d}"),
                          ignore_errors=True)

    # ------------- restore -------------

    def all_steps(self) -> list:
        return sorted(int(name.split("-")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step-"))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step):
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        return step, os.path.join(self.dir, f"step-{step:010d}")

    def meta(self, step: int | None = None) -> dict:
        """meta.json of a checkpoint (step/aux/time + qsave format/report)."""
        _, d = self._step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            return json.load(f)

    def size_report(self, step: int | None = None) -> dict:
        """qsave bytes-vs-dense-f32 report + the bytes on disk."""
        step, d = self._step_dir(step)
        rep = dict(self.meta(step).get("report") or {})
        rep["disk_bytes"] = sum(os.path.getsize(os.path.join(d, n))
                                for n in os.listdir(d))
        return rep

    def restore(self, target, step: int | None = None):
        """Restore into `target` (a tree of tensors, arrays and ints, e.g.
        `(params, opt_state)`): every key set and shape is checked first,
        then tensors are overwritten in place, on their device and in
        their dtype; arrays and ints are replaced by the checkpoint's,
        cast to the target's dtype.  Returns (target, step, aux)."""
        step, d = self._step_dir(step)
        meta = self.meta(step)
        fmt = meta.get("qsave")
        with np.load(os.path.join(d, "arrays.npz")) as data:
            need = dict(tree_keys(target))
            have = set(fmt) if fmt is not None else set(data.files)
            if set(need) != have:
                raise ValueError(
                    f"checkpoint step {step} does not match the target tree: "
                    f"missing keys {sorted(set(need) - have)[:8]}, "
                    f"unexpected keys {sorted(have - set(need))[:8]} "
                    f"(checkpoint has {len(have)} arrays, target wants "
                    f"{len(need)})")
            arrays = {}
            for key, ref in need.items():
                arr = (qsave.unpack_array(data, key, fmt[key])
                       if fmt is not None else data[key])
                if arr.shape != tuple(np.shape(ref)):
                    raise ValueError(f"checkpoint leaf {key}: shape "
                                     f"{arr.shape} != target "
                                     f"{tuple(np.shape(ref))}")
                arrays[key] = arr
        return _fill(target, arrays, ""), meta["step"], meta["aux"]


@torch.no_grad()
def _fill(tree, arrays: dict, prefix: str):
    """Write `arrays` into `tree` (see restore); returns the filled node."""
    kids = _children(tree)
    if kids is None:
        arr = arrays[prefix]
        if isinstance(tree, torch.Tensor):
            return tree.copy_(torch.from_numpy(np.asarray(arr)))
        if type(tree) is int:
            return int(arr)
        return arr.astype(np.asarray(tree).dtype)
    new = [(slot, v, _fill(v, arrays, f"{prefix}/{k}" if prefix else k))
           for k, slot, v in kids]
    if isinstance(tree, tuple):
        return tuple(filled for _, _, filled in new)
    for slot, v, filled in new:
        if filled is not v:             # ints and arrays; tensors are filled
            if isinstance(tree, (dict, list)):
                tree[slot] = filled
            else:
                setattr(tree, slot, filled)
    return tree
