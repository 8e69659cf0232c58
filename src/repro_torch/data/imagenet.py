"""Real-data ImageNet-style input pipeline (npz shards on disk).

A numpy copy of the reference package's `data/imagenet.py` (the port
imports nothing of it), so both packages read the same bytes into the same
batches.  Batches are a pure function of (seed, step, sample index), so
any host can materialize exactly its slice of the global batch.

On-disk format: a directory of ``*.npz`` shards, two layouts accepted:

  * ``images`` (N, H, W, 3) uint8 + ``labels`` (N,) int: the native
    layout (what `write_demo_dataset` emits);
  * ``data`` (N, 3*S*S) uint8 row-major CHW + ``labels`` (N,) 1-based
    int: the downsampled-ImageNet (Imagenet32/64) / CIFAR batch layout.

Files whose name contains ``val`` form the held-out split; without any,
the last ~10% of the training samples are reserved.  Pixels map to
(x - 128) / 128 in [-1, 1): exactly the signed 8-bit fixed-point grid
2^(1-8).  Augmentation (pad-4 reflect, random crop, horizontal flip) is
seeded per (seed, step, global sample index).

``python -m repro_torch.data.imagenet --write-demo DIR`` materializes a
small learnable dataset in the native layout.
"""
from __future__ import annotations

import argparse
import glob
import os
from dataclasses import dataclass, field

import numpy as np

from .synthetic import ImageTask, host_local_slice


def _load_npz(path: str):
    """One shard -> (images uint8 NHWC, labels int32 0-based)."""
    with np.load(path) as z:
        if "images" in z:
            imgs = np.asarray(z["images"], dtype=np.uint8)
            labels = np.asarray(z["labels"], dtype=np.int64)
        elif "data" in z:
            flat = np.asarray(z["data"], dtype=np.uint8)
            side = int(round((flat.shape[1] // 3) ** 0.5))
            imgs = flat.reshape(-1, 3, side, side).transpose(0, 2, 3, 1)
            labels = np.asarray(z["labels"], dtype=np.int64)
            if labels.min() >= 1:            # Imagenet32/CIFAR are 1-based
                labels = labels - 1
        else:
            raise ValueError(f"{path}: expected 'images' or 'data' key, "
                             f"got {sorted(z.files)}")
    if imgs.ndim != 4 or imgs.shape[-1] != 3:
        raise ValueError(f"{path}: bad image shape {imgs.shape}")
    return imgs, labels.astype(np.int32)


@dataclass
class NpzImageTask:
    """Disk-backed image task with the synthetic tasks' batch protocol.

    batch(step, shard_idx, n_shards) -> {"images": f32 (n,H,W,3) on the
    2^-7 grid, "labels": int32}; holdout_batch(i) serves the val split
    (no augmentation).  Samples are drawn through a per-epoch permutation
    (epoch = how many times `step * global_batch` has wrapped the train
    set), so every epoch visits each sample once in a seed-fixed order.
    """

    data_dir: str
    global_batch: int
    augment: bool = True
    seed: int = 0
    pad: int = 4

    _train: tuple = field(init=False, repr=False)
    _val: tuple = field(init=False, repr=False)

    def __post_init__(self):
        files = sorted(glob.glob(os.path.join(self.data_dir, "*.npz")))
        if not files:
            raise FileNotFoundError(
                f"no *.npz shards under {self.data_dir!r} (see "
                f"repro_torch.data.imagenet module docstring for the layout)")
        val_files = [f for f in files if "val" in os.path.basename(f)]
        train_files = [f for f in files if f not in val_files] or files
        ti, tl = zip(*(_load_npz(f) for f in train_files))
        imgs, labels = np.concatenate(ti), np.concatenate(tl)
        if val_files:
            vi, vl = zip(*(_load_npz(f) for f in val_files))
            self._train = (imgs, labels)
            self._val = (np.concatenate(vi), np.concatenate(vl))
        else:                       # reserve the tail ~10% as holdout
            n_val = max(1, len(imgs) // 10)
            self._train = (imgs[:-n_val], labels[:-n_val])
            self._val = (imgs[-n_val:], labels[-n_val:])

    @property
    def img_size(self) -> int:
        return int(self._train[0].shape[1])

    @property
    def num_classes(self) -> int:
        return int(max(self._train[1].max(), self._val[1].max())) + 1

    @property
    def n_train(self) -> int:
        return len(self._train[0])

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        rs = np.random.RandomState(
            (self.seed * 1_000_003 + epoch * 97) % (2 ** 31))
        return rs.permutation(self.n_train)

    def batch(self, step: int, shard_idx: int = 0, n_shards: int = 1) -> dict:
        start, count = host_local_slice(self.global_batch, shard_idx,
                                        n_shards)
        imgs, labels = self._train
        pos0 = step * self.global_batch + start
        # positions may straddle an epoch boundary: resolve per sample
        pos = pos0 + np.arange(count)
        epochs = pos // self.n_train
        idx = np.empty(count, dtype=np.int64)
        for e in np.unique(epochs):
            m = epochs == e
            idx[m] = self._epoch_perm(int(e))[pos[m] % self.n_train]
        x = imgs[idx]
        if self.augment:
            x = self._augment(x, step, start)
        return {"images": _to_grid(x), "labels": labels[idx].copy()}

    def holdout_batch(self, i: int) -> dict:
        imgs, labels = self._val
        n = len(imgs)
        idx = (i * self.global_batch + np.arange(self.global_batch)) % n
        return {"images": _to_grid(imgs[idx]), "labels": labels[idx].copy()}

    def _augment(self, x: np.ndarray, step: int, start: int) -> np.ndarray:
        n, s, _, c = x.shape
        p = self.pad
        padded = np.pad(x, ((0, 0), (p, p), (p, p), (0, 0)), mode="reflect")
        out = np.empty_like(x)
        for i in range(n):
            # per-GLOBAL-sample seeding: shard slices compose bitwise with
            # the full batch (any host materializes exactly its rows)
            rs = np.random.RandomState(
                (self.seed * 1_000_003 + step * 7919
                 + (start + i) * 101 + 13) % (2 ** 31))
            oy, ox = rs.randint(0, 2 * p + 1, size=2)
            flip = bool(rs.randint(0, 2))
            crop = padded[i, oy:oy + s, ox:ox + s]
            out[i] = crop[:, ::-1] if flip else crop
        return out


def _to_grid(x_u8: np.ndarray) -> np.ndarray:
    """uint8 -> f32 on the signed 2^(1-8) fixed-point grid in [-1, 1)."""
    return (x_u8.astype(np.float32) - 128.0) / 128.0


def write_demo_dataset(data_dir: str, *, n: int = 4096, img_size: int = 16,
                       num_classes: int = 8, seed: int = 0,
                       val_frac: float = 0.125) -> dict:
    """Materialize a small learnable dataset in the native npz layout.

    Same class-conditional-blob distribution as the synthetic ImageTask,
    but rendered to uint8 files — so tests/CI drive the REAL disk pipeline
    (shard loading, epoch permutation, augmentation, 8-bit input grid)
    with bytes that a reduced ResNet can actually learn.
    """
    os.makedirs(data_dir, exist_ok=True)
    rs = np.random.RandomState(seed)
    proto_rs = np.random.RandomState(seed + 12345)
    protos = proto_rs.randn(num_classes, img_size, img_size, 3)
    labels = rs.randint(0, num_classes, size=n).astype(np.int32)
    x = protos[labels] + 0.8 * rs.randn(n, img_size, img_size, 3)
    imgs = np.clip(np.round(x * 24.0 + 128.0), 0, 255).astype(np.uint8)
    n_val = max(1, int(n * val_frac))
    paths = {}
    for name, sl in (("train_000.npz", slice(0, n - n_val)),
                     ("val_000.npz", slice(n - n_val, n))):
        path = os.path.join(data_dir, name)
        np.savez(path, images=imgs[sl], labels=labels[sl])
        paths[name] = path
    return {"n_train": n - n_val, "n_val": n_val, "paths": paths}


def resolve_image_task(global_batch: int, *, data_dir: str | None = None,
                       synthetic: bool = False, img_size: int = 16,
                       num_classes: int = 8, seed: int = 1):
    """Benchmark data resolver: the real npz pipeline when a data dir is
    configured (REPRO_DATA_DIR or explicit), the synthetic blob task
    otherwise or when `synthetic` forces the fallback.

    Returns (task, tag) where tag is "real:<dir>" or "synthetic" — the
    paper-table benchmarks stamp it into every emitted row.
    """
    data_dir = data_dir or os.environ.get("REPRO_DATA_DIR", "")
    if data_dir and not synthetic:
        task = NpzImageTask(data_dir, global_batch=global_batch, seed=seed)
        return task, f"real:{os.path.basename(os.path.normpath(data_dir))}"
    task = ImageTask(img_size=img_size, num_classes=num_classes,
                     global_batch=global_batch, seed=seed)
    return task, "synthetic"


def main(argv=None):
    p = argparse.ArgumentParser("repro_torch.data.imagenet")
    p.add_argument("--write-demo", metavar="DIR",
                   help="materialize a learnable demo dataset (native npz "
                        "layout) under DIR")
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--img-size", type=int, default=16)
    p.add_argument("--classes", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.write_demo:
        info = write_demo_dataset(args.write_demo, n=args.n,
                                  img_size=args.img_size,
                                  num_classes=args.classes, seed=args.seed)
        print(f"[data] wrote demo dataset: {info['n_train']} train / "
              f"{info['n_val']} val ({args.img_size}x{args.img_size}, "
              f"{args.classes} classes) -> {args.write_demo}")
        return
    p.error("nothing to do (pass --write-demo DIR)")


if __name__ == "__main__":
    main()
