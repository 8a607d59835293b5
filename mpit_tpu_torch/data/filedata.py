"""File-based classification datasets: memory-mapped npy directories.
The port's copy of the classification half of
:mod:`mpit_tpu.data.filedata`; the same files, seeds and flags give the
same batches, bit for bit.

On-disk format:

    <data_dir>/
      meta.json              {"kind": "classification", "num_classes": N}
      train_images.npy       [N, H, W, C] uint8 or float32
      train_labels.npy       [N] integer
      val_images.npy         (optional; eval falls back to train)
      val_labels.npy

Arrays are opened with ``np.load(mmap_mode="r")``: nothing is read until
a batch gathers its rows. uint8 images are normalised to float32 in
[0, 1) as a batch is assembled. :func:`write_classification` writes a
split; :func:`open_classification_images` and
:func:`finalize_classification` stream one to disk row by row.

Not here: the language-model directories (``kind: lm``, the JAX
package's ``FileLM``) and the C++ augmentation behind ``--native``,
which arrive with the data-pipeline slice of the port.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator

import numpy as np

from mpit_tpu_torch.data.augment import augment_images, center_crop, random_resized_crop

__all__ = [
    "FileClassification", "finalize_classification", "load_dataset",
    "open_classification_images", "write_classification",
]

_META = "meta.json"


def _mmap(path: str) -> np.ndarray:
    return np.load(path, mmap_mode="r")


def _split_path(data_dir: str, split: str, name: str) -> str:
    return os.path.join(data_dir, f"{split}_{name}.npy")


def load_dataset(data_dir: str, **kw):
    """Open ``data_dir`` as the classification dataset its meta.json
    declares; an ``lm`` directory raises, naming the slice that brings
    it."""
    with open(os.path.join(data_dir, _META)) as f:
        meta = json.load(f)
    kind = meta.get("kind")
    if kind == "classification":
        return FileClassification(data_dir, **kw)
    if kind == "lm":
        raise NotImplementedError(
            f"{data_dir}: an lm dataset (FileLM) arrives with the data-pipeline slice of "
            "the port (ROADMAP.md §A 12)"
        )
    raise ValueError(f"{data_dir}: unknown dataset kind {kind!r}")


@dataclasses.dataclass
class FileClassification:
    """Image-classification dataset from a directory of npy files.

    Same interface as ``SyntheticClassification`` (the workload scripts'
    duck type): infinite shuffled-epoch ``batches``, the ordered
    ``val_batches`` sweep and a held-out ``eval_batch``.
    """

    data_dir: str
    seed: int = 0
    normalize: bool = True  # uint8 -> float32 in [0, 1)
    # Train-split augmentation (data/augment.py). Applied to batches()
    # only — eval_batch/val_batches always see deterministic images.
    # Per-batch counter-seeded, so skip=N resume replays the augmented
    # stream exactly. Two modes:
    #   "shift": random shift-crop (crop_pad) + hflip — MNIST-grade.
    #   "rrc":   random-resized-crop (scale/aspect jitter, ImageNet-grade)
    #            to train_size (0 = stored size); the val/eval side is
    #            center-cropped to the same size so shapes agree.
    augment: bool = False
    augment_mode: str = "shift"
    crop_pad: int = 4
    hflip: bool = True
    train_size: int = 0
    rrc_scale: tuple = (0.08, 1.0)
    rrc_ratio: tuple = (3 / 4, 4 / 3)

    def __post_init__(self):
        if self.augment_mode not in ("shift", "rrc"):
            # A typo here would otherwise silently train with the wrong
            # augmentation.
            raise ValueError(
                f"augment_mode must be 'shift' or 'rrc', got "
                f"{self.augment_mode!r}"
            )
        with open(os.path.join(self.data_dir, _META)) as f:
            self.meta = json.load(f)
        if self.meta.get("kind") != "classification":
            raise ValueError(
                f"{self.data_dir}: meta.json kind is {self.meta.get('kind')!r},"
                " expected 'classification'"
            )
        self.num_classes = int(self.meta["num_classes"])
        self._images = _mmap(_split_path(self.data_dir, "train", "images"))
        self._labels = np.asarray(
            _mmap(_split_path(self.data_dir, "train", "labels"))
        ).astype(np.int32)
        if len(self._images) != len(self._labels):
            raise ValueError(
                f"{self.data_dir}: train images ({len(self._images)}) and "
                f"labels ({len(self._labels)}) disagree"
            )
        val = _split_path(self.data_dir, "val", "images")
        self._val_images = _mmap(val) if os.path.exists(val) else None
        self._val_labels = (
            np.asarray(
                _mmap(_split_path(self.data_dir, "val", "labels"))
            ).astype(np.int32)
            if self._val_images is not None
            else None
        )

    def __len__(self) -> int:
        return len(self._images)

    @property
    def stored_image_shape(self) -> tuple[int, ...]:
        """Shape of the rows on disk (pre-crop)."""
        return tuple(self._images.shape[1:])

    @property
    def image_shape(self) -> tuple[int, ...]:
        """Shape of the images batches actually yield — ``train_size``
        when set (the model-geometry number), else the stored shape."""
        stored = self.stored_image_shape
        if self.train_size and len(stored) == 3:
            return (self.train_size, self.train_size, stored[2])
        return stored

    def _assemble(self, images: np.ndarray) -> np.ndarray:
        out = np.ascontiguousarray(images)
        if self.normalize and out.dtype == np.uint8:
            out = out.astype(np.float32) / 255.0
        return out.astype(np.float32, copy=False)

    def _out_hw(self) -> tuple[int, int] | None:
        """(H, W) every yielded batch must have; None = stored size."""
        if not self.train_size:
            return None
        return (self.train_size, self.train_size)

    def _eval_view(self, images: np.ndarray) -> np.ndarray:
        """Deterministic val/eval-side geometry: center-crop to the train
        size so eval batches match the model the train stream shaped."""
        hw = self._out_hw()
        if hw is None or images.shape[1:3] == hw:
            return images
        return center_crop(images, *hw)

    def batches(
        self,
        batch_size: int,
        *,
        seed: int | None = None,
        skip: int = 0,
    ) -> Iterator[dict[str, np.ndarray]]:
        """Infinite stream of ``{"image": [B,...] f32, "label": [B] i32}``:
        a fresh seeded shuffle every epoch, last partial batch dropped
        (every batch of one shape). ``skip=N``
        fast-forwards to batch N drawing only the epoch permutations —
        no batch assembly/IO for the skipped range (checkpoint resume)."""
        n = len(self)
        if batch_size > n:
            raise ValueError(
                f"batch_size {batch_size} exceeds dataset size {n}"
            )
        base = self.seed + 1 if seed is None else seed
        rng = np.random.RandomState(base)
        produced = 0
        while True:
            order = rng.permutation(n)
            for lo in range(0, n - batch_size + 1, batch_size):
                if produced < skip:
                    produced += 1
                    continue
                idx = np.sort(order[lo : lo + batch_size])  # mmap-friendly
                images = self._assemble(self._images[idx])
                if self.augment:
                    # Counter-based per-batch RNG (independent of the
                    # epoch-permutation stream): augmentation replays
                    # across seek-based resume without drawing for the
                    # skipped range.
                    arng = np.random.RandomState(
                        (base * 2_000_003 + produced) % 2**31
                    )
                    if self.augment_mode == "rrc":
                        images = random_resized_crop(
                            images,
                            arng,
                            out_hw=self._out_hw(),
                            scale=self.rrc_scale,
                            ratio=self.rrc_ratio,
                            hflip=self.hflip,
                        )
                    else:
                        images = self._eval_view(
                            augment_images(
                                images, arng,
                                pad=self.crop_pad, hflip=self.hflip,
                            )
                        )
                else:
                    images = self._eval_view(images)
                produced += 1
                yield {"image": images, "label": self._labels[idx]}

    @property
    def val_size(self) -> int:
        """Rows in the val split (train split if no val files exist)."""
        return len(
            self._val_images if self._val_images is not None else self._images
        )

    def val_batches(
        self, batch_size: int, *, num_batches: int | None = None
    ) -> Iterator[dict[str, np.ndarray]]:
        """Ordered sweep over the whole val split (train if absent) — the
        full top-1 evaluation pass (BASELINE.json north star is measured
        on it). Finite iterator covering ALL ``n`` rows exactly: the last
        partial batch is zero-padded to ``batch_size`` (static shapes) and
        every batch carries a ``"valid"`` float mask (1 real / 0 pad) so
        the weighted eval path counts denominators exactly — no remainder
        drop. ``num_batches`` caps the sweep (tests / quick evals). Never
        augmented."""
        images, labels = self._val_images, self._val_labels
        if images is None:
            images, labels = self._images, self._labels
        n = len(images)
        full = n // batch_size
        rem = n % batch_size
        total = full + (1 if rem else 0)
        if num_batches is not None:
            total = min(total, num_batches)
        for b in range(total):
            lo = b * batch_size
            hi = min(lo + batch_size, n)
            imgs = self._eval_view(self._assemble(images[lo:hi]))
            labs = np.asarray(labels[lo:hi]).astype(np.int32)
            valid = np.ones(hi - lo, np.float32)
            if hi - lo < batch_size:
                pad = batch_size - (hi - lo)
                imgs = np.concatenate(
                    [imgs, np.zeros((pad, *imgs.shape[1:]), imgs.dtype)]
                )
                labs = np.concatenate([labs, np.zeros(pad, np.int32)])
                valid = np.concatenate([valid, np.zeros(pad, np.float32)])
            yield {"image": imgs, "label": labs, "valid": valid}

    def eval_batch(self, batch_size: int, *, seed: int = 10_000):
        """One deterministic batch from the val split (train if absent)."""
        images, labels = self._val_images, self._val_labels
        if images is None:
            images, labels = self._images, self._labels
        n = len(images)
        idx = np.sort(
            np.random.RandomState(seed).choice(
                n, size=min(batch_size, n), replace=False
            )
        )
        return {
            "image": self._eval_view(self._assemble(images[idx])),
            "label": np.asarray(labels[idx]).astype(np.int32),
        }

def _finish_classification_split(
    data_dir: str, labels: np.ndarray, split: str, num_classes: int | None
) -> str:
    """The labels + meta tail every classification writer shares."""
    np.save(_split_path(data_dir, split, "labels"), labels.astype(np.int32))
    n_cls = int(num_classes if num_classes is not None else labels.max() + 1)
    _update_meta(
        data_dir,
        {"kind": "classification", "num_classes": n_cls},
        explicit=num_classes is not None,
    )
    return data_dir


def _partial_path(data_dir: str, split: str) -> str:
    return _split_path(data_dir, split, "images") + ".partial"


def open_classification_images(
    data_dir: str,
    split: str,
    n: int,
    hw: tuple[int, int],
    *,
    channels: int = 3,
    dtype=np.uint8,
) -> np.memmap:
    """Preallocate one split's images array ON DISK for streaming writes.

    The importer path for datasets too large to decode into RAM first
    (ImageNet at 256² is about 1.28M × 256² × 3 ≈ 250 GB:
    ``write_classification``'s in-memory array cannot exist). Returns a
    writable ``np.lib.format.open_memmap`` over
    ``<split>_images.npy.partial``; fill rows incrementally, then call
    :func:`finalize_classification`, which atomically renames the file
    into place. An import that crashes mid-decode leaves only the
    ``.partial`` file — never a loadable dataset with silently-zero rows.
    """
    os.makedirs(data_dir, exist_ok=True)
    return np.lib.format.open_memmap(
        _partial_path(data_dir, split),
        mode="w+",
        dtype=dtype,
        shape=(n, hw[0], hw[1], channels),
    )


def finalize_classification(
    data_dir: str,
    labels: np.ndarray,
    *,
    split: str = "train",
    num_classes: int | None = None,
) -> str:
    """Complete a streamed split: publish the images file + labels + meta.

    Requires the ``.partial`` images file from
    :func:`open_classification_images` (its absence means the import
    never ran or already finalized — both loud errors), cross-checks the
    label count, and renames the images into place atomically.
    """
    labels = np.asarray(labels)
    partial = _partial_path(data_dir, split)
    if not os.path.exists(partial):
        raise FileNotFoundError(
            f"{partial}: no streamed images to finalize (call "
            "open_classification_images first; a second finalize of the "
            "same split is also an error)"
        )
    images = np.load(partial, mmap_mode="r")
    if len(images) != len(labels):
        raise ValueError(
            f"{split}: images on disk ({len(images)}) != labels "
            f"({len(labels)})"
        )
    del images
    os.replace(partial, _split_path(data_dir, split, "images"))
    return _finish_classification_split(data_dir, labels, split, num_classes)


def write_classification(
    data_dir: str,
    images: np.ndarray,
    labels: np.ndarray,
    *,
    split: str = "train",
    num_classes: int | None = None,
) -> str:
    """Write one split of a classification dataset in this module's format
    (creates/updates ``meta.json``). Returns ``data_dir``."""
    os.makedirs(data_dir, exist_ok=True)
    images = np.asarray(images)
    labels = np.asarray(labels)
    if len(images) != len(labels):
        raise ValueError(f"images ({len(images)}) != labels ({len(labels)})")
    np.save(_split_path(data_dir, split, "images"), images)
    return _finish_classification_split(data_dir, labels, split, num_classes)


_GEOMETRY_KEYS = ("num_classes", "vocab_size")


def _update_meta(data_dir: str, meta: dict, *, explicit: bool = True) -> None:
    """Merge ``meta`` into meta.json. Inferred geometry (``explicit=False``)
    only ever GROWS an existing value — a val split whose labels happen to
    miss the top classes must not shrink the train split's num_classes
    (that would silently build a too-small model)."""
    path = os.path.join(data_dir, _META)
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
        if old.get("kind") != meta["kind"]:
            raise ValueError(
                f"{data_dir} already holds a {old.get('kind')!r} dataset"
            )
        if not explicit:
            for key in _GEOMETRY_KEYS:
                if key in meta and key in old:
                    meta[key] = max(meta[key], old[key])
        old.update(meta)
        meta = old
    with open(path, "w") as f:
        json.dump(meta, f)
