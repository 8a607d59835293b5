"""Real-image ingestion: an image directory → the npy dataset format of
:mod:`mpit_tpu_torch.data.filedata`. The port's copy of
:mod:`mpit_tpu.data.images`: decode every image with PIL, resize its
shorter side to a storage size and centre-crop it, once, offline; the
train stream's scale and aspect jitter then comes from
:func:`~mpit_tpu_torch.data.augment.random_resized_crop`.

Directory conventions accepted by :func:`import_image_directory`:

    src/train/<class_name>/*.{jpg,jpeg,png,bmp}   + src/val/<class>/...
    src/<class_name>/*.{jpg,...}                  (+ val_fraction split)

Class names map to label indices in sorted order; the mapping is
recorded in ``meta.json`` (``class_names``). PIL is imported only when
an image is decoded, and its absence raises a clear ``ImportError`` (the
npy path never needs it).
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

from mpit_tpu_torch.data.filedata import finalize_classification, open_classification_images

__all__ = ["decode_image", "import_image_directory"]

_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".gif")


def _require_pil():
    try:
        from PIL import Image  # noqa: F401

        return Image
    except ImportError as e:  # pragma: no cover - PIL is installed here
        raise ImportError(
            "image-directory import needs PIL (pillow); install it or "
            "convert to the npy format by other means (data/filedata.py "
            "documents the layout)"
        ) from e


def decode_image(path: str, size: int) -> np.ndarray:
    """One file → uint8 [size, size, 3]: RGB decode, shorter-side resize
    to ``size`` (bilinear), center crop."""
    Image = _require_pil()
    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        s = size / min(w, h)
        rw, rh = max(size, int(round(w * s))), max(size, int(round(h * s)))
        im = im.resize((rw, rh), Image.BILINEAR)
        x, y = (rw - size) // 2, (rh - size) // 2
        im = im.crop((x, y, x + size, y + size))
        return np.asarray(im, dtype=np.uint8)


def _class_dirs(root: str) -> list[str]:
    return sorted(
        d
        for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d)) and not d.startswith(".")
    )


def _image_files(class_dir: str) -> list[str]:
    return sorted(
        os.path.join(class_dir, f)
        for f in os.listdir(class_dir)
        if f.lower().endswith(_EXTS)
    )


def _split_files(
    root: str, class_names: Sequence[str]
) -> tuple[list[str], np.ndarray]:
    """File list + labels for one split — counted BEFORE any decoding so
    the images array can be preallocated on disk (streaming import)."""
    files, labels = [], []
    for idx, name in enumerate(class_names):
        for path in _image_files(os.path.join(root, name)):
            files.append(path)
            labels.append(idx)
    if not files:
        raise ValueError(f"{root}: no decodable images found")
    return files, np.asarray(labels, np.int32)


def _decode_split_to_partial(
    out_dir: str, split: str, files: Sequence[str], size: int
) -> None:
    """Stream-decode ``files`` into the split's ``.partial`` on-disk npy.

    One decoded image in RAM at a time (a decoded ImageNet split is
    about 250 GB: the importer must never hold the split in memory).
    Publishing (rename + labels + meta) happens in
    ``finalize_classification`` — and the importer finalizes only after
    EVERY split has decoded, so a crash anywhere mid-import leaves only
    ``.partial`` files, never a loadable-but-incomplete dataset (one
    without its val split, say).
    """
    arr = open_classification_images(
        out_dir, split, len(files), (size, size)
    )
    try:
        for i, path in enumerate(files):
            arr[i] = decode_image(path, size)
        arr.flush()
    finally:
        del arr  # release the mapping before the rename publishes it


def import_image_directory(
    src_dir: str,
    out_dir: str,
    *,
    size: int = 256,
    val_fraction: float = 0.0,
    seed: int = 0,
) -> str:
    """Convert an image directory tree to the npy dataset at ``out_dir``.

    With ``src/train/`` + ``src/val/`` subtrees, each becomes the
    matching split. Otherwise ``src/<class>/...`` is treated as train,
    and ``val_fraction > 0`` carves a per-class deterministic holdout.
    Returns ``out_dir`` (loadable via ``load_dataset`` /
    ``FileClassification``).

    Decoding streams directly into the destination npy files (one image
    in RAM at a time), so the importer scales to the ImageNet-sized
    trees the rrc pipeline is motivated by.
    """
    train_root = os.path.join(src_dir, "train")
    val_root = os.path.join(src_dir, "val")
    has_splits = os.path.isdir(train_root)
    if not has_splits:
        train_root, val_root = src_dir, ""

    class_names = _class_dirs(train_root)
    if not class_names:
        raise ValueError(f"{train_root}: no class subdirectories")

    if has_splits and os.path.isdir(val_root):
        # Validate the val tree BEFORE the (potentially long) train
        # decode, so a missing class directory fails fast and clearly.
        missing = [
            c
            for c in class_names
            if not os.path.isdir(os.path.join(val_root, c))
        ]
        if missing:
            raise ValueError(
                f"{val_root}: missing class directories {missing} (every "
                "train/ class needs a val/ counterpart; use val_fraction "
                "for an automatic split instead)"
            )

    files, labels = _split_files(train_root, class_names)

    vfiles = None
    if has_splits and os.path.isdir(val_root):
        vfiles, vlabels = _split_files(val_root, class_names)
    elif val_fraction > 0.0:
        # The holdout is decided from the FILE LIST (labels are known
        # before decoding), so both splits still stream to disk.
        rng = np.random.RandomState(seed)
        val_mask = np.zeros(len(labels), bool)
        for c in range(len(class_names)):
            idx = np.flatnonzero(labels == c)
            n_val = max(1, int(round(len(idx) * val_fraction)))
            val_mask[rng.permutation(idx)[:n_val]] = True
        vfiles = [f for f, m in zip(files, val_mask) if m]
        vlabels = labels[val_mask]
        files = [f for f, m in zip(files, val_mask) if not m]
        labels = labels[~val_mask]

    # Decode EVERY split to .partial first, publish after — all-or-
    # nothing (see _decode_split_to_partial).
    _decode_split_to_partial(out_dir, "train", files, size)
    if vfiles:
        _decode_split_to_partial(out_dir, "val", vfiles, size)
    finalize_classification(
        out_dir, labels, split="train", num_classes=len(class_names)
    )
    if vfiles:
        finalize_classification(
            out_dir, vlabels, split="val", num_classes=len(class_names)
        )
    # Record the class-name ↔ index mapping for reverse lookup.
    meta_path = os.path.join(out_dir, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["class_names"] = list(class_names)
    tmp = meta_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, meta_path)
    return out_dir
