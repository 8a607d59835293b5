"""Input augmentation for the classification streams (host-side numpy):
the port's copy of :mod:`mpit_tpu.data.augment`. The same ``RandomState``
draws in the same order give the same arrays, bit for bit.

- :func:`augment_images` — zero-fill pad-and-crop (a random shift in
  ``[-pad, pad]²``) and a horizontal flip with probability 1/2, per
  image;
- :func:`random_resized_crop` — per image a random area (``scale``) and
  aspect (``ratio``) crop, up to 10 rejection draws and a centre-crop
  fallback, bilinear-resized (align-corners false) to ``out_hw``, then
  the flip: the ImageNet transform;
- :func:`center_crop` — its deterministic eval-side companion.

The caller supplies the ``RandomState``: the datasets seed one per batch
from a counter, so a stream resumed at batch ``skip`` replays exactly.
"""

from __future__ import annotations

import numpy as np

__all__ = ["augment_images", "center_crop", "random_resized_crop"]


def augment_images(
    images: np.ndarray,
    rng: np.random.RandomState,
    *,
    pad: int = 4,
    hflip: bool = True,
) -> np.ndarray:
    """Random shift (zero-fill pad-and-crop) + horizontal flip, per image.

    ``images``: ``[B, H, W, C]`` float32. Returns a fresh array (the
    input is never written — Prefetcher owned-buffer contract).
    """
    images = np.asarray(images)
    if images.ndim != 4:
        raise ValueError(f"expected [B,H,W,C] images, got {images.shape}")
    b, h, w, _ = images.shape
    if pad:
        ys = rng.randint(0, 2 * pad + 1, size=b)
        xs = rng.randint(0, 2 * pad + 1, size=b)
        padded = np.zeros(
            (b, h + 2 * pad, w + 2 * pad, images.shape[3]), images.dtype
        )
        padded[:, pad : pad + h, pad : pad + w] = images
        out = np.empty_like(images)
        for i in range(b):
            out[i] = padded[i, ys[i] : ys[i] + h, xs[i] : xs[i] + w]
    else:
        out = images.copy()
    if hflip:
        flips = rng.randint(0, 2, size=b).astype(bool)
        out[flips] = out[flips, :, ::-1]
    return out


def _sample_crop_box(
    rng: np.random.RandomState,
    h: int,
    w: int,
    scale: tuple[float, float],
    ratio: tuple[float, float],
) -> tuple[int, int, int, int]:
    """(y, x, ch, cw) of one random area/aspect crop; center fallback."""
    area = float(h * w)
    log_r = (np.log(ratio[0]), np.log(ratio[1]))
    for _ in range(10):
        target = area * rng.uniform(scale[0], scale[1])
        r = np.exp(rng.uniform(*log_r))
        cw = int(round(np.sqrt(target * r)))
        ch = int(round(np.sqrt(target / r)))
        if 0 < cw <= w and 0 < ch <= h:
            y = rng.randint(0, h - ch + 1)
            x = rng.randint(0, w - cw + 1)
            return y, x, ch, cw
    # Fallback: clamp aspect to the valid range, center crop.
    in_r = w / h
    if in_r < ratio[0]:
        cw, ch = w, min(h, int(round(w / ratio[0])))
    elif in_r > ratio[1]:
        ch, cw = h, min(w, int(round(h * ratio[1])))
    else:
        ch, cw = h, w
    return (h - ch) // 2, (w - cw) // 2, ch, cw


def _resize_bilinear(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """[H, W, C] float32 → [oh, ow, C], align-corners=False convention."""
    h, w, _ = img.shape
    if (h, w) == (oh, ow):
        return img.astype(np.float32, copy=True)
    ys = (np.arange(oh, dtype=np.float32) + 0.5) * (h / oh) - 0.5
    xs = (np.arange(ow, dtype=np.float32) + 0.5) * (w / ow) - 0.5
    y0 = np.clip(np.floor(ys), 0, h - 1).astype(np.int64)
    x0 = np.clip(np.floor(xs), 0, w - 1).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)[None, :, None]
    img = img.astype(np.float32, copy=False)
    r0, r1 = img[y0], img[y1]  # one row-gather each (the hot allocation)
    top = r0[:, x0] * (1 - wx) + r0[:, x1] * wx
    bot = r1[:, x0] * (1 - wx) + r1[:, x1] * wx
    return top * (1 - wy) + bot * wy


def random_resized_crop(
    images: np.ndarray,
    rng: np.random.RandomState,
    *,
    out_hw: tuple[int, int] | None = None,
    scale: tuple[float, float] = (0.08, 1.0),
    ratio: tuple[float, float] = (3 / 4, 4 / 3),
    hflip: bool = True,
) -> np.ndarray:
    """ImageNet-standard random-resized-crop + flip, per image.

    ``images``: ``[B, H, W, C]`` float32. Each image gets an independent
    random crop box (area fraction in ``scale``, aspect in ``ratio``),
    bilinear-resized to ``out_hw`` (default: the input H×W), then a coin-
    flip horizontal mirror. Returns a fresh ``[B, *out_hw, C]`` array.
    The caller's counter-seeded RNG gives exact replay across resume
    (same contract as :func:`augment_images`).
    """
    images = np.asarray(images)
    if images.ndim != 4:
        raise ValueError(f"expected [B,H,W,C] images, got {images.shape}")
    b, h, w, c = images.shape
    oh, ow = out_hw if out_hw is not None else (h, w)
    out = np.empty((b, oh, ow, c), np.float32)
    for i in range(b):
        y, x, ch, cw = _sample_crop_box(rng, h, w, scale, ratio)
        out[i] = _resize_bilinear(images[i, y : y + ch, x : x + cw], oh, ow)
        if hflip and rng.randint(0, 2):
            out[i] = out[i, :, ::-1]
    return out


def center_crop(images: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Deterministic eval-side companion of :func:`random_resized_crop`:
    center-crop ``[B, H, W, C]`` to ``[B, oh, ow, C]`` (bilinear-resizing
    first when the input is smaller than the target)."""
    images = np.asarray(images)
    b, h, w, c = images.shape
    if h < oh or w < ow:
        s = max(oh / h, ow / w)
        rh, rw = int(np.ceil(h * s)), int(np.ceil(w * s))
        images = np.stack(
            [_resize_bilinear(images[i], rh, rw) for i in range(b)]
        )
        h, w = rh, rw
    y, x = (h - oh) // 2, (w - ow) // 2
    return np.ascontiguousarray(
        images[:, y : y + oh, x : x + ow].astype(np.float32)
    )
