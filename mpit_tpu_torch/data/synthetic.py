"""Deterministic, learnable synthetic datasets (no network, no disk).

The port's numpy-only copies of :mod:`mpit_tpu.data.synthetic`'s
streams: the same seeds give the same arrays, bit for bit.

- :class:`SyntheticClassification` — prototype-plus-noise images (each
  class a fixed random prototype, samples ``prototype + noise``), NHWC
  float32 as the JAX package makes them, the train stream shift-cropped
  and flipped with ``augment`` (:func:`~mpit_tpu_torch.data.augment.augment_images`
  on the batch's own ``RandomState``); :func:`synthetic_mnist` and
  :func:`synthetic_imagenet` give its MNIST and ImageNet shapes.
- :class:`SyntheticLM` — tokens following a sparse random bigram table,
  so a model can push the per-token cross entropy from ``log(vocab)``
  toward ``log(branching)``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from mpit_tpu_torch.data.augment import augment_images

__all__ = ["SyntheticClassification", "SyntheticLM", "synthetic_imagenet", "synthetic_mnist"]


@dataclasses.dataclass
class SyntheticClassification:
    """Prototype-plus-noise image classification stream: images ``[B,
    *image_shape]`` float32 (NHWC), labels ``[B]`` int32.

    Every batch has its own ``RandomState``, seeded from the stream's
    base and the batch index (counter-based), so ``skip`` is O(1).
    ``eval_batch`` and ``val_batches`` draw from a seed namespace
    (``salt=1``) that no train stream reaches. ``augment``: the train
    stream's random shift-crop (``crop_pad``) and flip (``hflip``), drawn
    from the batch's generator after its images; eval and val batches are
    never augmented."""

    image_shape: tuple[int, ...] = (28, 28, 1)
    num_classes: int = 10
    noise: float = 0.3
    seed: int = 0
    augment: bool = False
    crop_pad: int = 4
    hflip: bool = True

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        self.prototypes = rng.randn(self.num_classes, *self.image_shape).astype(np.float32)

    def _raw_batch(self, batch_size: int, base: int, idx: int, salt: int = 0):
        """One batch and its RandomState (drawn from as far as the batch
        needs): the train stream's and the eval/val paths' generator."""
        rng = np.random.RandomState((base * 1_000_003 + idx + salt * 715_827_883) % 2**31)
        labels = rng.randint(0, self.num_classes, size=(batch_size,))
        images = self.prototypes[labels] + self.noise * rng.randn(
            batch_size, *self.image_shape
        ).astype(np.float32)
        return images.astype(np.float32), labels.astype(np.int32), rng

    def batches(
        self, batch_size: int, *, seed: int | None = None, skip: int = 0
    ) -> Iterator[dict[str, np.ndarray]]:
        """Infinite stream of ``{"image": [B, ...], "label": [B]}``,
        resumed at batch ``skip`` in O(1)."""
        base = self.seed + 1 if seed is None else seed
        idx = skip
        while True:
            images, labels, rng = self._raw_batch(batch_size, base, idx)
            idx += 1
            if self.augment:
                images = augment_images(images, rng, pad=self.crop_pad, hflip=self.hflip)
            yield {"image": images, "label": labels}

    def eval_batch(self, batch_size: int, *, seed: int = 10_000) -> dict[str, np.ndarray]:
        """One held-out batch."""
        images, labels, _ = self._raw_batch(batch_size, seed, 0, salt=1)
        return {"image": images, "label": labels}

    def val_batches(self, batch_size: int, *, num_batches: int | None = None):
        """A finite sweep of held-out batches (8 unless ``num_batches``
        says otherwise): the synthetic stand-in for a val split."""
        for i in range(num_batches if num_batches is not None else 8):
            images, labels, _ = self._raw_batch(batch_size, 20_000 + i, 0, salt=1)
            yield {"image": images, "label": labels}


def synthetic_mnist(noise: float = 0.4, seed: int = 0) -> SyntheticClassification:
    """MNIST-shaped stream: 28×28×1, 10 classes (baseline configs #1/#2)."""
    return SyntheticClassification(image_shape=(28, 28, 1), num_classes=10, noise=noise, seed=seed)


def synthetic_imagenet(
    image_size: int = 224, num_classes: int = 1000, noise: float = 0.5, seed: int = 0
) -> SyntheticClassification:
    """ImageNet-shaped stream: 224×224×3, 1000 classes (config #3)."""
    return SyntheticClassification(
        image_shape=(image_size, image_size, 3), num_classes=num_classes, noise=noise, seed=seed
    )


@dataclasses.dataclass
class SyntheticLM:
    """Sparse-bigram language-model stream.

    Each token's successor is drawn from ``branching`` allowed successors
    (a fixed random table). Uniform baseline loss is ``log(vocab)``; a
    model that learns the table reaches ``log(branching)``.
    """

    vocab_size: int = 1024
    branching: int = 4
    seed: int = 0

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        self.successors = rng.randint(
            0, self.vocab_size, size=(self.vocab_size, self.branching)
        ).astype(np.int32)

    @property
    def uniform_loss(self) -> float:
        return float(np.log(self.vocab_size))

    @property
    def optimal_loss(self) -> float:
        return float(np.log(self.branching))

    def batches(
        self, batch_size: int, seq_len: int, *, seed: int | None = None, skip: int = 0
    ) -> Iterator[dict[str, np.ndarray]]:
        """Infinite stream of ``{"tokens": [B, L + 1]}`` int32 (shift for
        targets). Counter-based per-batch RNG, so ``skip=N`` is O(1)."""
        base = self.seed + 1 if seed is None else seed
        idx = skip
        while True:
            rng = np.random.RandomState((base * 1_000_003 + idx) % 2**31)
            idx += 1
            toks = np.empty((batch_size, seq_len + 1), np.int32)
            toks[:, 0] = rng.randint(0, self.vocab_size, size=batch_size)
            for t in range(seq_len):
                choice = rng.randint(0, self.branching, size=batch_size)
                toks[:, t + 1] = self.successors[toks[:, t], choice]
            yield {"tokens": toks}
