"""Deterministic, learnable synthetic token stream (no network, no disk).

The port's numpy-only copy of :class:`mpit_tpu.data.synthetic.SyntheticLM`:
the same seeds give the same tokens, bit for bit. Tokens follow a sparse
random bigram table, so a model can push the per-token cross entropy
from ``log(vocab)`` toward ``log(branching)``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["SyntheticLM"]


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
