"""Step metrics, throughput meters, structured logging.

The port of :mod:`mpit_tpu.train.metrics`: one concise stdout line per
log interval plus an optional JSONL stream (one record per log call),
and a :class:`Throughput` meter for the tokens/sec the baseline tracks.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import IO, Any

import numpy as np

__all__ = ["MetricLogger", "Throughput"]


class Throughput:
    """Exponential-moving-average items/sec meter (the first interval,
    which holds the first call's set-up, is not a rate)."""

    def __init__(self, ema: float = 0.9):
        self._ema = ema
        self._rate: float | None = None
        self._last: float | None = None

    def tick(self, items: int) -> float | None:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            rate = items / dt if dt > 0 else 0.0
            self._rate = (
                rate
                if self._rate is None
                else self._ema * self._rate + (1 - self._ema) * rate
            )
        self._last = now
        return self._rate

    @property
    def rate(self) -> float | None:
        return self._rate


class MetricLogger:
    """Console + JSONL metric sink."""

    def __init__(
        self, jsonl_path: str | Path | None = None, *, stdout: bool = True, prefix: str = ""
    ):
        self._stdout = stdout
        self._prefix = prefix
        self._fh: IO | None = None
        if jsonl_path is not None:
            Path(jsonl_path).parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(jsonl_path, "a", buffering=1)

    def log(self, step: int, metrics: dict[str, Any]) -> None:
        record = {"step": int(step)}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                try:  # non-scalar metric: a JSON-serializable nested list
                    record[k] = np.asarray(v).tolist()
                except (TypeError, ValueError):
                    record[k] = str(v)
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")
        if self._stdout:
            parts = [f"{self._prefix}step {record['step']}"]
            parts += [
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in record.items()
                if k != "step"
            ]
            print("  ".join(parts), flush=True)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
