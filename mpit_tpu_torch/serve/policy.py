"""Projected time-to-first-token for admission decisions: the
:class:`TTFTProjector` of :mod:`mpit_tpu.serve.policy`. The fleet's
router sheds on it (``FleetConfig.admission_ttft_s``); the scheduling
policy around it (priority tiers, fairness, preemption) is not ported
yet."""

from __future__ import annotations

__all__ = ["TTFTProjector"]


class TTFTProjector:
    """Projected TTFT for a request entering the queue NOW.

    The model: the queue ahead drains roughly one request per prefill
    tick, so a request behind ``depth`` others waits ``depth`` prefill
    ticks, pays its own, and sits behind the decode tick in flight::

        projected = (depth + 1) × prefill_tick + decode_tick

    Both tick costs come from the stream registry's rolling windows
    (``prefill_tick`` / ``decode_tick`` series) at ``quantile`` (default
    p50 — a central estimate, not a tail bound). Fewer than
    ``min_samples`` windowed prefill observations → ``None`` (abstain):
    a cold server must not shed on a guess.
    """

    def __init__(self, registry, *, quantile: float = 0.5,
                 min_samples: int = 4):
        self.registry = registry
        self.quantile = quantile
        self.min_samples = min_samples

    def projected_ttft_s(self, queue_depth: int) -> float | None:
        reg = self.registry
        if reg is None:
            return None
        if reg.window_count("prefill_tick") < self.min_samples:
            return None
        pf = reg.quantile("prefill_tick", self.quantile)
        if pf is None:
            return None
        dc = reg.quantile("decode_tick", self.quantile) or 0.0
        return (queue_depth + 1) * pf + dc
