"""Learning-rate schedules for the goo family: plain ``step -> lr``
functions.

The port of :mod:`mpit_tpu.opt.schedules`, which wraps optax's
schedules. Each function here gives the value the optax schedule gives,
computed in float32 as optax computes it. The optimizers call a schedule
with the step count *before* it is incremented (optax's convention), so
a linear warmup gives lr 0 at step 0.

Selection from a config goes through :func:`from_config` (``--schedule
warmup_cosine --warmup-steps 200``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = [
    "LearningRate",
    "from_config",
    "geometry",
    "step_decay",
    "warmup_constant",
    "warmup_cosine",
]

# A learning rate is a constant or a schedule ``step -> lr``.
LearningRate = float | Callable[[int], float]

_F32 = np.float32


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax ``linear_schedule``: ``(init - end) * (1 - clip(c, 0, n) / n)
    + end``, in float32."""

    def schedule(count: int) -> float:
        c = _F32(min(max(count, 0), steps))
        frac = _F32(1) - c / _F32(steps)
        return float(_F32(init - end) * frac + _F32(end))

    return schedule


def _cosine(init: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    """optax ``cosine_decay_schedule`` (exponent 1), in float32."""

    def schedule(count: int) -> float:
        c = _F32(min(float(count), float(decay_steps)))
        cos = _F32(0.5) * (_F32(1) + np.cos(_F32(np.pi) * c / _F32(decay_steps)))
        return float(_F32(init) * (_F32(1 - alpha) * cos + _F32(alpha)))

    return schedule


def _join(schedules, boundaries) -> Callable[[int], float]:
    """optax ``join_schedules``: past each boundary the next schedule runs
    on the count rebased to that boundary."""

    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, sch in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sch(count - boundary)
        return out

    return schedule


def warmup_constant(lr: float, warmup_steps: int) -> LearningRate:
    """Linear 0 → lr over ``warmup_steps``, then constant."""
    if warmup_steps <= 0:
        return lr
    return _linear(0.0, lr, warmup_steps)


def warmup_cosine(
    lr: float, warmup_steps: int, total_steps: int, *, end_scale: float = 0.0
) -> LearningRate:
    """Linear warmup to ``lr`` then cosine decay to ``lr * end_scale`` by
    ``total_steps`` (optax ``warmup_cosine_decay_schedule``)."""
    warmup = max(warmup_steps, 1)
    decay = max(total_steps, warmup_steps + 1)
    alpha = 0.0 if lr == 0.0 else lr * end_scale / lr
    return _join(
        [_linear(0.0, lr, warmup), _cosine(lr, decay - warmup, alpha)], [warmup]
    )


def step_decay(lr: float, every: int, factor: float = 0.1) -> LearningRate:
    """Multiply lr by ``factor`` every ``every`` steps — the classic
    ImageNet staircase."""

    def schedule(count: int) -> float:
        return lr * factor ** (count // every)

    return schedule


def _horizon(cfg) -> int:
    """Decay horizon: an explicit ``schedule_horizon``, else the run's step
    budget."""
    return getattr(cfg, "schedule_horizon", 0) or cfg.steps


def from_config(cfg, total_steps: int | None = None) -> LearningRate:
    """The lr (constant or schedule) of a ``TrainConfig``: ``cfg.schedule``
    is ``""`` (constant), ``"warmup"``, ``"warmup_cosine"`` or ``"step"``."""
    name = getattr(cfg, "schedule", "") or ""
    total = total_steps if total_steps is not None else _horizon(cfg)
    if name == "":
        return cfg.lr
    if name == "warmup":
        return warmup_constant(cfg.lr, cfg.warmup_steps)
    if name == "warmup_cosine":
        return warmup_cosine(cfg.lr, cfg.warmup_steps, total, end_scale=cfg.lr_end_scale)
    if name == "step":
        if cfg.decay_every <= 0:
            raise ValueError("--schedule step requires --decay-every > 0")
        base = step_decay(cfg.lr, cfg.decay_every, cfg.decay_factor)
        if cfg.warmup_steps > 0:
            # The staircase starts fresh (at peak lr) after warmup.
            return _join(
                [warmup_constant(cfg.lr, cfg.warmup_steps), base], [cfg.warmup_steps]
            )
        return base
    raise ValueError(
        f"unknown schedule {name!r} (expected '', 'warmup', 'warmup_cosine', or 'step')"
    )


def geometry(cfg) -> dict:
    """The fields that shape the lr curve: the resolved decay horizon and
    every schedule parameter the named schedule reads."""
    name = getattr(cfg, "schedule", "") or ""
    geo = {"schedule": name, "lr": cfg.lr}
    if name == "":
        return geo
    geo["warmup_steps"] = cfg.warmup_steps
    if name == "warmup_cosine":
        geo["horizon"] = _horizon(cfg)
        geo["lr_end_scale"] = cfg.lr_end_scale
    elif name == "step":
        geo["decay_every"] = cfg.decay_every
        geo["decay_factor"] = cfg.decay_factor
    return geo
