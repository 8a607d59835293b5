"""Failure detection: a non-finite or exploding loss.

The port of :mod:`mpit_tpu.train.guard`. Checks ride the loop's existing
lagged loss read-back, so no extra device synchronisation enters the
hot loop. The loop delivers the loss of step N up to ``lag`` fences
later; :meth:`DivergenceGuard.check` takes both steps, and a delay past
the declared window is itself an error.
"""

from __future__ import annotations

import math

__all__ = ["Diverged", "DivergenceGuard"]


class Diverged(RuntimeError):
    """Training produced a non-finite or exploding loss.

    ``step`` is the step whose loss failed; ``detected_step`` where the
    loop's host side stood when the value arrived (``step`` for a
    synchronous read, up to ``lag`` fences later for the lagged one).
    """

    def __init__(
        self, step: int, loss: float, reason: str, detected_step: int | None = None
    ):
        detected_step = step if detected_step is None else detected_step
        late = f", detected at step {detected_step}" if detected_step != step else ""
        super().__init__(f"training diverged at step {step}: loss={loss} ({reason}{late})")
        self.step = step
        self.loss = loss
        self.reason = reason
        self.detected_step = detected_step


class DivergenceGuard:
    """Loss sanity checks at log points.

    - a non-finite loss is always fatal (:class:`Diverged`);
    - spike detection (``spike_factor > 0``): a loss above ``spike_factor
      x`` its EMA, after ``warmup`` healthy checks whose median seeds the
      EMA, is fatal too;
    - lag window: ``check`` takes the step the loss belongs to and the
      step the loop had reached when it arrived, and raises when the
      delay exceeds ``lag`` fences of ``fence`` steps.
    """

    def __init__(
        self, *, spike_factor: float = 0.0, ema: float = 0.9, warmup: int = 5,
        lag: int = 0, fence: int = 1,
    ):
        self.spike_factor = spike_factor
        self.lag = lag
        self.fence = max(1, fence)
        self._ema_coef = ema
        self._warmup = warmup
        self._ema: float | None = None
        self._window: list[float] = []

    def check(self, step: int, loss: float, *, detected_step: int | None = None) -> None:
        detected = step if detected_step is None else detected_step
        if detected - step > self.lag * self.fence:
            raise RuntimeError(
                f"DivergenceGuard: loss for step {step} delivered at step "
                f"{detected}, past the declared lag window ({self.lag} fences "
                f"x {self.fence} steps)"
            )
        if not math.isfinite(loss):
            raise Diverged(step, loss, "non-finite", detected_step=detected)
        if len(self._window) < self._warmup:
            self._window.append(loss)
            if len(self._window) == self._warmup:
                self._ema = sorted(self._window)[self._warmup // 2]
            return
        if self.spike_factor > 0 and loss > self.spike_factor * self._ema:
            raise Diverged(
                step, loss, f"spike > {self.spike_factor}x EMA {self._ema:.4g}",
                detected_step=detected,
            )
        self._ema = self._ema_coef * self._ema + (1 - self._ema_coef) * loss

    def reset(self) -> None:
        """Forget history."""
        self._ema = None
        self._window = []
