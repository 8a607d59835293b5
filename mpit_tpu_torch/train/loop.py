"""The training drive loop: prefetch, lagged loss read-back, logging,
divergence guard and the SIGTERM drain.

The port of :func:`mpit_tpu.train.loop.hardened_loop`, without what a
checkpoint brings (periodic saves, divergence restore, the preemption
checkpoint), the profile window, the roofline registration and the
sentinel: those arrive with later slices of the port.

- **Prefetch.** A background thread draws host batches ahead of the
  step into a queue of ``prefetch_depth``, as torch tensors in pinned
  host memory when the step runs on CUDA; the loop copies each to the
  device with ``non_blocking=True``, so the copy overlaps the queued
  work. With a ``world`` the global batch is then split over its ranks
  (:func:`mpit_tpu_torch.data.shard_batch`) and the step takes the list.
- **Lagged read-back.** At each log point the loop keeps the step's
  loss as a device scalar and reads it back only once more than
  ``fetch_lag`` log points are waiting, so no step waits on the host.
  The last step drains every waiting loss.
- **Throughput.** The loop marks every step's end on the device's
  timeline (a CUDA event; a host clock on the CPU). ``items_per_sec``
  is taken over the steps between two read-backs, timed by their
  marks; ``step_ms`` are the times between consecutive marks. (JAX
  times the window on the host between the read-backs themselves, which
  tracks the device only while the host runs ahead of it; an eager
  PyTorch step can be host-bound, and then a window that closes in a
  burst of read-backs would credit several steps to the time of one.)
- **Divergence.** Every read-back goes through
  :class:`~mpit_tpu_torch.train.guard.DivergenceGuard`; with no
  checkpoint to restore, a :class:`Diverged` propagates (as JAX's does
  when no checkpoint is older than the failing step).
- **SIGTERM drain.** A SIGTERM (from the main thread's handler) ends
  the run after the step in flight; the result says ``preempted``.
- **Eval.** With ``eval_every`` and ``eval_hook``, the hook runs on the
  state every ``eval_every`` steps and after the last step, in an
  ``eval`` span; its metrics are logged as ``eval_<name>`` and the last
  result is returned as ``eval``. The device time of an eval falls into
  the next step's ``step_ms`` (its mark is taken before the eval).
"""

from __future__ import annotations

import queue
import signal
import threading
import time
from collections import deque
from typing import Callable, Iterator

import numpy as np
import torch

from mpit_tpu_torch import obs
from mpit_tpu_torch.data.loader import shard_batch
from mpit_tpu_torch.train.guard import DivergenceGuard
from mpit_tpu_torch.train.metrics import MetricLogger

__all__ = ["hardened_loop"]


class _Prefetcher:
    """Host batches (dicts of numpy arrays) drawn on a background thread
    into a bounded queue, as torch tensors, pinned when ``device`` is
    CUDA; ``next`` hands the next one over, copied to ``device`` without
    blocking. ``close`` stops and joins the thread."""

    def __init__(self, batches: Iterator, device: torch.device, depth: int):
        self._device = device
        self._pin = device.type == "cuda"
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, args=(batches,), name="prefetch", daemon=True
        )
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, batches: Iterator) -> None:
        try:
            for batch in batches:
                staged = {}
                for name, arr in batch.items():
                    t = torch.from_numpy(np.ascontiguousarray(arr))
                    staged[name] = t.pin_memory() if self._pin else t
                if not self._put(("batch", staged)):
                    return
            self._put(("end", None))
        except Exception as e:  # the consumer re-raises it
            self._put(("error", e))

    def __next__(self) -> dict:
        kind, val = self._queue.get()
        if kind == "end":
            raise StopIteration
        if kind == "error":
            raise val
        return {k: v.to(self._device, non_blocking=True) for k, v in val.items()}

    def close(self) -> None:
        self._stop.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():
            raise RuntimeError("prefetch thread did not stop within 10 s")


def hardened_loop(
    state,
    step_fn: Callable,
    batches: Iterator,
    *,
    steps: int,
    device,
    items_per_batch: int | None = None,
    log_every: int = 50,
    logger: MetricLogger | None = None,
    spike_factor: float = 0.0,
    fetch_lag: int = 2,
    prefetch_depth: int = 2,
    step_attrs: dict | None = None,
    world=None,
    eval_every: int = 0,
    eval_hook: Callable | None = None,
) -> dict:
    """Drive ``step_fn(state, batch) -> (state, metrics)`` from
    ``state.step`` to ``steps``; ``metrics["loss"]`` is a device scalar.

    ``batches`` is the host iterator, already past the batches
    ``state.step`` consumed. ``step_attrs`` label every ``step`` span.
    ``world``: split each batch over its ranks for the step.
    ``eval_hook(state) -> metrics`` runs every ``eval_every`` steps and
    after the last step.
    Returns ``{"state", "steps", "losses", "final_loss", "restores",
    "preempted", "step_ms"}`` (``step_ms``: one per step, the first
    holding the run's set-up) plus ``items_per_sec`` (best window),
    ``items_per_sec_last`` and ``items_per_sec_mean`` once a window
    closed, and ``eval`` (the last hook's metrics) once one ran."""
    device = torch.device(device)
    logger = logger or MetricLogger()
    step_attrs = step_attrs or {}
    guard = DivergenceGuard(spike_factor=spike_factor, lag=fetch_lag, fence=log_every)
    start = step = state.step
    pending: deque = deque()  # (step, loss device scalar)
    loss_trace: list[tuple[int, float]] = []
    rate_trace: list[float] = []
    log_step: int | None = None  # the last read-back's step; the first opens no window

    def mark():
        if device.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def elapsed_s(a, b) -> float:
        if device.type != "cuda":
            return b - a
        b.synchronize()  # the read-back waited for the step's loss, not its end
        return a.elapsed_time(b) / 1e3

    marks = [mark()]  # marks[i]: the end of step start + i (0: the start)
    last_eval: dict | None = None

    preempted = {"flag": False}

    def _on_term(signum, frame):
        del signum, frame
        preempted["flag"] = True

    try:
        prev_handler = signal.signal(signal.SIGTERM, _on_term)
        handler_installed = True
    except ValueError:  # not the main thread: no handler
        prev_handler, handler_installed = None, False

    def consume(burst: list, at_step: int) -> None:
        """Read back, check and log a burst of waiting losses; the last
        of a burst closes a throughput window over the steps since the
        previous window closed (the others log without a rate)."""
        nonlocal log_step
        for i, (s, loss) in enumerate(burst):
            with obs.span("host_fence", lag=at_step - s):
                val = float(loss)
            guard.check(s, val, detected_step=at_step)
            loss_trace.append((s, val))
            vals = {"loss": val}
            if i == len(burst) - 1:
                if items_per_batch and log_step is not None and s > log_step:
                    dt = elapsed_s(marks[log_step - start], marks[s - start])
                    rate = items_per_batch * (s - log_step) / dt
                    vals["items_per_sec"] = round(rate, 2)
                    rate_trace.append(rate)
                log_step = s
            logger.log(s, vals)

    stream = _Prefetcher(batches, device, prefetch_depth)
    try:
        while step < steps:
            if preempted["flag"]:
                logger.log(step, {"event": "preempted_and_exit", "resumable": False})
                break
            with obs.span("prefetch_wait"):
                try:
                    batch = next(stream)
                except StopIteration:
                    break
                if world is not None:
                    batch = shard_batch(world, batch)
            with obs.span("step", **step_attrs):
                state, metrics = step_fn(state, batch)
            marks.append(mark())
            step += 1
            if step % log_every == 0 or step == steps:
                pending.append((step, metrics["loss"]))
            burst = []
            while pending and (len(pending) > fetch_lag or step == steps):
                burst.append(pending.popleft())
            consume(burst, step)
            if eval_hook and eval_every and (step % eval_every == 0 or step == steps):
                with obs.span("eval"):
                    last_eval = eval_hook(state)
                if last_eval:
                    logger.log(step, {"eval_" + k: v for k, v in last_eval.items()})
        consume(list(pending), step)
    finally:
        stream.close()
        if handler_installed:
            signal.signal(
                signal.SIGTERM, prev_handler if prev_handler is not None else signal.SIG_DFL
            )

    step_ms = [elapsed_s(a, b) * 1e3 for a, b in zip(marks, marks[1:])]
    losses = [v for _, v in loss_trace]
    out = {
        "state": state,
        "steps": state.step,
        "losses": losses,
        "final_loss": losses[-1] if losses else float("nan"),
        "restores": 0,
        "preempted": preempted["flag"],
        "step_ms": step_ms,
    }
    if last_eval:  # an empty sweep records nothing
        out["eval"] = last_eval
    if rate_trace:
        out["items_per_sec"] = round(max(rate_trace), 2)
        out["items_per_sec_last"] = round(rate_trace[-1], 2)
        out["items_per_sec_mean"] = round(sum(rate_trace) / len(rate_trace), 2)
    return out
