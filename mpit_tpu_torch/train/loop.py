"""The training drive loop: prefetch, lagged loss read-back, logging,
divergence guard and restore, checkpoint cadence and the SIGTERM drain.

The port of :func:`mpit_tpu.train.loop.hardened_loop`, without the
dispatch fence (JAX's fetch-only fence bounds XLA's async dispatch; an
eager step has none to bound).

- **Prefetch.** A background thread draws host batches ahead of the
  step into a queue of ``prefetch_depth``, as torch tensors in pinned
  host memory when the step runs on CUDA; the loop copies each to the
  device with ``non_blocking=True``, so the copy overlaps the queued
  work. With a ``world`` the global batch is then split over its ranks
  (:func:`mpit_tpu_torch.data.shard_batch`) and the step takes the list.
- **Lagged read-back.** At each log point the loop keeps the step's
  loss as a device scalar and reads it back only once more than
  ``fetch_lag`` log points are waiting, so no step waits on the host.
  A sync point — a checkpoint save, an eval, the last step — drains
  every waiting loss first and then checks its own step's loss, so a
  checkpoint is never written on an unchecked or failing loss.
- **Throughput.** The loop marks every step's end on the device's
  timeline (a CUDA event; a host clock on the CPU). ``items_per_sec``
  is taken over the steps between two read-backs, timed by their
  marks; ``step_ms`` are the times between consecutive marks. (JAX
  times the window on the host between the read-backs themselves, which
  tracks the device only while the host runs ahead of it; an eager
  PyTorch step can be host-bound, and then a window that closes in a
  burst of read-backs would credit several steps to the time of one.)
- **Checkpoints** (``ckpt``: a
  :class:`~mpit_tpu_torch.train.checkpoint.CheckpointManager` or
  :class:`~mpit_tpu_torch.train.checkpoint.AtomicCheckpoint`): a save
  every ``ckpt_every`` steps, at a sync point; with ``final_save`` one
  at the natural end unless the cadence saved that step; then
  ``ckpt.wait()``.
- **Divergence.** Every read-back goes through
  :class:`~mpit_tpu_torch.train.guard.DivergenceGuard`. On
  :class:`Diverged` the loop restores the newest checkpoint older than
  the previous restore target (a state saved at step t can already be
  poisoned while loss t was finite), up to ``max_restores`` times; with
  no candidate left, or past the limit, the error propagates. The
  restore writes into the state's own tensors. After it the guard is
  reset, the waiting losses are dropped (they belong to the abandoned
  trajectory), the loss trace is rebased to the restored step and a
  fresh throughput window opens; the stream keeps its position (exact
  replay is for a clean resume, not for recovery). The loop logs
  ``{"event": "restored_after_divergence", ...}`` with JAX's keys.
- **SIGTERM drain.** A SIGTERM (from the main thread's handler) ends
  the run after the step in flight: the waiting losses are drained and
  checked, the state is saved (unless the cadence saved that step) and
  ``{"event": "preempted_checkpoint_and_exit", "resumable": bool(ckpt)}``
  is logged.
- **Eval.** With ``eval_every`` and ``eval_hook``, the hook runs on the
  state every ``eval_every`` steps and after the last step, in an
  ``eval`` span; its metrics are logged as ``eval_<name>`` and the last
  result is returned as ``eval``. The device time of an eval falls into
  the next step's ``step_ms`` (its mark is taken before the eval).
- **Sentinel** (``sentinel``: a :class:`~mpit_tpu_torch.obs.Sentinel`).
  It is fed, under JAX's metric names, each step's device time
  (``step``: between the step's end mark and the previous one) and the
  loop's wait for its batch (``prefetch_wait``), at the read-back that
  proves the step done. JAX feeds the host's iteration wall, which its
  dispatch fence bounds; an eager step's host wall here is its enqueue
  time, and the wall of a lagged read-back is the wait for queued work,
  so a host-wall detector would flag every read-back. The report is
  returned as ``sentinel`` and logged as the ``sentinel_report`` record.
- **Profile window** (``profile_dir``): steps 2..5 of the run under
  ``torch.profiler`` (:func:`mpit_tpu_torch.utils.profiling.trace`; on
  the card, CUDA activity too — a capture without device events raises),
  its Chrome trace in ``profile_dir/trace.json``; returned as
  ``profile``.
- **Roofline** (``roofline``: one step's modeled cost, ``{"flops",
  "hbm_bytes"[, "dtype", "source"]}``, e.g.
  :func:`~mpit_tpu_torch.utils.profiling.gpt2_step_cost`): the steps'
  modeled work against their device seconds between step-end marks, not
  against the ``step`` spans, which close when the step is enqueued. Left
  out: the first step (it holds the set-up) and the profile window's
  steps with the one after it (traced, and waiting on the trace's
  export). Returned as ``roofline`` (percentages only on a known card).
- **Builds** — a kernel library built or loaded inside a step is a
  ``compile`` span; one after the first step is an
  ``unexpected_recompile`` (a sentinel note with a sentinel).
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
from mpit_tpu_torch.utils import profiling
from mpit_tpu_torch.train.guard import Diverged, DivergenceGuard
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
    ckpt=None,
    ckpt_every: int = 0,
    max_restores: int = 1,
    spike_factor: float = 0.0,
    final_save: bool = False,
    fetch_lag: int = 2,
    prefetch_depth: int = 2,
    step_attrs: dict | None = None,
    world=None,
    eval_every: int = 0,
    eval_hook: Callable | None = None,
    sentinel=None,
    profile_dir: str = "",
    roofline: dict | None = None,
) -> dict:
    """Drive ``step_fn(state, batch) -> (state, metrics)`` from
    ``state.step`` to ``steps``; ``metrics["loss"]`` is a device scalar.

    ``batches`` is the host iterator, already past the batches
    ``state.step`` consumed (a seek-based resume is the caller's).
    ``step_attrs`` label every ``step`` span. ``world``: split each batch
    over its ranks for the step. ``ckpt`` / ``ckpt_every`` /
    ``max_restores`` / ``final_save``: the checkpoint cadence and the
    divergence restore (module docstring). ``eval_hook(state) ->
    metrics`` runs every ``eval_every`` steps and after the last step.
    ``sentinel`` / ``profile_dir`` / ``roofline``: module docstring.
    Returns ``{"state", "steps", "losses", "final_loss", "restores",
    "preempted", "step_ms"}`` (``step_ms``: one per step run, the first
    holding the run's set-up) plus ``items_per_sec`` (best window),
    ``items_per_sec_last`` and ``items_per_sec_mean`` once a window
    closed, ``eval`` (the last hook's metrics) once one ran, and
    ``sentinel``, ``profile``, ``roofline`` and ``compiles`` when
    asked for or observed."""
    device = torch.device(device)
    logger = logger or MetricLogger()
    step_attrs = step_attrs or {}
    guard = DivergenceGuard(spike_factor=spike_factor, lag=fetch_lag, fence=log_every)
    start = step = state.step
    pending: deque = deque()  # (step, loss device scalar, kind)
    loss_trace: list[tuple[int, float]] = []
    rate_trace: list[float] = []
    log_step: int | None = None  # the last window's end; None: the next read-back opens one
    restores = 0
    restore_before: int | None = None  # ceiling for the next restore target

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

    # marks[s]: the end of step s on this trajectory; segments: every
    # step's mark in run order, a new segment after each restore.
    marks = {step: mark()}
    segments = [[marks[step]]]
    last_eval: dict | None = None
    # The sentinel's feed: steps up to ``observed`` are fed; ``pf_wait``
    # holds each step's wait for its batch until then.
    observed = step
    pf_wait: dict[int, float] = {}
    prof_window = None
    if profile_dir and steps > start:
        prof_window = (min(start + 2, steps - 1), min(start + 5, steps - 1))
    tracing = None  # the open trace's context manager
    profile: dict | None = None
    compile_watch = obs.roofline.CompileWatch(scope="train_step", sentinel=sentinel)

    preempted = {"flag": False}

    def _on_term(signum, frame):
        del signum, frame
        preempted["flag"] = True

    try:
        prev_handler = signal.signal(signal.SIGTERM, _on_term)
        handler_installed = True
    except ValueError:  # not the main thread: no handler
        prev_handler, handler_installed = None, False

    def feed_sentinel(upto: int) -> None:
        """Feed the sentinel every step up to ``upto`` (done on the device
        by now) not fed yet: its device time and its batch wait."""
        nonlocal observed
        if sentinel is None:
            return
        for t in range(observed + 1, upto + 1):
            if t - 1 in marks and t in marks:
                sentinel.observe_step(
                    t - 1, step_s=elapsed_s(marks[t - 1], marks[t]),
                    prefetch_wait_s=pf_wait.pop(t - 1, None),
                )
        observed = max(observed, upto)

    def consume(entry, at_step: int, close: bool) -> None:
        """Read back and check one waiting loss; a ``log`` entry is
        logged, and with ``close`` it ends a throughput window over the
        steps since the previous one ended."""
        nonlocal log_step
        s, loss, kind = entry
        with obs.span("host_fence", why=kind, lag=at_step - s):
            val = float(loss)
        feed_sentinel(s)
        guard.check(s, val, detected_step=at_step)
        if kind != "log":
            return
        loss_trace.append((s, val))
        vals = {"loss": val}
        if close:
            if items_per_batch and log_step is not None and s > log_step:
                dt = elapsed_s(marks[log_step], marks[s])
                rate = items_per_batch * (s - log_step) / dt
                vals["items_per_sec"] = round(rate, 2)
                rate_trace.append(rate)
            log_step = s
        logger.log(s, vals)

    def drain(at_step: int, close_last: bool = True) -> None:
        while pending:
            e = pending.popleft()
            consume(e, at_step, close=close_last and not pending)

    stream = _Prefetcher(batches, device, prefetch_depth)
    try:
        while True:
            pf_t0 = time.perf_counter()
            with obs.span("prefetch_wait"):
                try:
                    batch = next(stream)
                except StopIteration:
                    batch = None
                if batch is not None and world is not None:
                    batch = shard_batch(world, batch)
            pf_wait[step] = time.perf_counter() - pf_t0
            try:
                if batch is None or step >= steps:
                    drain(step)
                    break
                if preempted["flag"]:
                    # Drain WITH checks: the checkpoint must not ship a
                    # trajectory a waiting loss condemns (a Diverged
                    # restores below, and the next iteration saves that).
                    drain(step)
                    if ckpt:
                        with obs.span("checkpoint_save", reason="preempted"):
                            if ckpt.latest_step() != step:  # the cadence saved it
                                ckpt.save(step, state)
                            ckpt.wait()
                    logger.log(step, {"event": "preempted_checkpoint_and_exit",
                                      "resumable": bool(ckpt)})
                    break
                if prof_window and tracing is None and profile is None \
                        and step == prof_window[0]:
                    tracing = profiling.trace(profile_dir, cuda=device.type == "cuda")
                    profile = tracing.__enter__()
                with obs.span("step", **step_attrs):
                    state, metrics = compile_watch.call("step", step_fn, state, batch)
                if step == start:
                    # Builds in the first step are its own; later ones
                    # are unexpected.
                    compile_watch.expected = compile_watch.compiles
                marks[step + 1] = mark()
                segments[-1].append(marks[step + 1])
                if tracing is not None and step >= prof_window[1]:
                    tracing.__exit__(None, None, None)  # waits for the card
                    tracing = None
                should_log = (step + 1) % log_every == 0 or step + 1 == steps
                should_save = bool(ckpt and ckpt_every and (step + 1) % ckpt_every == 0)
                should_eval = bool(
                    eval_hook and eval_every and ((step + 1) % eval_every == 0 or step + 1 == steps)
                )
                if fetch_lag > 0 and not (should_save or should_eval or step + 1 == steps):
                    if should_log:
                        pending.append((step + 1, metrics["loss"], "log"))
                    burst = []
                    while len(pending) > fetch_lag:
                        burst.append(pending.popleft())
                    for i, e in enumerate(burst):
                        consume(e, step + 1, close=i == len(burst) - 1)
                else:
                    # A sync point: drain, then check this step's loss.
                    drain(step + 1, close_last=False)
                    if should_log or should_save:
                        consume((step + 1, metrics["loss"], "log" if should_log else "save"),
                                step + 1, close=True)
                    if should_save:
                        with obs.span("checkpoint_save"):
                            ckpt.save(step + 1, state)
                        # A new checked checkpoint supersedes the suspicion
                        # a past restore cast on the newest one.
                        restore_before = None
                if should_eval:
                    with obs.span("eval"):
                        last_eval = eval_hook(state)
                    if last_eval:
                        logger.log(step + 1, {"eval_" + k: v for k, v in last_eval.items()})
            except Diverged as dvg:
                candidates = [
                    s for s in (ckpt.all_steps() if ckpt else [])
                    if restore_before is None or s < restore_before
                ]
                if not candidates or restores >= max_restores:
                    raise
                target = max(candidates)
                restores += 1
                if tracing is not None:
                    # The step counter goes back: end the capture here.
                    tracing.__exit__(None, None, None)
                    tracing = None
                with obs.span("divergence_restore", target=target):
                    state = ckpt.restore(state, step=target)
                step = state.step
                restore_before = target
                guard.reset()
                pending.clear()
                loss_trace = [(s, v) for s, v in loss_trace if s <= step]
                log_step = None  # a fresh window: the step counter went back
                marks = {step: mark()}
                segments.append([marks[step]])
                observed = step
                logger.log(step, {"event": "restored_after_divergence",
                                  "bad_loss": dvg.loss, "restores": restores,
                                  "diverged_step": dvg.step,
                                  "detected_step": dvg.detected_step})
                continue
            step += 1
    finally:
        stream.close()
        if tracing is not None:  # the run ended (or raised) inside the window
            tracing.__exit__(None, None, None)
        if handler_installed:
            signal.signal(
                signal.SIGTERM, prev_handler if prev_handler is not None else signal.SIG_DFL
            )
    if ckpt:
        with obs.span("checkpoint_save", reason="final"):
            if (final_save and not preempted["flag"] and step > start
                    and ckpt.latest_step() != step):  # the cadence saved it
                ckpt.save(step, state)
            ckpt.wait()

    feed_sentinel(step)
    step_ms = [elapsed_s(a, b) * 1e3 for seg in segments for a, b in zip(seg, seg[1:])]
    losses = [v for _, v in loss_trace]
    out = {
        "state": state,
        "steps": state.step,
        "losses": losses,
        "final_loss": losses[-1] if losses else float("nan"),
        "restores": restores,
        "preempted": preempted["flag"],
        "step_ms": step_ms,
    }
    if last_eval:  # an empty sweep records nothing
        out["eval"] = last_eval
    if rate_trace:
        out["items_per_sec"] = round(max(rate_trace), 2)
        out["items_per_sec_last"] = round(rate_trace[-1], 2)
        out["items_per_sec_mean"] = round(sum(rate_trace) / len(rate_trace), 2)
    if compile_watch.compiles:
        out["compiles"] = compile_watch.compiles
    if profile is not None:
        out["profile"] = profile
    # Device seconds from the step-end marks (the step span closes when
    # the step is enqueued, not when the card finishes it), on the final
    # trajectory, past the set-up and the profile window.
    skip = {start} | (set(range(prof_window[0], prof_window[1] + 2)) if prof_window else set())
    timed = [elapsed_s(marks[t], marks[t + 1]) for t in sorted(marks)
             if t + 1 in marks and t not in skip]
    if roofline is not None and timed:
        cost = {
            "flops": float(roofline.get("flops", 0.0)),
            "hbm_bytes": float(roofline.get("hbm_bytes", 0.0)),
            "platform": device.type,
            "source": roofline.get("source", "analytic"),
            **obs.roofline.chip_peaks(dtype=roofline.get("dtype", "bf16")),
        }
        out["roofline"] = obs.roofline.rollup(
            {"step": cost}, {}, {"step": {"count": len(timed), "total_s": sum(timed)}},
        )
    if sentinel is not None:
        out["sentinel"] = sentinel.report()
        logger.log(step, {
            "event": "sentinel_report",
            "sentinel_clean": out["sentinel"]["clean"],
            **{f"sentinel_{k}": v for k, v in out["sentinel"]["anomaly_counts"].items()},
        })
    return out
