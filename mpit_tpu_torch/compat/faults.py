"""Deterministic, seeded fault injection for the compat simulator: the
port of :mod:`mpit_tpu.compat.faults`, standard library only. The same
plan and seed give the same drop, delay and kill decisions as the JAX
package's (the rules draw from the same ``random.Random`` streams).

The reference's defining robustness story — a pserver fleet that keeps
training through slow and dying workers — is only testable if slow and
dying workers are *reproducible*. This module makes every failure mode a
declared, seeded plan rather than an anecdote:

- **message faults** (consulted by ``compat.Send`` when a plan is
  installed on the communicator): drop or delay messages matching an
  ``(src, dst, tag)`` pattern. Decisions are a pure function of the
  plan's seed, the rule index, and the per-rule match counter —
  decisions happen synchronously inside ``Send``, and per
  ``(src, dst, tag)`` channel each channel has one sender, so the
  decision sequence (== the event log) is deterministic for a given
  program. NOTE the deliberate scope of that contract: a ``delay``
  rule hands the message to a timer, so a later undelayed send on the
  same channel can overtake it — suspending the simulator's
  non-overtaking rule on that channel IS the injected fault (network
  reordering), and wall-clock *delivery* order under delays is not part
  of the determinism guarantee; ``FaultPlan.events()`` (which faults
  were applied to which matches) is.
- **step faults** (consulted by a training wrapper via
  :meth:`FaultPlan.step_action`, keyed on ``(rank, step)`` — exactly
  deterministic): ``slowdown`` (a straggler — extra seconds per step
  over a window), ``hang_at`` (a bounded full-process stall: compute
  AND heartbeats stop — the lease/eviction path), ``kill_at`` (raise
  :class:`ReplicaKilled` — the crash/rejoin path), ``nan_at`` (poison
  the step's params — the divergence-quarantine path).

Every applied fault is appended to the plan's event log;
:meth:`FaultPlan.events` is the sequence two runs with the same plan +
seed must reproduce (pinned against the JAX package's log in
``tests/test_torch_compat.py``).

Plans are installed per ``compat.run`` job (``run(..., fault_plan=...)``)
and inherited by ``Comm_dup`` children, so library channels (the fleet's
control and KV channels, the flight-recorder shipment channel) see the same wire
faults as application traffic unless a rule's tag/comm pattern excludes
them.
"""

from __future__ import annotations

import dataclasses
import random
import threading
from typing import Any


class ReplicaKilled(RuntimeError):
    """Raised by :meth:`FaultPlan.step_action` at a ``kill_at`` step —
    the in-process analogue of a replica's OS process dying. Carries the
    rank and step so its supervisor (the fleet's worker loop) can log the
    crash and stop the worker."""

    def __init__(self, rank: int, step: int):
        super().__init__(f"replica rank {rank} killed at step {step} (fault plan)")
        self.rank = rank
        self.step = step


@dataclasses.dataclass(frozen=True)
class MessageRule:
    """One message-fault rule. ``None`` fields are wildcards.

    ``kind``: ``"drop"`` (message never delivered) or ``"delay"``
    (delivered ``delay_s`` later, off the sender's thread — a later
    undelayed message on the same channel may overtake it; the
    reordering is part of the fault, see the module docstring). ``after`` /
    ``count`` window the rule onto matches ``[after, after+count)`` of
    its own match stream; ``prob`` thins it with the rule's seeded RNG
    (one draw per windowed match — deterministic per match index).
    """

    kind: str  # "drop" | "delay"
    src: int | None = None
    dst: int | None = None
    tag: int | None = None
    after: int = 0
    count: int | None = None
    prob: float = 1.0
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in ("drop", "delay"):
            raise ValueError(f"MessageRule kind must be drop|delay, got {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class Slowdown:
    """A straggler window: ``seconds`` of extra wall per step for rank's
    steps in ``[start, stop)`` (``stop=None`` = forever)."""

    seconds: float
    start: int = 0
    stop: int | None = None

    def applies(self, step: int) -> bool:
        return step >= self.start and (self.stop is None or step < self.stop)


@dataclasses.dataclass(frozen=True)
class StepAction:
    """What :meth:`FaultPlan.step_action` tells the wrapper to do before
    running ``step`` on ``rank``: sleep (straggler), stall with
    heartbeats suspended (hang), poison params (nan). ``kill`` is never
    returned — it raises :class:`ReplicaKilled` instead."""

    sleep_s: float = 0.0
    hang_s: float = 0.0
    nan: bool = False


class FaultPlan:
    """A declared, seeded set of faults for one simulated multi-rank job.

    Args:
      seed: determinism root for probabilistic message rules.
      message_rules: :class:`MessageRule` sequence, evaluated in order —
        the FIRST matching rule decides a message's fate.
      slowdown: ``{rank: Slowdown}`` straggler spec.
      hang_at: ``{rank: (step, seconds)}`` — one bounded full stall.
      kill_at: ``{rank: step}`` — raise :class:`ReplicaKilled` entering
        that step.
      nan_at: ``{rank: step}`` — poison that step's params.
      rejoin_delay_s: how long a killed replica stays dead before its
        supervisor rejoins it (must exceed the anchor lease for the
        eviction to be observable).
    """

    def __init__(
        self,
        *,
        seed: int = 0,
        message_rules: tuple[MessageRule, ...] | list[MessageRule] = (),
        slowdown: dict[int, Slowdown] | None = None,
        hang_at: dict[int, tuple[int, float]] | None = None,
        kill_at: dict[int, int] | None = None,
        nan_at: dict[int, int] | None = None,
        rejoin_delay_s: float = 0.0,
    ):
        self.seed = seed
        self.message_rules = tuple(message_rules)
        self.slowdown = dict(slowdown or {})
        self.hang_at = dict(hang_at or {})
        self.kill_at = dict(kill_at or {})
        self.nan_at = dict(nan_at or {})
        self.rejoin_delay_s = rejoin_delay_s
        self._lock = threading.Lock()
        self._events: list[tuple] = []
        # Per-rule deterministic state: match counter + seeded RNG. The
        # RNG is consumed once per WINDOWED match, so the decision for
        # match k depends only on (seed, rule index, k).
        self._rule_matches = [0] * len(self.message_rules)
        self._rule_rng = [
            random.Random((seed << 8) ^ (i * 0x9E3779B1))
            for i in range(len(self.message_rules))
        ]
        # kill_at fires once per (rank, step) — a rejoined replica
        # re-running its loop from a restored earlier step must not be
        # re-killed at the same step forever.
        self._fired: set[tuple] = set()

    # -- event log -----------------------------------------------------------
    def _log(self, *event: Any) -> None:
        with self._lock:
            self._events.append(tuple(event))

    def events(self) -> tuple[tuple, ...]:
        """The applied-fault record in CANONICAL (sorted) order — the
        determinism contract: same plan spec + seed (and same program)
        ⇒ same tuple. Canonical, not insertion, order: with faults on
        several ranks the append order depends on which thread wins the
        lock, which is scheduling noise, not plan behavior; each
        event's own fields (rank/src/dst/tag, step or match index)
        carry its position in its stream, so sorting loses nothing the
        contract promises."""
        with self._lock:
            return tuple(sorted(self._events))

    def events_of(self, kind: str) -> tuple[tuple, ...]:
        return tuple(e for e in self.events() if e[0] == kind)

    # -- message faults (called by compat.Send under the mailbox-free path) --
    def message_fault(
        self, src: int, dst: int, tag: int
    ) -> tuple[str, float] | None:
        """First-matching-rule decision for one message: ``None`` =
        deliver normally, ``("drop", 0)`` or ``("delay", seconds)``."""
        for i, rule in enumerate(self.message_rules):
            if rule.src is not None and rule.src != src:
                continue
            if rule.dst is not None and rule.dst != dst:
                continue
            if rule.tag is not None and rule.tag != tag:
                continue
            with self._lock:
                k = self._rule_matches[i]
                self._rule_matches[i] += 1
                if k < rule.after:
                    return None
                if rule.count is not None and k >= rule.after + rule.count:
                    return None
                if rule.prob < 1.0 and self._rule_rng[i].random() >= rule.prob:
                    return None
                self._events.append(
                    (rule.kind, src, dst, tag, k)
                    if rule.kind == "drop"
                    else (rule.kind, src, dst, tag, k, rule.delay_s)
                )
            return (rule.kind, rule.delay_s)
        return None

    # -- step faults (called by the worker or training wrapper) -------------
    def step_action(self, rank: int, step: int) -> StepAction:
        """The (deterministic) fault entering ``step`` on ``rank``.

        Raises :class:`ReplicaKilled` at the rank's ``kill_at`` step
        (once — a restored replica re-crossing it survives). The caller
        applies the returned sleeps/poisoning itself: the plan decides,
        the wrapper executes, so the decision log stays wall-clock-free.
        """
        kill_step = self.kill_at.get(rank)
        if kill_step == step and ("kill", rank, step) not in self._fired:
            with self._lock:
                self._fired.add(("kill", rank, step))
                self._events.append(("kill", rank, step))
            raise ReplicaKilled(rank, step)
        sleep_s = 0.0
        slow = self.slowdown.get(rank)
        if slow is not None and slow.applies(step):
            sleep_s = slow.seconds
            self._log("slow", rank, step, slow.seconds)
        hang_s = 0.0
        hang = self.hang_at.get(rank)
        if hang is not None and hang[0] == step and ("hang", rank, step) not in self._fired:
            with self._lock:
                self._fired.add(("hang", rank, step))
                self._events.append(("hang", rank, step, hang[1]))
            hang_s = hang[1]
        nan = self.nan_at.get(rank) == step
        if nan and ("nan", rank, step) not in self._fired:
            with self._lock:
                self._fired.add(("nan", rank, step))
                self._events.append(("nan", rank, step))
        elif nan:
            nan = False  # fired already (restored replica re-crossing it)
        return StepAction(sleep_s=sleep_s, hang_s=hang_s, nan=nan)
