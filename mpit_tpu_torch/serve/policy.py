"""The scheduling policy: priority, fairness, admission, preemption, as
in :mod:`mpit_tpu.serve.policy`.

Without a policy the :class:`~mpit_tpu_torch.serve.scheduler.Server`
drains one FIFO queue. With one it consults this decision layer at every
admit boundary:

- **Priority tiers** — requests carry a ``priority`` (0 = highest); the
  admit loop drains tiers in strict order. A lower tier runs only when
  every higher tier is empty (sustained high-tier overload can starve
  lower tiers; admission shedding is the relief valve).
- **Per-tenant fairness** — deficit-weighted round robin within a tier:
  each tenant queue earns ``quantum × weight`` credits when the rotation
  reaches it and spends one per admitted request. Deficits stay bounded
  (``≤ max(quantum × weight, 1)``, +1 transiently after a failed
  admission's refund), and a tenant whose queue empties forfeits its
  balance.
- **Admission** — a projected TTFT (:class:`TTFTProjector`: queue depth
  × the measured prefill-tick cost + the decode-tick cost, from the
  stream registry's rolling windows) decides shed or queue at submit:
  when the projection already breaches the request's TTFT target,
  queueing it would only make a certain miss, so it is shed
  (``shed_admission``, apart from ``max_queue``'s ``shed_queue_full``).
  Cold windows abstain.
- **Preemption** — when the best queued tier's longest-waiting request
  is projected to miss its target and nothing frees, the server evicts a
  lower-tier live generation: its pages go back to the allocator, the
  request keeps its tokens on the host and re-enters its tier at the
  front, to resume through the chunked prefill (feed = prompt + tokens)
  or, with a host KV tier, by restreaming its parked pages. A resumed
  greedy request equals its un-preempted run. Paged engines only;
  ``max_preemptions`` bounds thrash.

The policy is host bookkeeping only. The ``Server`` decides when to ask
(submit → :meth:`SchedulingPolicy.should_shed`; admit →
:meth:`~SchedulingPolicy.next` / :meth:`~SchedulingPolicy.restore`;
capacity miss → :meth:`~SchedulingPolicy.wants_preemption` /
:meth:`~SchedulingPolicy.pick_victim`); the policy owns the order and
the verdicts.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Mapping

__all__ = [
    "PolicyConfig",
    "SchedulingPolicy",
    "TTFTProjector",
    "parse_policy_spec",
]


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Knobs for one :class:`SchedulingPolicy`.

    ``quantum``: DRR credits granted per rotation visit (requests-worth;
    a tenant with weight ``w`` can admit up to ``max(quantum × w, 1)``
    requests per turn before the rotation moves on). ``tenant_weights``
    maps tenant id → weight (missing tenants get 1.0). ``admission``
    enables projected-TTFT shedding; a request is shed when the
    projection exceeds ``admission_factor ×`` its TTFT target.
    ``preempt`` enables eviction of lower-tier live generations (paged
    engines only); one request is preempted at most
    ``max_preemptions`` times. ``projection_quantile``/``min_samples``
    shape the estimator (see :class:`TTFTProjector`).
    """

    quantum: float = 4.0
    tenant_weights: Mapping[str, float] = dataclasses.field(
        default_factory=dict
    )
    admission: bool = True
    admission_factor: float = 1.0
    preempt: bool = True
    max_preemptions: int = 3
    projection_quantile: float = 0.5
    min_samples: int = 4

    def __post_init__(self):
        if self.quantum <= 0:
            raise ValueError(f"quantum must be > 0, got {self.quantum}")
        for t, w in self.tenant_weights.items():
            if w <= 0:
                raise ValueError(
                    f"tenant {t!r}: weight must be > 0, got {w}"
                )
        if self.admission_factor <= 0:
            raise ValueError(
                f"admission_factor must be > 0, got {self.admission_factor}"
            )
        if self.max_preemptions < 0:
            raise ValueError(
                f"max_preemptions must be >= 0, got {self.max_preemptions}"
            )
        if not 0.0 < self.projection_quantile <= 1.0:
            raise ValueError(
                f"projection_quantile must be in (0, 1], got "
                f"{self.projection_quantile}"
            )
        if self.min_samples < 1:
            raise ValueError(
                f"min_samples must be >= 1, got {self.min_samples}"
            )


_BOOL_KEYS = ("admission", "preempt")
_FLOAT_KEYS = ("quantum", "admission_factor", "projection_quantile")
_INT_KEYS = ("max_preemptions", "min_samples")


def parse_policy_spec(text: str) -> PolicyConfig:
    """``"quantum=4,preempt=1,admission_factor=1.2,weight.t0=2"`` →
    :class:`PolicyConfig` (the serve CLI's ``--policy`` value; the
    literals ``on`` / ``default`` select the defaults)."""
    text = text.strip()
    if text in ("on", "default", "1", "true"):
        return PolicyConfig()
    kw: dict[str, Any] = {}
    weights: dict[str, float] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"--policy parts are key=value, got {part!r}")
        key, val = part.split("=", 1)
        key = key.strip()
        if key.startswith("weight."):
            weights[key[len("weight."):]] = float(val)
        elif key in _BOOL_KEYS:
            kw[key] = val.strip().lower() in ("1", "true", "yes", "on")
        elif key in _FLOAT_KEYS:
            kw[key] = float(val)
        elif key in _INT_KEYS:
            kw[key] = int(val)
        else:
            raise ValueError(
                f"unknown --policy key {key!r} (valid: "
                f"{', '.join((*_FLOAT_KEYS, *_INT_KEYS, *_BOOL_KEYS))}, "
                f"weight.<tenant>)"
            )
    if weights:
        kw["tenant_weights"] = weights
    return PolicyConfig(**kw)


class TTFTProjector:
    """Projected TTFT for a request entering the queue NOW.

    The model: the queue ahead drains roughly one request
    per prefill tick, so a request behind ``depth`` others waits
    ``depth`` prefill ticks, pays its own, and sits behind the decode
    tick in flight::

        projected = (depth + 1) × prefill_tick + decode_tick

    Both tick costs come from the stream registry's rolling windows
    (``prefill_tick`` / ``decode_tick`` series, fed by the Server once
    per tick) at ``quantile`` (default p50 — the projection is a
    central estimate, not a tail bound; ``admission_factor`` is where
    callers buy slack). Fewer than ``min_samples`` windowed prefill
    observations → ``None`` (abstain): a cold server must not shed on
    a guess.
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


class _TierState:
    """One priority tier's DRR machinery: per-tenant FIFO deques, a
    rotation ring, and the deficit counters."""

    __slots__ = ("queues", "ring", "deficit")

    def __init__(self):
        self.queues: dict[str, deque] = {}
        self.ring: deque[str] = deque()
        self.deficit: dict[str, float] = {}

    def queue_for(self, tenant: str) -> deque:
        """The tenant's deque, registering the tenant in the rotation
        ring + deficit table on first sight — the ONE registration
        path (enqueue/requeue/restore all route here)."""
        q = self.queues.get(tenant)
        if q is None:
            q = self.queues[tenant] = deque()
            self.ring.append(tenant)
            self.deficit.setdefault(tenant, 0.0)
        return q

    def depth(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def oldest_head(self):
        """The longest-waiting queued request. Each tenant deque is
        FIFO by submit order (appendleft only ever fronts OLDER
        restored/parked items), so the per-tenant heads suffice —
        O(tenants), not O(backlog), which matters because this runs on
        every capacity miss in exactly the overload regime."""
        heads = [q[0] for q in self.queues.values() if q]
        return min(heads, key=lambda l: l.submit_t) if heads else None


class SchedulingPolicy:
    """Tiered + deficit-round-robin request ordering with projected-TTFT
    admission and preemption verdicts. See the module docstring for the
    semantics; see ``serve.scheduler`` for the call sites.

    ``registry`` (a :class:`~mpit_tpu_torch.obs.stream.StreamRegistry`) feeds
    the projector; the Server binds its own via :meth:`bind_registry`
    when the policy was constructed without one.
    """

    def __init__(self, config: PolicyConfig | None = None, registry=None):
        self.cfg = config or PolicyConfig()
        self.projector = TTFTProjector(
            registry,
            quantile=self.cfg.projection_quantile,
            min_samples=self.cfg.min_samples,
        )
        self._tiers: dict[int, _TierState] = {}
        # Rolled into Server.stats()["policy"].
        self.preemptions = 0
        self.resumes = 0
        self.shed_admission = 0
        # The most recent admission verdict with the projection inputs
        # that produced it; overwritten per verdict.
        self.last_admission: dict = {"verdict": "none"}
        # The queued head on whose behalf wants_preemption() last said
        # yes: the rid the victim's preemption instant names.
        self.last_preemption_for: str = ""
        # (rid, tier, tenant) in SUCCESSFUL admit order — a failed
        # admission's restore() pops its entry back off. Bounded: a
        # long-running server must not spend memory on a diagnostic
        # (the fairness tests read windows far under the cap).
        self.admitted: deque = deque(maxlen=4096)

    def bind_registry(self, registry) -> None:
        if self.projector.registry is None:
            self.projector.registry = registry

    # -- queue surface -------------------------------------------------------
    def _tier(self, priority: int) -> _TierState:
        st = self._tiers.get(priority)
        if st is None:
            st = self._tiers[priority] = _TierState()
        return st

    def _weight(self, tenant: str) -> float:
        return float(self.cfg.tenant_weights.get(tenant, 1.0))

    def _cap(self, tenant: str) -> float:
        # Every tenant must be able to bank >= 1 request of credit, or
        # a tiny weight could starve it forever (and spin the rotation).
        return max(self.cfg.quantum * self._weight(tenant), 1.0)

    def enqueue(self, live) -> None:
        """Queue one request (``live`` is the scheduler's ``_Live``)."""
        st = self._tier(live.req.priority)
        st.queue_for(live.req.tenant or "").append(live)

    def requeue_front(self, live) -> None:
        """Park-and-resume path: a preempted request re-enters its own
        tier's tenant queue at the FRONT (it already waited its turn;
        making it re-earn credit would double-charge the preemption)."""
        st = self._tier(live.req.priority)
        st.queue_for(live.req.tenant or "").appendleft(live)

    def restore(self, live) -> None:
        """Undo one :meth:`next`: the admission attempt failed (no
        pages), so the request goes back to the head of its queue, the
        spent credit is refunded (transiently pushing the deficit at
        most 1 over its cap — the bounded-counter invariant's only
        excursion, erased by the next successful pop) and its
        ``admitted`` entry comes back off — the log records admissions
        that STUCK."""
        st = self._tier(live.req.priority)
        tenant = live.req.tenant or ""
        st.queue_for(tenant).appendleft(live)
        st.deficit[tenant] = st.deficit.get(tenant, 0.0) + 1.0
        if self.admitted and self.admitted[-1][0] == live.req.rid:
            self.admitted.pop()

    def pending(self) -> int:
        return sum(st.depth() for st in self._tiers.values())

    def depth_at_or_above(self, priority: int) -> int:
        """Queued requests a new ``priority``-class arrival would wait
        behind (its own tier + every higher one) — the projector's
        queue-depth input."""
        return sum(
            st.depth() for p, st in self._tiers.items() if p <= priority
        )

    def tier_depths(self) -> dict[int, int]:
        """Backlog per tier the run has seen — zeros INCLUDED, so a
        tier gauge reads 0 when its queue empties instead of latching
        its last nonzero value."""
        return {p: st.depth() for p, st in sorted(self._tiers.items())}

    # -- the DRR pop ---------------------------------------------------------
    def _next_in_tier(self, st: _TierState):
        if not any(st.queues.values()):
            return None
        # Each full rotation grants every non-empty tenant quantum×w
        # (capped at >= 1), so some deficit reaches 1.0 within
        # ceil(1/(q·w)) rotations of the slowest-earning tenant — the
        # loop bound is sized from that; hitting it is a real
        # accounting bug, not a low-weight tenant earning slowly.
        min_gain = min(
            (self.cfg.quantum * self._weight(t) for t in st.ring),
            default=1.0,
        )
        rotations = int(1.0 / min(min_gain, 1.0)) + 2
        for _ in range(rotations * (len(st.ring) + 1) + 1):
            tenant = st.ring[0]
            q = st.queues.get(tenant)
            if q and st.deficit.get(tenant, 0.0) >= 1.0:
                st.deficit[tenant] -= 1.0
                item = q.popleft()
                if not q:
                    # DRR no-banking rule: an emptied queue forfeits its
                    # balance — credit measures backlog service, not
                    # savings (this is what keeps counters bounded AND
                    # a returning burst from replaying banked credit).
                    st.deficit[tenant] = 0.0
                    st.ring.rotate(-1)
                return item
            # This tenant is done for the turn (empty, or out of
            # credit): move on, granting the NEXT tenant its arrival
            # credit — grants happen exactly once per rotation visit.
            if not q:
                st.deficit[tenant] = 0.0
            st.ring.rotate(-1)
            nxt = st.ring[0]
            if st.queues.get(nxt):
                st.deficit[nxt] = min(
                    st.deficit.get(nxt, 0.0) + self.cfg.quantum
                    * self._weight(nxt),
                    self._cap(nxt),
                )
        raise RuntimeError(
            "DRR rotation failed to converge — deficit accounting bug"
        )

    def next(self):
        """Pop the next request to admit: strict tier order, DRR within
        the tier. ``None`` when nothing is queued. Records the choice
        in ``admitted`` (the fairness tests' observable)."""
        for priority in sorted(self._tiers):
            item = self._next_in_tier(self._tiers[priority])
            if item is not None:
                self.admitted.append(
                    (item.req.rid, priority, item.req.tenant or "")
                )
                return item
        return None

    # -- admission (shed vs queue) -------------------------------------------
    def should_shed(self, req) -> bool:
        """True when queueing ``req`` would already breach its TTFT
        target by projection — shedding now beats a guaranteed miss
        later. Requests without a target (``ttft_target_s <= 0``) are
        never admission-shed; cold windows abstain (admit). Every call
        records its verdict + projection inputs in ``last_admission``."""
        depth = self.depth_at_or_above(req.priority)
        verdict = {
            "queue_depth": depth,
            "ttft_target_s": req.ttft_target_s,
            "admission_factor": self.cfg.admission_factor,
            "proj_ttft_s": None,
        }
        self.last_admission = verdict
        if not self.cfg.admission or req.ttft_target_s <= 0:
            verdict["verdict"] = (
                "no_target" if self.cfg.admission else "disabled"
            )
            return False
        proj = self.projector.projected_ttft_s(depth)
        if proj is None:
            verdict["verdict"] = "abstain_cold"
            return False
        verdict["proj_ttft_s"] = proj
        shed = proj > self.cfg.admission_factor * req.ttft_target_s
        verdict["verdict"] = "shed" if shed else "admit"
        return shed

    # -- preemption ----------------------------------------------------------
    def wants_preemption(self, now: float):
        """The priority (tier) on whose behalf a preemption is
        justified RIGHT NOW, or ``None``: the best non-empty tier's
        longest-waiting request must carry a TTFT target and its
        waited-so-far + projected remaining wait must exceed it. Only
        the best tier is consulted — a lower tier never preempts."""
        if not self.cfg.preempt:
            return None
        for priority in sorted(self._tiers):
            st = self._tiers[priority]
            head = st.oldest_head()
            if head is None:
                continue
            if head.req.ttft_target_s <= 0:
                return None
            proj = self.projector.projected_ttft_s(
                max(st.depth() - 1, 0)
            )
            if proj is None:
                return None
            waited = now - head.submit_t
            if waited + proj > head.req.ttft_target_s:
                # The head this eviction serves.
                self.last_preemption_for = head.req.rid
                return priority
            return None
        return None

    def pick_victim(self, live: Mapping[int, Any], priority: int):
        """The slot to evict for a ``priority``-tier admission: among
        LIVE lower-tier requests not already preempted out
        (``max_preemptions``), the one with the most generation left —
        evicting it buys the most slot/page time per eviction, and its
        re-prefill is the same price as anyone's. Ties break on slot id
        (determinism). ``None`` = nothing eligible."""
        best = None
        for slot in sorted(live):
            l = live[slot]
            if l.req.priority <= priority:
                continue
            if l.preempts >= self.cfg.max_preemptions:
                continue
            remaining = l.req.max_new_tokens - len(l.tokens)
            if remaining <= 0:
                continue
            if best is None or remaining > best[1]:
                best = (slot, remaining)
        return best[0] if best is not None else None

    # -- reporting -----------------------------------------------------------
    def stats(self) -> dict:
        out = {
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "shed_admission": self.shed_admission,
            "queued": self.pending(),
        }
        depths = self.tier_depths()
        if depths:
            out["tier_depths"] = depths
        return out
