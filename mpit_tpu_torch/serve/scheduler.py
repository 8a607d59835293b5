"""Continuous batching: the request loop over the slot-batched engine.

Requests queue on the host and are admitted into free KV-cache slots
between decode ticks (a new request rides the next prefill while the
others keep decoding); each slot retires on EOS, max-new-tokens or a
full cache, and its slot goes to the next queued request at once.
:meth:`Server.run` drains everything submitted (closed loop);
:meth:`Server.run_timed` submits an open-loop arrival trace
(:mod:`mpit_tpu_torch.serve.loadgen`) by its own clock, ticking in
between. ``max_queue`` bounds the queue: arrivals beyond it are shed,
counted and not raised.

``Server(policy=SchedulingPolicy(...))`` replaces the FIFO queue with
the policy tier (:mod:`mpit_tpu_torch.serve.policy`): priority tiers,
tenant-fair order within a tier, projected-TTFT admission shedding at
submit (``shed_admission``, kept apart from ``max_queue``'s
``shed_queue_full``), and preemption on the paged engine: a lower-tier
live generation is parked (its pages freed as retirement frees them,
its tokens kept) and re-queued at the front of its tier, to resume
through the chunked prefill with ``feed = prompt + tokens``. The
resume's last row recomputes the decode tick the eviction displaced, so
a resumed greedy request equals its un-preempted run.

With a host KV tier (``Engine(kv_host_pages=...)``) a victim's pages
are spilled to host seats before they recycle, and its resume restores
them and goes live at once: the next tick writes the displaced row, as
the uninterrupted run's tick did (the JAX package re-runs that row as a
one-token prefill chunk; on the card a chunk's row differs from a
tick's in its last bits, and a greedy token can part at a near-tie). A
retiring slot's sole-reader prefix entries migrate to the host instead
of dying, and a later hit on one restores its pages. Each resume's time (re-admission to its next
token) is recorded by mode, ``restream`` or ``recompute``.

On a paged engine admission also needs pages: the FIFO head is granted
its whole page requirement (fresh pages, shared-prefix mappings and a
copy-on-write reserve) or the queue waits for a retirement to free
some. Admitted requests prefill one ``prefill_chunk`` slice per tick,
interleaved with the decode ticks of the live slots; a write into a
still-shared page copies it out first; a retiring slot unmaps its pages.

Observability (:mod:`mpit_tpu_torch.obs`):

- spans ``prefill`` (per admission batch or prefill chunk) and
  ``decode`` (per tick), each closed by the host fetch of the sampled
  tokens, labelled with the attention mode and sampler actually running
  (and the cache's ``kv_dtype`` when it was chosen explicitly); on a
  speculative engine the ``decode`` span (``spec_k=``) holds the nested
  ``spec_draft`` and ``spec_verify`` spans, with the same labels;
- per-request spans from explicit timestamps: ``queue_wait`` (submit →
  admit), ``request_ttft`` (submit → first token), ``request_latency``
  (submit → retire);
- gauges ``slot_occupancy``, ``kv_tokens_cached`` and, paged,
  ``kv_pool_occupancy`` and ``prefix_pages_shared``; counters
  ``serve_tokens``, ``serve_requests``, ``kv_cow_copies``,
  ``spec_drafted_tokens`` and ``spec_accepted_tokens`` and, in
  kernel mode, ``decode_blocks_skipped`` (cache tiles the length-aware
  kernel did not read this tick, from :func:`num_kv_blocks`); the
  ``kv_pool_exhausted`` instant when admission starts waiting on pages;
- ``serve_shed``/``serve_shed_<cause>`` and ``serve_preemptions``
  counters, the ``request_shed``, ``request_preempted`` and
  ``request_resumed`` instants, and ``kv_host_restreams`` /
  ``kv_prefix_spills`` with a host tier.

The obs layers wired into the loop, each optional:

- ``sentinel=`` (a :class:`~mpit_tpu_torch.obs.Sentinel`, typically
  ``phases=("decode", "prefill")``) observes every prefill and decode
  tick's wall; the engine's ``compile_watch`` and a
  :class:`~mpit_tpu_torch.obs.roofline.UtilizationWatch` over the decode
  tick's modeled HBM rate report into it;
- ``slo=`` (an :class:`~mpit_tpu_torch.obs.SLOMonitor` over ``stream``)
  is evaluated once a tick, idle stretches of ``run_timed`` included;
- ``ledger=`` (a request :class:`~mpit_tpu_torch.obs.Ledger`) receives
  each request's causal events: intake, the admission verdict with its
  projection inputs, shed, ``admit_blocked`` with the headroom that
  refused it, slot bind, prefill chunks, decode-tick membership, COW
  copies, preemption park and resume, spec draft and accept, retire
  with its reason; the sentinel's notes pin the in-flight set;
- the engine's memory ledger (``engine.memledger``): the scheduler
  grants and frees the dense cache's slots, keeps owners' recency,
  samples held bytes and KV headroom a tick, and at a pool-exhaustion
  edge records the ranked holders; ``stats()["memory"]`` is the byte
  decomposition with its conservation verdict and, on the card, its
  reconciliation with the allocator;
- the roofline: a kernel engine's decode (or verify) tick feeds its
  length-aware modeled bytes (:meth:`Engine.decode_achieved_hbm_bytes`)
  as explicit work, so ``obs.summary()["roofline"]`` divides what the
  kernel read by the tick's wall.

``worker_id`` / ``role`` name the server in a fleet (``single`` /
``standalone`` alone).

``stream=`` (a :class:`~mpit_tpu_torch.obs.stream.StreamRegistry`) gets
the rolling-window feed under the JAX package's names: histograms
``request_ttft``, ``request_latency``, ``queue_wait``, ``prefill_tick``,
``decode_tick`` (and ``resume_<mode>``); rates ``serve_arrivals``,
``serve_completed``, ``serve_tokens``, ``serve_shed``,
``serve_shed_<cause>``, ``serve_preemptions``; gauges ``queue_depth``,
``slot_occupancy`` (and the KV gauges). A policy's projector reads the
two tick windows; a policy without a registry gets a private one.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any

import numpy as np

from mpit_tpu_torch import obs
from mpit_tpu_torch.ops.decode_attention import num_kv_blocks

__all__ = ["Completed", "Request", "Server", "warm_engine"]


def warm_engine(engine, *, register_costs: bool = False) -> None:
    """Run one throwaway request through ``engine`` (spanned
    ``warmup``), then reset it: the first launches' one-off costs land
    outside a timed window. A paged engine also copies page 0 onto
    itself (the COW copy), and a host tier spills page 0 to seat 0,
    drains and restores it (a no-op round trip). The engine's
    ``compile_watch`` is then pinned to the builds so far: a kernel
    library built later is an ``unexpected_recompile``.
    ``register_costs=True`` also registers the steps' analytic costs with
    the obs recorder (:meth:`~mpit_tpu_torch.serve.Engine.register_roofline`)."""
    with obs.span("warmup"):
        warm = Server(engine)
        warm.submit(Request(rid="warm", prompt=[1, 2, 3], max_new_tokens=2))
        warm.run()
        if engine.paged:
            engine.copy_page(0, 0)
            if engine.host_pages:
                engine.spill_page(0, 0)
                engine.drain_spills()
                engine.restore_page(0, 0, release=True, kind="warm")
        watch = engine.compile_watch
        watch.expected = watch.compiles
        if register_costs:
            engine.register_roofline()
    engine.reset()


@dataclasses.dataclass
class Request:
    """One generation request. ``temperature <= 0`` = greedy;
    ``top_k = 0`` = full vocabulary; ``eos_id = None`` = never stop
    early; ``tenant`` labels the requester (stamped on its spans when
    set). ``priority`` is the scheduling policy's tier (0 = highest; the
    FIFO scheduler ignores it) and ``ttft_target_s`` the TTFT target the
    policy's admission and preemption decisions use (<= 0 = none)."""

    rid: Any
    prompt: list[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    eos_id: int | None = None
    tenant: str = ""
    priority: int = 0
    ttft_target_s: float = 0.0


@dataclasses.dataclass
class Completed:
    """A finished request: output + the latency facts the histograms
    aggregate. ``tokens`` includes the EOS token when one stopped it."""

    rid: Any
    prompt: list[int]
    tokens: list[int]
    submit_t: float
    first_token_t: float
    finish_t: float
    truncated: bool = False  # retired by cache-full, not EOS/max-tokens
    tenant: str = ""

    @property
    def ttft_s(self) -> float:
        return self.first_token_t - self.submit_t

    @property
    def latency_s(self) -> float:
        return self.finish_t - self.submit_t


@dataclasses.dataclass
class _Live:
    req: Request
    submit_t: float
    first_token_t: float = 0.0
    tokens: list = dataclasses.field(default_factory=list)
    # Paged prefill state: ``base`` = prompt tokens already cached
    # (advanced per chunk), ``floor`` = the shared-prefix write floor
    # granted at admission (positions below it live in immutable shared
    # pages).
    base: int = 0
    floor: int = 0
    # Preemption: ``feed`` is None until a preemption parks the request,
    # then prompt + the tokens generated so far (the resume prefill's
    # last row is the decode tick the eviction displaced); ``preempts``
    # bounds thrash; ``park_tick`` is the tick it was parked.
    feed: list | None = None
    preempts: int = 0
    park_tick: int = 0
    # The last tick this request's cache was touched (bind, prefill
    # chunk, decode): the memory ledger's eviction ranking reads it.
    last_touch: int = 0
    # How the last resume rebuilt the cache ("restream" from parked host
    # pages, "recompute" through the chunked prefill) and when it was
    # re-admitted; cleared at the first token after the resume.
    resume_mode: str = ""
    resume_t: float = 0.0

    def remaining_new(self) -> int:
        """Output tokens still owed: a speculative tick's budget, and
        the generation term of a resume's page requirement (the tokens
        already generated move into the feed, so the pages are the
        same)."""
        return self.req.max_new_tokens - len(self.tokens)

    def feed_tokens(self) -> list:
        """What prefill feeds the device: the prompt, or the resume
        sequence after a preemption."""
        return self.feed if self.feed is not None else self.req.prompt

    def cache_fill(self) -> int:
        """Host mirror of the slot's device cache fill. Prefill cached
        the prompt; each decode tick appends ONE token; the newest
        sampled token is not written yet — so the fill is ``prompt +
        generated - 1``, and the next decode append lands exactly here."""
        return len(self.req.prompt) + len(self.tokens) - 1


class Server:
    """The continuous-batching loop around one
    :class:`~mpit_tpu_torch.serve.Engine`.

    Host-side only: slot bookkeeping, the request queue, retirement and
    telemetry. ``submit()`` enqueues (or sheds); ``run()`` drives
    admit/decode ticks until the queue and all slots drain (or
    ``max_ticks``); ``run_timed()`` drives an open-loop arrival trace by
    its clock. ``stream``, ``max_queue``, ``policy``, ``sentinel``,
    ``slo``, ``ledger``, ``worker_id`` and ``role``: module docstring.
    """

    def __init__(self, engine, *, sentinel=None, stream=None, slo=None, max_queue=None,
                 policy=None, ledger=None, worker_id="", role=""):
        self.engine = engine
        self.policy = policy
        self.sentinel = sentinel
        self.worker_id = worker_id or "single"
        self.role = role or "standalone"
        self._ledger = ledger
        if ledger is not None and sentinel is not None:
            # A breach or anomaly pins the requests in flight when it
            # fires; chained, so a caller's own callback keeps firing.
            prev = sentinel.on_note

            def _pin(record, _prev=prev, _ledger=ledger):
                if _prev is not None:
                    _prev(record)
                _ledger.pin_inflight(record.get("kind", "anomaly"), step=record.get("step"))

            sentinel.on_note = _pin
        if policy is not None and stream is None:
            # The policy's projector reads rolling tick windows: without
            # a caller's registry a private one keeps admission and
            # preemption on evidence, not silently off.
            from mpit_tpu_torch.obs.stream import StreamRegistry

            stream = StreamRegistry()
        self.stream = stream
        if policy is not None:
            policy.bind_registry(stream)
        self.slo = slo
        if slo is not None and stream is None:
            raise ValueError(
                "Server(slo=...) needs the stream registry the monitor "
                "evaluates over — pass stream=slo.registry"
            )
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        # Stamped on every prefill/decode span: the attention mode and
        # the sampler this engine runs, and the cache and weight dtypes
        # when they were chosen explicitly.
        self._attn_mode = engine.decode_attention
        self._sampler = engine.decode_sampler
        self._kv_attrs = (
            {"kv_dtype": engine.kv_dtype} if engine.kv_dtype_explicit else {}
        )
        if engine.weights_dtype_explicit:
            self._kv_attrs["weights_dtype"] = engine.weights_dtype
        self._paged = engine.paged
        self._host_tier = self._paged and engine.host_pages > 0
        # Speculative decoding: k drafted tokens a tick, and the roll-up
        # stats() reports (tokens emitted per slot-tick, acceptance).
        self._spec = int(getattr(engine, "spec_k", 0) or 0)
        self._spec_emitted = 0
        self._spec_active_ticks = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        # An unexpected kernel-library build and a sustained collapse of
        # the decode tick's modeled HBM rate land in this server's
        # sentinel report.
        if sentinel is not None:
            engine.compile_watch.sentinel = sentinel
        self._util_watch = (
            obs.roofline.UtilizationWatch(sentinel=sentinel) if sentinel is not None else None
        )
        self._decode_hbm_bytes = 0.0  # length-aware modeled bytes moved
        self._memledger = engine.memledger
        self._held_peak = 0
        self._headroom_min_pct: float | None = None
        self._host_held_peak = 0
        self.queue: deque[_Live] = deque()
        self.live: dict[int, _Live] = {}  # slot -> in-flight request
        # Paged: slots whose prompt is still being written, one chunk
        # per tick.
        self.prefilling: dict[int, _Live] = {}
        self.free: list[int] = list(range(engine.slots))[::-1]  # pop() = slot 0 first
        self.completed: list[Completed] = []
        self.shed: list[Request] = []
        self.shed_causes: dict[str, int] = {}  # cause -> count
        self.tick = 0
        self.admissions = 0
        self._occupancy_sum = 0.0
        self._concurrency_peak = 0
        self._truncated = False  # a run stopped with work still pending
        self._pool_exhausted = False  # edge trigger of the obs instant
        self._kv_occ_sum = 0.0
        self._kv_occ_peak = 0.0
        self._pages_shared_peak = 0
        self._host_in_use_peak = 0
        # Resume durations by rebuild mode: re-admission to the first
        # token after it.
        self.resume_durations: dict[str, list] = {"restream": [], "recompute": []}
        # Per-slot sampling-control arrays (host; refreshed on admit/retire).
        s = engine.slots
        self._temp = np.zeros((s,), np.float32)
        self._topk = np.zeros((s,), np.int32)

    # -- intake -------------------------------------------------------------
    @staticmethod
    def _span_attrs(req: Request) -> dict:
        """``rid`` (and ``tenant`` when set) for per-request spans."""
        return {"rid": req.rid, "tenant": req.tenant} if req.tenant else {"rid": req.rid}

    def submit(self, req: Request) -> bool:
        """Enqueue one request; returns False when it was shed instead:
        by ``max_queue`` (cause ``queue_full``) or by the policy's
        projected-TTFT verdict (cause ``admission``). Malformed requests
        raise: shedding is a load decision, validation a caller's bug."""
        if not req.prompt:
            raise ValueError(f"request {req.rid!r}: empty prompt")
        if req.priority < 0:
            raise ValueError(
                f"request {req.rid!r}: priority must be >= 0 (0 = "
                f"highest tier), got {req.priority}"
            )
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.rid!r}: max_new_tokens must be >= 1 "
                f"(prefill always samples the first token), got "
                f"{req.max_new_tokens}"
            )
        if len(req.prompt) > self.engine.prefill_len:
            raise ValueError(
                f"request {req.rid!r}: prompt length {len(req.prompt)} > "
                f"engine prefill_len {self.engine.prefill_len}"
            )
        if len(req.prompt) + req.max_new_tokens > self.engine.max_len:
            raise ValueError(
                f"request {req.rid!r}: prompt + max_new_tokens "
                f"({len(req.prompt)} + {req.max_new_tokens}) exceeds the "
                f"engine's max_len {self.engine.max_len}"
            )
        if self._spec and not self._paged:
            # The dense verify writes k + 1 rows at the fill; JAX's
            # dense write clamps its start at the buffer's end, so
            # without k - 1 spare rows it would write shifted rows. The
            # port refuses the same geometry at submit. (The pool needs
            # none: rows past a slot's mapped pages are not written.)
            need = len(req.prompt) + req.max_new_tokens + self._spec - 1
            if need > self.engine.max_len:
                raise ValueError(
                    f"request {req.rid!r}: speculative decode (spec_k="
                    f"{self._spec}) writes draft rows past the fill: prompt + "
                    f"max_new_tokens + spec_k - 1 = {need} exceeds the dense "
                    f"cache's max_len {self.engine.max_len}; shrink the request, "
                    f"lower spec_k, or grow max_len"
                )
        if self._paged:
            # A request the pool could never hold is a caller error:
            # raise now, not when admission finds it can never stop
            # waiting.
            alloc = self.engine.allocator
            need = alloc.pages_for(len(req.prompt), req.max_new_tokens)
            if need > alloc.num_pages:
                raise ValueError(
                    f"request {req.rid!r}: needs {need} pages of "
                    f"{alloc.page_size} tokens but the pool holds only "
                    f"{alloc.num_pages}; shrink prompt + max_new_tokens "
                    f"or grow Engine(kv_pages=...)"
                )
        k_cap = self.engine.sample_k_cap
        if k_cap is not None and req.top_k > k_cap:
            raise ValueError(
                f"request {req.rid!r}: top_k {req.top_k} exceeds the "
                f"blocked sampler's candidate buffer (sample_k_cap="
                f"{k_cap}); raise Engine(sample_k_cap=...) or use "
                f"top_k=0 (full vocab)"
            )
        if self.stream is not None:
            # Arrivals count before the shed decision: a shed rate is
            # sheds over arrivals.
            self.stream.inc("serve_arrivals")
        if self._ledger is not None:
            # The ledger opens at intake: a shed request still gets its
            # verdict, which is what a why-slow reading needs.
            self._ledger.begin(
                req.rid, priority=req.priority, tenant=req.tenant,
                prompt_len=len(req.prompt), max_new=req.max_new_tokens,
            )
        cause = None
        if self.max_queue is not None and self._qdepth() >= self.max_queue:
            cause = "queue_full"
        elif self.policy is not None:
            if self.policy.should_shed(req):
                cause = "admission"
                self.policy.shed_admission += 1
            if self._ledger is not None:
                # The verdict with the projection inputs behind it.
                self._ledger.event(req.rid, "admission", **self.policy.last_admission)
        reason = {"queue_full": "queue_full", "admission": "admission_projection"}.get(cause)
        if cause is not None:
            self.shed.append(req)
            self.shed_causes[cause] = self.shed_causes.get(cause, 0) + 1
            obs.counter("serve_shed")
            obs.counter(f"serve_shed_{cause}")
            # The headroom the refusal was made against.
            headroom = self._kv_headroom()
            obs.instant(
                "request_shed", cause=cause, reason=reason, queue_depth=self._qdepth(),
                **headroom, **self._span_attrs(req),
            )
            if self.stream is not None:
                self.stream.inc("serve_shed")
                self.stream.inc(f"serve_shed_{cause}")
            if self._ledger is not None:
                self._ledger.event(req.rid, "shed", reason=reason,
                                   queue_depth=self._qdepth(), **headroom)
                self._ledger.retire(req.rid, status="shed", reason=reason)
            return False
        self._enqueue(_Live(req, time.perf_counter()))
        return True

    # -- queue plumbing (FIFO deque or the policy's tiers) --------------------
    def _enqueue(self, live: _Live) -> None:
        if self.policy is not None:
            self.policy.enqueue(live)
        else:
            self.queue.append(live)

    def _qdepth(self) -> int:
        return self.policy.pending() if self.policy is not None else len(self.queue)

    def _next_queued(self) -> _Live | None:
        """Pop the next request to admit: FIFO, or the policy's
        tier-then-deficit-round-robin choice."""
        if self.policy is not None:
            return self.policy.next()
        return self.queue.popleft() if self.queue else None

    def _restore_queued(self, live: _Live) -> None:
        """Undo one pop (the admission found no pages): back to the head
        of its queue (the policy also refunds the spent credit)."""
        if self.policy is not None:
            self.policy.restore(live)
        else:
            self.queue.appendleft(live)

    # -- the loop -----------------------------------------------------------
    def _admit(self) -> None:
        """Move queued requests into free slots and start their prefill:
        dense = one batched whole-prompt call; paged = map pages and
        enter the per-tick chunk pipeline."""
        if self._paged:
            self._admit_paged()
        else:
            self._admit_dense()

    def _admit_paged(self) -> None:
        """Grant the next queued request (FIFO head, or the policy's
        choice) a free slot and its whole page requirement (all or
        nothing, in the allocator), or stop: stopping at the first
        request that does not fit keeps admission fair, so a stream of
        small requests cannot starve a big one.

        With a policy, a capacity miss (no free slot, or no pages for
        the chosen request) may preempt instead of stopping: when the
        best queued tier's head is projected to miss its TTFT target, a
        lower-tier live generation is parked and the loop retries. Each
        preemption frees one victim; the live set and
        ``max_preemptions`` bound the loop."""
        alloc = self.engine.allocator
        now = time.perf_counter()
        while True:
            if not self.free:
                if not self._try_preempt(now):
                    break
                continue  # a slot (and its victim's pages) just freed
            live = self._next_queued()
            if live is None:
                break
            slot = self.free[-1]
            feed = live.feed_tokens()
            plan = alloc.admit(
                slot, feed, live.remaining_new(), owner=live.req.rid,
                tenant=live.req.tenant or None, tick=self.tick,
            )
            if plan is None:
                # The pool is full right now; nothing was taken. Back to
                # the queue head, and retry once a retirement (or a
                # preemption) frees pages. The instant marks only the
                # transition into exhaustion, so a long overload writes
                # one event, not one per tick.
                self._restore_queued(live)
                if self._try_preempt(now):
                    continue
                if self._ledger is not None:
                    self._ledger.event(
                        live.req.rid, "admit_blocked", tick=self.tick,
                        need_pages=alloc.pages_for(len(feed), live.remaining_new()),
                        free_pages=alloc.free_pages, **self._kv_headroom(),
                    )
                if not self._pool_exhausted:
                    self._pool_exhausted = True
                    # Who holds the pool the head needed, ranked.
                    dump = self._exhaustion_dump()
                    self._memledger.note_exhaustion(dump)
                    obs.instant("kv_pool_exhausted", **dump)
                break
            self.free.pop()
            self._pool_exhausted = False
            live.last_touch = self.tick
            # The write floor is the shared-token count; the forward
            # re-runs at least the last feed token (its output seeds the
            # next token), so the feed base stops one below the end even
            # on a full-feed prefix hit.
            live.floor = plan.shared_tokens
            live.base = min(plan.shared_tokens, len(feed) - 1)
            self._temp[slot] = live.req.temperature
            self._topk[slot] = live.req.top_k
            if plan.restream:
                # A host-tier prefix hit: its pages come back into the
                # fresh pages before the first chunk, and the write floor
                # masks re-writes below it as for a pool hit. The entry
                # keeps its seats until promotion.
                for hp, dp in plan.restream:
                    self.engine.restore_page(hp, dp, owner=live.req.rid, tick=self.tick)
                obs.counter("kv_host_restreams", len(plan.restream))
            if self._ledger is not None:
                self._ledger.event(
                    live.req.rid, "slot_bind", slot=slot, tick=self.tick,
                    resumed=bool(live.tokens), shared_tokens=plan.shared_tokens,
                    pages=plan.pages_granted, restreamed_pages=len(plan.restream),
                )
            if live.tokens:
                # Resumed after a preemption: its queue wait and TTFT
                # were recorded in its first stint.
                mode = "recompute"
                if self._host_tier:
                    rec = alloc.peek_parked(live.req.rid)
                    if rec is not None:
                        if self._restream_parked(slot, live, plan, rec):
                            mode = "restream"
                        alloc.take_parked(live.req.rid)
                live.resume_mode = mode
                live.resume_t = now
                if self.policy is not None:
                    self.policy.resumes += 1
                obs.instant(
                    "request_resumed", generated=len(live.tokens), mode=mode,
                    **self._span_attrs(live.req),
                )
                if self._ledger is not None:
                    self._ledger.event(
                        live.req.rid, "preempt_resume", slot=slot, tick=self.tick,
                        generated=len(live.tokens), mode=mode,
                    )
            else:
                obs.span_at(
                    "queue_wait", live.submit_t, now, **self._span_attrs(live.req)
                )
                if self.stream is not None:
                    self.stream.observe("queue_wait", now - live.submit_t)
            if live.resume_mode == "restream":
                # Every row below the fill is back: the slot decodes
                # from this tick on (_finish_restream closes the resume).
                self.engine.arm_slot(slot, live.cache_fill(), live.tokens[-1])
                self.live[slot] = live
            else:
                self.prefilling[slot] = live
            self.admissions += 1

    # -- preemption (paged engines only) --------------------------------------
    def _try_preempt(self, now: float) -> bool:
        """Park one lower-tier live generation when the policy says the
        best queued tier's head would otherwise miss its TTFT target.
        True when a victim was evicted (a slot and its pages are free)."""
        if self.policy is None or not self._paged:
            return False
        priority = self.policy.wants_preemption(now)
        if priority is None:
            return False
        # A restreamed resume awaiting its first tick is still mid-resume,
        # as a prefilling slot is: not a candidate.
        victim = self.policy.pick_victim(
            {s: l for s, l in self.live.items() if l.resume_mode != "restream"}, priority
        )
        if victim is None:
            return False
        self._preempt(victim, for_tier=priority)
        return True

    def _preempt(self, slot: int, *, for_tier: int | None = None) -> None:
        """Evict ``slot``'s live request: free its pages as retirement
        frees them (sole-owner pages to the free list, shared pages one
        refcount down), keep its tokens as the resume feed, and re-queue
        it at the front of its tier (of the FIFO queue without a
        policy). With a host tier its filled rows are spilled first, all
        or nothing, and the prefix entries dying with the slot migrate;
        otherwise the resume recomputes them."""
        live = self.live.pop(slot)
        alloc = self.engine.allocator
        owned, shared = alloc.slot_page_stats(slot)
        spilled = 0
        if self._host_tier:
            planned = alloc.park_pages(live.req.rid, slot, live.cache_fill())
            if planned is not None:
                copies, evicted = planned
                for hp in evicted:
                    self.engine.host_free(hp, kind="host_evict")
                for dp, hp in copies:
                    self.engine.spill_page(dp, hp, owner=live.req.rid, tick=self.tick)
                spilled = len(copies)
            self._spill_dying_prefixes(slot, owner=live.req.rid)
        alloc.free_slot(slot)
        self.free.append(slot)
        self._temp[slot] = 0.0
        self._topk[slot] = 0
        live.preempts += 1
        live.feed = list(live.req.prompt) + [int(t) for t in live.tokens]
        live.base = 0
        live.floor = 0
        live.park_tick = self.tick
        # Parked is cold: the owner stays on the ledger's recency index,
        # marked parked, for the eviction ranking.
        self._memledger.touch(live.req.rid, tick=self.tick,
                              tenant=live.req.tenant or None, state="parked")
        obs.counter("serve_preemptions")
        for_rid = self.policy.last_preemption_for if for_tier is not None else ""
        obs.instant(
            "request_preempted",
            tier=live.req.priority,
            for_tier=for_tier if for_tier is not None else -1,
            for_rid=for_rid,
            generated=len(live.tokens),
            pages_freed=owned,
            pages_unshared=shared,
            pages_spilled=spilled,
            **self._span_attrs(live.req),
        )
        if self._ledger is not None:
            self._ledger.event(
                live.req.rid, "preempt_park", tick=self.tick, tier=live.req.priority,
                for_tier=for_tier if for_tier is not None else -1, for_rid=for_rid,
                generated=len(live.tokens), pages_freed=owned,
            )
        if self.stream is not None:
            self.stream.inc("serve_preemptions")
        if self.policy is not None:
            self.policy.preemptions += 1
            self.policy.requeue_front(live)
        else:
            self.queue.appendleft(live)

    def _spill_dying_prefixes(self, slot: int, *, owner=None) -> None:
        """Migrate the prefix entries that would die with ``slot``'s
        pages to the host tier; call just before ``free_slot``. All or
        nothing: when the tier cannot hold them they die as without it."""
        if not self._host_tier:
            return
        copies, evicted = self.engine.allocator.spill_prefix_on_free(slot)
        for hp in evicted:
            self.engine.host_free(hp, kind="host_evict")
        for dp, hp in copies:
            self.engine.spill_page(dp, hp, owner=owner, tick=self.tick)
        if copies:
            obs.counter("kv_prefix_spills", len(copies))

    def _restream_parked(self, slot: int, live: _Live, plan, rec) -> bool:
        """Rebuild a resumed victim's rows ``[shared, fill)`` from its
        parked seats instead of prefilling the feed again. Rows below
        the admission's shared floor are on the pool already (a prefix
        hit); a still-shared boundary page is copied out first, and each
        restored page is written whole (parked rows below the floor equal
        the resident ones, rows past the fill stay masked). False when
        the prefix hit already covers every parked row (the payloads are
        dropped, and the feed's one remaining row is prefilled)."""
        eng = self.engine
        alloc = eng.allocator
        ps = alloc.page_size
        s = plan.shared_tokens
        fill = rec.fill
        rid = live.req.rid
        if s >= fill:
            for hp in rec.host_pages:
                eng.host_free(hp, kind="restream_unused", owner=rid)
            return False
        if s % ps:
            # The boundary page holds shared rows below ``s``: a whole-page
            # restore over a still-shared page would corrupt its other
            # readers. The admission reserved the page this copy takes.
            pair = alloc.cow_before_write(slot, s)
            if pair is not None:
                eng.copy_page(*pair)
                obs.counter("kv_cow_copies")
                if self._ledger is not None:
                    self._ledger.event(rid, "cow_copy", tick=self.tick, src=pair[0],
                                       dst=pair[1], phase="restream")
        bt = alloc.block_tables[slot]
        for pi in range(s // ps, (fill - 1) // ps + 1):
            eng.restore_page(int(rec.host_pages[pi]), int(bt[pi]), release=True,
                             kind="restream", owner=rid, tick=self.tick)
        for pi in range(0, s // ps):
            # Wholly below the shared floor: the pool's pages serve them.
            eng.host_free(int(rec.host_pages[pi]), kind="restream_unused", owner=rid)
        return True

    def _finish_restream(self, slot: int, live: _Live, now: float) -> None:
        """After the first tick of a restreamed resume, which wrote the
        feed's last row: register the feed in the prefix index (as a
        resume's final prefill chunk does) and record the resume's time."""
        alloc = self.engine.allocator
        for hp in alloc.register_prefix(slot, live.feed_tokens(), tick=self.tick):
            self.engine.host_free(hp, kind="promote", owner=live.req.rid)
        self._close_resume(live, now)

    def _close_resume(self, live: _Live, now: float) -> None:
        """Record a resume's time, re-admission to its next token, by mode."""
        dur = now - live.resume_t
        self.resume_durations.setdefault(live.resume_mode, []).append(dur)
        if self.stream is not None:
            self.stream.observe(f"resume_{live.resume_mode}", dur)
        live.resume_mode = ""

    def _prefill_chunk_tick(self) -> None:
        """Advance every prefilling slot by one feed chunk, in one
        batched call. Slots whose last feed token rides this chunk
        sample their next token, register their feed in the prefix index
        (only now: an entry must never advertise K/V not yet on the
        device) and go live."""
        if not self.prefilling:
            return
        eng = self.engine
        alloc = eng.allocator
        s, w = eng.slots, eng.prefill_chunk
        tokens = np.zeros((s, w), np.int32)
        base = np.zeros((s,), np.int32)
        chunk_lens = np.zeros((s,), np.int32)
        floor = np.zeros((s,), np.int32)
        sample_mask = np.zeros((s,), bool)
        finishing: list[tuple[int, _Live]] = []
        now = time.perf_counter()
        for slot, live in self.prefilling.items():
            p = live.feed_tokens()
            n = min(w, len(p) - live.base)
            # This chunk's first write: at the floor on a partial-page
            # prefix hit, else at the base. A write landing in a
            # still-shared page copies it out first; the admission
            # reserve guarantees the free page.
            first_write = max(live.base, live.floor)
            if first_write < live.base + n:
                pair = alloc.cow_before_write(slot, first_write)
                if pair is not None:
                    eng.copy_page(*pair)
                    obs.counter("kv_cow_copies")
                    if self._ledger is not None:
                        self._ledger.event(live.req.rid, "cow_copy", tick=self.tick,
                                           src=pair[0], dst=pair[1], phase="prefill")
            tokens[slot, :n] = p[live.base : live.base + n]
            base[slot] = live.base
            chunk_lens[slot] = n
            floor[slot] = live.floor
            if live.base + n == len(p):
                sample_mask[slot] = True
                finishing.append((slot, live))
        with obs.span(
            "prefill",
            admitted=len(finishing),
            chunks=int((chunk_lens > 0).sum()),
            attention=self._attn_mode,
            sampler=self._sampler,
            rids=[live.req.rid for live in self.prefilling.values()],
            **self._kv_attrs,
        ):
            first = eng.prefill_paged(
                tokens, base, chunk_lens, floor, sample_mask,
                self._temp, self._topk,
            )
        t_first = time.perf_counter()
        if self.sentinel is not None:
            self.sentinel.observe_phases(self.tick, prefill=t_first - now)
        if self.stream is not None:
            self.stream.observe("prefill_tick", t_first - now)
        for slot, live in self.prefilling.items():
            n = int(chunk_lens[slot])
            live.base += n
            if n:
                live.last_touch = self.tick
                if self._ledger is not None:
                    self._ledger.event(live.req.rid, "prefill_chunk", tick=self.tick,
                                       chunk=n, dur_s=t_first - now, t=t_first)
        for slot, live in finishing:
            del self.prefilling[slot]
            for hp in alloc.register_prefix(slot, live.feed_tokens(), tick=self.tick):
                # Promoted: the prefix is on the pool again.
                eng.host_free(hp, kind="promote", owner=live.req.rid)
            if live.tokens:
                # Resumed: this chunk's token is the decode step the
                # eviction displaced.
                live.tokens.append(int(first[slot]))
                if live.resume_mode:
                    self._close_resume(live, t_first)
            else:
                live.first_token_t = t_first
                live.tokens = [int(first[slot])]
                self._record_ttft(live, t_first)
            self.live[slot] = live
            self._maybe_retire(slot, t_first)

    def _record_ttft(self, live: _Live, t_first: float) -> None:
        """The ``request_ttft`` span and windows, with the per-tier
        series (``request_ttft_tier<p>``) when tiers are in play and the
        per-tenant one behind ``stats()``'s tenant roll-up."""
        req = live.req
        obs.span_at("request_ttft", live.submit_t, t_first, **self._span_attrs(req))
        if self.stream is None:
            return
        ttft = t_first - live.submit_t
        self.stream.observe("request_ttft", ttft)
        if self.policy is not None or req.priority or req.ttft_target_s > 0:
            self.stream.observe(f"request_ttft_tier{req.priority}", ttft)
        if req.tenant:
            self.stream.observe(f"request_ttft_tenant:{req.tenant}", ttft)

    def _admit_dense(self) -> None:
        """Move queued requests into free slots (FIFO, or the policy's
        order) and prefill them, in one batched call however many were
        admitted this tick. The dense engine never preempts: a slot has
        no pages to free."""
        if not self._qdepth() or not self.free:
            return
        s, plen = self.engine.slots, self.engine.prefill_len
        tokens = np.zeros((s, plen), np.int32)
        lens = np.ones((s,), np.int32)
        admit = np.zeros((s,), bool)
        batch: list[tuple[int, _Live]] = []
        now = time.perf_counter()
        while self.free:
            live = self._next_queued()
            if live is None:
                break
            slot = self.free.pop()
            p = live.req.prompt
            tokens[slot, : len(p)] = p
            lens[slot] = len(p)
            admit[slot] = True
            self._temp[slot] = live.req.temperature
            self._topk[slot] = live.req.top_k
            live.last_touch = self.tick
            # The dense cache's capacity is slot-granular: one slot
            # granted an admission, freed at retirement.
            self._memledger.grant(
                "kv_slots", self.engine.slot_bytes, owner=live.req.rid,
                tenant=live.req.tenant or None, tick=self.tick, kind="admit",
            )
            if self._ledger is not None:
                self._ledger.event(live.req.rid, "slot_bind", slot=slot, tick=self.tick,
                                   resumed=False, t=now)
            obs.span_at("queue_wait", live.submit_t, now, **self._span_attrs(live.req))
            if self.stream is not None:
                self.stream.observe("queue_wait", now - live.submit_t)
            batch.append((slot, live))
        with obs.span(
            "prefill", admitted=len(batch), attention=self._attn_mode,
            sampler=self._sampler,
            rids=[live.req.rid for _, live in batch],
            **self._kv_attrs,
        ):
            first = self.engine.prefill(
                tokens, lens, admit, self._temp, self._topk
            )
        t_first = time.perf_counter()
        self.admissions += len(batch)
        if self.sentinel is not None:
            self.sentinel.observe_phases(self.tick, prefill=t_first - now)
        if self.stream is not None:
            self.stream.observe("prefill_tick", t_first - now)
        if self._ledger is not None:
            # One whole-prompt chunk; the batch's wall is each request's.
            for slot, live in batch:
                self._ledger.event(live.req.rid, "prefill_chunk", tick=self.tick,
                                   chunk=len(live.req.prompt), dur_s=t_first - now, t=t_first)
        for slot, live in batch:
            live.first_token_t = t_first
            live.tokens = [int(first[slot])]
            self._record_ttft(live, t_first)
            self.live[slot] = live
            self._maybe_retire(slot, t_first)

    def _maybe_retire(self, slot: int, now: float) -> None:
        """Retire ``slot`` if its newest token finished the request."""
        live = self.live[slot]
        req = live.req
        tok = live.tokens[-1]
        # The next decode would write at the fill position: at max_len
        # the slot must retire or it would overrun its buffer.
        full = live.cache_fill() >= self.engine.max_len
        done = (
            (req.eos_id is not None and tok == req.eos_id)
            or len(live.tokens) >= req.max_new_tokens
            or full
        )
        if not done:
            return
        del self.live[slot]
        if self._paged:
            # Unmap the slot's pages: sole-owner pages return to the free
            # list (handed out again without zeroing) and the prefix
            # entries citing them die, unless the host tier takes them.
            self._spill_dying_prefixes(slot, owner=req.rid)
            self.engine.allocator.free_slot(slot)
        else:
            self._memledger.free("kv_slots", self.engine.slot_bytes, owner=req.rid,
                                 kind="retire")
        self._memledger.forget(req.rid)
        self.free.append(slot)
        self._temp[slot] = 0.0
        self._topk[slot] = 0
        obs.span_at("request_latency", live.submit_t, now, **self._span_attrs(req))
        obs.counter("serve_requests")
        if self.stream is not None:
            self.stream.observe("request_latency", now - live.submit_t)
            self.stream.inc("serve_completed")
        truncated = (
            full and tok != req.eos_id and len(live.tokens) < req.max_new_tokens
        )
        if self._ledger is not None:
            if req.eos_id is not None and tok == req.eos_id:
                reason = "eos"
            elif len(live.tokens) >= req.max_new_tokens:
                reason = "max_tokens"
            else:
                reason = "cache_full"
            self._ledger.event(req.rid, "retire", tick=self.tick, reason=reason,
                               generated=len(live.tokens), t=now)
            self._ledger.retire(req.rid, t=now,
                                status="truncated" if truncated else "completed",
                                reason=reason)
        self.completed.append(
            Completed(
                rid=req.rid,
                prompt=list(req.prompt),
                tokens=list(live.tokens),
                submit_t=live.submit_t,
                first_token_t=live.first_token_t,
                finish_t=now,
                truncated=truncated,
                tenant=req.tenant,
            )
        )

    def _spec_tick(self) -> None:
        """One speculative decode tick: draft k tokens per live slot,
        verify the k + 1 positions in one target pass, emit each slot's
        longest accepted prefix and the replacement / bonus token, the
        lengths advanced on the device by exactly the emitted count (the
        rollback). Spanned ``decode`` (``spec_k=``) around the nested
        ``spec_draft`` and ``spec_verify`` spans, each labelled with the
        attention mode."""
        eng = self.engine
        k = self._spec
        active = np.zeros((eng.slots,), bool)
        budget = np.ones((eng.slots,), np.int32)
        eos = np.full((eng.slots,), -1, np.int32)
        for slot, live in self.live.items():
            active[slot] = True
            budget[slot] = live.remaining_new()
            if live.req.eos_id is not None:
                eos[slot] = live.req.eos_id
        if self._paged:
            # Every page the verify span [fill, fill + k] can write must
            # be the slot's own before the step: the plain tick's COW
            # probe, once a page in the span (writes past the mapped
            # pages are dropped, so the span stops at the last one).
            ps = eng.page_size
            caps = eng.allocator.mapped_tokens()
            for slot, live in self.live.items():
                fill = live.cache_fill()
                last_pos = min(fill + k, int(caps[slot]) - 1)
                for page_idx in range(fill // ps, last_pos // ps + 1):
                    pair = eng.allocator.cow_before_write(slot, max(fill, page_idx * ps))
                    if pair is not None:
                        eng.copy_page(*pair)
                        obs.counter("kv_cow_copies")
                        if self._ledger is not None:
                            self._ledger.event(live.req.rid, "cow_copy", tick=self.tick,
                                               src=pair[0], dst=pair[1], phase="spec")
        n_live = int(active.sum())
        rids = [live.req.rid for live in self.live.values()]
        labels = dict(active=n_live, attention=self._attn_mode, sampler=self._sampler,
                      rids=rids, **self._kv_attrs)
        t0 = time.perf_counter()
        with obs.span("decode", spec_k=k, **labels):
            with obs.span("spec_draft", **labels):
                eng.spec_draft(active, self._temp, self._topk)
            t1 = time.perf_counter()
            with obs.span("spec_verify", **labels):
                emit, n_emit, n_acc = eng.spec_verify(
                    active, self._temp, self._topk, budget, eos
                )
        now = time.perf_counter()
        if self.sentinel is not None:
            self.sentinel.observe_phases(self.tick, decode=now - t0)
        emitted = int(n_emit.sum())
        accepted = int(n_acc.sum())
        obs.counter("serve_tokens", float(emitted))
        obs.counter("spec_drafted_tokens", float(k * n_live))
        obs.counter("spec_accepted_tokens", float(accepted))
        self._spec_emitted += emitted
        self._spec_active_ticks += n_live
        self._spec_drafted += k * n_live
        self._spec_accepted += accepted
        if self.stream is not None:
            self.stream.inc("serve_tokens", float(emitted))
            self.stream.observe("decode_tick", now - t0)
            self.stream.observe("spec_draft_tick", t1 - t0)
            self.stream.observe("spec_verify_tick", now - t1)
            if n_live:
                self.stream.observe("accepted_tokens_per_tick", emitted / n_live)
                self.stream.observe("draft_acceptance_rate", accepted / (k * n_live))
        lens = np.asarray([live.cache_fill() for live in self.live.values()])
        if self._attn_mode == "kernel":
            # The plain tick's tile accounting at the verify's T = k + 1.
            bk = eng.decode_block_k
            total = eng.max_len // bk
            visited = num_kv_blocks(lens, k + 1, eng.max_len, bk)
            n_free = eng.slots - lens.size
            obs.counter(
                "decode_blocks_skipped",
                float(total * eng.slots - int(visited.sum()) - n_free),
            )
        # The verify's modeled bytes over the verify's own wall (the
        # draft's time would depress the rate on a healthy engine).
        self._feed_roofline("spec_verify", lens, k + 1, now - t1)
        if self._ledger is not None:
            # Per slot: a slow request's rollback streak shows only here.
            for slot, live in self.live.items():
                self._ledger.event(
                    live.req.rid, "spec_tick", tick=self.tick, dur_s=now - t0, drafted=k,
                    t=now, accepted=int(n_acc[slot]), emitted=int(n_emit[slot]),
                )
        for slot in list(self.live):
            n = int(n_emit[slot])
            live = self.live[slot]
            live.tokens.extend(int(t) for t in emit[slot, :n])
            live.last_touch = self.tick
            if live.resume_mode == "restream":
                self._finish_restream(slot, live, now)
            self._maybe_retire(slot, now)

    def _decode_tick(self) -> None:
        if self._spec:
            self._spec_tick()
            return
        active = np.zeros((self.engine.slots,), bool)
        for slot in self.live:
            active[slot] = True
        if self._paged:
            # This tick appends one row per live slot at its fill; a fill
            # still in a shared page (full-prompt prefix reuse of a
            # partial last page) copies the page out first. Later ticks
            # find it private.
            for slot, live in self.live.items():
                pair = self.engine.allocator.cow_before_write(
                    slot, live.cache_fill()
                )
                if pair is not None:
                    self.engine.copy_page(*pair)
                    obs.counter("kv_cow_copies")
                    if self._ledger is not None:
                        self._ledger.event(live.req.rid, "cow_copy", tick=self.tick,
                                           src=pair[0], dst=pair[1], phase="decode")
        t0 = time.perf_counter()
        with obs.span(
            "decode", active=int(active.sum()), attention=self._attn_mode,
            sampler=self._sampler,
            rids=[live.req.rid for live in self.live.values()],
            **self._kv_attrs,
        ):
            toks = self.engine.decode(active, self._temp, self._topk)
        now = time.perf_counter()
        if self.sentinel is not None:
            self.sentinel.observe_phases(self.tick, decode=now - t0)
        obs.counter("serve_tokens", float(active.sum()))
        if self.stream is not None:
            self.stream.inc("serve_tokens", float(active.sum()))
            self.stream.observe("decode_tick", now - t0)
        if self._ledger is not None:
            # Tick membership: the tick's wall is every resident
            # request's latency cost.
            n_live = int(active.sum())
            for live in self.live.values():
                self._ledger.event(live.req.rid, "decode_tick", tick=self.tick,
                                   dur_s=now - t0, active=n_live, t=now)
        lens = np.asarray([live.cache_fill() for live in self.live.values()])
        if self._attn_mode == "kernel":
            # Cache tiles the length-aware kernel skipped this tick, by
            # the kernel's own bound (num_kv_blocks). Free slots run
            # with length 0 and visit one tile each.
            bk = self.engine.decode_block_k
            total = self.engine.max_len // bk
            visited = num_kv_blocks(lens, 1, self.engine.max_len, bk)
            n_free = self.engine.slots - lens.size
            obs.counter(
                "decode_blocks_skipped",
                float(total * self.engine.slots - int(visited.sum()) - n_free),
            )
        self._feed_roofline("decode", lens, 1, now - t0)
        for slot in list(self.live):
            live = self.live[slot]
            live.tokens.append(int(toks[slot]))
            live.last_touch = self.tick
            if live.resume_mode == "restream":
                self._finish_restream(slot, live, now)
            self._maybe_retire(slot, now)

    def _feed_roofline(self, phase: str, lens, t_q: int, seconds: float) -> None:
        """The tick's length-aware modeled bytes as explicit work of
        ``phase`` (a kernel engine's only), into the stream windows
        (``decode_hbm_bytes``, and ``decode_flops`` from the registered
        cost) and the utilization watch (GB/s over ``seconds``)."""
        ach = self.engine.decode_achieved_hbm_bytes(lens, t_q=t_q)
        if ach is None:
            return
        self._decode_hbm_bytes += ach
        obs.roofline.work(phase, hbm_bytes=ach)
        if self.stream is not None:
            self.stream.inc("decode_hbm_bytes", ach)
            flops = (self.engine.roofline_costs or {}).get(phase, {}).get("flops", 0.0)
            if flops:
                self.stream.inc("decode_flops", flops)
        if self._util_watch is not None and seconds > 0:
            self._util_watch.observe("decode_hbm_gbps", self.tick, ach / seconds / 1e9)

    def _pending(self) -> bool:
        """Work outstanding: queued (FIFO or the policy's tiers),
        mid-prefill (paged) or live."""
        return bool(self._qdepth() or self.prefilling or self.live)

    def _kv_gauges(self) -> None:
        """Cache-memory gauges: ``kv_tokens_cached`` (live fills plus
        prefill progress) and, paged, pool occupancy and shared pages;
        in the recorder and the stream windows."""
        kv_tokens = float(
            sum(live.cache_fill() for live in self.live.values())
            + sum(live.base for live in self.prefilling.values())
        )
        gauges = {"kv_tokens_cached": kv_tokens}
        if self._paged:
            alloc = self.engine.allocator
            occ = alloc.occupancy
            shared = alloc.pages_shared
            self._kv_occ_sum += occ
            self._kv_occ_peak = max(self._kv_occ_peak, occ)
            self._pages_shared_peak = max(self._pages_shared_peak, shared)
            gauges.update(kv_pool_occupancy=occ, prefix_pages_shared=float(shared))
            if self._host_tier:
                in_use = alloc.host_pages_in_use
                self._host_in_use_peak = max(self._host_in_use_peak, in_use)
                gauges["kv_host_pages_in_use"] = float(in_use)
        gauges.update(self._memory_gauges(kv_tokens))
        for name, val in gauges.items():
            obs.gauge(name, val)
            if self.stream is not None:
                self.stream.set_gauge(name, val)

    def _memory_gauges(self, kv_tokens: float) -> dict:
        """Held bytes, the KV subsystem's held bytes and headroom and, on
        the pool, fragmentation (granted page rows no cached token
        fills); the run's peak held and least headroom are kept here,
        once a tick."""
        ml = self._memledger
        held = ml.held()
        self._held_peak = max(self._held_peak, int(held))
        head = self._kv_headroom()
        gauges = {"hbm_held_bytes": float(held)}
        if self._host_tier:
            host_held = int(ml.held("kv_host_pages"))
            self._host_held_peak = max(self._host_held_peak, host_held)
            gauges["host_held_bytes"] = float(host_held)
        sub = "kv_pages" if self._paged else "kv_slots"
        kv_held = ml.held(sub) + (ml.held("kv_cow_reserve") if self._paged else 0.0)
        gauges["kv_held_bytes"] = float(kv_held)
        if "kv_headroom_pct" in head:
            pct = head["kv_headroom_pct"]
            self._headroom_min_pct = (
                pct if self._headroom_min_pct is None else min(self._headroom_min_pct, pct)
            )
            gauges["kv_headroom_pct"] = pct
        if self._paged:
            granted = self.engine.allocator.pages_in_use * self.engine.page_size
            gauges["kv_frag_pct"] = (
                round(100.0 * (1.0 - kv_tokens / granted), 2) if granted else 0.0
            )
        return gauges

    def _kv_headroom(self) -> dict:
        """The KV capacity an admission verdict has right now: free
        grantable pages (the COW reserve is promised) or free slots, as
        bytes and percent, beside the total held."""
        ml = self._memledger
        sub = "kv_pages" if self._paged else "kv_slots"
        cap = ml.capacity(sub)
        if not cap:
            return {}
        held = ml.held(sub) + (ml.held("kv_cow_reserve") if self._paged else 0.0)
        headroom = cap - held
        return {
            "kv_headroom_bytes": int(headroom),
            "kv_headroom_pct": round(100.0 * headroom / cap, 2),
            "hbm_held_bytes": int(ml.held()),
        }

    def _exhaustion_dump(self) -> dict:
        """The ranked holders at a pool-exhaustion edge: each request's
        exclusive bytes (what evicting it returns), the tenants' totals,
        the COW reserve, the prefix index's health, the host tier's
        state and the ledger's decomposition."""
        alloc = self.engine.allocator
        pb = self.engine.page_bytes
        holders = []
        for slot, live in list(self.live.items()) + list(self.prefilling.items()):
            owned, shared = alloc.slot_page_stats(slot)
            holders.append({
                "rid": live.req.rid,
                "tenant": live.req.tenant or "",
                "bytes": int(owned * pb),
                "shared_pages": shared,
                "last_touch_tick": live.last_touch,
            })
        holders.sort(key=lambda e: (-e["bytes"], str(e["rid"])))
        tenants: dict[str, int] = {}
        for h in holders:
            tenants[h["tenant"]] = tenants.get(h["tenant"], 0) + h["bytes"]
        sole, dead = self._prefix_entry_counts()
        out = {
            "tick": self.tick,
            "free_pages": alloc.free_pages,
            "queued": self._qdepth(),
            "top_holders": holders[:8],
            "tenants": dict(sorted(tenants.items(), key=lambda kv: -kv[1])),
            "cow_reserve_bytes": int(alloc.reserved * pb),
            "sole_reader_prefix_entries": sole,
            "dead_prefix_entries": dead,  # 0 by construction; a leak shows here
        }
        if self._host_tier:
            out["host_free_pages"] = len(alloc.host_free)
            out["host_pages"] = alloc.host_pages
            out["host_parked_records"] = len(alloc._parked)
            out["host_resident_entries"] = alloc.host_resident_entries
        out["tier_pressure"] = (
            "both_tiers" if self._host_tier and not alloc.host_free else "hbm_only"
        )
        out["subsystems"] = self._memledger.decompose()
        out.update(self._kv_headroom())
        return out

    def _prefix_entry_counts(self) -> tuple[int, int]:
        """(sole-reader, dead) pool prefix entries: every page at refcount
        1 (retiring one slot reclaims them), or one at refcount 0 (never,
        by construction). Host entries name host seats and are skipped."""
        alloc = self.engine.allocator
        sole = dead = 0
        for entry in alloc._index.values():
            if entry.tier != "hbm":
                continue
            refs = [int(alloc.refcount[p]) for p in entry.pages]
            if any(r == 0 for r in refs):
                dead += 1
            elif all(r == 1 for r in refs):
                sole += 1
        return sole, dead

    def _run_tick(self) -> None:
        """One loop iteration: land last tick's spills, admit, prefill
        chunk (paged), gauges, decode."""
        if self._host_tier:
            # The spills dispatched last tick copied under its decode;
            # waiting here costs what is left of them.
            self.engine.drain_spills()
        self._admit()
        if self._paged:
            self._prefill_chunk_tick()
        busy = len(self.live) + len(self.prefilling)
        self._concurrency_peak = max(self._concurrency_peak, busy)
        occupancy = busy / self.engine.slots
        self._occupancy_sum += occupancy
        obs.gauge("slot_occupancy", occupancy)
        if self.stream is not None:
            self.stream.set_gauge("slot_occupancy", occupancy)
            self.stream.set_gauge("queue_depth", float(self._qdepth()))
        if self.policy is not None:
            # One backlog gauge per tier the run has seen, zeros
            # included, so an emptied tier reads 0.
            for tier, depth in self.policy.tier_depths().items():
                obs.gauge(f"queue_depth_tier{tier}", float(depth))
                if self.stream is not None:
                    self.stream.set_gauge(f"queue_depth_tier{tier}", float(depth))
        self._kv_gauges()
        if self.live:
            self._decode_tick()
        if self.slo is not None:
            transitions = self.slo.evaluate(tick=self.tick)
            if self._ledger is not None and self.slo.sentinel is None:
                # Without a sentinel the monitor's transitions pin the
                # in-flight set here (with one, its note chain did).
                for tr in transitions:
                    if tr.get("event") == "slo_breach":
                        self._ledger.pin_inflight("slo_breach", step=self.tick)
        self.tick += 1

    def run(self, *, max_ticks: int = 1_000_000) -> list[Completed]:
        """Drive admit/decode until everything submitted has completed,
        then return ALL completions so far, in finish order. Hitting
        ``max_ticks`` with work still queued or live sets the
        ``truncated`` flag that :meth:`stats` reports."""
        self._truncated = False
        while self._pending() and self.tick < max_ticks:
            self._run_tick()
        if self._pending():
            self._truncated = True
        if self.slo is not None:
            self.slo.finish()
        return self.completed

    def run_timed(
        self,
        arrivals,
        *,
        duration: float | None = None,
        drain: bool = True,
        max_ticks: int = 1_000_000,
        on_tick=None,
    ) -> list[Completed]:
        """Open-loop drive: submit each
        :class:`~mpit_tpu_torch.serve.loadgen.Arrival` when its clock
        (seconds from the call) comes due, tick the engine in between,
        and stop admitting at ``duration`` seconds (``None``: when the
        trace runs out).

        ``drain=True`` keeps ticking past the window until queued and
        live work finishes, so every admitted request is answered.
        ``drain=False`` stops at the window's end: past saturation a
        drain would never return, and what completed inside the window
        is the result (``stats()`` reports ``truncated``).
        ``on_tick(server, now_s)`` is called once a loop iteration (the
        CLI's live line). While nothing is pending the loop sleeps to the
        next arrival, at most 50 ms at a time. Sheds are counted, not
        raised."""
        arrivals = sorted(arrivals, key=lambda a: a.t)
        self._truncated = False
        t0 = time.perf_counter()
        i = 0
        end_t = math.inf if duration is None else duration
        while self.tick < max_ticks:
            now = time.perf_counter() - t0
            while i < len(arrivals) and arrivals[i].t <= min(now, end_t):
                self.submit(arrivals[i].request)
                i += 1
            pending_arrivals = i < len(arrivals) and arrivals[i].t < end_t
            if now >= end_t and not (drain and self._pending()):
                break
            if not pending_arrivals and not self._pending():
                if now >= end_t or i >= len(arrivals):
                    break  # the trace is spent and everything answered
            if not self._pending():
                wake = arrivals[i].t if pending_arrivals else end_t
                delay = min(wake - now, 0.05)
                if delay > 0:
                    time.sleep(delay)
                # An idle stretch still advances SLO time: a breach does
                # not end because traffic paused.
                if self.slo is not None:
                    self.slo.evaluate(tick=self.tick)
                if on_tick is not None:
                    on_tick(self, now)
                continue
            self._run_tick()
            if on_tick is not None:
                on_tick(self, time.perf_counter() - t0)
        if self._pending():
            self._truncated = True
        if self.slo is not None:
            # Work admitted or shed after the last evaluation still gets
            # a verdict.
            self.slo.evaluate(tick=self.tick)
            self.slo.finish()
        return self.completed

    # -- reporting ----------------------------------------------------------
    def _tenant_rollup(self) -> dict:
        """Per-tenant completions, sheds and, with a stream registry, the
        whole run's p95 TTFT. Empty when no request carried a tenant."""
        out: dict[str, dict] = {}
        for c in self.completed:
            if c.tenant:
                out.setdefault(c.tenant, {"completed": 0, "shed": 0})["completed"] += 1
        for r in self.shed:
            if r.tenant:
                out.setdefault(r.tenant, {"completed": 0, "shed": 0})["shed"] += 1
        if self.stream is not None:
            for t, e in out.items():
                sk = self.stream.total_sketch(f"request_ttft_tenant:{t}")
                if sk is not None and sk.count:
                    e["ttft_p95_s"] = round(sk.quantile(0.95), 6)
        return dict(sorted(out.items()))

    def _eviction_candidates(self, cap: int = 16) -> list:
        """What an eviction policy should reclaim first, coldest first by
        last-touch tick: ``parked_victim`` (a preempted request in the
        policy's queue: the bytes its re-admission will claim),
        ``idle_tail`` (a live slot's exclusive bytes: it decodes every
        tick, so it ranks hottest), ``sole_reader_prefix`` (a pool prefix
        entry no one shares, nested entries deduped to the longest) and
        ``host_prefix`` (an entry on the host tier). Each names its
        ``tier``."""
        pb = self.engine.page_bytes
        out = []
        if self.policy is not None and pb:
            alloc = self.engine.allocator
            parked = getattr(alloc, "_parked", {})
            for st in self.policy._tiers.values():
                for q in st.queues.values():
                    for live in q:
                        if live.feed is None:
                            continue  # a fresh submission holds nothing yet
                        pages = alloc.pages_for(len(live.feed), live.remaining_new())
                        out.append({
                            "kind": "parked_victim",
                            "rid": live.req.rid,
                            "tenant": live.req.tenant or "",
                            "bytes": int(pages * pb),
                            "last_touch_tick": live.park_tick,
                            "tier": "host" if live.req.rid in parked else "none",
                        })
        if self._paged and pb:
            alloc = self.engine.allocator
            for slot, live in self.live.items():
                owned, _ = alloc.slot_page_stats(slot)
                out.append({
                    "kind": "idle_tail",
                    "rid": live.req.rid,
                    "tenant": live.req.tenant or "",
                    "bytes": int(owned * pb),
                    "last_touch_tick": live.last_touch,
                    "tier": "hbm",
                })
            for tier, kind in (("hbm", "sole_reader_prefix"), ("host", "host_prefix")):
                best: dict[int, tuple] = {}
                for key, entry in alloc._index.items():
                    if entry.tier != tier or not entry.pages:
                        continue
                    if tier == "hbm" and any(int(alloc.refcount[p]) != 1 for p in entry.pages):
                        continue
                    first = entry.pages[0]
                    if first not in best or key[0] > best[first][0][0]:
                        best[first] = (key, entry)
                for key, entry in best.values():
                    out.append({
                        "kind": kind,
                        "key": f"prefix[{key[0]}t]",
                        "bytes": int(len(entry.pages) * pb),
                        "last_touch_tick": alloc._prefix_touch.get(key, 0),
                        "tier": tier,
                    })
        elif not self._paged and self.engine.slot_bytes:
            for live in self.live.values():
                out.append({
                    "kind": "idle_tail",
                    "rid": live.req.rid,
                    "tenant": live.req.tenant or "",
                    "bytes": int(self.engine.slot_bytes),
                    "last_touch_tick": live.last_touch,
                    "tier": "hbm",
                })
        out.sort(key=lambda c: (c["last_touch_tick"], str(c.get("rid", c.get("key", "")))))
        return out[:cap]

    def _memory_stats(self) -> dict:
        """``stats()["memory"]``: the ledger's held decomposition and its
        conservation verdict, the KV capacity and headroom (now and the
        run's least), the host tier's bytes, per-request and per-tenant
        bytes from the allocator's own state, the eviction ranking, the
        last exhaustion and, on the card, the reconciliation with
        ``torch.cuda.memory_allocated`` (less what the process held
        before the engine). ``source: memledger`` is what ``obs
        capacity`` looks for."""
        ml = self._memledger
        out = {
            "source": "memledger",
            "worker_id": self.worker_id,
            "role": self.role,
            "platform": ml.platform,
            "held_bytes": int(ml.held()),
            "held_peak_bytes": int(max(self._held_peak, int(ml.held()))),
            "held_by_subsystem": ml.decompose(),
            "conservation": ml.conservation(),
        }
        sub = "kv_pages" if self._paged else "kv_slots"
        cap = ml.capacity(sub)
        if cap:
            out["kv_capacity_bytes"] = int(cap)
            out.update(self._kv_headroom())
            out.pop("hbm_held_bytes", None)  # held_bytes says it
        if self._headroom_min_pct is not None:
            out["kv_headroom_min_pct"] = self._headroom_min_pct
        eng = self.engine
        if self._host_tier:
            held = int(ml.held("kv_host_pages"))
            self._host_held_peak = max(self._host_held_peak, held)
            out["host_held_bytes"] = held
            out["host_held_peak_bytes"] = int(self._host_held_peak)
            out["host_capacity_bytes"] = int(ml.capacity("kv_host_pages") or 0)
            out["spill_bytes_total"] = int(eng.host_spill_bytes)
            out["restream_bytes"] = int(eng.host_restream_bytes)
        per_req: dict[str, dict] = {}
        if self._paged and eng.page_bytes:
            alloc = eng.allocator
            for slot, live in list(self.live.items()) + list(self.prefilling.items()):
                owned, shared = alloc.slot_page_stats(slot)
                per_req[str(live.req.rid)] = {
                    "bytes": int(owned * eng.page_bytes),
                    "shared_pages": shared,
                    "tenant": live.req.tenant or "",
                }
            out["shared_bytes"] = int(int((alloc.refcount >= 2).sum()) * eng.page_bytes)
        elif not self._paged and eng.slot_bytes:
            for live in self.live.values():
                per_req[str(live.req.rid)] = {
                    "bytes": int(eng.slot_bytes), "shared_pages": 0,
                    "tenant": live.req.tenant or "",
                }
        per_tenant: dict[str, int] = {}
        for e in per_req.values():
            per_tenant[e["tenant"]] = per_tenant.get(e["tenant"], 0) + e["bytes"]
        if per_req:
            out["per_request"] = dict(sorted(per_req.items(), key=lambda kv: -kv[1]["bytes"]))
            out["per_tenant"] = dict(sorted(per_tenant.items(), key=lambda kv: -kv[1]))
        ev = self._eviction_candidates()
        if ev:
            out["eviction_candidates"] = ev
        out["reconciliation"] = ml.reconcile(
            eng.device if eng.platform == "cuda" else None,
            baseline_bytes=eng.device_bytes_before,
        )
        snap = ml.snapshot()
        if "exhaustion" in snap:
            out["exhaustion"] = snap["exhaustion"]
            out["exhaustions"] = snap["exhaustions"]
        return out

    def _roofline(self) -> dict:
        """The installed recorder's roofline roll-up ({} without
        registered costs)."""
        rec = obs.get_recorder()
        if rec is None or not rec.costs:
            return {}
        return rec.summary().get("roofline", {})

    def stats(self) -> dict:
        """Host-side serving roll-up (the obs summary carries the
        span-derived histograms; this is the request-math view)."""
        done = self.completed
        out = {
            "worker_id": self.worker_id,
            "role": self.role,
            "requests_completed": len(done),
            "ticks": self.tick,
            "admissions": self.admissions,
            "generated_tokens": sum(len(c.tokens) for c in done),
            "occupancy_mean": round(
                self._occupancy_sum / max(self.tick, 1), 4
            ),
            "truncated": self._truncated,
            "concurrency_peak": self._concurrency_peak,
            "kv_dtype": self.engine.kv_dtype,
            "weights_dtype": self.engine.weights_dtype,
            # Kernel-library builds inside engine calls (on the card, 0
            # after warm-up: the engine builds its kernels at construction).
            "engine_compiles": self.engine.compile_watch.compiles,
        }
        if self._decode_hbm_bytes:
            out["decode_hbm_bytes_modeled"] = round(self._decode_hbm_bytes, 1)
        if self._spec:
            # Tokens emitted per slot-tick (1.0 = plain decode) and the
            # fraction of drafted tokens the target kept.
            out["spec_k"] = self._spec
            out["spec_drafted_tokens"] = self._spec_drafted
            out["spec_accepted_tokens"] = self._spec_accepted
            if self._spec_active_ticks:
                out["accepted_tokens_per_tick"] = round(
                    self._spec_emitted / self._spec_active_ticks, 4
                )
                out["draft_acceptance_rate"] = round(
                    self._spec_accepted / max(self._spec_drafted, 1), 4
                )
        if self._paged:
            alloc = self.engine.allocator
            out.update(
                kv_page_size=alloc.page_size,
                kv_pool_pages=alloc.num_pages,
                kv_pool_occupancy_mean=round(
                    self._kv_occ_sum / max(self.tick, 1), 4
                ),
                kv_pool_occupancy_peak=round(self._kv_occ_peak, 4),
                prefix_hit_rate=round(alloc.hit_rate, 4),
                prefix_hits=alloc.prefix_hits,
                prefix_pages_shared_peak=self._pages_shared_peak,
                kv_cow_copies=alloc.cow_copies,
            )
            if self._host_tier:
                eng = self.engine
                out.update(
                    kv_host_pages=alloc.host_pages,
                    kv_host_pages_in_use=alloc.host_pages_in_use,
                    host_spilled_pages=eng.host_spilled_pages,
                    host_restreamed_pages=eng.host_restreamed_pages,
                    host_spill_bytes=eng.host_spill_bytes,
                    host_restream_bytes=eng.host_restream_bytes,
                    host_held_peak_bytes=max(self._host_in_use_peak,
                                             alloc.host_pages_in_use) * eng.page_bytes,
                    host_prefix_hits=alloc.host_prefix_hits,
                    parked_spills=alloc.parked_spills,
                    spilled_prefix_entries=alloc.spilled_prefix_entries,
                    promoted_entries=alloc.promoted_entries,
                )
            # Resume p95s by mode, for every paged server: an untiered
            # run gives the recompute figure a tiered one's restream
            # figure is held against.
            for mode, durs in sorted(self.resume_durations.items()):
                if durs:
                    out[f"resume_{mode}_p95_s"] = round(
                        float(np.percentile(np.asarray(durs), 95)), 6
                    )
        if self.shed:
            # The total and the two causes apart, zeros included.
            out["requests_shed"] = {
                "total": len(self.shed),
                "shed_queue_full": self.shed_causes.get("queue_full", 0),
                "shed_admission_projection": self.shed_causes.get("admission", 0),
            }
        out["shed"] = len(self.shed)
        out["shed_causes"] = dict(sorted(self.shed_causes.items()))
        if self.policy is not None:
            pol = self.policy.stats()
            out["preemptions"] = pol["preemptions"]
            out["policy"] = pol
        if self._ledger is not None:
            # The retained tail exemplars, worst first, and the ledger's
            # aggregate view (what why-slow reads).
            out["exemplars"] = self._ledger.exemplars()
            out["ledger"] = self._ledger.stats()
        tenants = self._tenant_rollup()
        if tenants:
            out["tenants"] = tenants
        out["memory"] = self._memory_stats()
        roof = self._roofline()
        if roof:
            out["roofline"] = roof
        if self.slo is not None:
            out["slo"] = self.slo.report()
        if self.sentinel is not None:
            out["sentinel"] = self.sentinel.report()
        if done:
            lat = np.asarray([c.latency_s for c in done])
            ttft = np.asarray([c.ttft_s for c in done])
            out.update(
                latency_p50_s=round(float(np.percentile(lat, 50)), 6),
                latency_p95_s=round(float(np.percentile(lat, 95)), 6),
                ttft_p50_s=round(float(np.percentile(ttft, 50)), 6),
                ttft_p95_s=round(float(np.percentile(ttft, 95)), 6),
            )
        return out
