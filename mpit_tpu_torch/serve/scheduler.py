"""Continuous batching: the request loop over the slot-batched engine.

Requests queue on the host and are admitted into free KV-cache slots
between decode ticks (a new request rides the next prefill while the
others keep decoding); each slot retires on EOS, max-new-tokens or a
full cache, and its slot goes to the next queued request at once.
FIFO order, closed loop: :meth:`Server.run` drains everything submitted.

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
  ``kv_pool_exhausted`` instant when admission starts waiting on pages.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any

import numpy as np

from mpit_tpu_torch import obs
from mpit_tpu_torch.ops.decode_attention import num_kv_blocks

__all__ = ["Completed", "Request", "Server", "warm_engine"]


def warm_engine(engine) -> None:
    """Run one throwaway request through ``engine`` (spanned
    ``warmup``), then reset it: the first launches' one-off costs land
    outside a timed window."""
    with obs.span("warmup"):
        warm = Server(engine)
        warm.submit(Request(rid="warm", prompt=[1, 2, 3], max_new_tokens=2))
        warm.run()
    engine.reset()


@dataclasses.dataclass
class Request:
    """One generation request. ``temperature <= 0`` = greedy;
    ``top_k = 0`` = full vocabulary; ``eos_id = None`` = never stop
    early."""

    rid: Any
    prompt: list[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    eos_id: int | None = None


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

    def remaining_new(self) -> int:
        """Output tokens still owed: a speculative tick's budget."""
        return self.req.max_new_tokens - len(self.tokens)

    def feed_tokens(self) -> list:
        """What prefill feeds the device: the prompt."""
        return self.req.prompt

    def cache_fill(self) -> int:
        """Host mirror of the slot's device cache fill. Prefill cached
        the prompt; each decode tick appends ONE token; the newest
        sampled token is not written yet — so the fill is ``prompt +
        generated - 1``, and the next decode append lands exactly here."""
        return len(self.req.prompt) + len(self.tokens) - 1


class Server:
    """The continuous-batching loop around one
    :class:`~mpit_tpu_torch.serve.Engine`.

    Host-side only: slot bookkeeping, the FIFO queue, retirement and
    telemetry. ``submit()`` enqueues; ``run()`` drives admit/decode
    ticks until the queue and all slots drain (or ``max_ticks``).
    """

    def __init__(self, engine):
        self.engine = engine
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
        # Speculative decoding: k drafted tokens a tick, and the roll-up
        # stats() reports (tokens emitted per slot-tick, acceptance).
        self._spec = int(getattr(engine, "spec_k", 0) or 0)
        self._spec_emitted = 0
        self._spec_active_ticks = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        self.queue: deque[_Live] = deque()
        self.live: dict[int, _Live] = {}  # slot -> in-flight request
        # Paged: slots whose prompt is still being written, one chunk
        # per tick.
        self.prefilling: dict[int, _Live] = {}
        self.free: list[int] = list(range(engine.slots))[::-1]  # pop() = slot 0 first
        self.completed: list[Completed] = []
        self.tick = 0
        self.admissions = 0
        self._occupancy_sum = 0.0
        self._concurrency_peak = 0
        self._truncated = False  # a run stopped with work still pending
        self._pool_exhausted = False  # edge trigger of the obs instant
        self._kv_occ_sum = 0.0
        self._kv_occ_peak = 0.0
        self._pages_shared_peak = 0
        # Per-slot sampling-control arrays (host; refreshed on admit/retire).
        s = engine.slots
        self._temp = np.zeros((s,), np.float32)
        self._topk = np.zeros((s,), np.int32)

    # -- intake -------------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Enqueue one request; malformed requests raise."""
        if not req.prompt:
            raise ValueError(f"request {req.rid!r}: empty prompt")
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
        self.queue.append(_Live(req, time.perf_counter()))

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
        """Grant the FIFO head a free slot and its whole page requirement
        (all or nothing, in the allocator), or stop: stopping at the
        first request that does not fit keeps admission fair, so a
        stream of small requests cannot starve a big one."""
        alloc = self.engine.allocator
        now = time.perf_counter()
        while self.free and self.queue:
            live = self.queue[0]
            slot = self.free[-1]
            feed = live.feed_tokens()
            plan = alloc.admit(slot, feed, live.req.max_new_tokens)
            if plan is None:
                # The pool is full right now; nothing was taken. The
                # instant marks only the transition into exhaustion, so
                # a long overload writes one event, not one per tick.
                if not self._pool_exhausted:
                    self._pool_exhausted = True
                    obs.instant(
                        "kv_pool_exhausted", tick=self.tick,
                        free_pages=alloc.free_pages, queued=len(self.queue),
                    )
                break
            self.queue.popleft()
            self.free.pop()
            self._pool_exhausted = False
            # The write floor is the shared-token count; the forward
            # re-runs at least the last prompt token (its output seeds
            # the first output token), so the feed base stops one below
            # the end even on a full-prompt prefix hit.
            live.floor = plan.shared_tokens
            live.base = min(plan.shared_tokens, len(feed) - 1)
            self._temp[slot] = live.req.temperature
            self._topk[slot] = live.req.top_k
            obs.span_at("queue_wait", live.submit_t, now, rid=live.req.rid)
            self.prefilling[slot] = live
            self.admissions += 1

    def _prefill_chunk_tick(self) -> None:
        """Advance every prefilling slot by one prompt chunk, in one
        batched call. Slots whose last prompt token rides this chunk
        sample their first output token, register their prompt in the
        prefix index (only now: an entry must never advertise K/V not
        yet on the device) and go live."""
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
        for slot, live in self.prefilling.items():
            live.base += int(chunk_lens[slot])
        for slot, live in finishing:
            del self.prefilling[slot]
            alloc.register_prefix(slot, live.feed_tokens())
            live.first_token_t = t_first
            live.tokens = [int(first[slot])]
            obs.span_at(
                "request_ttft", live.submit_t, t_first, rid=live.req.rid
            )
            self.live[slot] = live
            self._maybe_retire(slot, t_first)

    def _admit_dense(self) -> None:
        """Move queued requests into free slots and prefill them, in one
        batched call however many were admitted this tick."""
        if not self.queue or not self.free:
            return
        s, plen = self.engine.slots, self.engine.prefill_len
        tokens = np.zeros((s, plen), np.int32)
        lens = np.ones((s,), np.int32)
        admit = np.zeros((s,), bool)
        batch: list[tuple[int, _Live]] = []
        now = time.perf_counter()
        while self.free and self.queue:
            live = self.queue.popleft()
            slot = self.free.pop()
            p = live.req.prompt
            tokens[slot, : len(p)] = p
            lens[slot] = len(p)
            admit[slot] = True
            self._temp[slot] = live.req.temperature
            self._topk[slot] = live.req.top_k
            obs.span_at("queue_wait", live.submit_t, now, rid=live.req.rid)
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
        for slot, live in batch:
            live.first_token_t = t_first
            live.tokens = [int(first[slot])]
            obs.span_at(
                "request_ttft", live.submit_t, t_first, rid=live.req.rid
            )
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
            # entries citing them die.
            self.engine.allocator.free_slot(slot)
        self.free.append(slot)
        self._temp[slot] = 0.0
        self._topk[slot] = 0
        obs.span_at("request_latency", live.submit_t, now, rid=req.rid)
        obs.counter("serve_requests")
        truncated = (
            full and tok != req.eos_id and len(live.tokens) < req.max_new_tokens
        )
        self.completed.append(
            Completed(
                rid=req.rid,
                prompt=list(req.prompt),
                tokens=list(live.tokens),
                submit_t=live.submit_t,
                first_token_t=live.first_token_t,
                finish_t=now,
                truncated=truncated,
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
        n_live = int(active.sum())
        rids = [live.req.rid for live in self.live.values()]
        labels = dict(active=n_live, attention=self._attn_mode, sampler=self._sampler,
                      rids=rids, **self._kv_attrs)
        with obs.span("decode", spec_k=k, **labels):
            with obs.span("spec_draft", **labels):
                eng.spec_draft(active, self._temp, self._topk)
            with obs.span("spec_verify", **labels):
                emit, n_emit, n_acc = eng.spec_verify(
                    active, self._temp, self._topk, budget, eos
                )
        now = time.perf_counter()
        emitted = int(n_emit.sum())
        accepted = int(n_acc.sum())
        obs.counter("serve_tokens", float(emitted))
        obs.counter("spec_drafted_tokens", float(k * n_live))
        obs.counter("spec_accepted_tokens", float(accepted))
        self._spec_emitted += emitted
        self._spec_active_ticks += n_live
        self._spec_drafted += k * n_live
        self._spec_accepted += accepted
        if self._attn_mode == "kernel":
            # The plain tick's tile accounting at the verify's T = k + 1.
            lens = np.asarray([live.cache_fill() for live in self.live.values()])
            bk = eng.decode_block_k
            total = eng.max_len // bk
            visited = num_kv_blocks(lens, k + 1, eng.max_len, bk)
            n_free = eng.slots - lens.size
            obs.counter(
                "decode_blocks_skipped",
                float(total * eng.slots - int(visited.sum()) - n_free),
            )
        for slot in list(self.live):
            n = int(n_emit[slot])
            self.live[slot].tokens.extend(int(t) for t in emit[slot, :n])
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
        with obs.span(
            "decode", active=int(active.sum()), attention=self._attn_mode,
            sampler=self._sampler,
            rids=[live.req.rid for live in self.live.values()],
            **self._kv_attrs,
        ):
            toks = self.engine.decode(active, self._temp, self._topk)
        now = time.perf_counter()
        obs.counter("serve_tokens", float(active.sum()))
        if self._attn_mode == "kernel":
            # Cache tiles the length-aware kernel skipped this tick, by
            # the kernel's own bound (num_kv_blocks). Free slots run
            # with length 0 and visit one tile each.
            lens = np.asarray([live.cache_fill() for live in self.live.values()])
            bk = self.engine.decode_block_k
            total = self.engine.max_len // bk
            visited = num_kv_blocks(lens, 1, self.engine.max_len, bk)
            n_free = self.engine.slots - lens.size
            obs.counter(
                "decode_blocks_skipped",
                float(total * self.engine.slots - int(visited.sum()) - n_free),
            )
        for slot in list(self.live):
            self.live[slot].tokens.append(int(toks[slot]))
            self._maybe_retire(slot, now)

    def _pending(self) -> bool:
        """Work outstanding: queued, mid-prefill (paged) or live."""
        return bool(self.queue or self.prefilling or self.live)

    def _kv_gauges(self) -> None:
        """Cache-memory gauges: ``kv_tokens_cached`` (live fills plus
        prefill progress) and, paged, pool occupancy and shared pages."""
        obs.gauge(
            "kv_tokens_cached",
            float(
                sum(live.cache_fill() for live in self.live.values())
                + sum(live.base for live in self.prefilling.values())
            ),
        )
        if not self._paged:
            return
        alloc = self.engine.allocator
        occ = alloc.occupancy
        shared = alloc.pages_shared
        self._kv_occ_sum += occ
        self._kv_occ_peak = max(self._kv_occ_peak, occ)
        self._pages_shared_peak = max(self._pages_shared_peak, shared)
        obs.gauge("kv_pool_occupancy", occ)
        obs.gauge("prefix_pages_shared", float(shared))

    def _run_tick(self) -> None:
        """One loop iteration: admit, prefill chunk (paged), gauges,
        decode."""
        self._admit()
        if self._paged:
            self._prefill_chunk_tick()
        busy = len(self.live) + len(self.prefilling)
        self._concurrency_peak = max(self._concurrency_peak, busy)
        occupancy = busy / self.engine.slots
        self._occupancy_sum += occupancy
        obs.gauge("slot_occupancy", occupancy)
        self._kv_gauges()
        if self.live:
            self._decode_tick()
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
        return self.completed

    # -- reporting ----------------------------------------------------------
    def stats(self) -> dict:
        """Host-side serving roll-up (the obs summary carries the
        span-derived histograms; this is the request-math view)."""
        done = self.completed
        out = {
            # A standalone server (fleet workers arrive in a later slice).
            "worker_id": "single",
            "role": "standalone",
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
        }
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
