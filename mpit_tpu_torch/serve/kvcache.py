"""The serving engine's KV cache: dense per-slot buffers, or a paged pool
shared by all slots with its host-side page bookkeeping.

- :class:`KVCache` — ``[layers, slots, max_len, heads, head_dim]`` K/V
  buffers and per-slot fill counts.
- :class:`PagedKVCache` — a ``[layers, num_pages + 1, page_size, heads,
  head_dim]`` pool: ``num_pages`` pages the allocator hands out, and one
  trash page past them, where writes that must not land go (see
  :func:`mpit_tpu_torch.models.gpt2.paged_write_index`). Cache memory
  scales with the tokens held, not with ``slots × max_len``, and a page
  named by two block tables is a shared prefix.
- :class:`PageAllocator` — pure host Python and numpy: the free list,
  per-page refcounts, the rolling-hash prefix index, copy-on-write
  reserves and, with ``host_pages``, the host KV tier's seats (parked
  preemption victims and prefix entries migrated off the pool), as in
  :mod:`mpit_tpu.serve.kvcache`; with the engine's memory ledger bound
  (``memledger``, ``page_bytes``) every page leaving or rejoining the
  free list and every copy-on-write reserve is a grant or a free.
  Validity comes from ``lengths`` and the attention mask, never
  from buffer contents, so freed pages are handed out again without
  zeroing.

``quantized=True`` puts a :class:`~mpit_tpu_torch.ops.kv_quant.QuantizedKV`
(int8 rows and their per-(row, head) f32 scales) in each K/V seat of
either cache; every page copy and block-table indirection applies to
both tensors, so the allocator never learns about scales.

``ranks=p`` shards either cache on the head axis for a tensor-parallel
engine (the JAX package's ``cache_specs`` / ``paged_cache_specs``): rank
``r`` holds ``[layers, slots, max_len, heads/p, head_dim]`` (or ``[layers,
num_pages + 1, page_size, heads/p, head_dim]``), its own heads' rows, and
the ranks' shards are stacked on a leading rank dimension. An int8
cache's scales shard on the same head axis. Lengths (and the block
tables) are one for all ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from mpit_tpu_torch.ops.kv_quant import QuantizedKV

__all__ = [
    "AdmitPlan",
    "KVCache",
    "PageAllocator",
    "PagedKVCache",
    "alloc_cache",
    "alloc_paged_cache",
    "pages_needed",
]


def _kv_shape(cfg, lead: tuple, ranks: int) -> tuple:
    """``lead + (heads, head_dim)``, or head-sharded over ``ranks``:
    ``(ranks,) + lead + (heads / ranks, head_dim)``."""
    if not ranks:
        return (cfg.num_layers, *lead, cfg.num_heads, cfg.head_dim)
    if cfg.num_heads % ranks:
        raise ValueError(f"num_heads ({cfg.num_heads}) must divide TP={ranks}")
    return (ranks, cfg.num_layers, *lead, cfg.num_heads // ranks, cfg.head_dim)


def _alloc_kv(shape, dtype, quantized: bool, device):
    """One zeroed K (or V) buffer: a dense tensor, or int8 rows and
    keepdims f32 scales (zero scales dequantize zero rows to zeros).
    Zeroed, not empty: rows a kernel tile reads past a slot's fill are
    masked to weight 0, and ``0 * NaN`` would still poison the sum."""
    if not quantized:
        return torch.zeros(shape, dtype=dtype, device=device)
    return QuantizedKV(
        q=torch.zeros(shape, dtype=torch.int8, device=device),
        scale=torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device),
    )


@dataclasses.dataclass
class KVCache:
    """The engine's decode state: KV buffers + per-slot fill counts.

    ``k``/``v``: ``[num_layers, slots, max_len, heads, head_dim]``, or
    with ``ranks`` ``[ranks, num_layers, slots, max_len, heads / ranks,
    head_dim]``; ``lengths``: ``[slots]`` int32, tokens currently cached
    per slot.
    """

    k: object
    v: object
    lengths: torch.Tensor
    ranks: int = 0  # 0: not head-sharded

    def at(self, idx) -> tuple:
        """The index of slot(s) ``idx`` in ``k``/``v``, every layer (and
        rank) of them."""
        return (slice(None),) * (2 if self.ranks else 1) + (idx,)


def alloc_cache(
    cfg, slots: int, max_len: int, *, device, dtype=None, quantized: bool = False,
    ranks: int = 0,
) -> KVCache:
    """The zeroed cache for ``slots`` concurrent requests on ``device``,
    in ``dtype`` (default ``cfg.dtype``, the dtype the blocks' K/V
    arrive in), or int8 with scales when ``quantized``; head-sharded
    over ``ranks`` when given."""
    shape = _kv_shape(cfg, (slots, max_len), ranks)
    dt = dtype or cfg.dtype
    return KVCache(
        k=_alloc_kv(shape, dt, quantized, device),
        v=_alloc_kv(shape, dt, quantized, device),
        lengths=torch.zeros((slots,), dtype=torch.int32, device=device),
        ranks=ranks,
    )


@dataclasses.dataclass
class PagedKVCache:
    """Paged decode state: one shared page pool + per-slot fill counts.

    ``k``/``v``: ``[num_layers, num_pages + 1, page_size, heads,
    head_dim]`` (the last page is the trash page), or with ``ranks``
    ``[ranks, num_layers, num_pages + 1, page_size, heads / ranks,
    head_dim]``; ``lengths``: ``[slots]`` int32. The block tables are not
    device state: they live on the :class:`PageAllocator` and are
    uploaded with each step.
    """

    k: object
    v: object
    lengths: torch.Tensor
    ranks: int = 0  # 0: not head-sharded

    @property
    def num_pages(self) -> int:
        """Pages the allocator may hand out (the trash page excluded)."""
        return self.k.shape[-4] - 1

    @property
    def page_size(self) -> int:
        return self.k.shape[-3]

    def at(self, idx) -> tuple:
        """The index of page(s) ``idx`` in ``k``/``v``, every layer (and
        rank) of them."""
        return (slice(None),) * (2 if self.ranks else 1) + (idx,)


def alloc_paged_cache(
    cfg,
    slots: int,
    num_pages: int,
    page_size: int,
    *,
    device,
    dtype=None,
    quantized: bool = False,
    ranks: int = 0,
) -> PagedKVCache:
    """The zeroed page pool: ``num_pages`` pages of ``page_size`` rows,
    plus the trash page, independent of ``slots`` and of any per-slot
    length; head-sharded over ``ranks`` when given."""
    shape = _kv_shape(cfg, (num_pages + 1, page_size), ranks)
    dt = dtype or cfg.dtype
    return PagedKVCache(
        k=_alloc_kv(shape, dt, quantized, device),
        v=_alloc_kv(shape, dt, quantized, device),
        lengths=torch.zeros((slots,), dtype=torch.int32, device=device),
        ranks=ranks,
    )


def pages_needed(prompt_len: int, max_new_tokens: int, page_size: int) -> int:
    """Pages a request can ever touch. Prefill writes positions ``0 ..
    prompt_len - 1``; decode tick ``t`` appends one row at ``prompt_len
    + t - 1``, and the slot retires once it has ``max_new_tokens``
    tokens — so the fill watermark is ``prompt_len + max_new_tokens -
    1``."""
    return -(-(prompt_len + max_new_tokens - 1) // page_size)


@dataclasses.dataclass(frozen=True)
class AdmitPlan:
    """What :meth:`PageAllocator.admit` decided for one admission:
    ``shared_tokens`` prompt tokens whose K/V already sits in mapped
    shared pages (0 = cold), which is also the slot's write floor, and
    the slot's ``pages`` in position order. ``restream`` holds the
    ``(host_page, device_page)`` pairs to restore before the first
    prefill chunk: non-empty only when the prefix hit landed on a
    host-tier entry, whose pages come back into the first fresh pages of
    the mapping."""

    shared_tokens: int
    pages: tuple
    restream: tuple = ()

    @property
    def pages_granted(self) -> int:
        """Pages this admission mapped (fresh and shared): the slot-bind
        figure the request ledger records."""
        return len(self.pages)


def _prefix_hashes(tokens) -> list:
    """Rolling polynomial hash of every prefix: ``out[i]`` covers
    ``tokens[:i]``. The prefix index is keyed on ``(n, out[n])`` and
    every hit is confirmed by a full token compare before a page is
    mapped."""
    h = 0
    out = [0] * (len(tokens) + 1)
    for i, t in enumerate(tokens):
        h = (h * 1000003 + int(t) + 1) & 0x7FFFFFFFFFFFFFFF
        out[i + 1] = h
    return out


@dataclasses.dataclass
class _PrefixEntry:
    tokens: tuple  # the exact prefix (full compare before mapping)
    pages: tuple  # pages covering it, in position order
    # Which namespace ``pages`` indexes: "hbm" ids are pool pages
    # (refcounted, mappable); "host" ids are host seats, never
    # refcounted or mapped: a hit restores them into fresh pages.
    tier: str = "hbm"


@dataclasses.dataclass(frozen=True)
class _ParkedKV:
    """A preemption victim's spilled K/V: ``host_pages`` (position
    order) hold rows ``[0, fill)``, ``fill`` being the victim's cache
    fill (``prompt + generated - 1``) when it was evicted. Its resume
    restores them instead of prefilling the feed again."""

    host_pages: tuple
    fill: int


class PageAllocator:
    """Host-side page bookkeeping for one :class:`PagedKVCache`.

    - **Free-list reuse**: freed pages go back to the pool and are
      handed out again without zeroing.
    - **Prefix sharing**: once a request's prompt is fully prefilled,
      its page-aligned prefixes and the full prompt are registered in a
      rolling-hash index; a later admit whose prompt extends one maps
      those pages (refcount + 1) instead of recomputing them. Entries
      die with their pages.
    - **Copy-on-write**: a shared page (refcount > 1) is immutable; a
      write into one first copies it to a private page
      (:meth:`cow_before_write` returns the pair for the engine's device
      copy). Only a shared prefix's partly filled last page can be
      written while shared, and each mapper of one reserves a free page
      at admit, so a copy can never fail mid-decode.
    - **No partial allocation**: :meth:`admit` takes the whole
      requirement (fresh pages + COW reserve) or nothing.
    - **Host tier** (``host_pages`` > 0): a second namespace of page ids,
      seats whose payloads the engine keeps in host memory. A retiring
      slot's sole-reader prefix entries migrate there instead of dying
      (:meth:`spill_prefix_on_free`) and keep serving admissions by
      restream; a preemption victim parks its rows there
      (:meth:`park_pages`). Cold host entries are evicted to make room
      (:meth:`_reclaim_host`); parked records never are.
    """

    def __init__(self, num_pages: int, page_size: int, pages_per_slot: int, slots: int,
                 *, host_pages: int = 0):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        if host_pages < 0:
            raise ValueError(f"host_pages must be >= 0, got {host_pages}")
        self.host_pages = host_pages
        self.num_pages = num_pages
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        self.slots = slots
        self.block_tables = np.zeros((slots, pages_per_slot), np.int32)
        # The engine binds its memory ledger and the bytes one page spans
        # (every layer, K and V, the draft pool) after construction; every
        # page leaving or rejoining the free list, and every COW reserve,
        # is then a grant or a free. None: unwired, nothing is recorded.
        self.memledger = None
        self.page_bytes = 0
        self.reset()

    def reset(self) -> None:
        if self.memledger is not None and self.pages_in_use:
            # Return what is still held before the wipe: conservation
            # holds across a reset.
            self.memledger.free("kv_pages", self.pages_in_use * self.page_bytes, kind="reset")
            if self.reserved:
                self.memledger.free("kv_cow_reserve", self.reserved * self.page_bytes,
                                    kind="reset")
        self.block_tables[:] = 0
        self.refcount = np.zeros(self.num_pages, np.int64)
        self.free: list[int] = list(range(self.num_pages))[::-1]  # pop() = 0 first
        self.reserved = 0  # free pages promised to future COW copies
        self._cow_reserve: dict[int, int] = {}  # page -> outstanding reserves
        self._slot_pages: dict[int, list[int]] = {}
        self._index: dict[tuple[int, int], _PrefixEntry] = {}
        self._page_keys: dict[int, set] = {}  # page -> index keys citing it
        self._prefix_touch: dict[tuple, int] = {}  # index key -> last tick used
        self._slot_owner: dict[int, tuple] = {}  # slot -> (rid, tenant), for the ledger
        # The host tier: the allocator owns the seat ids, the engine the
        # payloads.
        self.host_free: list[int] = list(range(self.host_pages))[::-1]
        self._host_page_keys: dict[int, set] = {}  # host page -> keys
        self._parked: dict[Any, _ParkedKV] = {}  # rid -> parked record
        self.cow_copies = 0
        self.prefix_hits = 0
        self.admissions = 0
        self.shared_tokens_total = 0
        self.prompt_tokens_total = 0
        self.host_prefix_hits = 0  # admits served from the host tier
        self.parked_spills = 0  # preemption victims parked on the host
        self.spilled_prefix_entries = 0  # entries migrated to the host
        self.promoted_entries = 0  # host entries registered on the pool again

    # -- capacity -----------------------------------------------------------
    @property
    def free_pages(self) -> int:
        """Pages admittable right now (free minus the COW reserve)."""
        return len(self.free) - self.reserved

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self.free)

    @property
    def occupancy(self) -> float:
        return self.pages_in_use / self.num_pages

    @property
    def pages_shared(self) -> int:
        """Mappings beyond the first of every page: each is one page of
        K/V the dense cache would have stored again."""
        return int(np.maximum(self.refcount - 1, 0).sum())

    @property
    def hit_rate(self) -> float:
        """Fraction of admitted prompt tokens served from shared pages."""
        return (
            self.shared_tokens_total / self.prompt_tokens_total
            if self.prompt_tokens_total
            else 0.0
        )

    @property
    def host_pages_in_use(self) -> int:
        return self.host_pages - len(self.host_free)

    @property
    def host_resident_entries(self) -> int:
        """Prefix-index entries whose K/V lives only in host memory."""
        return sum(1 for e in self._index.values() if e.tier == "host")

    def pages_for(self, prompt_len: int, max_new_tokens: int) -> int:
        return pages_needed(prompt_len, max_new_tokens, self.page_size)

    # -- admission ----------------------------------------------------------
    def _find_shared_prefix(self, prompt: tuple):
        """Longest registered prefix of ``prompt``, every length probed
        from the longest down: ``(n_tokens, entry)`` or ``(0, None)``."""
        hashes = _prefix_hashes(prompt)
        for n in range(len(prompt), 0, -1):
            entry = self._index.get((n, hashes[n]))
            if entry is not None and entry.tokens == tuple(prompt[:n]):
                return n, entry
        return 0, None

    def admit(self, slot: int, prompt, max_new_tokens: int, *,
              owner=None, tenant=None, tick: int = 0):
        """Map pages for one request into ``slot``'s block table.

        Returns an :class:`AdmitPlan`, or ``None`` when the pool cannot
        hold the request right now (nothing is taken; the caller keeps
        it queued). Raises only for a request that could never fit.
        ``tick`` stamps the hit entry's recency (host eviction order);
        ``owner`` / ``tenant`` annotate the memory ledger's grants."""
        prompt = tuple(int(t) for t in prompt)
        need_total = self.pages_for(len(prompt), max_new_tokens)
        if need_total > self.pages_per_slot:
            raise ValueError(
                f"request needs {need_total} pages > pages_per_slot "
                f"{self.pages_per_slot} (prompt + max_new_tokens exceeds "
                f"the per-slot max_len)"
            )
        if need_total > self.num_pages:
            raise ValueError(
                f"request needs {need_total} pages but the pool holds "
                f"only {self.num_pages} (page_size {self.page_size}); "
                f"shrink prompt + max_new_tokens or grow num_pages"
            )
        shared_tokens, entry = self._find_shared_prefix(prompt)
        # A host-tier hit maps no shared pages: the prefix restores into
        # fresh private pages (refcounts and COW never span tiers), so
        # every page is the slot's own and no COW reserve is taken.
        host_hit = entry is not None and entry.tier == "host"
        shared_pages = (
            [] if host_hit else list(entry.pages) if entry is not None else []
        )
        partial_shared = bool(shared_tokens % self.page_size) and not host_hit
        own_needed = need_total - len(shared_pages)
        # The whole requirement up front — fresh pages now, plus one
        # reserved free page for a mapped partial page's future copy.
        if self.free_pages < own_needed + (1 if partial_shared else 0):
            return None
        fresh = [self.free.pop() for _ in range(own_needed)]
        for p in fresh:
            self.refcount[p] = 1
        for p in shared_pages:
            self.refcount[p] += 1
        if partial_shared:
            last = shared_pages[-1]
            self._cow_reserve[last] = self._cow_reserve.get(last, 0) + 1
            self.reserved += 1
        mapping = shared_pages + fresh
        self._slot_pages[slot] = mapping
        self._slot_owner[slot] = (owner, tenant)
        self.block_tables[slot] = 0  # no stale entries from the last tenant
        self.block_tables[slot, : len(mapping)] = mapping
        if self.memledger is not None:
            # Only the fresh pages are new occupancy (a shared mapping is
            # a refcount on pages granted already); the COW reserve is
            # held capacity too: it gates admission.
            if fresh:
                self.memledger.grant("kv_pages", len(fresh) * self.page_bytes, owner=owner,
                                     tenant=tenant, tick=tick, kind="admit")
            elif owner is not None:
                self.memledger.touch(owner, tick=tick, tenant=tenant, state="admit")
            if partial_shared:
                self.memledger.grant("kv_cow_reserve", self.page_bytes, owner=owner,
                                     tenant=tenant, tick=tick, kind="cow_reserve")
        self.admissions += 1
        restream = ()
        if shared_tokens:
            self.prefix_hits += 1
            # A hit refreshes the entry's recency on either tier: a host
            # entry still paying for itself is not the next one evicted.
            hashes = _prefix_hashes(prompt[:shared_tokens])
            self._prefix_touch[(shared_tokens, hashes[-1])] = tick
        if host_hit:
            # The hit's pages restore into the first fresh pages, in
            # position order. The entry stays on the host until
            # register_prefix promotes it.
            restream = tuple(
                (int(h), int(mapping[i])) for i, h in enumerate(entry.pages)
            )
            self.host_prefix_hits += 1
        self.shared_tokens_total += shared_tokens
        self.prompt_tokens_total += len(prompt)
        return AdmitPlan(
            shared_tokens=shared_tokens, pages=tuple(mapping), restream=restream
        )

    def register_prefix(self, slot: int, prompt, *, tick: int = 0) -> list:
        """Index ``slot``'s fully prefilled prompt: one entry per
        page-aligned prefix plus the full prompt (its partly filled last
        page). Call only after the final prefill chunk ran — an entry
        must never advertise K/V that is not on the device yet.

        A host-tier entry under the same key is promoted: the prefix is
        on the pool again, so its host copy goes. Returns the host seats
        that freed, whose payloads the engine drops."""
        prompt = tuple(int(t) for t in prompt)
        mapping = self._slot_pages.get(slot)
        if mapping is None:
            return []
        hashes = _prefix_hashes(prompt)
        ps = self.page_size
        plen = len(prompt)
        boundaries = [k * ps for k in range(1, plen // ps + 1)]
        if plen % ps:
            boundaries.append(plen)
        freed_host: list[int] = []
        for n in boundaries:
            key = (n, hashes[n])
            prev = self._index.get(key)
            if prev is not None:
                if prev.tier != "host":
                    continue  # first registration wins; content identical
                freed_host += self._evict_host_entry(key, prev)
                self.promoted_entries += 1
            pages = tuple(mapping[: -(-n // ps)])
            self._index[key] = _PrefixEntry(tokens=prompt[:n], pages=pages)
            self._prefix_touch[key] = tick
            for p in pages:
                self._page_keys.setdefault(p, set()).add(key)
        return freed_host

    # -- host tier ----------------------------------------------------------
    def spill_prefix_on_free(self, slot: int):
        """Plan the host migration of the prefix entries about to die
        with ``slot``'s pages. Call before :meth:`free_slot`: the entries
        citing a sole-reader (refcount 1) page of ``slot`` move to the
        host tier, every device page they cite (still-shared ones too,
        so the host copy stands alone) gets a seat, and their device
        bookkeeping goes, so a later free of a surviving shared page
        cannot kill them.

        Returns ``(copies, evicted)``: ``copies`` the ``[(device_page,
        host_page)]`` spills the engine runs before the pages recycle
        (all or nothing: a host tier too small returns ``([], [])`` and
        the entries die as without a tier); ``evicted`` the seats cold
        host entries gave up, whose payloads the engine drops."""
        if not self.host_pages:
            return [], []
        dying = [
            p for p in self._slot_pages.get(slot, [])
            if self.refcount[p] == 1 and self._page_keys.get(p)
        ]
        if not dying:
            return [], []
        keys: set = set()
        for p in dying:
            keys |= self._page_keys[p]
        entries = [(k, self._index[k]) for k in sorted(keys) if k in self._index]
        pages: list[int] = []
        seen: set = set()
        for _k, e in entries:
            for p in e.pages:
                if p not in seen:
                    seen.add(p)
                    pages.append(int(p))
        evicted = self._reclaim_host(len(pages))
        if evicted is None:
            return [], []
        mapping = {p: self.host_free.pop() for p in pages}
        for k, e in entries:
            for p in e.pages:
                s = self._page_keys.get(p)
                if s is not None:
                    s.discard(k)
                    if not s:
                        del self._page_keys[p]
            moved = _PrefixEntry(
                tokens=e.tokens,
                pages=tuple(mapping[int(p)] for p in e.pages),
                tier="host",
            )
            self._index[k] = moved
            for h in moved.pages:
                self._host_page_keys.setdefault(h, set()).add(k)
        self.spilled_prefix_entries += len(entries)
        return [(p, mapping[p]) for p in pages], evicted

    def park_pages(self, rid, slot: int, fill: int):
        """Take host seats for a preemption victim's rows ``[0, fill)``,
        all or nothing, evicting cold host prefix entries if needed
        (parked records are never evicted: they are promised resumes).
        Call before :meth:`free_slot`. Returns ``(copies, evicted)`` as
        :meth:`spill_prefix_on_free` does, or ``None`` when the host tier
        cannot hold them (the resume then recomputes)."""
        if not self.host_pages or fill <= 0:
            return None
        mapping = self._slot_pages.get(slot)
        npages = -(-fill // self.page_size)
        if mapping is None or npages > len(mapping):
            return None
        evicted = self._reclaim_host(npages)
        if evicted is None:
            return None
        host = [self.host_free.pop() for _ in range(npages)]
        self._parked[rid] = _ParkedKV(host_pages=tuple(host), fill=fill)
        self.parked_spills += 1
        return [(int(mapping[i]), host[i]) for i in range(npages)], evicted

    def peek_parked(self, rid):
        """The parked record of ``rid`` (or None), its seats still held."""
        return self._parked.get(rid)

    def take_parked(self, rid):
        """Pop ``rid``'s parked record and free its seats. Call only after
        the payloads were consumed (restored or dropped): the next spill
        may reuse the seats at once."""
        rec = self._parked.pop(rid, None)
        if rec is not None:
            self.host_free.extend(rec.host_pages)
        return rec

    def drop_parked(self, rid) -> list:
        """Discard ``rid``'s parked record. Returns the freed seats, whose
        payloads the engine drops."""
        rec = self._parked.pop(rid, None)
        if rec is None:
            return []
        self.host_free.extend(rec.host_pages)
        return list(rec.host_pages)

    def _reclaim_host(self, need: int):
        """Free seats until ``need`` are available, evicting the coldest
        host prefix entries first (by last use, then length). Returns the
        evicted seats (``[]`` when enough were free) or ``None`` when
        ``need`` cannot be reached, in which case nothing was evicted."""
        if need <= len(self.host_free):
            return []
        if len(self.host_free) + len(self._host_page_keys) < need:
            return None
        order = sorted(
            {k for ks in self._host_page_keys.values() for k in ks},
            key=lambda k: (self._prefix_touch.get(k, 0), k[0]),
        )
        freed: list[int] = []
        for key in order:
            if len(self.host_free) >= need:
                break
            entry = self._index.get(key)
            if entry is None or entry.tier != "host":
                continue
            freed += self._evict_host_entry(key, entry)
        return freed

    def _evict_host_entry(self, key, entry) -> list:
        """Drop one host-tier entry; seats no key cites any more return
        to ``host_free`` and are returned (their payloads go)."""
        self._index.pop(key, None)
        self._prefix_touch.pop(key, None)
        freed: list[int] = []
        for h in entry.pages:
            s = self._host_page_keys.get(h)
            if s is None:
                continue
            s.discard(key)
            if not s:
                del self._host_page_keys[h]
                self.host_free.append(h)
                freed.append(int(h))
        return freed

    def mapped_tokens(self) -> np.ndarray:
        """Per-slot writable capacity (mapped pages × page_size), int32
        ``[slots]``: a row past it would go through a zeroed table entry
        to page 0, which another slot may own."""
        out = np.zeros((self.slots,), np.int32)
        for slot, pages in self._slot_pages.items():
            out[slot] = len(pages) * self.page_size
        return out

    # -- write path ---------------------------------------------------------
    def cow_before_write(self, slot: int, position: int):
        """Make the page holding ``position`` privately writable by
        ``slot``. Returns ``(src, dst)`` when a copy-on-write remap
        happened (the caller copies page ``src`` to ``dst`` on the
        device before the write), else ``None``."""
        idx = position // self.page_size
        page = int(self.block_tables[slot, idx])
        if self.refcount[page] <= 1:
            return None
        # The admission reserve guarantees this pop: every mapper of a
        # shared partial page reserved one free page.
        if not self.free:
            raise RuntimeError(
                "COW with an empty free list — reservation accounting bug"
            )
        dst = self.free.pop()
        if self.memledger is not None:
            # The copy's page is new occupancy, paid for by the reserve
            # this mapper took at admission.
            owner, tenant = self._slot_owner.get(slot, (None, None))
            self.memledger.grant("kv_pages", self.page_bytes, owner=owner, tenant=tenant,
                                 kind="cow_copy")
        if self._cow_reserve.get(page, 0) > 0:
            self._cow_reserve[page] -= 1
            self.reserved -= 1
            if self.memledger is not None:
                self.memledger.free("kv_cow_reserve", self.page_bytes, kind="cow_copy")
        self.refcount[page] -= 1
        self.refcount[dst] = 1
        self._trim_reserve(page)
        self.block_tables[slot, idx] = dst
        self._slot_pages[slot][idx] = dst
        self.cow_copies += 1
        return page, dst

    def _trim_reserve(self, page: int) -> None:
        """Release COW reserves a page can no longer need: with
        ``refcount`` mappers it needs at most ``refcount - 1`` copies (the
        last owner writes in place), including after a sharer retired
        without ever writing."""
        keep = max(int(self.refcount[page]) - 1, 0)
        excess = self._cow_reserve.get(page, 0) - keep
        if excess > 0:
            self._cow_reserve[page] -= excess
            self.reserved -= excess
            if self.memledger is not None:
                self.memledger.free("kv_cow_reserve", excess * self.page_bytes,
                                    kind="trim_reserve")

    # -- release ------------------------------------------------------------
    def slot_page_stats(self, slot: int) -> tuple:
        """``(owned, shared)`` pages mapped by ``slot``: ``owned`` would
        return to the free list on :meth:`free_slot`, ``shared`` would
        only drop a refcount."""
        pages = self._slot_pages.get(slot, [])
        owned = sum(1 for p in pages if self.refcount[p] == 1)
        return owned, len(pages) - owned

    def free_slot(self, slot: int) -> None:
        """Unmap ``slot``'s pages: pages at refcount 0 return to the free
        list, and the prefix entries citing them die."""
        owner, _ = self._slot_owner.pop(slot, (None, None))
        released = 0
        for p in self._slot_pages.pop(slot, []):
            self.refcount[p] -= 1
            self._trim_reserve(p)
            if self.refcount[p] == 0:
                for key in self._page_keys.pop(p, ()):
                    entry = self._index.pop(key, None)
                    self._prefix_touch.pop(key, None)
                    if entry is not None:
                        for q in entry.pages:
                            if q != p and q in self._page_keys:
                                self._page_keys[q].discard(key)
                self.free.append(p)
                released += 1
        if self.memledger is not None and released:
            # Only pages back at refcount 0 end occupancy; a refcount
            # dropped on a shared page frees nothing.
            self.memledger.free("kv_pages", released * self.page_bytes, owner=owner,
                                kind="free_slot")
