"""mpit_tpu_torch's page allocator against the JAX package's, step by step.

The same scripted admit / ``register_prefix`` / ``cow_before_write`` /
``free_slot`` calls go to :class:`mpit_tpu.serve.kvcache.PageAllocator`
and to the port's; after every call the two must agree exactly: the
returned plans and copy pairs, block tables, refcounts, free lists, COW
reserves, the prefix index and every counter. The cases mirror the
no-tier cases of ``tests/test_kvcache.py`` (capacity, prefix sharing,
the hash-collision compare, copy-on-write, reserve trimming, COW at
exhaustion), plus a seeded random script. Host Python only: no JAX
compute runs here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from mpit_tpu.serve import kvcache as jkv
from mpit_tpu_torch.serve import kvcache as tkv


class Pair:
    """One JAX and one port allocator driven in lockstep."""

    def __init__(self, num_pages=16, page_size=4, pages_per_slot=8, slots=4):
        args = (num_pages, page_size, pages_per_slot, slots)
        self.j = jkv.PageAllocator(*args)
        self.t = tkv.PageAllocator(*args)
        self.check()

    def check(self):
        j, t = self.j, self.t
        np.testing.assert_array_equal(t.block_tables, j.block_tables)
        np.testing.assert_array_equal(t.refcount, j.refcount)
        assert t.free == j.free
        assert t.reserved == j.reserved
        assert t._cow_reserve == j._cow_reserve
        assert t._slot_pages == j._slot_pages
        assert {k: (e.tokens, e.pages) for k, e in t._index.items()} == {
            k: (e.tokens, e.pages) for k, e in j._index.items()
        }
        assert all(e.tier == "hbm" for e in j._index.values())
        assert t._page_keys == j._page_keys
        for name in (
            "cow_copies", "prefix_hits", "admissions", "shared_tokens_total",
            "prompt_tokens_total", "free_pages", "pages_in_use", "occupancy",
            "pages_shared", "hit_rate",
        ):
            assert getattr(t, name) == getattr(j, name), name
        np.testing.assert_array_equal(t.mapped_tokens(), j.mapped_tokens())
        for slot in range(j.slots):
            assert t.slot_page_stats(slot) == j.slot_page_stats(slot)

    def admit(self, slot, prompt, max_new):
        pj = self.j.admit(slot, prompt, max_new)
        pt = self.t.admit(slot, prompt, max_new)
        assert (pj is None) == (pt is None)
        if pj is not None:
            assert (pt.shared_tokens, pt.pages) == (pj.shared_tokens, pj.pages)
            assert not pj.restream  # the no-tier path
        self.check()
        return pt

    def register(self, slot, prompt):
        self.j.register_prefix(slot, prompt)
        self.t.register_prefix(slot, prompt)
        self.check()

    def cow(self, slot, position):
        pair = self.t.cow_before_write(slot, position)
        assert pair == self.j.cow_before_write(slot, position)
        self.check()
        return pair

    def free_slot(self, slot):
        self.j.free_slot(slot)
        self.t.free_slot(slot)
        self.check()


class TestPagesNeeded:
    def test_fill_watermark_math(self):
        for plen in range(1, 40):
            for new in range(1, 20):
                for ps in (1, 4, 16):
                    assert tkv.pages_needed(plen, new, ps) == jkv.pages_needed(
                        plen, new, ps
                    )
        assert tkv.pages_needed(4, 1, 4) == 1
        assert tkv.pages_needed(7, 10, 4) == 4

    def test_admit_maps_exactly_pages_needed(self):
        a = Pair()
        plan = a.admit(0, list(range(6)), 4)  # watermark 9 -> 3 pages
        assert len(plan.pages) == 3 and plan.shared_tokens == 0


class TestCapacity:
    def test_exhaustion_returns_none_with_no_partial_allocation(self):
        a = Pair(num_pages=4, page_size=4)
        a.admit(0, list(range(8)), 4)
        assert a.admit(1, list(range(5)), 3) is None
        assert a.t.pages_in_use == 3
        assert a.admit(1, [1, 2], 2) is not None

    def test_never_fits_raises_precise_valueerror(self):
        a = Pair(num_pages=4, page_size=4, pages_per_slot=8)
        for alloc in (a.j, a.t):
            with pytest.raises(ValueError, match="pool holds"):
                alloc.admit(0, list(range(12)), 8)
        b = Pair(num_pages=64, pages_per_slot=2)
        for alloc in (b.j, b.t):
            with pytest.raises(ValueError, match="pages_per_slot"):
                alloc.admit(0, list(range(12)), 8)
        a.check()
        b.check()

    def test_freed_pages_recycle_through_free_list(self):
        a = Pair(num_pages=4, page_size=4)
        a.admit(0, list(range(8)), 4)
        a.free_slot(0)
        a.admit(1, list(range(4)), 8)
        assert a.t.pages_in_use == 3

    def test_admit_clears_stale_block_table_tail(self):
        a = Pair()
        a.admit(0, list(range(20)), 12)  # 8 pages fill the row
        a.free_slot(0)
        a.admit(0, [1, 2], 2)
        assert list(a.t.block_tables[0][1:]) == [0] * 7


class TestPrefixSharing:
    def test_registered_prefix_is_mapped_refcounted(self):
        a = Pair()
        p = list(range(10))
        plan_a = a.admit(0, p, 4)
        a.register(0, p)
        plan_b = a.admit(1, p + [77, 78], 4)
        assert plan_b.shared_tokens == 10
        assert plan_b.pages[:3] == plan_a.pages[:3]
        assert a.t.pages_shared == 3 and 0 < a.t.hit_rate < 1

    def test_page_aligned_prefix_shares_without_reserve(self):
        a = Pair()
        p = list(range(8))
        a.admit(0, p, 4)
        a.register(0, p)
        plan = a.admit(1, p + [5], 4)
        assert plan.shared_tokens == 8 and a.t.reserved == 0

    def test_entries_die_with_their_pages(self):
        a = Pair()
        p = list(range(6))
        a.admit(0, p, 4)
        a.register(0, p)
        a.free_slot(0)
        assert a.admit(1, p, 4).shared_tokens == 0

    def test_hash_collision_is_confirmed_by_token_compare(self):
        """Both indexes are poisoned with an entry whose key is prompt
        B's 4-token prefix hash but whose tokens differ: the full token
        compare must reject the hit in both."""
        a = Pair()
        b = [1, 2, 3, 4, 9]
        h = tkv._prefix_hashes(b)[4]
        assert h == jkv._prefix_hashes(b)[4]
        other = tuple(range(100, 104))
        a.j._index[(4, h)] = jkv._PrefixEntry(tokens=other, pages=(7,))
        a.t._index[(4, h)] = tkv._PrefixEntry(tokens=other, pages=(7,))
        for alloc in (a.j, a.t):
            alloc._page_keys[7] = {(4, h)}
            alloc.refcount[7] = 1
        a.check()
        assert a.admit(0, b, 2).shared_tokens == 0
        assert a.t.prefix_hits == 0

    def test_first_registration_wins(self):
        a = Pair()
        p = list(range(4))
        a.admit(0, p, 4)
        a.register(0, p)
        entry = a.t._index[(4, tkv._prefix_hashes(p)[4])]
        a.admit(1, p + [9], 4)
        a.register(1, p + [9])
        assert a.t._index[(4, tkv._prefix_hashes(p)[4])] is entry


class TestCopyOnWrite:
    def _shared_partial(self):
        a = Pair()
        p = list(range(6))
        a.admit(0, p, 4)
        a.register(0, p)
        plan = a.admit(1, p + [50, 51], 4)
        assert plan.shared_tokens == 6
        return a, plan

    def test_partial_page_mapping_reserves_cow_page(self):
        a, _ = self._shared_partial()
        assert a.t.reserved == 1 and a.t.free_pages == len(a.t.free) - 1

    def test_cow_moves_writer_consumes_reserve(self):
        a, plan = self._shared_partial()
        src, dst = a.cow(1, 6)
        assert src == plan.pages[1] and a.t.block_tables[1][1] == dst
        assert a.t.reserved == 0 and a.t.cow_copies == 1
        assert a.cow(1, 7) is None
        assert a.cow(0, 6) is None

    def test_sole_owner_write_is_in_place(self):
        a = Pair()
        a.admit(0, list(range(6)), 4)
        assert a.cow(0, 6) is None

    def test_release_on_retire_returns_reserve(self):
        a, _ = self._shared_partial()
        a.free_slot(1)
        assert a.t.reserved == 0 and a.t.pages_shared == 0

    def test_retiring_nonwriter_sharer_releases_its_reserve(self):
        a = Pair(num_pages=8, page_size=4, slots=4)
        p = list(range(6))
        a.admit(0, p, 4)
        a.register(0, p)
        a.admit(1, p, 4)
        a.admit(2, p, 4)
        assert a.t.reserved == 2
        a.free_slot(1)
        assert a.t.reserved == 1
        assert a.cow(2, 5) is not None and a.t.reserved == 0
        assert a.cow(0, 5) is None

    def test_cow_cannot_fail_at_pool_exhaustion(self):
        a = Pair(num_pages=5, page_size=4, pages_per_slot=4, slots=5)
        p = list(range(6))
        a.admit(0, p, 2)
        a.register(0, p)
        a.admit(1, p + [9], 2)
        assert a.admit(2, [1], 1) is not None
        assert a.admit(3, [2], 1) is not None
        assert a.t.free_pages == 0 and a.t.reserved == 1
        assert a.admit(4, [3], 1) is None
        assert a.cow(1, 6) is not None
        assert a.t.reserved == 0 and len(a.t.free) == 0


class TestAdmitPlanShape:
    def test_plan_is_frozen_and_ordered(self):
        a = Pair()
        plan = a.admit(0, list(range(5)), 3)
        assert isinstance(plan, tkv.AdmitPlan)
        assert list(a.t.block_tables[0][: len(plan.pages)]) == list(plan.pages)
        with pytest.raises(dataclasses.FrozenInstanceError):
            plan.shared_tokens = 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_script_matches_jax(seed):
    """A seeded random mix of admits (prompts drawn from a few shared
    stems so that prefixes hit), registrations, decode-position COW
    probes and retirements, checked after every call."""
    rng = np.random.default_rng(seed)
    a = Pair(num_pages=24, page_size=4, pages_per_slot=8, slots=5)
    stems = [list(rng.integers(0, 50, 9)) for _ in range(3)]
    live: dict[int, tuple] = {}  # slot -> (prompt, max_new, fill)
    for _ in range(120):
        op = rng.integers(0, 4)
        free_slots = [s for s in range(5) if s not in live]
        if op == 0 and free_slots:
            slot = int(rng.choice(free_slots))
            stem = stems[rng.integers(0, 3)]
            prompt = stem[: rng.integers(1, 10)] + list(
                rng.integers(0, 50, rng.integers(0, 4))
            )
            max_new = int(rng.integers(1, 8))
            if a.admit(slot, prompt, max_new) is not None:
                a.register(slot, prompt)
                live[slot] = (prompt, max_new, len(prompt))
        elif op in (1, 2) and live:
            slot = int(rng.choice(sorted(live)))
            prompt, max_new, fill = live[slot]
            if fill < len(prompt) + max_new - 1:
                a.cow(slot, fill)
                live[slot] = (prompt, max_new, fill + 1)
        elif op == 3 and live:
            slot = int(rng.choice(sorted(live)))
            a.free_slot(slot)
            del live[slot]
