"""The device-memory ledger: byte-exact capacity accounting (the port of
:mod:`mpit_tpu.obs.memledger`).

Every device-memory-holding subsystem of the serving stack registers
with one :class:`MemLedger` and reports its allocation lifecycle as
``grant`` / ``free`` events, so that at any tick :meth:`MemLedger.held`
decomposes the engine's device memory into attributed components and
``granted − freed == held`` holds exactly, per subsystem and in total.

Layout convention (the serving stack's registration,
:class:`mpit_tpu_torch.serve.Engine`), in the port's own tensors:

- **top-level subsystems** hold real device tensors and sum into
  ``held()``: ``weights`` (the model's parameters as the engine holds
  them: an int8 store's ``q`` and ``scale`` tensors, a tensor-parallel
  engine's rank-stacked shards), ``draft_weights`` (the draft model's
  own tensors: the port's draft loads its own copy even of the leaves it
  shares with the target), ``kv_pool`` (the cache tensors — target and
  draft, K and V, an int8 cache's scales, the lengths, and on the paged
  pool its trash page), ``step_buffers`` (per-slot decode state);
- **nested subsystems** (``nested_in=``) decompose a parent's capacity
  without adding to the total: ``kv_pages`` tracks page occupancy inside
  ``kv_pool`` (grants as pages leave the free list, frees as they return)
  and ``kv_cow_reserve`` the pages held back for copy-on-write copies;
  ``kv_slots`` the dense cache's slot reservations; ``kv_host_pages``
  the host tier's seats (nested in ``host_ram``: host memory, not the
  card's).

Ledger numbers always carry the platform label. :meth:`reconcile` reads
``torch.cuda.memory_allocated`` only when the platform is ``"cuda"``;
off the card it reports the ledger bytes, the platform and ``None``
device bytes, never a fabricated measurement.

Import-light: no torch, no numpy (torch is imported lazily by
:meth:`MemLedger.reconcile`).

``python -m mpit_tpu_torch.obs capacity`` (:func:`capacity_report` /
:func:`format_capacity`) is the offline verdict over a snapshot: exit 0
on a usable verdict, 2 on input without ledger data.
"""

from __future__ import annotations

MEMLEDGER_FORMAT = "mpit-obs-memledger-v1"

#: Reconciliation tolerance (%): the caching allocator rounds blocks up,
#: and the process holds scratch no subsystem registers — cuBLAS's
#: workspace (32 MiB a stream on the H100), the int8 matmul's
#: split-contraction workspace, the sampler's buffers.
DEFAULT_RECONCILE_TOLERANCE_PCT = 10.0


class MemLedger:
    """Byte-exact device-memory ledger (see module docstring).

    All byte quantities are integral and < 2^53, so float accumulation
    is exact; the invariant checks compare with ``==``, not a
    tolerance. Grants/frees from unregistered subsystems auto-register
    (top-level, no capacity) so instrumentation never KeyErrors on an
    engine variant that skipped a registration.
    """

    def __init__(self, *, platform: str = "unknown"):
        self.platform = platform
        # subsystem -> {held, granted, freed, grants, frees, peak,
        #               capacity, nested_in, meta}
        self._subs: dict[str, dict] = {}
        # owner (rid) -> {tenant, last_touch, state} — the eviction
        # ranking's recency index. Owners are forgotten at retire so
        # the registry tracks residents, not history.
        self._owners: dict[str, dict] = {}
        self._peak = 0.0
        self._peak_tick = 0
        self._exhaustion: dict | None = None
        self.exhaustions = 0

    # -- registration --------------------------------------------------------
    def register(
        self,
        subsystem: str,
        *,
        capacity_bytes: float | None = None,
        nested_in: str | None = None,
        **meta,
    ) -> None:
        """Declare a subsystem (idempotent; re-register updates
        capacity/meta without touching the accumulators). ``nested_in``
        marks it as a decomposition of a parent subsystem: its held
        bytes do NOT add into :meth:`held`'s total."""
        sub = self._subs.get(subsystem)
        if sub is None:
            sub = self._subs[subsystem] = {
                "held": 0.0, "granted": 0.0, "freed": 0.0,
                "grants": 0, "frees": 0, "peak": 0.0,
                "capacity": None, "nested_in": None, "meta": {},
            }
        if capacity_bytes is not None:
            sub["capacity"] = float(capacity_bytes)
        if nested_in is not None:
            sub["nested_in"] = nested_in
        if meta:
            sub["meta"].update(meta)

    # -- the lifecycle events ------------------------------------------------
    def grant(
        self,
        subsystem: str,
        nbytes: float,
        *,
        owner=None,
        tenant: str | None = None,
        tick: int | None = None,
        kind: str | None = None,
    ) -> None:
        """Record ``nbytes`` newly held by ``subsystem``. ``owner`` /
        ``tenant`` / ``tick`` annotate the owner registry for the
        eviction ranking; attribution totals are computed at query
        time from allocator ground truth, never accumulated here (no
        drift)."""
        if nbytes < 0:
            raise ValueError(f"grant of negative bytes: {nbytes}")
        sub = self._subs.get(subsystem)
        if sub is None:
            self.register(subsystem)
            sub = self._subs[subsystem]
        sub["held"] += nbytes
        sub["granted"] += nbytes
        sub["grants"] += 1
        if sub["held"] > sub["peak"]:
            sub["peak"] = sub["held"]
        if sub["nested_in"] is None:
            total = self.held()
            if total > self._peak:
                self._peak = total
                self._peak_tick = int(tick or 0)
        if owner is not None:
            self.touch(owner, tick=tick or 0, tenant=tenant, state=kind)

    def free(
        self,
        subsystem: str,
        nbytes: float,
        *,
        owner=None,
        tick: int | None = None,
        kind: str | None = None,
    ) -> None:
        """Record ``nbytes`` returned by ``subsystem``. Over-freeing
        (held going negative) is an instrumentation bug, surfaced by
        :meth:`conservation`, not silently clamped."""
        if nbytes < 0:
            raise ValueError(f"free of negative bytes: {nbytes}")
        sub = self._subs.get(subsystem)
        if sub is None:
            self.register(subsystem)
            sub = self._subs[subsystem]
        sub["held"] -= nbytes
        sub["freed"] += nbytes
        sub["frees"] += 1

    # -- the owner recency index ---------------------------------------------
    def touch(
        self, owner, *, tick: int,
        tenant: str | None = None, state: str | None = None,
    ) -> None:
        """Update ``owner``'s last-touch tick (monotonic max) — the
        recency signal the eviction ranking orders by."""
        e = self._owners.setdefault(
            owner, {"tenant": tenant, "last_touch": int(tick), "state": state}
        )
        e["last_touch"] = max(e["last_touch"], int(tick))
        if tenant is not None:
            e["tenant"] = tenant
        if state is not None:
            e["state"] = state

    def forget(self, owner) -> None:
        """Drop a retired owner from the recency index."""
        self._owners.pop(owner, None)

    def reset_transients(self) -> None:
        """Forget owner recency and exhaustion forensics (an engine
        reset between runs). Byte accumulators are NOT touched — the
        buffers persist across resets and the conservation history
        must cover their whole lifetime."""
        self._owners.clear()
        self._exhaustion = None
        self.exhaustions = 0

    def owners(self) -> dict:
        return {k: dict(v) for k, v in self._owners.items()}

    # -- queries -------------------------------------------------------------
    def held(self, subsystem: str | None = None) -> float:
        """Bytes currently held — by one subsystem, or (default) the
        total over top-level subsystems (nested decompositions are a
        view into their parent, not additional memory)."""
        if subsystem is not None:
            sub = self._subs.get(subsystem)
            return sub["held"] if sub is not None else 0.0
        return sum(
            s["held"] for s in self._subs.values()
            if s["nested_in"] is None
        )

    def decompose(self) -> dict:
        """``{subsystem: held_bytes}`` over every registered subsystem
        (nested included — the reader distinguishes via snapshot's
        ``nested_in``)."""
        return {
            name: int(sub["held"]) for name, sub in sorted(self._subs.items())
        }

    def capacity(self, subsystem: str) -> float | None:
        sub = self._subs.get(subsystem)
        return sub["capacity"] if sub is not None else None

    def headroom(self, subsystem: str) -> float | None:
        """``capacity − held`` for one subsystem; None when it never
        declared a capacity (headroom against an unknown ceiling would
        be a fabricated number)."""
        sub = self._subs.get(subsystem)
        if sub is None or sub["capacity"] is None:
            return None
        return sub["capacity"] - sub["held"]

    def watermark(self) -> dict:
        """Peak total held bytes, the tick it was set, and per-subsystem
        peaks."""
        return {
            "held_peak_bytes": int(self._peak),
            "tick": self._peak_tick,
            "subsystems": {
                name: int(sub["peak"])
                for name, sub in sorted(self._subs.items())
            },
        }

    def conservation(self) -> dict:
        """The invariant: per subsystem ``granted − freed == held`` and
        ``held >= 0``, compared EXACTLY (integral floats). ``ok`` is
        the conjunction; per-subsystem verdicts name the violator."""
        subs = {}
        ok = True
        for name, sub in sorted(self._subs.items()):
            sub_ok = (
                sub["granted"] - sub["freed"] == sub["held"]
                and sub["held"] >= 0
            )
            ok = ok and sub_ok
            subs[name] = {
                "ok": sub_ok,
                "granted_bytes": int(sub["granted"]),
                "freed_bytes": int(sub["freed"]),
                "held_bytes": int(sub["held"]),
            }
        return {"ok": ok, "total_held_bytes": int(self.held()),
                "subsystems": subs}

    # -- exhaustion forensics ------------------------------------------------
    def note_exhaustion(self, dump: dict) -> None:
        """Retain the most recent pool-exhaustion forensics dump (the
        ranked top-holders table the scheduler builds at the
        ``kv_pool_exhausted`` edge) for the end-of-run snapshot."""
        self._exhaustion = dict(dump)
        self.exhaustions += 1

    # -- reconciliation ------------------------------------------------------
    def reconcile(
        self, device=None, *,
        baseline_bytes: int = 0,
        tolerance_pct: float = DEFAULT_RECONCILE_TOLERANCE_PCT,
    ) -> dict:
        """Compare ledger-held bytes against the CUDA caching allocator's
        ``memory_allocated(device)``, less ``baseline_bytes`` (what the
        process held before the ledgered tensors were made). Only on the
        card: off it the report carries the platform label, the ledger
        bytes and ``device_bytes: None``."""
        out = {
            "platform": self.platform,
            "ledger_bytes": int(self.held()),
            "device_bytes": None,
            "delta_pct": None,
            "within_tolerance": None,
            "tolerance_pct": tolerance_pct,
        }
        if self.platform != "cuda" or device is None:
            return out
        import torch

        dev = float(torch.cuda.memory_allocated(device) - baseline_bytes)
        out["device_bytes"] = int(dev)
        out["baseline_bytes"] = int(baseline_bytes)
        delta = 100.0 * abs(dev - out["ledger_bytes"]) / max(dev, 1.0)
        out["delta_pct"] = round(delta, 2)
        out["within_tolerance"] = delta <= tolerance_pct
        return out

    # -- snapshot ------------------------------------------------------------
    def snapshot(self) -> dict:
        """The serializable whole-ledger view. Conservation is evaluated
        at snapshot time, so a stored snapshot carries its own verdict."""
        subs = {}
        for name, sub in sorted(self._subs.items()):
            e = {
                "held_bytes": int(sub["held"]),
                "granted_bytes": int(sub["granted"]),
                "freed_bytes": int(sub["freed"]),
                "grants": sub["grants"],
                "frees": sub["frees"],
                "peak_bytes": int(sub["peak"]),
            }
            if sub["capacity"] is not None:
                e["capacity_bytes"] = int(sub["capacity"])
            if sub["nested_in"] is not None:
                e["nested_in"] = sub["nested_in"]
            if sub["meta"]:
                e["meta"] = dict(sub["meta"])
            subs[name] = e
        out = {
            "format": MEMLEDGER_FORMAT,
            "platform": self.platform,
            "held_bytes": int(self.held()),
            "held_peak_bytes": int(self._peak),
            "held_peak_tick": self._peak_tick,
            "subsystems": subs,
            "conservation": self.conservation(),
        }
        if self._owners:
            out["owners"] = self.owners()
        if self._exhaustion is not None:
            out["exhaustion"] = dict(self._exhaustion)
            out["exhaustions"] = self.exhaustions
        return out


# ---------------------------------------------------------------------------
# Offline capacity verdict (``python -m mpit_tpu_torch.obs capacity``).
# ---------------------------------------------------------------------------


def _find_memory_block(doc: dict, workload: str | None = None):
    """Locate the memory block in any of the accepted input shapes:
    a raw :meth:`MemLedger.snapshot`, a ``Server.stats()`` dump (its
    ``memory`` key), that ``memory`` block alone, or a
    ``BENCH_DETAIL.json`` (``workloads`` → serve entries carrying a
    ``memory`` block). Returns ``(block, label)``."""
    if not isinstance(doc, dict):
        raise ValueError("not a JSON object")
    if doc.get("format") == MEMLEDGER_FORMAT:
        return doc, "memledger snapshot"
    mem = doc.get("memory")
    if isinstance(mem, dict) and mem.get("source") == "memledger":
        return mem, "stats dump"
    if doc.get("source") == "memledger":
        return doc, "memory block"
    workloads = doc.get("workloads")
    if isinstance(workloads, dict):
        names = [workload] if workload else sorted(workloads)
        for name in names:
            entry = workloads.get(name)
            if not isinstance(entry, dict):
                continue
            mem = entry.get("memory")
            if isinstance(mem, dict) and mem.get("source") == "memledger":
                return mem, f"workload {name}"
        raise ValueError(
            "no workload in this BENCH_DETAIL carries a memory-ledger block"
        )
    raise ValueError(
        "input carries no memory-ledger data (need a memledger "
        "snapshot, a Server.stats() dump with a 'memory' block, or a "
        "BENCH_DETAIL.json from a serve bench)"
    )


def capacity_report(doc: dict, *, workload: str | None = None) -> dict:
    """Build the capacity verdict from a snapshot document. Raises
    :class:`ValueError` on input without ledger data (the CLI's exit
    2: no verdict beats a fabricated one)."""
    mem, label = _find_memory_block(doc, workload)
    # Normalize the two block shapes: a raw MemLedger.snapshot carries
    # ``subsystems`` dicts; the Server.stats() memory block carries the
    # flattened ``held_by_subsystem`` plus kv headroom fields.
    if "subsystems" in mem:
        by_sub = {
            name: e.get("held_bytes", 0)
            for name, e in mem["subsystems"].items()
        }
        kv = mem["subsystems"].get("kv_pages", {})
        capacity = kv.get("capacity_bytes")
        reserve = (
            mem["subsystems"].get("kv_cow_reserve", {}).get("held_bytes", 0)
        )
        headroom = (
            capacity - kv.get("held_bytes", 0) - reserve
            if capacity is not None else None
        )
        headroom_pct = (
            round(100.0 * headroom / capacity, 2)
            if capacity else None
        )
        headroom_min_pct = None
        host = mem["subsystems"].get("kv_host_pages", {})
        host_held = host.get("held_bytes") if host else None
        host_cap = host.get("capacity_bytes") if host else None
    else:
        by_sub = dict(mem.get("held_by_subsystem", {}))
        capacity = mem.get("kv_capacity_bytes")
        headroom = mem.get("kv_headroom_bytes")
        headroom_pct = mem.get("kv_headroom_pct")
        headroom_min_pct = mem.get("kv_headroom_min_pct")
        host_held = mem.get("host_held_bytes")
        host_cap = mem.get("host_capacity_bytes")
    conservation = mem.get("conservation", {})
    report = {
        "source": label,
        "platform": mem.get("platform", "unknown"),
        "held_bytes": int(mem.get("held_bytes", 0)),
        "held_peak_bytes": int(
            mem.get("held_peak_bytes", mem.get("held_bytes", 0))
        ),
        "held_by_subsystem": by_sub,
        "kv_capacity_bytes": capacity,
        "kv_headroom_bytes": headroom,
        "kv_headroom_pct": headroom_pct,
        "kv_headroom_min_pct": headroom_min_pct,
        "conservation_ok": bool(conservation.get("ok", False)),
    }
    if host_held is not None:
        # Present only when the run carried a host KV tier.
        report["host_held_bytes"] = int(host_held)
        if host_cap is not None:
            report["host_capacity_bytes"] = int(host_cap)
        if mem.get("host_held_peak_bytes") is not None:
            report["host_held_peak_bytes"] = int(
                mem["host_held_peak_bytes"]
            )
    if mem.get("reconciliation"):
        report["reconciliation"] = mem["reconciliation"]
    if mem.get("eviction_candidates"):
        report["eviction_candidates"] = mem["eviction_candidates"]
    if mem.get("exhaustion"):
        report["exhaustion"] = mem["exhaustion"]
    return report


def format_capacity(report: dict) -> str:
    """Human-readable capacity verdict: a header line, an attribution
    table, then the verdicts."""
    lines = [
        f"capacity verdict — platform={report['platform']} "
        f"({report['source']})",
        f"  held {_fmt_bytes(report['held_bytes'])}   "
        f"peak {_fmt_bytes(report['held_peak_bytes'])}",
    ]
    by_sub = report.get("held_by_subsystem", {})
    if by_sub:
        total = max(report["held_bytes"], 1)
        lines.append("  held by subsystem:")
        for name, b in sorted(by_sub.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"    {name:<16} {_fmt_bytes(b):>12}  "
                f"{100.0 * b / total:5.1f}%"
            )
    if report.get("kv_capacity_bytes") is not None:
        head = report.get("kv_headroom_bytes")
        pct = report.get("kv_headroom_pct")
        line = (
            f"  kv pool capacity {_fmt_bytes(report['kv_capacity_bytes'])}"
        )
        if head is not None:
            line += f"   headroom {_fmt_bytes(head)}"
        if pct is not None:
            line += f" ({pct:.1f}%)"
        if report.get("kv_headroom_min_pct") is not None:
            line += f"   min {report['kv_headroom_min_pct']:.1f}%"
        lines.append(line)
    if report.get("host_held_bytes") is not None:
        # The host tier's own line, beside the pool's.
        line = f"  host tier held {_fmt_bytes(report['host_held_bytes'])}"
        cap = report.get("host_capacity_bytes")
        if cap:
            line += (
                f" of {_fmt_bytes(cap)} "
                f"({100.0 * report['host_held_bytes'] / cap:.1f}%)"
            )
        if report.get("host_held_peak_bytes") is not None:
            line += f"   peak {_fmt_bytes(report['host_held_peak_bytes'])}"
        lines.append(line)
    rec = report.get("reconciliation")
    if rec:
        if rec.get("device_bytes") is not None:
            verdict = (
                "within tolerance" if rec.get("within_tolerance")
                else "OUT OF TOLERANCE"
            )
            lines.append(
                f"  device reconcile: ledger "
                f"{_fmt_bytes(rec['ledger_bytes'])} vs device "
                f"{_fmt_bytes(rec['device_bytes'])} "
                f"(delta {rec['delta_pct']}%) — {verdict}"
            )
        else:
            lines.append(
                f"  device reconcile: modeled only "
                f"(platform={rec.get('platform')}, no device bytes)"
            )
    ev = report.get("eviction_candidates")
    if ev:
        lines.append(f"  eviction candidates ({len(ev)}, coldest first):")
        for c in ev[:8]:
            # ``tier`` names where the candidate lives: reclaiming an
            # hbm one buys pool pages, a host one host capacity.
            tier = f" tier={c['tier']}" if c.get("tier") else ""
            lines.append(
                f"    {c.get('kind', '?'):<20} "
                f"{_fmt_bytes(c.get('bytes', 0)):>12}  "
                f"last_touch=t{c.get('last_touch_tick', 0)}{tier} "
                f"{c.get('rid', c.get('key', ''))}"
            )
    ex = report.get("exhaustion")
    if ex:
        pressure = (
            f" pressure={ex['tier_pressure']}"
            if ex.get("tier_pressure") else ""
        )
        lines.append(
            f"  last exhaustion: tick={ex.get('tick')} "
            f"headroom={_fmt_bytes(ex.get('kv_headroom_bytes', 0))}"
            + pressure
        )
        for h in ex.get("top_holders", [])[:5]:
            lines.append(
                f"    holder {str(h.get('rid', h.get('tenant', '?'))):<12} "
                f"{_fmt_bytes(h.get('bytes', 0)):>12}"
            )
    lines.append(
        "  conservation: "
        + ("ok (grants - frees == held)" if report["conservation_ok"]
           else "VIOLATED — instrumentation bug, bytes unattributed")
    )
    return "\n".join(lines)


def _fmt_bytes(b) -> str:
    b = float(b or 0)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(b) < 1024.0 or unit == "GiB":
            return f"{b:.1f}{unit}" if unit != "B" else f"{int(b)}B"
        b /= 1024.0
    return f"{b:.1f}GiB"
