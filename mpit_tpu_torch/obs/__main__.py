"""``python -m mpit_tpu_torch.obs`` — trace summary, gap report, the
perf-regression gate, request forensics and the capacity verdict (the
port of ``python -m mpit_tpu.obs``).

Usage::

    python -m mpit_tpu_torch.obs trace.json            # summary + gap report
    python -m mpit_tpu_torch.obs summary trace.json    # the same, named
    python -m mpit_tpu_torch.obs obs.jsonl --top 10    # widen the phase table
    python -m mpit_tpu_torch.obs trace.json --gap-only # just the attribution
    python -m mpit_tpu_torch.obs diff base.json cur.json --tolerance-pct 10
    python -m mpit_tpu_torch.obs why-slow serve_out.json   # worst exemplar
    python -m mpit_tpu_torch.obs capacity serve_out.json   # memory verdict

**Summary mode** reads an exported timeline — the Chrome trace of
:func:`mpit_tpu_torch.obs.export_chrome_trace` (the serving CLI's
``--trace``) or the JSONL of :func:`mpit_tpu_torch.obs.export_jsonl` —
and prints the phase roll-up and the gap attribution offline.

**Diff mode** compares two :mod:`~mpit_tpu_torch.obs.baseline`
snapshots (the serving CLI's ``--baseline`` writes one) and exits 1 on a
phase-time regression, a utilization drop or a held-bytes growth beyond
tolerance.

**Why-slow mode** reads a ledger snapshot, a ``Server.stats()`` dump
(the serving CLI's JSON output carries one) or a BENCH_DETAIL.json with
``trace_forensics`` blocks and prints the worst retained exemplar's
lifeline and latency attribution.

**Capacity mode** reads a :meth:`MemLedger.snapshot`, a
``Server.stats()`` dump with a ``memory`` block or a serving
BENCH_DETAIL.json and prints the memory verdict.

Exit status: 0 on success; summary mode exits 2 when the file holds no
span events; diff mode 1 on regressions and 2 on unusable input
(malformed files, truncated event buffers, a baseline phase missing
from the current snapshot); why-slow 2 without a ledger block, with
zero exemplars or with dropped ledger events; capacity 2 without
memory-ledger data.
"""

from __future__ import annotations

import argparse
import json
import sys

from mpit_tpu_torch.obs import baseline, memledger, trace
from mpit_tpu_torch.obs.core import gap_attribution, phase_stats


def _spans_from_chrome(doc: dict) -> tuple[dict, dict]:
    """(name -> [dur_s]), (counter label -> value) from a Chrome trace."""
    durs: dict[str, list[float]] = {}
    counters: dict[str, float] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "X":
            durs.setdefault(ev["name"], []).append(
                float(ev.get("dur", 0.0)) / 1e6
            )
        elif ev.get("ph") == "C":
            counters[ev["name"]] = float(ev.get("args", {}).get("value", 0.0))
    return durs, counters


def _spans_from_jsonl(lines) -> tuple[dict, dict]:
    """Same, from the MetricLogger-shaped JSONL export."""
    durs: dict[str, list[float]] = {}
    counters: dict[str, float] = {}
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if rec.get("event") == "span":
            durs.setdefault(rec["name"], []).append(float(rec["dur_s"]))
        elif rec.get("event") == "counter":
            counters[rec["name"]] = (
                counters.get(rec["name"], 0.0) + float(rec["value"])
            )
    return durs, counters


def _summarize(durs: dict) -> dict:
    """The live recorder's roll-up (obs.core.phase_stats — one shared
    definition), rounded for printing."""
    rounding = {"total_s": 4, "p50_s": 6, "p95_s": 6}
    return {
        name: {
            k: round(v, rounding[k]) if k in rounding else v
            for k, v in stats.items()
        }
        for name, stats in phase_stats(durs).items()
    }


def _main_diff(argv) -> int:
    """The ``diff`` subcommand: the perf-regression gate."""
    ap = argparse.ArgumentParser(
        prog="python -m mpit_tpu_torch.obs diff",
        description="Diff two obs.baseline phase snapshots; exit 1 on "
        "phase-time regressions beyond tolerance.",
    )
    ap.add_argument("baseline", help="baseline snapshot (obs.baseline JSON, "
                    "a raw summary dump, or BENCH_DETAIL.json)")
    ap.add_argument("current", help="current snapshot (same shapes)")
    ap.add_argument(
        "--tolerance-pct", type=float, default=10.0,
        help="allowed per-phase p50 growth before the gate trips (%%)",
    )
    ap.add_argument(
        "--workload", default=None,
        help="workload entry to read when a file is a BENCH_DETAIL.json",
    )
    args = ap.parse_args(argv)
    try:
        base = baseline.load(args.baseline, workload=args.workload)
        cur = baseline.load(args.current, workload=args.workload)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(json.dumps({"error": str(e)}))
        return 2
    # A snapshot whose recorder hit max_events reports percentiles over
    # a truncated prefix — gating on it would pass/fail on a clipped
    # buffer. Unusable input, same exit as a malformed file.
    truncated = {
        label: snap["dropped_events"]
        for label, snap in (("baseline", base), ("current", cur))
        if snap.get("dropped_events")
    }
    if truncated:
        print(json.dumps({
            "error": "snapshot(s) from a truncated event buffer — "
            "percentiles cover a clipped prefix; raise Recorder "
            "max_events and re-record",
            "dropped_events": truncated,
        }))
        return 2
    verdict = baseline.diff(base, cur, tolerance_pct=args.tolerance_pct)
    if verdict["missing_phases"]:
        # A phase present in the baseline but absent from the current
        # snapshot makes the comparison unusable, not clean: only the
        # intersection was compared, and the phase
        # that silently disappeared is exactly the one a gate must not
        # ignore. Same exit as truncated snapshots. (NEW phases are
        # fine — instrumentation growing is not a broken comparison.)
        print(json.dumps({
            "error": "baseline phase(s) missing from the current "
            "snapshot — the comparison covers only the intersection "
            "and cannot gate; re-record or prune the baseline",
            "missing_phases": verdict["missing_phases"],
        }))
        return 2
    print(json.dumps(verdict, indent=1))
    return 0 if verdict["ok"] else 1


def _main_why_slow(argv) -> int:
    """The ``why-slow`` subcommand: request-ledger forensics."""
    ap = argparse.ArgumentParser(
        prog="python -m mpit_tpu_torch.obs why-slow",
        description="Print the worst request-ledger exemplar's lifeline "
        "+ latency attribution from a ledger snapshot, a Server.stats() "
        "dump, or a BENCH_DETAIL.json with trace_forensics blocks.",
    )
    ap.add_argument("input", help="ledger snapshot / stats dump / "
                    "BENCH_DETAIL.json")
    ap.add_argument(
        "--top", type=int, default=1,
        help="how many exemplars to print, worst first",
    )
    args = ap.parse_args(argv)
    try:
        with open(args.input) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(json.dumps({"error": str(e)}))
        return 2
    exemplars, err = trace.collect_exemplars(doc)
    if err is not None:
        # Unusable input (the obs-diff rule): a ledger with dropped
        # events would misattribute — refuse, don't guess.
        print(json.dumps({"error": err}))
        return 2
    for i, ex in enumerate(exemplars[: max(args.top, 1)]):
        if i:
            print()
        print(trace.format_why_slow(ex))
    return 0


def _main_capacity(argv) -> int:
    """The ``capacity`` subcommand: the HBM memory-ledger verdict."""
    ap = argparse.ArgumentParser(
        prog="python -m mpit_tpu_torch.obs capacity",
        description="Print the byte-exact HBM capacity verdict (held "
        "decomposition, KV headroom, eviction candidates, conservation) "
        "from a MemLedger snapshot, a Server.stats() dump with a "
        "'memory' block, or a BENCH_DETAIL.json from a serve bench.",
    )
    ap.add_argument("input", help="memledger snapshot / stats dump / "
                    "BENCH_DETAIL.json")
    ap.add_argument(
        "--workload", default=None,
        help="which BENCH_DETAIL workload's memory block to read",
    )
    args = ap.parse_args(argv)
    try:
        with open(args.input) as f:
            doc = json.load(f)
        report = memledger.capacity_report(doc, workload=args.workload)
    except (OSError, json.JSONDecodeError, ValueError) as e:
        # Unusable input (the obs-diff rule): a capacity verdict over
        # a snapshot with no ledger data would be fabricated — refuse.
        print(json.dumps({"error": str(e)}))
        return 2
    print(memledger.format_capacity(report))
    return 0


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "diff":
        return _main_diff(argv[1:])
    if argv and argv[0] == "why-slow":
        return _main_why_slow(argv[1:])
    if argv and argv[0] == "capacity":
        return _main_capacity(argv[1:])
    if argv and argv[0] == "summary":
        argv = argv[1:]
    ap = argparse.ArgumentParser(
        prog="python -m mpit_tpu_torch.obs",
        description="Offline trace summary + app-path gap attribution.",
    )
    ap.add_argument(
        "trace",
        help="exported timeline: Chrome-trace .json or obs .jsonl",
    )
    ap.add_argument(
        "--top", type=int, default=20, help="max phases to print (by total_s)"
    )
    ap.add_argument(
        "--gap-only", action="store_true",
        help="print only the gap-attribution block",
    )
    args = ap.parse_args(argv)

    dropped = 0
    with open(args.trace) as f:
        head = f.read(1)
        f.seek(0)
        if head == "{" and args.trace.endswith(".jsonl"):
            durs, counters = _spans_from_jsonl(f)
        elif head == "{":
            # One JSON document => Chrome trace; a JSONL stream's first
            # char is also "{", so fall back to line records on failure.
            try:
                doc = json.load(f)
                durs, counters = _spans_from_chrome(doc)
                dropped = int(doc.get("dropped_events", 0))
            except json.JSONDecodeError:
                f.seek(0)
                durs, counters = _spans_from_jsonl(f)
        else:
            durs, counters = _spans_from_jsonl(f)

    if dropped:
        # export_chrome_trace marked this file as truncated: the phase
        # table below covers only the events that fit in the buffer.
        print(
            f"obs: WARNING: trace is truncated — the recorder dropped "
            f"{dropped} events; percentiles cover a clipped prefix",
            file=sys.stderr,
        )
    if not durs:
        print(json.dumps({"error": "no span events found", "file": args.trace}))
        return 2
    phases = _summarize(durs)
    gap = gap_attribution({"phases": phases})
    if args.gap_only:
        print(json.dumps({"gap_attribution": gap}, indent=1))
        return 0
    top = dict(
        sorted(phases.items(), key=lambda kv: -kv[1]["total_s"])[: args.top]
    )
    out = {"phases": top, "gap_attribution": gap}
    if counters:
        out["counters"] = {
            k: round(v, 1)
            for k, v in sorted(counters.items(), key=lambda kv: -kv[1])[:10]
        }
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
