"""mpit_tpu_torch's pure observability modules against the JAX package's.

The same inputs go through :mod:`mpit_tpu.obs` and
:mod:`mpit_tpu_torch.obs` and must give equal outputs: the sentinel's
report over one scripted series (warm-up, a spike, a sustained
degradation, prefetch starvation, an external note); the SLO monitor's
transitions and report at fixed ``now`` over a registry fed at fixed
times (quantile, rate and ratio targets, abstention, an idle stretch in
breach, ``finish``); the baseline gate's verdicts and the ``diff`` CLI's
exit codes; a recorder script's summary (phase labels, instants, the top
collectives, ``dropped_events``), ``gap_attribution``, Chrome-trace
events, JSONL records and traffic matrix; and ``CommModel``,
``collective_bytes`` and the ``modeled_*_seconds`` functions under
:class:`~mpit_tpu_torch.utils.ChipSpec` values equal to a JAX
``ChipSpec``'s. No test reads a clock: every time is passed in.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch

from mpit_tpu.obs import baseline as jbaseline
from mpit_tpu.obs import core as jcore
from mpit_tpu.obs import export as jexport
from mpit_tpu.obs.__main__ import main as jobs_main
from mpit_tpu.obs.sentinel import Sentinel as JSentinel
from mpit_tpu.obs.slo import SLO as JSLO
from mpit_tpu.obs.slo import SLOMonitor as JSLOMonitor
from mpit_tpu.obs.stream import StreamRegistry as JStreamRegistry
from mpit_tpu.utils import profiling as jprof
from mpit_tpu_torch import obs
from mpit_tpu_torch.obs import baseline, core, export
from mpit_tpu_torch.obs.__main__ import main as obs_main
from mpit_tpu_torch.obs.slo import SLO, SLOMonitor
from mpit_tpu_torch.obs.stream import StreamRegistry
from mpit_tpu_torch.utils import profiling


def _series(seed: int = 0):
    """A seeded step-time series: 20 steady steps near 10 ms, a 5x
    spike, 12 steps 60% slower (a durable slowdown), then recovery; and
    a prefetch wait that comes to dominate for 6 steps."""
    rng = np.random.default_rng(seed)
    steps = list(10e-3 * (1 + 0.01 * rng.standard_normal(20)))
    steps += [50e-3] + list(16e-3 * (1 + 0.01 * rng.standard_normal(12)))
    steps += list(10e-3 * (1 + 0.01 * rng.standard_normal(10)))
    waits = [0.5e-3] * len(steps)
    for i in range(30, 36):
        waits[i] = 30e-3
    return [float(v) for v in steps], waits


def _drive_sentinel(cls, rec_core):
    notes = []
    with rec_core.local_recorder(rec_core.Recorder()) as rec:
        s = cls(warmup=6, window=16, on_note=notes.append, max_anomalies=8)
        steps, waits = _series()
        for i, (st, w) in enumerate(zip(steps, waits)):
            s.observe_step(i, step_s=st, prefetch_wait_s=w)
        s.observe_phases(99, decode=0.01, prefill=None)
        s.note("slo_breach", "ttft_p95", 7, value=0.9, max_value=0.5)
        instants = [(e[1], e[5]) for e in rec.snapshot()["events"] if e[0] == "i"]
    return s.report(), notes, instants


def test_sentinel_report_equals_jax():
    mine = _drive_sentinel(obs.Sentinel, core)
    ref = _drive_sentinel(JSentinel, jcore)
    assert mine == ref
    report = mine[0]
    assert not report["clean"]
    assert {"spike", "sustained_degradation", "prefetch_starvation", "slo_breach"} <= set(
        report["anomaly_counts"])
    assert report.get("anomalies_truncated", 0) >= 0


def test_sentinel_phases_filter_equals_jax():
    out = []
    for cls in (obs.Sentinel, JSentinel):
        s = cls(phases=("decode",), warmup=3)
        for i, v in enumerate([1.0, 1.0, 1.0, 1.0, 9.0, 1.0]):
            s.observe_phases(i, decode=v, prefill=v)
        out.append(s.report())
    assert out[0] == out[1]
    assert set(out[0]["metrics"]) == {"decode"}


def _drive_slo(slo_cls, mon_cls, reg_cls, sentinel_cls):
    t = [0.0]
    reg = reg_cls(window_s=4.0, intervals=4, clock=lambda: t[0])
    targets = [
        slo_cls.ttft_p95(0.2),
        slo_cls.latency_p95(1.0),
        slo_cls.shed_rate(0.25),
        slo_cls(name="err_rate", metric="serve_errors", kind="rate", max_value=0.5),
    ]
    sentinel = sentinel_cls()
    mon = mon_cls(targets, reg, min_count=4, sentinel=sentinel)
    transitions = []
    rng = np.random.default_rng(3)
    for step in range(40):
        now = 0.25 * step
        t[0] = now
        slow = 12 <= step < 24
        for _ in range(2):
            reg.inc("serve_arrivals", t=now)
            reg.observe("request_ttft", float((0.5 if slow else 0.05) * (1 + 0.1 * rng.random())),
                        t=now)
            reg.observe("request_latency", float(0.3 + 0.01 * step), t=now)
        if 16 <= step < 20:
            reg.inc("serve_shed", 2.0, t=now)
            reg.inc("serve_errors", 3.0, t=now)
        transitions += mon.evaluate(now=now, tick=step)
    # An idle stretch in breach: abstaining keeps the clock running.
    transitions += mon.evaluate(now=10.5, tick=40)
    mon.finish(now=11.0)
    return transitions, mon.report(), sentinel.report(), mon.breached


def test_slo_monitor_equals_jax():
    mine = _drive_slo(SLO, SLOMonitor, StreamRegistry, obs.Sentinel)
    ref = _drive_slo(JSLO, JSLOMonitor, JStreamRegistry, JSentinel)
    assert mine == ref
    transitions, report, sent, breached = mine
    kinds = [(tr["event"], tr["slo"]) for tr in transitions]
    assert ("slo_breach", "ttft_p95") in kinds and ("slo_recovered", "ttft_p95") in kinds
    assert breached and not report["ok"]
    assert sent["anomaly_counts"]["slo_breach"] >= 2


def test_slo_validation_equals_jax():
    for cls in (SLO, JSLO):
        with pytest.raises(ValueError, match="kind"):
            cls(name="x", metric="m", max_value=1.0, kind="median")
        with pytest.raises(ValueError, match="denom_metric"):
            cls(name="x", metric="m", max_value=1.0, kind="ratio")
    for mon, reg in ((SLOMonitor, StreamRegistry), (JSLOMonitor, JStreamRegistry)):
        with pytest.raises(ValueError, match="duplicate"):
            mon([SLO.ttft_p95(1.0), SLO.ttft_p95(2.0)], reg())


def _snap(p50s, *, roof=None, memory=None, dropped=0, extra_phase=None):
    phases = {name: {"count": 10, "total_s": 10 * v, "p50_s": v, "p95_s": 1.5 * v}
              for name, v in p50s.items()}
    if extra_phase:
        phases[extra_phase] = {"count": 1, "total_s": 0.0, "p50_s": 0.0, "p95_s": 0.0}
    summ = {"phases": phases, "counters": {"serve_tokens": 100.0},
            "instants": {"slo_breach": 1}, "dropped_events": dropped}
    if roof:
        summ["roofline"] = {"phases": roof}
    return summ, memory


CASES = {
    "clean": (({"decode": 0.010, "prefill": 0.050}, {}), ({"decode": 0.0105, "prefill": 0.049}, {})),
    "regressed": (({"decode": 0.010}, {}), ({"decode": 0.013}, {})),
    "util_drop": (
        ({"decode": 0.010}, {"roof": {"decode": {"mfu_pct": 2.0, "hbm_util_pct": 40.0}}}),
        ({"decode": 0.010}, {"roof": {"decode": {"mfu_pct": 2.0, "hbm_util_pct": 20.0}}}),
    ),
    "memory_growth": (
        ({"decode": 0.010}, {"memory": {"held_peak_bytes": 1000, "kv_headroom_min_pct": 50.0,
                                        "platform": "cuda", "host_held_peak_bytes": 10,
                                        "restream_bytes": 5}}),
        ({"decode": 0.010}, {"memory": {"held_peak_bytes": 1500, "kv_headroom_min_pct": 40.0,
                                        "platform": "cuda", "host_held_peak_bytes": 30,
                                        "restream_bytes": 7}}),
    ),
    "missing_phase": (({"decode": 0.010, "prefill": 0.05}, {}), ({"decode": 0.010}, {})),
    "truncated": (({"decode": 0.010}, {"dropped": 3}), ({"decode": 0.010}, {})),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_baseline_diff_and_cli_exit_equal_jax(case, tmp_path):
    (b_p50, b_kw), (c_p50, c_kw) = CASES[case]
    docs = {}
    for tag, pkg in (("mine", baseline), ("jax", jbaseline)):
        pair = []
        for p50s, kw in ((b_p50, b_kw), (c_p50, c_kw)):
            summ, memory = _snap(p50s, **kw)
            pair.append(pkg.snapshot(summ, memory=memory, meta={"case": case}))
        docs[tag] = pair
    assert docs["mine"] == docs["jax"]
    base, cur = docs["mine"]
    assert baseline.diff(base, cur, tolerance_pct=10.0) == jbaseline.diff(
        base, cur, tolerance_pct=10.0)
    paths = []
    for i, d in enumerate((base, cur)):
        paths.append(str(tmp_path / f"{i}.json"))
        with open(paths[-1], "w") as f:
            json.dump(d, f)
    args = ["diff", *paths, "--tolerance-pct", "10"]
    rc = obs_main(args)
    assert rc == jobs_main(args)
    want = {"clean": 0, "regressed": 1, "util_drop": 1, "memory_growth": 1,
            "missing_phase": 2, "truncated": 2}[case]
    assert rc == want


def test_baseline_save_load_round_trip(tmp_path):
    summ, memory = _snap({"decode": 0.01})
    path = baseline.save(tmp_path / "b.json", summ, meta={"k": 1},
                         memory={"held_peak_bytes": 7, "platform": "cpu"})
    assert baseline.load(path) == jbaseline.load(path)
    bench = {"workloads": {"w": {"obs_baseline": baseline.snapshot(summ)}}}
    bp = tmp_path / "bench.json"
    bp.write_text(json.dumps(bench))
    assert baseline.load(bp, workload="w") == jbaseline.load(bp, workload="w")
    for pkg in (baseline, jbaseline):
        with pytest.raises(ValueError, match="workload"):
            pkg.load(bp)


def _record(core_mod):
    """One recorder script, timestamps fixed: spans at explicit times,
    counters (collective bytes, P2P bytes), gauges, a compile overlay,
    and instants (their times normalised by the caller)."""
    rec = core_mod.Recorder(max_events=12)
    rec._epoch = 0.0
    rec.add_span("step", 1.0, 1.5, {"grad_sync": "ring"})
    rec.add_span("step", 2.0, 2.25, {"grad_sync": "ring"})
    rec.add_span("prefetch_wait", 0.5, 0.6, None)
    rec.add_span("host_fence", 1.5, 1.9, {"why": "log", "lag": 2})
    rec.add_span("decode", 3.0, 3.01, {"attention": "kernel", "rids": [1, 2]})
    rec.add_span("compile", 3.0, 3.005, {"phase": "decode", "scope": "engine"})
    rec.add_instant("anomaly", {"kind": "spike", "step": 3})
    for src, dst, v in ((0, 1, 100.0), (1, 0, 40.0), (2, 1, 7.0), (0, 1, 5.0)):
        rec.add_counter("p2p_send_bytes", v, {"src": src, "dst": dst})
    for op, axis, v in (("psum", "data", 4e6), ("all_gather", "data", 1e6),
                        ("ppermute", "model", 2e6)):
        rec.add_counter("collective_bytes", v, {"op": op, "axis": axis})
    rec.add_gauge("slot_occupancy", 0.5, None)
    for i in range(8):  # past max_events: dropped and counted
        rec.add_span("queue_wait", 4.0 + i, 4.5 + i, {"rid": i})
    return rec


def _norm_events(events):
    """Instants carry the clock's time, and the counter samples sit at
    the trace's end, which an instant can set: those timestamps are
    normalised; every other field is compared as is."""
    out = []
    for ev in events:
        ev = dict(ev)
        if ev.get("ph") in ("i", "C"):
            ev["ts"] = ev["ph"]
        out.append(ev)
    return out


def test_recorder_summary_and_exports_equal_jax(tmp_path):
    mine, ref = _record(core), _record(jcore)
    assert mine.summary(top_collectives=2) == ref.summary(top_collectives=2)
    summ = mine.summary()
    assert summ["dropped_events"] == 3
    assert summ["collectives"][0] == {"op": "psum", "axis": "data", "wire_bytes": 4e6}
    assert mine.summary(since=3) == ref.summary(since=3)
    assert core.gap_attribution(summ) == jcore.gap_attribution(ref.summary())
    assert mine.counter_total("p2p_send_bytes") == ref.counter_total("p2p_send_bytes")
    assert sorted(mine.counter_items("p2p_send_bytes"), key=str) == sorted(
        ref.counter_items("p2p_send_bytes"), key=str)
    assert mine.event_count() == ref.event_count()
    assert _norm_events(export.chrome_trace_events(mine)) == _norm_events(
        jexport.chrome_trace_events(ref, pid=0))
    assert np.array_equal(export.traffic_matrix(recorder=mine),
                          jexport.traffic_matrix(recorder=ref))
    assert np.array_equal(export.traffic_matrix(4, recorder=mine),
                          jexport.traffic_matrix(4, recorder=ref))
    a, b = tmp_path / "mine.jsonl", tmp_path / "jax.jsonl"
    export.export_jsonl(a, mine)
    jexport.export_jsonl(b, ref)

    def rows(path):
        return [{k: ("instant" if k == "t0_s" and r.get("event") == "instant" else v)
                 for k, v in r.items()} for r in map(json.loads, path.read_text().splitlines())]

    assert rows(a) == rows(b)


def test_chrome_trace_file_and_summary_cli_equal_jax(tmp_path, capsys):
    paths = []
    for tag, core_mod, exp in (("mine", core, export), ("jax", jcore, jexport)):
        rec = _record(core_mod)
        path = tmp_path / f"{tag}.json"
        exp.export_chrome_trace(path, rec, extra_events=[{"ph": "i", "name": "x", "ts": 1.0,
                                                          "pid": 0, "tid": 0}])
        paths.append(path)
    docs = [json.loads(p.read_text()) for p in paths]
    assert _norm_events(docs[0]["traceEvents"]) == _norm_events(docs[1]["traceEvents"])
    assert docs[0]["dropped_events"] == docs[1]["dropped_events"] == 3
    capsys.readouterr()
    outs = []
    for main, argv in ((obs_main, ["summary", str(paths[0])]), (jobs_main, [str(paths[1])])):
        assert main(argv) == 0
        outs.append(json.loads(capsys.readouterr().out))
    assert outs[0] == outs[1]
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"traceEvents": []}))
    assert obs_main([str(empty)]) == jobs_main([str(empty)]) == 2


def test_thread_local_recorders_keep_their_events():
    seen = {}

    def work(name):
        with obs.local_recorder() as rec:
            obs.span_at(name, 1.0, 2.0)
            seen[name] = rec.summary()["phases"]

    threads = [threading.Thread(target=work, args=(n,)) for n in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert set(seen["a"]) == {"a"} and set(seen["b"]) == {"b"}
    assert obs.summary() == {} and obs.gap_attribution({}) == jcore.gap_attribution({})


def _chip(pkg_spec_cls):
    return pkg_spec_cls(name="card", peak_flops_bf16=9.89e14, hbm_bandwidth=3.35e12,
                        ici_bandwidth=4.5e11, dcn_bandwidth=5e10, ici_hop_latency=1e-6,
                        **({"peak_flops_f32": 6.7e13} if pkg_spec_cls is profiling.ChipSpec
                           else {}))


def test_comm_model_and_collective_models_equal_jax():
    mine, ref = _chip(profiling.ChipSpec), _chip(jprof.ChipSpec)
    params = {"w": torch.zeros(1000, 33), "b": torch.zeros(7, dtype=torch.bfloat16)}
    jparams = {"w": np.zeros((1000, 33), np.float32), "b": np.zeros(7, np.float16)}
    assert profiling.tree_bytes(params) == jprof.tree_bytes(jparams)
    for n, slices, scale in ((1, 1, 1.0), (4, 1, 1.0), (8, 2, 0.25), (256, 4, 1.0)):
        a = profiling.CommModel(params, n, num_slices=slices, wire_scale=scale)
        b = jprof.CommModel(jparams, n, num_slices=slices, wire_scale=scale)
        assert a.summary() == b.summary()
        assert a.grad_sync_bytes() == b.grad_sync_bytes()
        assert a.grad_sync_seconds(mine) == b.grad_sync_seconds(ref)
    for op in ("allreduce", "reduce_scatter", "all_gather", "alltoall", "broadcast"):
        assert profiling.collective_bytes(1e6, 8, op) == jprof.collective_bytes(1e6, 8, op)
    for fn in ("modeled_allreduce_seconds", "modeled_reduce_scatter_seconds",
               "modeled_all_gather_seconds"):
        for p in (1, 2, 8):
            assert getattr(profiling, fn)(3e7, p, chip=mine) == getattr(jprof, fn)(
                3e7, p, chip=ref)
    assert profiling.allreduce_gbps(1e9, 8, 0.5) == jprof.allreduce_gbps(1e9, 8, 0.5)
    assert profiling.roofline(1e12, 1e9, ici_bytes=1e8, chip=mine) == {
        **jprof.roofline(1e12, 1e9, ici_bytes=1e8, chip=ref)}
    proj = dict(chips=(8, 32, 256, 512), alltoall_payload_bytes=1e6, alltoall_group=8,
                alltoall_passes=4)
    assert profiling.scaling_projection(0.1, 64, params, chip=mine, **proj) == \
        jprof.scaling_projection(0.1, 64, jparams, chip=ref, **proj)
    with pytest.raises(ValueError, match="slices"):
        profiling.CommModel(params, 6, num_slices=4)


def test_h100_spec_is_the_data_sheet_and_the_only_card():
    spec = profiling.H100_SXM
    assert (spec.peak_flops_bf16, spec.peak_flops_f32, spec.hbm_bandwidth) == (
        989e12, 67e12, 3.35e12)
    assert set(profiling.KNOWN_CARDS.values()) == {spec}
    with pytest.raises(TypeError):
        profiling.ChipSpec()  # no default card


def test_step_timer_and_cpu_trace(tmp_path):
    timer = profiling.StepTimer()
    timer.start()
    for _ in range(3):
        timer.tick(torch.ones(2))
    summ = timer.summary()
    assert summ["steps"] == 2 and summ["total_s"] >= 0
    with pytest.raises(RuntimeError, match="before start"):
        profiling.StepTimer().tick()
    with profiling.trace(str(tmp_path / "t"), cuda=False) as info:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert info["device_events"] == 0
    assert json.loads(open(info["path"]).read())["traceEvents"]


def test_gpt2_cli_returns_a_sentinel_report():
    from mpit_tpu_torch.asyncsgd import runner
    from mpit_tpu_torch.asyncsgd.gpt2 import main as gpt2_main

    out = gpt2_main(["--device", "cpu", "--steps", "6", "--vocab-size", "64", "--seq-len", "16",
                     "--num-layers", "2", "--num-heads", "2", "--d-model", "32",
                     "--log-every", "2", "--sentinel", "true"])
    assert out["sentinel"]["metrics"]["step"]["count"] == 6
    assert out["sentinel"]["metrics"]["prefetch_wait"]["count"] == 6
    roof = out["roofline"]["phases"]["step"]
    assert roof["platform"] == "cpu" and roof["executions"] == 5
    assert not any(k.endswith("_pct") for k in roof)
    assert out["comm"]["num_devices"] == 1
    # Only the data slice's flags still wait.
    assert set(runner.LATER_FLAGS) == {"native", "prefetch_workers", "prefetch_max_depth"}
