"""mpit_tpu_torch's request forensics and serving obs against the JAX
package's.

- ``Server(ledger=, sentinel=, slo=)`` on the port and on JAX, fed the
  same scripted submissions over the same converted weights (one
  module-scoped tiny JAX engine: 2 layers, width 64, f32, reference
  attention): greedy tokens are identical with obs on and with it off,
  and every request's ledger events — kinds in order, with their
  attributes less the clock's (``t``, ``dur_s``) — are equal, on the
  dense cache, the paged pool with a shared prefix and COW copies, and a
  preemption resumed by recompute under the policy. (The host tier's
  restream resume is left out: the port resumes it with a decode tick
  where JAX prefills a one-row chunk, by design — see
  ``serve/scheduler.py``.)
- :func:`format_why_slow`, :func:`exemplar_trace_events` and
  :func:`collect_exemplars` equal JAX's on the same exemplars.
- The CLI: ``serve --device cpu --model tiny`` with ``--slo-ttft-p95``,
  ``--sentinel true`` and ``--trace`` returns the
  ``roofline`` (labelled, no percentage on the CPU), ``sentinel``,
  ``slo``, ``memory`` and ``exemplars`` blocks and writes a trace with
  ``prefill`` and ``decode`` spans and the exemplars' ledger instants;
  then ``python -m mpit_tpu_torch.obs`` summary, ``why-slow``,
  ``capacity`` and ``diff`` on those files exit as JAX's ``python -m
  mpit_tpu.obs`` does on them.
- A trace context ships over the port's compat layer byte for byte.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.models.gpt2 import GPT2 as JGPT2
from mpit_tpu.models.gpt2 import GPT2Config as JConfig
from mpit_tpu.obs import trace as jtrace
from mpit_tpu.obs.__main__ import main as jobs_main
from mpit_tpu.obs.sentinel import Sentinel as JSentinel
from mpit_tpu.obs.slo import SLO as JSLO
from mpit_tpu.obs.slo import SLOMonitor as JSLOMonitor
from mpit_tpu.obs.stream import StreamRegistry as JStreamRegistry
from mpit_tpu.serve import Engine as JEngine
from mpit_tpu.serve import Request as JRequest
from mpit_tpu.serve import SchedulingPolicy as JPolicy
from mpit_tpu.serve import Server as JServer
from mpit_tpu_torch import compat, obs
from mpit_tpu_torch.models import GPT2Config
from mpit_tpu_torch.obs import baseline, trace
from mpit_tpu_torch.obs.__main__ import main as obs_main
from mpit_tpu_torch.serve import Engine, Request, SchedulingPolicy, Server, params_from_jax
from mpit_tpu_torch.serve.__main__ import main as serve_main

JCFG = JConfig.tiny(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=2, d_model=64,
                    dtype=jnp.float32)
TCFG = GPT2Config.tiny(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=2, d_model=64,
                       dtype=torch.float32)
GEOM = dict(slots=2, max_len=32, prefill_len=16)
PAGED = dict(GEOM, kv_pages=24, kv_page_size=4, prefill_chunk=4)
SYSP = [11, 12, 13, 14, 15]
CLOCK_KEYS = ("t", "dur_s")


@pytest.fixture(scope="module")
def params():
    p = jax.jit(JGPT2(JCFG).init)(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    p = jax.tree.map(np.asarray, p)
    return {"jax": p, "torch": params_from_jax(p)}


@pytest.fixture(scope="module")
def jax_engines(params):
    """One JAX engine per geometry, reset between runs."""
    return {
        "dense": JEngine(JCFG, params["jax"], decode_attention="reference", **GEOM),
        "paged": JEngine(JCFG, params["jax"], decode_attention="reference", **PAGED),
    }


def _script(server, req_cls, scenario):
    """Submit, tick and run one scripted scenario; return the tokens."""
    if scenario == "preempt":
        server.submit(req_cls(rid="v", prompt=SYSP + [40, 41], max_new_tokens=9, priority=1))
        server.run(max_ticks=5)
        server._preempt(next(iter(server.live)))
        server.submit(req_cls(rid="w", prompt=[7, 8], max_new_tokens=4))
    else:
        server.submit(req_cls(rid="a", prompt=SYSP + [20, 21], max_new_tokens=12))
        server.submit(req_cls(rid="b", prompt=SYSP + [30], max_new_tokens=9))
        server.run(max_ticks=4)  # a's prefix is registered before c arrives
        server.submit(req_cls(rid="c", prompt=SYSP + [20, 21], max_new_tokens=5))
        server.submit(req_cls(rid="d", prompt=[60, 2, 2, 1, 9], max_new_tokens=3))
    return {c.rid: c.tokens for c in server.run()}


def _serve(pkg, engine, scenario, *, with_obs: bool):
    if pkg == "jax":
        engine.reset()
        mods = (JServer, JRequest, JPolicy, jtrace.Ledger, JSentinel, JSLO, JSLOMonitor,
                JStreamRegistry)
    else:
        mods = (Server, Request, SchedulingPolicy, trace.Ledger, obs.Sentinel, obs.SLO,
                obs.SLOMonitor, obs.StreamRegistry)
    server_cls, req_cls, pol_cls, ledger_cls, sent_cls, slo_cls, mon_cls, reg_cls = mods
    kw = {"policy": pol_cls()} if scenario == "preempt" else {}
    ledger = None
    if with_obs:
        reg = reg_cls()
        sentinel = sent_cls(phases=("decode", "prefill"), warmup=2)
        ledger = ledger_cls(mode="full", exemplar_k=16)
        kw.update(sentinel=sentinel, stream=reg, ledger=ledger,
                  slo=mon_cls([slo_cls.ttft_p95(10.0)], reg, sentinel=sentinel))
    server = server_cls(engine, **kw)
    tokens = _script(server, req_cls, scenario)
    return tokens, ledger, server.stats()


def _events(ledger):
    out = {}
    for ex in ledger.exemplars():
        out[ex["rid"]] = [
            (kind, {k: v for k, v in attrs.items() if k not in CLOCK_KEYS})
            for kind, _t, attrs in ex["events"]
        ]
    return out


@pytest.mark.parametrize("scenario,geom", [("stream", "dense"), ("stream", "paged"),
                                           ("preempt", "paged")])
def test_served_events_and_tokens_equal_jax(params, jax_engines, scenario, geom):
    kw = GEOM if geom == "dense" else PAGED
    eng = Engine(TCFG, params["torch"], device="cpu", decode_attention="reference", **kw)
    mine, ledger, stats = _serve("torch", eng, scenario, with_obs=True)
    eng.reset()
    plain, _, _ = _serve("torch", eng, scenario, with_obs=False)
    ref, jledger, jstats = _serve("jax", jax_engines[geom], scenario, with_obs=True)
    assert mine == plain == ref
    assert _events(ledger) == _events(jledger)
    assert ledger.counts == jledger.counts
    assert stats["ledger"]["retired"] == jstats["ledger"]["retired"]
    assert stats["slo"]["ok"] and "sentinel" in stats
    kinds = {k for evs in _events(ledger).values() for k, _ in evs}
    want = {"slot_bind", "prefill_chunk", "decode_tick", "retire"}
    if geom == "paged" and scenario == "stream":
        want.add("cow_copy")
    if scenario == "preempt":
        want |= {"admission", "preempt_park", "preempt_resume"}
    assert want <= kinds


def test_why_slow_rendering_equals_jax(params, jax_engines):
    _, jledger, jstats = _serve("jax", jax_engines["paged"], "stream", with_obs=True)
    exemplars = jledger.exemplars()
    assert exemplars
    for ex in exemplars:
        assert trace.format_why_slow(ex) == jtrace.format_why_slow(ex)
        assert trace.exemplar_trace_events(ex, pid=1, tid=3) == jtrace.exemplar_trace_events(
            ex, pid=1, tid=3)
    for doc in (jstats, jledger.snapshot(), {"workloads": {"w": {"trace_forensics": {
            "exemplars": exemplars, "dropped_events": 0}}}}, {"phases": {}},
            {"exemplars": [], "dropped_events": 0},
            {"exemplars": exemplars, "dropped_events": 2}):
        assert trace.collect_exemplars(doc) == jtrace.collect_exemplars(doc)


def test_serve_cli_obs_outputs_and_obs_cli_exits_equal_jax(tmp_path, capsys):
    tr, base = tmp_path / "run.json", tmp_path / "base.json"
    out = serve_main([
        "--device", "cpu", "--model", "tiny", "--requests", "6", "--max-new-tokens", "5",
        "--slots", "2", "--kv-pages", "32", "--kv-page-size", "8", "--prefill-chunk", "4",
        "--slo-ttft-p95", "0.5", "--sentinel", "true", "--trace", str(tr),
    ])
    assert out["requests_completed"] == 6 and out["trace"] == str(tr)
    phases = out["roofline"]["phases"]
    assert {"prefill", "decode"} <= set(phases)
    for entry in phases.values():
        assert entry["platform"] == "cpu" and entry["source"] == "analytic"
        assert not any(k.endswith("_pct") for k in entry)
    assert set(out["sentinel"]) >= {"clean", "anomaly_counts", "metrics"}
    assert out["slo"]["targets"]["ttft_p95"]["max_value"] == 0.5
    memory = out["memory"]
    assert memory["source"] == "memledger" and memory["conservation"]["ok"]
    assert memory["reconciliation"]["device_bytes"] is None
    assert out["exemplars"] and out["worker_id"] == "single"
    doc = json.loads(tr.read_text())
    names = {ev["name"] for ev in doc["traceEvents"] if ev.get("ph") == "X"}
    assert {"prefill", "decode", "request_latency"} <= names
    assert any(ev["name"].startswith("ledger:") for ev in doc["traceEvents"])
    stats = tmp_path / "out.json"
    stats.write_text(json.dumps(out))
    # A baseline snapshot of the run (the diff gate's input) from its output.
    baseline.save(base, {"phases": out["obs_summary"], "roofline": out["roofline"]},
                  memory=out["memory"])
    junk = tmp_path / "junk.json"
    junk.write_text(json.dumps({"nothing": 1}))
    cases = [
        (["summary", str(tr)], [str(tr)], 0),
        (["why-slow", str(stats)], ["why-slow", str(stats)], 0),
        (["capacity", str(stats)], ["capacity", str(stats)], 0),
        (["diff", str(base), str(base)], ["diff", str(base), str(base)], 0),
        (["why-slow", str(junk)], ["why-slow", str(junk)], 2),
        (["capacity", str(junk)], ["capacity", str(junk)], 2),
        (["diff", str(base), str(junk)], ["diff", str(base), str(junk)], 2),
    ]
    for argv, jargv, want in cases:
        capsys.readouterr()
        rc = obs_main(argv)
        mine = capsys.readouterr().out
        assert rc == jobs_main(jargv) == want, argv
        assert mine == capsys.readouterr().out, argv


def test_serve_cli_open_loop_with_slo_and_sentinel():
    out = serve_main([
        "--device", "cpu", "--model", "tiny", "--max-len", "64", "--prefill-len", "16",
        "--loadgen", "rate=20,prompt_max=8,new_min=2,new_max=6", "--duration", "0.3",
        "--slo-ttft-p95", "1e-9", "--slo-shed-rate", "0.5", "--sentinel", "true",
        "--stats-interval", "0",
    ])
    assert out["load"]["arrivals"] == out["requests_completed"]
    assert set(out["slo"]["targets"]) == {"ttft_p95", "shed_rate"}
    assert out["roofline"]["phases"]["decode"]["explicit_components"] == ["hbm_bytes"]


def test_trace_context_ships_over_compat_byte_for_byte():
    ctx = trace.TraceContext(rid="r-7", trace_id="abc123", origin_rank=0, seq=4)

    def main(rank):
        if rank == 0:
            trace.send_trace_context(ctx, 1)
            return None
        return trace.recv_trace_context(0).to_bytes()

    results = compat.run(main, 2, pass_rank=True, timeout=30)
    assert results[1] == ctx.to_bytes() == jtrace.TraceContext(
        rid="r-7", trace_id="abc123", origin_rank=0, seq=4).to_bytes()
