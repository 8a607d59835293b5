"""mpit_tpu_torch's open-loop load harness against the JAX package's.

``serve/loadgen.py`` is a numpy copy of :mod:`mpit_tpu.serve.loadgen`:
for the same spec, vocabulary, duration and seed the trace must be
bit-equal (times, prompts, shared prefixes, classes, tenants, priorities
and targets), and so must ``split_arrivals`` and ``parse_load_spec``.
``Server.run_timed`` over a short trace answers every admitted request
with ``drain=True``; ``max_queue`` sheds and does not raise. The serve
CLI runs ``--loadgen`` with ``--policy`` and ``--kv-host-pages`` on the
CPU; the serving obs flags (SLOs, sentinel, trace) drive one Server,
so beside ``--fleet`` they refuse.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from mpit_tpu.serve import loadgen as jlg
from mpit_tpu_torch.models import GPT2, GPT2Config
from mpit_tpu_torch.serve import Engine, Request, Server, loadgen
from mpit_tpu_torch.serve.__main__ import main

SPECS = [
    "rate=8",
    "rate=40,process=bursty,on_fraction=0.25,mean_on_s=0.3,tenants=4",
    "rate=12,prompt_min=2,prompt_max=9,new_min=1,new_max=5,prefix=6",
    "rate=20,tenants=3,priority=1,ttft_target=0.25",
    "rate=5,process=bursty,on_fraction=1.0,prefix=3,priority=2",
]
BAD_SPECS = ["", "rate=0", "rate=8,process=spiky", "rate=8,foo=1", "rate=8,oops",
             "rate=8,on_fraction=0", "rate=8,tenants=-1", "rate=8,prompt_min=0"]


def _trace(mod, spec, **kw):
    out = []
    for a in mod.generate_arrivals(spec, **kw):
        r = a.request
        out.append((a.t, a.klass, r.rid, list(r.prompt), r.max_new_tokens, r.temperature,
                    r.top_k, r.eos_id, r.tenant, r.priority, r.ttft_target_s))
    return out


@pytest.mark.parametrize("text", SPECS)
@pytest.mark.parametrize("seed", [0, 7])
def test_trace_bit_equal(text, seed):
    """Same spec text, vocabulary, duration and seed: the same trace."""
    kw = dict(vocab_size=97, duration_s=3.0, seed=seed, eos_id=5)
    want = _trace(jlg, jlg.parse_load_spec(text), **kw)
    got = _trace(loadgen, loadgen.parse_load_spec(text), **kw)
    assert got == want and len(got) > 0


def test_mixture_and_sampling_trace_bit_equal():
    """A programmatic three-class mixture with nested prefixes, per-class
    priorities and targets, sampling settings and a request cap."""
    def spec(mod):
        classes = (
            mod.RequestClass("chat", weight=3.0, prompt_len=(1, 4), max_new_tokens=(2, 6),
                             prefix_len=5, priority=0, ttft_target_s=0.05),
            mod.RequestClass("doc", weight=1.0, prompt_len=(8, 12), max_new_tokens=(10, 20),
                             prefix_len=9, priority=1),
            mod.RequestClass("raw", weight=0.5, prompt_len=(3, 3), max_new_tokens=(1, 1)),
        )
        return mod.LoadSpec(rate=30.0, process="bursty", tenants=2, classes=classes,
                            temperature=0.7, top_k=5)

    kw = dict(vocab_size=50, duration_s=5.0, max_requests=40, seed=3)
    want = _trace(jlg, spec(jlg), **kw)
    got = _trace(loadgen, spec(loadgen), **kw)
    assert got == want and len(got) == 40


@pytest.mark.parametrize("shards", [1, 3])
def test_split_arrivals_bit_equal(shards):
    kw = dict(vocab_size=64, duration_s=2.0, seed=1)
    jt = jlg.generate_arrivals(jlg.parse_load_spec(SPECS[1]), **kw)
    tt = loadgen.generate_arrivals(loadgen.parse_load_spec(SPECS[1]), **kw)
    want = [[a.request.rid for a in s] for s in jlg.split_arrivals(jt, shards, seed=4)]
    got = [[a.request.rid for a in s] for s in loadgen.split_arrivals(tt, shards, seed=4)]
    assert got == want
    with pytest.raises(ValueError, match="shards"):
        loadgen.split_arrivals(tt, 0)


@pytest.mark.parametrize("text", SPECS)
def test_parse_load_spec_equal(text):
    want = dataclasses.asdict(jlg.parse_load_spec(text))
    assert dataclasses.asdict(loadgen.parse_load_spec(text)) == want


@pytest.mark.parametrize("text", BAD_SPECS)
def test_parse_load_spec_refusals_equal(text):
    """Each bad spec raises ValueError in both packages, with the same
    message."""
    with pytest.raises(ValueError) as want:
        jlg.parse_load_spec(text)
    with pytest.raises(ValueError) as got:
        loadgen.parse_load_spec(text)
    assert str(got.value) == str(want.value)


def test_generate_arrivals_refuses_empty_window():
    with pytest.raises(ValueError, match="duration_s"):
        loadgen.generate_arrivals(loadgen.LoadSpec(rate=1.0), vocab_size=8, duration_s=0)


CFG = GPT2Config.tiny(vocab_size=64, max_seq_len=64, num_layers=2, num_heads=2,
                      d_model=32, dtype=torch.float32)


@pytest.fixture(scope="module")
def state():
    return GPT2(CFG, generator=torch.Generator().manual_seed(0)).state_dict()


def _engine(state, **kw):
    return Engine(CFG, state, device="cpu", slots=2, max_len=48, prefill_len=24, **kw)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_run_timed_drains_every_admitted_request(state, paged):
    """A 0.5 s open-loop trace at 40 req/s through ``run_timed`` with
    ``drain=True``: every request is answered, with its token count."""
    kw = dict(kv_pages=12, kv_page_size=8, prefill_chunk=4) if paged else {}
    spec = loadgen.parse_load_spec("rate=40,prompt_min=2,prompt_max=10,new_min=2,new_max=8")
    arrivals = loadgen.generate_arrivals(spec, vocab_size=64, duration_s=0.5, seed=2)
    server = Server(_engine(state, **kw))
    done = server.run_timed(arrivals, duration=0.5, drain=True)
    want = {a.request.rid: a.request.max_new_tokens for a in arrivals}
    assert {c.rid: len(c.tokens) for c in done} == want
    st = server.stats()
    assert not st["truncated"] and st["shed"] == 0 and st["shed_causes"] == {}


def test_max_queue_sheds_without_raising(state):
    """Past ``max_queue`` queued requests, arrivals are shed (counted by
    cause, in the stream registry too) and the rest complete."""
    from mpit_tpu_torch.obs.stream import StreamRegistry

    reg = StreamRegistry()
    server = Server(_engine(state), stream=reg, max_queue=2)
    ok = [server.submit(Request(rid=i, prompt=[1, 2, 3], max_new_tokens=2)) for i in range(5)]
    assert ok == [True, True, False, False, False]
    server.run()
    st = server.stats()
    assert st["requests_completed"] == 2 and st["shed"] == 3
    assert st["shed_causes"] == {"queue_full": 3}
    assert st["requests_shed"] == {"total": 3, "shed_queue_full": 3,
                                   "shed_admission_projection": 0}
    assert reg.counter_total("serve_shed") == 3 == reg.counter_total("serve_shed_queue_full")
    assert reg.counter_total("serve_arrivals") == 5
    assert reg.counter_total("serve_completed") == 2
    with pytest.raises(ValueError, match="max_queue"):
        Server(_engine(state), max_queue=0)


def test_stream_registry_feed(state):
    """The registry gets the JAX package's series names."""
    from mpit_tpu_torch.obs.stream import StreamRegistry

    reg = StreamRegistry()
    server = Server(_engine(state, kv_pages=12, kv_page_size=8, prefill_chunk=4), stream=reg)
    for i in range(3):
        server.submit(Request(rid=i, prompt=[1, 2, 3, 4, 5], max_new_tokens=3))
    server.run()
    ws = reg.window_stats()
    assert {"request_ttft", "request_latency", "queue_wait", "prefill_tick",
            "decode_tick"} <= set(ws["histograms"])
    assert ws["histograms"]["request_ttft"]["count"] == 3
    assert {"serve_arrivals", "serve_completed", "serve_tokens"} <= set(ws["rates"])
    assert reg.counter_total("serve_tokens") == 6  # 3 a request, the first from prefill
    assert {"queue_depth", "slot_occupancy", "kv_pool_occupancy"} <= set(ws["gauges"])


CLI = ["--device", "cpu", "--model", "tiny", "--slots", "2", "--max-len", "64",
       "--prefill-len", "32", "--stats-interval", "0"]


def test_cli_open_loop_policy_host_tier(capsys):
    """``--loadgen`` with ``--policy`` and ``--kv-host-pages`` on the CPU:
    every arrival answered, the policy block and the host tier's keys in
    the JSON, the load block and the windows beside them."""
    out = main([*CLI, "--kv-pages", "16", "--kv-page-size", "8", "--prefill-chunk", "8",
                "--loadgen", "rate=30,prompt_min=4,prompt_max=12,new_min=2,new_max=10,"
                "priority=1,tenants=2", "--duration", "0.4", "--policy",
                "admission=0,min_samples=1", "--kv-host-pages", "16",
                "--stats-interval", "0.1"])
    assert out["load"]["arrivals"] == out["requests_completed"] > 0
    assert out["load"]["shed"] == 0 and not out["truncated"]
    assert out["policy"]["queued"] == 0 and "preemptions" in out
    assert out["kv_host_pages"] == 16 and "host_spilled_pages" in out
    assert set(out["tenants"]) <= {"t0", "t1"}
    assert out["window_stats"]["histograms"]["request_ttft"]["count"] >= 1
    assert "ttft p50/p95=" in capsys.readouterr().err


def test_cli_open_loop_dense_fifo():
    """``--loadgen`` on the dense engine, FIFO, with ``--max-queue``."""
    out = main([*CLI, "--loadgen", "rate=25,prompt_min=2,prompt_max=8,new_min=2,new_max=6",
                "--duration", "0.3", "--max-queue", "8"])
    assert out["load"]["arrivals"] == out["requests_completed"] + out["load"]["shed"]
    assert "policy" not in out and out["shed"] == out["load"]["shed"]


@pytest.mark.parametrize("flags,match", [
    (["--fleet", "prefill=1,decode=1", "--slo-ttft-p95", "0.5"], "fleet's router"),
    (["--fleet", "prefill=1,decode=1", "--slo-latency-p95", "0.5"], "fleet's router"),
    (["--fleet", "prefill=1,decode=1", "--slo-shed-rate", "0.1"], "fleet's router"),
    (["--fleet", "prefill=1,decode=1", "--sentinel", "true"], "fleet's router"),
    (["--fleet", "prefill=1,decode=1", "--trace", "t.json"], "fleet's router"),
    (["--loadgen", "rate=8,new_max=60"], "max-len"),
    (["--kv-pages", "3", "--kv-page-size", "8", "--loadgen",
      "rate=8,prompt_max=16,new_max=16"], "kv-pages 3"),
    (["--loadgen", "rate=8,bogus=1"], "bogus"),
    (["--fleet", "prefill=1,decode=1", "--loadgen", "rate=8"], "fleet's router"),
], ids=["slo_ttft", "slo_latency", "slo_shed", "sentinel", "trace", "max_len", "pool",
        "bad_spec", "fleet"])
def test_cli_refusals(flags, match):
    """The serving obs flags are the single Server's: beside ``--fleet``
    they refuse; a load the engine could not take refuses before the
    window, a model or a worker is built."""
    with pytest.raises(SystemExit, match=match):
        main([*CLI, *flags])
