"""mpit_tpu_torch's disaggregated serving fleet, on the CPU.

- The port's fleet (router → prefill worker → KV shipment over
  ``Comm_dup("fleet-kv")`` → decode worker) gives, for every request,
  the greedy tokens of the port's single-engine ``Server``: the dense
  fleet, the paged int8 fleet, and a fleet whose decode worker a seeded
  ``FaultPlan`` kills mid-job (its requests re-queue to the survivor).
- The whole slice against the JAX package: the port's ``run_fleet`` on
  weights converted from JAX's gives JAX's ``run_fleet`` completions,
  token for token (f32), with and without the kill.
- Shipment bytes ride the flight recorder's merged P2P matrix.
- ``--fleet`` through the CLI with ``--device cpu``; the fleet spec
  parser against JAX's.
- The obs layers the fleet stands on (stream sketch, TTFT projector,
  ledger, snapshot serialization, skew and matrix merge) against JAX's.

All parity runs use the f32 tiny config of the JAX package's fleet test
(slots 2, max_len 32, prefill_len 8), with its liveness settings
(heartbeat 0.05 s; lease 5 s, or 0.75 s where a kill must be noticed);
every fleet runs under a ``job_timeout_s``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.models.gpt2 import GPT2 as JGPT2
from mpit_tpu.models.gpt2 import GPT2Config as JConfig
from mpit_tpu.obs import aggregate as jagg
from mpit_tpu.obs.stream import StreamRegistry as JRegistry
from mpit_tpu.obs.trace import Ledger as JLedger
from mpit_tpu.serve import Engine as JEngine
from mpit_tpu.serve import Request as JRequest
from mpit_tpu.serve import parse_fleet_spec as j_parse_fleet_spec
from mpit_tpu.serve import run_fleet as j_run_fleet
from mpit_tpu.serve.policy import TTFTProjector as JProjector
from mpit_tpu_torch.compat import FaultPlan
from mpit_tpu_torch.models import GPT2Config
from mpit_tpu_torch.obs import aggregate as tagg
from mpit_tpu_torch.obs.stream import StreamRegistry
from mpit_tpu_torch.obs.trace import Ledger
from mpit_tpu_torch.serve import (
    Engine,
    FleetConfig,
    Request,
    Server,
    TTFTProjector,
    params_from_jax,
    parse_fleet_spec,
    run_fleet,
)
from mpit_tpu_torch.serve import __main__ as serve_cli

JCFG = JConfig.tiny(
    vocab_size=64, max_seq_len=64, num_layers=2, num_heads=2, d_model=32,
    dtype=jnp.float32,
)
TCFG = GPT2Config.tiny(
    vocab_size=64, max_seq_len=64, num_layers=2, num_heads=2, d_model=32,
    dtype=torch.float32,
)
PROMPTS = [[5, 9, 3], [7], [1, 2, 3, 4, 5], [9, 9], [3, 1], [60, 2, 2, 1]]
MAX_NEW = [6, 4, 8, 3, 5, 7]
DENSE = dict(slots=2, max_len=32, prefill_len=8)
PAGED_INT8 = dict(slots=2, max_len=40, prefill_len=8, kv_pages=24,
                  kv_page_size=4, kv_dtype="int8", decode_attention="reference",
                  prefill_chunk=4)
LIVE = dict(heartbeat_s=0.05, lease_s=5.0, job_timeout_s=60.0)


def _requests(cls=Request):
    return [
        cls(rid=f"r{i}", prompt=p, max_new_tokens=n)
        for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW))
    ]


@pytest.fixture(scope="module")
def params():
    p = jax.jit(JGPT2(JCFG).init)(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32)
    )["params"]
    p = jax.tree.map(np.asarray, p)
    return {"jax": p, "torch": params_from_jax(p)}


def _factory(state, geo):
    return lambda role, rank: Engine(TCFG, state, device="cpu", **geo)


def _server_tokens(state, geo):
    server = Server(Engine(TCFG, state, device="cpu", **geo))
    for r in _requests():
        server.submit(r)
    return {str(c.rid): list(c.tokens) for c in server.run()}


@pytest.fixture(scope="module")
def server_tokens(params):
    """The oracle: the port's single-engine dense Server."""
    return _server_tokens(params["torch"], DENSE)


@pytest.fixture(scope="module")
def jax_fleet_tokens(params):
    """JAX's fleet on the same weights (the whole-slice yardstick)."""
    out = j_run_fleet(
        lambda role, rank: JEngine(JCFG, params["jax"], **DENSE),
        _requests(JRequest), prefill=1, decode=2, **LIVE,
    )
    assert out["shed"] == []
    return out["completed"]


def test_dense_fleet_equals_server_and_jax_fleet(params, server_tokens, jax_fleet_tokens):
    out = run_fleet(_factory(params["torch"], DENSE), _requests(),
                    prefill=1, decode=2, **LIVE)
    assert out["shed"] == []
    assert out["completed"] == server_tokens
    assert out["completed"] == jax_fleet_tokens
    router = out["router"]
    assert router["evictions"] == 0 and router["requeues"] == 0
    assert router["ledger_counts"]["fleet_assign"] == len(PROMPTS)
    assert router["ledger_counts"]["fleet_done"] == len(PROMPTS)
    pf = next(w for w in out["workers"] if w["role"] == "prefill")
    assert pf["processed"] == len(PROMPTS)
    # f32 rows [2 layers, length, 2 heads, 16] for k and v.
    assert pf["ship_bytes"] == sum(2 * 2 * len(p) * 2 * 16 * 4 for p in PROMPTS)
    assert pf["ledger_counts"]["kv_ship_send"] == len(PROMPTS)
    # Shipment bytes ride the flight recorder: the prefill rank's row
    # toward the decode ranks covers the payload (control frames add).
    matrix = out["flight"]["p2p_bytes"]
    assert sum(matrix[1][d] for d in (2, 3)) >= pf["ship_bytes"]
    assert sum(w["completed"] for w in out["workers"]
               if w["role"] == "decode") == len(PROMPTS)
    assert set(out["flight"]["record"]["ranks"]) == {0, 1, 2, 3}


def test_decode_worker_kill_requeues_and_equals_jax(params, server_tokens,
                                                    jax_fleet_tokens):
    """A decode worker dies mid-job; its lease expires and the router
    re-queues its in-flight requests to the survivor: every request
    still gets the single engine's (and JAX's fleet's) tokens."""
    plan = FaultPlan(seed=0, kill_at={3: 2})
    out = run_fleet(_factory(params["torch"], DENSE), _requests(),
                    prefill=1, decode=2, heartbeat_s=0.05, lease_s=0.75,
                    fault_plan=plan, job_timeout_s=60.0)
    assert out["fault_events"] == (("kill", 3, 2),)
    killed = next(w for w in out["workers"] if w["rank"] == 3)
    assert killed["killed"] is True
    router = out["router"]
    assert router["evictions"] >= 1 and router["requeues"] >= 1
    assert any(e[0] == "evicted" and e[1] == 3 for e in router["events"])
    assert out["completed"] == server_tokens
    assert out["completed"] == jax_fleet_tokens


def test_paged_int8_fleet_equals_server(params):
    want = _server_tokens(params["torch"], PAGED_INT8)
    out = run_fleet(_factory(params["torch"], PAGED_INT8), _requests(),
                    prefill=1, decode=2, **LIVE)
    assert out["completed"] == want
    pf = next(w for w in out["workers"] if w["role"] == "prefill")
    # int8 rows + one f32 scale per (row, head), k and v.
    assert pf["ship_bytes"] == sum(2 * 2 * len(p) * 2 * (16 + 4) for p in PROMPTS)


def test_unique_rids_enforced(params):
    dup = [Request(rid="same", prompt=[5], max_new_tokens=2),
           Request(rid="same", prompt=[7], max_new_tokens=2)]
    with pytest.raises(ValueError, match="unique rids"):
        run_fleet(_factory(params["torch"], DENSE), dup, prefill=1, decode=1,
                  job_timeout_s=30.0)


def test_fleet_cli_on_the_cpu():
    assert not hasattr(serve_cli, "_LATER_SLICES")  # no flag waits for a later slice
    out = serve_cli.main([
        "--fleet", "prefill=1,decode=2,lease_s=5.0,job_timeout_s=60",
        "--device", "cpu", "--requests", "5", "--max-new-tokens", "4",
    ])
    for key in ("wall_s", "requests_completed", "requests_shed",
                "fleet_req_per_s", "generated_tokens", "router", "workers",
                "p2p_bytes"):
        assert key in out, key
    assert out["requests_completed"] == 5 and out["requests_shed"] == 0
    assert out["generated_tokens"] == 5 * 4 == sum(map(len, out["completed"].values()))
    assert out["fleet"] == {"prefill": 1, "decode": 2}
    with pytest.raises(ValueError, match="unknown fleet spec key"):
        serve_cli.main(["--fleet", "prefill=1,workers=2", "--device", "cpu"])


@pytest.mark.parametrize("spec", ["prefill=2,decode=3,lease_s=0.4",
                                  "decode=2,heartbeat_s=0.1,admission_ttft_s=0.5"])
def test_fleet_spec_matches_jax(spec):
    got, want = parse_fleet_spec(spec), j_parse_fleet_spec(spec)
    assert vars(got) == vars(want)
    assert [got.role_of(r) for r in range(got.nranks)] == [
        want.role_of(r) for r in range(want.nranks)
    ]


@pytest.mark.parametrize("kw,match", [
    (dict(prefill=0, decode=1), ">=1 prefill"),
    (dict(heartbeat_s=0.5, lease_s=0.5), "must exceed heartbeat_s"),
])
def test_fleet_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        FleetConfig(**kw)


def test_stream_projector_and_ledger_match_jax():
    """The router's admission math and ledger counts, fed the same
    observations in both packages."""
    regs = [StreamRegistry(clock=lambda: 100.0), JRegistry(clock=lambda: 100.0)]
    rng = np.random.default_rng(1)
    for x in rng.exponential(0.02, 50):
        for reg in regs:
            reg.observe("prefill_tick", float(x), t=99.0)
            reg.observe("decode_tick", float(x) / 3, t=99.5)
            reg.inc("fleet_completed", t=99.5)
    assert regs[0].window_stats() == regs[1].window_stats()
    for depth in (0, 3, 17):
        assert TTFTProjector(regs[0]).projected_ttft_s(depth) == \
            JProjector(regs[1]).projected_ttft_s(depth)
    assert TTFTProjector(StreamRegistry()).projected_ttft_s(2) is None
    ledgers = [Ledger(mode="full", clock=lambda: 1.0),
               JLedger(mode="full", clock=lambda: 1.0)]
    for led in ledgers:
        led.begin("a", t=0.0)
        led.event("a", "slot_bind", t=0.25)
        led.event("a", "decode_tick", t=0.5, dur_s=0.5)
        led.retire("a", t=1.0)
    assert ledgers[0].snapshot() == ledgers[1].snapshot()


def _snapshot(rank: int):
    return {
        "events": [("X", "fleet:decode_tick", 0.1 * rank, 0.02 * (rank + 1), 7, {"live": 2}),
                   ("X", "fleet:prefill", 0.5, 0.01 * rank, 7, None),
                   ("i", "fleet_worker_killed", 0.6, 0.0, 8, {"rank": rank})],
        "counters": {("p2p_send_bytes", (("dst", (rank + 1) % 3), ("src", rank))): 100.0 * rank,
                     ("fleet_msgs", (("kind", "hb"),)): 3.0},
        "gauges": {("fleet_inflight", (("rank", rank),)): 1.0},
        "thread_names": {7: f"mpit-rank-{rank}", 8: "fleet-hb"},
        "dropped": 0,
    }


def test_flight_record_matches_jax():
    per_rank = {r: _snapshot(r) for r in range(3)}
    for r, snap in per_rank.items():
        wire = tagg.serialize_snapshot(snap)
        assert wire == jagg.serialize_snapshot(snap)
        assert tagg.deserialize_snapshot(wire) == jagg.deserialize_snapshot(wire)
    assert tagg.skew_report(per_rank) == jagg.skew_report(per_rank)
    np.testing.assert_array_equal(tagg.merged_matrix(per_rank),
                                  jagg.merged_matrix(per_rank))
    model = np.asarray(jagg.merged_matrix(per_rank)) * 1.01
    assert tagg.flight_record(per_rank, modeled_matrix=model) == \
        jagg.flight_record(per_rank, modeled_matrix=model)
    assert tagg.merged_trace_events(per_rank) == jagg.merged_trace_events(per_rank)
