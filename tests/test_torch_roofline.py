"""mpit_tpu_torch's roofline layer against the JAX package's.

- :func:`rollup` and :func:`utilization` of the port equal JAX's on the
  same costs, work, phases and peaks, with the port's ``"cuda"`` where
  JAX has ``"tpu"`` (the platform that earns percentages); a CPU run, and
  a card without a known spec, carry no percentage;
- :func:`kv_tile_read_bytes` and :func:`decode_step_hbm_bytes` equal
  JAX's bit for bit, and a kernel engine's
  :meth:`Engine.decode_achieved_hbm_bytes` equals JAX's formula over
  JAX's own wire sizes (``params_wire_bytes``, ``kv_wire_bytes_per_row``)
  for the dense f32, int8 K/V and int8-weight engines;
- the analytic matmul FLOPs of :func:`gpt2_step_cost` equal a hand count
  from the config, and the engine's registered FLOPs lie within
  [0.75, 1.0] of XLA's ``cost_analysis`` of the same tiny JAX engine
  (2 layers, width 64, f32): the analytic count is the matmuls and
  attention products, a subset of what XLA counts (LayerNorm, GELU,
  softmax and sampling are elementwise work, a large share at width 64);
  the speculative engine's prefill is left out, since XLA drops the
  draft's unused last-block work in JAX's fused prefill while the eager
  port computes it;
- :class:`CompileWatch` records a kernel-library build inside a watched
  call and flags one past the pinned expectation;
  :class:`UtilizationWatch` gives JAX's alerts on the same series;
- a served run's summary carries the roofline phases, labelled, with no
  percentage on the CPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.models.gpt2 import GPT2 as JGPT2
from mpit_tpu.models.gpt2 import GPT2Config as JConfig
from mpit_tpu.obs import core as jcore
from mpit_tpu.obs import roofline as jroof
from mpit_tpu.ops.kv_quant import kv_wire_bytes_per_row as jkv_row_bytes
from mpit_tpu.serve import Engine as JEngine
from mpit_tpu.serve.weights import params_wire_bytes as jparams_wire_bytes
from mpit_tpu.serve.weights import quantize_gpt2_params as jquantize
from mpit_tpu_torch import obs
from mpit_tpu_torch.models import GPT2Config
from mpit_tpu_torch.obs import roofline as roof
from mpit_tpu_torch.ops import build
from mpit_tpu_torch.serve import Engine, Request, Server, params_from_jax, warm_engine
from mpit_tpu_torch.utils import profiling

JCFG = JConfig.tiny(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=2, d_model=64,
                    dtype=jnp.float32)
TCFG = GPT2Config.tiny(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=2, d_model=64,
                       dtype=torch.float32)
GEOM = dict(slots=2, max_len=32, prefill_len=16)
PEAKS = {"chip": "card", "peak_flops": 9.89e14, "peak_hbm": 3.35e12, "peak_ici": 4.5e11}


@pytest.fixture(scope="module")
def params():
    p = jax.jit(JGPT2(JCFG).init)(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    p = jax.tree.map(np.asarray, p)
    return {"jax": p, "torch": params_from_jax(p)}


def _costs(platform):
    return {
        "decode": {"flops": 4.0e9, "hbm_bytes": 2.5e8, "ici_bytes": 0.0,
                   "platform": platform, **PEAKS},
        "prefill": {"flops": 9.0e11, "hbm_bytes": 3.0e8, "ici_bytes": 1.0e7,
                    "platform": platform, **PEAKS},
        "idle": {"flops": 1.0, "hbm_bytes": 1.0, "ici_bytes": 0.0, "platform": platform,
                 **PEAKS},
    }


WORK = {"decode": {"flops": 0.0, "hbm_bytes": 6.1e9, "ici_bytes": 0.0, "n": 20,
                   "explicit": {"hbm_bytes"}}}
PHASES = {"decode": {"count": 20, "total_s": 0.41}, "prefill": {"count": 3, "total_s": 0.09}}
OVERLAY = {"prefill": 0.03}


def _strip(out):
    for e in out["phases"].values():
        e.pop("platform")
    return out


def test_rollup_equals_jax_with_cuda_in_the_tpu_slot():
    mine = roof.rollup(_costs("cuda"), WORK, PHASES, overlay_seconds=OVERLAY)
    ref = jroof.rollup(_costs("tpu"), WORK, PHASES, overlay_seconds=OVERLAY)
    assert _strip(mine) == _strip(ref)
    dec = mine["phases"]["decode"]
    assert dec["mfu_pct"] >= 0 and dec["hbm_util_pct"] > 0
    assert dec["explicit_components"] == ["hbm_bytes"]
    assert mine["phases"]["prefill"]["compile_seconds_excluded"] == 0.03
    assert "mfu_pct" not in mine["phases"]["idle"]  # no seconds: no share


@pytest.mark.parametrize("achieved,seconds", [
    ({"flops": 1e12, "hbm_bytes": 1e9}, 0.01),
    ({"flops": 5e9, "hbm_bytes": 3e9, "ici_bytes": 2e8}, 0.5),
    ({"flops": 0.0, "hbm_bytes": 0.0}, 0.0),
])
def test_utilization_equals_jax(achieved, seconds):
    mine = roof.utilization(achieved, seconds, platform="cuda", peaks=PEAKS)
    assert mine == jroof.utilization(achieved, seconds, platform="tpu", peaks=PEAKS)
    off = roof.utilization(achieved, seconds, platform="cpu", peaks=PEAKS)
    assert off == jroof.utilization(achieved, seconds, platform="cpu", peaks=PEAKS)
    assert not any(k.endswith("_pct") for k in off)
    unknown = {"chip": "other card", "peak_flops": None, "peak_hbm": None, "peak_ici": None}
    blind = roof.utilization(achieved, seconds, platform="cuda", peaks=unknown)
    assert not any(k.endswith("_pct") for k in blind) and "bound_modeled" not in blind


def test_chip_peaks_label_the_card(monkeypatch):
    # No card here: the H100's data-sheet peaks, modeled, without a card label.
    assert roof.chip_peaks()["peak_flops"] == profiling.H100_SXM.peak_flops_bf16
    assert roof.chip_peaks(dtype="f32")["peak_flops"] == profiling.H100_SXM.peak_flops_f32
    assert "card" not in roof.chip_peaks()
    monkeypatch.setattr(roof, "device_card", lambda: {"name": "NVIDIA H100 80GB HBM3",
                                                       "power_limit": "700.00 W"})
    known = roof.chip_peaks()
    assert known["chip"] == "h100-sxm" and known["power_limit"] == "700.00 W"
    monkeypatch.setattr(roof, "device_card", lambda: {"name": "NVIDIA H100 PCIe",
                                                       "power_limit": "350.00 W"})
    assert roof.chip_peaks()["peak_flops"] is None
    with obs.local_recorder() as rec:
        roof.register_cost("decode", flops=1e9, hbm_bytes=1e9, platform="cuda")
        obs.span_at("decode", 1.0, 1.5)
        entry = rec.summary()["roofline"]["phases"]["decode"]
    assert entry["card"] == "NVIDIA H100 PCIe" and "hbm_util_pct" not in entry


@pytest.mark.parametrize("tiles,bk,row,layers,params_b,appended", [
    (37, 16, 2 * 64 * 4.0, 12, 0.0, 0), (8, 256, 12 * (64 + 4.0), 12, 1.6e8, 8),
    (1, 8, 3.0, 1, 7.0, 3),
])
def test_decode_bytes_bit_equal_jax(tiles, bk, row, layers, params_b, appended):
    kw = dict(block_k=bk, kv_row_bytes=row, num_layers=layers)
    assert roof.kv_tile_read_bytes(tiles, **kw) == jroof.kv_tile_read_bytes(tiles, **kw)
    assert roof.decode_step_hbm_bytes(tiles, param_bytes=params_b, appended_rows=appended,
                                      **kw) == jroof.decode_step_hbm_bytes(
        tiles, param_bytes=params_b, appended_rows=appended, **kw)


@pytest.mark.parametrize("kw", [{}, {"kv_dtype": "int8"}, {"weights_dtype": "int8"},
                                {"kv_pages": 24, "kv_page_size": 4}],
                         ids=["dense_f32", "int8_kv", "int8_weights", "paged"])
def test_engine_decode_bytes_equal_jax_formula(params, kw):
    eng = Engine(TCFG, params["torch"], device="cpu", **GEOM, **kw)
    jp = jquantize(params["jax"]) if kw.get("weights_dtype") else params["jax"]
    row = jkv_row_bytes(JCFG.num_heads, JCFG.head_dim,
                        "int8" if kw.get("kv_dtype") else jnp.float32)
    assert eng._kv_row_bytes == row
    assert eng._param_bytes == jparams_wire_bytes(jp)
    lens = np.array([3, 17])
    from mpit_tpu.ops.decode_attention import num_kv_blocks as jnum_kv_blocks

    tiles = int(jnum_kv_blocks(lens, 1, eng.max_len, eng.decode_block_k).sum()) + 0
    want = jroof.decode_step_hbm_bytes(
        tiles, block_k=eng.decode_block_k, kv_row_bytes=row, num_layers=JCFG.num_layers,
        param_bytes=jparams_wire_bytes(jp), appended_rows=2,
    )
    assert eng.decode_achieved_hbm_bytes(lens) == want
    assert eng.decode_achieved_hbm_bytes(lens[:1]) > eng.decode_achieved_hbm_bytes(
        lens[:1], include_params=False)
    ref = Engine(TCFG, params["torch"], device="cpu", decode_attention="reference", **GEOM)
    assert ref.decode_achieved_hbm_bytes(lens) is None


def test_matmul_flops_equal_a_hand_count():
    cfg = TCFG  # L 2, D 64, F 256, V 128
    got = profiling.gpt2_step_cost(cfg, "decode", slots=3, ctx=32, param_bytes=0.0)
    # Per row and layer: qkv 64x192, proj 64x64, fc 64x256, out 256x64
    # multiply-adds; the head 64x128 for each of the 3 sampled rows.
    per_row = 64 * 192 + 64 * 64 + 64 * 256 + 256 * 64
    assert got["matmul_flops"] == 2 * 3 * 2 * per_row + 2 * 3 * 64 * 128
    assert got["flops"] == got["matmul_flops"] + 4 * 2 * 64 * 3 * 32
    verify = profiling.gpt2_step_cost(cfg, "spec_verify", slots=3, width=4, ctx=32,
                                      param_bytes=0.0)
    assert verify["matmul_flops"] == 2 * 12 * 2 * per_row + 2 * 12 * 64 * 128
    train = profiling.gpt2_step_cost(cfg, "train", slots=2, width=16, ctx=16, param_bytes=100.0)
    assert train["matmul_flops"] == 3 * (2 * 32 * 2 * per_row + 2 * 32 * 64 * 128)
    assert train["hbm_bytes"] == 1000.0 and train["source"] == "analytic"
    with pytest.raises(ValueError, match="kind"):
        profiling.gpt2_step_cost(cfg, "backward", slots=1, ctx=1, param_bytes=0.0)


@pytest.mark.parametrize("kw", [{}, {"kv_pages": 24, "kv_page_size": 4, "prefill_chunk": 8},
                                {"spec_k": 2}], ids=["dense", "paged", "spec"])
def test_registered_flops_within_xla_cost_analysis(params, kw):
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("spec_k"):
        from mpit_tpu.serve import draft_from_target as jdraft
        from mpit_tpu_torch.serve import draft_from_target as tdraft

        jkw["draft_params"], jkw["draft_cfg"] = jdraft(params["jax"], JCFG, 1)
        tkw["draft_params"], tkw["draft_cfg"] = tdraft(params["torch"], TCFG, 1)
    with jcore.local_recorder():
        jeng = JEngine(JCFG, params["jax"], decode_attention="reference", **GEOM, **jkw)
        ref = jeng.register_roofline()
    with obs.local_recorder() as rec:
        eng = Engine(TCFG, params["torch"], device="cpu", decode_attention="reference",
                     **GEOM, **tkw)
        mine = eng.register_roofline()
        assert set(rec.costs) == set(ref)
        assert all(c["source"] == "analytic" and c["platform"] == "cpu"
                   for c in rec.costs.values())
    for phase, cost in ref.items():
        if kw.get("spec_k") and phase == "prefill":
            continue  # XLA drops the draft's unused block work; the port runs it
        ratio = mine[phase]["flops"] / cost["flops"]
        assert 0.75 <= ratio <= 1.0, (phase, ratio)


def test_compile_watch_records_builds(monkeypatch):
    calls = []

    def fake_build():
        calls.append(1)
        monkeypatch.setattr(build, "_events", build._events + 1)
        return "out"

    sentinel = obs.Sentinel()
    watch = roof.CompileWatch(scope="engine", sentinel=sentinel)
    with obs.local_recorder() as rec:
        assert watch.call("prefill", fake_build) == "out"
        watch.expected = watch.compiles
        assert watch.call("decode", lambda: 1) == 1
        watch.call("decode", fake_build)
        summ = rec.summary()
    assert watch.compiles == 2 and watch.unexpected == 1
    assert summ["phases"]["compile"]["count"] == 2
    assert summ["counters"]["compiles"] == 2
    assert sentinel.report()["anomaly_counts"] == {"unexpected_recompile": 1}


def test_utilization_watch_equals_jax():
    series = [10.0] * 10 + [3.0] * 12 + [10.0] * 4
    out = []
    for cls, sent in ((roof.UtilizationWatch, obs.Sentinel), (jroof.UtilizationWatch,
                                                              __import__("mpit_tpu.obs", fromlist=[
                                                                  "Sentinel"]).Sentinel)):
        s = sent()
        w = cls(window=8, warmup=4, sustained_n=3, sentinel=s)
        for i, v in enumerate(series):
            w.observe("decode_hbm_gbps", i, v)
        out.append((w.alerts, s.report()))
    assert out[0] == out[1] and out[0][0]


def test_served_summary_carries_the_roofline_unpercented_on_the_cpu(params):
    eng = Engine(TCFG, params["torch"], device="cpu", kv_pages=24, kv_page_size=4, **GEOM)
    with obs.local_recorder() as rec:
        warm_engine(eng, register_costs=True)
        assert eng.compile_watch.expected == eng.compile_watch.compiles == 0
        server = Server(eng)
        for i in range(3):
            server.submit(Request(rid=i, prompt=[1, 2, 3 + i], max_new_tokens=5))
        server.run()
        summ = rec.summary()
        stats = server.stats()
    phases = summ["roofline"]["phases"]
    assert set(phases) == {"prefill", "decode"}
    dec = phases["decode"]
    assert dec["explicit_components"] == ["hbm_bytes"] and dec["platform"] == "cpu"
    assert dec["chip"] == "h100-sxm" and not any(k.endswith("_pct") for k in dec)
    assert dec["achieved_hbm_bytes"] > stats["decode_hbm_bytes_modeled"] > 0  # + the warm-up's
    assert stats["roofline"] == summ["roofline"] and stats["engine_compiles"] == 0
