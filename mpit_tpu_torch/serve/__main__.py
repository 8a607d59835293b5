"""Serving entry point: ``python -m mpit_tpu_torch.serve [options]``.

Loads a dense checkpoint (``--ckpt state.npz``, the format the JAX
package's ``train.convert --save-dense`` writes) or random-initialises a
model from ``--seed`` (``--model tiny|small``), serves a closed-loop
synthetic stream (``--requests N``, all submitted up front, run to
drain) through the continuous-batching engine, and prints one JSON
result: the serving stats (decode tokens/s, TTFT and latency
percentiles, occupancy) plus the obs phase summary. A one-line summary
goes to stderr. ``--fleet prefill=P,decode=D[,lease_s=...]`` serves the
same stream through the disaggregated fleet instead
(:mod:`mpit_tpu_torch.serve.fleet`: a router, P prefill and D decode
workers, each with its own engine, KV shipped between them).
``--spec-k K`` serves speculatively, with a draft from ``--draft-ckpt
state.npz`` (``--draft-num-heads``), ``--draft-config tiny`` (a random
tiny model of the target's vocabulary) or ``--draft-config
truncate:N`` (the target's first N layers). ``--mesh model=N`` serves
tensor-parallel over N ranks on the one device (the engine's
``world``/``tp_axis``: Megatron blocks, a head-sharded cache); the TP
axis is ``model`` where the mesh has one, else its first axis, as in the
JAX CLI.

``--loadgen "rate=8,process=bursty,tenants=4"`` drives an open-loop
arrival trace instead (:mod:`mpit_tpu_torch.serve.loadgen`, seeded by
``--seed``) through ``Server.run_timed`` for ``--duration`` seconds
(``--drain`` answers every admitted request), after the engine is warmed
outside the window; a live line of rolling-window stats (TTFT and
latency p50/p95, req/s, tok/s, occupancy, queue depth, over
``--window-s``) goes to stderr every ``--stats-interval`` seconds, and
the JSON carries the ``load`` block and ``window_stats``.
``--max-queue N`` sheds arrivals past N queued. ``--policy on`` (or a
spec such as ``"quantum=4,preempt=1,admission_factor=1.2,weight.t0=2"``)
swaps the FIFO queue for the scheduling policy
(:mod:`mpit_tpu_torch.serve.policy`: priority tiers, tenant fairness,
admission shedding and, paged, preemption); priorities and TTFT targets
ride the load spec (``...,priority=1,ttft_target=0.2``).
``--kv-host-pages N`` gives the paged pool a host KV tier of N pages:
preemption victims park there and resume by restreaming, and prefix
entries outlive their pages.

Observability: ``--slo-ttft-p95 S``, ``--slo-latency-p95 S`` and
``--slo-shed-rate F`` declare SLO targets evaluated once a tick over the
rolling windows (the JSON's ``slo`` block); ``--sentinel true`` runs the
anomaly sentinel over the prefill and decode ticks (``sentinel``);
``--trace run.json`` writes the run's Chrome trace, with the request
ledger's exemplars on their requests' lanes (the ledger rides along, so
the JSON's ``exemplars`` feed ``python -m mpit_tpu_torch.obs why-slow``).
The JSON always carries the ``roofline`` block (each phase's
modeled work against its span seconds: ``mfu_pct`` / ``hbm_util_pct``
against the card's peaks on a known card, labelled with the card and its
power limit; the platform label and no percentage on the CPU) and the
``memory`` block (the engine's memory ledger, for ``obs capacity``).

Runs on the GPU (``--device cuda``, the default; it raises without
one); ``--device cpu`` is for testing.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np

from mpit_tpu_torch.config import from_argv


@dataclasses.dataclass
class ServeConfig:
    """Options for the serving CLI."""

    ckpt: str = ""  # dense .npz ("" = random init)
    model: str = "tiny"  # random-init size: tiny | small
    num_heads: int = 0  # ckpt head-count override (0 = d_model//64)
    slots: int = 4  # concurrent KV-cache slots
    max_len: int = 96  # per-slot cache length (prompt + generation)
    prefill_len: int = 32  # padded prompt buffer width
    requests: int = 16  # synthetic stream size
    prompt_len: int = 8  # max synthetic prompt length (uniform 1..N)
    max_new_tokens: int = 16
    temperature: float = 0.0  # <=0 greedy
    top_k: int = 0  # 0 = full vocab
    # kernel = flash-decode CUDA kernel + blocked LM-head sampling;
    # reference = plain cached attention + dense sampling (the oracle).
    decode_attention: str = "kernel"
    sample_k_cap: int = 128  # blocked sampler's candidate buffer (bounds top_k)
    seed: int = 0
    device: str = "cuda"  # cpu only for testing
    # Paged KV pool: kv_pages > 0 selects it (pages of kv_page_size
    # tokens shared by all slots, prefix sharing with copy-on-write);
    # prefill_chunk > 0 prefills long prompts in slices interleaved
    # with decode ticks.
    kv_pages: int = 0
    kv_page_size: int = 16
    prefill_chunk: int = 0
    # Cache storage: f32 | bf16 | int8 ("" = follow the model dtype).
    kv_dtype: str = ""
    # Matmul weight storage: f32 | int8 ("" = the weights as loaded).
    weights_dtype: str = ""
    # Speculative decoding: spec_k > 0 drafts k tokens a tick and
    # verifies them in one target pass. The draft: --draft-ckpt (a
    # dense .npz, heads by --draft-num-heads), or --draft-config tiny |
    # truncate:N (the target's first N layers).
    spec_k: int = 0
    draft_ckpt: str = ""
    draft_config: str = ""
    draft_num_heads: int = 0
    # Tensor parallelism: "model=N" (or "data=D,model=M": one data
    # replica is served) over ranks on the one device.
    mesh: str = ""
    # The paged pool's host KV tier: pages of host memory for parked
    # preemption victims and migrated prefix entries (0 = none).
    kv_host_pages: int = 0
    # Open-loop load: "" keeps the closed-loop stream; else a
    # serve.loadgen spec ("rate=8,process=poisson|bursty,tenants=4,
    # prompt_min=..,prompt_max=..,new_min=..,new_max=..,prefix=..,
    # priority=..,ttft_target=..").
    loadgen: str = ""
    duration: float = 10.0  # the admission window, seconds
    drain: bool = True  # tick past the window until every request is answered
    window_s: float = 5.0  # rolling-window span of the live stats
    stats_interval: float = 2.0  # live line cadence, seconds (0 = silent)
    max_queue: int = 0  # shed arrivals past this queue depth (0 = unbounded)
    # Scheduling policy: "" = FIFO; "on" = the defaults; or a
    # serve.policy spec ("quantum=4,preempt=1,admission_factor=1.2,
    # weight.<tenant>=2").
    policy: str = ""
    # Observability: the step-time sentinel, a Chrome trace path (with
    # the request ledger), SLO targets (0 = none).
    sentinel: bool = False
    trace: str = ""
    slo_ttft_p95: float = 0.0
    slo_latency_p95: float = 0.0
    slo_shed_rate: float = 0.0
    # Disaggregated fleet: "" = one Server; else a serve.fleet spec
    # ("prefill=1,decode=2[,lease_s=5.0,heartbeat_s=0.05,...]").
    fleet: str = ""


# Flags of the single Server's loop, which the fleet's router does not run.
_SERVER_ONLY = (
    "loadgen", "max_queue", "policy", "kv_host_pages", "sentinel", "trace", "slo_ttft_p95",
    "slo_latency_p95", "slo_shed_rate",
)


def _check_flags(cfg: ServeConfig) -> None:
    """``SystemExit`` for a flag value or combination the CLI refuses."""
    if cfg.decode_attention not in ("kernel", "reference"):
        raise SystemExit(
            f"--decode-attention {cfg.decode_attention!r}: expected kernel "
            "or reference (the Pallas interpreter has no counterpart here)"
        )
    if cfg.kv_dtype and cfg.kv_dtype not in ("f32", "bf16", "int8"):
        raise SystemExit(f"--kv-dtype {cfg.kv_dtype!r}: expected f32, bf16 or int8")
    if cfg.kv_dtype == "int8" and cfg.decode_attention == "reference":
        # The reference path dequantizes the whole cache every tick: it
        # is the parity oracle, and serving int8 through it pays the
        # quantization error for more bytes moved, not fewer.
        raise SystemExit(
            "--kv-dtype int8 with --decode-attention reference: the "
            "reference path materializes the full dequantized cache per "
            "tick (it is the parity oracle, not a serving path); use "
            "--decode-attention kernel for the fused dequant"
        )
    if cfg.weights_dtype and cfg.weights_dtype not in ("f32", "int8"):
        raise SystemExit(
            f"--weights-dtype {cfg.weights_dtype!r}: expected f32 or int8"
        )
    if cfg.fleet and cfg.spec_k:
        # JAX's fleet builds speculative workers, but its KV shipment
        # (export_kv_rows / inject_kv_rows) moves the target's cache
        # only: a decode worker's draft would never see the prompt.
        raise SystemExit(
            "--fleet with --spec-k: the KV shipment carries the target's "
            "cache only, so a decode worker's draft would draft from a cache "
            "that never saw the prompt; serve speculatively without --fleet"
        )
    if cfg.kv_host_pages and not cfg.kv_pages:
        raise SystemExit(
            f"--kv-host-pages {cfg.kv_host_pages}: the host KV tier spills the "
            "paged pool's pages; pass --kv-pages"
        )
    if cfg.fleet:
        defaults = ServeConfig()
        for name in _SERVER_ONLY:
            if getattr(cfg, name) != getattr(defaults, name):
                raise SystemExit(
                    f"--fleet with --{name.replace('_', '-')}: the fleet's router "
                    "serves the closed-loop stream with its own admission; "
                    "the open-loop harness, the policy, the host KV tier and "
                    "the serving obs flags drive one Server"
                )
    if cfg.fleet and cfg.mesh:
        # The fleet's KV shipment (export_kv_rows / inject_kv_rows) moves
        # one device's whole rows; a tensor-parallel engine's rows are cut
        # over its ranks on the head axis.
        raise SystemExit(
            "--fleet with --mesh: the fleet's KV shipment moves one device's whole "
            "rows, and a tensor-parallel engine's cache is head-sharded over its "
            "ranks; the fleet over tensor parallelism arrives with ROADMAP.md §A 8c"
        )
    if cfg.weights_dtype == "int8" and cfg.decode_attention == "reference":
        # Same rule as --kv-dtype: the reference engine runs the
        # whole-dequant matmul oracle.
        raise SystemExit(
            "--weights-dtype int8 with --decode-attention reference: "
            "the reference path materializes whole dequantized weights "
            "(it is the parity oracle, not a serving path); use "
            "--decode-attention kernel for the fused-dequant matmuls"
        )


def _build_engine(cfg: ServeConfig):
    import torch

    from mpit_tpu_torch import comm
    from mpit_tpu_torch.asyncsgd.config import parse_mesh
    from mpit_tpu_torch.models import GPT2, GPT2Config
    from mpit_tpu_torch.serve import Engine, load_gpt2_params, resolve_device

    device = resolve_device(cfg.device)  # before any weights are made
    world = tp_axis = None
    shape = parse_mesh(cfg.mesh)
    if shape:
        world = comm.init(shape, devices=[device])
        tp_axis = "model" if "model" in shape else next(iter(shape))
    if cfg.ckpt:
        params, mcfg = load_gpt2_params(cfg.ckpt, num_heads=cfg.num_heads)
    else:
        mcfg = (
            GPT2Config.small()
            if cfg.model == "small"
            else GPT2Config.tiny(max_seq_len=max(cfg.max_len, 128))
        )
        gen = torch.Generator().manual_seed(cfg.seed)
        params = GPT2(mcfg, generator=gen).state_dict()
    draft_params, draft_cfg = _resolve_draft(cfg, params, mcfg)
    engine = Engine(
        mcfg,
        params,
        slots=cfg.slots,
        max_len=cfg.max_len,
        prefill_len=cfg.prefill_len,
        seed=cfg.seed,
        device=device,
        decode_attention=cfg.decode_attention,
        sample_k_cap=max(cfg.sample_k_cap, cfg.top_k),
        kv_pages=cfg.kv_pages or None,
        kv_page_size=cfg.kv_page_size,
        # Passed through unconditionally: --prefill-chunk without
        # --kv-pages must surface the Engine's rejection, not silently
        # run whole-prompt prefills.
        prefill_chunk=cfg.prefill_chunk or None,
        kv_dtype=cfg.kv_dtype or None,
        weights_dtype=cfg.weights_dtype or None,
        spec_k=cfg.spec_k,
        draft_params=draft_params,
        draft_cfg=draft_cfg,
        world=world,
        tp_axis=tp_axis,
        kv_host_pages=cfg.kv_host_pages or None,
    )
    return engine, mcfg


def _resolve_draft(cfg: ServeConfig, params, mcfg):
    """The speculative draft ``(state, cfg)`` the flags name, or ``(None,
    None)``; every bad combination is a ``SystemExit`` before a model is
    built, as in the JAX CLI."""
    import torch

    from mpit_tpu_torch.models import GPT2, GPT2Config
    from mpit_tpu_torch.serve import draft_from_target, load_gpt2_params

    if not cfg.spec_k:
        if cfg.draft_ckpt or cfg.draft_config:
            raise SystemExit("--draft-ckpt/--draft-config require --spec-k >= 1")
        return None, None
    if cfg.draft_ckpt and cfg.draft_config:
        raise SystemExit(
            "--draft-ckpt and --draft-config are mutually exclusive: one draft "
            "model per engine"
        )
    if not cfg.kv_pages:
        # The dense verify needs spec_k - 1 rows of headroom past prompt +
        # max_new; refuse the geometry here, not per request.
        need = cfg.prompt_len + cfg.max_new_tokens + cfg.spec_k - 1
        if need > cfg.max_len:
            raise SystemExit(
                f"--spec-k {cfg.spec_k}: prompt_len + max_new_tokens + spec_k - 1 "
                f"= {need} > --max-len {cfg.max_len} on the dense engine; shrink "
                "the stream, lower --spec-k, grow --max-len, or use --kv-pages "
                "(the paged engine drops out-of-range draft rows)"
            )
    if cfg.draft_ckpt:
        return load_gpt2_params(cfg.draft_ckpt, num_heads=cfg.draft_num_heads)
    if cfg.draft_config.startswith("truncate:"):
        try:
            n = int(cfg.draft_config.split(":", 1)[1])
        except ValueError:
            raise SystemExit(
                f"--draft-config {cfg.draft_config!r}: expected truncate:<num_layers>"
            ) from None
        if not 1 <= n < mcfg.num_layers:
            raise SystemExit(
                f"--draft-config truncate:{n}: need 1 <= N < the target's "
                f"{mcfg.num_layers} layers (an equal-depth draft costs what the "
                "target costs)"
            )
        return draft_from_target(params, mcfg, n)
    if cfg.draft_config == "tiny":
        dcfg = GPT2Config.tiny(
            vocab_size=mcfg.vocab_size, max_seq_len=mcfg.max_seq_len, dtype=mcfg.dtype
        )
        gen = torch.Generator().manual_seed(cfg.seed + 1)
        return GPT2(dcfg, generator=gen).state_dict(), dcfg
    raise SystemExit(
        f"--spec-k {cfg.spec_k} needs a draft: --draft-ckpt state.npz, "
        f"--draft-config tiny, or --draft-config truncate:N "
        f"(got draft_config={cfg.draft_config!r})"
    )


def synthetic_requests(cfg: ServeConfig, vocab_size: int):
    """A reproducible request stream: uniform prompt lengths 1..N,
    uniform token ids, the CLI's sampling settings."""
    from mpit_tpu_torch.serve import Request

    rng = np.random.RandomState(cfg.seed)
    for i in range(cfg.requests):
        plen = int(rng.randint(1, cfg.prompt_len + 1))
        yield Request(
            rid=i,
            prompt=rng.randint(0, vocab_size, size=plen).tolist(),
            max_new_tokens=cfg.max_new_tokens,
            temperature=cfg.temperature,
            top_k=cfg.top_k,
        )


def summary_line(engine, stats: dict, wall_s: float, tok_s) -> str:
    """One line for a person: completions, tokens, wall time and decode
    rate, then the cache and weight dtypes where they were chosen."""
    line = (
        f"served {stats['requests_completed']} requests, "
        f"{stats['generated_tokens']} tokens in {wall_s:.2f} s, "
        f"decode tok/s={tok_s if tok_s is not None else '-'}"
    )
    if engine.kv_dtype_explicit:
        line += f" kvd={engine.kv_dtype}"
    if engine.weights_dtype_explicit:
        line += f" wd={engine.weights_dtype}"
    if engine.tp:
        line += f" tp={engine.tp}"
    return line


def _run_fleet_cli(cfg: ServeConfig) -> dict:
    """``--fleet prefill=P,decode=D``: the disaggregated serving fleet
    over the closed-loop synthetic stream. One JSON result: completion
    counts and tokens, per-worker roll-ups, fleet req/s, and the flight
    block's P2P matrix (KV shipment bytes visible per (src, dst)); one
    stderr line with the copy kernel's launches and the bytes shipped."""
    from mpit_tpu_torch.ops import kv_ship
    from mpit_tpu_torch.serve.fleet import parse_fleet_spec, run_fleet

    fcfg = parse_fleet_spec(cfg.fleet)
    engine0, mcfg = _build_engine(cfg)
    seed_engines = [engine0]

    def factory(role, rank):
        # Same config + same seed → identical weights on every worker;
        # the engine built for the vocab lookup serves the first worker.
        if seed_engines:
            return seed_engines.pop()
        engine, _ = _build_engine(cfg)
        return engine

    requests = list(synthetic_requests(cfg, mcfg.vocab_size))
    launches0 = kv_ship.launches["kv_ship"]
    t0 = time.perf_counter()
    out = run_fleet(
        factory,
        requests,
        prefill=fcfg.prefill,
        decode=fcfg.decode,
        heartbeat_s=fcfg.heartbeat_s,
        lease_s=fcfg.lease_s,
        admission_ttft_s=fcfg.admission_ttft_s,
        job_timeout_s=fcfg.job_timeout_s,
    )
    wall = time.perf_counter() - t0
    launches = kv_ship.launches["kv_ship"] - launches0
    completed = out["completed"]
    shipped = sum(w.get("ship_bytes", 0) for w in out["workers"])
    result = {
        "model": {
            "layers": mcfg.num_layers,
            "d_model": mcfg.d_model,
            "vocab": mcfg.vocab_size,
            "source": cfg.ckpt or f"random-init {cfg.model}",
        },
        "device": str(engine0.device),
        "fleet": {"prefill": fcfg.prefill, "decode": fcfg.decode},
        "wall_s": round(wall, 4),
        "requests_completed": len(completed),
        "requests_shed": len(out["shed"]),
        "fleet_req_per_s": round(len(completed) / wall, 2) if wall else None,
        "generated_tokens": sum(len(t) for t in completed.values()),
        "completed": completed,
        "router": {
            k: v
            for k, v in out["router"].items()
            if k not in ("completed", "role")
        },
        "workers": out["workers"],
    }
    flight = out.get("flight")
    if flight is not None:
        result["p2p_bytes"] = np.asarray(flight["p2p_bytes"]).tolist()
    print(
        f"fleet prefill={fcfg.prefill} decode={fcfg.decode}: served "
        f"{len(completed)} requests, {result['generated_tokens']} tokens in "
        f"{wall:.2f} s, kv_ship launches={launches}, shipped {shipped} bytes",
        file=sys.stderr, flush=True,
    )
    return result


def _check_load_geometry(cfg: ServeConfig, spec) -> None:
    """Refuse, before the window, a load spec whose requests the engine
    could not take: ``submit`` raises on an oversized request as a
    caller's bug, and here the caller is this spec and geometry."""
    from mpit_tpu_torch.serve import pages_needed

    for klass in spec.classes:
        if klass.max_prompt_total > cfg.prefill_len:
            raise SystemExit(
                f"--loadgen class {klass.name!r}: prefix + prompt_max "
                f"{klass.max_prompt_total} > --prefill-len {cfg.prefill_len}"
            )
        need = klass.max_prompt_total + klass.max_new_tokens[1]
        if need > cfg.max_len:
            raise SystemExit(
                f"--loadgen class {klass.name!r}: prefix + prompt_max + new_max "
                f"= {need} > --max-len {cfg.max_len}"
            )
        if cfg.spec_k and not cfg.kv_pages and need + cfg.spec_k - 1 > cfg.max_len:
            raise SystemExit(
                f"--loadgen class {klass.name!r} + --spec-k {cfg.spec_k}: the dense "
                f"verify needs spec_k - 1 rows of headroom: prefix + prompt_max + "
                f"new_max + spec_k - 1 = {need + cfg.spec_k - 1} > --max-len "
                f"{cfg.max_len}; lower --spec-k, grow --max-len, or use --kv-pages"
            )
        if cfg.kv_pages:
            pages = pages_needed(klass.max_prompt_total, klass.max_new_tokens[1],
                                 cfg.kv_page_size)
            if pages > cfg.kv_pages:
                raise SystemExit(
                    f"--loadgen class {klass.name!r}: a request may need {pages} "
                    f"pages of {cfg.kv_page_size} tokens > --kv-pages {cfg.kv_pages}"
                )


def _slo_targets(cfg: ServeConfig) -> list:
    from mpit_tpu_torch.obs.slo import SLO

    targets = []
    if cfg.slo_ttft_p95 > 0:
        targets.append(SLO.ttft_p95(cfg.slo_ttft_p95))
    if cfg.slo_latency_p95 > 0:
        targets.append(SLO.latency_p95(cfg.slo_latency_p95))
    if cfg.slo_shed_rate > 0:
        targets.append(SLO.shed_rate(cfg.slo_shed_rate))
    return targets


def live_line(registry, server, now: float, monitor=None) -> str:
    """One line of rolling-window stats: TTFT and latency percentiles,
    arrival and token rates, occupancy, queue depth, completions and
    sheds; preemptions under a policy, the cache and weight dtypes when
    chosen, on the pool its occupancy, cached tokens, shared pages and
    host pages in use; the ledger's held bytes, the KV subsystem's and
    its headroom; the decode tick's modeled HBM rate and, on a known
    card, its MFU; the SLO targets in breach."""
    ws = registry.window_stats()
    h, r, g = ws["histograms"], ws["rates"], ws["gauges"]

    def ms(name, k):
        v = h.get(name, {}).get(k)
        return f"{v * 1000:.0f}" if v is not None else "-"

    line = (
        f"[t={now:6.1f}s] "
        f"ttft p50/p95={ms('request_ttft', 'p50')}/{ms('request_ttft', 'p95')}ms "
        f"lat p95={ms('request_latency', 'p95')}ms "
        f"req/s={r.get('serve_arrivals', {}).get('rate_per_s', 0.0):.1f} "
        f"tok/s={r.get('serve_tokens', {}).get('rate_per_s', 0.0):.0f} "
        f"occ={g.get('slot_occupancy', 0.0):.2f} "
        f"q={g.get('queue_depth', 0.0):.0f} "
        f"done={len(server.completed)} shed={len(server.shed)}"
    )
    if server.policy is not None:
        line += f" pre={server.policy.preemptions}"
    if server.engine.kv_dtype_explicit:
        line += f" kvd={server.engine.kv_dtype}"
    if server.engine.weights_dtype_explicit:
        line += f" wd={server.engine.weights_dtype}"
    if "kv_pool_occupancy" in g:
        line += (
            f" kv={g['kv_pool_occupancy']:.2f}"
            f" kvtok={g.get('kv_tokens_cached', 0.0):.0f}"
            f" shr={g.get('prefix_pages_shared', 0.0):.0f}"
        )
    if "kv_host_pages_in_use" in g:
        line += f" host={g['kv_host_pages_in_use']:.0f}"
    if "hbm_held_bytes" in g:
        line += (
            f" hbm={g['hbm_held_bytes'] / 1e6:.1f}MB"
            f" held={g.get('kv_held_bytes', 0.0) / 1e6:.1f}MB"
            f" headroom={g.get('kv_headroom_pct', 0.0):.0f}%"
        )
    bw = r.get("decode_hbm_bytes", {}).get("rate_per_s", 0.0)
    if bw:
        # The decode tick's length-aware modeled bytes over the window;
        # MFU only on a card with a known spec (off it, a percentage of a
        # peak would be fiction).
        line += f" hbmbw={bw / 1e9:.2f}GB/s"
        fl = r.get("decode_flops", {}).get("rate_per_s", 0.0)
        peaks = _card_peaks(server.engine)
        if fl and peaks is not None:
            line += f" mfu={100.0 * fl / peaks['peak_flops']:.2f}%"
        else:
            line += " mfu=-"
    if monitor is not None:
        breached = [n for n, t in monitor.report()["targets"].items() if t["in_breach"]]
        if breached:
            line += " SLO-BREACH:" + ",".join(breached)
    return line


def _card_peaks(engine):
    """The card's peaks for the engine's compute dtype, or None off the
    card or on a card without a known spec."""
    from mpit_tpu_torch.obs.roofline import chip_peaks

    if engine.platform != "cuda":
        return None
    import torch

    peaks = chip_peaks(dtype="bf16" if engine.cfg.dtype == torch.bfloat16 else "f32")
    return peaks if peaks["peak_flops"] else None


def main(argv: list[str] | None = None) -> dict:
    cfg = from_argv(ServeConfig, argv, prog="python -m mpit_tpu_torch.serve")
    _check_flags(cfg)
    if cfg.fleet:
        return _run_fleet_cli(cfg)
    from mpit_tpu_torch import obs
    from mpit_tpu_torch.obs.stream import StreamRegistry
    from mpit_tpu_torch.serve import (
        SchedulingPolicy,
        Server,
        generate_arrivals,
        parse_load_spec,
        parse_policy_spec,
        warm_engine,
    )

    try:
        spec = parse_load_spec(cfg.loadgen) if cfg.loadgen else None
        policy_cfg = parse_policy_spec(cfg.policy) if cfg.policy else None
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if spec is not None:
        _check_load_geometry(cfg, spec)
    rec = obs.enable(obs.Recorder())
    sentinel = obs.Sentinel(phases=("decode", "prefill"), warmup=4) if cfg.sentinel else None
    # The request ledger rides along with --trace: its exemplars go on
    # the trace's request lanes and into the JSON (why-slow's input).
    ledger = obs.Ledger(mode="full") if cfg.trace else None
    try:
        engine, mcfg = _build_engine(cfg)
        registry = StreamRegistry(window_s=cfg.window_s)
        targets = _slo_targets(cfg)
        monitor = obs.SLOMonitor(targets, registry, sentinel=sentinel) if targets else None
        policy = (
            SchedulingPolicy(policy_cfg, registry) if policy_cfg is not None else None
        )
        server = Server(
            engine, sentinel=sentinel, stream=registry, slo=monitor,
            max_queue=cfg.max_queue or None, policy=policy, ledger=ledger,
        )
        if spec is not None:
            # The first launches' one-off costs land outside the window;
            # the steps' analytic costs are registered with the recorder.
            warm_engine(engine, register_costs=True)
            arrivals = generate_arrivals(
                spec, vocab_size=mcfg.vocab_size, duration_s=cfg.duration,
                seed=cfg.seed,
            )
            last_line = [0.0]

            def on_tick(srv, now):
                if cfg.stats_interval <= 0 or now - last_line[0] < cfg.stats_interval:
                    return
                last_line[0] = now
                print(live_line(registry, srv, now, monitor), file=sys.stderr, flush=True)

            t0 = time.perf_counter()
            server.run_timed(
                arrivals, duration=cfg.duration, drain=cfg.drain, on_tick=on_tick
            )
        else:
            engine.register_roofline()
            for req in synthetic_requests(cfg, mcfg.vocab_size):
                server.submit(req)
            t0 = time.perf_counter()
            server.run()
        wall = time.perf_counter() - t0
        stats = server.stats()
    finally:
        obs.disable()
    summ = rec.summary()
    decode_s = summ["phases"].get("decode", {}).get("total_s", 0.0)
    # First tokens come from prefill; decode throughput counts the rest.
    decode_tokens = stats["generated_tokens"] - stats["requests_completed"]
    tok_s = round(decode_tokens / decode_s, 2) if decode_s else None
    print(summary_line(engine, stats, wall, tok_s), file=sys.stderr, flush=True)
    out = {
        "model": {
            "layers": mcfg.num_layers,
            "d_model": mcfg.d_model,
            "vocab": mcfg.vocab_size,
            "source": cfg.ckpt or f"random-init {cfg.model}",
        },
        "device": str(engine.device),
        "wall_s": round(wall, 4),
        "decode_tokens_per_sec": tok_s,
        "decode_attention": engine.decode_attention,
        "decode_sampler": engine.decode_sampler,
        "tensor_parallel": engine.tp or 1,
        **stats,
        "obs_summary": {
            name: {
                k: round(v, 6) if isinstance(v, float) else v
                for k, v in p.items()
            }
            for name, p in summ["phases"].items()
        },
    }
    if summ.get("roofline"):
        out["roofline"] = summ["roofline"]
    if spec is not None:
        out["load"] = {
            "rate": spec.rate,
            "process": spec.process,
            "tenants": spec.tenants,
            "duration_s": cfg.duration,
            "arrivals": len(arrivals),
            "shed": len(server.shed),
        }
        out["window_stats"] = registry.window_stats()
    if cfg.trace:
        extra = [ev for ex in ledger.exemplars() for ev in obs.trace.exemplar_trace_events(ex)]
        obs.export_chrome_trace(cfg.trace, recorder=rec, extra_events=extra)
        out["trace"] = cfg.trace
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1:])))
