"""Chip smoke test of mpit_tpu_torch: the port's serving path on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA GPU (written
for an H100). Phases, each of which raises (exit code != 0) on failure:

1. device — CUDA must be available; prints the card's name and power
   limit (``nvidia-smi``);
2. build — compiles every kernel source of the port with ``nvcc`` (one
   process per source, all at once); compiler output goes to
   ``chiprun_out/chip_smoke_build.log``;
3. kernel vs plain — the flash-decode kernel against its plain PyTorch
   version at GPT-2 small's head geometry (8 slots, 12 heads, head dim
   64) for cache lengths 512 and 1024, query widths 1 (a decode tick)
   and 128 (a prefill), bf16 and f32, with slot lengths spread from 0 to
   S - T: max |error| within 1e-4 (f32) / 5e-2 (bf16, the JAX package's
   own bf16 kernel tolerance), visited-tile counts exact; times the
   kernel, its plain version and ``scaled_dot_product_attention`` (the
   library yardstick, never called by the port) with CUDA events on a
   cold L2, beside the bound the card's HBM rate and peak arithmetic
   rate set for the same work;
4. serve — ``python -m mpit_tpu_torch.serve``'s ``main`` in process:
   GPT-2 small at full width (12 layers, d_model 768, 12 heads, vocab
   50257, random weights from seed 0) in bf16, 8 slots, 16 greedy
   requests; every request completes with its tokens, and the kernel's
   launch count, set to 0 just before, reaches at least num_layers x
   (prefill calls + decode ticks);
5. parity — the same stream in f32 through the kernel engine and the
   reference engine (plain attention + dense sampling) on the card, same
   weights: the greedy tokens must be identical (TF32 off).

The last lines are the kernels JSON line, the card's name and power
limit as ``nvidia-smi`` prints them, and ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
OUT = HERE / "chiprun_out"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 / f32 non-tensor
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
SERVE_ARGS = [
    "--model", "small", "--slots", "8", "--max-len", "512",
    "--prefill-len", "128", "--prompt-len", "128", "--requests", "16",
    "--max-new-tokens", "32", "--seed", "0",
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def import_port():
    """The port from THIS checkout, nothing else."""
    sys.path.insert(0, str(HERE))
    try:
        import mpit_tpu_torch
    except ImportError as e:
        fail(f"mpit_tpu_torch is not beside chip_smoke.py ({e})")
    if Path(mpit_tpu_torch.__file__).resolve().parent.parent != HERE:
        fail(f"mpit_tpu_torch imported from {mpit_tpu_torch.__file__}, not {HERE}")


def cold_time_ms(fn, torch, flush, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, each on a cold L2
    (a 256 MB buffer is rewritten before every timed call). For a call
    of several launches the time between its events includes any wait
    for the host between them."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def kernel_phase(torch, flush):
    """Phase 3: the flash-decode kernel against its plain version."""
    import torch.nn.functional as F

    from mpit_tpu_torch.ops import decode_attention as da

    b, h, d = 8, 12, 64
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for s in (512, 1024):
            for t in (1, 128):
                gen = torch.Generator(device="cuda").manual_seed(s + t)
                q, k, v = (
                    torch.randn(shape, generator=gen, device="cuda").to(dtype)
                    for shape in ((b, t, h, d), (b, s, h, d), (b, s, h, d))
                )
                lens = torch.linspace(0, s - t, b, device="cuda").int()
                bk = da.pick_block_k(s)
                out, visited = da.flash_decode_attention(
                    q, k, v, lens, return_visited=True
                )
                torch.cuda.synchronize()
                ref = da.reference_decode_attention(q, k, v, lens)
                err = (out.float() - ref.float()).abs().max().item()
                name = str(dtype).removeprefix("torch.")
                if not math.isfinite(err) or err > TOL[name]:
                    fail(f"kernel vs plain {name} S={s} T={t}: {err} > {TOL[name]}")
                want = da.num_kv_blocks(lens.cpu(), t, s, bk)
                if not torch.equal(visited.cpu(), want):
                    fail(f"visited {visited.tolist()} != num_kv_blocks {want.tolist()}")
                # SDPA over the padded cache with the same visibility mask.
                q_pos = lens.long()[:, None] + torch.arange(t, device="cuda")
                mask = (torch.arange(s, device="cuda") <= q_pos[..., None])[:, None]
                qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
                # Bound: the visible K/V rows, q, o, lengths and visited
                # once each; 4 operations per (query, visible key, dim).
                visible = (lens.long() + t).clamp(max=s)
                isz = q.element_size()
                nbytes = (
                    2 * int(visible.sum()) * h * d * isz
                    + 2 * q.numel() * isz + 2 * 4 * b
                )
                nops = 4 * h * d * int(
                    (lens.long()[:, None] + torch.arange(1, t + 1, device="cuda"))
                    .clamp(max=s).sum()
                )
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = nops / PEAK_OPS_PER_S[name] * 1e3
                cases.append({
                    "dtype": name, "B": b, "S": s, "T": t, "H": h, "Dh": d,
                    "block_k": bk, "lengths": lens.tolist(),
                    "max_abs_err": err, "tol": TOL[name],
                    "ms": cold_time_ms(
                        lambda: da.flash_decode_attention(q, k, v, lens),
                        torch, flush,
                    ),
                    "plain_ms": cold_time_ms(
                        lambda: da.reference_decode_attention(q, k, v, lens),
                        torch, flush,
                    ),
                    "library_ms": cold_time_ms(
                        lambda: F.scaled_dot_product_attention(
                            qh, kh, vh, attn_mask=mask
                        ),
                        torch, flush,
                    ),
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                })
                print(json.dumps({"kernel_case": cases[-1]}), flush=True)
    return cases


def serve_phase(torch, card):
    """Phase 4: the port's serving main path at GPT-2 small's width."""
    from mpit_tpu_torch.ops import flash_decode_attention
    from mpit_tpu_torch.serve.__main__ import main

    flash_decode_attention.launches = 0
    out = main(SERVE_ARGS)
    launches = flash_decode_attention.launches
    phases = out["obs_summary"]
    n_prefill = phases["prefill"]["count"]
    n_decode = phases["decode"]["count"]
    need = out["model"]["layers"] * (n_prefill + n_decode)
    if out["requests_completed"] != 16 or out["truncated"]:
        fail(f"serve: {out['requests_completed']} of 16 requests completed")
    if out["generated_tokens"] != 16 * 32:
        fail(f"serve: {out['generated_tokens']} tokens, expected {16 * 32}")
    if launches < need or launches == 0:
        fail(f"serve: {launches} kernel launches < {need} (layers x calls)")
    if out["decode_attention"] != "kernel" or out["device"] != "cuda":
        fail(f"serve ran {out['decode_attention']} on {out['device']}")
    print(json.dumps({
        "card": card,
        "serve": {
            k: out[k] for k in (
                "model", "device", "wall_s", "decode_tokens_per_sec",
                "requests_completed", "generated_tokens", "ticks",
                "admissions", "ttft_p50_s", "ttft_p95_s", "latency_p50_s",
                "latency_p95_s", "kv_dtype",
            )
        },
        "prefill_calls": n_prefill,
        "decode_ticks": n_decode,
        "prefill_ms_p50": phases["prefill"]["p50_s"] * 1e3,
        "prefill_ms_p95": phases["prefill"]["p95_s"] * 1e3,
        "decode_tick_ms_p50": phases["decode"]["p50_s"] * 1e3,
        "decode_tick_ms_p95": phases["decode"]["p95_s"] * 1e3,
        "kernel_launches": launches,
    }), flush=True)
    return launches


def parity_phase(torch):
    """Phase 5: f32 greedy tokens, kernel engine vs reference engine."""
    from mpit_tpu_torch.config import from_argv
    from mpit_tpu_torch.models import GPT2, GPT2Config
    from mpit_tpu_torch.serve import Engine, Server
    from mpit_tpu_torch.serve.__main__ import ServeConfig, synthetic_requests

    cfg = from_argv(ServeConfig, SERVE_ARGS)
    mcfg = GPT2Config.small(dtype=torch.float32)
    state = GPT2(mcfg, generator=torch.Generator().manual_seed(cfg.seed)).state_dict()
    tokens = {}
    for mode in ("kernel", "reference"):
        engine = Engine(
            mcfg, state, slots=cfg.slots, max_len=cfg.max_len,
            prefill_len=cfg.prefill_len, seed=cfg.seed, device="cuda",
            decode_attention=mode,
        )
        server = Server(engine)
        for req in synthetic_requests(cfg, mcfg.vocab_size):
            server.submit(req)
        tokens[mode] = {c.rid: c.tokens for c in server.run()}
        del engine, server
        torch.cuda.empty_cache()
    diff = [r for r in tokens["reference"] if tokens["kernel"].get(r) != tokens["reference"][r]]
    if len(tokens["reference"]) != 16 or diff:
        fail(f"f32 greedy tokens differ, kernel vs reference, for requests {diff}")
    print(json.dumps({"parity_f32": "identical", "requests": 16,
                      "tokens": sum(len(t) for t in tokens["kernel"].values())}),
          flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    import_port()
    # Full-precision f32 matmuls wherever f32 results are compared.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from mpit_tpu_torch.ops import build

    t0 = time.perf_counter()
    logs = build.build(build.KERNEL_SOURCES, force=True)
    build_s = time.perf_counter() - t0
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke_build.log").write_text(
        "\n".join(f"== {src}\n{log}" for src, log in logs.items())
    )
    print(f"build: {len(logs)} source(s) in {build_s:.2f} s", flush=True)

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    cases = kernel_phase(torch, flush)
    del flush
    launches = serve_phase(torch, card)
    parity_phase(torch)

    head = next(c for c in cases if c["dtype"] == "bfloat16" and c["S"] == 512 and c["T"] == 1)
    kernels = {"kernels": [{
        "name": "flash_decode_attention",
        "route": "cuda",
        "source": "mpit_tpu_torch/csrc/decode_attention.cu",
        "replaces": "mpit_tpu/ops/decode_attention.py:166",
        "launches": launches,
        "max_abs_err": head["max_abs_err"],
        "tol": head["tol"],
        "ms": head["ms"],
        "kernel_ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": {k: head[k] for k in ("dtype", "B", "S", "T", "H", "Dh")},
        "cases": cases,
    }]}
    print(json.dumps(kernels))
    print(card)  # the nvidia-smi name and power limit, as it prints them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
