"""Tracing, timing and cost accounting: the port of
:mod:`mpit_tpu.utils.profiling`.

- :func:`trace` — a ``torch.profiler`` capture (host and CUDA activity)
  of the enclosed region, written as a Chrome trace into ``log_dir``;
- :class:`StepTimer` — per-step wall timing, each tick fenced by
  ``torch.cuda.synchronize`` on the result's device;
- :class:`ChipSpec` and :data:`H100_SXM` — the card's peaks for a
  roofline, from the data sheet (there is no default card);
- :func:`roofline`, :func:`collective_bytes`, :func:`allreduce_gbps`,
  the ``modeled_*_seconds`` functions, :func:`scaling_projection` and
  :class:`CommModel` — the JAX package's arithmetic, unchanged;
- :func:`gpt2_step_cost` — the analytic FLOPs and HBM bytes of a GPT-2
  prefill, decode, verify, draft or train step from the config and the
  step's shapes (``source="analytic"``). It takes the place of JAX's
  ``compiled_cost``: there is no XLA here to ask. It counts the matmuls
  (the LM head included) and the attention score and value products of
  the padded step, and leaves out the elementwise work (LayerNorm, GELU,
  softmax, sampling) that XLA's ``cost_analysis`` also counts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Iterator, Sequence

import numpy as np

__all__ = [
    "ChipSpec",
    "CommModel",
    "H100_SXM",
    "StepTimer",
    "allreduce_gbps",
    "collective_bytes",
    "device_events",
    "gpt2_step_cost",
    "modeled_all_gather_seconds",
    "modeled_allreduce_seconds",
    "modeled_reduce_scatter_seconds",
    "roofline",
    "scaling_projection",
    "trace",
    "tree_bytes",
]

# Chrome-trace categories of device activity in a torch.profiler export.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")


def device_events(path: str | Path) -> list[dict]:
    """The device-activity events (kernels, copies, memsets) of a
    Chrome trace that :func:`trace` wrote."""
    with open(path) as f:
        doc = json.load(f)
    return [
        ev for ev in doc.get("traceEvents", [])
        if ev.get("ph") == "X" and ev.get("cat") in _DEVICE_CATS[:3]
    ]


@contextlib.contextmanager
def trace(log_dir: str, *, cuda: bool | None = None) -> Iterator[dict]:
    """Profile the enclosed region with ``torch.profiler`` (CPU activity,
    and CUDA activity when ``cuda`` — default: when a GPU is available)
    and write its Chrome trace to ``log_dir/trace.json``. Yields a dict
    that holds, after the block, ``path`` and ``device_events`` (the
    count of kernel, copy and memset events). With CUDA activity asked
    for and none recorded the block raises: a host-only trace of a GPU
    run is not a trace of the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    info: dict = {}
    with profile(activities=activities) as prof:
        yield info
        if cuda:
            torch.cuda.synchronize()
    path = out / "trace.json"
    prof.export_chrome_trace(str(path))
    info["path"] = str(path)
    info["device_events"] = len(device_events(path)) if cuda else 0
    if cuda and not info["device_events"]:
        raise RuntimeError(
            f"torch.profiler recorded no device activity in {path}: the CUDA "
            "activity trace (CUPTI) is not working on this machine"
        )


class StepTimer:
    """Wall-clock step timing with a device-completion fence.

    ``block=True`` (default) closes each tick with
    ``torch.cuda.synchronize`` on the device of the first tensor in the
    result passed to :meth:`tick` (a CPU tensor needs no fence: eager
    CPU work is done when the call returns), so queued kernels cannot
    make a step look free.
    """

    def __init__(self, *, block: bool = True):
        self._block = block
        self._t0: float | None = None
        self.times: list[float] = []

    def start(self) -> None:
        self._t0 = time.perf_counter()

    @staticmethod
    def _fence(result: Any) -> None:
        import torch

        for leaf in _leaves(result):
            if isinstance(leaf, torch.Tensor):
                if leaf.is_cuda:
                    torch.cuda.synchronize(leaf.device)
                return

    def tick(self, result: Any = None) -> float:
        """Record one step; returns its duration in seconds."""
        if self._t0 is None:
            raise RuntimeError("StepTimer.tick() before start()")
        if self._block and result is not None:
            self._fence(result)
        now = time.perf_counter()
        dt = now - self._t0
        self.times.append(dt)
        self._t0 = now
        return dt

    def summary(self, *, skip_warmup: int = 1) -> dict[str, float]:
        ts = self.times[skip_warmup:] or self.times
        arr = np.asarray(ts)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "total_s": float(arr.sum()),
        }


def _leaves(tree) -> Iterator:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Peak numbers of one card for a roofline. No field has a default:
    a spec names its card and where each figure comes from.

    ``ici_bandwidth`` is the card-to-card link (NVLink on an H100) per
    direction, and ``dcn_bandwidth`` the per-card bandwidth between
    hosts; ``ici_hop_latency`` the per-hop latency of a ring step. The
    last two are planning assumptions, labelled so where they are used.
    ``peak_flops_f32`` is the rate of f32 arithmetic outside the tensor
    cores."""

    name: str
    peak_flops_bf16: float  # FLOP/s, dense
    peak_flops_f32: float  # FLOP/s
    hbm_bandwidth: float  # bytes/s
    ici_bandwidth: float  # bytes/s per direction
    dcn_bandwidth: float  # bytes/s per card (assumed)
    ici_hop_latency: float  # seconds per ring hop (assumed)


# NVIDIA H100 SXM5 80 GB, from NVIDIA's H100 data sheet: 989 TFLOP/s
# dense bf16 on the tensor cores, 67 TFLOP/s f32 outside them, 3.35 TB/s
# of HBM3. The ICI field holds NVLink 4: 900 GB/s bidirectional, 450 GB/s
# per direction. The DCN field assumes one 400 Gb/s NDR InfiniBand port a
# card (50 GB/s), and the hop latency 1 µs: both planning assumptions.
H100_SXM = ChipSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    peak_flops_f32=67e12,
    hbm_bandwidth=3.35e12,
    ici_bandwidth=450e9,
    dcn_bandwidth=50e9,
    ici_hop_latency=1e-6,
)

# torch.cuda.get_device_name() of the cards a spec covers (the SXM card
# only: the PCIe H100 has other peaks).
KNOWN_CARDS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def roofline(
    flops: float,
    hbm_bytes: float,
    *,
    ici_bytes: float = 0.0,
    chip: ChipSpec = H100_SXM,
) -> dict[str, Any]:
    """Lower-bound step time from the card's peaks (perfect overlap
    assumed) and the binding resource. Modeled, not measured."""
    t_compute = flops / chip.peak_flops_bf16
    t_hbm = hbm_bytes / chip.hbm_bandwidth
    t_ici = ici_bytes / chip.ici_bandwidth if ici_bytes else 0.0
    t = max(t_compute, t_hbm, t_ici)
    bound = {t_compute: "compute", t_hbm: "hbm", t_ici: "ici"}[t]
    return {
        "seconds_lower_bound": t,
        "bound": bound,
        "arithmetic_intensity": flops / hbm_bytes if hbm_bytes else float("inf"),
        "chip": chip.name,
        "modeled": True,
    }


def tree_bytes(tree: Any) -> int:
    """Total bytes of the tensors (or arrays) in a nest of dicts, lists
    and tuples."""
    total = 0
    for leaf in _leaves(tree):
        if hasattr(leaf, "element_size"):
            total += leaf.numel() * leaf.element_size()
        elif hasattr(leaf, "nbytes") and hasattr(leaf, "dtype"):
            total += int(leaf.nbytes)
    return total


def collective_bytes(payload_bytes: float, num_devices: int, op: str = "allreduce") -> float:
    """Per-card wire bytes of a ring collective over ``num_devices``:
    allreduce 2·(P−1)/P·N; reduce_scatter, all_gather, alltoall
    (P−1)/P·N; broadcast N."""
    p = num_devices
    if p <= 1:
        return 0.0
    n = float(payload_bytes)
    if op == "allreduce":
        return 2.0 * (p - 1) / p * n
    if op in ("reduce_scatter", "all_gather", "alltoall"):
        return (p - 1) / p * n
    if op == "broadcast":
        return n
    raise ValueError(f"unknown op {op!r}")


def allreduce_gbps(payload_bytes: float, num_devices: int, seconds: float) -> float:
    """Algorithm bandwidth (payload / time, the MPI convention)."""
    del num_devices
    return payload_bytes / seconds / 1e9


def modeled_allreduce_seconds(
    payload_bytes: float, num_devices: int, *, chip: ChipSpec = H100_SXM
) -> float:
    """Ring allreduce: ``2·(P−1)`` hops of latency plus the wire bytes at
    both directions' bandwidth. Equals the reduce-scatter plus the
    all-gather model at the same payload. Modeled, not measured."""
    p = num_devices
    if p <= 1:
        return 0.0
    wire = collective_bytes(payload_bytes, p, "allreduce")
    return 2.0 * (p - 1) * chip.ici_hop_latency + wire / (2.0 * chip.ici_bandwidth)


def _modeled_phase_seconds(payload_bytes: float, num_devices: int, op: str,
                           chip: ChipSpec) -> float:
    p = num_devices
    if p <= 1:
        return 0.0
    wire = collective_bytes(payload_bytes, p, op)
    return (p - 1) * chip.ici_hop_latency + wire / (2.0 * chip.ici_bandwidth)


def modeled_reduce_scatter_seconds(
    payload_bytes: float, num_devices: int, *, chip: ChipSpec = H100_SXM
) -> float:
    """Ring reduce-scatter: ``P−1`` hops and ``(P−1)/P·N`` wire bytes
    (``payload_bytes`` as on the wire: the int8 size for ``ring_q8``)."""
    return _modeled_phase_seconds(payload_bytes, num_devices, "reduce_scatter", chip)


def modeled_all_gather_seconds(
    payload_bytes: float, num_devices: int, *, chip: ChipSpec = H100_SXM
) -> float:
    """Ring all-gather, the other half of the allreduce."""
    return _modeled_phase_seconds(payload_bytes, num_devices, "all_gather", chip)


def scaling_projection(
    step_seconds: float,
    items_per_step_per_chip: float,
    params: Any,
    *,
    chips: Sequence[int] = (8, 32, 64, 128, 256),
    slice_size: int = 256,
    zero1: bool = True,
    chip: ChipSpec = H100_SXM,
    alltoall_payload_bytes: float = 0.0,
    alltoall_group: int = 0,
    alltoall_passes: int = 1,
) -> dict[str, Any]:
    """Data-parallel weak-scaling projection from one card's measured
    step: the JAX package's model (compute = the measured step; comm =
    :class:`CommModel`'s hierarchical sync, the cross-"slice" phase over
    ``dcn_bandwidth``; no-overlap and full-overlap brackets; an optional
    all-to-all on the critical path). Labelled ``modeled``."""
    points = []
    t1_throughput = items_per_step_per_chip / step_seconds
    for n in chips:
        num_slices = max(1, -(-n // slice_size))
        if n % max(num_slices, 1):
            raise ValueError(f"{n} chips not divisible into {num_slices} slices")
        m = CommModel(params, n, zero1=zero1, num_slices=num_slices)
        t = m.grad_sync_seconds(chip)
        t_a2a = 0.0
        if alltoall_payload_bytes and alltoall_group > 1:
            g = min(alltoall_group, n)
            if g > 1:
                wire = collective_bytes(alltoall_payload_bytes, g, "alltoall")
                t_a2a = (
                    max(1, alltoall_passes) * (g - 1) * chip.ici_hop_latency
                    + wire / chip.ici_bandwidth
                )
        t_none = step_seconds + t["total_s"] + t_a2a
        t_full = max(step_seconds, t["total_s"]) + t_a2a
        thpt_none = n * items_per_step_per_chip / t_none
        thpt_full = n * items_per_step_per_chip / t_full
        point = {
            "chips": n,
            "num_slices": num_slices,
            "comm_ici_s": round(t["ici_s"], 6),
            "comm_dcn_s": round(t["dcn_s"], 6),
            "items_per_sec_no_overlap": round(thpt_none, 1),
            "items_per_sec_full_overlap": round(thpt_full, 1),
            "efficiency_no_overlap": round(thpt_none / (n * t1_throughput), 4),
            "efficiency_full_overlap": round(thpt_full / (n * t1_throughput), 4),
        }
        if alltoall_payload_bytes:
            point["comm_alltoall_s"] = round(t_a2a, 6)
        points.append(point)
    by_chips = {p["chips"]: p for p in points}
    out: dict[str, Any] = {
        "modeled": True,
        "assumptions": {
            "chip": chip.name,
            "ici_bandwidth_Bps": chip.ici_bandwidth,
            "dcn_bandwidth_Bps_per_chip": chip.dcn_bandwidth,
            "slice_size": slice_size,
            "weak_scaling": "fixed per-chip batch",
            "measured_step_seconds_1chip": round(step_seconds, 6),
            "wire_model": "bandwidth-optimal ring, zero latency/congestion",
        },
        "points": points,
    }
    if alltoall_payload_bytes:
        out["assumptions"]["alltoall_payload_bytes_per_chip_per_step"] = float(
            alltoall_payload_bytes)
        out["assumptions"]["alltoall_group"] = int(alltoall_group)
        out["assumptions"]["alltoall_passes_per_step"] = int(max(1, alltoall_passes))
        out["assumptions"]["alltoall_model"] = (
            "ring alltoall (P-1)/P wire + per-pass per-hop latency, on "
            "the critical path (not overlappable)"
        )
    if 8 in by_chips and 256 in by_chips:
        out["efficiency_8_to_256_no_overlap"] = round(
            by_chips[256]["efficiency_no_overlap"] / by_chips[8]["efficiency_no_overlap"], 4)
        out["efficiency_8_to_256_full_overlap"] = round(
            by_chips[256]["efficiency_full_overlap"]
            / by_chips[8]["efficiency_full_overlap"], 4)
    return out


class CommModel:
    """Per-step gradient-sync wire bytes of a data-parallel config
    (allreduce, or ZeRO-1's reduce-scatter + all-gather: the same bytes),
    split into the intra-"slice" phase (the card links) and, with
    ``num_slices > 1``, the cross-slice phase. ``wire_scale`` is the wire
    bytes per logical byte (¼ for ``ring_q8``'s int8 chunks of f32
    grads)."""

    def __init__(
        self,
        params,
        num_devices: int,
        *,
        zero1: bool = True,
        num_slices: int = 1,
        wire_scale: float = 1.0,
    ):
        if num_slices > 1 and num_devices % num_slices:
            raise ValueError(f"{num_devices} devices not divisible into {num_slices} slices")
        if wire_scale <= 0:
            raise ValueError(f"wire_scale must be positive, got {wire_scale}")
        self.param_bytes = params if isinstance(params, (int, float)) else tree_bytes(params)
        self.num_devices = num_devices
        self.zero1 = zero1
        self.num_slices = num_slices if num_devices > 1 else 1
        self.wire_scale = float(wire_scale)

    def _phase_bytes(self, payload: float, p: int) -> float:
        return collective_bytes(payload * self.wire_scale, p, "allreduce")

    def grad_sync_bytes(self) -> float:
        ici, dcn = self.grad_sync_bytes_by_tier()
        return ici + dcn

    def grad_sync_bytes_by_tier(self) -> tuple[float, float]:
        if self.num_devices <= 1:
            return 0.0, 0.0
        s = self.num_slices
        if s <= 1:
            return self._phase_bytes(self.param_bytes, self.num_devices), 0.0
        per_slice = self.num_devices // s
        intra = self._phase_bytes(self.param_bytes, per_slice)
        inter = self._phase_bytes(self.param_bytes / per_slice, s)
        return intra, inter

    def grad_sync_seconds(self, chip: ChipSpec = H100_SXM) -> dict[str, float]:
        """Modeled sync time, the phases serialized."""
        ici_b, dcn_b = self.grad_sync_bytes_by_tier()
        t_ici = ici_b / chip.ici_bandwidth
        t_dcn = dcn_b / chip.dcn_bandwidth
        return {"ici_s": t_ici, "dcn_s": t_dcn, "total_s": t_ici + t_dcn, "modeled": True}

    def summary(self) -> dict[str, float]:
        ici_b, dcn_b = self.grad_sync_bytes_by_tier()
        out = {
            "param_bytes": float(self.param_bytes),
            "grad_sync_bytes_per_step": ici_b + dcn_b,
            "num_devices": self.num_devices,
        }
        if self.num_slices > 1:
            out["grad_sync_ici_bytes"] = ici_b
            out["grad_sync_dcn_bytes"] = dcn_b
            out["num_slices"] = self.num_slices
        return out


# ---------------------------------------------------------------------------
# Analytic step costs (the port's stand-in for XLA's cost_analysis).
# ---------------------------------------------------------------------------


def gpt2_matmul_flops(cfg, rows: int, head_rows: int) -> float:
    """FLOPs of the dense layers over ``rows`` token rows (qkv, proj, fc
    and out in every block: ``2·rows·L·(3D² + D² + 2·D·F)``) plus the LM
    head over ``head_rows`` rows (``2·head_rows·D·V``)."""
    d, f = cfg.d_model, cfg.ff_dim
    per_row = 3 * d * d + d * d + d * f + f * d
    return 2.0 * rows * cfg.num_layers * per_row + 2.0 * head_rows * d * cfg.vocab_size


def gpt2_step_cost(
    cfg,
    kind: str,
    *,
    slots: int,
    width: int = 1,
    ctx: int,
    param_bytes: float,
    kv_row_bytes: float = 0.0,
    head_rows: int | None = None,
) -> dict:
    """Analytic per-execution cost of one GPT-2 step over ``slots`` rows
    of ``width`` tokens each, attending over a key window of ``ctx``
    positions (the padded window the step addresses: the cache length,
    or the training sequence):

    - ``flops`` = the dense layers' and LM head's matmuls
      (:func:`gpt2_matmul_flops`, the head over ``head_rows``, default
      one row a slot) plus the attention products, ``4·L·D`` per
      (query row, key) pair over ``slots·width·ctx`` pairs; ``kind
      "train"`` is three forwards' worth (forward, and the backward's
      two products a matmul), the head over every row;
    - ``hbm_bytes`` = the weights once (``param_bytes``: the store at
      wire width), the K and V rows of the window read
      (``2·L·slots·ctx·kv_row_bytes``) and the rows written
      (``2·L·slots·width·kv_row_bytes``); for ``"train"``, ten passes
      over the f32 parameters (the forward's and the backward's reads,
      the gradient's write, Adam's reads of parameter, gradient and two
      moments and writes of parameter and moments). Activations are
      left out.

    Kinds: ``prefill``, ``decode`` (``width`` 1), ``spec_verify``
    (``width`` k + 1, the head over every row), ``spec_draft`` (``width``
    k: k T = 1 steps of the draft, the head over every row) and
    ``train``."""
    rows = slots * width
    pairs = rows * ctx
    attn = 4.0 * cfg.num_layers * cfg.d_model * pairs
    if kind == "train":
        mm = gpt2_matmul_flops(cfg, rows, rows)
        return {
            "flops": 3.0 * (mm + attn),
            "matmul_flops": 3.0 * mm,
            "hbm_bytes": 10.0 * float(param_bytes),
            "source": "analytic",
        }
    if kind not in ("prefill", "decode", "spec_verify", "spec_draft"):
        raise ValueError(f"unknown step kind {kind!r}")
    if head_rows is None:
        head_rows = rows if kind in ("spec_verify", "spec_draft") else slots
    mm = gpt2_matmul_flops(cfg, rows, head_rows)
    kv = 2.0 * cfg.num_layers * kv_row_bytes * (slots * ctx + rows)
    return {
        "flops": mm + attn,
        "matmul_flops": mm,
        "hbm_bytes": float(param_bytes) + kv,
        "source": "analytic",
    }
