"""Open-loop load generation: seeded arrival traces, as in
:mod:`mpit_tpu.serve.loadgen` (a numpy copy; a trace is bit-equal to the
JAX package's for the same spec, vocabulary, duration and seed).

A closed-loop stream submits every request up front, so the queue can
only drain. Open-loop traffic arrives on its own clock whether or not
the server keeps up: past saturation the queue grows and TTFT climbs,
which a closed-loop stream never shows.

- :class:`LoadSpec` — the process: mean ``rate`` req/s, ``"poisson"``
  or ``"bursty"`` (on/off modulated Poisson: silent off-phases, on-phases
  at ``rate / on_fraction``, so the long-run mean stays ``rate``), a
  mixture of :class:`RequestClass` shapes, and random ``tenants``;
- :func:`generate_arrivals` — one trace, ``[Arrival(t, Request)]``
  sorted by time, fixed by ``(spec, vocab_size, duration_s,
  max_requests, seed)``;
- :func:`split_arrivals` — one trace dealt across admission streams;
- :func:`parse_load_spec` — ``"rate=8,process=bursty,tenants=4"`` →
  :class:`LoadSpec`, the serve CLI's ``--loadgen`` syntax.

``Server.run_timed`` (:mod:`mpit_tpu_torch.serve.scheduler`) submits
each request when its arrival clock comes due. Importing this module
loads neither numpy nor torch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = [
    "Arrival",
    "LoadSpec",
    "RequestClass",
    "generate_arrivals",
    "parse_load_spec",
    "split_arrivals",
]


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """One shape class in the traffic mix: uniform prompt/output-length
    ranges (inclusive) drawn per request, weighted against the other
    classes; the class name rides ``Arrival.klass``.

    ``prefix_len`` prepends a shared prefix of that many tokens to every
    prompt of the class (the system-prompt pattern the paged engine's
    prefix sharing serves). One prefix sequence is drawn per trace and
    shared by all classes: a shorter ``prefix_len`` uses the first
    tokens of the longest one, so class prefixes nest.

    ``priority`` / ``ttft_target_s`` are stamped onto every request of
    the class: the scheduling policy's tier (0 = highest) and the TTFT
    target its admission and preemption decisions use (0 = none).
    Neither draws from the rng, so a trace without them is unchanged.
    """

    name: str
    weight: float = 1.0
    prompt_len: tuple[int, int] = (4, 16)
    max_new_tokens: tuple[int, int] = (8, 32)
    prefix_len: int = 0
    priority: int = 0
    ttft_target_s: float = 0.0

    def __post_init__(self):
        for field, (lo, hi) in (
            ("prompt_len", self.prompt_len),
            ("max_new_tokens", self.max_new_tokens),
        ):
            if not 1 <= lo <= hi:
                raise ValueError(
                    f"class {self.name!r}: {field} range must satisfy "
                    f"1 <= lo <= hi, got ({lo}, {hi})"
                )
        if self.weight <= 0:
            raise ValueError(
                f"class {self.name!r}: weight must be > 0, got {self.weight}"
            )
        if self.prefix_len < 0:
            raise ValueError(
                f"class {self.name!r}: prefix_len must be >= 0, got "
                f"{self.prefix_len}"
            )
        if self.priority < 0:
            raise ValueError(
                f"class {self.name!r}: priority must be >= 0, got "
                f"{self.priority}"
            )
        if self.ttft_target_s < 0:
            raise ValueError(
                f"class {self.name!r}: ttft_target_s must be >= 0, got "
                f"{self.ttft_target_s}"
            )

    @property
    def max_prompt_total(self) -> int:
        """Largest total prompt this class can draw (prefix included) —
        what engine-geometry validation must bound."""
        return self.prefix_len + self.prompt_len[1]


# The default mix: mostly short interactive turns, a tail of long
# batch requests.
DEFAULT_MIX = (
    RequestClass("interactive", weight=0.8, prompt_len=(2, 12),
                 max_new_tokens=(4, 16)),
    RequestClass("batch", weight=0.2, prompt_len=(12, 28),
                 max_new_tokens=(16, 48)),
)


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """Declarative open-loop arrival process.

    ``rate`` is the long-run MEAN arrival rate (req/s) for both
    processes; ``bursty`` concentrates it into on-phases of mean
    ``mean_on_s`` seconds at ``rate / on_fraction`` req/s separated by
    silent off-phases (phase durations exponential, time-fraction on =
    ``on_fraction``). ``tenants`` > 0 stamps each request with a
    uniform-random ``t<k>`` tenant id.
    """

    rate: float
    process: str = "poisson"
    on_fraction: float = 0.25
    mean_on_s: float = 1.0
    tenants: int = 0
    classes: tuple[RequestClass, ...] = DEFAULT_MIX
    temperature: float = 0.0
    top_k: int = 0

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(f"rate must be > 0 req/s, got {self.rate}")
        if self.process not in ("poisson", "bursty"):
            raise ValueError(
                f"process must be poisson|bursty, got {self.process!r}"
            )
        if not 0.0 < self.on_fraction <= 1.0:
            raise ValueError(
                f"on_fraction must be in (0, 1], got {self.on_fraction}"
            )
        if self.mean_on_s <= 0:
            raise ValueError(f"mean_on_s must be > 0, got {self.mean_on_s}")
        if not self.classes:
            raise ValueError("need at least one RequestClass")
        if self.tenants < 0:
            raise ValueError(f"tenants must be >= 0, got {self.tenants}")


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request and the moment it arrives (seconds from stream
    start — ``Server.run_timed`` maps it onto its own wall clock)."""

    t: float
    request: Any  # serve.scheduler.Request (imported lazily)
    klass: str = ""


def _arrival_times(spec: LoadSpec, rng, duration_s: float,
                   max_requests: int) -> list[float]:
    """Times in [0, duration_s), at most max_requests of them."""
    times: list[float] = []
    if spec.process == "poisson":
        t = 0.0
        while len(times) < max_requests:
            t += float(rng.exponential(1.0 / spec.rate))
            if t >= duration_s:
                break
            times.append(t)
        return times
    # Bursty: walk exponential on/off phases; arrivals only in ON
    # phases, at the elevated rate. mean_off chosen so the expected
    # time-fraction on is on_fraction (=> long-run mean rate == rate).
    rate_on = spec.rate / spec.on_fraction
    mean_off = spec.mean_on_s * (1.0 - spec.on_fraction) / spec.on_fraction
    t = 0.0
    while t < duration_s and len(times) < max_requests:
        on_end = t + float(rng.exponential(spec.mean_on_s))
        while len(times) < max_requests:
            t += float(rng.exponential(1.0 / rate_on))
            if t >= on_end or t >= duration_s:
                break
            times.append(t)
        t = max(t, on_end)
        if mean_off > 0.0:
            t += float(rng.exponential(mean_off))
    return times


def generate_arrivals(
    spec: LoadSpec,
    *,
    vocab_size: int,
    duration_s: float,
    max_requests: int = 100_000,
    seed: int = 0,
    eos_id: int | None = None,
) -> list[Arrival]:
    """Materialize one arrival trace: sorted :class:`Arrival` records,
    fully determined by ``(spec, vocab_size, duration_s, max_requests,
    seed)``. ``max_requests`` bounds the trace, which is built up front
    so a run is replayable."""
    if duration_s <= 0:
        raise ValueError(f"duration_s must be > 0, got {duration_s}")
    # Lazy imports: numpy (the traces are RandomState streams) and the
    # scheduler's Request (whose module chain reaches torch) load only
    # when a trace is generated.
    import numpy as np

    from mpit_tpu_torch.serve.scheduler import Request

    rng = np.random.RandomState(seed)
    times = _arrival_times(spec, rng, duration_s, max_requests)
    weights = np.asarray([c.weight for c in spec.classes], np.float64)
    weights /= weights.sum()
    # One shared prefix per trace, drawn only when a class asks for one
    # (prefix-free specs keep their rng stream): class k's prefix is its
    # first ``prefix_len`` tokens.
    max_pref = max((c.prefix_len for c in spec.classes), default=0)
    prefix_pool = (
        rng.randint(0, vocab_size, size=max_pref).tolist()
        if max_pref
        else []
    )
    out: list[Arrival] = []
    for i, t in enumerate(times):
        klass = spec.classes[int(rng.choice(len(spec.classes), p=weights))]
        plen = int(rng.randint(klass.prompt_len[0],
                               klass.prompt_len[1] + 1))
        new = int(rng.randint(klass.max_new_tokens[0],
                              klass.max_new_tokens[1] + 1))
        tenant = (
            f"t{int(rng.randint(spec.tenants))}" if spec.tenants else ""
        )
        out.append(
            Arrival(
                t=t,
                klass=klass.name,
                request=Request(
                    rid=i,
                    prompt=prefix_pool[: klass.prefix_len]
                    + rng.randint(0, vocab_size, size=plen).tolist(),
                    max_new_tokens=new,
                    temperature=spec.temperature,
                    top_k=spec.top_k,
                    eos_id=eos_id,
                    tenant=tenant,
                    priority=klass.priority,
                    ttft_target_s=klass.ttft_target_s,
                ),
            )
        )
    return out


def split_arrivals(arrivals, shards: int, *, seed: int = 0) -> list:
    """Deal one materialized trace across ``shards`` admission streams.

    The shard draw uses its own ``RandomState(seed)``, never the trace
    generator's, so a trace is the same whether or not it is split
    later. Each shard keeps the trace's time order; the same
    ``(arrivals, shards, seed)`` always deals the same way.
    """
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    arrivals = list(arrivals)
    if shards == 1:
        return [arrivals]
    import numpy as np

    rng = np.random.RandomState(seed)
    assign = rng.randint(0, shards, size=len(arrivals))
    out: list[list] = [[] for _ in range(shards)]
    for arrival, shard in zip(arrivals, assign):
        out[int(shard)].append(arrival)
    return out


# Keys parse_load_spec accepts, with their coercions. Prompt/output
# ranges collapse the class mix to one uniform class; the full mixture
# stays programmatic. ``prefix`` stamps a shared prefix length onto
# every class.
_SPEC_KEYS = {
    "rate": float,
    "process": str,
    "on_fraction": float,
    "mean_on_s": float,
    "tenants": int,
}
_RANGE_KEYS = ("prompt_min", "prompt_max", "new_min", "new_max")


def parse_load_spec(text: str) -> LoadSpec:
    """``"rate=8,process=bursty,on_fraction=0.25,tenants=4,prefix=32"``
    → :class:`LoadSpec` (the serve CLI's ``--loadgen`` value).

    Optional ``prompt_min/prompt_max/new_min/new_max`` replace the
    default interactive/batch mixture with a single uniform class over
    those ranges; ``prefix=N`` gives every class an N-token shared
    prefix (the trace-wide system prompt); ``priority=P`` /
    ``ttft_target=S`` stamp the scheduling policy's tier and TTFT target
    onto every class. None of the three draws from the rng.
    """
    kw: dict = {}
    ranges: dict[str, int] = {}
    prefix = 0
    stamp: dict = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"--loadgen parts are key=value, got {part!r}"
            )
        key, val = part.split("=", 1)
        key = key.strip()
        if key in _SPEC_KEYS:
            kw[key] = _SPEC_KEYS[key](val)
        elif key in _RANGE_KEYS:
            ranges[key] = int(val)
        elif key == "prefix":
            prefix = int(val)
        elif key == "priority":
            stamp["priority"] = int(val)
        elif key == "ttft_target":
            stamp["ttft_target_s"] = float(val)
        else:
            raise ValueError(
                f"unknown --loadgen key {key!r} (valid: "
                f"{', '.join((*_SPEC_KEYS, *_RANGE_KEYS, 'prefix', 'priority', 'ttft_target'))})"
            )
    if "rate" not in kw:
        raise ValueError("--loadgen needs rate=<req/s>")
    if ranges:
        kw["classes"] = (
            RequestClass(
                "uniform",
                prompt_len=(ranges.get("prompt_min", 4),
                            ranges.get("prompt_max", 16)),
                max_new_tokens=(ranges.get("new_min", 8),
                                ranges.get("new_max", 32)),
            ),
        )
    if prefix:
        stamp["prefix_len"] = prefix
    if stamp:
        kw["classes"] = tuple(
            dataclasses.replace(c, **stamp)
            for c in kw.get("classes", DEFAULT_MIX)
        )
    return LoadSpec(**kw)
