"""KV shipment: moving finished prefill state between fleet workers, the
port of :mod:`mpit_tpu.serve.shipment`.

The disaggregated fleet splits a request's life across two engines: a
prefill worker fills the KV rows, a decode worker streams the output
tokens. The hand-off is a **shipment** — the slot's first ``length``
cached KV rows in the canonical dense row layout ``[L, length, H, Dh]``
(an int8 cache ships four leaves: int8 payloads plus their ``[L,
length, H, 1]`` f32 scale blocks) plus the request facts the decode
side needs (prompt, first sampled token, sampling params).

Wire format — three length-prefixed messages on the dedicated
``Comm_dup(key="fleet-kv")`` channel, in per-(src, tag) FIFO order, byte
for byte the JAX package's:

1. ``TAG_SHIP_HDR``: ``int64[2]`` = ``[meta_len, payload_len]`` — the
   receiver sizes its buffers from this (compat's ``_check_transfer``
   demands exact size + dtype matches).
2. ``TAG_SHIP_META``: ``uint8[meta_len]`` JSON (``sort_keys``) — request
   facts + one shape/dtype descriptor per leaf, in the explicit leaf
   order ``[k, v]`` (or ``[k.q, k.scale, v.q, v.scale]``). Dtypes are
   named as numpy names them (``"float32"``, ``"bfloat16"``, ``"int8"``).
3. ``TAG_SHIP_PAYLOAD``: ``uint8[payload_len]`` — the leaves' raw bytes
   concatenated in that same order.

Header and meta are CPU tensors. The payload lives where the leaves
live: an engine on the card packs it on the card (each leaf's bytes
through ``.view(torch.uint8)`` into one uint8 CUDA tensor), and the
compat simulator moves it card to card through the CUDA copy kernel
(:mod:`mpit_tpu_torch.ops.kv_ship`) — the snapshot at ``Send`` and the
delivery into the decode worker's buffer — without a trip through host
memory. :func:`ship_kv_remote` is that kernel's whole-buffer form under
the JAX package's name.

Each serialize/deserialize site takes an optional ``ledger`` and emits a
``kv_ship_*`` event when given one.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np
import torch

from mpit_tpu_torch import compat as mpiT
from mpit_tpu_torch.ops.kv_ship import byte_view, ship_bytes

__all__ = [
    "KVShipment",
    "SHIPMENT_CHANNEL",
    "TAG_SHIP_HDR",
    "TAG_SHIP_META",
    "TAG_SHIP_PAYLOAD",
    "inject_shipment",
    "pack_shipment",
    "recv_shipment",
    "send_shipment",
    "ship_kv_remote",
    "unpack_shipment",
]

# Dedicated matching space for KV payloads: bulk shipments never race
# the fleet's small control messages for a Probe slot.
SHIPMENT_CHANNEL = "fleet-kv"

# Tag block 61-63 (fleet control uses 41-46 — disjoint).
TAG_SHIP_HDR = 61
TAG_SHIP_META = 62
TAG_SHIP_PAYLOAD = 63

# Wire dtype names (numpy's) <-> torch dtypes: the K/V storage types.
_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
}
_NAMES = {dt: name for name, dt in _DTYPES.items()}


def _dtype_name(dtype: torch.dtype) -> str:
    try:
        return _NAMES[dtype]
    except KeyError:
        raise ValueError(f"no shipment wire name for dtype {dtype}") from None


@dataclasses.dataclass
class KVShipment:
    """One request's prefill hand-off.

    ``k``/``v`` are tensors ``[L, length, H, Dh]`` — or, when
    ``quantized``, objects with ``.q`` (int8, same shape) and ``.scale``
    (f32 ``[L, length, H, 1]``) attributes (``QuantizedKV`` fits; the
    wire never sees the container type, only the four leaves).
    ``first_token`` is the token prefill sampled — output token 1, and
    the decode worker's starting ``last_token``.
    """

    rid: str
    prompt: list[int]
    first_token: int
    length: int
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    eos_id: int | None = None
    quantized: bool = False
    k: Any = None
    v: Any = None

    def leaves(self) -> list[tuple[str, Any]]:
        """The wire leaf order — explicit, not derived from a container."""
        if self.quantized:
            return [
                ("k.q", self.k.q),
                ("k.scale", self.k.scale),
                ("v.q", self.v.q),
                ("v.scale", self.v.scale),
            ]
        return [("k", self.k), ("v", self.v)]


@dataclasses.dataclass
class _QuantPair:
    """Wire-side stand-in for a quantized leaf pair; the engine's
    ``inject_kv_rows`` reads ``.q`` / ``.scale`` positionally."""

    q: torch.Tensor
    scale: torch.Tensor


def _leaf_tensor(arr) -> torch.Tensor:
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.asarray(arr))
    return t.contiguous()


def pack_shipment(
    ship: KVShipment, *, ledger=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Serialize to the three wire messages: ``(header int64[2], meta
    uint8[m], payload uint8[n])``; header and meta on the CPU, the
    payload on the leaves' device."""
    leaves = [(name, _leaf_tensor(arr)) for name, arr in ship.leaves()]
    devices = {t.device for _, t in leaves}
    if len(devices) > 1:
        raise ValueError(f"shipment leaves lie on several devices: {sorted(map(str, devices))}")
    meta = {
        "rid": str(ship.rid),
        "prompt": [int(t) for t in ship.prompt],
        "first_token": int(ship.first_token),
        "length": int(ship.length),
        "max_new_tokens": int(ship.max_new_tokens),
        "temperature": float(ship.temperature),
        "top_k": int(ship.top_k),
        "eos_id": None if ship.eos_id is None else int(ship.eos_id),
        "quantized": bool(ship.quantized),
        "leaves": [
            {"name": name, "shape": list(t.shape), "dtype": _dtype_name(t.dtype)}
            for name, t in leaves
        ],
    }
    meta_buf = torch.frombuffer(
        bytearray(json.dumps(meta, sort_keys=True).encode("utf-8")), dtype=torch.uint8
    )
    payload = (
        torch.cat([byte_view(t) for _, t in leaves])
        if leaves
        else torch.empty((0,), dtype=torch.uint8)
    )
    header = torch.tensor([meta_buf.numel(), payload.numel()], dtype=torch.int64)
    if ledger is not None:
        ledger.event(
            ship.rid, "kv_ship_pack",
            bytes=payload.numel(), rows=int(ship.length),
            quantized=bool(ship.quantized),
        )
    return header, meta_buf, payload


def unpack_shipment(meta_buf, payload, *, ledger=None) -> KVShipment:
    """Inverse of :func:`pack_shipment` — slices the payload back into
    leaves by the meta descriptors (same explicit order). The leaves are
    views of ``payload`` where their offsets allow, on its device."""
    meta = json.loads(bytes(np.asarray(meta_buf, np.uint8)).decode("utf-8"))
    raw = payload if isinstance(payload, torch.Tensor) else torch.from_numpy(
        np.asarray(payload, np.uint8)
    )
    dtypes = [_DTYPES[d["dtype"]] for d in meta["leaves"]]
    items = [torch.empty((), dtype=dt).element_size() for dt in dtypes]
    sizes = [
        int(np.prod(d["shape"], dtype=np.int64)) * item
        for d, item in zip(meta["leaves"], items)
    ]
    if sum(sizes) != raw.numel():
        raise ValueError(
            f"shipment payload size mismatch: descriptors cover {sum(sizes)} "
            f"bytes, payload carries {raw.numel()}"
        )
    arrays: list[torch.Tensor] = []
    off = 0
    for d, dt, item, n in zip(meta["leaves"], dtypes, items, sizes):
        piece = raw[off : off + n]
        if off % item:
            piece = piece.clone()  # a view of another dtype needs aligned bytes
        arrays.append(piece.view(dt).reshape(d["shape"]))
        off += n
    if meta["quantized"]:
        k = _QuantPair(q=arrays[0], scale=arrays[1])
        v = _QuantPair(q=arrays[2], scale=arrays[3])
    else:
        k, v = arrays
    ship = KVShipment(
        rid=meta["rid"],
        prompt=list(meta["prompt"]),
        first_token=int(meta["first_token"]),
        length=int(meta["length"]),
        max_new_tokens=int(meta["max_new_tokens"]),
        temperature=float(meta["temperature"]),
        top_k=int(meta["top_k"]),
        eos_id=meta["eos_id"],
        quantized=bool(meta["quantized"]),
        k=k,
        v=v,
    )
    if ledger is not None:
        ledger.event(
            ship.rid, "kv_ship_unpack",
            bytes=raw.numel(), rows=int(ship.length),
        )
    return ship


def send_shipment(ship: KVShipment, dest: int, comm, *, ledger=None) -> int:
    """Ship to ``dest`` on the KV channel: header, meta, payload — three
    Sends whose per-(src, tag) FIFO ordering the receiver relies on.
    Returns the payload byte count."""
    header, meta_buf, payload = pack_shipment(ship)
    mpiT.Send(header, dest=dest, tag=TAG_SHIP_HDR, comm=comm)
    mpiT.Send(meta_buf, dest=dest, tag=TAG_SHIP_META, comm=comm)
    mpiT.Send(payload, dest=dest, tag=TAG_SHIP_PAYLOAD, comm=comm)
    if ledger is not None:
        ledger.event(
            ship.rid, "kv_ship_send",
            dest=int(dest), bytes=payload.numel(), rows=int(ship.length),
        )
    return payload.numel()


def recv_shipment(
    src: int, comm, *, device, timeout: float | None = None, ledger=None
) -> KVShipment:
    """Receive one shipment from ``src``: header first (sizes the
    buffers), then meta and payload. The payload buffer is allocated on
    ``device``, a required keyword: it must be the device the sender
    packed on (compat refuses a message that would change device), and
    the port's entry points run on the card. ``timeout`` applies to
    the header wait only — the remaining frames are already FIFO-queued
    behind it (compat Send is buffered)."""
    header = torch.empty((2,), dtype=torch.int64)
    kw = {} if timeout is None else {"timeout": timeout}
    mpiT.Recv(header, src=src, tag=TAG_SHIP_HDR, comm=comm, **kw)
    meta_buf = torch.empty((int(header[0]),), dtype=torch.uint8)
    payload = torch.empty((int(header[1]),), dtype=torch.uint8, device=device)
    mpiT.Recv(meta_buf, src=src, tag=TAG_SHIP_META, comm=comm)
    mpiT.Recv(payload, src=src, tag=TAG_SHIP_PAYLOAD, comm=comm)
    ship = unpack_shipment(meta_buf, payload)
    if ledger is not None:
        ledger.event(
            ship.rid, "kv_ship_recv",
            src=int(src), bytes=payload.numel(), rows=int(ship.length),
        )
    return ship


def inject_shipment(engine, slot: int, ship: KVShipment, *, ledger=None):
    """Install a received shipment into ``slot`` of a decode engine:
    KV rows, fill length, and ``last_token`` (= the shipped first
    token). The caller has already admitted the slot (paged: an
    all-or-nothing ``allocator.admit`` — no ``register_prefix``;
    injected pages are private, never prefix-shared)."""
    engine.inject_kv_rows(slot, ship.k, ship.v, ship.length, ship.first_token)
    if ledger is not None:
        ledger.event(
            ship.rid, "kv_ship_inject",
            slot=int(slot), rows=int(ship.length),
        )


def ship_kv_remote(buf: torch.Tensor, dst_device) -> torch.Tensor:
    """Device-to-device transfer of a whole buffer (any dtype and shape):
    a copy of ``buf`` on ``dst_device``, made by the CUDA copy kernel
    (the plain ``copy_`` for a CPU tensor). ``dst_device`` is a device
    index or a ``torch.device``; on one card it is ``buf``'s own device.
    A copy to another card needs the multi-card form and raises."""
    if isinstance(dst_device, int):
        dst = torch.device("cuda", dst_device) if buf.is_cuda else buf.device
    else:
        dst = torch.device(dst_device)
        if dst.type == "cuda" and dst.index is None:
            dst = torch.device("cuda", torch.cuda.current_device())
    if dst != buf.device:
        raise NotImplementedError(
            f"ship_kv_remote from {buf.device} to {dst}: copies between cards "
            "wait for the multi-card form (ROADMAP.md §A 14)"
        )
    out = torch.empty(buf.shape, dtype=buf.dtype, device=buf.device)
    return ship_bytes(buf.contiguous() if not buf.is_cuda else buf, out)

