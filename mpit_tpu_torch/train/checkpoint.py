"""Checkpoints of the training state: the port of
:mod:`mpit_tpu.train.checkpoint`.

- :class:`AtomicCheckpoint` — crash-consistent checkpoints of a
  :class:`~mpit_tpu_torch.train.step.TrainState`: each save is one
  ``step_<10 digits>.npz``, written to ``.tmp-step_…-<pid>.npz``,
  flushed, ``fsync``-ed and published with ``os.replace``, so a process
  killed at any byte of a write leaves no torn checkpoint where a
  restore would find it. Temp files are never scanned. ``max_to_keep``
  prunes the oldest.
- :class:`CheckpointManager` — the same files behind JAX's manager
  surface (``save``, ``restore(state, step=)``, ``latest_step``,
  ``all_steps``, ``wait``, ``close``, the context manager), with
  asynchronous saves (``async_save``, the default) and the run geometry
  pinned to the directory (:meth:`CheckpointManager.ensure_meta`).

**The format is the port's own.** It does not read the JAX package's
orbax directories, nor they its files. The artifact the two packages
share is the dense ``.npz`` of :mod:`mpit_tpu_torch.train.convert`
(``--save-dense`` / ``--resume-dense``).

**Leaves.** A state is written as its leaves ``leaf_0000``, ``leaf_0001``,
… in this fixed order (:func:`state_leaves`):

1. ``step`` (int64);
2. the parameters: one rank's name → tensor mapping in the flat
   layout's order (the JAX tree's leaf order,
   :class:`~mpit_tpu_torch.opt.sharded.FlatLayout`); a p-rank state's
   flat buffer (:class:`~mpit_tpu_torch.train.step.FlatReplicas`) as
   one ``[N]`` leaf, rank 0's row (the replicas are bit-identical; a
   restore writes it into every rank's row), as JAX keeps replicated
   parameters once; or a flat tensor as it is (the elastic tier's
   replicas);
3. the optimizer state: the goo state's fields in declaration order, an
   int count as one int64 leaf (a ``None`` field has none), a buffer
   list tensor by tensor, a name → tensor mapping in the flat layout's
   order;
4. ``extra``: a mapping in the same order, or with p ranks each rank's
   mapping in rank order.

A restore reads the leaves in that order and writes them INTO the
state's own tensors with ``copy_`` (the ints into its fields): the
models' parameters, the flat buffer the ranks' parameters are views of,
the optimizer buffers and ``extra`` stay the tensors they were, and the
replicas stay equal. A file with another number of leaves, or a leaf of
another shape, raises ("structure drift").

**Saving a state the step updates in place.** A save takes its snapshot
before it returns, before the next step is enqueued: on the card the
device-to-host copies go into pinned memory on the current stream and a
CUDA event marks their end; the writer thread waits on that event
before it reads them. A synchronous save copies and writes before it
returns.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import warnings
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from mpit_tpu_torch.opt.sharded import _jax_key

__all__ = ["AtomicCheckpoint", "CheckpointManager", "state_leaves"]


class _Rows:
    """A p-rank ``[p, N]`` buffer of identical rows as one ``[N]`` leaf."""

    __slots__ = ("t",)

    def __init__(self, t: torch.Tensor):
        self.t = t

    @property
    def shape(self):
        return self.t.shape[1:]


class _IntField:
    """An int field of a dataclass (``step``, a goo count) as a leaf."""

    __slots__ = ("obj", "name")

    def __init__(self, obj, name: str):
        self.obj, self.name = obj, name

    def get(self) -> np.ndarray:
        return np.asarray(getattr(self.obj, self.name), np.int64)

    def put(self, arr: np.ndarray) -> None:
        if np.shape(arr) != ():
            raise ValueError(f"{self.name}: a leaf of shape {np.shape(arr)}, not a scalar")
        setattr(self.obj, self.name, int(arr))


def _walk(node, out: list, owner=None, name: str = "") -> None:
    if node is None or (isinstance(node, tuple) and not node):
        return
    if isinstance(node, torch.Tensor):
        out.append(node)
    elif isinstance(node, (bool, np.bool_)):
        raise TypeError(f"{name}: a bool is no checkpoint leaf")
    elif isinstance(node, (int, np.integer)):
        if owner is None:
            raise TypeError(f"{name}: an int outside a dataclass field")
        out.append(_IntField(owner, name))
    elif isinstance(node, Mapping):
        for key in sorted(node, key=_jax_key):
            _walk(node[key], out, name=f"{name}.{key}")
    elif isinstance(node, (list, tuple)):
        for i, item in enumerate(node):
            _walk(item, out, name=f"{name}[{i}]")
    elif dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            _walk(getattr(node, f.name), out, owner=node, name=f.name)
    else:
        raise TypeError(f"{name}: {type(node).__name__} is no checkpoint leaf")


def state_leaves(state) -> list:
    """The state's leaves in the documented order: tensors, and the int
    fields as ``_IntField`` handles."""
    out: list = [_IntField(state, "step")]
    flat = getattr(state, "flat", None)
    if flat is None:
        _walk(state.params, out, name="params")
    else:
        out.append(_Rows(flat.params))
    _walk(state.opt_state, out, name="opt_state")
    _walk(state.extra, out, name="extra")
    return out


def _snapshot(state, *, pinned: bool) -> tuple[list[np.ndarray], Any]:
    """Host copies of the state's leaves, taken now: ``(arrays, event)``.
    With ``pinned`` (an asynchronous save on the card) the copies of the
    CUDA tensors are enqueued into pinned memory and ``event`` marks
    their end (None when nothing was enqueued); the arrays must not be
    read before it has completed."""
    arrays, event = [], None
    for leaf in state_leaves(state):
        if isinstance(leaf, _IntField):
            arrays.append(leaf.get())
            continue
        t = (leaf.t[0] if isinstance(leaf, _Rows) else leaf).detach()
        if t.device.type == "cuda" and pinned:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            if event is None:
                event = torch.cuda.Event()
            arrays.append(host.numpy())
        else:
            arrays.append(t.to("cpu", copy=True).numpy())
    if event is not None:
        event.record()
    return arrays, event


def _restore_into(state, arrays: list[np.ndarray], step: int) -> None:
    leaves = state_leaves(state)
    if len(arrays) != len(leaves):
        raise ValueError(
            f"checkpoint at step {step} has {len(arrays)} leaves, "
            f"state_like has {len(leaves)} — structure drift"
        )
    with torch.no_grad():
        for i, (leaf, arr) in enumerate(zip(leaves, arrays)):
            if isinstance(leaf, _IntField):
                leaf.put(arr)
                continue
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"checkpoint at step {step}: leaf {i} has shape {tuple(arr.shape)}, "
                    f"the state's {tuple(leaf.shape)} — structure drift"
                )
            if isinstance(leaf, _Rows):
                leaf.t.copy_(torch.from_numpy(arr).expand_as(leaf.t))
            else:
                leaf.copy_(torch.from_numpy(arr))


class AtomicCheckpoint:
    """Crash-consistent ``step_<10 digits>.npz`` checkpoints of a
    :class:`~mpit_tpu_torch.train.step.TrainState` (module docstring).

    The surface ``hardened_loop`` needs (``save``/``restore``/
    ``latest_step``/``all_steps``/``wait``/``close``), so the loop's
    divergence restore drives it unchanged. Saves are synchronous
    (``wait`` is a no-op). ``restore`` writes into ``state_like`` and
    returns it."""

    def __init__(self, directory: str | Path, *, max_to_keep: int = 3):
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self._max_to_keep = max_to_keep

    @property
    def directory(self) -> Path:
        return self._dir

    def _path(self, step: int) -> Path:
        return self._dir / f"step_{step:010d}.npz"

    def _write(self, step: int, arrays: list[np.ndarray]) -> None:
        """Publish ``arrays`` as the checkpoint at ``step``: temp file,
        flush, fsync, ``os.replace``, then prune."""
        named = {f"leaf_{i:04d}": a for i, a in enumerate(arrays)}
        tmp = self._dir / f".tmp-step_{step:010d}-{os.getpid()}.npz"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **named)
                f.flush()
                os.fsync(f.fileno())
        except BaseException:
            # A failed write leaves no debris a later save at this step
            # would trip on; the published files are untouched.
            tmp.unlink(missing_ok=True)
            raise
        os.replace(tmp, self._path(step))
        self._prune()

    def save(self, step: int, state) -> None:
        self._write(step, _snapshot(state, pinned=False)[0])

    def _prune(self) -> None:
        steps = self._disk_steps()
        for s in steps[: max(0, len(steps) - self._max_to_keep)]:
            self._path(s).unlink(missing_ok=True)

    def _read(self, step: int) -> list[np.ndarray]:
        with np.load(self._path(step)) as z:
            # Numeric sort: a lexicographic one would misorder names past
            # the zero-pad width (leaf_10000 < leaf_2000).
            names = sorted(z.files, key=lambda n: int(n.rsplit("_", 1)[1]))
            return [z[n] for n in names]

    def restore(self, state_like, *, step: int | None = None):
        """Write the checkpoint at ``step`` (default: the latest) into
        ``state_like``'s tensors and fields; returns ``state_like``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self._dir}")
        _restore_into(state_like, self._read(step), step)
        return state_like

    def _disk_steps(self) -> list[int]:
        out = []
        for p in self._dir.glob("step_*.npz"):
            try:
                out.append(int(p.stem.split("_", 1)[1]))
            except ValueError:
                continue  # a foreign file; not ours to interpret
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return self._disk_steps()

    def wait(self) -> None:
        pass  # synchronous saves: already durable

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


class CheckpointManager:
    """Checkpoints of a training run: :class:`AtomicCheckpoint`'s files
    with JAX's ``CheckpointManager`` surface.

    ``world`` is taken for JAX's signature; the port's restore writes
    into the state's own tensors, so no layout is needed. ``async_save``
    (default True, as JAX's ``run_spmd`` has it): :meth:`save` snapshots
    the state and returns, a writer thread publishes the file;
    :meth:`wait` blocks until every pending save is durable and raises
    the first error of one. Steps being written count in
    :meth:`all_steps` and :meth:`latest_step`; :meth:`restore` waits for
    them first."""

    def __init__(
        self,
        directory: str | Path,
        world=None,
        *,
        max_to_keep: int = 3,
        async_save: bool = True,
    ):
        del world
        self._ck = AtomicCheckpoint(directory, max_to_keep=max_to_keep)
        self._dir = self._ck.directory
        self._pending_meta: dict | None = None
        self._async_save = async_save
        self._meta_flush_on_wait = False
        self._pool = (
            concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="ckpt-write")
            if async_save else None
        )
        self._inflight: list[tuple[int, concurrent.futures.Future]] = []

    @property
    def directory(self) -> Path:
        return self._dir

    def ensure_meta(self, meta: dict, *, defaults: dict | None = None) -> None:
        """Pin the run's geometry to the checkpoint directory (JAX's
        rules, :meth:`mpit_tpu.train.CheckpointManager.ensure_meta`).

        While the directory holds a checkpoint, every run against it
        must present the same ``meta`` values: a drift raises. Fields
        the recorded meta lacks are merged, but only after the first
        successful :meth:`restore` or the first durable :meth:`save` (a
        failed resume must not pin geometry it only attempted); one of
        them at a value other than its ``defaults`` value warns, since
        drift against the run that wrote the checkpoint cannot be
        validated. A checkpoint without ``run_meta.json`` warns and pins
        this run's meta. With nothing to resume the meta is (re)written."""
        path = self._dir / "run_meta.json"
        if path.exists() and self.latest_step() is not None:
            try:
                with open(path) as f:
                    recorded = json.load(f)
            except (json.JSONDecodeError, OSError) as e:
                raise ValueError(
                    f"{path} is unreadable ({e}); the checkpoint directory "
                    "has a checkpoint but corrupt run metadata — delete "
                    "run_meta.json to re-pin it from this run's flags"
                ) from None
            drift = {
                k: (recorded.get(k), v)
                for k, v in meta.items()
                if k in recorded and recorded[k] != v
            }
            if drift:
                lines = ", ".join(
                    f"{k}: checkpoint has {a!r}, this run has {b!r}"
                    for k, (a, b) in drift.items()
                )
                raise ValueError(
                    f"checkpoint directory {self._dir} was written by a run "
                    f"with different geometry ({lines}); pass matching flags "
                    "(e.g. --schedule-horizon pins the decay length across "
                    "runs with different --steps) or use a fresh --ckpt-dir"
                )
            unrecorded = {k: v for k, v in meta.items() if k not in recorded}
            nondefault = {
                k: v
                for k, v in unrecorded.items()
                if defaults is not None and v != defaults.get(k)
            }
            if nondefault:
                fields = ", ".join(f"{k}={v!r}" for k, v in sorted(nondefault.items()))
                warnings.warn(
                    f"{self._dir} predates geometry field(s) {fields}; "
                    "pinning this run's non-default value(s) — drift "
                    "against the run that wrote the checkpoint (which "
                    "implicitly ran the old default) cannot be validated",
                    stacklevel=2,
                )
            if unrecorded:
                self._pending_meta = {**recorded, **unrecorded}
            return
        if not path.exists() and self.latest_step() is not None:
            warnings.warn(
                f"{self._dir} holds a checkpoint but no run_meta.json; "
                "pinning this run's flags as the geometry — drift against "
                "the run that wrote the checkpoint cannot be validated",
                stacklevel=2,
            )
        self._write_meta(meta)

    def _write_meta(self, meta: dict) -> None:
        path = self._dir / "run_meta.json"
        tmp = path.with_suffix(".json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmp, path)  # atomic: no partial file is ever visible

    def _flush_pending_meta(self) -> None:
        merged, self._pending_meta = self._pending_meta, None
        if merged is not None:
            self._write_meta(merged)

    def save(self, step: int, state) -> None:
        """Checkpoint ``state`` at ``step``. The snapshot is taken before
        this returns; an asynchronous save is durable at :meth:`wait`."""
        if not self._async_save:
            self._ck.save(step, state)
            self._flush_pending_meta()
            return
        arrays, event = _snapshot(state, pinned=True)

        def write():
            if event is not None:
                event.synchronize()
            self._ck._write(step, arrays)

        self._inflight.append((step, self._pool.submit(write)))
        # The merge waits for the write to be durable (wait()).
        self._meta_flush_on_wait = True

    def restore(self, state_like, *, step: int | None = None):
        """Write the checkpoint at ``step`` (default: the latest) into
        ``state_like``'s tensors and fields (module docstring); returns
        ``state_like``. Pending saves are waited for first."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        self._ck.restore(state_like, step=step)
        # Restore succeeded: the deferred ensure_meta merge may pin.
        self._flush_pending_meta()
        return state_like

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return sorted(set(self._ck.all_steps()) | {s for s, _ in self._inflight})

    def wait(self) -> None:
        """Block until every pending save is durable; raise the first
        failed one's error."""
        inflight, self._inflight = self._inflight, []
        errors = []
        for _, fut in inflight:
            try:
                fut.result()
            except BaseException as e:  # noqa: BLE001 -- re-raised below
                errors.append(e)
        if errors:
            raise errors[0]
        if self._meta_flush_on_wait:
            self._meta_flush_on_wait = False
            self._flush_pending_meta()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.wait()
        self.close()
