"""A JAX training state carried into the port.

The training part of :mod:`mpit_tpu.train.convert`:
:func:`train_state_from_jax` takes the JAX package's params, optax
optimizer state and step (numpy trees: ``jax.tree.map(np.asarray,
...)``) and builds the port's :class:`~mpit_tpu_torch.train.step.TrainState`.
Params map through :func:`mpit_tpu_torch.serve.weights.params_from_jax`
(the same names and layouts); optax's Adam ``ScaleByAdamState(count,
mu, nu)`` becomes :class:`~mpit_tpu_torch.opt.goo.AdamState` and goo's
``GooState(momentum, count)`` :class:`~mpit_tpu_torch.opt.goo.GooState`,
moment for moment under the parameters' names. A moment may be a tree
like the params (replicated state) or the flat vector of the JAX
package's ZeRO-1 layout (each leaf raveled in the tree's sorted-key
order and zero-padded to a multiple of 128).

With a ``world`` of ``p`` ranks the state is the data-parallel step's:
the params once per rank, and every moment rank-stacked in the flat
layout. A ZeRO-1 moment, JAX's global ``[p·S]`` vector, is cut into its
``p`` contiguous shards (``[p, S]``, rank ``r`` holding ``[r·S,
(r+1)·S)``, :func:`mpit_tpu_torch.opt.sharded.shard_of`'s layout); a
replicated moment tree becomes ``[p, N]``, its flat vector on every
rank.

**The dense state** (the DP half of JAX's cross-geometry format):
:class:`DenseState` is the JAX package's, field for field — the dense
param tree under JAX's names and layouts, one dense tree per vector leaf
of the goo state in JAX's order (goo: the momentum trace; Adam: μ, ν;
EASGD's chain: then the elastic centre), the scalar leaves (the counts, int32) and the step.
:func:`dense_from_dp` gathers it from the port's state (one rank, or the
``[p, S]`` ZeRO-1 shards of p ranks); :func:`dp_from_dense` writes one
into a state ``init_fn`` built, for any p, the shards re-cut.
:func:`save_dense` / :func:`load_dense` are the ``.npz``, JAX's byte for
byte in its keys and layouts (``__step__``, ``p/`` + the ``keystr`` of
the JAX tree path, ``m<i>/``, ``s/<i>``, ``meta/<key>``): the artifact
the two packages share (the port's ``--ckpt-dir`` format is its own).
On the way out the port's names follow
:func:`~mpit_tpu_torch.models.layers.params_from_jax`'s map in reverse
(``blocks.<i>`` → ``block_<i>``, ``.`` → ``/``), convolution kernels go
OIHW → HWIO and dense kernels stay ``[in, out]``; the flat layout's pads
(each leaf zero-padded to a multiple of 128) are stripped, and put back
as zeros on the way in.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping

import numpy as np
import torch

from mpit_tpu_torch.opt.goo import AdamState, ElasticState, GooState
from mpit_tpu_torch.opt.sharded import FlatLayout, _jax_key, padded_len
from mpit_tpu_torch.serve.weights import params_from_jax
from mpit_tpu_torch.train.step import TrainState

__all__ = [
    "DenseState", "dense_from_dp", "dp_from_dense", "flat_unravel", "load_dense",
    "save_dense", "train_state_from_jax",
]

_LANE = 128  # the ZeRO-1 layout's per-leaf alignment


def _leaves(tree: Mapping, prefix: str = ""):
    """``(path, leaf)`` in JAX's leaf order: dict keys sorted."""
    for key in sorted(tree):
        val = tree[key]
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _leaves(val, path + "/")
        else:
            yield path, val


def flat_unravel(flat, like: Mapping) -> dict:
    """The inverse of the JAX package's lane-aligned ``flat_ravel``: the
    flat vector (possibly longer: the shard padding) as a nested tree
    shaped like ``like``."""
    flat = np.asarray(flat).reshape(-1)
    out: dict = {}
    off = 0
    for path, leaf in _leaves(like):
        shape = np.shape(leaf)
        size = int(np.prod(shape)) if shape else 1
        node = out
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        if off + size > flat.shape[0]:
            raise ValueError(f"flat vector of {flat.shape[0]} ends inside leaf {path!r}")
        node[parts[-1]] = flat[off : off + size].reshape(shape)
        off += size + (-size) % _LANE
    return out


def _moment(tree, params: Mapping) -> dict:
    """A moment tree or flat ZeRO-1 vector as a name → tensor mapping."""
    if not isinstance(tree, Mapping):
        tree = flat_unravel(tree, params)
    return params_from_jax(tree)


def _stacked_moment(tree, state: Mapping, p: int):
    """A moment as the p-rank step's rank-stacked buffer: a flat ZeRO-1
    vector → its ``[p, S]`` shards, a replicated tree → ``[p, N]``."""
    layout = FlatLayout(state)
    n = padded_len(layout.total, p)
    if isinstance(tree, Mapping):
        flat = torch.zeros(n)
        layout.ravel(params_from_jax(tree), out=flat)
        return flat.expand(p, n).clone()
    flat = torch.from_numpy(np.array(np.asarray(tree).reshape(-1), dtype=np.float32))
    if flat.shape[0] != n:
        raise ValueError(
            f"a ZeRO-1 moment of {flat.shape[0]} elements; {p} ranks of this "
            f"model hold {n} (flat length {layout.total} padded to {p}·128)"
        )
    return flat.view(p, n // p)


def _find(state, fields: tuple[str, ...]):
    """The first node of an optax state (nested tuples / named tuples)
    that has all of ``fields``."""
    if all(hasattr(state, f) for f in fields):
        return state
    if isinstance(state, (tuple, list)):
        for sub in state:
            found = _find(sub, fields)
            if found is not None:
                return found
    return None


def train_state_from_jax(params: Mapping, opt_state: Any, step, *, world=None) -> TrainState:
    """The port's :class:`TrainState` from JAX's params, optax state and
    step. ``opt_state`` holds an Adam state (``count``, ``mu``, ``nu``:
    ``goo_adam``) or a goo SGD state (``momentum``, ``count``); an SGD
    state without momentum (``()``) or without a schedule count maps to
    ``None`` there. The returned params are CPU tensors:
    :meth:`TrainState.bind` loads them into a model (a list of models,
    one per rank, with a ``world``)."""
    state = params_from_jax(params)
    p = None if world is None else world.num_devices

    def moment(tree):
        if p is not None:
            return [_stacked_moment(tree, state, p)]
        buf = _moment(tree, params)
        return {n: buf[n] for n in state}

    adam = _find(opt_state, ("count", "mu", "nu"))
    if adam is not None:
        opt = AdamState(count=int(np.asarray(adam.count)), mu=moment(adam.mu),
                        nu=moment(adam.nu))
    else:
        sgd = _find(opt_state, ("momentum", "count"))
        if sgd is None:
            raise ValueError(
                "opt_state holds neither an optax Adam state (count, mu, nu) "
                "nor a goo SGD state (momentum, count)"
            )
        momentum = None
        if not (isinstance(sgd.momentum, tuple) and not sgd.momentum):
            momentum = moment(sgd.momentum)
        count = sgd.count
        opt = GooState(
            momentum=momentum,
            count=None if isinstance(count, tuple) else int(np.asarray(count)),
        )
    ranks_params = state if p is None else [dict(state) for _ in range(p)]
    return TrainState(step=int(np.asarray(step)), params=ranks_params, opt_state=opt)


# ---- the dense state (JAX's cross-geometry format, its DP half) -------------


@dataclasses.dataclass
class DenseState:
    """The cross-geometry checkpoint payload (host numpy), JAX's
    ``DenseState``: ``params`` the dense param tree under JAX's names
    and layouts; ``moments`` one such tree per vector leaf of the goo
    state, in JAX's order; ``scalars`` the state's scalar leaves (the
    counts), in order; ``meta`` the geometry that shapes cannot tell
    (``num_heads``, ``tie_head``)."""

    step: int
    params: Any
    moments: list
    scalars: list
    meta: dict = dataclasses.field(default_factory=dict)


def _to_jax_layout(arr: np.ndarray) -> np.ndarray:
    """A port leaf as JAX lays it out: conv kernels OIHW → HWIO."""
    return np.ascontiguousarray(arr.transpose(2, 3, 1, 0)) if arr.ndim == 4 else arr


def _from_jax_layout(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(arr.transpose(3, 2, 0, 1)) if arr.ndim == 4 else arr


def _nest(flat: Mapping[str, np.ndarray]) -> dict:
    """Port names → the nested JAX tree (``blocks.<i>.x`` → ``block_<i>/x``)."""
    out: dict = {}
    for name, arr in flat.items():
        *parents, leaf = _jax_key(name)
        node = out
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = _to_jax_layout(arr)
    return out


def _unnest(tree: Mapping, layout: FlatLayout) -> dict:
    """The nested JAX tree → port names in ``layout``'s order (port
    layouts); raises naming a leaf that is missing or of another shape."""
    out = {}
    for name in layout.names:
        node = tree
        for part in _jax_key(name):
            if not isinstance(node, Mapping) or part not in node:
                raise ValueError(f"the dense tree lacks {'/'.join(_jax_key(name))}")
            node = node[part]
        arr = _from_jax_layout(np.asarray(node, np.float32))
        if tuple(arr.shape) != layout.shapes[name]:
            raise ValueError(
                f"{'/'.join(_jax_key(name))}: shape {arr.shape} (port layout), "
                f"the model's {layout.shapes[name]}"
            )
        out[name] = arr
    return out


def _state_layout(state: TrainState) -> FlatLayout:
    return state.flat.layout if state.flat is not None else FlatLayout(state.params)


def _moment_buffers(opt) -> list:
    """The goo state's vector leaves in JAX's order: goo's momentum
    trace; Adam's μ then ν (optax's ``ScaleByAdamState(count, mu, nu)``);
    a chain's (``chain(goo, elastic_average)``, EASGD) its rules' in
    turn, the elastic centre as one more moment, as JAX's
    ``dense_from_dp`` takes every vector leaf of the chained state."""
    if isinstance(opt, tuple):
        return [b for sub in opt for b in _moment_buffers(sub)]
    if isinstance(opt, AdamState):
        return [opt.mu, opt.nu]
    if isinstance(opt, GooState):
        return [] if opt.momentum is None else [opt.momentum]
    if isinstance(opt, ElasticState):
        return [opt.center]
    raise TypeError(f"{type(opt).__name__} is not a goo state")


def _counted(opt):
    """The state that holds the counts: a chain's base rule's."""
    return opt[0] if isinstance(opt, tuple) else opt


def _scalar_count(opt, tx) -> int:
    """How many scalar leaves JAX's state holds: goo's schedule count
    (none for a constant lr); Adam's count, and optax's schedule count
    beside it when the lr is a schedule. The elastic term holds none."""
    opt = _counted(opt)
    if isinstance(opt, AdamState):
        return 2 if callable(getattr(tx, "lr", None)) else 1
    return 0 if opt.count is None else 1


def _replicated(t: torch.Tensor, state: TrainState) -> bool:
    """Whether a p-rank moment buffer is the replicated ``[p, N]`` one
    (plain DP), not the ``[p, S]`` ZeRO-1 shards."""
    return t.shape == state.flat.params.shape


def _moment_flat(buf, layout: FlatLayout, state: TrainState) -> dict:
    """One moment buffer as name → numpy (pads stripped): a name →
    tensor mapping (one rank), a ``[p, S]`` ZeRO-1 shard stack, or a
    ``[p, N]`` replicated stack (its rank 0 row)."""
    if isinstance(buf, Mapping):
        return {n: buf[n].detach().cpu().numpy() for n in layout.names}
    (t,) = buf
    t = t.detach()
    flat = (t[0] if _replicated(t, state) else t.reshape(-1)).cpu()
    return {n: v.numpy() for n, v in layout.views(flat).items()}


def dense_from_dp(state: TrainState, tx) -> DenseState:
    """The port's state (one rank, or p ranks' ZeRO-1 ``[p, S]`` shards
    or replicated ``[p, N]`` buffers) as JAX's :class:`DenseState`.
    ``tx`` is the goo rule the state belongs to (it says whether optax
    keeps a schedule count beside Adam's)."""
    layout = _state_layout(state)
    if state.flat is None:
        params = {n: state.params[n].detach().cpu().numpy() for n in layout.names}
    else:
        row = state.flat.params[0].detach().cpu()
        params = {n: v.numpy() for n, v in layout.views(row).items()}
    opt = state.opt_state
    moments = [_nest(_moment_flat(b, layout, state)) for b in _moment_buffers(opt)]
    count = _counted(opt).count
    count = np.asarray(count if count is not None else 0, np.int32)
    scalars = [count.copy() for _ in range(_scalar_count(opt, tx))]
    return DenseState(step=int(state.step), params=_nest(params), moments=moments,
                      scalars=scalars)


@torch.no_grad()
def dp_from_dense(dense: DenseState, state: TrainState, tx) -> TrainState:
    """Write a :class:`DenseState` into ``state``, a state ``init_fn``
    built (bound to its models) for one rank or any p: the params into
    the models' tensors (with p ranks the ``[p, N]`` buffer, pads zero),
    each moment into its buffer, the ZeRO-1 shards cut for this p, the
    counts and the step. Returns ``state``."""
    layout = _state_layout(state)
    params = _unnest(dense.params, layout)
    opt = state.opt_state
    bufs = _moment_buffers(opt)
    if len(dense.moments) != len(bufs):
        raise ValueError(
            f"the dense state has {len(dense.moments)} moment trees, "
            f"{type(opt).__name__} holds {len(bufs)}"
        )
    want = _scalar_count(opt, tx)
    if len(dense.scalars) != want:
        raise ValueError(
            f"the dense state has {len(dense.scalars)} scalar leaves, "
            f"{type(opt).__name__} with this lr holds {want}"
        )

    def fill_flat(dst: torch.Tensor, leaves: Mapping[str, np.ndarray]) -> None:
        """``dst`` (a flat vector of at least ``layout.total``) ← the
        leaves, pads zero."""
        dst.zero_()
        views = layout.views(dst)
        for n in layout.names:
            views[n].copy_(torch.from_numpy(leaves[n]))

    if state.flat is None:
        for n in layout.names:
            state.params[n].copy_(torch.from_numpy(params[n]))
    else:
        fp = state.flat.params
        for r in range(fp.shape[0]):
            fill_flat(fp[r], params)
    for buf, tree in zip(bufs, dense.moments):
        leaves = _unnest(tree, layout)
        if isinstance(buf, Mapping):
            for n in layout.names:
                buf[n].copy_(torch.from_numpy(leaves[n]))
            continue
        (t,) = buf
        p = t.shape[0]
        if _replicated(t, state):  # plain DP: [p, N]
            for r in range(p):
                fill_flat(t[r], leaves)
        else:  # ZeRO-1 [p, S]: the flat vector cut into p shards
            full = torch.zeros(padded_len(layout.total, p), dtype=t.dtype)
            fill_flat(full, leaves)
            t.copy_(full.view(p, -1))
    if dense.scalars:
        _counted(opt).count = int(np.asarray(dense.scalars[0]))
    state.step = int(dense.step)
    return state


def _keystr(path: str) -> str:
    """``jax.tree_util.keystr`` of a ``/``-joined dict path: ``['a']['b']``."""
    return "".join(f"[{k!r}]" for k in path.split("/"))


def save_dense(path: str, dense: DenseState, **meta) -> str:
    """Write a :class:`DenseState` as one ``.npz``, JAX's keys, order and
    dtypes (``__step__`` int64, the counts int32); ``meta`` merges over
    ``dense.meta`` as ``meta/<key>``. Written to ``path + ".tmp.npz"``
    and published with ``os.replace``."""
    arrays: dict[str, np.ndarray] = {"__step__": np.asarray(dense.step)}
    for name, leaf in _leaves(dense.params):
        arrays["p/" + _keystr(name)] = np.asarray(leaf)
    for m, tree in enumerate(dense.moments):
        for name, leaf in _leaves(tree):
            arrays[f"m{m}/" + _keystr(name)] = np.asarray(leaf)
    for i, s in enumerate(dense.scalars):
        arrays[f"s/{i}"] = np.asarray(s)
    for key, val in {**dense.meta, **meta}.items():
        arrays[f"meta/{key}"] = np.asarray(val)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)  # atomic: no torn file on preemption
    return path


def load_dense(path: str) -> DenseState:
    """Read a :func:`save_dense` file (either package's) back into a
    :class:`DenseState`."""

    def nest(flat: dict) -> dict:
        out: dict = {}
        for key, leaf in flat.items():
            parts = [p for p in key.split("/") if p]
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = leaf
        return out

    with np.load(path) as z:
        step = int(z["__step__"])
        params_flat, moments_flat, scalars, meta = {}, {}, {}, {}
        for key in z.files:
            if key == "__step__":
                continue
            head, _, rest = key.partition("/")
            # keystr paths look like ['a']['b']; normalize to a/b.
            clean = rest.replace("']['", "/").strip("[']")
            if head == "p":
                params_flat[clean] = z[key]
            elif head == "s":
                scalars[int(rest)] = z[key]
            elif head == "meta":
                meta[rest] = z[key].item()
            else:
                moments_flat.setdefault(int(head[1:]), {})[clean] = z[key]
    return DenseState(
        step=step,
        params=nest(params_flat),
        moments=[nest(moments_flat[m]) for m in sorted(moments_flat)],
        scalars=[scalars[i] for i in sorted(scalars)],
        meta=meta,
    )
