"""Config and flags for the port's training workloads.

The port of :mod:`mpit_tpu.asyncsgd.config`: each workload is a plain
dataclass and its command line is generated from the fields
(:func:`mpit_tpu_torch.config.from_argv`, with ``overrides``). The
fields are those of the JAX package that the port reads, with JAX's
defaults; every other flag of the JAX CLI still parses, and raises
``SystemExit`` naming the slice that brings it
(``asyncsgd.runner.LATER_FLAGS``). Two fields are
the port's own: ``device`` (``cuda``, the default, or ``cpu``) and
``ps_timeout`` (the parity mode's compat job limit).
"""

from __future__ import annotations

import dataclasses

from mpit_tpu_torch.config import add_dataclass_args, from_argv

__all__ = ["TrainConfig", "add_dataclass_args", "from_argv", "parse_mesh"]


@dataclasses.dataclass
class TrainConfig:
    """Options shared by every workload script (the Lua ``opt`` table
    analogue). ``mode``: ``spmd`` (one rank, or ``--mesh data=N`` ranks
    driven from this process), ``parity`` (1 parameter server +
    ``nranks - 1`` clients on the compat simulator) or ``elastic`` (1
    anchor server + ``nranks - 1`` replicas, each on the hardened loop,
    with heartbeats, leases, quarantine and crash/rejoin over per-replica
    checkpoints; ``mnist`` only)."""

    mode: str = "spmd"  # spmd | parity | elastic
    steps: int = 200
    batch_size: int = 64  # global (split over the ranks or the clients)
    lr: float = 0.05
    momentum: float = 0.9  # goo SGD (the convnets); gpt2 trains with goo_adam
    weight_decay: float = 0.0
    # lr schedule (opt/schedules.py): "" = constant, "warmup",
    # "warmup_cosine", "step".
    schedule: str = ""
    warmup_steps: int = 0
    lr_end_scale: float = 0.0  # warmup_cosine: final lr as a fraction of lr
    decay_every: int = 0  # step schedule: decay period
    decay_factor: float = 0.1  # step schedule: decay multiplier
    schedule_horizon: int = 0  # warmup_cosine horizon; 0 = --steps
    zero1: bool = True  # shard the goo state across the data ranks
    # Gradient-sync wire (train/grad_sync.py): "psum" = the plain
    # collectives; "ring" = the ring reduce-scatter/all-gather kernels,
    # per grad bucket; "ring_q8" = the ring with the int8 wire (lossy).
    grad_sync: str = "psum"  # psum | ring | ring_q8
    grad_bucket_mb: float = 4.0  # ring tiers: bucket size (MB of f32)
    easgd: bool = False  # parity: elastic averaging in place of Downpour
    easgd_alpha: float = 0.125
    # elastic: alpha = easgd_beta / N_active when > 0 (eviction reshapes
    # the denominator); 0 keeps the fixed easgd_alpha.
    easgd_beta: float = 0.0
    sync_every: int = 1  # parity/elastic: client steps between server exchanges
    nranks: int = 2  # parity/elastic: 1 server + (nranks - 1) clients/replicas
    # elastic liveness: a replica silent past lease_s is evicted; a pull
    # more than staleness_bound centre versions stale is noted, not fatal.
    lease_s: float = 1.0
    heartbeat_s: float = 0.1
    staleness_bound: int = 8
    # parity: the compat job's wall-clock limit (s); a longer run is
    # taken for a deadlock and aborted with every rank's mailbox state.
    ps_timeout: float = 600.0
    mesh: str = ""  # e.g. "data=4"; "" = one rank
    log_every: int = 50
    ckpt_dir: str = ""  # checkpoint directory ("" = no checkpoints)
    ckpt_every: int = 0
    # The cross-geometry dense .npz (train/convert.py): --save-dense writes
    # it at the run's end (a preemption included); --resume-dense restores
    # it onto this run's ranks, the ZeRO-1 shards re-cut.
    save_dense: str = ""
    resume_dense: str = ""
    eval_batch: int = 256
    # Every N steps (and at the last) the val split's sweep is logged as
    # eval_* rows; 0 = one held-out batch evaluated at the end.
    eval_every: int = 0
    eval_batches: int = 0  # cap the sweep (0 = the synthetic split's 8)
    max_restores: int = 1  # checkpoint restores after a diverged loss
    spike_factor: float = 0.0  # >0: treat loss > factor * EMA as divergence
    fetch_lag: int = 2  # losses read back this many log points late
    prefetch_depth: int = 2  # host batches staged ahead of the step
    # Observability (obs/sentinel.py, utils/profiling.py): the anomaly
    # sentinel over the steps' device times, and a torch.profiler trace
    # of steps 2..5 into profile_dir (SPMD mode).
    sentinel: bool = False
    profile_dir: str = ""
    seed: int = 0
    device: str = "cuda"  # cuda | cpu
    # The classification workloads' data (runner.classification_dataset).
    data_dir: str = ""  # an npy directory (data/filedata.py); "" = synthetic
    # Train-stream augmentation (data/augment.py): "shift" = random
    # shift-crop by crop_pad and hflip; "rrc" = random-resized-crop to
    # train_size (0 = the stored size) and hflip, --data-dir only.
    augment: bool = False
    augment_mode: str = "shift"  # shift | rrc
    crop_pad: int = 4
    train_size: int = 0
    rrc_min_scale: float = 0.08  # rrc: the least crop-area fraction

    def mesh_shape(self) -> dict[str, int] | None:
        return parse_mesh(self.mesh)


def parse_mesh(mesh: str) -> dict[str, int] | None:
    """``"data=4,model=2"`` → ``{"data": 4, "model": 2}``; ``""`` → None."""
    if not mesh:
        return None
    out: dict[str, int] = {}
    for part in mesh.split(","):
        k, _, v = part.partition("=")
        out[k.strip()] = int(v)
    return out
