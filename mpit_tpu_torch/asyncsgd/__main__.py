"""Workload launcher: ``python -m mpit_tpu_torch.asyncsgd <workload> [options]``.

The port of :mod:`mpit_tpu.asyncsgd.__main__`. ``mnist``, ``imagenet``,
``resnet`` and ``gpt2`` train on the GPU, on one rank or over ``--mesh
data=N`` ranks, and LeNet and AlexNet also under ``--mode parity
--nranks N`` (1 pserver + N - 1 pclients); ``--device cpu`` runs on the
CPU. Prints the workload's result as one JSON line.

    python -m mpit_tpu_torch.asyncsgd mnist --steps 30 --batch-size 32
    python -m mpit_tpu_torch.asyncsgd imagenet --mesh data=4 --grad-sync ring
    python -m mpit_tpu_torch.asyncsgd resnet --mesh data=4 --zero1 true --grad-sync ring
    python -m mpit_tpu_torch.asyncsgd mnist --mode parity --nranks 2 --device cpu
"""

from __future__ import annotations

import importlib
import json
import sys

from mpit_tpu_torch.asyncsgd import WORKLOADS


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print(f"workloads: {', '.join(WORKLOADS)}")
        return 0
    name, rest = argv[0], argv[1:]
    if name not in WORKLOADS:
        print(f"unknown workload {name!r}; choose from {WORKLOADS}", file=sys.stderr)
        return 2
    mod = importlib.import_module(f"mpit_tpu_torch.asyncsgd.{name}")
    print(json.dumps(mod.main(rest)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
