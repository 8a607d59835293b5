"""mpit_tpu_torch stands alone: importing every module of the port pulls
in neither ``jax`` (nor ``jaxlib``) nor the JAX package ``mpit_tpu``.

The import runs in a fresh interpreter, since this test process has
both packages loaded already.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, json, pkgutil, sys
import mpit_tpu_torch
names = sorted(
    m.name for m in pkgutil.walk_packages(mpit_tpu_torch.__path__, "mpit_tpu_torch.")
)
for name in names:
    importlib.import_module(name)
banned = sorted(
    k for k in sys.modules
    if k.split(".")[0] in ("jax", "jaxlib", "mpit_tpu")
)
print(json.dumps({"modules": names, "banned": banned}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["banned"] == []
    for name in ("mpit_tpu_torch.compat.simulator", "mpit_tpu_torch.ops.kv_ship",
                 "mpit_tpu_torch.serve.fleet", "mpit_tpu_torch.obs.aggregate",
                 "mpit_tpu_torch.serve.__main__", "mpit_tpu_torch.asyncsgd.actors",
                 "mpit_tpu_torch.asyncsgd.mnist", "mpit_tpu_torch.asyncsgd.imagenet",
                 "mpit_tpu_torch.models.lenet", "mpit_tpu_torch.models.alexnet",
                 "mpit_tpu_torch.models.layers", "mpit_tpu_torch.models.norm",
                 "mpit_tpu_torch.models.resnet", "mpit_tpu_torch.asyncsgd.resnet",
                 "mpit_tpu_torch.data.augment", "mpit_tpu_torch.data.filedata",
                 "mpit_tpu_torch.data.images", "mpit_tpu_torch.obs.sentinel",
                 "mpit_tpu_torch.obs.slo", "mpit_tpu_torch.obs.roofline",
                 "mpit_tpu_torch.obs.memledger", "mpit_tpu_torch.obs.baseline",
                 "mpit_tpu_torch.obs.__main__", "mpit_tpu_torch.utils.profiling"):
        assert name in out["modules"], name
