"""stcd_tpu_torch imports torch and never JAX, flax, optax or stcd_tpu, and
PIL only where an image file is read or written: importing
the package and every one of its submodules, in a fresh interpreter, leaves
none of them in sys.modules, and builds no kernel."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import stcd_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(stcd_tpu_torch.__path__,
                                                      "stcd_tpu_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "PIL", "stcd_tpu"))
from stcd_tpu_torch.ops import _build
print(json.dumps({"modules": names, "bad": bad,
                  "built": _build.load_library.cache_info().currsize}))
"""


def test_port_never_imports_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "stcd_tpu_torch.models.changeformer" in res["modules"]
    assert "stcd_tpu_torch.cli.serve" in res["modules"]
    for name in ("encoders.resnet", "decoders.unet", "models.segcd", "losses.functional",
                 "metrics.confusion", "train.schedules", "train.state", "train.steps",
                 "data.augment", "ops.augment", "tools.profile_step"):
        assert f"stcd_tpu_torch.{name}" in res["modules"], name
    assert len(res["modules"]) >= 30
    assert res["bad"] == []
    assert res["built"] == 0
