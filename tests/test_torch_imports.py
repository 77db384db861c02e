"""stcd_tpu_torch imports torch and never JAX, flax, optax or stcd_tpu, and
PIL only where an image file is read or written: importing
the package and every one of its submodules, in a fresh interpreter, leaves
none of them in sys.modules, and builds no kernel and no native decoder."""

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
from stcd_tpu_torch import native
from stcd_tpu_torch.ops import _build
print(json.dumps({"modules": names, "bad": bad,
                  "built": _build.load_library.cache_info().currsize,
                  "native_loaded": native._lib is not None or native._load_failed}))
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
                 "data.augment", "ops.augment", "tools.profile_step", "ops.bn_stats",
                 "models.bit", "train.trainer", "layers.stochastic", "ops.matmul_stats",
                 "tools.bench_conv_bn_epilogue", "tools.bench_bnstats_diag", "train.loops",
                 "tools.bench_bnstats",
                 "train.checkpoint", "utils.logging", "data.io", "native", "data.datasets",
                 "data.loader", "data.tools", "train.preemption", "utils.profiling",
                 "utils.debug", "convert.pretrained", "cli.common", "cli.train_sup",
                 "cli.train_pse_cd", "cli.train_stcd", "cli.train_ffctl", "cli.evaluate",
                 "cli.make_demo_data", "cli.pipeline_demo", "cli.train_cd",
                 "cli.export_model", "serving.quant", "layers.pixel_shuffle",
                 "encoders.mix_transformer", "layers.se", "models.siam_unet",
                 "models.snunet", "models.dtcdscn", "encoders.vgg", "models.dsifn",
                 "models.gcn_lib", "models.changevig", "models.init"):
        assert f"stcd_tpu_torch.{name}" in res["modules"], name
    assert len(res["modules"]) >= 71
    assert res["bad"] == []
    assert res["built"] == 0 and not res["native_loaded"]


def _imported_roots(path):
    """Top-level names of every import statement in a source file, wherever
    it stands (module level or inside a function)."""
    import ast
    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_of_the_port_names_jax_or_the_jax_package_in_an_import():
    """The lazy imports too: chip_smoke.py and every module of the port,
    read as source, import nothing of JAX, of stcd_tpu or of benchmarks/."""
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "stcd_tpu_torch")):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(sources) >= 60
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "stcd_tpu", "benchmarks", "bench"}
    for path in sources:
        assert not _imported_roots(path) & banned, path


def test_chip_smoke_imports_without_jax_and_fails_without_a_card():
    """Importing chip_smoke.py pulls in neither JAX nor the JAX package, and
    without a CUDA card its main() returns non-zero and prints no result."""
    probe = ("import json, sys, torch, chip_smoke\n"
             "torch.cuda.is_available = lambda: False\n"
             "rc = chip_smoke.main()\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'flax', 'optax', 'stcd_tpu'))\n"
             "print(json.dumps({'rc': rc, 'bad': bad}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1  # nothing but the probe's own line: no result was printed
    res = json.loads(lines[0])
    assert res["rc"] != 0 and res["bad"] == []
    assert "needs a CUDA card" in out.stderr
