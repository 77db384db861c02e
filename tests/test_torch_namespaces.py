"""The port's package namespaces export what the JAX package's export, and load
lazily: ``stcd_tpu_torch`` (smp's top level: losses, metrics, datasets,
encoders, decoders, create_model, define_G, the model classes, predict) and
its ``losses``, ``metrics``, ``data``, ``layers``, ``serving`` and ``models``.
Importing a namespace imports none of the model zoo; a fresh interpreter
checks that."""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _public(module):
    names = getattr(module, "__all__", None)
    if names is None:
        names = [n for n in vars(module) if not n.startswith("_")]
    return {n for n in names if not isinstance(getattr(module, n), type(os))}


@pytest.mark.parametrize("name", ["losses", "metrics", "data", "layers", "serving", "models",
                                  "datasets"])
def test_namespace_exports_what_jax_exports(name):
    jmod = importlib.import_module(f"stcd_tpu.{name}")
    tmod = importlib.import_module(f"stcd_tpu_torch.{name}")
    want = _public(jmod) - {"annotations"}
    missing = sorted(n for n in want if not hasattr(tmod, n))
    assert not missing, missing


def test_top_level_has_smp_names_and_predict():
    import stcd_tpu
    import stcd_tpu_torch

    for name in ("losses", "metrics", "datasets", "encoders", "decoders", "create_model",
                 "define_G", "Unet", "UnetSeg", "SegCD", "FFCTLCD", "CDNet", "UnetPlusPlus",
                 "MAnet", "Linknet", "FPN", "PSPNet", "DeepLabV3", "DeepLabV3Plus", "PAN",
                 "predict"):
        assert hasattr(stcd_tpu, name), name
        assert getattr(stcd_tpu_torch, name) is not None, name
    assert stcd_tpu_torch.losses.DiceLoss is importlib.import_module(
        "stcd_tpu_torch.losses.smp").DiceLoss
    with pytest.raises(AttributeError):
        stcd_tpu_torch.no_such_name
    model = stcd_tpu_torch.create_model("unet", "resnet18", decoder_channels=(16, 12, 8, 8, 8))
    model.train()
    x = torch.randn(1, 3, 32, 32)
    out = stcd_tpu_torch.predict(model, x)
    assert not model.training and not out.requires_grad and out.shape == (1, 1, 32, 32)


_PROBE = r"""
import json, sys
import stcd_tpu_torch
from stcd_tpu_torch import losses, metrics, datasets, data, layers, serving, models
from stcd_tpu_torch.ops import _build
zoo = sorted(m for m in sys.modules if m.startswith(("stcd_tpu_torch.encoders",
             "stcd_tpu_torch.models.", "stcd_tpu_torch.decoders", "stcd_tpu_torch.train")))
print(json.dumps({"zoo": zoo, "built": _build.load_library.cache_info().currsize}))
"""


def test_namespaces_load_no_model_zoo_and_build_nothing():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"zoo": [], "built": 0}


@pytest.mark.parametrize("ctor,fusion", [("UnetEF", "ef"), ("SiamUnetDiff", "diff"),
                                         ("SiamUnetConc", "conc"), ("SiamUnetSub", "sub"),
                                         ("SiamUnetCrossConc", "crossconc")])
def test_fc_siam_constructors_and_cdnet_match_jax(ctor, fusion):
    from stcd_tpu import models as jmodels
    from stcd_tpu_torch import models as tmodels
    from stcd_tpu_torch.models.segcd import CDNet
    from stcd_tpu_torch.models.siam_unet import FUSIONS, SiamUnet

    assert fusion in FUSIONS
    jm = getattr(jmodels, ctor)(label_nbr=3)
    tm = getattr(tmodels, ctor)(label_nbr=3)
    assert isinstance(tm, SiamUnet) and (tm.fusion, jm.fusion) == (fusion, fusion)
    assert tm.conv11d.out_channels == jm.label_nbr == 3
    a = np.zeros((1, 16, 16, 3), np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), a, a))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_jax
    assert tmodels.CDNet is CDNet and jmodels.CDNet is not None
