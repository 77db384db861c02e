"""Encoder registry (counterpart of stcd_tpu/encoders/__init__.py:40-262).

Every encoder obeys the smp stage contract: ``module(x)`` returns a pyramid
[f0 .. f_depth] of NCHW features, each level 2x smaller than the one before.
Registered: the ResNet and ResNeXt family, VGG 11/13/16/19 with their
``_bn`` variants, and MiT b0 to b5. The JAX package's other families are
listed in ``PENDING_FAMILIES``: asking for one of their names raises
NotImplementedError naming ROADMAP.md Queue 1 #9d.

``weights`` is resolved (``convert/pretrained.py``: a local file, nothing is
downloaded; a missing file raises) and loaded into the encoder here, as smp
loads it inside ``get_encoder``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from stcd_tpu_torch.encoders.mix_transformer import (MIT_CFGS, MixTransformerEncoder,
                                                     mit_out_channels)
from stcd_tpu_torch.encoders.resnet import RESNET_CFGS, ResNetEncoder, resnet_out_channels
from stcd_tpu_torch.encoders.vgg import VGG16Features, VGGEncoder, vgg_out_channels


@dataclasses.dataclass
class EncoderSpec:
    cls: Any
    kwargs: dict
    out_channels: Tuple[int, ...]


_REGISTRY: Dict[str, EncoderSpec] = {}


def register_encoder(name: str, cls, kwargs: dict, out_channels: Tuple[int, ...]) -> None:
    _REGISTRY[name] = EncoderSpec(cls, dict(kwargs), tuple(out_channels))


for _name in RESNET_CFGS:
    register_encoder(_name, ResNetEncoder, {"arch": _name}, resnet_out_channels(_name))
for _name in ("vgg11", "vgg13", "vgg16", "vgg19"):
    register_encoder(_name, VGGEncoder, {"arch": _name, "batch_norm": False},
                     vgg_out_channels(_name))
    register_encoder(_name + "_bn", VGGEncoder, {"arch": _name, "batch_norm": True},
                     vgg_out_channels(_name))
for _name in MIT_CFGS:
    register_encoder(_name, MixTransformerEncoder, {"variant": _name},
                     mit_out_channels(_name))

_SIZES = ("002", "004", "006", "008", "016", "032", "040", "064", "080", "120", "160", "320")
# the JAX package's encoder families that the port has not yet (ROADMAP.md Queue 1 #9d)
PENDING_FAMILIES = {
    "densenet": tuple(f"densenet{n}" for n in (121, 161, 169, 201)),
    "efficientnet": (tuple(f"efficientnet-b{i}" for i in range(8))
                     + tuple(f"timm-efficientnet-{v}"
                             for v in ("b0", "b1", "b2", "b3", "b4", "b5", "b6", "b7", "b8",
                                       "l2"))
                     + tuple(f"timm-tf_efficientnet_lite{i}" for i in range(5))),
    "mobilenet": ("mobilenet_v2",) + tuple(
        f"timm-mobilenetv3_{mode}_{tag}" for mode in ("large", "small")
        for tag in ("075", "100", "minimal_100")),
    "senet": ("se_resnet50", "se_resnet101", "se_resnet152", "se_resnext50_32x4d",
              "se_resnext101_32x4d", "senet154"),
    "xception": ("xception",),
    "inception": ("inceptionv4", "inceptionresnetv2"),
    "dpn": tuple(f"dpn{n}" for n in ("68", "68b", "92", "98", "107", "131")),
    "regnet": tuple(f"timm-regnet{kind}_{size}" for kind in "xy" for size in _SIZES),
    "timm_resnet": tuple("timm-" + n for n in (
        "res2net50_26w_4s", "res2net101_26w_4s", "res2net50_26w_6s", "res2net50_26w_8s",
        "res2net50_48w_2s", "res2net50_14w_8s", "res2next50", "resnest14d", "resnest26d",
        "resnest50d", "resnest101e", "resnest200e", "resnest269e", "resnest50d_4s2x40d",
        "resnest50d_1s4x24d", "skresnet18", "skresnet34", "skresnext50_32x4d")),
    "gernet": tuple(f"timm-gernet_{s}" for s in "sml"),
    "mobileone": tuple(f"mobileone_s{i}" for i in range(5)),
}
_PENDING = {name: family for family, names in PENDING_FAMILIES.items() for name in names}


def encoder_names():
    """The registered names, sorted."""
    return sorted(_REGISTRY)


def encoder_out_channels(name: str, depth: int = 5) -> Tuple[int, ...]:
    return _REGISTRY[name].out_channels[: depth + 1]


def _known(name: str) -> bool:
    return name in _REGISTRY or name in _PENDING


def _require_ported(name: str) -> None:
    if name in _PENDING:
        raise NotImplementedError(
            f"encoder {name!r} ({_PENDING[name]} family) is not ported to stcd_tpu_torch "
            f"yet; ROADMAP.md Queue 1 #9d brings it. Ported: {encoder_names()}")


def get_encoder(name: str, in_channels: int = 3, depth: int = 5,
                weights: Optional[str] = None, output_stride: int = 32,
                device=None) -> Tuple[nn.Module, Tuple[int, ...]]:
    """Build an encoder; returns ``(module, out_channels)``.

    ``in_channels`` is the width of the first conv's input (flax infers it;
    torch builds it). ``output_stride`` 8 or 16 dilates the deepest stages
    instead of striding them; an encoder without stages to dilate raises
    ValueError. ``tu-<name>`` resolves ``<name>`` or ``timm-<name>`` here (the
    JAX package has no timm either). ``weights``: see the module docstring
    and ``load_encoder_weights``."""
    if name.startswith("tu-"):
        for cand in (name[3:], f"timm-{name[3:]}"):
            if _known(cand):
                name = cand
                break
        else:
            raise KeyError(
                f"`{name}`: timm universal encoders need the optional timm "
                f"dependency; locally available encoders: {encoder_names()}")
    _require_ported(name)
    if name not in _REGISTRY:
        raise KeyError(f"Wrong encoder name `{name}`, supported encoders: {encoder_names()}")
    spec = _REGISTRY[name]
    kwargs = dict(spec.kwargs)
    if output_stride != 32:
        if output_stride not in (8, 16):
            raise ValueError(f"Output stride should be 8, 16 or 32, got {output_stride}")
        if not getattr(spec.cls, "supports_dilation", False):
            raise ValueError(f"{name} encoder does not support dilated mode")
        check = getattr(spec.cls, "check_dilation_support", None)
        if check is not None:  # a refusal of some archs within a shared class
            check(**kwargs)
        kwargs["replace_stride_with_dilation"] = (
            (False, False, True) if output_stride == 16 else (False, True, True))
    module = spec.cls(depth=depth, in_channels=in_channels, device=device, **kwargs)
    if weights is not None:
        from stcd_tpu_torch.convert.pretrained import resolve_encoder_weights
        load_encoder_weights(module, resolve_encoder_weights(weights, name))
    return module, spec.out_channels[: depth + 1]


def load_encoder_weights(encoder: nn.Module, path: str) -> None:
    """Load a torchvision state_dict file strictly into ``encoder``. The
    classifier (ResNet's ``fc.*``, VGG's ``classifier.*``), which no encoder
    has and the JAX converters never read, is dropped first, as smp's
    encoders drop it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    encoder.load_state_dict(
        {k: v for k, v in sd.items() if not k.startswith(("fc.", "classifier."))}, strict=True)


# pretrainedmodels' settings of the reference's dpn, inception and xception encoders
_PREPROCESS_SPECIAL = {
    "dpn": dict(mean=[124 / 255, 117 / 255, 104 / 255], std=[1 / (0.0167 * 255)] * 3),
    "inception": dict(mean=[0.5, 0.5, 0.5], std=[0.5, 0.5, 0.5]),
    "xception": dict(mean=[0.5, 0.5, 0.5], std=[0.5, 0.5, 0.5]),
}


def get_preprocessing_params(encoder_name: str, pretrained: str = "imagenet") -> dict:
    """The normalisation an encoder's pretrained weights expect
    (stcd_tpu/encoders/__init__.py:213-229). It needs the name only, so the
    names of families not yet ported answer too."""
    if encoder_name.startswith("tu-"):
        encoder_name = encoder_name[3:]
    if not _known(encoder_name) and not _known(f"timm-{encoder_name}"):
        raise KeyError(f"Wrong encoder name `{encoder_name}`")
    settings = dict(input_space="RGB", input_range=[0, 1],
                    mean=[0.485, 0.456, 0.406], std=[0.229, 0.224, 0.225])
    for prefix, special in _PREPROCESS_SPECIAL.items():
        if encoder_name.startswith(prefix):
            settings.update(special)
    if pretrained == "advprop":
        settings.update(mean=[0.5, 0.5, 0.5], std=[0.5, 0.5, 0.5])
    return settings


def preprocess_input(x, mean=None, std=None, input_space="RGB", input_range=None, **kwargs):
    """Normalise a channels-last numpy image (stcd_tpu/encoders/__init__.py:232-243)."""
    if input_space == "BGR":
        x = x[..., ::-1]
    if input_range is not None and x.max() > 1 and input_range[1] == 1:
        x = x / 255.0
    if mean is not None:
        x = x - np.array(mean, dtype=np.float32)
    if std is not None:
        x = x / np.array(std, dtype=np.float32)
    return x


def get_preprocessing_fn(encoder_name: str, pretrained: str = "imagenet"):
    params = get_preprocessing_params(encoder_name, pretrained=pretrained)
    return functools.partial(preprocess_input, **params)


__all__ = ["get_encoder", "load_encoder_weights", "get_preprocessing_params",
           "get_preprocessing_fn", "preprocess_input", "encoder_names", "encoder_out_channels",
           "register_encoder", "PENDING_FAMILIES", "ResNetEncoder", "VGGEncoder",
           "VGG16Features", "MixTransformerEncoder"]
