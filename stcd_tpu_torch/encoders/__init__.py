"""Encoder registry (counterpart of stcd_tpu/encoders/__init__.py:40-262).

Every encoder obeys the smp stage contract: ``module(x)`` returns a pyramid
[f0 .. f_depth] of NCHW features, each level 2x smaller than the one before.
Registered: the JAX package's 124 names, in 14 families: ResNet and ResNeXt,
VGG 11/13/16/19 with their ``_bn`` variants, MiT b0 to b5, EfficientNet
(efficientnet_pytorch's and timm's names, the lite variants), MobileNet V2
and V3, SENet, DenseNet, RegNet X and Y, DPN, Xception, InceptionV4 and
InceptionResNetV2, Res2Net / ResNeSt / SKNet, GERNet and MobileOne. Each
family's module keeps the state_dict names of its upstream checkpoints
(torchvision, efficientnet_pytorch, timm, pretrainedmodels).

``weights`` is resolved (``convert/pretrained.py``: a local file, nothing is
downloaded; a missing file raises) and loaded into the encoder here, as smp
loads it inside ``get_encoder``.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from stcd_tpu_torch.encoders.densenet import (_DENSENET_CFGS, DenseNetEncoder,
                                              densenet_out_channels)
from stcd_tpu_torch.encoders.dpn import _DPN_CFGS, DPNEncoder, dpn_out_channels
from stcd_tpu_torch.encoders.efficientnet import (EfficientNetEncoder, TimmEfficientNetEncoder,
                                                  efficientnet_out_channels)
from stcd_tpu_torch.encoders.gernet import _GERNET_CFGS, GERNetEncoder, gernet_out_channels
from stcd_tpu_torch.encoders.inception import (InceptionResNetV2Encoder, InceptionV4Encoder,
                                               inceptionresnetv2_out_channels,
                                               inceptionv4_out_channels)
from stcd_tpu_torch.encoders.mix_transformer import (MIT_CFGS, MixTransformerEncoder,
                                                     mit_out_channels)
from stcd_tpu_torch.encoders.mobilenet import (MobileNetV2Encoder, MobileNetV3Encoder,
                                               mobilenetv3_out_channels)
from stcd_tpu_torch.encoders.mobileone import (_MOBILEONE_CFGS, MobileOneEncoder,
                                               mobileone_out_channels)
from stcd_tpu_torch.encoders.regnet import _REGNET_CFGS, RegNetEncoder, regnet_out_channels
from stcd_tpu_torch.encoders.resnet import RESNET_CFGS, ResNetEncoder, resnet_out_channels
from stcd_tpu_torch.encoders.senet import _SENET_CFGS, SENetEncoder, senet_out_channels
from stcd_tpu_torch.encoders.timm_resnet import (_TIMM_RESNET_CFGS, TimmResNetEncoder,
                                                 timm_resnet_out_channels)
from stcd_tpu_torch.encoders.vgg import VGG16Features, VGGEncoder, vgg_out_channels
from stcd_tpu_torch.encoders.xception import XceptionEncoder, xception_out_channels


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

for _name in _DENSENET_CFGS:
    register_encoder(_name, DenseNetEncoder, {"arch": _name}, densenet_out_channels(_name))
# efficientnet_pytorch's names slice stages by flat block index; timm's by group
for _v in ("b0", "b1", "b2", "b3", "b4", "b5", "b6", "b7"):
    register_encoder(f"efficientnet-{_v}", EfficientNetEncoder, {"variant": _v},
                     efficientnet_out_channels(_v))
for _v in ("b0", "b1", "b2", "b3", "b4", "b5", "b6", "b7", "b8", "l2"):
    register_encoder(f"timm-efficientnet-{_v}", TimmEfficientNetEncoder, {"variant": _v},
                     efficientnet_out_channels(_v))
for _v in ("lite0", "lite1", "lite2", "lite3", "lite4"):
    register_encoder(f"timm-tf_efficientnet_{_v}", TimmEfficientNetEncoder,
                     {"variant": _v, "lite": True}, efficientnet_out_channels(_v, lite=True))
register_encoder("mobilenet_v2", MobileNetV2Encoder, {}, (3, 16, 24, 32, 96, 1280))
for _mode in ("large", "small"):
    for _wm, _tag in ((0.75, "075"), (1.0, "100")):
        register_encoder(f"timm-mobilenetv3_{_mode}_{_tag}", MobileNetV3Encoder,
                         {"mode": _mode, "width_mult": _wm},
                         mobilenetv3_out_channels(_mode, _wm))
    register_encoder(f"timm-mobilenetv3_{_mode}_minimal_100", MobileNetV3Encoder,
                     {"mode": _mode, "width_mult": 1.0, "minimal": True},
                     mobilenetv3_out_channels(_mode, 1.0))
for _name in _SENET_CFGS:
    register_encoder(_name, SENetEncoder, {"arch": _name}, senet_out_channels(_name))
register_encoder("xception", XceptionEncoder, {}, xception_out_channels())
register_encoder("inceptionv4", InceptionV4Encoder, {}, inceptionv4_out_channels())
register_encoder("inceptionresnetv2", InceptionResNetV2Encoder, {},
                 inceptionresnetv2_out_channels())
for _name in _DPN_CFGS:
    register_encoder(_name, DPNEncoder, {"arch": _name}, dpn_out_channels(_name))
for _name in _REGNET_CFGS:
    register_encoder(f"timm-{_name}", RegNetEncoder, {"arch": _name},
                     regnet_out_channels(_name))
for _name in _TIMM_RESNET_CFGS:
    register_encoder(f"timm-{_name}", TimmResNetEncoder, {"arch": _name},
                     timm_resnet_out_channels(_name))
for _name in _GERNET_CFGS:
    register_encoder(f"timm-{_name}", GERNetEncoder, {"arch": _name},
                     gernet_out_channels(_name))
for _name in _MOBILEONE_CFGS:
    register_encoder(_name, MobileOneEncoder, {"arch": _name}, mobileone_out_channels(_name))


def encoder_names():
    """The registered names, sorted."""
    return sorted(_REGISTRY)


def encoder_out_channels(name: str, depth: int = 5) -> Tuple[int, ...]:
    return _REGISTRY[name].out_channels[: depth + 1]


def encoder_spec(name: str) -> EncoderSpec:
    """The registry's entry of ``name`` (``tu-<name>`` resolved as in
    ``get_encoder``)."""
    if name.startswith("tu-"):
        for cand in (name[3:], f"timm-{name[3:]}"):
            if cand in _REGISTRY:
                return _REGISTRY[cand]
        raise KeyError(
            f"`{name}`: timm universal encoders need the optional timm "
            f"dependency; locally available encoders: {encoder_names()}")
    if name not in _REGISTRY:
        raise KeyError(f"Wrong encoder name `{name}`, supported encoders: {encoder_names()}")
    return _REGISTRY[name]


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
    spec = encoder_spec(name)
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
    """Load an upstream state_dict file strictly into ``encoder``. First the
    checkpoint's classifier head, which no encoder has and the JAX converters
    never read, is dropped (the encoder class's ``head_prefixes``: ResNet's
    ``fc``, VGG's ``classifier`` by default); DenseNet's legacy names
    (``norm.1``) are renamed; a fused MobileOne file (``reparam_conv``) is
    refused, as the JAX converter refuses it; and a conv bias that the
    encoder declares and the file lacks (timm's SK ``fc_select``) is zero, as
    the JAX converter of that family makes it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if any(k.endswith("reparam_conv.weight") for k in sd):
        raise ValueError("fused (inference-form) MobileOne checkpoint: convert the unfused "
                         "train-form weights instead (reparam_conv.* found)")
    sd = {k: v for k, v in sd.items()
          if not k.startswith(getattr(encoder, "head_prefixes", ("fc.", "classifier.")))}
    if isinstance(encoder, DenseNetEncoder):
        sd = densenet_normalize_keys(sd)
    if isinstance(encoder, (TimmResNetEncoder, RegNetEncoder)):
        for k, v in encoder.state_dict().items():
            if k.endswith(".bias") and k not in sd and k[:-4] + "weight" in sd:
                sd[k] = torch.zeros_like(v, device="cpu")
    encoder.load_state_dict(sd, strict=True)


def densenet_normalize_keys(sd: Dict[str, Any]) -> Dict[str, Any]:
    """torchvision's legacy DenseNet names (``denselayer1.norm.1.weight``) ->
    the current ones (``denselayer1.norm1.weight``), by the regex of the JAX
    converter (stcd_tpu/convert/torch_to_flax.py:1335-1350)."""
    pattern = re.compile(r"^(.*denselayer\d+\.(?:norm|relu|conv))\.((?:[12])\.(?:weight|bias|"
                         r"running_mean|running_var))$")
    out = {}
    for k, v in sd.items():
        m = pattern.match(k)
        out[m.group(1) + m.group(2) if m else k] = v
    return out


# pretrainedmodels' settings of the reference's dpn, inception and xception encoders
_PREPROCESS_SPECIAL = {
    "dpn": dict(mean=[124 / 255, 117 / 255, 104 / 255], std=[1 / (0.0167 * 255)] * 3),
    "inception": dict(mean=[0.5, 0.5, 0.5], std=[0.5, 0.5, 0.5]),
    "xception": dict(mean=[0.5, 0.5, 0.5], std=[0.5, 0.5, 0.5]),
}


def get_preprocessing_params(encoder_name: str, pretrained: str = "imagenet") -> dict:
    """The normalisation an encoder's pretrained weights expect
    (stcd_tpu/encoders/__init__.py:213-229)."""
    if encoder_name.startswith("tu-"):
        encoder_name = encoder_name[3:]
    if encoder_name not in _REGISTRY and f"timm-{encoder_name}" not in _REGISTRY:
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
    """Normalise a channels-last image (stcd_tpu/encoders/__init__.py:232-243):
    a numpy array, or a tensor, which stays on its device."""
    tensor = isinstance(x, torch.Tensor)

    def const(v):
        if tensor:
            return torch.tensor(v, dtype=torch.float32, device=x.device)
        return np.array(v, dtype=np.float32)

    if input_space == "BGR":
        x = x.flip(-1) if tensor else x[..., ::-1]
    if input_range is not None and x.max() > 1 and input_range[1] == 1:
        x = x / 255.0
    if mean is not None:
        x = x - const(mean)
    if std is not None:
        x = x / const(std)
    return x


def get_preprocessing_fn(encoder_name: str, pretrained: str = "imagenet"):
    params = get_preprocessing_params(encoder_name, pretrained=pretrained)
    return functools.partial(preprocess_input, **params)


__all__ = ["get_encoder", "load_encoder_weights", "get_preprocessing_params",
           "get_preprocessing_fn", "preprocess_input", "encoder_names", "encoder_out_channels",
           "encoder_spec", "register_encoder", "ResNetEncoder", "VGGEncoder", "VGG16Features",
           "MixTransformerEncoder", "EfficientNetEncoder", "TimmEfficientNetEncoder",
           "MobileNetV2Encoder", "MobileNetV3Encoder", "SENetEncoder", "DenseNetEncoder",
           "RegNetEncoder", "DPNEncoder", "XceptionEncoder", "InceptionV4Encoder",
           "InceptionResNetV2Encoder", "TimmResNetEncoder", "GERNetEncoder",
           "MobileOneEncoder"]
