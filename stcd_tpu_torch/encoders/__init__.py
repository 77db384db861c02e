"""Encoder registry (counterpart of stcd_tpu/encoders/__init__.py
``get_encoder``). Every encoder obeys the smp stage contract: ``module(x)``
returns a pyramid [f0 .. f_depth] of NCHW features, f0 at input resolution,
each next level 2x smaller."""

from __future__ import annotations

from typing import Tuple

from torch import nn

from stcd_tpu_torch.encoders.resnet import RESNET_CFGS, ResNetEncoder


def get_encoder(name: str, depth: int = 5, device=None) -> Tuple[nn.Module, Tuple[int, ...]]:
    """Build an encoder; returns ``(module, out_channels)``. Ported: the ResNet
    family (resnet18, resnet34, resnet50) and the MiT family (mit_b0 to
    mit_b5)."""
    if name in RESNET_CFGS:
        enc = ResNetEncoder(name, depth=depth, device=device)
        return enc, enc.out_channels
    from stcd_tpu_torch.encoders.mix_transformer import MIT_CFGS, MixTransformerEncoder
    if name in MIT_CFGS:
        enc = MixTransformerEncoder(name, depth=depth, device=device)
        return enc, enc.out_channels
    raise NotImplementedError(
        f"encoder {name!r} is not ported to stcd_tpu_torch yet (ported: "
        f"{sorted(RESNET_CFGS) + sorted(MIT_CFGS)}); ROADMAP.md Queue 1 #9 brings the "
        "other families")
