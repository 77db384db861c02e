"""MobileNetV2 and MobileNetV3 encoders (counterpart of
stcd_tpu/encoders/mobilenet.py).

- ``MobileNetV2Encoder`` keeps torchvision's names (``features.0.0`` the stem
  conv, ``features.{i}.conv.*`` the inverted residuals, ``features.18`` the
  final 1x1 conv); stages end after features 1, 3, 6, 13 and 18:
  out_channels (3, 16, 24, 32, 96, 1280).
- ``MobileNetV3Encoder`` keeps timm's (``conv_stem``, ``bn1``,
  ``blocks.{g}.{i}`` with ``conv_pw`` / ``conv_dw`` / ``se.conv_reduce`` /
  ``conv_pwl``, the final ``blocks.{n}.0.conv``); large groups the stem with
  group 0 in stage 1, small starts stage 1 at the stem. Widths are
  ``make_divisible(c * width_mult)``; ``minimal`` is timm's
  ``*_minimal_100``: 3x3 kernels, no squeeze-excite, relu.

A dilated stage (smp's make_dilated) runs its depthwise convs at stride 1
with dilation d and padding (k // 2) * d; a block keeps its residual by its
original stride. hard_swish and hard_sigmoid are relu6(x + 3) / 6 based.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from stcd_tpu_torch.encoders.dilation import make_dilated_rates
from stcd_tpu_torch.layers.norm import BatchNorm


def make_divisible(v: float, divisor: int = 8, min_value: Optional[int] = None) -> int:
    """torchvision's and timm's _make_divisible: the nearest multiple, never
    more than 10% below ``v``."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * F.relu6(x + 3.0) / 6.0


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


_ACTS = {"relu6": F.relu6, "relu": torch.relu, "hswish": hard_swish}


def _conv_bn(in_c: int, out_c: int, kernel: int, stride: int = 1, dilation: int = 1,
             groups: int = 1, device=None) -> nn.Sequential:
    """torchvision's Conv2dNormActivation without its activation module
    (``0`` conv, ``1`` BatchNorm)."""
    return nn.Sequential(
        nn.Conv2d(in_c, out_c, kernel, stride=stride, padding=(kernel // 2) * dilation,
                  dilation=dilation, groups=groups, bias=False, device=device),
        BatchNorm(out_c, device=device))


class InvertedResidualV2(nn.Module):
    """torchvision's InvertedResidual (``conv.0`` expand, ``conv.1``
    depthwise, ``conv.2`` project, ``conv.3`` its BatchNorm; without an
    expand the indices shift down by one). relu6."""

    def __init__(self, in_c: int, exp_c: int, out_c: int, stride: int, dilation: int = 1,
                 device=None):
        super().__init__()
        self.residual = stride == 1 and in_c == out_c
        stride = 1 if dilation > 1 else stride
        layers = [_conv_bn(in_c, exp_c, 1, device=device)] if exp_c != in_c else []
        layers += [_conv_bn(exp_c, exp_c, 3, stride, dilation, exp_c, device),
                   nn.Conv2d(exp_c, out_c, 1, bias=False, device=device),
                   BatchNorm(out_c, device=device)]
        self.has_expand = exp_c != in_c
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = list(self.conv)
        h = x
        if self.has_expand:
            h = F.relu6(layers.pop(0)(h))
        h = F.relu6(layers[0](h))
        h = layers[2](layers[1](h))
        return h + x if self.residual else h


# MobileNetV2 (t, c, n, s): torchvision's mobilenet_v2
_V2_CFG = [
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]
_V2_STAGE_END = {1: 1, 3: 2, 6: 3, 13: 4}  # feature index -> the stage it ends


class MobileNetV2Encoder(nn.Module):
    """smp-contract MobileNetV2 (stcd_tpu/encoders/mobilenet.py:115-167):
    [x, features[:2] (16 /2), [2:4] (24 /4), [4:7] (32 /8), [7:14] (96 /16),
    [14:] with the final conv (1280 /32)]."""

    supports_dilation = True
    head_prefixes = ("classifier.",)

    def __init__(self, depth: int = 5,
                 replace_stride_with_dilation: Sequence[bool] = (False, False, False),
                 in_channels: int = 3, device=None):
        super().__init__()
        self.depth = depth
        self.out_channels = (3, 16, 24, 32, 96, 1280)[:depth + 1]
        flags = replace_stride_with_dilation
        rates = make_dilated_rates(flags)
        stage_dilation = {si: rates[si - 3] for si in (3, 4, 5) if flags[si - 3]}
        blocks = [(t, c, s if i == 0 else 1) for t, c, n, s in _V2_CFG for i in range(n)]
        features: List[nn.Module] = [_conv_bn(in_channels, 32, 3, 2, device=device)]
        self._taps = []
        in_c, stage = 32, 1
        for idx, (t, c, s) in enumerate(blocks, start=1):
            if stage > depth:
                break
            features.append(InvertedResidualV2(in_c, t * in_c, c, s,
                                               stage_dilation.get(stage, 1), device))
            in_c = c
            self._taps.append(idx in _V2_STAGE_END)
            stage += idx in _V2_STAGE_END
        self._final = stage <= depth
        if self._final:
            features.append(_conv_bn(in_c, 1280, 1, device=device))
        self.features = nn.Sequential(*features)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        mods = list(self.features)
        out = [x]
        h = F.relu6(mods[0](x))
        for block, tap in zip(mods[1:], self._taps):
            h = block(h)
            if tap:
                out.append(h)
        if self._final:
            out.append(F.relu6(mods[-1](h)))
        return out


class _SqueezeExcite(nn.Module):
    """timm's SqueezeExcite: ``conv_reduce`` -> relu -> ``conv_expand`` ->
    hard_sigmoid gate."""

    def __init__(self, c: int, rd: int, device=None):
        super().__init__()
        self.conv_reduce = nn.Conv2d(c, rd, 1, device=device)
        self.conv_expand = nn.Conv2d(rd, c, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.relu(self.conv_reduce(x.mean((2, 3), keepdim=True)))
        return x * hard_sigmoid(self.conv_expand(s))


class InvertedResidualV3(nn.Module):
    """timm's InvertedResidual (``conv_pw``, ``bn1``, ``conv_dw``, ``bn2``,
    ``se``, ``conv_pwl``, ``bn3``) or, without an expand conv, its
    DepthwiseSeparableConv (``conv_dw``, ``bn1``, ``se``, ``conv_pw``,
    ``bn2``). The squeeze width is ``make_divisible(in_c / 4)``, from the
    block's input (timm's se_from_exp=False)."""

    def __init__(self, in_c: int, exp_c: int, out_c: int, kernel: int, stride: int,
                 use_se: bool, act: str, dilation: int = 1, device=None):
        super().__init__()
        self.act = _ACTS[act]
        self.residual = stride == 1 and in_c == out_c
        self.has_expand = exp_c != in_c
        stride = 1 if dilation > 1 else stride
        dw = nn.Conv2d(exp_c, exp_c, kernel, stride=stride, padding=(kernel // 2) * dilation,
                       dilation=dilation, groups=exp_c, bias=False, device=device)
        proj = nn.Conv2d(exp_c, out_c, 1, bias=False, device=device)
        if self.has_expand:
            self.conv_pw = nn.Conv2d(in_c, exp_c, 1, bias=False, device=device)
            self.bn1 = BatchNorm(exp_c, device=device)
            self.conv_dw, self.bn2 = dw, BatchNorm(exp_c, device=device)
            self.conv_pwl, self.bn3 = proj, BatchNorm(out_c, device=device)
        else:
            self.conv_dw, self.bn1 = dw, BatchNorm(exp_c, device=device)
            self.conv_pw, self.bn2 = proj, BatchNorm(out_c, device=device)
        self.se = _SqueezeExcite(exp_c, make_divisible(in_c / 4), device) if use_se else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.has_expand:
            h = self.act(self.bn1(self.conv_pw(h)))
            h = self.act(self.bn2(self.conv_dw(h)))
        else:
            h = self.act(self.bn1(self.conv_dw(h)))
        if self.se is not None:
            h = self.se(h)
        h = self.bn3(self.conv_pwl(h)) if self.has_expand else self.bn2(self.conv_pw(h))
        return h + x if self.residual else h


class _FinalConv(nn.Module):
    """timm's ConvBnAct at the end of ``blocks``: ``conv``, ``bn1``."""

    def __init__(self, in_c: int, out_c: int, device=None):
        super().__init__()
        self.conv = nn.Conv2d(in_c, out_c, 1, bias=False, device=device)
        self.bn1 = BatchNorm(out_c, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn1(self.conv(x))


# MobileNetV3 block specs, a group a list: (kernel, exp, out, se, act, stride)
_V3_LARGE = [
    [(3, 16, 16, False, "relu", 1)],
    [(3, 64, 24, False, "relu", 2), (3, 72, 24, False, "relu", 1)],
    [(5, 72, 40, True, "relu", 2), (5, 120, 40, True, "relu", 1),
     (5, 120, 40, True, "relu", 1)],
    [(3, 240, 80, False, "hswish", 2), (3, 200, 80, False, "hswish", 1),
     (3, 184, 80, False, "hswish", 1), (3, 184, 80, False, "hswish", 1)],
    [(3, 480, 112, True, "hswish", 1), (3, 672, 112, True, "hswish", 1)],
    [(5, 672, 160, True, "hswish", 2), (5, 960, 160, True, "hswish", 1),
     (5, 960, 160, True, "hswish", 1)],
]
_V3_SMALL = [
    [(3, 16, 16, True, "relu", 2)],
    [(3, 72, 24, False, "relu", 2), (3, 88, 24, False, "relu", 1)],
    [(5, 96, 40, True, "hswish", 2), (5, 240, 40, True, "hswish", 1),
     (5, 240, 40, True, "hswish", 1)],
    [(5, 120, 48, True, "hswish", 1), (5, 144, 48, True, "hswish", 1)],
    [(5, 288, 96, True, "hswish", 2), (5, 576, 96, True, "hswish", 1),
     (5, 576, 96, True, "hswish", 1)],
]
# the groups of each smp stage 1..5 (the stem leads stage 1)
_V3_STAGES = {"large": [[0], [1], [2], [3, 4], [5]], "small": [[], [0], [1], [2, 3], [4]]}


def mobilenetv3_out_channels(mode: str, width_mult: float = 1.0) -> Tuple[int, ...]:
    base = [16, 16, 24, 48, 576] if mode == "small" else [16, 24, 40, 112, 960]
    return tuple([3] + [make_divisible(c * width_mult) for c in base])


class MobileNetV3Encoder(nn.Module):
    """smp-contract MobileNetV3 (stcd_tpu/encoders/mobilenet.py:193-248)."""

    supports_dilation = True
    head_prefixes = ("conv_head.", "classifier.")

    def __init__(self, mode: str = "large", width_mult: float = 1.0, minimal: bool = False,
                 depth: int = 5,
                 replace_stride_with_dilation: Sequence[bool] = (False, False, False),
                 in_channels: int = 3, device=None):
        super().__init__()
        specs = _V3_LARGE if mode == "large" else _V3_SMALL
        self.depth = depth
        self.out_channels = mobilenetv3_out_channels(mode, width_mult)[:depth + 1]
        self.stem_act = torch.relu if minimal else hard_swish
        stem_c = make_divisible(16 * width_mult)
        self.conv_stem = nn.Conv2d(in_channels, stem_c, 3, stride=2, padding=1, bias=False,
                                   device=device)
        self.bn1 = BatchNorm(stem_c, device=device)
        flags = replace_stride_with_dilation
        rates = make_dilated_rates(flags)
        stage_dilation = {si: rates[si - 3] for si in (3, 4, 5) if flags[si - 3]}
        groups: List[nn.Module] = []
        self._stage_groups = []
        in_c = stem_c
        for stage, gids in enumerate(_V3_STAGES[mode], start=1):
            if stage > depth:
                break
            self._stage_groups.append(len(gids))
            for g in gids:
                blocks = []
                for (k, e, c, se, act, s) in specs[g]:
                    if minimal:
                        k, se, act = 3, False, "relu"
                    out_c = make_divisible(c * width_mult)
                    blocks.append(InvertedResidualV3(in_c, make_divisible(e * width_mult), out_c,
                                                     k, s, se, act, stage_dilation.get(stage, 1),
                                                     device))
                    in_c = out_c
                groups.append(nn.Sequential(*blocks))
        if depth >= 5:
            final_c = make_divisible((960 if mode == "large" else 576) * width_mult)
            groups.append(nn.Sequential(_FinalConv(in_c, final_c, device)))
        self.blocks = nn.ModuleList(groups)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        features = [x]
        h = self.stem_act(self.bn1(self.conv_stem(x)))
        g = 0
        for stage, n_groups in enumerate(self._stage_groups, start=1):
            for _ in range(n_groups):
                h = self.blocks[g](h)
                g += 1
            if stage == 5:
                h = self.stem_act(self.blocks[g](h))
            features.append(h)
        return features
