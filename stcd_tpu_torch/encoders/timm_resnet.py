"""Res2Net, ResNeSt and SKNet encoders (counterpart of
stcd_tpu/encoders/timm_resnet.py) under timm's ResNet names: the stem
``conv1`` / ``bn1`` (ResNeSt's deep stem ``conv1.0`` / ``.1`` / ``.3`` /
``.4`` / ``.6`` and ``bn1``), ``layer{1..4}.{b}`` blocks with
``downsample.0`` / ``.1`` (ResNeSt: ``downsample.1`` / ``.2`` after an
average pool).

- Res2Net (``Bottle2neck``): ``conv1``, ``bn1``, ``convs.{i}`` /
  ``bns.{i}`` over ``scale`` hierarchical splits, ``conv3``, ``bn3``. A
  strided or projecting block convolves every split but the last one apart,
  and average-pools (3x3, the stride, padding counted) the last one.
- ResNeSt (``ResNestBottleneck``): ``conv1``, ``bn1``, the split-attention
  ``conv2.conv`` / ``bn0`` / ``fc1`` / ``bn1`` / ``fc2`` (radix softmax over
  the group-major channel layout), the avd pool after it (before it in the
  ``4s2x40d`` / ``1s4x24d`` variants), ``conv3``, ``bn3``; avg-down
  shortcut.
- SKNet: ``SelectiveKernel`` with ``paths.{0,1}.conv`` / ``.bn`` (3x3 at
  dilation 1 and 2) and ``attn.fc_reduce`` / ``bn`` / ``fc_select``; the
  basic block is ``conv1`` (SK) and ``conv2`` (``.conv`` / ``.bn``), the
  bottleneck ``conv1`` / ``conv2`` (SK) / ``conv3``.

Only SKNet dilates (smp refuses res2net and resnest): a dilated stage runs at
stride 1 and both SK paths at the stage's rate, as smp's conv patch does.
The biases that the JAX encoder declares and timm's files may lack
(``fc1``, ``fc2``, ``fc_select``) are zeros when such a file is loaded
(``encoders.load_encoder_weights``), as the JAX converter makes them.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from stcd_tpu_torch.encoders.dilation import make_dilated_rates
from stcd_tpu_torch.layers.modules import ConvNorm
from stcd_tpu_torch.layers.norm import BatchNorm

# name: (block, layers, base_width, cardinality, block_arg, stem_width, avg_down)
_TIMM_RESNET_CFGS = {
    "res2net50_26w_4s": ("res2", (3, 4, 6, 3), 26, 1, 4, 64, False),
    "res2net101_26w_4s": ("res2", (3, 4, 23, 3), 26, 1, 4, 64, False),
    "res2net50_26w_6s": ("res2", (3, 4, 6, 3), 26, 1, 6, 64, False),
    "res2net50_26w_8s": ("res2", (3, 4, 6, 3), 26, 1, 8, 64, False),
    "res2net50_48w_2s": ("res2", (3, 4, 6, 3), 48, 1, 2, 64, False),
    "res2net50_14w_8s": ("res2", (3, 4, 6, 3), 14, 1, 8, 64, False),
    "res2next50": ("res2", (3, 4, 6, 3), 4, 8, 4, 64, False),
    "resnest14d": ("nest", (1, 1, 1, 1), 64, 1, 2, 32, True),
    "resnest26d": ("nest", (2, 2, 2, 2), 64, 1, 2, 32, True),
    "resnest50d": ("nest", (3, 4, 6, 3), 64, 1, 2, 32, True),
    "resnest101e": ("nest", (3, 4, 23, 3), 64, 1, 2, 64, True),
    "resnest200e": ("nest", (3, 24, 36, 3), 64, 1, 2, 64, True),
    "resnest269e": ("nest", (3, 30, 48, 8), 64, 1, 2, 64, True),
    "resnest50d_4s2x40d": ("nest", (3, 4, 6, 3), 40, 2, 4, 32, True),
    "resnest50d_1s4x24d": ("nest", (3, 4, 6, 3), 24, 4, 1, 32, True),
    "skresnet18": ("sk_basic", (2, 2, 2, 2), 64, 1, 0, 64, False),
    "skresnet34": ("sk_basic", (3, 4, 6, 3), 64, 1, 0, 64, False),
    "skresnext50_32x4d": ("sk_bottle", (3, 4, 6, 3), 4, 32, 0, 64, False),
}


def timm_resnet_out_channels(name: str) -> Tuple[int, ...]:
    kind, _, _, _, _, stem_w, _ = _TIMM_RESNET_CFGS[name]
    e = 1 if kind == "sk_basic" else 4
    return (3, stem_w * 2 if kind == "nest" else 64, 64 * e, 128 * e, 256 * e, 512 * e)


def _make_divisible(v, divisor=8, min_value=None):
    """timm.layers.make_divisible."""
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _downsample(in_c: int, out_c: int, stride: int, device) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(in_c, out_c, 1, stride=stride, bias=False, device=device),
                         BatchNorm(out_c, device=device))


class Bottle2neck(nn.Module):
    """stcd_tpu/encoders/timm_resnet.py:70-118."""

    def __init__(self, in_c: int, planes: int, base_width: int = 26, cardinality: int = 1,
                 scale: int = 4, stride: int = 1, downsample: bool = False, device=None):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64.0))) * cardinality
        out_c = planes * 4
        self.scale, self.stride = scale, stride
        self.is_first = stride > 1 or downsample
        self.conv1 = nn.Conv2d(in_c, width * scale, 1, bias=False, device=device)
        self.bn1 = BatchNorm(width * scale, device=device)
        n = max(1, scale - 1)
        self.convs = nn.ModuleList([
            nn.Conv2d(width, width, 3, stride=stride, padding=1, groups=cardinality,
                      bias=False, device=device) for _ in range(n)])
        self.bns = nn.ModuleList([BatchNorm(width, device=device) for _ in range(n)])
        self.conv3 = nn.Conv2d(width * scale, out_c, 1, bias=False, device=device)
        self.bn3 = BatchNorm(out_c, device=device)
        self.downsample = _downsample(in_c, out_c, stride, device) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(x)))
        sp = torch.chunk(h, self.scale, 1)
        outs, prev = [], None
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            s = sp[i] if (i == 0 or self.is_first) else sp[i] + prev
            prev = torch.relu(bn(conv(s)))
            outs.append(prev)
        if self.scale > 1:
            last = sp[-1]
            if self.is_first:
                last = F.avg_pool2d(last, 3, self.stride, 1)
            outs.append(last)
        h = self.bn3(self.conv3(torch.cat(outs, 1)))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(h + identity)


class SplitAttn(nn.Module):
    """ResNeSt's SplAtConv2d (stcd_tpu/encoders/timm_resnet.py:121-165)."""

    def __init__(self, in_c: int, channels: int, radix: int = 2, groups: int = 1, device=None):
        super().__init__()
        self.radix, self.channels, self.groups = radix, channels, groups
        self.conv = nn.Conv2d(in_c, channels * radix, 3, padding=1, groups=groups * radix,
                              bias=False, device=device)
        self.bn0 = BatchNorm(channels * radix, device=device)
        v = channels * radix // 4
        inter = max(32, int(v + 4) // 8 * 8)
        if inter < 0.9 * v:
            inter += 8
        self.fc1 = nn.Conv2d(channels, inter, 1, groups=groups, device=device)
        self.bn1 = BatchNorm(inter, device=device)
        self.fc2 = nn.Conv2d(inter, channels * radix, 1, groups=groups, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r, c = self.radix, self.channels
        h = torch.relu(self.bn0(self.conv(x)))
        parts = torch.chunk(h, r, 1) if r > 1 else (h,)
        gap = sum(parts).mean((2, 3), keepdim=True)
        a = self.fc2(torch.relu(self.bn1(self.fc1(gap))))
        if r == 1:
            return h * torch.sigmoid(a)
        n = a.shape[0]
        # softmax over the radix of (groups, radix, c / groups), flattened
        # radix-major so each split keeps the conv's group-major layout
        a = a.reshape(n, self.groups, r, c // self.groups).softmax(2)
        a = a.transpose(1, 2).reshape(n, r, c, 1, 1)
        return sum(a[:, i] * parts[i] for i in range(r))


class ResNestBottleneck(nn.Module):
    """stcd_tpu/encoders/timm_resnet.py:168-206."""

    def __init__(self, in_c: int, planes: int, base_width: int = 64, cardinality: int = 1,
                 radix: int = 2, stride: int = 1, downsample: bool = False,
                 avd_first: bool = False, device=None):
        super().__init__()
        gw = int(planes * (base_width / 64.0)) * cardinality
        out_c = planes * 4
        self.stride, self.avd_first = stride, avd_first
        self.conv1 = nn.Conv2d(in_c, gw, 1, bias=False, device=device)
        self.bn1 = BatchNorm(gw, device=device)
        self.conv2 = SplitAttn(gw, gw, radix, cardinality, device)
        self.conv3 = nn.Conv2d(gw, out_c, 1, bias=False, device=device)
        self.bn3 = BatchNorm(out_c, device=device)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.AvgPool2d(2, 2) if stride > 1 else nn.Identity(),
                nn.Conv2d(in_c, out_c, 1, bias=False, device=device),
                BatchNorm(out_c, device=device))

    def _avd(self, h: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(h, 3, self.stride, 1) if self.stride > 1 else h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(x)))
        if self.avd_first:
            h = self._avd(h)
        h = self.conv2(h)
        if not self.avd_first:
            h = self._avd(h)
        h = self.bn3(self.conv3(h))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(h + identity)


class _SKAttn(nn.Module):
    def __init__(self, c: int, rd: int, device=None):
        super().__init__()
        self.fc_reduce = nn.Conv2d(c, rd, 1, bias=False, device=device)
        self.bn = BatchNorm(rd, device=device)
        self.fc_select = nn.Conv2d(rd, c * 2, 1, device=device)


class SelectiveKernel(nn.Module):
    """Two 3x3 paths (dilation 1 and 2; skresnet18/34 give each half of the
    input), fused by a softmax over the paths
    (stcd_tpu/encoders/timm_resnet.py:218-265)."""

    def __init__(self, in_c: int, out_c: int, stride: int = 1, dilation: int = 1,
                 groups: int = 1, split_input: bool = True, rd_ratio: float = 1 / 8,
                 rd_divisor: int = 8, device=None):
        super().__init__()
        self.split_input, self.out_c = split_input, out_c
        path_in = in_c // 2 if split_input else in_c
        g = max(min(out_c, groups), 1)
        paths = []
        for d in (1, 2):
            if dilation > 1:
                d = dilation
            paths.append(ConvNorm(path_in, out_c, 3, stride=1 if dilation > 1 else stride,
                                  dilation=d, groups=g, device=device))
        self.paths = nn.ModuleList(paths)
        self.attn = _SKAttn(out_c, _make_divisible(out_c * rd_ratio, rd_divisor), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ins = torch.chunk(x, 2, 1) if self.split_input else (x, x)
        f0, f1 = (torch.relu(p(i)) for p, i in zip(self.paths, ins))
        a = (f0 + f1).mean((2, 3), keepdim=True)
        a = torch.relu(self.attn.bn(self.attn.fc_reduce(a)))
        a = self.attn.fc_select(a)
        a = a.reshape(a.shape[0], 2, self.out_c, 1, 1).softmax(1)
        return a[:, 0] * f0 + a[:, 1] * f1


class SelectiveKernelBlock(nn.Module):
    """SK basic (skresnet18/34) or bottleneck (skresnext50_32x4d) block
    (stcd_tpu/encoders/timm_resnet.py:268-316)."""

    def __init__(self, in_c: int, planes: int, bottleneck: bool = False, base_width: int = 64,
                 cardinality: int = 1, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, device=None):
        super().__init__()
        dd = dilation
        self.bottleneck = bottleneck
        if bottleneck:
            width = int(planes * (base_width / 64.0)) * cardinality
            out_c = planes * 4
            self.conv1 = ConvNorm(in_c, width, 1, device=device)
            self.conv2 = SelectiveKernel(width, width, stride, dd, cardinality, False,
                                         1 / 16, 32, device)
            self.conv3 = ConvNorm(width, out_c, 1, device=device)
        else:
            out_c = planes
            self.conv1 = SelectiveKernel(in_c, planes, stride, dd, device=device)
            self.conv2 = ConvNorm(planes, out_c, 3, dilation=dd, device=device)
        self.downsample = (_downsample(in_c, out_c, 1 if dd > 1 else stride, device)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bottleneck:
            h = self.conv3(self.conv2(torch.relu(self.conv1(x))))
        else:
            h = self.conv2(self.conv1(x))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(h + identity)


class TimmResNetEncoder(nn.Module):
    """smp-contract encoder of the res2net, resnest and sknet families
    (stcd_tpu/encoders/timm_resnet.py:319-390)."""

    supports_dilation = True
    head_prefixes = ("fc.",)

    @staticmethod
    def check_dilation_support(arch="res2net50_26w_4s", **_):
        kind = _TIMM_RESNET_CFGS[arch][0]
        if kind == "res2":
            raise ValueError("Res2Net encoders do not support dilated mode")
        if kind == "nest":
            raise ValueError("ResNest encoders do not support dilated mode")

    def __init__(self, arch: str = "res2net50_26w_4s", depth: int = 5,
                 replace_stride_with_dilation: Sequence[bool] = (False, False, False),
                 in_channels: int = 3, device=None):
        super().__init__()
        kind, layers, base_width, card, barg, stem_w, _ = _TIMM_RESNET_CFGS[arch]
        flags = replace_stride_with_dilation
        if any(flags):
            self.check_dilation_support(arch)
        rates = make_dilated_rates(flags)
        self.depth = depth
        self.out_channels = timm_resnet_out_channels(arch)[:depth + 1]
        if depth >= 1:
            if kind == "nest":
                self.conv1 = nn.Sequential(
                    nn.Conv2d(in_channels, stem_w, 3, 2, 1, bias=False, device=device),
                    BatchNorm(stem_w, device=device), nn.ReLU(),
                    nn.Conv2d(stem_w, stem_w, 3, 1, 1, bias=False, device=device),
                    BatchNorm(stem_w, device=device), nn.ReLU(),
                    nn.Conv2d(stem_w, stem_w * 2, 3, 1, 1, bias=False, device=device))
                self.bn1 = BatchNorm(stem_w * 2, device=device)
            else:
                self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False, device=device)
                self.bn1 = BatchNorm(64, device=device)
        in_c = self.out_channels[1] if depth >= 1 else 64
        e = 1 if kind == "sk_basic" else 4
        planes = (64, 128, 256, 512)
        for i in range(4):
            if depth < 2 + i:
                break
            stride = 1 if i == 0 else 2
            blocks = []
            for b in range(layers[i]):
                down = b == 0 and (stride != 1 or in_c != planes[i] * e)
                s = stride if b == 0 else 1
                if kind == "res2":
                    blk = Bottle2neck(in_c, planes[i], base_width, card, barg, s, down, device)
                elif kind == "nest":
                    blk = ResNestBottleneck(in_c, planes[i], base_width, card, barg, s, down,
                                            arch.endswith(("4s2x40d", "1s4x24d")), device)
                else:
                    dil = rates[i - 1] if i > 0 and flags[i - 1] else 1
                    blk = SelectiveKernelBlock(in_c, planes[i], kind == "sk_bottle", base_width,
                                               card, s, dil, down, device)
                blocks.append(blk)
                in_c = planes[i] * e
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        features = [x]
        if self.depth >= 1:
            x = torch.relu(self.bn1(self.conv1(x)))
            features.append(x)
        for i in range(1, min(self.depth, 5)):
            if i == 1:
                x = F.max_pool2d(x, 3, 2, 1)
            x = getattr(self, f"layer{i}")(x)
            features.append(x)
        return features
