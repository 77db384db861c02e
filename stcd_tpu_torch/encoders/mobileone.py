"""MobileOne encoders (counterpart of stcd_tpu/encoders/mobileone.py) in the
train form, under the reference's names: ``stage0`` and
``stage{1..4}.{i}`` MobileOneBlocks, each with ``rbr_conv.{j}.conv`` /
``.bn`` (the kxk branches), ``rbr_scale.conv`` / ``.bn`` (the 1x1 branch of
a kxk block), ``rbr_skip`` (the BatchNorm identity where the shape allows)
and ``se.reduce`` / ``se.expand``.

A stage block is a depthwise 3x3 block (even index) then a pointwise 1x1
block (odd index); the branches are summed, then relu. The encoder keeps
the branches (no reparameterisation), so a fused checkpoint (with
``reparam_conv``) does not load. Widths are the base (64, 128, 256, 512)
times the variant's multipliers, depths (2, 8, 10, 1); stage0 has the single
conv branch even in s0; s4 has squeeze-excite in the last stage and the
second half of stage 3. A dilated stage runs at stride 1 and dilates its
kxk branches; the identity branch keeps to the original stride.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from stcd_tpu_torch.encoders.dilation import make_dilated_rates
from stcd_tpu_torch.layers.modules import ConvNorm
from stcd_tpu_torch.layers.norm import BatchNorm

# name: (width_multipliers, num_conv_branches, use_se)
_MOBILEONE_CFGS = {
    "mobileone_s0": ((0.75, 1.0, 1.0, 2.0), 4, False),
    "mobileone_s1": ((1.5, 1.5, 2.0, 2.5), 1, False),
    "mobileone_s2": ((1.5, 2.0, 2.5, 4.0), 1, False),
    "mobileone_s3": ((2.0, 2.5, 3.0, 4.0), 1, False),
    "mobileone_s4": ((3.0, 3.5, 3.5, 4.0), 1, True),
}
_BASE_WIDTHS = (64, 128, 256, 512)
_DEPTHS = (2, 8, 10, 1)


def mobileone_out_channels(name: str) -> Tuple[int, ...]:
    wms = _MOBILEONE_CFGS[name][0]
    return (3, min(64, int(64 * wms[0]))) + tuple(int(w * m) for w, m in zip(_BASE_WIDTHS, wms))


class _SE(nn.Module):
    def __init__(self, c: int, device=None):
        super().__init__()
        self.reduce = nn.Conv2d(c, c // 16, 1, device=device)
        self.expand = nn.Conv2d(c // 16, c, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.relu(self.reduce(x.mean((2, 3), keepdim=True)))
        return x * torch.sigmoid(self.expand(s))


class MobileOneBlock(nn.Module):
    """One over-parameterised conv (stcd_tpu/encoders/mobileone.py:57-111):
    ``branches`` kxk convs, the 1x1 scale branch when k > 1, the BatchNorm
    identity when stride 1 keeps the width, summed; then squeeze-excite and
    relu. The convs run in the JAX order: the kxk branches, then the scale
    branch."""

    def __init__(self, in_c: int, out_c: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, groups: int = 1, branches: int = 1, use_se: bool = False,
                 device=None):
        super().__init__()
        d = dilation
        s = 1 if d > 1 else stride
        self.rbr_conv = nn.ModuleList([
            ConvNorm(in_c, out_c, kernel, stride=s, dilation=d, groups=groups, device=device)
            for _ in range(branches)])
        self.rbr_scale = (ConvNorm(in_c, out_c, 1, stride=s, groups=groups, device=device)
                          if kernel > 1 else None)
        self.rbr_skip = (BatchNorm(in_c, device=device)
                         if stride == 1 and in_c == out_c else None)
        self.se = _SE(out_c, device) if use_se else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = 0.0
        for branch in self.rbr_conv:
            out = out + branch(x)
        if self.rbr_scale is not None:
            xs = x
            if x.device.type == "cpu" and self.rbr_scale.conv.stride != (1, 1):
                # PyTorch's CPU backward of a strided 1x1 conv over a channels_last
                # input of 3 or 4 channels (the stem's, from the train step's NHWC
                # images) corrupts the heap; a contiguous copy takes another path
                xs = x.contiguous()
            out = out + self.rbr_scale(xs)
        if self.rbr_skip is not None:
            out = out + self.rbr_skip(x)
        if self.se is not None:
            out = self.se(out)
        return torch.relu(out)


class MobileOneEncoder(nn.Module):
    """smp-contract MobileOne (stcd_tpu/encoders/mobileone.py:121-158):
    [x, stage0 (/2), stage1 .. stage4]."""

    supports_dilation = True
    head_prefixes = ("linear.",)

    def __init__(self, arch: str = "mobileone_s0", depth: int = 5,
                 replace_stride_with_dilation: Sequence[bool] = (False, False, False),
                 in_channels: int = 3, device=None):
        super().__init__()
        wms, branches, use_se = _MOBILEONE_CFGS[arch]
        flags = replace_stride_with_dilation
        rates = make_dilated_rates(flags)
        self.depth = depth
        self.out_channels = mobileone_out_channels(arch)[:depth + 1]
        in_c = min(64, int(64 * wms[0]))
        if depth >= 1:
            self.stage0 = MobileOneBlock(in_channels, in_c, 3, 2, device=device)
        for i in range(4):
            if depth < 2 + i:
                break
            c = int(_BASE_WIDTHS[i] * wms[i])
            dil = rates[i - 1] if i > 0 and flags[i - 1] else 1
            blocks = []
            for b in range(_DEPTHS[i]):
                se = use_se and (i == 3 or (i == 2 and b >= _DEPTHS[i] // 2))
                blocks.append(MobileOneBlock(in_c, in_c, 3, 2 if b == 0 else 1, dil, in_c,
                                             branches, se, device))
                blocks.append(MobileOneBlock(in_c, c, 1, 1, dil, 1, branches, se, device))
                in_c = c
            setattr(self, f"stage{i + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        features = [x]
        for i in range(min(self.depth, 5)):
            x = getattr(self, f"stage{i}")(x)
            features.append(x)
        return features
