"""DPN encoders (counterpart of stcd_tpu/encoders/dpn.py) under
pretrainedmodels' names: ``features.conv1_1.conv`` / ``.bn`` (the input
block), ``features.conv{s}_{j}`` dual-path blocks with pre-activated
``c1x1_w_s1`` / ``c1x1_w_s2`` (the projection), ``c1x1_a``, ``c3x3_b`` and
``c1x1_c`` (each ``.bn`` then ``.conv``), or in the b variant ``c1x1_c.bn``
and the plain convs ``c1x1_c1`` / ``c1x1_c2``; ``features.conv5_bn_ac.bn``.

A block carries a residual path of fixed width and a dense path that grows
by ``inc``; a stage outputs relu(cat(residual, dense)), the last one
cat -> BatchNorm -> relu. BatchNorm eps 1e-3. A dilated stage (conv3..5;
conv2 keeps its pool stride) runs at stride 1 and dilates its 3x3 convs.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from stcd_tpu_torch.encoders.dilation import make_dilated_rates
from stcd_tpu_torch.layers.norm import BatchNorm

# name: (init, k_r, groups, k_sec, inc_sec, small, b)
_DPN_CFGS = {
    "dpn68": (10, 128, 32, (3, 4, 12, 3), (16, 32, 32, 64), True, False),
    "dpn68b": (10, 128, 32, (3, 4, 12, 3), (16, 32, 32, 64), True, True),
    "dpn92": (64, 96, 32, (3, 4, 20, 3), (16, 32, 24, 128), False, False),
    "dpn98": (96, 160, 40, (3, 6, 20, 3), (16, 32, 32, 128), False, False),
    "dpn107": (128, 200, 50, (4, 8, 20, 3), (20, 64, 64, 128), False, False),
    "dpn131": (128, 160, 40, (4, 8, 28, 3), (16, 32, 32, 128), False, False),
}


def dpn_out_channels(name: str) -> Tuple[int, ...]:
    init, k_r, groups, k_sec, inc_sec, small, b = _DPN_CFGS[name]
    bwf = 1 if small else 4
    return (3, init) + tuple(64 * 2 ** i * bwf + (2 + k_sec[i]) * inc_sec[i] for i in range(4))


def _bn(c: int, device) -> BatchNorm:
    return BatchNorm(c, eps=1e-3, device=device)


class BnActConv2d(nn.Module):
    """BatchNorm -> relu -> conv (``bn``, ``conv``)."""

    def __init__(self, in_c: int, out_c: int, kernel: int = 1, stride: int = 1,
                 dilation: int = 1, groups: int = 1, padding: int = 0, device=None):
        super().__init__()
        self.bn = _bn(in_c, device)
        self.conv = nn.Conv2d(in_c, out_c, kernel, stride=stride, padding=padding,
                              dilation=dilation, groups=groups, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.relu(self.bn(x)))


class _BnAct(nn.Module):
    """pretrainedmodels' CatBnAct: ``bn`` -> relu."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.bn = _bn(c, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(x))


class _InputBlock(nn.Module):
    def __init__(self, in_c: int, init: int, kernel: int, device=None):
        super().__init__()
        self.conv = nn.Conv2d(in_c, init, kernel, stride=2, padding=kernel // 2, bias=False,
                              device=device)
        self.bn = _bn(init, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class DualPathBlock(nn.Module):
    """stcd_tpu/encoders/dpn.py:53-103; takes and returns (residual, dense)
    (a tensor on the stage's first block)."""

    def __init__(self, in_c: int, num_1x1_a: int, num_3x3_b: int, num_1x1_c: int, inc: int,
                 groups: int, block_type: str = "normal", b: bool = False, dilation: int = 1,
                 device=None):
        super().__init__()
        d = dilation
        stride = 1 if d > 1 else (2 if block_type == "down" else 1)
        self.num_1x1_c, self.b = num_1x1_c, b
        self.proj = None
        if block_type in ("proj", "down"):
            self.proj = "c1x1_w_s2" if block_type == "down" else "c1x1_w_s1"
            setattr(self, self.proj, BnActConv2d(in_c, num_1x1_c + 2 * inc, 1, stride,
                                                 device=device))
        self.c1x1_a = BnActConv2d(in_c, num_1x1_a, device=device)
        self.c3x3_b = BnActConv2d(num_1x1_a, num_3x3_b, 3, stride, d, groups, d, device=device)
        if b:
            self.c1x1_c = _BnAct(num_3x3_b, device)
            self.c1x1_c1 = nn.Conv2d(num_3x3_b, num_1x1_c, 1, bias=False, device=device)
            self.c1x1_c2 = nn.Conv2d(num_3x3_b, inc, 1, bias=False, device=device)
        else:
            self.c1x1_c = BnActConv2d(num_3x3_b, num_1x1_c + inc, device=device)

    def forward(self, x):
        x_in = torch.cat(x, 1) if isinstance(x, tuple) else x
        if self.proj is not None:
            w = getattr(self, self.proj)(x_in)
            s1, s2 = w[:, :self.num_1x1_c], w[:, self.num_1x1_c:]
        else:
            s1, s2 = x
        h = self.c3x3_b(self.c1x1_a(x_in))
        if self.b:
            h = self.c1x1_c(h)
            out1, out2 = self.c1x1_c1(h), self.c1x1_c2(h)
        else:
            c = self.c1x1_c(h)
            out1, out2 = c[:, :self.num_1x1_c], c[:, self.num_1x1_c:]
        return s1 + out1, torch.cat([s2, out2], 1)


class DPNEncoder(nn.Module):
    """smp-contract DPN (stcd_tpu/encoders/dpn.py:106-153): [x, stem (/2),
    pool + conv2 (/4), conv3, conv4, conv5 + CatBnAct (/32)]."""

    supports_dilation = True
    head_prefixes = ("last_linear.",)

    def __init__(self, arch: str = "dpn68", depth: int = 5,
                 replace_stride_with_dilation: Sequence[bool] = (False, False, False),
                 in_channels: int = 3, device=None):
        super().__init__()
        init, k_r, groups, k_sec, inc_sec, small, b = _DPN_CFGS[arch]
        bwf = 1 if small else 4
        flags = replace_stride_with_dilation
        rates = make_dilated_rates(flags)
        self.depth = depth
        self.out_channels = dpn_out_channels(arch)[:depth + 1]
        f = nn.ModuleDict()
        if depth >= 1:
            f["conv1_1"] = _InputBlock(in_channels, init, 3 if small else 7, device)
        in_c = init
        self._stages = []
        for i in range(4):
            if depth < 2 + i:
                break
            bw = 64 * 2 ** i * bwf
            r = (k_r * bw) // (64 * bwf)
            inc = inc_sec[i]
            dil = rates[i - 1] if i > 0 and flags[i - 1] else 1
            names = []
            for j in range(k_sec[i]):
                kind = ("proj" if i == 0 else "down") if j == 0 else "normal"
                name = f"conv{i + 2}_{j + 1}"
                f[name] = DualPathBlock(in_c, r, r, bw, inc, groups, kind, b, dil, device)
                in_c = bw + (3 + j) * inc
                names.append(name)
            self._stages.append(names)
            if i == 3:
                f["conv5_bn_ac"] = _BnAct(in_c, device)
        self.features = f

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        features = [x]
        if self.depth >= 1:
            h = self.features["conv1_1"](x)
            features.append(h)
        for i, names in enumerate(self._stages):
            if i == 0:
                h = F.max_pool2d(h, 3, 2, 1)
            for name in names:
                h = self.features[name](h)
            out = torch.cat(h, 1)
            features.append(self.features["conv5_bn_ac"](out) if i == 3 else torch.relu(out))
        return features
