"""GERNet encoders (counterpart of stcd_tpu/encoders/gernet.py) under timm's
ByobNet names: ``stem.conv`` / ``.bn``, ``stages.{s}.{b}`` with
``conv1_kxk`` / ``conv2_kxk`` (basic) or ``conv1_1x1`` / ``conv2_kxk`` /
``conv3_1x1`` (bottle), each ``.conv`` and ``.bn``, ``shortcut.conv`` /
``.bn``, and ``final_conv.conv`` / ``.bn``.

Per stage (type, depth, channels, stride, group size, bottle ratio) from
timm's table; a bottle block's middle width is ``c * bottle_ratio`` and a
group size of 1 makes its 3x3 depthwise. Table stages 0..2 are smp stages
2..4; stages 3 and 4 and the final conv are smp stage 5. A dilated stage
runs at stride 1 and dilates its 3x3 convs.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from stcd_tpu_torch.encoders.dilation import make_dilated_rates
from stcd_tpu_torch.layers.modules import ConvNorm

# (type, depth, channels, stride, group_size, bottle_ratio)
_GERNET_CFGS = {
    "gernet_s": {
        "stem": 13, "features": 1920,
        "blocks": [("basic", 1, 48, 2, 0, 1.0), ("basic", 3, 48, 2, 0, 1.0),
                   ("bottle", 7, 384, 2, 0, 0.25), ("bottle", 2, 560, 2, 1, 3.0),
                   ("bottle", 1, 256, 1, 1, 3.0)],
    },
    "gernet_m": {
        "stem": 32, "features": 2560,
        "blocks": [("basic", 1, 128, 2, 0, 1.0), ("basic", 2, 192, 2, 0, 1.0),
                   ("bottle", 6, 640, 2, 0, 0.25), ("bottle", 4, 640, 2, 1, 3.0),
                   ("bottle", 1, 640, 1, 1, 3.0)],
    },
    "gernet_l": {
        "stem": 32, "features": 2560,
        "blocks": [("basic", 1, 128, 2, 0, 1.0), ("basic", 2, 192, 2, 0, 1.0),
                   ("bottle", 6, 640, 2, 0, 0.25), ("bottle", 5, 640, 2, 1, 3.0),
                   ("bottle", 4, 640, 1, 1, 3.0)],
    },
}


def gernet_out_channels(name: str) -> Tuple[int, ...]:
    cfg = _GERNET_CFGS[name]
    bl = cfg["blocks"]
    return (3, cfg["stem"], bl[0][2], bl[1][2], bl[2][2], cfg["features"])


class GERBlock(nn.Module):
    """stcd_tpu/encoders/gernet.py:58-101; the convs in its order (the
    branch, then the shortcut)."""

    def __init__(self, kind: str, in_c: int, c: int, stride: int = 1, dilation: int = 1,
                 group_size: int = 0, bottle_ratio: float = 1.0, device=None):
        super().__init__()
        d = dilation
        s = 1 if d > 1 else stride
        self.kind = kind
        if kind == "basic":
            self.conv1_kxk = ConvNorm(in_c, c, 3, stride=s, dilation=d, device=device)
            self.conv2_kxk = ConvNorm(c, c, 3, dilation=d, device=device)
        else:
            mid = int(round(c * bottle_ratio))
            self.conv1_1x1 = ConvNorm(in_c, mid, 1, device=device)
            self.conv2_kxk = ConvNorm(mid, mid, 3, stride=s, dilation=d,
                                      groups=mid // group_size if group_size else 1,
                                      device=device)
            self.conv3_1x1 = ConvNorm(mid, c, 1, device=device)
        self.shortcut = (ConvNorm(in_c, c, 1, stride=s, device=device)
                         if stride != 1 or in_c != c else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "basic":
            h = self.conv2_kxk(torch.relu(self.conv1_kxk(x)))
        else:
            h = torch.relu(self.conv1_1x1(x))
            h = self.conv3_1x1(torch.relu(self.conv2_kxk(h)))
        identity = x if self.shortcut is None else self.shortcut(x)
        return torch.relu(h + identity)


class GERNetEncoder(nn.Module):
    """smp-contract GERNet (stcd_tpu/encoders/gernet.py:104-152)."""

    supports_dilation = True
    head_prefixes = ("head.",)

    def __init__(self, arch: str = "gernet_s", depth: int = 5,
                 replace_stride_with_dilation: Sequence[bool] = (False, False, False),
                 in_channels: int = 3, device=None):
        super().__init__()
        cfg = _GERNET_CFGS[arch]
        flags = replace_stride_with_dilation
        rates = make_dilated_rates(flags)
        self.depth = depth
        self.out_channels = gernet_out_channels(arch)[:depth + 1]
        if depth >= 1:
            self.stem = ConvNorm(in_channels, cfg["stem"], 3, stride=2, device=device)
        in_c, stages = cfg["stem"], []
        for si, (kind, n, c, s, gs, br) in enumerate(cfg["blocks"]):
            smp_stage = min(si + 2, 5)
            if depth < smp_stage:
                break
            dil = rates[smp_stage - 3] if smp_stage >= 3 and flags[smp_stage - 3] else 1
            blocks = []
            for b in range(n):
                blocks.append(GERBlock(kind, in_c, c, s if b == 0 else 1, dil, gs, br, device))
                in_c = c
            stages.append(nn.Sequential(*blocks))
        self.stages = nn.ModuleList(stages)
        if depth >= 5:
            self.final_conv = ConvNorm(in_c, cfg["features"], 1, device=device)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        features = [x]
        if self.depth >= 1:
            x = torch.relu(self.stem(x))
            features.append(x)
        for si, stage in enumerate(self.stages):
            x = stage(x)
            if si <= 2:  # table stages 3 and 4 end in the final conv's level
                features.append(x)
        if self.depth >= 5:
            features.append(torch.relu(self.final_conv(x)))
        return features
