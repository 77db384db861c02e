"""EfficientNet encoders (counterpart of stcd_tpu/encoders/efficientnet.py).

One MBConv body, two naming sets, as the reference has two modules:

- ``EfficientNetEncoder``: efficientnet_pytorch's names (``_conv_stem``,
  ``_bn0``, ``_blocks.{i}._expand_conv`` ...), the ``efficientnet-b0..b7``
  encoders. Stages end at the flat block indices of ``_REF_STAGE_IDXS``
  (b0's stage 4 ends one block into the 112-channel group).
- ``TimmEfficientNetEncoder``: timm's names (``conv_stem``, ``bn1``,
  ``blocks.{g}.{i}.conv_pw`` ...), the ``timm-efficientnet-*`` and
  ``timm-tf_efficientnet_lite*`` encoders. Stages end at whole block groups
  (``_STAGE_END_GROUP``); lite variants fix the stem at 32 and the first and
  last groups' repeats, and use relu6 without squeeze-excite.

MBConv: expand 1x1 -> depthwise kxk -> squeeze-excite (to a quarter of the
block's input width) -> project 1x1, swish, with drop_connect on the
residual in training (``layers.stochastic.DropPath``, rate
``0.2 * block / blocks``, drawn from the step's generator). Convolutions pad
as TF's SAME, as the JAX encoder does for both naming sets: at stride 2 on an
even input that is (0, 1), so the input is padded explicitly by ``F.pad``
and the conv has padding 0; a dilated stage runs at stride 1 and pads
(k // 2) * d a side. BatchNorm: flax momentum 0.99, eps 1e-3.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from stcd_tpu_torch.encoders.dilation import make_dilated_rates
from stcd_tpu_torch.layers.norm import BatchNorm
from stcd_tpu_torch.layers.stochastic import DropPath

# base (kernel, repeats, stride, expand, in_c, out_c, se_ratio)
_BASE_BLOCKS = [
    (3, 1, 1, 1, 32, 16, 0.25),
    (3, 2, 2, 6, 16, 24, 0.25),
    (5, 2, 2, 6, 24, 40, 0.25),
    (3, 3, 2, 6, 40, 80, 0.25),
    (5, 3, 1, 6, 80, 112, 0.25),
    (5, 4, 2, 6, 112, 192, 0.25),
    (3, 1, 1, 6, 192, 320, 0.25),
]

# name: (width_coefficient, depth_coefficient, drop_connect_rate); the encoder
# uses its own drop_connect_rate (0.2), as the JAX one does
_EFFNET_CFGS = {
    "b0": (1.0, 1.0, 0.2), "b1": (1.0, 1.1, 0.2), "b2": (1.1, 1.2, 0.3),
    "b3": (1.2, 1.4, 0.3), "b4": (1.4, 1.8, 0.4), "b5": (1.6, 2.2, 0.4),
    "b6": (1.8, 2.6, 0.5), "b7": (2.0, 3.1, 0.5), "b8": (2.2, 3.6, 0.5),
    "l2": (4.3, 5.3, 0.5),
    "lite0": (1.0, 1.0, 0.2), "lite1": (1.0, 1.1, 0.2),
    "lite2": (1.1, 1.2, 0.3), "lite3": (1.2, 1.4, 0.3),
    "lite4": (1.4, 1.8, 0.4),
}

# the group at which each smp stage 2..5 ends under timm's names
_STAGE_END_GROUP = (1, 2, 4, 6)

# the flat block index (exclusive) at which each smp stage 2..5 ends under
# efficientnet_pytorch's names
_REF_STAGE_IDXS = {
    "b0": (3, 5, 9, 16), "b1": (5, 8, 16, 23), "b2": (5, 8, 16, 23),
    "b3": (5, 8, 18, 26), "b4": (6, 10, 22, 32), "b5": (8, 13, 27, 39),
    "b6": (9, 15, 31, 45), "b7": (11, 18, 38, 55),
}


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new_f = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * filters:
        new_f += divisor
    return int(new_f)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def efficientnet_out_channels(variant: str, lite: bool = False) -> Tuple[int, ...]:
    width = _EFFNET_CFGS[variant][0]
    group_out = [round_filters(b[5], width) for b in _BASE_BLOCKS]
    return (3, 32 if lite else round_filters(32, width)) + tuple(
        group_out[end] for end in _STAGE_END_GROUP)


def same_pad(x: torch.Tensor, kernel: int, stride: int, dilation: int = 1) -> torch.Tensor:
    """Pad an NCHW tensor as TF's (and flax's) SAME does for a conv of this
    kernel, stride and dilation: the total split low = total // 2."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad takes the last axis first
        total = max((-(-n // stride) - 1) * stride + (kernel - 1) * dilation + 1 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _bn(c: int, device) -> BatchNorm:
    return BatchNorm(c, momentum=0.99, eps=1e-3, device=device)


class _MBConv(nn.Module):
    """The MBConv body (stcd_tpu/encoders/efficientnet.py:99-159). A subclass
    names its parts: ``names(has_expand)`` maps each role to a dotted
    attribute path. The convs run in the JAX block's order (expand, depthwise,
    squeeze, excite, project), which is the order of the int8 conv sites."""

    def names(self, has_expand: bool) -> Dict[str, str]:
        raise NotImplementedError

    def __init__(self, in_c: int, out_c: int, kernel: int, expand_ratio: int, stride: int,
                 dilation: int = 1, se_ratio: float = 0.25, drop_rate: float = 0.0,
                 lite: bool = False, device=None):
        super().__init__()
        exp_c = in_c * expand_ratio
        self.kernel, self.dilation = kernel, dilation
        self.eff_stride = 1 if dilation > 1 else stride
        self.act = F.relu6 if lite else _swish
        self.residual = stride == 1 and in_c == out_c
        self.has_expand = expand_ratio != 1
        self.has_se = se_ratio > 0 and not lite
        parts = {}
        if self.has_expand:
            parts["expand"] = nn.Conv2d(in_c, exp_c, 1, bias=False, device=device)
            parts["expand_bn"] = _bn(exp_c, device)
        parts["dw"] = nn.Conv2d(exp_c, exp_c, kernel, stride=self.eff_stride, dilation=dilation,
                                groups=exp_c, bias=False, device=device)
        parts["dw_bn"] = _bn(exp_c, device)
        if self.has_se:
            rd = max(1, int(in_c * se_ratio))
            parts["se_reduce"] = nn.Conv2d(exp_c, rd, 1, device=device)
            parts["se_expand"] = nn.Conv2d(rd, exp_c, 1, device=device)
        parts["project"] = nn.Conv2d(exp_c, out_c, 1, bias=False, device=device)
        parts["project_bn"] = _bn(out_c, device)
        self._paths = self.names(self.has_expand)
        for role, module in parts.items():
            parent = self
            *path, leaf = self._paths[role].split(".")
            for p in path:
                if not hasattr(parent, p):
                    parent.add_module(p, nn.Module())
                parent = getattr(parent, p)
            parent.add_module(leaf, module)
        self.drop_path = DropPath(drop_rate) if self.residual else None

    def _m(self, role: str) -> nn.Module:
        return self.get_submodule(self._paths[role])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.has_expand:
            h = self.act(self._m("expand_bn")(self._m("expand")(h)))
        h = same_pad(h, self.kernel, self.eff_stride, self.dilation)
        h = self.act(self._m("dw_bn")(self._m("dw")(h)))
        if self.has_se:
            s = self.act(self._m("se_reduce")(h.mean((2, 3), keepdim=True)))
            h = h * torch.sigmoid(self._m("se_expand")(s))
        h = self._m("project_bn")(self._m("project")(h))
        if self.residual:
            h = self.drop_path(h) + x
        return h


class _PytorchMBConv(_MBConv):
    """efficientnet_pytorch's MBConvBlock names."""

    def names(self, has_expand: bool) -> Dict[str, str]:
        return dict(expand="_expand_conv", expand_bn="_bn0", dw="_depthwise_conv",
                    dw_bn="_bn1", se_reduce="_se_reduce", se_expand="_se_expand",
                    project="_project_conv", project_bn="_bn2")


class _TimmMBConv(_MBConv):
    """timm's InvertedResidual names, or its DepthwiseSeparableConv names
    for a block without an expand conv."""

    def names(self, has_expand: bool) -> Dict[str, str]:
        se = dict(se_reduce="se.conv_reduce", se_expand="se.conv_expand")
        if has_expand:
            return dict(expand="conv_pw", expand_bn="bn1", dw="conv_dw", dw_bn="bn2",
                        project="conv_pwl", project_bn="bn3", **se)
        return dict(dw="conv_dw", dw_bn="bn1", project="conv_pw", project_bn="bn2", **se)


def _block_plan(variant: str, lite: bool, group_split: bool, depth: int,
                flags: Sequence[bool]):
    """The blocks that stages 2..depth run, as (kernel, out_c, expand,
    se_ratio, stride, group, dilation, taps_after) with the JAX encoder's
    stage ends (stcd_tpu/encoders/efficientnet.py:197-227); and the count of
    all blocks, which sets the drop_connect rates."""
    width, depth_c, _ = _EFFNET_CFGS[variant]
    blocks = []
    for gi, (k, r, s, e, _ic, oc, se) in enumerate(_BASE_BLOCKS):
        reps = r if lite and gi in (0, len(_BASE_BLOCKS) - 1) else round_repeats(r, depth_c)
        for i in range(reps):
            blocks.append((k, round_filters(oc, width), e, se, s if i == 0 else 1, gi))
    if group_split:
        end_of_group = {blk[5]: bi + 1 for bi, blk in enumerate(blocks)}
        stage_ends = [end_of_group[g] for g in _STAGE_END_GROUP]
    else:
        stage_ends = list(_REF_STAGE_IDXS[variant])
    rates = make_dilated_rates(flags)
    plan, stage = [], 2
    for bidx, (k, oc, e, se, s, gi) in enumerate(blocks):
        if stage > depth:
            break
        dil = rates[stage - 3] if stage >= 3 and flags[stage - 3] else 1
        tap = stage - 2 < len(stage_ends) and bidx + 1 == stage_ends[stage - 2]
        plan.append((k, oc, e, se, s, gi, dil, tap))
        stage += tap
    return plan, len(blocks)


def timm_block_groups(variant: str, lite: bool = False) -> List[Tuple[int, int]]:
    """(group, index in the group) of each flat block: timm's
    ``blocks.{group}.{i}``."""
    plan, _ = _block_plan(variant, lite, True, 5, (False, False, False))
    places, count = [], {}
    for *_, gi, _dil, _tap in plan:
        places.append((gi, count.get(gi, 0)))
        count[gi] = count.get(gi, 0) + 1
    return places


class _EfficientNetBase(nn.Module):
    """smp-contract EfficientNet: [x, stem (/2), stages 2..5]. The stem is
    built at every depth, as in JAX."""

    supports_dilation = True
    _block_cls = _MBConv
    _group_split = False

    def __init__(self, variant: str = "b0", depth: int = 5, lite: bool = False,
                 replace_stride_with_dilation: Sequence[bool] = (False, False, False),
                 in_channels: int = 3, drop_connect_rate: float = 0.2, device=None):
        super().__init__()
        width = _EFFNET_CFGS[variant][0]
        self.depth = depth
        self.out_channels = efficientnet_out_channels(variant, lite)[:depth + 1]
        self.act = F.relu6 if lite else _swish
        stem_c = 32 if lite else round_filters(32, width)
        self._stem(nn.Conv2d(in_channels, stem_c, 3, stride=2, bias=False, device=device),
                   _bn(stem_c, device))
        plan, n_blocks = _block_plan(variant, lite, self._group_split, depth,
                                     replace_stride_with_dilation)
        in_c, modules = stem_c, []
        for bidx, (k, oc, e, se, s, gi, dil, _) in enumerate(plan):
            modules.append((gi, self._block_cls(in_c, oc, k, e, s, dil, se,
                                                drop_connect_rate * bidx / n_blocks, lite,
                                                device=device)))
            in_c = oc
        self._blocks_from(modules)
        self._taps = [tap for *_, tap in plan]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        conv, bn = self._stem_parts()
        h = self.act(bn(conv(same_pad(x, 3, 2))))
        features = [x]
        if self.depth >= 1:
            features.append(h)
        for block, tap in zip(self._flat_blocks(), self._taps):
            h = block(h)
            if tap:
                features.append(h)
        return features


class EfficientNetEncoder(_EfficientNetBase):
    """efficientnet_pytorch's names: ``_conv_stem``, ``_bn0``, ``_blocks.{i}``.
    Its checkpoint's head (``_conv_head``, ``_bn1``, ``_fc``) is dropped."""

    head_prefixes = ("_conv_head.", "_bn1.", "_fc.")
    _block_cls = _PytorchMBConv

    def _stem(self, conv, bn):
        self._conv_stem, self._bn0 = conv, bn

    def _stem_parts(self):
        return self._conv_stem, self._bn0

    def _blocks_from(self, modules):
        self._blocks = nn.ModuleList([m for _, m in modules])

    def _flat_blocks(self):
        return list(self._blocks)


class TimmEfficientNetEncoder(_EfficientNetBase):
    """timm's names: ``conv_stem``, ``bn1``, ``blocks.{group}.{i}``. Its
    checkpoint's head (``conv_head``, ``bn2``, ``classifier``) is dropped."""

    head_prefixes = ("conv_head.", "bn2.", "classifier.")
    _block_cls = _TimmMBConv
    _group_split = True

    def _stem(self, conv, bn):
        self.conv_stem, self.bn1 = conv, bn

    def _stem_parts(self):
        return self.conv_stem, self.bn1

    def _blocks_from(self, modules):
        groups: List[List[nn.Module]] = []
        for gi, m in modules:
            while len(groups) <= gi:
                groups.append([])
            groups[gi].append(m)
        self.blocks = nn.ModuleList([nn.ModuleList(g) for g in groups])

    def _flat_blocks(self):
        return [b for g in self.blocks for b in g]
