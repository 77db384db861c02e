"""The FC-EF / FC-Siam UNet family (Daudt et al., ICIP 2018) on NCHW tensors
(counterpart of stcd_tpu/models/siam_unet.py:42-186). One parametric module
covers the five ``define_G`` keys: ``Unet`` (early fusion), ``SiamUnet_abs``
(|f1 - f2| skips), ``SiamUnet_sub`` (f2 - f1), ``SiamUnet_conc`` (cat(f1, f2))
and ``SiamUnet_cross_conc`` (channel interleave + grouped-conv fusion).

The state_dict names and module types are the original reference's:
``conv11``/``bn11``/``do11`` .. ``conv43`` in the encoder, ``upconv4`` ..
``upconv1`` as ``ConvTranspose2d(k=3, s=2, p=1, output_padding=1)``, the
decoder's ``conv43d`` .. ``conv11d`` as stride-1 ``ConvTranspose2d(k=3, p=1)``
(the JAX package runs those as convs with the flipped, IO-swapped kernel) and
``cross_conc{1..4}.diff`` / ``.conv_res``. As in the JAX model the Siamese
encoder runs once on the 2N-batched pair (so in train mode its BatchNorm
statistics cover both images), and the decoder starts from the second image's
bottom, as the reference does.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from stcd_tpu_torch.layers.modules import Dropout2d, max_pool, pad_replicate_to
from stcd_tpu_torch.layers.norm import BatchNorm

_STAGE_WIDTHS = (16, 32, 64, 128)
_STAGE_CONVS = (2, 2, 3, 3)
_DEC_CONVS = {3: (128, 128, 64), 2: (64, 64, 32), 1: (32, 16)}  # deepest first
FUSIONS = ("ef", "diff", "sub", "conc", "crossconc")


class CrossConcFuse(nn.Module):
    """cross_conc fusion (stcd_tpu/models/siam_unet.py:84-107): interleave the
    channels as [a0, b0, a1, b1, ...], grouped 3x3 conv (groups = C) + BN +
    ReLU (``diff``), then 3x3 conv + BN (``conv_res``), then ReLU."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        c = channels
        self.diff = nn.Sequential(nn.Conv2d(2 * c, c, 3, padding=1, groups=c, device=device),
                                  BatchNorm(c, device=device), nn.ReLU())
        self.conv_res = nn.Sequential(nn.Conv2d(c, c, 3, padding=1, device=device),
                                      BatchNorm(c, device=device))

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        n, c, h, w = a.shape
        x = torch.stack([a, b], dim=2).reshape(n, 2 * c, h, w)
        return torch.relu(self.conv_res(self.diff(x)))


class SiamUnet(nn.Module):
    """``forward(x1, x2) -> (N, label_nbr, H, W)`` logits; ``fusion`` is one
    of ``FUSIONS``."""

    def __init__(self, fusion: str = "diff", label_nbr: int = 2, device=None):
        super().__init__()
        if fusion not in FUSIONS:
            raise ValueError(f"unknown fusion {fusion!r}; one of {FUSIONS}")
        self.fusion = fusion
        cin = 6 if fusion == "ef" else 3
        for s, (w, n) in enumerate(zip(_STAGE_WIDTHS, _STAGE_CONVS)):
            for i in range(n):
                self._cbdr(f"{s + 1}{i + 1}", cin, w, transposed=False, device=device)
                cin = w
        skip_mult = 2 if fusion == "conc" else 1
        for stage in (3, 2, 1):
            up_w = _STAGE_WIDTHS[stage]
            setattr(self, f"upconv{stage + 1}", nn.ConvTranspose2d(
                up_w, up_w, 3, stride=2, padding=1, output_padding=1, device=device))
            cin = up_w + skip_mult * _STAGE_WIDTHS[stage]
            widths = _DEC_CONVS[stage]
            for i, w in enumerate(widths):
                self._cbdr(f"{stage + 1}{len(widths) - i}d", cin, w, transposed=True,
                           device=device)
                cin = w
        self.upconv1 = nn.ConvTranspose2d(16, 16, 3, stride=2, padding=1, output_padding=1,
                                          device=device)
        self._cbdr("12d", 16 + skip_mult * 16, 16, transposed=True, device=device)
        self.conv11d = nn.ConvTranspose2d(16, label_nbr, 3, padding=1, device=device)
        if fusion == "crossconc":
            for s, w in enumerate(_STAGE_WIDTHS):
                setattr(self, f"cross_conc{s + 1}", CrossConcFuse(w, device=device))

    def _cbdr(self, tag: str, cin: int, cout: int, transposed: bool, device) -> None:
        """``conv{tag}``, ``bn{tag}``, ``do{tag}``: the family's unit block."""
        conv = (nn.ConvTranspose2d(cin, cout, 3, padding=1, device=device) if transposed
                else nn.Conv2d(cin, cout, 3, padding=1, device=device))
        setattr(self, f"conv{tag}", conv)
        setattr(self, f"bn{tag}", BatchNorm(cout, device=device))
        setattr(self, f"do{tag}", Dropout2d(0.2))

    def _block(self, tag: str, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, f"bn{tag}")(getattr(self, f"conv{tag}")(x))
        return getattr(self, f"do{tag}")(torch.relu(x))

    def _encode(self, x: torch.Tensor):
        skips: List[torch.Tensor] = []
        for s, n in enumerate(_STAGE_CONVS):
            for i in range(n):
                x = self._block(f"{s + 1}{i + 1}", x)
            skips.append(x)
            x = max_pool(x, 2, 2)
        return skips, x

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        if self.fusion == "ef":
            fused, x = self._encode(torch.cat([x1, x2], dim=1))
        else:
            n = x1.shape[0]
            skips, bottom = self._encode(torch.cat([x1, x2], dim=0))
            pairs = [(s[:n], s[n:]) for s in skips]
            x = bottom[n:]  # the reference decodes from the second image's bottom
            if self.fusion == "diff":
                fused = [torch.abs(a - b) for a, b in pairs]
            elif self.fusion == "sub":
                fused = [b - a for a, b in pairs]
            elif self.fusion == "conc":
                fused = [torch.cat([a, b], dim=1) for a, b in pairs]
            else:
                fused = [getattr(self, f"cross_conc{s + 1}")(a, b)
                         for s, (a, b) in enumerate(pairs)]
        for stage in (3, 2, 1):
            x = getattr(self, f"upconv{stage + 1}")(x)
            skip = fused[stage]
            x = torch.cat([pad_replicate_to(x, skip.shape[2:]), skip], dim=1)
            widths = _DEC_CONVS[stage]
            for i in range(len(widths)):
                x = self._block(f"{stage + 1}{len(widths) - i}d", x)
        x = self.upconv1(x)
        x = torch.cat([pad_replicate_to(x, fused[0].shape[2:]), fused[0]], dim=1)
        return self.conv11d(self._block("12d", x))


def UnetEF(label_nbr: int = 2, device=None) -> SiamUnet:
    """FC-EF: the two images concatenated at the input."""
    return SiamUnet("ef", label_nbr=label_nbr, device=device)


def SiamUnetDiff(label_nbr: int = 2, device=None) -> SiamUnet:
    return SiamUnet("diff", label_nbr=label_nbr, device=device)


def SiamUnetConc(label_nbr: int = 2, device=None) -> SiamUnet:
    return SiamUnet("conc", label_nbr=label_nbr, device=device)


def SiamUnetSub(label_nbr: int = 2, device=None) -> SiamUnet:
    return SiamUnet("sub", label_nbr=label_nbr, device=device)


def SiamUnetCrossConc(label_nbr: int = 2, device=None) -> SiamUnet:
    return SiamUnet("crossconc", label_nbr=label_nbr, device=device)
