"""U-Net decoder (counterpart of stcd_tpu/decoders/unet.py). NCHW; the
state_dict names are smp's: ``blocks.{i}.conv{1,2}.{0,1}`` with one
(Cout, Cx + Cs, 3, 3) weight per first conv, ``blocks.{i}.attention{1,2}``
for the scse gates and ``center.{0,1}`` for the VGG center block.

DecoderBlock: nearest 2x upsample -> concat skip -> (attention1) ->
ConvBNReLU x2 -> (attention2). The JAX decoder computes the first conv in a
split form (a dilated conv over x plus a conv over the skip) when it has no
gates, because XLA cannot fuse the upsample and the concat into a conv's
input; that form is an exact rewrite of this one. Here the materialised form
is what runs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from stcd_tpu_torch.layers.modules import AttentionGate, ConvBNReLU, upsample_nearest


class DecoderBlock(nn.Module):
    """stcd_tpu/decoders/unet.py:114-147. ``attention1`` gates the
    concatenation of the upsampled input and the skip, ``attention2`` the
    output. ``skip_channels`` None: a block without a skip, which never applies
    attention1; the JAX block then has no parameters for it (smp builds them
    all the same). A skip of 0 channels (MiT's /2 level) is a skip."""

    def __init__(self, in_channels: int, skip_channels: Optional[int], out_channels: int,
                 use_batchnorm: bool = True, attention_type: Optional[str] = None,
                 device=None):
        super().__init__()
        cat = in_channels + (skip_channels or 0)
        self.conv1 = ConvBNReLU(cat, out_channels, 3, padding=1,
                                use_batchnorm=use_batchnorm, device=device)
        self.attention1 = AttentionGate(None if skip_channels is None else attention_type,
                                        cat, device=device)
        self.conv2 = ConvBNReLU(out_channels, out_channels, 3, padding=1,
                                use_batchnorm=use_batchnorm, device=device)
        self.attention2 = AttentionGate(attention_type, out_channels, device=device)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = upsample_nearest(x, 2)
        if skip is not None:
            x = self.attention1(torch.cat([x, skip], dim=1))
        return self.attention2(self.conv2(self.conv1(x)))


class CenterBlock(nn.Sequential):
    """Two ConvBNReLU at the deepest level's width, applied before the first
    block when the encoder is a VGG (stcd_tpu/decoders/unet.py:150-166)."""

    def __init__(self, channels: int, use_batchnorm: bool = True, device=None):
        super().__init__(
            ConvBNReLU(channels, channels, 3, padding=1, use_batchnorm=use_batchnorm,
                       device=device),
            ConvBNReLU(channels, channels, 3, padding=1, use_batchnorm=use_batchnorm,
                       device=device))


class UnetDecoder(nn.Module):
    """stcd_tpu/decoders/unet.py:168-212. ``forward(features)``: f0 (input
    resolution) is dropped and the rest reversed; the deepest feature is the
    head, it passes the center block if there is one, and ``n_blocks``
    DecoderBlocks consume the skips, the last one(s) without a skip."""

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 n_blocks: int = 5, use_batchnorm: bool = True,
                 attention_type: Optional[str] = None, center: bool = False, device=None):
        super().__init__()
        if n_blocks != len(decoder_channels):
            raise ValueError(
                "Model depth is {}, but you provide `decoder_channels` for {} blocks.".format(
                    n_blocks, len(decoder_channels)))
        enc = list(encoder_channels[1:])[::-1]
        in_channels = [enc[0]] + list(decoder_channels[:-1])
        skip_channels = enc[1:] + [None]
        self.center = (CenterBlock(enc[0], use_batchnorm=use_batchnorm, device=device)
                       if center else nn.Identity())
        self.blocks = nn.ModuleList(
            DecoderBlock(i, s, o, use_batchnorm=use_batchnorm, attention_type=attention_type,
                         device=device)
            for i, s, o in zip(in_channels, skip_channels, decoder_channels))

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        feats = features[1:][::-1]
        x, skips = self.center(feats[0]), feats[1:]
        for i, block in enumerate(self.blocks):
            x = block(x, skips[i] if i < len(skips) else None)
        return x
