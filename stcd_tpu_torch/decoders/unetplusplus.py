"""UNet++ decoder (counterpart of stcd_tpu/decoders/unetplusplus.py:14-62):
nested dense skip pathways over the encoder pyramid, under smp's names
``blocks.x_{depth}_{layer}`` (each a U-Net ``DecoderBlock``).

smp builds a center block for VGG encoders but its forward never applies it,
and the JAX decoder does not build one; neither does this one.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from stcd_tpu_torch.decoders.unet import DecoderBlock


class UnetPlusPlusDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 n_blocks: int = 5, use_batchnorm: bool = True,
                 attention_type: Optional[str] = None, device=None):
        super().__init__()
        if n_blocks != len(decoder_channels):
            raise ValueError(
                "Model depth is {}, but you provide `decoder_channels` for {} blocks.".format(
                    n_blocks, len(decoder_channels)))
        enc = list(encoder_channels[1:])[::-1]
        skip_channels = enc[1:] + [0]
        out_channels = list(decoder_channels)
        self.depth = len(enc) - 1
        kw = dict(use_batchnorm=use_batchnorm, attention_type=attention_type, device=device)

        def width(d: int, l: int) -> int:  # of node x_{d}_{l}
            return out_channels[l] if d == 0 else skip_channels[l]

        blocks = {}
        for layer_idx in range(self.depth):
            for depth_idx in range(self.depth - layer_idx):
                l = depth_idx + layer_idx
                if layer_idx == 0:  # x: the encoder level, skip: the next one
                    in_ch = enc[0] if depth_idx == 0 else skip_channels[depth_idx - 1]
                    skip_ch = skip_channels[depth_idx]
                else:  # x: x_{d}_{l-1}, skip: x_{d+1..l}_{l} and the encoder level l+1
                    in_ch = width(depth_idx, l - 1)
                    skip_ch = (layer_idx + 1) * skip_channels[l]
                blocks[f"x_{depth_idx}_{l}"] = DecoderBlock(in_ch, skip_ch,
                                                           width(depth_idx, l), **kw)
        blocks[f"x_0_{self.depth}"] = DecoderBlock(out_channels[self.depth - 1], None,
                                                  out_channels[-1], **kw)
        self.blocks = nn.ModuleDict(blocks)

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        feats = features[1:][::-1]
        dense = {}
        for layer_idx in range(self.depth):
            for depth_idx in range(self.depth - layer_idx):
                if layer_idx == 0:
                    dense[f"x_{depth_idx}_{depth_idx}"] = self.blocks[
                        f"x_{depth_idx}_{depth_idx}"](feats[depth_idx], feats[depth_idx + 1])
                else:
                    dense_l_i = depth_idx + layer_idx
                    cat = torch.cat([dense[f"x_{idx}_{dense_l_i}"]
                                     for idx in range(depth_idx + 1, dense_l_i + 1)]
                                    + [feats[dense_l_i + 1]], dim=1)
                    dense[f"x_{depth_idx}_{dense_l_i}"] = self.blocks[
                        f"x_{depth_idx}_{dense_l_i}"](dense[f"x_{depth_idx}_{dense_l_i - 1}"],
                                                      cat)
        return self.blocks[f"x_0_{self.depth}"](dense[f"x_0_{self.depth - 1}"])
