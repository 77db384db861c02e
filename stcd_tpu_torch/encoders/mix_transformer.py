"""MixVisionTransformer (SegFormer) encoders mit_b0 to mit_b5 with the smp
stage contract (counterpart of stcd_tpu/encoders/mix_transformer.py; smp's
encoders/mix_transformer.py).

The encoder is ``models.changeformer.SegFormerEncoder`` with smp's names
(``patch_embed1.proj``, ``block1.0.attn.q``, ``norm1``, ...). ``forward(x)``
returns [x, a zero-channel map at /2, then the four stages at /4 .. /32], cut
to ``depth + 1`` levels: smp's MixVisionTransformerEncoder reports 0 channels at
the /2 level too."""

from __future__ import annotations

from typing import List

import torch

from stcd_tpu_torch.models.changeformer import SegFormerEncoder

MIT_CFGS = {
    "mit_b0": dict(embed_dims=(32, 64, 160, 256), depths=(2, 2, 2, 2)),
    "mit_b1": dict(embed_dims=(64, 128, 320, 512), depths=(2, 2, 2, 2)),
    "mit_b2": dict(embed_dims=(64, 128, 320, 512), depths=(3, 4, 6, 3)),
    "mit_b3": dict(embed_dims=(64, 128, 320, 512), depths=(3, 4, 18, 3)),
    "mit_b4": dict(embed_dims=(64, 128, 320, 512), depths=(3, 8, 27, 3)),
    "mit_b5": dict(embed_dims=(64, 128, 320, 512), depths=(3, 6, 40, 3)),
}


def mit_out_channels(name: str):
    return (3, 0) + tuple(MIT_CFGS[name]["embed_dims"])


class MixTransformerEncoder(SegFormerEncoder):
    """heads (1, 2, 5, 8), SR ratios (8, 4, 2, 1), MLP ratio 4, patch 7 stride
    4 and then patch 3 stride 2, q/kv bias, DropPath 0.1, LayerNorm eps 1e-6."""

    def __init__(self, variant: str = "mit_b0", depth: int = 5, in_channels: int = 3,
                 device=None):
        cfg = MIT_CFGS[variant]
        super().__init__(in_channels, cfg["embed_dims"], cfg["depths"], (1, 2, 5, 8), (4, 4, 4, 4),
                         (8, 4, 2, 1), first_patch=7, first_stride=4, patch_size=3,
                         qkv_bias=True, drop_path_rate=0.1, device=device)
        self.depth = depth
        self.out_channels = mit_out_channels(variant)[:depth + 1]

    def forward(self, x) -> List[torch.Tensor]:
        n, _, h, w = x.shape
        dummy = x.new_zeros((n, 0, h // 2, w // 2))
        return ([x, dummy] + super().forward(x))[:self.depth + 1]
