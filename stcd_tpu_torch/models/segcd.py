"""The STCD model family (counterpart of stcd_tpu/models/segcd.py). NCHW
in and out; state_dict names are smp's (``encoder.``, ``decoder.``,
``segmentation_head.0``).

- UnetSeg / Unet: encoder -> UnetDecoder -> SegmentationHead.
- SegCD: the shared encoder and decoder on A and B;
  change = min(head(|dec(A) - dec(B)|), |head(dec(A)) - head(dec(B))|).
- FFCTLCD: the abs-diff taken at every encoder level, then decoded.
- CDNet: the per-level abs-diff fusion head over two lists of decoder features.

``siamese_batched`` (default True) folds A and B into one 2N-image pass, as
the JAX models do. The weights are shared either way; in train mode the
BatchNorm statistics then cover both temporal images jointly. Eval mode is
the same in both forms.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
from torch import nn

from stcd_tpu_torch.decoders.unet import UnetDecoder
from stcd_tpu_torch.encoders import get_encoder
from stcd_tpu_torch.layers.modules import (ClassificationHead, PredictMixin, SegmentationHead,
                                           resize_bilinear)
from stcd_tpu_torch.layers.se import ChannelSpatialSELayer


class _EncDecHead(PredictMixin, nn.Module):
    """Shared encoder + UnetDecoder + SegmentationHead assembly
    (stcd_tpu/models/segcd.py:44-108). ``decoder_attention_type="scse"``
    gates every decoder block; a VGG encoder gets the center block;
    ``aux_params`` (``classes``, ``pooling``, ``dropout``, ``activation``)
    adds smp's classification head over the deepest feature, which ``Unet``
    returns beside the mask. ``encoder_weights`` is loaded into the encoder
    (``encoders.get_encoder``)."""

    def __init__(self, encoder_name: str = "resnet34", encoder_depth: int = 5,
                 encoder_weights: Optional[str] = None,
                 decoder_use_batchnorm: bool = True,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 decoder_attention_type: Optional[str] = None,
                 in_channels: int = 3, classes: int = 1,
                 activation: Union[str, None] = None, aux_params: Optional[dict] = None,
                 siamese_batched: bool = True, device=None):
        super().__init__()
        self.encoder_name = encoder_name
        self.encoder_depth = encoder_depth
        self.siamese_batched = siamese_batched
        self.encoder, encoder_channels = get_encoder(
            encoder_name, in_channels=in_channels, depth=encoder_depth,
            weights=encoder_weights, device=device)
        self.decoder = UnetDecoder(encoder_channels, tuple(decoder_channels),
                                   n_blocks=encoder_depth,
                                   use_batchnorm=decoder_use_batchnorm,
                                   attention_type=decoder_attention_type,
                                   center=encoder_name.startswith("vgg"), device=device)
        self.segmentation_head = SegmentationHead(decoder_channels[-1], classes,
                                                  kernel_size=3, activation=activation,
                                                  device=device)
        self.classification_head = None
        if aux_params is not None:
            self.classification_head = ClassificationHead(encoder_channels[-1], device=device,
                                                          **aux_params)

    def check_input_shape(self, x: torch.Tensor) -> None:
        """Reject spatial sizes the pyramid cannot round-trip."""
        h, w = x.shape[-2:]
        stride = 2 ** self.encoder_depth
        if h % stride != 0 or w % stride != 0:
            new_h = (h // stride + 1) * stride if h % stride != 0 else h
            new_w = (w // stride + 1) * stride if w % stride != 0 else w
            raise RuntimeError(
                f"Wrong input shape height={h}, width={w}. Expected image "
                f"height and width divisible by {stride}. Consider padding "
                f"your images to shape ({new_h}, {new_w}).")

    def encode(self, x):
        self.check_input_shape(x)
        return self.encoder(x)

    def decode(self, features):
        return self.decoder(features)

    def head(self, x):
        return self.segmentation_head(x)


class UnetSeg(_EncDecHead):
    """Plain encoder-decoder-head; ``forward(x) -> mask``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.decode(self.encode(x)))


class Unet(_EncDecHead):
    """smp's Unet: ``forward(x) -> mask``, or ``(mask, labels)`` with
    ``aux_params``."""

    def forward(self, x: torch.Tensor):
        feats = self.encode(x)
        mask = self.head(self.decode(feats))
        if self.classification_head is not None:
            return mask, self.classification_head(feats[-1])
        return mask


class SegCD(_EncDecHead):
    """``forward(A, B) -> (mask_t1, mask_t2, change)``."""

    def forward(self, a: torch.Tensor, b: torch.Tensor):
        if self.siamese_batched:
            n = a.shape[0]
            d = self.decode(self.encode(torch.cat([a, b], dim=0)))
            x1_decode, x2_decode = d[:n], d[n:]
            m = self.head(d)
            mask_t1, mask_t2 = m[:n], m[n:]
        else:
            x1_decode = self.decode(self.encode(a))
            x2_decode = self.decode(self.encode(b))
            mask_t1 = self.head(x1_decode)
            mask_t2 = self.head(x2_decode)
        diffea = self.head(torch.abs(x1_decode - x2_decode))
        diffseg = torch.abs(mask_t1 - mask_t2)
        return mask_t1, mask_t2, torch.minimum(diffea, diffseg)


class FFCTLCD(_EncDecHead):
    """``forward(A, B) -> (mask_t1, mask_t2, change)`` with the feature-level
    difference taken at every encoder level."""

    def forward(self, a: torch.Tensor, b: torch.Tensor):
        if self.siamese_batched:
            n = a.shape[0]
            feats = self.encode(torch.cat([a, b], dim=0))
            features1 = [f[:n] for f in feats]
            features2 = [f[n:] for f in feats]
        else:
            features1 = self.encode(a)
            features2 = self.encode(b)
        featurediff = [torch.abs(f1 - f2) for f1, f2 in zip(features1, features2)]
        diffea = self.head(self.decode(featurediff))
        mask_t1 = self.head(self.decode(features1))
        mask_t2 = self.head(self.decode(features2))
        diffseg = torch.abs(mask_t1 - mask_t2)
        return mask_t1, mask_t2, torch.minimum(diffea, diffseg)


class _AttBlock(nn.Module):
    """``block`` = conv3x3, ReLU, ChannelSpatialSELayer (the reference's names)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.block = nn.Sequential(nn.Conv2d(channels, channels, 3, padding=1, device=device),
                                   nn.ReLU(),
                                   ChannelSpatialSELayer(channels, 2, device=device))

    def forward(self, x):
        return self.block(x)


class CDNet(nn.Module):
    """The per-level abs-diff fusion head (stcd_tpu/models/segcd.py:185-218):
    ``forward(x1, x2)`` over two 5-level lists of decoder features, coarse to
    fine; each |x1 - x2| is resized bilinearly to the finest level, the five
    are concatenated, then conv + ReLU + scSE (``AttBlock``), ``cd1``, ReLU,
    ``cd2``. The reference's ``Deconv*`` blocks reduce to the abs-diff and hold
    no live weights, so they are not built."""

    def __init__(self, decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 classes: int = 1, device=None):
        super().__init__()
        c = sum(decoder_channels)
        self.AttBlock = _AttBlock(c, device=device)
        self.cd1 = nn.Conv2d(c, 64, 3, padding=1, device=device)
        self.cd2 = nn.Conv2d(64, classes, 3, padding=1, device=device)

    def forward(self, x1: List[torch.Tensor], x2: List[torch.Tensor]) -> torch.Tensor:
        size = tuple(x1[4].shape[2:])
        diffs = [torch.abs(a - b) for a, b in zip(x1[:5], x2[:5])]
        diffs = [resize_bilinear(d, size) for d in diffs[:4]] + diffs[4:]
        h = self.AttBlock(torch.cat(diffs, dim=1))
        return self.cd2(torch.relu(self.cd1(h)))


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights for these models and every model of
    ``create_model``: every conv, transposed-conv and linear weight normal(0,
    sqrt(1 / fan_in)) (the JAX models' lecun_normal scale, untruncated; the
    fan counts the receptive field and a group's input channels), biases 0,
    BatchNorm weight 1 and bias 0. Drawn on the CPU from one
    ``torch.Generator`` and copied to each parameter's device, so a seed gives
    the same weights on every device."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = mod.weight  # a transposed conv's is (in, out / groups, kh, kw)
                fan_in = (w.shape[0] * w[0, 0].numel() if isinstance(mod, nn.ConvTranspose2d)
                          else w[0].numel())
                mod.weight.copy_(torch.randn(w.shape, generator=gen) * fan_in ** -0.5)
                if mod.bias is not None:
                    mod.bias.zero_()
    return model
