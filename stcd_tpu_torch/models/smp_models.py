"""smp model assemblies (counterpart of stcd_tpu/models/smp_models.py:31-242):
UnetPlusPlus, MAnet, Linknet, FPN, PSPNet, DeepLabV3, DeepLabV3Plus and PAN.

Each is ``encoder`` + ``decoder`` + ``segmentation_head`` under smp's names,
with smp's head upsampling and encoder settings: FPN 4x; PSPNet an encoder of
depth 3 and 8x; DeepLabV3 output stride 8 and 8x; DeepLabV3+ output stride 16
and 4x; PAN output stride 16 and 4x; Linknet a 1x1 head. ``forward(x)``
returns the mask logits (NCHW); ``predict(x)`` is the eval forward without
autograd. ``encoder_weights`` is loaded into the encoder by
``encoders.get_encoder``; ``in_channels`` sizes the encoder's first conv.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from stcd_tpu_torch.decoders.deeplabv3 import DeepLabV3Decoder, DeepLabV3PlusDecoder
from stcd_tpu_torch.decoders.fpn import FPNDecoder
from stcd_tpu_torch.decoders.linknet import LinknetDecoder
from stcd_tpu_torch.decoders.manet import MAnetDecoder
from stcd_tpu_torch.decoders.pan import PANDecoder
from stcd_tpu_torch.decoders.pspnet import PSPDecoder
from stcd_tpu_torch.decoders.unetplusplus import UnetPlusPlusDecoder
from stcd_tpu_torch.encoders import get_encoder
from stcd_tpu_torch.layers.modules import PredictMixin, SegmentationHead


class _SmpModel(PredictMixin, nn.Module):
    """The shared encoder, a decoder made by ``make_decoder(encoder_channels)``
    and a SegmentationHead over the decoder's ``head_channels``."""

    def __init__(self, encoder_name: str, encoder_depth: int, encoder_weights: Optional[str],
                 in_channels: int, output_stride: int, make_decoder, head_channels: int,
                 classes: int, activation, head_kernel: int = 3, upsampling: int = 1,
                 device=None):
        super().__init__()
        self.encoder_name = encoder_name
        self.encoder, encoder_channels = get_encoder(
            encoder_name, in_channels=in_channels, depth=encoder_depth,
            weights=encoder_weights, output_stride=output_stride, device=device)
        self.decoder = make_decoder(encoder_channels)
        self.segmentation_head = SegmentationHead(head_channels, classes,
                                                  kernel_size=head_kernel,
                                                  activation=activation,
                                                  upsampling=upsampling, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.segmentation_head(self.decoder(self.encoder(x)))


class UnetPlusPlus(_SmpModel):
    def __init__(self, encoder_name: str = "resnet34", encoder_depth: int = 5,
                 encoder_weights: Optional[str] = None, decoder_use_batchnorm: bool = True,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 decoder_attention_type: Optional[str] = None, in_channels: int = 3,
                 classes: int = 1, activation: Union[str, None] = None, device=None):
        super().__init__(
            encoder_name, encoder_depth, encoder_weights, in_channels, 32,
            lambda ch: UnetPlusPlusDecoder(ch, tuple(decoder_channels), encoder_depth,
                                           decoder_use_batchnorm, decoder_attention_type,
                                           device=device),
            decoder_channels[-1], classes, activation, device=device)


class MAnet(_SmpModel):
    def __init__(self, encoder_name: str = "resnet34", encoder_depth: int = 5,
                 encoder_weights: Optional[str] = None, decoder_use_batchnorm: bool = True,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 decoder_pab_channels: int = 64, in_channels: int = 3, classes: int = 1,
                 activation: Union[str, None] = None, device=None):
        super().__init__(
            encoder_name, encoder_depth, encoder_weights, in_channels, 32,
            lambda ch: MAnetDecoder(ch, tuple(decoder_channels), encoder_depth,
                                    use_batchnorm=decoder_use_batchnorm,
                                    pab_channels=decoder_pab_channels, device=device),
            decoder_channels[-1], classes, activation, device=device)


class Linknet(_SmpModel):
    def __init__(self, encoder_name: str = "resnet34", encoder_depth: int = 5,
                 encoder_weights: Optional[str] = None, decoder_use_batchnorm: bool = True,
                 in_channels: int = 3, classes: int = 1,
                 activation: Union[str, None] = None, device=None):
        super().__init__(
            encoder_name, encoder_depth, encoder_weights, in_channels, 32,
            lambda ch: LinknetDecoder(ch, 32, encoder_depth, decoder_use_batchnorm,
                                      device=device),
            32, classes, activation, head_kernel=1, device=device)


class FPN(_SmpModel):
    def __init__(self, encoder_name: str = "resnet34", encoder_depth: int = 5,
                 encoder_weights: Optional[str] = None, decoder_pyramid_channels: int = 256,
                 decoder_segmentation_channels: int = 128, decoder_merge_policy: str = "add",
                 decoder_dropout: float = 0.2, in_channels: int = 3, classes: int = 1,
                 activation: Union[str, None] = None, upsampling: int = 4, device=None):
        width = decoder_segmentation_channels * (1 if decoder_merge_policy == "add" else 4)
        super().__init__(
            encoder_name, encoder_depth, encoder_weights, in_channels, 32,
            lambda ch: FPNDecoder(ch, decoder_pyramid_channels, decoder_segmentation_channels,
                                  decoder_dropout, decoder_merge_policy, device=device),
            width, classes, activation, upsampling=upsampling, device=device)


class PSPNet(_SmpModel):
    def __init__(self, encoder_name: str = "resnet34", encoder_depth: int = 3,
                 encoder_weights: Optional[str] = None, psp_out_channels: int = 512,
                 psp_use_batchnorm: bool = True, psp_dropout: float = 0.2,
                 in_channels: int = 3, classes: int = 1,
                 activation: Union[str, None] = None, upsampling: int = 8, device=None):
        super().__init__(
            encoder_name, encoder_depth, encoder_weights, in_channels, 32,
            lambda ch: PSPDecoder(ch, psp_use_batchnorm, psp_out_channels, psp_dropout,
                                  device=device),
            psp_out_channels, classes, activation, upsampling=upsampling, device=device)


class DeepLabV3(_SmpModel):
    def __init__(self, encoder_name: str = "resnet34", encoder_depth: int = 5,
                 encoder_weights: Optional[str] = None, decoder_channels: int = 256,
                 in_channels: int = 3, classes: int = 1,
                 activation: Union[str, None] = None, upsampling: int = 8, device=None):
        super().__init__(
            encoder_name, encoder_depth, encoder_weights, in_channels, 8,
            lambda ch: DeepLabV3Decoder(ch, decoder_channels, device=device),
            decoder_channels, classes, activation, upsampling=upsampling, device=device)


class DeepLabV3Plus(_SmpModel):
    def __init__(self, encoder_name: str = "resnet34", encoder_depth: int = 5,
                 encoder_weights: Optional[str] = None, encoder_output_stride: int = 16,
                 decoder_channels: int = 256,
                 decoder_atrous_rates: Sequence[int] = (12, 24, 36), in_channels: int = 3,
                 classes: int = 1, activation: Union[str, None] = None, upsampling: int = 4,
                 device=None):
        super().__init__(
            encoder_name, encoder_depth, encoder_weights, in_channels, encoder_output_stride,
            lambda ch: DeepLabV3PlusDecoder(ch, decoder_channels, tuple(decoder_atrous_rates),
                                            encoder_output_stride, device=device),
            decoder_channels, classes, activation, upsampling=upsampling, device=device)


class PAN(_SmpModel):
    def __init__(self, encoder_name: str = "resnet34", encoder_weights: Optional[str] = None,
                 decoder_channels: int = 32, in_channels: int = 3, classes: int = 1,
                 activation: Union[str, None] = None, upsampling: int = 4, device=None):
        super().__init__(
            encoder_name, 5, encoder_weights, in_channels, 16,
            lambda ch: PANDecoder(ch, decoder_channels, device=device),
            decoder_channels, classes, activation, upsampling=upsampling, device=device)

