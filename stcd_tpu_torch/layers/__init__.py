"""Layers shared by the models (counterpart of stcd_tpu/layers). The names
of ``layers.modules`` and ``layers.se`` load on first use."""

from stcd_tpu_torch._lazy import lazy_getattr

_EXPORTS = {name: "modules" for name in (
    "Activation", "AttentionGate", "ConvBNReLU", "SCSEModule", "ClassificationHead",
    "SegmentationHead", "ConvTranspose2x", "max_pool", "upsample_nearest", "upsample_bilinear",
    "resize_bilinear", "pad_replicate_to")}
_EXPORTS.update({name: "se" for name in (
    "ChannelSELayer", "SpatialSELayer", "ChannelSpatialSELayer")})

__getattr__ = lazy_getattr(__name__, _EXPORTS)

__all__ = sorted(_EXPORTS)
