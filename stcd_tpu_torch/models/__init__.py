"""Models (counterpart of stcd_tpu/models). ``create_model``,
``register_arch`` and ``define_G`` (``models/factory.py``), the smp model
classes, CDNet and the FC-Siam constructors are importable from here; they
load on first use, so importing a submodule (``models.changeformer``, which
the encoder registry imports) does not import the registry back."""

from stcd_tpu_torch._lazy import lazy_getattr

_EXPORTS = {
    "create_model": "factory", "register_arch": "factory", "define_G": "factory",
    "Unet": "segcd", "UnetSeg": "segcd", "SegCD": "segcd", "FFCTLCD": "segcd",
    "CDNet": "segcd",
    "SiamUnet": "siam_unet", "UnetEF": "siam_unet", "SiamUnetDiff": "siam_unet",
    "SiamUnetConc": "siam_unet", "SiamUnetSub": "siam_unet", "SiamUnetCrossConc": "siam_unet",
    "UnetPlusPlus": "smp_models", "MAnet": "smp_models", "Linknet": "smp_models",
    "FPN": "smp_models", "PSPNet": "smp_models", "DeepLabV3": "smp_models",
    "DeepLabV3Plus": "smp_models", "PAN": "smp_models",
}

__getattr__ = lazy_getattr(__name__, _EXPORTS)

__all__ = sorted(_EXPORTS)
