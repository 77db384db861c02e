"""Models (counterpart of stcd_tpu/models). ``create_model``,
``register_arch`` and ``define_G`` (``models/factory.py``) and the smp model
classes are importable from here; they load on first use, so importing a
submodule (``models.changeformer``, which the encoder registry imports) does
not import the registry back."""

_EXPORTS = {
    "create_model": "factory", "register_arch": "factory", "define_G": "factory",
    "Unet": "segcd", "UnetSeg": "segcd", "SegCD": "segcd", "FFCTLCD": "segcd",
    "UnetPlusPlus": "smp_models", "MAnet": "smp_models", "Linknet": "smp_models",
    "FPN": "smp_models", "PSPNet": "smp_models", "DeepLabV3": "smp_models",
    "DeepLabV3Plus": "smp_models", "PAN": "smp_models",
}


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)


__all__ = sorted(_EXPORTS)
