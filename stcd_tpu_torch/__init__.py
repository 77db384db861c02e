"""PyTorch/CUDA port of stcd_tpu for one NVIDIA H100.

The layout mirrors ``stcd_tpu/``: a module's counterpart lives under the
same path. The package imports torch, numpy and (lazily) PIL, and never JAX
or ``stcd_tpu``. Importing it builds nothing: the CUDA kernels are compiled
at their first launch (``ops/_build.py``).

smp's top-level names are here, as in ``stcd_tpu``: the ``losses``,
``metrics``, ``datasets``, ``encoders`` and ``decoders`` namespaces,
``create_model``, ``define_G``, the model classes and ``predict``. They load
on first use.
"""

from stcd_tpu_torch._lazy import lazy_getattr

__version__ = "0.1.0"

_EXPORTS = {
    "losses": None, "metrics": None, "datasets": None, "encoders": None, "decoders": None,
    "create_model": "models", "define_G": "models", "Unet": "models", "UnetSeg": "models",
    "SegCD": "models", "FFCTLCD": "models", "CDNet": "models", "UnetPlusPlus": "models",
    "MAnet": "models", "Linknet": "models", "FPN": "models", "PSPNet": "models",
    "DeepLabV3": "models", "DeepLabV3Plus": "models", "PAN": "models",
}

__getattr__ = lazy_getattr(__name__, _EXPORTS)


def predict(model, *inputs):
    """smp's ``model.predict``: the forward in eval mode without autograd
    (``layers.modules.PredictMixin.predict``). The JAX package's
    ``predict(model, variables, *inputs)`` takes the variables apart; here the
    module holds them."""
    return model.predict(*inputs)


__all__ = sorted(_EXPORTS) + ["predict"]
