"""Serving (counterpart of stcd_tpu/serving): int8 post-training quantization
of the eval forward (``quant``) and the micro-batching inference server
(``server``). The names load on first use."""

from stcd_tpu_torch._lazy import lazy_getattr

_EXPORTS = {"calibrate_conv_scales": "quant", "n_quantized_sites": "quant",
            "quantize_fn": "quant", "BatchingEngine": "server", "serve": "server"}

__getattr__ = lazy_getattr(__name__, _EXPORTS)

__all__ = sorted(_EXPORTS)
