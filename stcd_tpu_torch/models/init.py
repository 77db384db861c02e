"""Weight re-initialisation by the reference's ``init_weights`` rules
(counterpart of stcd_tpu/models/init.py:19-63): every conv, transposed-conv
and linear weight drawn by ``init_type``, BatchNorm weights from N(1, gain),
every bias of those layers and of BatchNorm zero; LayerNorm weights, PReLU
slopes and free parameters such as ``pos_embed`` keep their values.

The kernel draws follow the JAX initialisers: ``normal`` N(0, gain);
``xavier`` a normal truncated at two standard deviations with variance
gain^2 / fan_avg; ``kaiming`` the same with variance 2 / fan_in (no gain);
``orthogonal`` gain times an orthogonal matrix over (fan, out) with the output
channels as columns. Fans count the receptive field, as flax's do. The draws
are made on the CPU from ``generator`` and copied to each parameter's device,
so a seed gives the same weights on every device.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from stcd_tpu_torch.layers.norm import BatchNorm

INIT_TYPES = ("normal", "xavier", "kaiming", "orthogonal")
_TRUNC_STD = 0.87962566103423978  # std of N(0, 1) truncated to [-2, 2]


def _fans(mod: nn.Module, shape) -> tuple:
    """(fan_in, fan_out) of the layer, the receptive field included."""
    if isinstance(mod, nn.Linear):
        return shape[1], shape[0]
    field = shape[2] * shape[3]
    if isinstance(mod, nn.ConvTranspose2d):  # (in, out / groups, kh, kw)
        return shape[0] * field, shape[1] * field
    return shape[1] * field, shape[0] * field  # Conv2d (out, in / groups, kh, kw)


def _truncated(shape, variance: float, gen: torch.Generator) -> torch.Tensor:
    std = variance ** 0.5 / _TRUNC_STD
    return nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=gen)


def _kernel(mod: nn.Module, init_type: str, gain: float, gen: torch.Generator) -> torch.Tensor:
    shape = tuple(mod.weight.shape)
    if init_type == "normal":
        return torch.randn(shape, generator=gen) * gain
    fan_in, fan_out = _fans(mod, shape)
    if init_type == "xavier":
        return _truncated(shape, 2.0 / (fan_in + fan_out), gen) * gain
    if init_type == "kaiming":
        return _truncated(shape, 2.0 / fan_in, gen)
    # orthogonal: the output channels as the columns of a (fan, out) matrix
    out_axis = 1 if isinstance(mod, nn.ConvTranspose2d) else 0
    w = torch.empty(shape).movedim(out_axis, 0)
    flat = nn.init.orthogonal_(torch.empty(w.shape[0], w[0].numel()), gain, generator=gen)
    return flat.reshape(w.shape).movedim(0, out_axis).contiguous()


def init_weights(model: nn.Module, init_type: str = "normal", init_gain: float = 0.02,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """Re-initialise ``model`` in place and return it."""
    if init_type not in INIT_TYPES:
        raise NotImplementedError(f"initialization method [{init_type}] is not implemented")
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                mod.weight.copy_(_kernel(mod, init_type, init_gain, gen))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.weight.copy_(1.0 + init_gain * torch.randn(mod.weight.shape,
                                                               generator=gen))
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm) and mod.bias is not None:
                mod.bias.zero_()
    return model
