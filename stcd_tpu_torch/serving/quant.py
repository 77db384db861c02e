"""Post-training int8 quantization of the eval and serving forward
(counterpart of stcd_tpu/serving/quant.py).

The semantics are the JAX package's:

- each conv site's activation is quantized per tensor, symmetric, with a
  scale calibrated as the max |x| over the calibration batches; its weight
  per output channel, symmetric, from the weight itself;
- the product is int8 x int8 -> int32, dequantized at once to the dtype the
  float conv would have given, so everything around the conv (BatchNorm,
  residual adds, activations, the fusion heads) runs as before;
- grouped and depthwise convs, and convs with fewer than ``min_in_channels``
  input channels, stay float and take a NaN slot in the scale table; a site
  whose calibration input was identically zero (scale 0) stays float too;
- a forward that meets another number of sites than the table has raises.

The sites are the ones the JAX package counts, in its order. It intercepts
``jax.lax.conv_general_dilated`` while tracing, so a site is every call of
that function in call order: each ``nn.Conv``, and the two convs of the UNet
decoder's fused first conv (``stcd_tpu/decoders/unet.py:_FusedUpConv``: a
dilated conv of the block's input with the upsample-composed kernel, and a conv
of the skip; one conv where the block has no skip). flax's ``ConvTranspose``
lowers through ``lax.conv_transpose``, which calls the library's own
``conv_general_dilated`` and not the patched name, so transposed convs are no
site there and stay float here as well. The exception is a stride-1
``nn.ConvTranspose2d`` (the FC-Siam decoders' ``conv*d``): the JAX package
builds it as an ``nn.Conv`` with the flipped, IO-swapped kernel, so it is a
site there, and here it runs as that conv. The port catches the sites per
module, never by patching a global function: while ``fn`` runs, each
``nn.Conv2d`` and stride-1 ``nn.ConvTranspose2d`` of ``model`` and each UNet
``DecoderBlock`` gets an instance ``forward`` that reports to the site table,
and loses it after. A ``DecoderBlock``'s first conv
is run as JAX's two convs there; the ResNet blocks run their shortcut conv
after the main branch, as the JAX blocks do.

The int8 product: on a CUDA tensor, an im2col of the int8 input (``F.unfold``
on the integer values in float16, which holds them exactly) times the int8
weight by ``torch._int_mm`` (cuBLASLt), with K, N and M padded with zeros to
what ``_int_mm`` takes; nothing falls back to float. On the CPU, a float64
conv of the integer values, which gives the int32 sums exactly (at most
127^2 x K < 2^53 for any K here; a float32 conv would not be exact:
127^2 x 4608 > 2^24).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_LOCK = threading.RLock()


def _composed_kernel(ka: torch.Tensor) -> torch.Tensor:
    """A 3x3 (O, I, 3, 3) kernel composed with the nearest 2x upsample: the
    4x4 kernel that, applied to the input dilated by 2 with padding 2, equals
    ``ka`` applied with padding 1 to the upsampled input
    (``stcd_tpu/decoders/unet.py:_upsample_composed_kernel``)."""
    kp = F.pad(ka, (1, 1, 1, 1))
    return kp[..., :-1, :-1] + kp[..., :-1, 1:] + kp[..., 1:, :-1] + kp[..., 1:, 1:]


def _dilate2(x: torch.Tensor) -> torch.Tensor:
    """Zeros between the pixels: (N, C, H, W) -> (N, C, 2H-1, 2W-1)."""
    n, c, h, w = x.shape
    out = x.new_zeros((n, c, 2 * h - 1, 2 * w - 1))
    out[:, :, ::2, ::2] = x
    return out


def _int_conv(xq: torch.Tensor, wq: torch.Tensor, stride, padding, dilation) -> torch.Tensor:
    """The exact int32 sums of conv2d(xq, wq) (groups 1) as float32, for
    integer-valued float tensors in [-127, 127]."""
    if not xq.is_cuda:
        y = F.conv2d(xq.double(), wq.double(), None, stride, padding, dilation)
        return y.to(torch.int32).float()
    n, _, h, w = xq.shape
    o, _, kh, kw = wq.shape
    ho = (h + 2 * padding[0] - dilation[0] * (kh - 1) - 1) // stride[0] + 1
    wo = (w + 2 * padding[1] - dilation[1] * (kw - 1) - 1) // stride[1] + 1
    cols = F.unfold(xq.half(), (kh, kw), dilation, padding, stride)  # (N, K, L)
    k = cols.shape[1]
    a = cols.transpose(1, 2).reshape(n * ho * wo, k).to(torch.int8)
    b = wq.reshape(o, k).to(torch.int8)
    # torch._int_mm: more than 16 rows, K and N multiples of 8
    kp, op, mp = -(-k // 8) * 8, -(-o // 8) * 8, max(a.shape[0], 17)
    if (kp, mp) != (k, a.shape[0]):
        a = F.pad(a, (0, kp - k, 0, mp - a.shape[0]))
    if (op, kp) != (o, k):
        b = F.pad(b, (0, kp - k, 0, op - o))
    y = torch._int_mm(a, b.t())[:n * ho * wo, :o]
    return y.reshape(n, ho * wo, o).transpose(1, 2).reshape(n, o, ho, wo).float()


def _out_dtype(x: torch.Tensor, w: torch.Tensor) -> torch.dtype:
    """The dtype the float conv would give: autocast's where it is on."""
    dev = x.device.type
    if torch.is_autocast_enabled(dev):
        return torch.get_autocast_dtype(dev)
    return torch.result_type(x, w)


def _quantized_conv(x, w, bias, scale: float, stride, padding, dilation,
                    lhs_dilated: bool = False) -> torch.Tensor:
    """One quantized site (stcd_tpu/serving/quant.py:171-202): x per tensor at
    ``scale``, w per output channel, the int32 product, dequantized to the
    float conv's dtype, then the bias."""
    out_dtype = _out_dtype(x, w)
    a_s = torch.tensor(np.float32(float(scale) / 127.0), device=x.device)
    xq = torch.clamp(torch.round(x.float() / a_s), -127, 127)
    wf = w.float()
    w_s = torch.clamp(wf.abs().amax(dim=(1, 2, 3), keepdim=True), min=1e-30) / 127.0
    wq = torch.clamp(torch.round(wf / w_s), -127, 127)
    if lhs_dilated:
        xq = _dilate2(xq)
    y = _int_conv(xq, wq, stride, padding, dilation)
    y = (y * (a_s * w_s.reshape(1, -1, 1, 1))).to(out_dtype)
    return y if bias is None else y + bias.to(out_dtype).reshape(1, -1, 1, 1)


class _Sites:
    """The conv sites of one forward, in call order. ``scales`` None
    calibrates (each site reports max |x|, or NaN where it stays float);
    otherwise each quantizable site with a finite, positive scale runs int8."""

    def __init__(self, min_in_channels: int, scales: Optional[np.ndarray] = None):
        self.min_in_channels = min_in_channels
        self.scales = scales
        self.maxes: List[torch.Tensor] = []
        self.count = 0

    def _next(self, x: torch.Tensor, quantizable: bool) -> Optional[float]:
        """Take the next slot; the scale to quantize with, or None for float."""
        i = self.count
        self.count += 1
        if self.scales is None:
            self.maxes.append(x.detach().abs().amax().float() if quantizable
                              else x.new_tensor(float("nan"), dtype=torch.float32))
            return None
        if i >= self.scales.shape[0]:
            raise ValueError(f"conv site {i} beyond calibration table "
                             f"({self.scales.shape[0]} sites): calibrate with the same "
                             "forward")
        s = float(self.scales[i])
        return s if quantizable and np.isfinite(s) and s > 0.0 else None

    def _quantizable(self, x: torch.Tensor, w: torch.Tensor, groups: int, cin: int) -> bool:
        return (groups == 1 and x.is_floating_point() and w.is_floating_point()
                and cin >= self.min_in_channels)

    def conv(self, m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        """An ``nn.Conv2d`` call: one site."""
        scale = self._next(x, self._quantizable(x, m.weight, m.groups, m.weight.shape[1]))
        if scale is None or m.padding_mode != "zeros" or isinstance(m.padding, str):
            return nn.Conv2d.forward(m, x)
        return _quantized_conv(x, m.weight, m.bias, scale, m.stride, m.padding, m.dilation)

    def conv_transpose_s1(self, m: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
        """A stride-1 ``nn.ConvTranspose2d``: one site, the conv with the
        flipped, IO-swapped kernel and padding d (k - 1) - p, as JAX runs it."""
        w = m.weight.flip(2, 3).transpose(0, 1)  # (out, in, kh, kw)
        scale = self._next(x, self._quantizable(x, w, m.groups, w.shape[1]))
        if scale is None:
            return nn.ConvTranspose2d.forward(m, x)
        pad = tuple(d * (k - 1) - p for d, k, p in zip(m.dilation, m.kernel_size, m.padding))
        return _quantized_conv(x, w, m.bias, scale, (1, 1), pad, m.dilation)

    def decoder_block(self, block, x: torch.Tensor, skip=None) -> torch.Tensor:
        """A UNet ``DecoderBlock``: its first conv as the JAX decoder's split
        form (a site for the upsampled input, one for the skip), then its
        BatchNorm and ReLU, then its second conv (a site of its own)."""
        conv = block.conv1[0]
        in_x = x.shape[1]
        w_x, w_skip = conv.weight[:, :in_x], conv.weight[:, in_x:]
        scale = self._next(x, self._quantizable(x, conv.weight, conv.groups, in_x))
        if scale is None:
            y = F.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), w_x, None,
                         1, 1)
        else:
            y = _quantized_conv(x, _composed_kernel(w_x), None, scale, (1, 1), (2, 2),
                                (1, 1), lhs_dilated=True)
        if skip is not None:
            scale = self._next(skip, self._quantizable(skip, conv.weight, conv.groups,
                                                       skip.shape[1]))
            y = y + (F.conv2d(skip, w_skip, None, 1, 1) if scale is None else
                     _quantized_conv(skip, w_skip, None, scale, (1, 1), (1, 1), (1, 1)))
        if conv.bias is not None:
            y = y + conv.bias.reshape(1, -1, 1, 1)
        for layer in list(block.conv1)[1:]:
            y = layer(y)
        return block.conv2(torch.relu(y))


@contextlib.contextmanager
def _intercept(model: nn.Module, sites: _Sites):
    """Give ``model``'s conv modules and UNet decoder blocks an instance
    ``forward`` that goes through ``sites``; take it away after. A block with
    scse gates keeps its own forward, its convs sites of their own: the JAX
    block takes the split form only without gates."""
    from stcd_tpu_torch.decoders.unet import DecoderBlock

    blocks = [m for m in model.modules() if isinstance(m, DecoderBlock)
              and isinstance(m.attention2.attention, nn.Identity)]
    claimed = {id(b.conv1[0]) for b in blocks}
    convs = [m for m in model.modules()
             if isinstance(m, nn.Conv2d) and id(m) not in claimed]
    convs_t = [m for m in model.modules()
               if isinstance(m, nn.ConvTranspose2d) and m.stride == (1, 1)
               and m.output_padding == (0, 0) and m.groups == 1]
    with _LOCK:
        try:
            for m in convs:
                m.forward = lambda x, m=m: sites.conv(m, x)
            for m in convs_t:
                m.forward = lambda x, output_size=None, m=m: sites.conv_transpose_s1(m, x)
            for b in blocks:
                b.forward = lambda x, skip=None, b=b: sites.decoder_block(b, x, skip)
            yield sites
        finally:
            for m in convs + convs_t + blocks:
                m.__dict__.pop("forward", None)


def calibrate_conv_scales(model: nn.Module, fn: Callable, batches: Sequence,
                          min_in_channels: int = 16) -> np.ndarray:
    """Run ``fn`` (an eval forward of ``model``, e.g. ``cli.predict``'s
    ``base_fn``) over the calibration batches and return each conv site's max
    |activation| over all of them, in call order, shape ``(n_sites,)``; NaN
    for a site that stays float, so that the indices line up with
    :func:`quantize_fn`'s."""
    scales: Optional[np.ndarray] = None
    for batch in batches:
        args = batch if isinstance(batch, (tuple, list)) else (batch,)
        with torch.no_grad(), _intercept(model, _Sites(min_in_channels)) as sites:
            fn(*args)
        batch_maxes = (torch.stack(sites.maxes).cpu().numpy() if sites.maxes
                       else np.zeros((0,), np.float32))
        if scales is None:
            scales = batch_maxes
        elif scales.shape != batch_maxes.shape:
            raise ValueError(
                f"conv-site count changed across calibration batches ({scales.shape[0]} "
                f"vs {batch_maxes.shape[0]}): fn must run the same convs for every batch")
        else:
            scales = np.fmax(scales, batch_maxes)  # fmax keeps the NaN slots
    if scales is None:
        raise ValueError("no calibration batches given")
    return scales


def n_quantized_sites(act_scales: np.ndarray) -> int:
    """The conv sites :func:`quantize_fn` runs in int8: finite and strictly
    positive scales (NaN marks a site that stays float, 0 a calibration input
    that was identically zero)."""
    s = np.asarray(act_scales)
    return int((np.isfinite(s) & (s > 0)).sum())


def quantize_fn(model: nn.Module, fn: Callable, act_scales: np.ndarray,
                min_in_channels: int = 16) -> Callable:
    """``fn`` with every quantizable conv site of ``model`` in int8.
    ``act_scales`` comes from :func:`calibrate_conv_scales` with the same
    ``min_in_channels``. The returned callable can be traced by
    ``torch.export`` (the scales are then constants of the program)."""
    act_scales = np.asarray(act_scales, np.float32)

    def quantized(*args, **kwargs):
        with _intercept(model, _Sites(min_in_channels, act_scales)) as sites:
            out = fn(*args, **kwargs)
        if sites.count != act_scales.shape[0]:
            raise ValueError(f"the quantized forward hit {sites.count} conv sites but the "
                             f"calibration table has {act_scales.shape[0]}: fn changed")
        return out

    return quantized
