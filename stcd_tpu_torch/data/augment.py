"""Photometric preprocessing and train-time augmentation (counterpart of
stcd_tpu/data/augment.py:31-359). NHWC in and out, values in [0, 1], as the
JAX functions.

The train-time pipeline is torchvision's ColorJitter(0.5, 0.5, 0.5, 0.25)
in a random order per image, gated by a coin; RandomGrayscale(p=0.2); an
11-tap separable Gaussian blur with sigma ~ U[0.1, 2] and edge-replicate
borders, p=0.5; ImageNet normalisation. Sampling and applying are apart:
``sample_augment_params`` makes every random draw for a batch, and
``apply_augment_reference`` applies a set of draws. The latter is the plain
version of the CUDA kernel ``ops/csrc/augment.cu``; the dispatcher between
the two is ``stcd_tpu_torch.ops.augment.apply_augment_batch``. The random
streams differ from JAX's; the distributions and the structure are the same,
and parameters sampled on either side can be fed to the other.

The functions work on one (H, W, 3) image with scalar factors or on an
(N, H, W, 3) batch with (N, 1, 1, 1) factors: every whole-image statistic is
taken over the last three axes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
GRAY_WEIGHTS = (0.299, 0.587, 0.114)  # torchvision rgb_to_grayscale
BLUR_RADIUS = 5

Params = Dict[str, torch.Tensor]


def normalize(img: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """ImageNet normalisation over the last (channel) axis."""
    m = torch.tensor(mean, dtype=torch.float32, device=img.device)
    s = torch.tensor(std, dtype=torch.float32, device=img.device)
    return (img - m) / s


def to_float01(img: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1]; float input passes through."""
    if not img.is_floating_point():
        return img.to(torch.float32) / 255.0
    return img


def eval_preprocess(img: torch.Tensor) -> torch.Tensor:
    return normalize(to_float01(img))


def _grayscale(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img[..., 0:1], img[..., 1:2], img[..., 2:3]
    return GRAY_WEIGHTS[0] * r + GRAY_WEIGHTS[1] * g + GRAY_WEIGHTS[2] * b


def adjust_brightness(img, factor):
    return torch.clamp(img * factor, 0.0, 1.0)


def adjust_contrast(img, factor):
    """Blend with the mean of the image's own grayscale."""
    mean = _grayscale(img).mean(dim=(-3, -2, -1), keepdim=True)
    return torch.clamp(img * factor + mean * (1.0 - factor), 0.0, 1.0)


def adjust_saturation(img, factor):
    gray = _grayscale(img)
    return torch.clamp(img * factor + gray * (1.0 - factor), 0.0, 1.0)


def _rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.amax(dim=-1)
    minc = img.amin(dim=-1)
    deltac = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, deltac / torch.clamp(maxc, min=1e-8), zero)
    dsafe = torch.clamp(deltac, min=1e-8)
    rc = (maxc - r) / dsafe
    gc = (maxc - g) / dsafe
    bc = (maxc - b) / dsafe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)  # floor-mod, as jnp's %
    h = torch.where(deltac == 0, zero, h)
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = i.to(torch.int64) % 6  # i is 6 where h rounded up to 1.0

    def pick(vals):
        out = torch.zeros_like(v)
        for j, val in enumerate(vals):
            out = torch.where(i == j, val, out)
        return out

    return torch.stack([pick([v, q, p, p, t, v]), pick([t, v, v, q, p, p]),
                        pick([p, p, t, v, v, q])], dim=-1)


def adjust_hue(img, shift):
    """Shift the hue channel in HSV by ``shift`` (a fraction of the circle).
    ``shift`` broadcasts against the (..., H, W) hue plane."""
    hsv = _rgb_to_hsv(torch.clamp(img, 0.0, 1.0))
    if isinstance(shift, torch.Tensor) and shift.dim() == img.dim():
        shift = shift[..., 0]
    h = torch.remainder(hsv[..., 0] + shift, 1.0)
    return _hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


JITTER_OPS = (adjust_brightness, adjust_contrast, adjust_saturation, adjust_hue)


def _gaussian_kernel_1d(sigma: torch.Tensor, radius: int = BLUR_RADIUS) -> torch.Tensor:
    """Normalised taps for sigma of shape (...,) -> (..., 2 * radius + 1)."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=sigma.device)
    k = torch.exp(-0.5 * (x / torch.clamp(sigma, min=1e-3)[..., None]) ** 2)
    return k / k.sum(dim=-1, keepdim=True)


def _apply_gaussian_blur(img: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """Separable blur of (N, H, W, C) by per-image taps (N, 2r+1): vertical
    then horizontal, indices clamped to the edge (edge-replicate padding)."""
    radius = kern.shape[-1] // 2
    for dim in (1, 2):
        size = img.shape[dim]
        pos = torch.arange(size, device=img.device)
        acc = torch.zeros_like(img)
        for t in range(kern.shape[-1]):
            idx = torch.clamp(pos + (t - radius), 0, size - 1)
            acc = acc + kern[:, t].reshape(-1, 1, 1, 1) * img.index_select(dim, idx)
        img = acc
    return img


def sample_augment_params(generator: torch.Generator, n: int, jitter_p: float,
                          jitter_apply: Optional[torch.Tensor] = None) -> Params:
    """Every random draw for the train-time pipeline of ``n`` images, on the
    generator's device (stcd_tpu/data/augment.py:94-104, :205-225):

    - ``perm`` (n, 4) int64: the order of brightness, contrast, saturation, hue;
    - ``factors`` (n, 4) float32: brightness, contrast and saturation in
      U[0.5, 1.5], hue in U[-0.25, 0.25];
    - ``jitter_apply`` (n,) bool: the ColorJitter coin (p = ``jitter_p``), or
      the tensor given by a caller that shares one coin within a pair;
    - ``gray_apply`` (n,) bool, p = 0.2; ``blur_apply`` (n,) bool, p = 0.5;
    - ``blur_kern`` (n, 11) float32: Gaussian taps for sigma ~ U[0.1, 2]."""
    dev = generator.device

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=generator, device=dev)

    perm = torch.rand(n, 4, generator=generator, device=dev).argsort(dim=1)
    factors = torch.stack([uniform(0.5, 1.5, n), uniform(0.5, 1.5, n),
                           uniform(0.5, 1.5, n), uniform(-0.25, 0.25, n)], dim=1)
    coin = uniform(0.0, 1.0, n) < jitter_p  # drawn either way: a fixed stream
    if jitter_apply is None:
        jitter_apply = coin
    return {
        "perm": perm,
        "factors": factors,
        "jitter_apply": jitter_apply.to(dev),
        "gray_apply": uniform(0.0, 1.0, n) < 0.2,
        "blur_apply": uniform(0.0, 1.0, n) < 0.5,
        "blur_kern": _gaussian_kernel_1d(uniform(0.1, 2.0, n)),
    }


def concat_params(pa: Params, pb: Params) -> Params:
    """The draws of two batches as one batch (A's images first)."""
    return {k: torch.cat([pa[k], pb[k]], dim=0) for k in pa}


def params_to(params: Params, device) -> Params:
    return {k: v.to(device, non_blocking=True) for k, v in params.items()}


def apply_augment_reference(imgs: torch.Tensor, params: Params) -> torch.Tensor:
    """Apply sampled draws to an (N, H, W, 3) batch in [0, 1] (or uint8):
    jitter chain in each image's own order, grayscale, blur, normalise.
    Float32 out. This is the plain version of ``ops/csrc/augment.cu``; like
    the JAX function it evaluates every branch and selects."""
    x = to_float01(imgs).to(torch.float32)
    n = x.shape[0]

    def col(v):
        return v.reshape(n, 1, 1, 1)

    perm, fac = params["perm"], params["factors"]
    jittered = x
    for k in range(4):
        slot = perm[:, k]
        nxt = jittered
        for j, op in enumerate(JITTER_OPS):
            nxt = torch.where(col(slot == j), op(jittered, col(fac[:, j])), nxt)
        jittered = nxt
    x = torch.where(col(params["jitter_apply"]), jittered, x)
    x = torch.where(col(params["gray_apply"]), _grayscale(x).expand_as(x), x)
    x = torch.where(col(params["blur_apply"]),
                    _apply_gaussian_blur(x, params["blur_kern"]), x)
    return normalize(x)


def train_augment(generator: torch.Generator, imgs: torch.Tensor,
                  jitter_p: float = 0.5, impl: Optional[str] = None) -> torch.Tensor:
    """The train-time pipeline on an (N, H, W, 3) batch: every image draws
    its own coins and factors."""
    from stcd_tpu_torch.ops.augment import apply_augment_batch

    params = sample_augment_params(generator, imgs.shape[0], jitter_p)
    return apply_augment_batch(imgs, params_to(params, imgs.device), impl=impl)


def sample_pair_params(generator: torch.Generator, n: int,
                       jitter_p: float = 0.5) -> Tuple[Params, Params]:
    """Draws for ``n`` bi-temporal pairs: one ColorJitter coin per pair
    (both images are jittered or neither), independent factors, orders,
    grayscale and blur (stcd_tpu/data/augment.py:318-340)."""
    dev = generator.device
    shared = torch.rand(n, generator=generator, device=dev) < jitter_p
    return (sample_augment_params(generator, n, jitter_p, shared),
            sample_augment_params(generator, n, jitter_p, shared))


def train_augment_pair(generator: torch.Generator, a: torch.Tensor, b: torch.Tensor,
                       jitter_p: float = 0.5, aug_params=None,
                       impl: Optional[str] = None):
    """Augment (N, H, W, 3) batches A and B as pairs, the 2N images in one
    call. ``aug_params`` (the pair of draw dicts for A and B) replaces the
    sampling, so that draws made elsewhere can drive this path."""
    from stcd_tpu_torch.ops.augment import apply_augment_batch

    pa, pb = aug_params if aug_params is not None else sample_pair_params(
        generator, a.shape[0], jitter_p)
    both = apply_augment_batch(torch.cat([a, b], dim=0),
                               params_to(concat_params(pa, pb), a.device), impl=impl)
    n = a.shape[0]
    return both[:n], both[n:]
