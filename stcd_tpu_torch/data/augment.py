"""Photometric preprocessing and train-time augmentation (counterpart of
stcd_tpu/data/augment.py). NHWC in and out, values in [0, 1], as the JAX
functions. ``cutout`` and the geometric and photometric pipeline
``get_training_augmentation`` close the file: each samples its draws
(``sample_cutout_params``, ``sample_training_augmentation_params``) apart
from applying them to a whole batch at once.

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

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from stcd_tpu_torch.utils.device import indexed_device

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


def concat_params(*params: Params) -> Params:
    """The draws of several batches as one batch, in the order given."""
    return {k: torch.cat([p[k] for p in params], dim=0) for k in params[0]}


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
                  jitter_p: float = 0.5, aug_params: Optional[Params] = None,
                  impl: Optional[str] = None) -> torch.Tensor:
    """The train-time pipeline on an (N, H, W, 3) batch: every image draws
    its own coins and factors. ``aug_params`` (one dict of draws) replaces
    the sampling."""
    from stcd_tpu_torch.ops.augment import apply_augment_batch

    params = aug_params if aug_params is not None else sample_augment_params(
        generator, imgs.shape[0], jitter_p)
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


def select_params(params: Params, index) -> Params:
    """The draws of the images ``index`` (an int keeps a batch of one)."""
    if isinstance(index, int):
        index = slice(index, index + 1)
    return {k: v[index] for k, v in params.items()}


def _batched(img: torch.Tensor, *rest: torch.Tensor):
    """(H, W, C) -> a batch of one; (N, H, W, C) as it is. Returns the tensors
    and whether a batch axis was added."""
    single = img.dim() == 3
    return tuple(x[None] if single and x is not None else x for x in (img, *rest)), single


def _unbatched(single: bool, *xs: torch.Tensor):
    return tuple(x[0] if single else x for x in xs)


def _col(v: torch.Tensor) -> torch.Tensor:
    """Per-image values (N,) as (N, 1, 1, 1)."""
    return v.reshape(-1, 1, 1, 1)


def _constant(values: tuple, device: torch.device) -> torch.Tensor:
    """A float32 constant on ``device``, copied there once: a copy from pageable
    host memory waits for the device's queue, so the ops do not make one a call.
    Keyed on the device with its index, so two cards never share one."""
    return _constant_on(values, indexed_device(device))


@functools.lru_cache(maxsize=64)
def _constant_on(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def _uniform(generator: torch.Generator, lo: float, hi: float, *shape) -> torch.Tensor:
    u = torch.rand(*shape, generator=generator, device=generator.device)
    return lo + (hi - lo) * u


# ---------------------------------------------------------------------------
# cutout (stcd_tpu/data/augment.py:370-399): one rectangle a pair erased from
# both images with the same random fill, the label stamped inside it. The box
# origin is uniform over the range where the box fits.
# ---------------------------------------------------------------------------

def sample_cutout_params(generator: torch.Generator, n: int, h: int, w: int, c: int = 3,
                         p: float = 0.5, size_min: float = 0.02, size_max: float = 0.4,
                         ratio_1: float = 0.3, ratio_2: float = 1 / 0.3,
                         value_min: float = 0.0, value_max: float = 1.0) -> Params:
    """Draws of ``cutout`` for ``n`` pairs of (h, w, c) images: ``apply`` (n,)
    bool (p), ``size`` (n,) the box's share of the image in [size_min,
    size_max], ``ratio`` (n,) its height over width, ``x`` and ``y`` (n,)
    where its origin sits in the range that fits, in [0, 1), and ``fill``
    (n, h, w, c) in [value_min, value_max]."""
    return {"apply": _uniform(generator, 0.0, 1.0, n) < p,
            "size": _uniform(generator, size_min, size_max, n),
            "ratio": _uniform(generator, ratio_1, ratio_2, n),
            "x": _uniform(generator, 0.0, 1.0, n),
            "y": _uniform(generator, 0.0, 1.0, n),
            "fill": _uniform(generator, value_min, value_max, n, h, w, c)}


def cutout(generator: Optional[torch.Generator], img_a: torch.Tensor, img_b: torch.Tensor,
           mask: torch.Tensor, p: float = 0.5, size_min: float = 0.02, size_max: float = 0.4,
           ratio_1: float = 0.3, ratio_2: float = 1 / 0.3, value_min: float = 0.0,
           value_max: float = 1.0, mask_value: float = 1.0, params: Optional[Params] = None):
    """Erase one random box from both images of a pair, with the same fill,
    and stamp ``mask_value`` into the label there. Images (H, W, C) or
    (N, H, W, C) in [0, 1]; the label (..., H, W, 1) or (..., H, W). A batch
    draws a box for each pair. ``params`` (``sample_cutout_params``)
    replaces the sampling."""
    (img_a, img_b, mask), single = _batched(img_a, img_b, mask)
    n, h, w, c = img_a.shape
    if params is None:
        params = sample_cutout_params(generator, n, h, w, c, p, size_min, size_max, ratio_1,
                                      ratio_2, value_min, value_max)
    params = params_to(params, img_a.device)
    size = params["size"] * h * w
    ratio = params["ratio"]
    erase_w = torch.clamp(torch.sqrt(size / ratio), 1.0, w)
    erase_h = torch.clamp(torch.sqrt(size * ratio), 1.0, h)
    x0 = (params["x"] * (w - erase_w))[:, None, None]
    y0 = (params["y"] * (h - erase_h))[:, None, None]
    ys = torch.arange(h, dtype=torch.float32, device=img_a.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=img_a.device)[None, None, :]
    inside = ((ys >= y0) & (ys < y0 + erase_h[:, None, None])
              & (xs >= x0) & (xs < x0 + erase_w[:, None, None])
              & params["apply"][:, None, None])
    box = inside[..., None]
    img_a = torch.where(box, params["fill"], img_a)
    img_b = torch.where(box, params["fill"], img_b)
    mask = torch.where(box if mask.dim() == 4 else inside, mask.new_full((), mask_value), mask)
    return _unbatched(single, img_a, img_b, mask)


# ---------------------------------------------------------------------------
# The geometric and photometric training pipeline (stcd_tpu/data/augment.py:
# 402-624; the reference's albumentations Compose): HFlip(0.5) ->
# ShiftScale(p=1) -> GaussNoise(0.2) -> Perspective(0.5) -> OneOf{contrast
# stretch, brightness-contrast, gamma}(0.9) -> OneOf{sharpen, blur, motion
# blur}(0.9) -> OneOf{brightness-contrast, hue-saturation}(0.9). A global
# percentile contrast stretch stands in for CLAHE, as in the JAX package.
#
# Every op works on an (N, H, W, C) batch with per-image parameters of shape
# (N,): one warp, one 3x3 filter and one select for the whole batch.
# ---------------------------------------------------------------------------

def _round_half_away_from_zero(x: torch.Tensor) -> torch.Tensor:
    """jnp.round's rule (torch.round rounds halves to even)."""
    f = torch.floor(x)
    d = x - f  # exact below 2**23
    up = (d > 0.5) | ((d == 0.5) & (x >= 0))
    return torch.where(up, f + 1, f)


def _warp(img: torch.Tensor, matrix: torch.Tensor, order: int = 1) -> torch.Tensor:
    """Backward warp of (N, H, W, C) by homographies (N, 3, 3) that map an
    output pixel's (x, y, 1) to source coordinates: bilinear (order 1) or
    nearest (order 0, halves away from zero), 0 outside the image. The four
    neighbours are each tested against the bounds, and the sum runs in the
    order of jax.scipy.ndimage.map_coordinates (mode 'constant')."""
    n, h, w, c = img.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=img.device),
                            torch.arange(w, dtype=torch.float32, device=img.device),
                            indexing="ij")
    xs, ys = xs.reshape(1, -1), ys.reshape(1, -1)
    m = matrix.to(torch.float32)
    src = [m[:, r, 0:1] * xs + m[:, r, 1:2] * ys + m[:, r, 2:3] for r in range(3)]
    sx, sy = src[0] / src[2], src[1] / src[2]
    flat = img.reshape(n, h * w, c)

    def tap(iy, ix):
        valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        index = (torch.clamp(iy, 0, h - 1) * w + torch.clamp(ix, 0, w - 1)).long()
        got = torch.gather(flat, 1, index[..., None].expand(-1, -1, c))
        return torch.where(valid[..., None], got, torch.zeros((), dtype=img.dtype,
                                                               device=img.device))

    if order == 0:
        out = tap(_round_half_away_from_zero(sy), _round_half_away_from_zero(sx))
    else:
        y0, x0 = torch.floor(sy), torch.floor(sx)
        wy1, wx1 = sy - y0, sx - x0
        wy0, wx0 = 1 - wy1, 1 - wx1
        out = None
        for iy, wy in ((y0, wy0), (y0 + 1, wy1)):
            for ix, wx in ((x0, wx0), (x0 + 1, wx1)):
                term = (wy * wx)[..., None] * tap(iy, ix)
                out = term if out is None else out + term
    return out.reshape(n, h, w, c)


def shift_scale_matrix(scale: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor,
                       h: int, w: int) -> torch.Tensor:
    """(N, 3, 3) output -> source maps: scale about the image centre, then
    translate by (tx, ty) pixels."""
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    inv_s = 1.0 / scale
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    return torch.stack([torch.stack([inv_s, zero, cx - inv_s * (cx + tx)], -1),
                        torch.stack([zero, inv_s, cy - inv_s * (cy + ty)], -1),
                        torch.stack([zero, zero, one], -1)], 1)


def shift_scale(img: torch.Tensor, mask: torch.Tensor, scale: torch.Tensor,
                tx: torch.Tensor, ty: torch.Tensor):
    """ShiftScaleRotate(rotate_limit=0): the image bilinear, the mask nearest."""
    m = shift_scale_matrix(scale, tx, ty, img.shape[1], img.shape[2])
    return _warp(img, m, order=1), _warp(mask, m, order=0)


def perspective_matrix(jitter: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, 3, 3) homographies H with H [corner, 1] ~ [corner + jitter * (w, h), 1]
    for the four corners, from a batched 8x8 solve; ``jitter`` (N, 4, 2)."""
    corners = _constant(((0.0, 0.0), (w - 1.0, 0.0), (w - 1.0, h - 1.0), (0.0, h - 1.0)),
                        jitter.device)
    src = corners + jitter * _constant((float(w), float(h)), jitter.device)
    n = jitter.shape[0]
    xd, yd = corners[:, 0].expand(n, 4), corners[:, 1].expand(n, 4)
    xs_, ys_ = src[..., 0], src[..., 1]
    zero, one = torch.zeros_like(xs_), torch.ones_like(xs_)
    row_x = torch.stack([xd, yd, one, zero, zero, zero, -xs_ * xd, -xs_ * yd], -1)
    row_y = torch.stack([zero, zero, zero, xd, yd, one, -ys_ * xd, -ys_ * yd], -1)
    a = torch.stack([row_x, row_y], 2).reshape(n, 8, 8)
    hvec = torch.linalg.solve_ex(a, src.reshape(n, 8))[0]  # no host sync for the check
    return torch.cat([hvec, torch.ones(n, 1, device=jitter.device)], 1).reshape(n, 3, 3)


def perspective(img: torch.Tensor, mask: torch.Tensor, jitter: torch.Tensor):
    """albumentations Perspective: the corners moved by ``jitter`` times the
    side, the image bilinear, the mask nearest."""
    m = perspective_matrix(jitter, img.shape[1], img.shape[2])
    return _warp(img, m, order=1), _warp(mask, m, order=0)


def gauss_noise(img: torch.Tensor, var: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """``noise`` (standard normal, the image's shape) scaled by sqrt(var)."""
    return torch.clamp(img + torch.sqrt(_col(var)) * noise, 0.0, 1.0)


def _percentile(img: torch.Tensor, pct: float) -> torch.Tensor:
    """jnp.percentile(linear) of each image as a whole, (N, 1, 1, 1): the
    sorted row's two neighbours of q (n - 1), mixed linearly."""
    rows = torch.sort(img.reshape(img.shape[0], -1), dim=1).values
    n = rows.shape[1]
    q = torch.tensor(pct / 100.0, dtype=torch.float32) * (n - 1)
    low, high = int(torch.floor(q)), int(torch.ceil(q))
    hw = float(q - torch.floor(q))
    return _col(rows[:, low] * (1.0 - hw) + rows[:, high] * hw)


def contrast_stretch(img: torch.Tensor, lo_pct: float = 2.0, hi_pct: float = 98.0):
    """Each image stretched so that its lo_pct..hi_pct percentiles span [0, 1]."""
    lo, hi = _percentile(img, lo_pct), _percentile(img, hi_pct)
    return torch.clamp((img - lo) / torch.clamp(hi - lo, min=1e-6), 0.0, 1.0)


def random_brightness_contrast(img: torch.Tensor, alpha: torch.Tensor,
                               beta: torch.Tensor) -> torch.Tensor:
    """Contrast ``alpha`` about the image's mean, then brightness ``beta``."""
    mean = img.mean(dim=(1, 2, 3), keepdim=True)
    return torch.clamp((img - mean) * _col(alpha) + mean + _col(beta), 0.0, 1.0)


def random_gamma(img: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.clamp(img, min=1e-8) ** _col(gamma), 0.0, 1.0)


def _conv3x3(img: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """Each channel of (N, H, W, C) filtered by a 3x3 kernel ((3, 3), or
    (N, 3, 3) one an image), zero-padded to the same size (cross-correlation,
    as lax.conv)."""
    n, h, w, _ = img.shape
    kern = kern.to(img.dtype).expand(n, 3, 3)
    padded = F.pad(img, (0, 0, 1, 1, 1, 1))
    out = None
    for i in range(3):
        for j in range(3):
            term = _col(kern[:, i, j]) * padded[:, i:i + h, j:j + w]
            out = term if out is None else out + term
    return out


_SHARPEN = ((-1.0, -1.0, -1.0), (-1.0, 9.0, -1.0), (-1.0, -1.0, -1.0))
# horizontal, vertical and the two diagonals
_MOTION = (((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (0.0, 0.0, 0.0)),
           ((0.0, 1.0, 0.0), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0)),
           ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)),
           ((0.0, 0.0, 1.0), (0.0, 1.0, 0.0), (1.0, 0.0, 0.0)))


def sharpen(img: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    sharp = _conv3x3(img, _constant(_SHARPEN, img.device))
    a = _col(alpha)
    return torch.clamp((1 - a) * img + a * sharp, 0.0, 1.0)


def box_blur(img: torch.Tensor) -> torch.Tensor:
    return _conv3x3(img, torch.full((3, 3), 1.0 / 9.0, device=img.device))


def motion_blur(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """3x3 motion blur along direction ``kernel`` (N,) in 0..3: horizontal,
    vertical, the diagonal, the anti-diagonal."""
    return _conv3x3(img, _constant(_MOTION, img.device)[kernel.long()] / 3.0)


def hue_saturation_value(img: torch.Tensor, hue: torch.Tensor, sat: torch.Tensor,
                         val: torch.Tensor) -> torch.Tensor:
    """Shift hue by ``hue`` / 180 of the circle (OpenCV's uint8 hue range),
    saturation by ``sat`` / 255 and value by ``val`` / 255."""
    hsv = _rgb_to_hsv(torch.clamp(img, 0.0, 1.0))
    h = torch.remainder(hsv[..., 0] + _col(hue)[..., 0] / 180.0, 1.0)
    s = torch.clamp(hsv[..., 1] + _col(sat)[..., 0] / 255.0, 0.0, 1.0)
    v = torch.clamp(hsv[..., 2] + _col(val)[..., 0] / 255.0, 0.0, 1.0)
    return _hsv_to_rgb(torch.stack([h, s, v], dim=-1))


def _one_of(branches, pick: torch.Tensor, apply: torch.Tensor, x: torch.Tensor):
    """albumentations OneOf: image i takes branch ``pick[i]``'s output where
    ``apply[i]``, else stays. Every branch is computed for the whole batch."""
    picked = branches[0]
    for j, out in enumerate(branches[1:], start=1):
        picked = torch.where(_col(pick == j), out, picked)
    return torch.where(_col(apply), picked, x)


def sample_training_augmentation_params(generator: torch.Generator, n: int, h: int, w: int,
                                        c: int = 3, shift_limit: float = 0.1,
                                        scale_limit: float = 0.5, noise_p: float = 0.2,
                                        perspective_p: float = 0.5,
                                        one_of_p: float = 0.9) -> Params:
    """Every draw of ``get_training_augmentation`` for ``n`` images of
    (h, w, c), on the generator's device; each (n,) unless said:

    - ``flip`` bool (p 0.5);
    - ``scale`` = 1 + U[-scale_limit, scale_limit], ``tx`` = U[-shift_limit,
      shift_limit] w and ``ty`` = U[..] h pixels (ShiftScale, always);
    - ``noise_apply`` bool (noise_p), ``noise_var`` U[10, 50] / 255^2,
      ``noise`` (n, h, w, c) standard normal;
    - ``persp_apply`` bool (perspective_p), ``persp_jitter`` (n, 4, 2)
      U[-0.05, 0.05];
    - the three OneOfs, each an ``*_apply`` bool (one_of_p) and an ``*_pick``
      int64: ``color`` of {contrast stretch, brightness-contrast
      ``color_alpha`` = 1 + U[-0.2, 0.2] and ``color_beta`` = U[-0.2, 0.2],
      gamma ``gamma`` = U[80, 120] / 100}; ``blur`` of {sharpen
      ``sharpen_alpha`` U[0.2, 0.5], box blur, motion blur
      ``motion_kernel`` in 0..3}; ``tone`` of {brightness-contrast
      ``tone_alpha``, ``tone_beta``, hue-saturation-value ``hue_shift``
      U[-20, 20], ``sat_shift`` U[-30, 30], ``val_shift`` U[-20, 20]}.

    The JAX function draws a OneOf's branches from one shared key (sharpen's
    alpha and the motion kernel from one, brightness-contrast and gamma from
    one). Only the picked branch reaches the output, so drawing them apart
    gives the same distribution; a replay of JAX's draws fills each field
    from its shared key."""
    def u(lo, hi, *shape):
        return _uniform(generator, lo, hi, n, *shape)

    def randint(k):
        return torch.randint(0, k, (n,), generator=generator, device=generator.device)

    return {
        "flip": u(0.0, 1.0) < 0.5,
        "scale": 1.0 + u(-scale_limit, scale_limit),
        "tx": u(-shift_limit, shift_limit) * w,
        "ty": u(-shift_limit, shift_limit) * h,
        "noise_apply": u(0.0, 1.0) < noise_p,
        "noise_var": u(10.0 / 255 ** 2, 50.0 / 255 ** 2),
        "noise": torch.randn(n, h, w, c, generator=generator, device=generator.device),
        "persp_apply": u(0.0, 1.0) < perspective_p,
        "persp_jitter": u(-0.05, 0.05, 4, 2),
        "color_apply": u(0.0, 1.0) < one_of_p, "color_pick": randint(3),
        "color_alpha": 1.0 + u(-0.2, 0.2), "color_beta": u(-0.2, 0.2),
        "gamma": u(80.0, 120.0) / 100.0,
        "blur_apply": u(0.0, 1.0) < one_of_p, "blur_pick": randint(3),
        "sharpen_alpha": u(0.2, 0.5), "motion_kernel": randint(4),
        "tone_apply": u(0.0, 1.0) < one_of_p, "tone_pick": randint(2),
        "tone_alpha": 1.0 + u(-0.2, 0.2), "tone_beta": u(-0.2, 0.2),
        "hue_shift": u(-20.0, 20.0), "sat_shift": u(-30.0, 30.0), "val_shift": u(-20.0, 20.0),
    }


def apply_training_augmentation(img: torch.Tensor, mask: torch.Tensor, params: Params):
    """The pipeline on an (N, H, W, C) batch in [0, 1] and its (N, H, W, 1)
    mask with the draws ``params``, all images at once."""
    p = params_to(params, img.device)
    img = torch.where(_col(p["flip"]), img.flip(2), img)
    mask = torch.where(_col(p["flip"]), mask.flip(2), mask)
    img, mask = shift_scale(img, mask, p["scale"], p["tx"], p["ty"])
    img = torch.where(_col(p["noise_apply"]), gauss_noise(img, p["noise_var"], p["noise"]), img)
    pimg, pmask = perspective(img, mask, p["persp_jitter"])
    img = torch.where(_col(p["persp_apply"]), pimg, img)
    mask = torch.where(_col(p["persp_apply"]), pmask, mask)
    img = _one_of([contrast_stretch(img),
                   random_brightness_contrast(img, p["color_alpha"], p["color_beta"]),
                   random_gamma(img, p["gamma"])], p["color_pick"], p["color_apply"], img)
    img = _one_of([sharpen(img, p["sharpen_alpha"]), box_blur(img),
                   motion_blur(img, p["motion_kernel"])], p["blur_pick"], p["blur_apply"], img)
    img = _one_of([random_brightness_contrast(img, p["tone_alpha"], p["tone_beta"]),
                   hue_saturation_value(img, p["hue_shift"], p["sat_shift"], p["val_shift"])],
                  p["tone_pick"], p["tone_apply"], img)
    return img, mask


def get_training_augmentation(shift_limit: float = 0.1, scale_limit: float = 0.5,
                              noise_p: float = 0.2, perspective_p: float = 0.5,
                              one_of_p: float = 0.9):
    """Returns ``fn(generator, img, mask, params=None) -> (img, mask)`` for an
    (H, W, C) image or an (N, H, W, C) batch in [0, 1] and its mask: each
    image draws its own parameters from ``generator``
    (``sample_training_augmentation_params``) unless ``params`` are given."""

    def apply(generator: Optional[torch.Generator], img: torch.Tensor, mask: torch.Tensor,
              params: Optional[Params] = None):
        (img, mask), single = _batched(img, mask)
        if params is None:
            n, h, w, c = img.shape
            params = sample_training_augmentation_params(
                generator, n, h, w, c, shift_limit, scale_limit, noise_p, perspective_p,
                one_of_p)
        return _unbatched(single, *apply_training_augmentation(img, mask, params))

    return apply
