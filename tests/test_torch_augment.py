"""stcd_tpu_torch's plain train-time augmentation against the JAX package.

The same images (numpy, from a seed) and the same draws (JAX's
sample_augment_params, passed as numpy) go through the port's
apply_augment_batch on CPU tensors (= its plain version) and through both JAX
paths: the vmapped jnp reference and the Pallas kernel in interpret mode.
atol 2e-5 on the normalised output, the JAX kernel's own tolerance against
its reference: the whole-image mean and the blur sum in other orders.

The sampler's streams differ from JAX's, so it is held to the structure (one
jitter coin per pair) and to the marginal rates within sampling error."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stcd_tpu.data import augment as jaug
from stcd_tpu.ops.augment_kernel import apply_augment_batch as jax_kernel_batch
from stcd_tpu_torch.data import augment as taug
from stcd_tpu_torch.ops.augment import (REDUCE_BLOCKS, apply_augment_batch, apply_augment_kernel,
                                        augment_plan)

ATOL = 2e-5


def _jax_params(seed, n, **forced):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    params = jax.vmap(lambda k: jaug.sample_augment_params(k, 0.5))(keys)
    for name, value in forced.items():
        params = {**params, name: jnp.full((n,), value, bool)}
    return params


def _to_torch(params):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in params.items()}


def _images(seed, shape, uint8):
    rng = np.random.default_rng(seed)
    if uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return (rng.uniform(0, 1, shape) * 0.98).astype(np.float32)


def _hold(imgs, params):
    got = apply_augment_batch(torch.from_numpy(imgs), _to_torch(params)).numpy()
    assert got.dtype == np.float32 and got.shape == imgs.shape
    ref = jax.vmap(jaug.apply_augment_reference)(jaug.to_float01(jnp.asarray(imgs)), params)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=0,
                               err_msg="against the jnp reference")
    kern = jax_kernel_batch(jnp.asarray(imgs), params, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), atol=ATOL, rtol=0,
                               err_msg="against the Pallas kernel (interpret)")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("uint8", [True, False], ids=["uint8", "float"])
def test_plain_matches_both_jax_paths(seed, uint8):
    _hold(_images(seed, (8, 32, 32, 3), uint8), _jax_params(seed + 10, 8))


@pytest.mark.parametrize("gates", [True, False], ids=["all_on", "all_off"])
def test_plain_with_every_gate_forced(gates):
    imgs = _images(5, (4, 24, 40, 3), uint8=False)  # not square
    params = _jax_params(7, 4, jitter_apply=gates, gray_apply=gates, blur_apply=gates)
    _hold(imgs, params)
    if not gates:
        got = apply_augment_batch(torch.from_numpy(imgs), _to_torch(params))
        torch.testing.assert_close(got, taug.eval_preprocess(torch.from_numpy(imgs)),
                                   atol=2e-6, rtol=0)


@pytest.mark.parametrize("contrast_at", [0, 1, 3])
def test_plain_with_contrast_first_middle_last(contrast_at):
    """The contrast op takes the whole image's gray mean at its place in
    the order; put it first, in the middle and last."""
    order = [0, 2, 3]
    order.insert(contrast_at, 1)
    params = _jax_params(3, 4, jitter_apply=True)
    params = {**params, "perm": jnp.tile(jnp.asarray(order, jnp.int32), (4, 1))}
    _hold(_images(9, (4, 16, 16, 3), uint8=True), params)


@pytest.mark.parametrize("name,factor", [
    ("adjust_brightness", 1.37), ("adjust_contrast", 0.61), ("adjust_saturation", 1.44),
    ("adjust_hue", 0.21), ("adjust_hue", -0.25), ("adjust_hue", -0.07)])
def test_each_jitter_op_alone(name, factor):
    img = _images(11, (12, 10, 3), uint8=False)
    img[0, 0] = 0.0          # black: maxc == 0
    img[0, 1] = 0.5          # gray: deltac == 0
    img[0, 2] = (1.0, 0.0, 0.0)
    got = getattr(taug, name)(torch.from_numpy(img), factor).numpy()
    want = np.asarray(getattr(jaug, name)(jnp.asarray(img), factor))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_hsv_round_trip_and_gaussian_taps():
    img = _images(12, (9, 7, 3), uint8=False)
    hsv = taug._rgb_to_hsv(torch.from_numpy(img))
    np.testing.assert_allclose(hsv.numpy(), np.asarray(jaug._rgb_to_hsv(jnp.asarray(img))),
                               atol=2e-6, rtol=0)
    np.testing.assert_allclose(taug._hsv_to_rgb(hsv).numpy(), img, atol=2e-6, rtol=0)
    sigma = np.asarray([0.1, 0.7, 2.0, 1e-5], np.float32)
    got = taug._gaussian_kernel_1d(torch.from_numpy(sigma)).numpy()
    want = np.stack([np.asarray(jaug._gaussian_kernel_1d(jnp.asarray(s), 5)) for s in sigma])
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)


def test_sampler_structure_and_rates():
    gen = torch.Generator().manual_seed(0)
    n = 4000
    pa, pb = taug.sample_pair_params(gen, n, jitter_p=0.5)
    # one coin per pair: both jittered or neither
    assert torch.equal(pa["jitter_apply"], pb["jitter_apply"])
    # everything else is drawn per image
    assert not torch.equal(pa["factors"], pb["factors"])
    assert not torch.equal(pa["gray_apply"], pb["gray_apply"])
    both = taug.concat_params(pa, pb)
    assert both["perm"].shape == (2 * n, 4) and both["blur_kern"].shape == (2 * n, 11)
    # 4 sigma of a binomial rate over the draws
    for key, p, m in (("jitter_apply", 0.5, n), ("gray_apply", 0.2, 2 * n),
                      ("blur_apply", 0.5, 2 * n)):
        rate = both[key][:m].float().mean().item()
        assert abs(rate - p) < 4 * np.sqrt(p * (1 - p) / m), (key, rate)
    assert torch.equal(both["perm"].sort(dim=1).values,
                       torch.arange(4).expand(2 * n, 4))
    # every op lands in every slot about a quarter of the time
    assert (torch.stack([(both["perm"] == j).float().mean(0) for j in range(4)])
            - 0.25).abs().max() < 0.03
    f = both["factors"]
    assert f[:, :3].min() >= 0.5 and f[:, :3].max() <= 1.5
    assert f[:, 3].min() >= -0.25 and f[:, 3].max() <= 0.25
    assert abs(f[:, :3].mean().item() - 1.0) < 0.02 and abs(f[:, 3].mean().item()) < 0.01
    p8 = taug.sample_augment_params(gen, n, jitter_p=0.8)
    assert abs(p8["jitter_apply"].float().mean().item() - 0.8) < 4 * np.sqrt(0.16 / n)


def test_train_augment_pair_takes_injected_draws():
    a = torch.from_numpy(_images(20, (3, 16, 16, 3), uint8=True))
    b = torch.from_numpy(_images(21, (3, 16, 16, 3), uint8=True))
    gen = torch.Generator().manual_seed(1)
    pa, pb = taug.sample_pair_params(gen, 3)
    xa, xb = taug.train_augment_pair(gen, a, b, aug_params=(pa, pb))
    torch.testing.assert_close(xa, taug.apply_augment_reference(a, pa), atol=0, rtol=0)
    torch.testing.assert_close(xb, taug.apply_augment_reference(b, pb), atol=0, rtol=0)
    # sampling inside: same generator state, same result
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    ya, _ = taug.train_augment_pair(g1, a, b)
    za, _ = taug.train_augment_pair(g2, a, b)
    assert torch.equal(ya, za)
    assert taug.train_augment(g1, a).shape == a.shape


def test_kernel_refuses_cpu_tensors_and_bad_arguments():
    imgs = torch.from_numpy(_images(1, (2, 8, 8, 3), uint8=True))
    params = _to_torch(_jax_params(1, 2))
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        apply_augment_batch(imgs, params, impl="kernel")
    assert apply_augment_kernel.kernel_launches == 0
    with pytest.raises(ValueError, match="impl must be"):
        apply_augment_batch(imgs, params, impl="fast")
    with pytest.raises(ValueError, match=r"\(N, H, W, 3\)"):
        apply_augment_batch(imgs[..., :2], params)
    with pytest.raises(TypeError, match="uint8 or float32"):
        apply_augment_batch(imgs.to(torch.float64), params)
    with pytest.raises(ValueError, match="perm"):
        apply_augment_batch(imgs, {**params, "perm": params["perm"][:1]})
    with pytest.raises(RuntimeError, match="no backward"):
        apply_augment_kernel(imgs.float().requires_grad_(), params)


# --- augment_plan: the tiles of csrc/augment.cu's second launch (the kernel runs only
# on a card; its geometry and its tiled blur are held here) ---

PLAN_SHAPES = [(2, 256, 256), (3, 100, 75), (4, 100, 75), (1, 1, 1), (2, 33, 65), (1, 31, 130)]


def _pre_blur(x, params):
    """The plain version's pixels before the blur: the jitter chain and grayscale."""
    n = x.shape[0]

    def col(v):
        return v.reshape(n, 1, 1, 1)

    jittered = x
    for k in range(4):
        slot = params["perm"][:, k]
        nxt = jittered
        for j, op in enumerate(taug.JITTER_OPS):
            nxt = torch.where(col(slot == j), op(jittered, col(params["factors"][:, j])), nxt)
        jittered = nxt
    x = torch.where(col(params["jitter_apply"]), jittered, x)
    return torch.where(col(params["gray_apply"]), taug._grayscale(x).expand_as(x), x)


def _tiled_blur(x, kern, plan):
    """The blur as augment.cu's blocks form it: each tile staged with its halo by
    clamped indices, blurred vertically over the staged rows, then horizontally
    over the staged columns, taps in the same order. Returns the image and how
    many tiles wrote each pixel."""
    n, h, w, _ = x.shape
    th, tw, halo = plan["tile_h"], plan["tile_w"], plan["halo"]
    out = torch.full_like(x, float("nan"))
    written = torch.zeros((h, w), dtype=torch.int64)
    taps = kern.shape[1]
    for by in range(plan["tiles_y"]):
        for bx in range(plan["tiles_x"]):
            y0, x0 = by * th, bx * tw
            rows = torch.clamp(torch.arange(y0 - halo, y0 - halo + plan["stage_rows"]), 0, h - 1)
            cols = torch.clamp(torch.arange(x0 - halo, x0 - halo + plan["stage_cols"]), 0, w - 1)
            staged = x[:, rows][:, :, cols]
            vert = torch.zeros((n, th, plan["stage_cols"], 3))
            for t in range(taps):
                vert = vert + kern[:, t].reshape(-1, 1, 1, 1) * staged[:, t:t + th]
            horiz = torch.zeros((n, th, tw, 3))
            for t in range(taps):
                horiz = horiz + kern[:, t].reshape(-1, 1, 1, 1) * vert[:, :, t:t + tw]
            ys, xs = min(th, h - y0), min(tw, w - x0)
            out[:, y0:y0 + ys, x0:x0 + xs] = horiz[:, :ys, :xs]
            written[y0:y0 + ys, x0:x0 + xs] += 1
    return out, written


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_augment_plan_covers_every_pixel_once_and_fits(shape):
    """Every output pixel belongs to exactly one tile; the staged tile and halo,
    three f32 planes, each warp's 96 16-byte words for its stores and the uint8
    table fit four blocks in an SM's shared memory; a row's four 16-byte reads of the
    horizontal pass stay inside the staged row; two launches."""
    n, h, w = shape
    plan = augment_plan(n, h, w)
    assert (plan["tile_h"], plan["tile_w"], plan["halo"]) == (32, 64, taug.BLUR_RADIUS)
    assert (plan["tiles_x"] - 1) * plan["tile_w"] < w <= plan["tiles_x"] * plan["tile_w"]
    assert (plan["tiles_y"] - 1) * plan["tile_h"] < h <= plan["tiles_y"] * plan["tile_h"]
    assert plan["blocks"] == plan["tiles_x"] * plan["tiles_y"] * n
    assert plan["stage_rows"] == plan["tile_h"] + 2 * plan["halo"]
    assert plan["stage_cols"] == plan["tile_w"] + 2 * plan["halo"] <= plan["stage_stride"]
    assert plan["stage_stride"] % 4 == 0 and 4 * (plan["tile_w"] // 4 - 1) + 16 <= plan[
        "stage_stride"]
    assert plan["smem_bytes"] == 3 * plan["stage_rows"] * plan["stage_stride"] * 4 + 256 * 48
    # besides: the uint8 table and the mean (static, 1 KB), and 1 KB of each block is the system's
    assert 4 * (plan["smem_bytes"] + 1040 + 1024) <= 228 * 1024
    assert plan["launches"] == 2 and plan["reduce_blocks"] == REDUCE_BLOCKS == 16
    x = torch.rand((n, h, w, 3), generator=torch.Generator().manual_seed(0))
    _, written = _tiled_blur(x, taug._gaussian_kernel_1d(torch.full((n,), 1.5)), plan)
    assert bool((written == 1).all())


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_tiled_blur_is_the_plain_blur_bit_for_bit(shape):
    """The halo reaches every tap of every output pixel within the image's
    clamped edge: the tiles' blur equals the plain whole-image blur exactly."""
    n, h, w = shape
    gen = torch.Generator().manual_seed(1)
    x = torch.rand((n, h, w, 3), generator=gen)
    kern = taug._gaussian_kernel_1d(0.1 + 1.9 * torch.rand(n, generator=gen))
    got, _ = _tiled_blur(x, kern, augment_plan(n, h, w))
    assert torch.equal(got, taug._apply_gaussian_blur(x, kern))


@pytest.mark.parametrize("uint8", [True, False], ids=["uint8", "float"])
def test_tiled_pipeline_matches_both_jax_paths(uint8):
    """The kernel's structure end to end at a ragged size, emulated on the CPU:
    the pointwise chain, the tiles' blur where an image's flag says so, then
    normalisation, against the jnp reference and the Pallas kernel (interpret)."""
    imgs = _images(7, (4, 100, 75, 3), uint8)
    params = _jax_params(7, 4, jitter_apply=True)
    params = {**params, "blur_apply": jnp.asarray([True, False, True, True])}
    tp = _to_torch(params)
    pre = _pre_blur(taug.to_float01(torch.from_numpy(imgs)), tp)
    blurred, _ = _tiled_blur(pre, tp["blur_kern"], augment_plan(*imgs.shape[:3]))
    got = taug.normalize(torch.where(tp["blur_apply"].reshape(-1, 1, 1, 1), blurred, pre))
    plain = apply_augment_batch(torch.from_numpy(imgs), tp)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6, rtol=0)
    ref = jax.vmap(jaug.apply_augment_reference)(jaug.to_float01(jnp.asarray(imgs)), params)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    kern = jax_kernel_batch(jnp.asarray(imgs), params, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(0, 8, 8), (1, 0, 8), (65536, 8, 8), (1, 4097, 4097)])
def test_augment_plan_refuses_what_the_grid_cannot_take(shape):
    with pytest.raises(ValueError):
        augment_plan(*shape)


def test_sampler_draws_reach_the_kernel_without_a_conversion():
    """The kernel reads the draws as sample_augment_params makes them (perm int64,
    the gates bool, factors and taps float32, all contiguous), so the wrapper's
    conversions return the tensors themselves and launch nothing."""
    params = taug.sample_augment_params(torch.Generator().manual_seed(3), 6, 0.5)
    want = {"perm": torch.int64, "factors": torch.float32, "jitter_apply": torch.bool,
            "gray_apply": torch.bool, "blur_apply": torch.bool, "blur_kern": torch.float32}
    for key, dtype in want.items():
        t = params[key]
        assert t.dtype == dtype and t.is_contiguous()
        assert t.to(dtype).contiguous() is t
