"""stcd_tpu_torch's cutout and get_training_augmentation against the JAX
functions of stcd_tpu/data/augment.py:362-624, on the CPU, in float32.

The JAX functions draw from a key; the port's apply functions take the draws
as tensors. ``jax_pipeline_params`` replays the JAX pipeline's key splits
(``keys = split(key, 10)``, the OneOfs' ``split(keys[i])`` and the branch keys
that siblings share) and draws each parameter with the JAX call that the
JAX function makes, so both sides get the same numbers. Held to:
- images within IMG_ATOL: the port sums the bilinear taps and the 3x3
  filters in the JAX order, but not always with the same fusion;
- masks (nearest warp) equal, except under a perspective warp, whose 8x8
  solve in float32 differs from JAX's by rounding and may move a source
  coordinate across a rounding boundary: there at least MASK_SHARE of the
  pixels equal;
- cutout exactly, with JAX's fill injected.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stcd_tpu.data import augment as jaug
from stcd_tpu_torch.data import augment as taug

IMG_ATOL = 1e-5
MASK_SHARE = 0.999
H, W = 32, 40


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread for this file's tests, as tests/test_torch_cli.py
    has: the suite runs several files at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(seed, n=4, h=H, w=W):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)
    mask = (rng.uniform(size=(n, h, w, 1)) > 0.6).astype(np.float32)
    return img, mask


def _t(x):
    return torch.from_numpy(np.array(x))


def _u(key, lo=0.0, hi=1.0, shape=()):
    return jax.random.uniform(key, shape, minval=lo, maxval=hi)


def _bc(key):
    kb, kc = jax.random.split(key)
    return 1.0 + _u(kc, -0.2, 0.2), _u(kb, -0.2, 0.2)


def _one_of(key, n, p=0.9):
    k_apply, k_pick = jax.random.split(key)
    return _u(k_apply) < p, jax.random.randint(k_pick, (), 0, n)


def jax_pipeline_params(key, h, w, c=3):
    """The draws that ``jaug.get_training_augmentation()(key, ...)`` makes for
    one (h, w, c) image, as the port's record of one image."""
    keys = jax.random.split(key, 10)
    ks, kx, ky = jax.random.split(keys[1], 3)
    kv, kn = jax.random.split(keys[2])
    k6a, k6b = jax.random.split(keys[6])
    k7a, k7b = jax.random.split(keys[7])
    k8a, k8b = jax.random.split(keys[8])
    kh, ks8, kv8 = jax.random.split(k8b, 3)
    color_apply, color_pick = _one_of(k6a, 3)
    color_alpha, color_beta = _bc(k6b)
    blur_apply, blur_pick = _one_of(k7a, 3)
    tone_apply, tone_pick = _one_of(k8a, 2)
    tone_alpha, tone_beta = _bc(k8b)
    p = {"flip": _u(keys[0]) < 0.5,
         "scale": 1.0 + _u(ks, -0.5, 0.5), "tx": _u(kx, -0.1, 0.1) * w,
         "ty": _u(ky, -0.1, 0.1) * h,
         "noise_apply": _u(keys[3]) < 0.2, "noise_var": _u(kv, 10.0 / 255 ** 2, 50.0 / 255 ** 2),
         "noise": jax.random.normal(kn, (h, w, c)),
         "persp_apply": _u(keys[5]) < 0.5, "persp_jitter": _u(keys[4], -0.05, 0.05, (4, 2)),
         "color_apply": color_apply, "color_pick": color_pick, "color_alpha": color_alpha,
         "color_beta": color_beta, "gamma": _u(k6b, 80.0, 120.0) / 100.0,
         "blur_apply": blur_apply, "blur_pick": blur_pick,
         "sharpen_alpha": _u(k7b, 0.2, 0.5), "motion_kernel": jax.random.randint(k7b, (), 0, 4),
         "tone_apply": tone_apply, "tone_pick": tone_pick, "tone_alpha": tone_alpha,
         "tone_beta": tone_beta, "hue_shift": _u(kh, -20.0, 20.0),
         "sat_shift": _u(ks8, -30.0, 30.0), "val_shift": _u(kv8, -20.0, 20.0)}
    out = {k: _t(v)[None] for k, v in p.items()}
    for k in ("color_pick", "blur_pick", "tone_pick", "motion_kernel"):
        out[k] = out[k].long()
    return out


def _mask_share(got, want):
    return float((got.numpy() == np.asarray(want)).mean())


KEYS = [jax.random.PRNGKey(s) for s in (0, 3, 11, 42)]


# -- each op at parameters replayed from JAX's key ------------------------------------


def test_shift_scale_matches_jax():
    img, mask = _images(0)
    for i, key in enumerate(KEYS):
        want_i, want_m = jaug.shift_scale(key, jnp.asarray(img[i]), jnp.asarray(mask[i]))
        ks, kx, ky = jax.random.split(key, 3)
        scale, tx, ty = (_t(v)[None] for v in (1.0 + _u(ks, -0.5, 0.5), _u(kx, -0.1, 0.1) * W,
                                               _u(ky, -0.1, 0.1) * H))
        got_i, got_m = taug.shift_scale(_t(img[i:i + 1]), _t(mask[i:i + 1]), scale, tx, ty)
        np.testing.assert_allclose(got_i[0].numpy(), np.asarray(want_i), atol=IMG_ATOL)
        np.testing.assert_array_equal(got_m[0].numpy(), np.asarray(want_m))


def test_perspective_matches_jax():
    img, mask = _images(1)
    share = []
    for i, key in enumerate(KEYS):
        want_i, want_m = jaug.perspective(key, jnp.asarray(img[i]), jnp.asarray(mask[i]))
        jitter = _t(_u(key, -0.05, 0.05, (4, 2)))[None]
        got_i, got_m = taug.perspective(_t(img[i:i + 1]), _t(mask[i:i + 1]), jitter)
        np.testing.assert_allclose(got_i[0].numpy(), np.asarray(want_i), atol=1e-4)
        share.append(_mask_share(got_m[0], want_m))
    assert np.mean(share) >= MASK_SHARE, share


def test_warp_nearest_rounds_halves_away_from_zero():
    """At source coordinates of exactly -0.5 and 0.5 JAX's nearest rounds away
    from zero (-1 is outside: 0; 1 is inside), where torch.round and
    grid_sample round halves to even."""
    img = torch.arange(1.0, 5.0).reshape(1, 1, 4, 1)
    shift = torch.tensor([[[1.0, 0.0, -0.5], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]])
    got = taug._warp(img, shift, order=0)
    want = jax.scipy.ndimage.map_coordinates(jnp.arange(1.0, 5.0)[None], [
        jnp.zeros(4), jnp.arange(4.0) - 0.5], order=0, mode="constant")
    np.testing.assert_array_equal(got.reshape(-1).numpy(), np.asarray(want))
    assert got.reshape(-1).tolist() == [0.0, 2.0, 3.0, 4.0]


def test_photometric_ops_match_jax():
    img, _ = _images(2)
    for i, key in enumerate(KEYS):
        x, tx_ = jnp.asarray(img[i]), _t(img[i:i + 1])
        kv, kn = jax.random.split(key)
        alpha, beta = _bc(key)
        kh, ks, kv3 = jax.random.split(key, 3)
        cases = {
            "gauss_noise": (jaug.gauss_noise(key, x), taug.gauss_noise(
                tx_, _t(_u(kv, 10.0 / 255 ** 2, 50.0 / 255 ** 2))[None],
                _t(jax.random.normal(kn, x.shape))[None])),
            "contrast_stretch": (jaug.contrast_stretch(x), taug.contrast_stretch(tx_)),
            "random_brightness_contrast": (jaug.random_brightness_contrast(key, x),
                                           taug.random_brightness_contrast(
                                               tx_, _t(alpha)[None], _t(beta)[None])),
            "random_gamma": (jaug.random_gamma(key, x), taug.random_gamma(
                tx_, _t(_u(key, 80.0, 120.0) / 100.0)[None])),
            "sharpen": (jaug.sharpen(key, x), taug.sharpen(tx_, _t(_u(key, 0.2, 0.5))[None])),
            "box_blur": (jaug.box_blur(x), taug.box_blur(tx_)),
            "motion_blur": (jaug.motion_blur(key, x), taug.motion_blur(
                tx_, _t(jax.random.randint(key, (), 0, 4))[None])),
            "hue_saturation_value": (jaug.hue_saturation_value(key, x), taug.hue_saturation_value(
                tx_, _t(_u(kh, -20.0, 20.0))[None], _t(_u(ks, -30.0, 30.0))[None],
                _t(_u(kv3, -20.0, 20.0))[None])),
        }
        for name, (want, got) in cases.items():
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=IMG_ATOL,
                                       err_msg=name)


@pytest.mark.parametrize("direction", range(4))
def test_motion_blur_each_direction_matches_jax(direction):
    img, _ = _images(3, n=1)
    key = next(k for k in (jax.random.PRNGKey(s) for s in range(100))
               if int(jax.random.randint(k, (), 0, 4)) == direction)
    want = jaug.motion_blur(key, jnp.asarray(img[0]))
    got = taug.motion_blur(_t(img), torch.tensor([direction]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=IMG_ATOL)


def test_contrast_stretch_percentile_is_jnp_percentile():
    img, _ = _images(4, n=3)
    for lo, hi in ((2.0, 98.0), (10.0, 90.0), (0.0, 100.0)):
        want = np.stack([np.asarray(jaug.contrast_stretch(jnp.asarray(x), lo, hi)) for x in img])
        got = taug.contrast_stretch(_t(img), lo, hi)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


# -- the whole pipeline -----------------------------------------------------------------


@pytest.fixture(scope="module")
def pipeline_run():
    img, mask = _images(5)
    fn = jax.jit(jaug.get_training_augmentation())
    want = [fn(k, jnp.asarray(img[i]), jnp.asarray(mask[i])) for i, k in enumerate(KEYS)]
    params = taug.concat_params(*(jax_pipeline_params(k, H, W) for k in KEYS))
    return img, mask, want, params


def test_pipeline_matches_jax_at_replayed_params(pipeline_run):
    img, mask, want, params = pipeline_run
    got_i, got_m = taug.get_training_augmentation()(None, _t(img), _t(mask), params=params)
    for i, (wi, wm) in enumerate(want):
        np.testing.assert_allclose(got_i[i].numpy(), np.asarray(wi), atol=1e-4, err_msg=str(i))
    share = _mask_share(got_m, np.stack([np.asarray(wm) for _, wm in want]))
    assert share >= MASK_SHARE
    # the keys cover both sides of every coin and every OneOf branch
    for name, values in (("flip", {0, 1}), ("persp_apply", {0, 1})):
        assert set(params[name].long().tolist()) == values, name
    assert len(set(params["color_pick"].tolist()) | set(params["blur_pick"].tolist())) >= 2


def test_pipeline_batched_equals_per_image(pipeline_run):
    img, mask, _, params = pipeline_run
    got_i, got_m = taug.apply_training_augmentation(_t(img), _t(mask), params)
    for i in range(len(KEYS)):
        one_i, one_m = taug.apply_training_augmentation(_t(img[i:i + 1]), _t(mask[i:i + 1]),
                                                        taug.select_params(params, i))
        np.testing.assert_allclose(got_i[i].numpy(), one_i[0].numpy(), atol=1e-6)
        np.testing.assert_array_equal(got_m[i].numpy(), one_m[0].numpy())
    # a single (H, W, C) image through the returned fn is the batch of one
    single_i, single_m = taug.get_training_augmentation()(None, _t(img[0]), _t(mask[0]),
                                                          params=taug.select_params(params, 0))
    assert single_i.shape == (H, W, 3) and single_m.shape == (H, W, 1)
    np.testing.assert_allclose(single_i.numpy(), got_i[0].numpy(), atol=1e-6)


def test_sampler_draws_every_field_with_its_range():
    g = torch.Generator().manual_seed(0)
    p = taug.sample_training_augmentation_params(g, 512, H, W)
    keys = set(jax_pipeline_params(jax.random.PRNGKey(0), H, W))
    assert set(p) == keys
    assert p["noise"].shape == (512, H, W, 3) and p["persp_jitter"].shape == (512, 4, 2)
    for name, lo, hi in (("scale", 0.5, 1.5), ("tx", -0.1 * W, 0.1 * W), ("ty", -0.1 * H, 0.1 * H),
                         ("gamma", 0.8, 1.2), ("sharpen_alpha", 0.2, 0.5),
                         ("hue_shift", -20, 20), ("sat_shift", -30, 30),
                         ("color_alpha", 0.8, 1.2), ("tone_beta", -0.2, 0.2)):
        assert lo <= float(p[name].min()) and float(p[name].max()) <= hi, name
    for name, rate in (("flip", 0.5), ("noise_apply", 0.2), ("persp_apply", 0.5),
                       ("color_apply", 0.9)):
        assert abs(p[name].float().mean().item() - rate) < 0.07, name
    assert set(p["motion_kernel"].tolist()) == {0, 1, 2, 3}
    assert set(p["tone_pick"].tolist()) == {0, 1}
    # the same seed, the same draws
    again = taug.sample_training_augmentation_params(torch.Generator().manual_seed(0), 512, H, W)
    assert all(torch.equal(p[k], again[k]) for k in p)


# -- cutout -------------------------------------------------------------------------------


def jax_cutout_params(key, h, w, c=3, p=0.5):
    k_apply, k_size, k_ratio, k_x, k_y, k_fill = jax.random.split(key, 6)
    return {"apply": _t(_u(k_apply) < p)[None], "size": _t(_u(k_size, 0.02, 0.4))[None],
            "ratio": _t(_u(k_ratio, 0.3, 1 / 0.3))[None], "x": _t(_u(k_x))[None],
            "y": _t(_u(k_y))[None], "fill": _t(_u(k_fill, 0.0, 1.0, (h, w, c)))[None]}


@pytest.mark.parametrize("p", [0.5, 1.0])
def test_cutout_matches_jax(p):
    img, mask = _images(6, n=8)
    b = np.ascontiguousarray(img[::-1])
    params = taug.concat_params(*(jax_cutout_params(jax.random.PRNGKey(i), H, W, p=p)
                                  for i in range(8)))
    got = taug.cutout(None, _t(img), _t(b), _t(mask), params=params)
    for i in range(8):
        want = jaug.cutout(jax.random.PRNGKey(i), jnp.asarray(img[i]), jnp.asarray(b[i]),
                           jnp.asarray(mask[i]), p=p)
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(g_[i].numpy(), np.asarray(w_))
    if p == 1.0:
        assert all(bool((got[0][i] != _t(img[i])).any()) for i in range(8))


def test_cutout_one_box_over_a_batch_matches_jax():
    """JAX's NHWC call draws one box for the batch: the port with one draw
    repeated over the batch gives the same, and a 2-D label takes the box too."""
    img, mask = _images(7)
    key = jax.random.PRNGKey(5)
    want = jaug.cutout(key, jnp.asarray(img), jnp.asarray(img), jnp.asarray(mask[..., 0]), p=1.0)
    one = jax_cutout_params(key, H, W, p=1.0)
    k_fill = jax.random.split(key, 6)[5]
    params = {k: v.expand(4, *v.shape[1:]) for k, v in one.items()}
    params["fill"] = _t(_u(k_fill, 0.0, 1.0, img.shape))
    got = taug.cutout(None, _t(img), _t(img), _t(mask[..., 0]), params=params)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


# -- the invariants of tests/test_augment_extra.py ---------------------------------------


def test_cutout_erases_same_box_in_both_images_and_p0_is_identity():
    img, mask = _images(8, n=2)
    g = torch.Generator().manual_seed(7)
    a, b, m = taug.cutout(g, _t(img), _t(img), _t(mask), p=1.0)
    for i in range(2):
        changed = (a[i] != _t(img[i])).any(-1).numpy()
        assert changed.any()
        np.testing.assert_array_equal(a[i].numpy(), b[i].numpy())
        assert (m[i, ..., 0].numpy()[changed] == 1.0).all()
        rows, cols = np.where(changed.any(1))[0], np.where(changed.any(0))[0]
        assert changed[rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1].all()
    a, b, m = taug.cutout(g, _t(img), _t(img), _t(mask), p=0.0)
    assert torch.equal(a, _t(img)) and torch.equal(m, _t(mask))


def test_identity_at_zero_limits():
    img, mask = _images(9, n=2)
    one, zero = torch.ones(2), torch.zeros(2)
    i2, m2 = taug.shift_scale(_t(img), _t(mask), one, zero, zero)
    np.testing.assert_allclose(i2.numpy(), img, atol=1e-6)
    np.testing.assert_array_equal(m2.numpy(), mask)
    i3, m3 = taug.perspective(_t(img), _t(mask), torch.zeros(2, 4, 2))
    np.testing.assert_allclose(i3.numpy(), img, atol=1e-5)
    np.testing.assert_array_equal(m3.numpy(), mask)


def test_mask_stays_binary_and_image_in_range_under_pipeline():
    img, mask = _images(10, n=8)
    ai, am = taug.get_training_augmentation()(torch.Generator().manual_seed(2), _t(img),
                                              _t(mask))
    assert ai.shape == img.shape and am.shape == mask.shape
    assert torch.isfinite(ai).all() and float(ai.min()) >= 0.0 and float(ai.max()) <= 1.0
    assert set(am.unique().tolist()) <= {0.0, 1.0}


def test_photometric_ops_stay_in_range():
    img, _ = _images(11, n=4)
    x = _t(img)
    g = torch.Generator().manual_seed(5)
    p = taug.sample_training_augmentation_params(g, 4, H, W)
    for out in (taug.gauss_noise(x, p["noise_var"], p["noise"]),
                taug.random_brightness_contrast(x, p["color_alpha"], p["color_beta"]),
                taug.random_gamma(x, p["gamma"]), taug.sharpen(x, p["sharpen_alpha"]),
                taug.hue_saturation_value(x, p["hue_shift"], p["sat_shift"], p["val_shift"])):
        assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
