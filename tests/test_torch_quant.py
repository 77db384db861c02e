"""stcd_tpu_torch/serving/quant.py against stcd_tpu/serving/quant.py.

(a) The cases of tests/test_serving_quant.py (the site mechanics and the int8
    arithmetic) on the port's modules, each against the JAX functions on the
    same conv: one quantized conv equals JAX's to 1e-6 (both take the exact
    int32 sums; the port's CPU path by a float64 conv of the integer values),
    the relative error of a 576-deep conv stays under 2 %, a zero scale and
    the narrow and grouped sites stay float bit for bit, the scale is the max
    over the batches, and a site-count mismatch raises both ways. The JAX case
    of positional conv arguments has no torch counterpart; in its place the
    UNet decoder block's split first conv takes JAX's two sites.
(b) Whole models against JAX on one set of weights: SegCD-r18 at 32x32, a
    narrow ChangeFormerV6 and BIT dd8 at 64x64. The conv-site sequence and the
    NaN pattern are JAX's, the scales agree to rtol 1e-5, and the int8 outputs
    agree with JAX's int8 outputs within 2 % of their norm, with the same
    decision (the sign of SegCD's change logit, the argmax of the 2-class
    heads) at 99 % of the pixels or more. Not to float32 precision: both sides
    take the same int32 sums of the same quantized values, but the two float
    forwards differ by about 1e-6, and an activation that close to a half step
    of its site's scale rounds to the other integer (measured on the narrow V6:
    1 or 2 such elements at each of 4 sites). A step moves every later site's
    input, the next sites round other elements the other way, and the
    difference grows through the network: at these inputs the port's int8
    output is off JAX's by 0 (SegCD), 0.86 % (V6) and 0.21 % (BIT) of its
    norm, while JAX's own BIT int8 output moves by 0.158 at most when its
    input moves by 1e-6 relative.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from stcd_tpu.serving import quant as jq
from stcd_tpu_torch.serving import quant as tq

INT8_REL = 0.02
DECISIONS = 0.99


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jconv(x, k, **kw):
    return jax.lax.conv_general_dilated(x, k, (1, 1), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"), **kw)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _conv(k, groups=1, bias=False):
    """A 3x3 'same' nn.Conv2d holding the HWIO kernel ``k``."""
    cin, cout = k.shape[2] * groups, k.shape[3]
    m = nn.Conv2d(cin, cout, 3, padding=1, groups=groups, bias=bias)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))))
    return m


def _run(m, x):
    with torch.no_grad():
        return m(_nchw(x)).numpy().transpose(0, 2, 3, 1)


def test_quantized_conv_matches_jax_and_manual_int8():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1.5, (2, 8, 8, 32)).astype(np.float32)
    k = rng.normal(0, 0.1, (3, 3, 32, 16)).astype(np.float32)
    m = _conv(k)
    fn = lambda a: m(a)
    scales = tq.calibrate_conv_scales(m, fn, [(_nchw(x),)])
    jfn = lambda a: _jconv(a, jnp.asarray(k))
    jscales = jq.calibrate_conv_scales(jfn, [(jnp.asarray(x),)])
    assert scales.shape == jscales.shape == (1,)
    assert scales[0] == pytest.approx(float(np.abs(x).max()), rel=1e-6)
    np.testing.assert_allclose(scales, jscales, rtol=1e-6)

    with torch.no_grad():
        got = tq.quantize_fn(m, fn, scales)(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    want = np.asarray(jq.quantize_fn(jfn, jscales)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    a_s = scales[0] / 127.0
    xq = np.clip(np.round(x / a_s), -127, 127).astype(np.int8)
    w_s = np.abs(k).max(axis=(0, 1, 2), keepdims=True) / 127.0
    kq = np.clip(np.round(k / w_s), -127, 127).astype(np.int8)
    y32 = _jconv(jnp.asarray(xq), jnp.asarray(kq), preferred_element_type=jnp.int32)
    np.testing.assert_allclose(got, np.asarray(y32, np.float32) * (a_s * w_s),
                               rtol=1e-6, atol=1e-6)


def test_quantized_conv_error_is_small_and_the_bias_stays_float():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 16, 16, 64)).astype(np.float32)
    m = _conv(rng.normal(0, 0.05, (3, 3, 64, 64)).astype(np.float32), bias=True)
    with torch.no_grad():
        m.bias.copy_(torch.from_numpy(rng.normal(0, 1, 64).astype(np.float32)))
    fn = lambda a: m(a)
    q = tq.quantize_fn(m, fn, tq.calibrate_conv_scales(m, fn, [(_nchw(x),)]))
    ref = _run(m, x)
    with torch.no_grad():
        got = q(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    bias = m.bias.detach().numpy()
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref - bias)
    assert rel < 0.02, rel  # about 8-bit relative error over a 576-deep sum


def test_zero_calibration_scale_stays_float():
    rng = np.random.default_rng(2)
    m = _conv(rng.normal(0, 0.1, (3, 3, 32, 16)).astype(np.float32))
    fn = lambda a: m(a)
    scales = tq.calibrate_conv_scales(m, fn, [(torch.zeros(2, 32, 8, 8),)])
    assert scales.shape == (1,) and scales[0] == 0.0
    assert tq.n_quantized_sites(scales) == 0
    x = rng.normal(0, 1.5, (2, 8, 8, 32)).astype(np.float32)
    with torch.no_grad():
        got = tq.quantize_fn(m, fn, scales)(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(got, _run(m, x))


def test_calibration_takes_the_max_over_batches():
    rng = np.random.default_rng(3)
    m = _conv(rng.normal(0, 0.1, (3, 3, 32, 16)).astype(np.float32))
    calls = [0]

    def fn(a):
        calls[0] += 1
        return m(a)

    batches = [(_nchw(rng.normal(0, 1, (2, 8, 8, 32)).astype(np.float32)),)
               for _ in range(3)]
    scales = tq.calibrate_conv_scales(m, fn, batches)
    assert scales.shape == (1,) and calls[0] == 3  # one forward a batch
    assert scales[0] == pytest.approx(max(float(b[0].abs().max()) for b in batches),
                                      rel=1e-6)
    assert not hasattr(m, "__dict__") or "forward" not in m.__dict__  # hooks removed


def test_narrow_grouped_and_transposed_sites_stay_float():
    """C_in < min_in_channels and depthwise convs take a NaN slot, as in JAX;
    a ConvTranspose2d takes none, as flax's ConvTranspose is no site of the
    JAX interception; every output is bitwise the float one."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (1, 8, 8, 8)).astype(np.float32)
    k_narrow = rng.normal(0, 0.1, (3, 3, 8, 32)).astype(np.float32)
    k_dw = rng.normal(0, 0.1, (3, 3, 1, 32)).astype(np.float32)
    model = nn.Sequential(_conv(k_narrow), _conv(k_dw, groups=32),
                          nn.ConvTranspose2d(32, 32, 4, 2, 1))
    fn = lambda a: model(a)
    scales = tq.calibrate_conv_scales(model, fn, [(_nchw(x),)])

    def jfn(a):
        y = _jconv(a, jnp.asarray(k_narrow))
        return jax.lax.conv_general_dilated(y, jnp.asarray(k_dw), (1, 1), "SAME",
                                            feature_group_count=32,
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    jscales = jq.calibrate_conv_scales(jfn, [(jnp.asarray(x),)])
    assert scales.shape == jscales.shape == (2,) and np.isnan(scales).all()
    assert np.isnan(jscales).all()
    with torch.no_grad():
        np.testing.assert_array_equal(tq.quantize_fn(model, fn, scales)(_nchw(x)).numpy(),
                                      model(_nchw(x)).numpy())


def test_decoder_block_split_conv_takes_jax_sites():
    """The UNet decoder block's first conv is two JAX sites (the upsample-
    composed dilated conv of x, then the conv of the skip; one where there is
    no skip): the port's block takes the same slots with the same scales, and
    its int8 output is JAX's."""
    from stcd_tpu.decoders.unet import DecoderBlock as JaxBlock
    from stcd_tpu_torch.convert.from_flax import _bn, _conv_w
    from stcd_tpu_torch.decoders.unet import DecoderBlock
    from test_torch_segcd import perturb

    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 4, 4, 32)).astype(np.float32)
    skip = rng.normal(0, 2, (2, 8, 8, 24)).astype(np.float32)
    for with_skip in (True, False):
        s = skip if with_skip else None
        jblock = JaxBlock(16)
        v = perturb(jblock.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                None if s is None else jnp.asarray(s)), 5)
        jfn = lambda a, b=None: jblock.apply(v, a, b)
        port = DecoderBlock(32, 24 if with_skip else 0, 16).eval()
        sd = {}
        for c in ("conv1", "conv2"):
            sd[f"{c}.0.weight"] = _conv_w(v["params"][c]["conv"]["kernel"])
            _bn(sd, f"{c}.1", v["params"][c]["bn"], v["batch_stats"][c]["bn"])
        port.load_state_dict(sd)
        fn = lambda a, b=None: port(a, b)
        jargs = (jnp.asarray(x),) + (() if s is None else (jnp.asarray(s),))
        targs = (_nchw(x),) + (() if s is None else (_nchw(s),))
        jscales = jq.calibrate_conv_scales(jfn, [jargs])
        scales = tq.calibrate_conv_scales(port, fn, [targs])
        assert scales.shape == jscales.shape == ((3,) if with_skip else (2,))
        np.testing.assert_allclose(scales, jscales, rtol=1e-5)
        want = np.asarray(jq.quantize_fn(jfn, jscales)(*jargs))
        with torch.no_grad():
            got = tq.quantize_fn(port, fn, scales)(*targs).numpy().transpose(0, 2, 3, 1)
            flt = port(*targs).numpy().transpose(0, 2, 3, 1)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        assert np.abs(got - flt).max() > 0  # it did run in int8


def test_site_count_mismatch_raises():
    rng = np.random.default_rng(4)
    x = _nchw(rng.normal(0, 1, (1, 8, 8, 32)).astype(np.float32))
    m = _conv(rng.normal(0, 0.1, (3, 3, 32, 32)).astype(np.float32))
    one = lambda a: m(a)
    two = lambda a: m(m(a))
    scales = tq.calibrate_conv_scales(m, one, [(x,)])
    with torch.no_grad():
        with pytest.raises(ValueError, match="beyond calibration table"):
            tq.quantize_fn(m, two, scales)(x)
        with pytest.raises(ValueError, match="calibration table has"):
            tq.quantize_fn(m, one, tq.calibrate_conv_scales(m, two, [(x,)]))(x)


# --- whole models ---

def _segcd():
    from stcd_tpu.models import segcd as jsegcd
    from stcd_tpu_torch.convert.from_flax import unetseg_from_flax
    from stcd_tpu_torch.models import segcd as tsegcd
    from test_torch_segcd import DEC, perturb
    jmodel = jsegcd.SegCD(encoder_name="resnet18", classes=1, decoder_channels=DEC)
    z = jnp.zeros((1, 32, 32, 3))
    v = perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(0), z, z), 7)
    port = tsegcd.SegCD("resnet18", decoder_channels=DEC, classes=1)
    port.load_state_dict(unetseg_from_flax(v["params"], v["batch_stats"]))
    return (lambda a, b: jmodel.apply(v, a, b)[2]), port, (lambda a, b: port(a, b)[2]), 32


def _v6():
    from test_torch_changeformer import JaxNarrowV6, NARROW, NARROW_EMBED, _perturb
    from stcd_tpu_torch.convert.from_flax import changeformer_v6_from_flax
    from stcd_tpu_torch.models.changeformer import ChangeFormerV6
    jmodel = JaxNarrowV6()
    z = jnp.zeros((1, 64, 64, 3))
    v = _perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(0), z, z), 1)
    port = ChangeFormerV6(embed_dim=NARROW_EMBED, **NARROW)
    port.load_state_dict(changeformer_v6_from_flax(v["params"], v["batch_stats"]))
    return (lambda a, b: jmodel.apply(v, a, b)[-1]), port, (lambda a, b: port(a, b)[-1]), 64


def _bit():
    from stcd_tpu.models.factory import define_G as jax_define_G
    from stcd_tpu_torch.models.factory import define_G
    from test_torch_bit import _init, _load
    jmodel = jax_define_G("base_transformer_pos_s4_dd8")
    v = _init(jmodel, seed=1)
    port = _load(define_G("base_transformer_pos_s4_dd8"), v)
    return (lambda a, b: jmodel.apply(v, a, b)), port, (lambda a, b: port(a, b)), 64


@pytest.mark.parametrize("build", [_segcd, _v6, _bit], ids=["segcd_r18", "v6_narrow",
                                                             "bit_dd8"])
def test_model_sites_scales_and_int8_outputs_match_jax(build):
    jfn, port, fn, hw = build()
    port.eval()
    rng = np.random.default_rng(9)
    a, b = (rng.uniform(0, 1, (2, hw, hw, 3)).astype(np.float32) for _ in range(2))
    jscales = jq.calibrate_conv_scales(jfn, [(jnp.asarray(a), jnp.asarray(b))])
    scales = tq.calibrate_conv_scales(port, fn, [(_nchw(a), _nchw(b))])
    assert scales.shape == jscales.shape and scales.shape[0] > 10
    np.testing.assert_array_equal(np.isnan(scales), np.isnan(jscales))
    np.testing.assert_allclose(scales, jscales, rtol=1e-5)
    assert 0 < tq.n_quantized_sites(scales) == jq.n_quantized_sites(jscales)
    want = np.asarray(jax.jit(jq.quantize_fn(jfn, jscales))(jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = tq.quantize_fn(port, fn, scales)(_nchw(a), _nchw(b)).numpy()
        flt = fn(_nchw(a), _nchw(b)).numpy()
    got = got.transpose(0, 2, 3, 1)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= INT8_REL, rel
    decide = (lambda o: o[..., 0] > 0) if want.shape[-1] == 1 else (lambda o: o.argmax(-1))
    assert np.mean(decide(got) == decide(want)) >= DECISIONS
    assert np.abs(got - flt.transpose(0, 2, 3, 1)).max() > 0  # it did run in int8
