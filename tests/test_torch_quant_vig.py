"""The six ViG keys in int8 (stcd_tpu_torch/serving/quant.py) against
stcd_tpu/serving/quant.py on one set of weights: tests/test_torch_changevig.py's
``_vig`` (JAX's variables drawn with numpy, converted to the port; embed 32,
64x64, batch 2), on JAX's neighbour indices as that file holds the float
models.

(a) Calibration: the NaN pattern of ``calibrate_conv_scales`` is JAX's site by
    site, and the scales agree to SCALE_RTOL (measured: at most 3.9e-5; a
    scale is the largest |input| of its site, and these models' float
    forwards differ from JAX's by up to 3e-4 of the largest output,
    tests/test_torch_changevig.py).
(b) The int8 forward, site by site. JAX's int8 forward (``quantize_fn`` with
    JAX's scales) records each conv site's input and output, and each int8
    site's input and kernel codes; the port's int8 forward with the same
    scales then takes JAX's input at every site and JAX's codes at every int8
    product. The port's own codes of JAX's input equal JAX's but at no more
    than CODE_FLIPS of the elements, and there by one step (measured: at most
    3.9e-5 of an input's codes): XLA's and torch's float32 divisions by the
    scale differ in the last bit, and a value on a half step rounds the other
    way. Each site's output equals JAX's plus the conv's bias within
    SITE_RTOL of its largest value (measured 2.6e-7), the port's own input at
    each site is within INPUT_TOL of JAX's, relative to its largest |input|
    (the float32 ops between two sites; measured 1.7e-6), and the change map
    is within MAP_RTOL of JAX's int8 output by norm (measured 1e-7), with the
    same argmax at DECISIONS of the pixels or more. The site inputs and codes
    are fed because the comparison of two free-running int8 forwards measures
    these models, not the port: one code rounded the other way grows through
    the later sites, and at these weights (outputs near 100) the unfed change
    maps, on JAX's scales and neighbours, differ by 6 % (ChangeGNNV1) to 46 %
    (ChangeGNNV2_abs) of their norm, while the port's own int8 output moves by
    4 % when its input moves by 1e-6 relative (ChangeGNNV1, its neighbours
    held).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stcd_tpu.serving import quant as jq
from stcd_tpu_torch.serving import quant as tq

from test_torch_changeformer import _inputs, _nchw
from test_torch_changevig import HW, N, VIG_KEYS, _vig, jax_neighbours  # noqa: F401

SCALE_RTOL = 1e-4
SITE_RTOL = 1e-6
INPUT_TOL = 1e-5
CODE_FLIPS = 1e-4
MAP_RTOL = 1e-5
DECISIONS = 0.99  # tests/test_torch_quant.py's


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_int8_sites(monkeypatch, vfn, variables, scales, a, b):
    """JAX's int8 change map; each conv site's (input, output) in call order;
    and each int8 site's (input codes, kernel codes): recorded around and
    inside quantize_fn's own interception."""
    sites, codes = [], []
    intercept = jq._intercept_convs

    def record(into, *arrays):
        jax.debug.callback(lambda *xs: into.append(tuple(np.array(x) for x in xs)), *arrays,
                           ordered=True)

    def around(inner):
        def wrapper(lhs, rhs, *args, **kwargs):
            y = inner(lhs, rhs, *args, **kwargs)
            record(sites, lhs, y)
            return y
        return wrapper

    def inside(orig):
        def wrapper(lhs, rhs, *args, **kwargs):
            if lhs.dtype == jnp.int8:
                record(codes, lhs, rhs)
            return orig(lhs, rhs, *args, **kwargs)
        return wrapper

    @contextlib.contextmanager
    def recording(factory):
        with intercept(lambda orig: around(factory(inside(orig)))):
            yield

    monkeypatch.setattr(jq, "_intercept_convs", recording)
    try:
        int8 = jax.jit(lambda v, x, y: jq.quantize_fn(lambda x, y: vfn(v, x, y), scales)(x, y))
        out = np.asarray(int8(variables, jnp.asarray(a), jnp.asarray(b)))
    finally:
        monkeypatch.setattr(jq, "_intercept_convs", intercept)
    return out, sites, codes


@pytest.mark.parametrize("net_G", VIG_KEYS)
def test_vig_int8_sites_scales_and_outputs_match_jax(net_G, jax_neighbours, monkeypatch):
    feed, _ = jax_neighbours
    jmodel, variables, port = _vig(net_G)
    port.eval()
    a, b = _inputs(N, HW, seed=11)
    vfn = lambda v, x, y: jmodel.apply(v, x, y)[-1]  # noqa: E731  the change map
    fn = lambda x, y: port(x, y)[-1]  # noqa: E731
    jscales = jq.calibrate_conv_scales(vfn, [(variables, jnp.asarray(a), jnp.asarray(b))])
    feed(runs=2)  # the port's calibration and float forwards take JAX's float neighbours
    with torch.no_grad():
        scales = tq.calibrate_conv_scales(port, fn, [(_nchw(a), _nchw(b))])
        flt = fn(_nchw(a), _nchw(b)).numpy().transpose(0, 2, 3, 1)
    assert scales.shape == jscales.shape and scales.shape[0] > 10
    np.testing.assert_array_equal(np.isnan(scales), np.isnan(jscales))
    np.testing.assert_allclose(scales, jscales, rtol=SCALE_RTOL)
    assert 0 < tq.n_quantized_sites(scales) == jq.n_quantized_sites(jscales)

    want, records, codes = jax_int8_sites(monkeypatch, vfn, variables, jscales, a, b)
    assert len(records) == jscales.shape[0]
    assert len(codes) == jq.n_quantized_sites(jscales)
    feed()  # the port's int8 forward takes JAX's int8 neighbours
    input_errs, site_errs, flips = [], [], []
    conv, pair, int_conv = tq._Sites.conv, tq._Sites.pair_grouped_conv, tq._int_conv

    def fed_conv(sites, m, x):
        lhs, out = records.pop(0)
        theirs = torch.from_numpy(np.ascontiguousarray(lhs.transpose(0, 3, 1, 2)))
        assert theirs.shape == x.shape
        input_errs.append(float((x - theirs).abs().max() / theirs.abs().max()))
        y = conv(sites, m, theirs)
        ref = out.transpose(0, 3, 1, 2) + (0 if m.bias is None
                                           else m.bias.numpy().reshape(1, -1, 1, 1))
        site_errs.append(float(np.abs(y.numpy() - ref).max() / np.abs(ref).max()))
        return y

    def fed_pair(sites, m, x):  # JAX's two float depthwise sites, not fed
        del records[:2]
        return pair(sites, m, x)

    def fed_int_conv(xq, wq, *args):
        jxq, jwq = codes.pop(0)
        theirs = [torch.from_numpy(np.ascontiguousarray(c).astype(np.float32))
                  for c in (jxq.transpose(0, 3, 1, 2), jwq.transpose(3, 2, 0, 1))]
        for own, their in zip((xq, wq), theirs):
            step = (own - their).abs()
            assert step.max() <= 1  # a half step rounded the other way, no more
            flips.append(float((step > 0).float().mean()))
        return int_conv(*theirs, *args)

    monkeypatch.setattr(tq._Sites, "conv", fed_conv)
    monkeypatch.setattr(tq._Sites, "pair_grouped_conv", fed_pair)
    monkeypatch.setattr(tq, "_int_conv", fed_int_conv)
    with torch.no_grad():
        got = tq.quantize_fn(port, fn, jscales)(_nchw(a), _nchw(b)).numpy()
    got = got.transpose(0, 2, 3, 1)
    assert not records and not codes
    assert max(flips) <= CODE_FLIPS, (int(np.argmax(flips)), max(flips))
    assert max(site_errs) <= SITE_RTOL, (int(np.argmax(site_errs)), max(site_errs))
    assert max(input_errs) <= INPUT_TOL, (int(np.argmax(input_errs)), max(input_errs))
    assert got.shape == want.shape == (N, HW, HW, 2)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= MAP_RTOL, rel
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= DECISIONS
    assert np.abs(got - flt).max() > 0  # it did run in int8
    print(f"{net_G}: scales {np.nanmax(np.abs(scales / jscales - 1)):.2e}, site outputs "
          f"{max(site_errs):.2e}, site inputs {max(input_errs):.2e}, codes off "
          f"{max(flips):.2e}, change map {rel:.2e}")
