"""int8 serving across the whole define_G zoo (stcd_tpu_torch/serving/quant.py
through cli.predict's build_model, make_base_fn and quantize_base_fn), against
stcd_tpu/serving/quant.py.

For each of the 24 keys at 64x64 with seeded weights (seed 0) on the CPU:
calibrate on one batch, run the quantized forward, and require finite
P(changed) in [0, 1], an output that differs from the float one, and the JAX
package's conv-site sequence: which sites there are and which stay float
(grouped, narrow), site by site. JAX's sequence is read here off its own
interception (``stcd_tpu.serving.quant._intercept_convs``) while
``jax.eval_shape`` traces the JAX model of the same key and sizes (no
compile). The six ViG keys' int8 forwards are held against JAX's on one set of weights
in tests/test_torch_quant_vig.py.
"""

import argparse

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stcd_tpu.models.factory import define_G as jax_define_G
from stcd_tpu.serving import quant as jq
from stcd_tpu_torch.cli import predict as cli_predict
from stcd_tpu_torch.models.factory import NET_G_KEYS
from stcd_tpu_torch.serving import quant as tq

SIZE = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_site_flags(net_G: str, batch: int = 2) -> list:
    """For each conv site of JAX's model of ``net_G`` (n_class 2, embed_dim
    64, img_size SIZE), in call order, whether JAX's quantize_fn runs it in
    int8: the model traced with ``jax.eval_shape`` under JAX's own
    interception and site rule."""
    jmodel = jax_define_G(net_G, n_class=2, embed_dim=64, img_size=SIZE)
    x = jax.ShapeDtypeStruct((batch, SIZE, SIZE, 3), jnp.float32)
    variables = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, x)
    flags = []

    def factory(orig):
        def wrapper(lhs, rhs, *args, **kwargs):
            kw = jq._normalize_conv_args(args, kwargs)
            flags.append(bool(jq._site_quantizable(lhs, rhs, kw, 16)))
            return orig(lhs, rhs, **kw)
        return wrapper

    with jq._intercept_convs(factory):
        jax.eval_shape(jmodel.apply, variables, x, x)
    return flags


def test_the_zoo_keys_are_jax_keys():
    """Every port key names a JAX define_G model (the sites of (a) come from
    it)."""
    for net_G in NET_G_KEYS:
        assert jax_define_G(net_G, n_class=2, embed_dim=64, img_size=SIZE) is not None


@pytest.mark.parametrize("net_G", NET_G_KEYS)
def test_int8_forward_of_every_zoo_key(net_G, capsys):
    args = argparse.Namespace(net_G=net_G, n_class=2, embed_dim=64, tile=SIZE, device="cpu",
                              init_seed=0, load_path=None, weights=None, bf16=False,
                              int8=True)
    model = cli_predict.build_model(args)
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32))
            for _ in range(2))
    fn = cli_predict.make_base_fn(args, model)
    with torch.inference_mode():
        qfn, scales = cli_predict.quantize_base_fn(model, fn, a, b)
        out = qfn(a, b).numpy()
        flt = fn(a, b).numpy()
    flags = jax_site_flags(net_G)
    sites, floats = len(flags), flags.count(False)
    assert sites > 10
    np.testing.assert_array_equal(np.isnan(scales), ~np.array(flags))
    assert tq.n_quantized_sites(scales) == sites - floats  # seeded inputs: no zero scale
    assert f"int8: {sites - floats}/{sites} conv sites quantized" in capsys.readouterr().out
    assert out.shape == (2, SIZE, SIZE, 1) and np.isfinite(out).all()
    assert out.min() >= 0.0 and out.max() <= 1.0
    assert np.abs(out - flt).max() > 0  # it did run in int8
