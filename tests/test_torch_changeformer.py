"""stcd_tpu_torch ChangeFormerV6 against the JAX model, on one set of weights.

(a) a narrow V6 copy against the JAX SegFormerEncoder + DecoderTransformerV3
    composed as ChangeFormerV6.__call__ does, all 5 multi-scale outputs;
(b) full width: changeformer_v6_from_flax and then convert_changeformer_v6
    give back the JAX params and batch_stats exactly;
(c) a full-width forward at 64x64 against JAX ChangeFormerV6(embed_dim=256).

Forward only, under torch.no_grad. The tolerance is atol 2e-4, rtol 1e-3:
the convolutions sum in another order in oneDNN than in XLA:CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from stcd_tpu.convert.torch_to_flax import convert_changeformer_v6
from stcd_tpu.models.changeformer import ChangeFormerV6 as JaxChangeFormerV6
from stcd_tpu.models.changeformer import DecoderTransformerV3, SegFormerEncoder
from stcd_tpu_torch.convert.from_flax import changeformer_v6_from_flax
from stcd_tpu_torch.models.changeformer import ChangeFormerV6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread for this file's tests, as tests/test_torch_cli.py
    has: the suite runs several files at once, and at these sizes more threads
    cost CPU time and buy little."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NARROW = dict(embed_dims=(16, 32, 48, 64), depths=(1, 1, 2, 1),
              num_heads=(1, 2, 2, 4), sr_ratios=(8, 4, 2, 1))
NARROW_EMBED = 32
ATOL, RTOL = 2e-4, 1e-3


class JaxNarrowV6(nn.Module):
    """JAX ChangeFormerV6.__call__ with the narrow encoder config."""

    @nn.compact
    def __call__(self, x1, x2, train=False):
        enc = SegFormerEncoder(first_patch=7, first_stride=4, patch_size=7,
                               qkv_bias=True, drop_rate=0.1, attn_drop_rate=0.1,
                               drop_path_rate=0.1, name="Tenc_x2", **NARROW)
        n = x1.shape[0]
        feats = enc(jnp.concatenate([x1, x2], axis=0), train)
        return DecoderTransformerV3(NARROW_EMBED, 2, False, name="TDec_x2")(
            [f[:n] for f in feats], [f[n:] for f in feats], train)


def _perturb(variables, seed):
    """Make norm scales/biases, biases, PReLU alphas and BN running stats
    non-trivial, so that every parameter kind shows in the outputs."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1].key)
        x = np.asarray(x)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        if name.startswith("prelu"):
            return rng.uniform(0.0, 0.5, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _inputs(batch, hw, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, hw, hw, 3)).astype(np.float32),
            rng.standard_normal((batch, hw, hw, 3)).astype(np.float32))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _compare(jax_model, variables, port, a, b):
    wants = jax.jit(jax_model.apply)(variables, jnp.asarray(a), jnp.asarray(b))
    port.load_state_dict(changeformer_v6_from_flax(variables["params"],
                                                   variables["batch_stats"]))
    with torch.no_grad():
        gots = port.eval()(_nchw(a), _nchw(b))
    assert len(gots) == len(wants) == 5  # 4 side predictions + full-res
    for i, (got, want) in enumerate(zip(gots, wants)):
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                                   np.asarray(want), atol=ATOL, rtol=RTOL,
                                   err_msg=f"multi-scale output {i}")


def test_narrow_v6_matches_jax():
    a, b = _inputs(2, 64, seed=0)
    model = JaxNarrowV6()
    variables = _perturb(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(a),
                                             jnp.asarray(b)), seed=1)
    port = ChangeFormerV6(embed_dim=NARROW_EMBED, **NARROW)
    _compare(model, variables, port, a, b)


@pytest.fixture(scope="module")
def full_v6():
    """JAX full-width V6 variables from a 64x64 init, perturbed."""
    model = JaxChangeFormerV6(output_nc=2, decoder_softmax=False, embed_dim=256)
    z = jnp.zeros((1, 64, 64, 3))
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), z, z)
    return model, _perturb(variables, seed=2)


def test_full_v6_converter_round_trip_is_exact(full_v6):
    _, variables = full_v6
    port = ChangeFormerV6()
    port.load_state_dict(changeformer_v6_from_flax(variables["params"],
                                                   variables["batch_stats"]))
    params, stats = convert_changeformer_v6(
        {k: v.numpy() for k, v in port.state_dict().items()}, depths=(3, 3, 4, 3))
    for want_tree, got_tree in ((variables["params"], params),
                                (variables["batch_stats"], stats)):
        want = dict(jax.tree_util.tree_flatten_with_path(want_tree)[0])
        got = dict(jax.tree_util.tree_flatten_with_path(got_tree)[0])
        assert {jax.tree_util.keystr(p) for p in want} == \
            {jax.tree_util.keystr(p) for p in got}
        got_by_key = {jax.tree_util.keystr(p): v for p, v in got.items()}
        for p, v in want.items():
            g = got_by_key[jax.tree_util.keystr(p)]
            assert np.array_equal(np.asarray(g), np.asarray(v)), jax.tree_util.keystr(p)


def test_full_v6_forward_matches_jax(full_v6):
    model, variables = full_v6
    a, b = _inputs(1, 64, seed=3)
    _compare(model, variables, ChangeFormerV6(), a, b)
