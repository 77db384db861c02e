"""stcd_tpu_torch ChangeFormer V1-V5, the MiT encoders and the ICNR
PixelShuffle layer against the JAX package, on one set of weights.

Each model is built at its published width by both ``define_G`` factories,
initialised by JAX at 64x64, perturbed with numpy, carried to the port by
``convert/from_flax.py`` and held to:
(a) the eval forward at 64x64, batch 1, every multi-scale output, atol 2e-4,
    rtol 1e-3 (the convolutions sum in another order in oneDNN than in
    XLA:CPU, as in tests/test_torch_changeformer.py);
(b) the converter round trip: the JAX converter of the port's state_dict gives
    the JAX variables back exactly;
(c) for V4, one train-mode gradient of a loss on every output against
    jax.grad, with the decoder's Dropout(0.6) the identity on both sides (V4's
    encoder has no dropout and no DropPath): every gradient within 2e-3 of the
    model's largest gradient entry. Not of each tensor's own largest entry:
    the conv biases and the projections that feed a train-mode BatchNorm have
    gradients that nearly cancel, and there both sides are float32 noise
    (measured on this test's inputs against a float64 run of the port: the
    port's float32 is off by up to 6e-2 of such a tensor's own largest entry,
    JAX's by 1e-1; against the model's largest gradient both are off by
    8.3e-4, and they differ from each other by 4.6e-4).
Then mit_b0 to mit_b5 (the smp contract with the zero-channel level, mit_b0
against JAX) and PixelShuffle / ICNR.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stcd_tpu.convert import torch_to_flax as t2f
from stcd_tpu.models.factory import define_G as jax_define_G
from stcd_tpu_torch.convert import from_flax
from stcd_tpu_torch.models.factory import define_G, init_weights

ATOL, RTOL = 2e-4, 1e-3
GRAD_TOL = 2e-3
HW = 64

# net_G -> (port converter, JAX converter of a state_dict, multi-scale outputs)
MODELS = {
    "ChangeFormerV1": (from_flax.changeformer_v1_from_flax,
                       lambda sd: t2f.convert_changeformer_v1(sd), 1),
    "ChangeFormerV2": (from_flax.changeformer_v2_from_flax,
                       lambda sd: t2f.convert_changeformer_v2(sd), 1),
    "ChangeFormerV3": (from_flax.changeformer_v3_from_flax,
                       lambda sd: t2f.convert_changeformer_v3(sd), 1),
    "ChangeFormerV4": (from_flax.changeformer_v4_from_flax,
                       lambda sd: t2f.convert_changeformer_v4(sd), 6),
    "ChangeFormerV5": (from_flax.changeformer_v5_from_flax,
                       lambda sd: t2f.convert_changeformer_v6(sd, depths=(3, 6, 16, 3)), 5),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _perturb(variables, seed):
    """Non-trivial norm scales and biases, biases, PReLU slopes and BatchNorm
    statistics, so that every parameter kind shows in the outputs."""
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


def _inputs(seed, batch=1):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((batch, HW, HW, 3)).astype(np.float32)
                 for _ in range(2))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _outs(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _variables(model, seed, *inputs):
    """JAX's variable tree for ``model`` with numpy values: kernels normal with
    variance 1 / fan_in, then ``_perturb``."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            *[jnp.asarray(x) for x in inputs])

    def leaf(x):
        fan_in = int(np.prod(x.shape[:-1])) if len(x.shape) > 1 else 1
        return (rng.standard_normal(x.shape) / np.sqrt(fan_in)).astype(np.float32)

    return _perturb(jax.tree_util.tree_map(leaf, shapes), seed)


def _setup(net_G, seed):
    """(JAX model, perturbed variables, port model with them)."""
    model = jax_define_G(net_G, embed_dim=256)
    variables = _variables(model, seed, *_inputs(seed))
    port = define_G(net_G, embed_dim=256)
    port.load_state_dict(MODELS[net_G][0](variables["params"],
                                          variables.get("batch_stats", {})))
    return model, variables, port


@pytest.fixture(scope="module")
def zoo():
    return {net_G: _setup(net_G, seed) for seed, net_G in enumerate(MODELS)}


@pytest.mark.parametrize("net_G", list(MODELS))
def test_eval_forward_matches_jax(zoo, net_G):
    model, variables, port = zoo[net_G]
    a, b = _inputs(seed=10)
    wants = _outs(jax.jit(model.apply)(variables, jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        gots = _outs(port.eval()(_nchw(a), _nchw(b)))
    assert len(gots) == len(wants) == MODELS[net_G][2]
    for i, (got, want) in enumerate(zip(gots, wants)):
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                                   atol=ATOL, rtol=RTOL, err_msg=f"{net_G} output {i}")


@pytest.mark.parametrize("net_G", list(MODELS))
def test_converter_round_trip_is_exact(zoo, net_G):
    _, variables, port = zoo[net_G]
    params, stats = MODELS[net_G][1]({k: v.numpy() for k, v in port.state_dict().items()})
    for want_tree, got_tree in ((variables["params"], params),
                                (variables.get("batch_stats", {}), stats)):
        want = {jax.tree_util.keystr(p): v
                for p, v in jax.tree_util.tree_flatten_with_path(want_tree)[0]}
        got = {jax.tree_util.keystr(p): v
               for p, v in jax.tree_util.tree_flatten_with_path(got_tree)[0]}
        assert want.keys() == got.keys(), net_G
        for key, v in want.items():
            assert np.array_equal(np.asarray(got[key]), np.asarray(v)), key


def test_v4_train_mode_gradients_match_jax(zoo, monkeypatch):
    """With the decoder's Dropout(0.6) the identity on both sides, V4's
    train-mode forward is deterministic: the gradient of sum_i mean(out_i^2)
    over the six outputs, for every parameter, within GRAD_TOL of the largest
    (module docstring, (c))."""
    from flax import linen as nn
    from stcd_tpu_torch.layers.stochastic import Dropout
    monkeypatch.setattr(nn.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None: inputs)
    model, variables, port = zoo["ChangeFormerV4"]
    for mod in port.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    a, b = _inputs(seed=11, batch=2)

    def loss_fn(params):
        outs, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jnp.asarray(a), jnp.asarray(b), True,
                              mutable=["batch_stats"])
        return sum(jnp.mean(o ** 2) for o in outs)

    grads = jax.jit(jax.grad(loss_fn))(variables["params"])
    want = from_flax.changeformer_v4_from_flax(
        grads, jax.tree_util.tree_map(np.zeros_like, variables["batch_stats"]))
    port.load_state_dict(from_flax.changeformer_v4_from_flax(variables["params"],
                                                             variables["batch_stats"]))
    port.train().zero_grad(set_to_none=True)
    sum(torch.mean(o ** 2) for o in port(_nchw(a), _nchw(b))).backward()
    named = dict(port.named_parameters())
    assert set(named) <= set(want)
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, p in named.items():
        err = float(np.abs(p.grad.numpy() - want[name].numpy()).max())
        assert err <= GRAD_TOL * scale, (name, err, scale)


def test_define_g_builds_every_changeformer_with_its_launch_count():
    """The SRA calls of a forward (one attention call each): 16 for V1-V3 (Tenc,
    3+4+6+3), 25 for V4 and 28 for V5; only V5 and V6 read embed_dim, whose
    default is the JAX package's 64; init_weights seeds every one."""
    from stcd_tpu_torch.models import changeformer
    counts = {"ChangeFormerV1": 16, "ChangeFormerV2": 16, "ChangeFormerV3": 16,
              "ChangeFormerV4": 25, "ChangeFormerV5": 28, "ChangeFormerV6": 13}
    for net_G, n in counts.items():
        model = define_G(net_G)
        assert sum(isinstance(m, changeformer.SRAttention) for m in model.modules()) == n
        w = dict(init_weights(model, seed=0).named_parameters())
        w2 = dict(init_weights(define_G(net_G), seed=0).named_parameters())
        assert all(torch.equal(w[k], w2[k]) for k in w), net_G
    assert define_G("ChangeFormerV6").TDec_x2.linear_c1.proj.out_features == 64
    assert define_G("ChangeFormerV5", embed_dim=32).TDec_x2.linear_c1.proj.out_features == 32
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        define_G("SNUNet")


@pytest.mark.parametrize("name", [f"mit_b{i}" for i in range(6)])
def test_mit_encoders_follow_the_smp_contract(name):
    from stcd_tpu_torch.encoders import get_encoder
    from stcd_tpu_torch.encoders.mix_transformer import MIT_CFGS
    enc, channels = get_encoder(name)
    dims = MIT_CFGS[name]["embed_dims"]
    assert channels == (3, 0) + dims
    assert sum(len(getattr(enc, f"block{s}")) for s in range(1, 5)) == \
        sum(MIT_CFGS[name]["depths"])
    if name == "mit_b0":  # the smallest is run; the others share its code
        with torch.no_grad():
            feats = enc.eval()(torch.zeros(1, 3, 64, 64))
        assert [tuple(f.shape[1:]) for f in feats] == \
            [(3, 64, 64), (0, 32, 32)] + [(c, 64 // 2 ** (s + 2), 64 // 2 ** (s + 2))
                                          for s, c in enumerate(dims)]
        enc3, ch3 = get_encoder(name, depth=3)
        assert ch3 == (3, 0, 32, 64) and len(enc3(torch.zeros(1, 3, 64, 64))) == 4
    with pytest.raises(NotImplementedError, match="Queue 1 #9"):
        get_encoder("efficientnet-b0")


def test_mit_b0_matches_jax():
    from stcd_tpu.encoders.mix_transformer import MixTransformerEncoder as JaxMiT
    from stcd_tpu_torch.encoders.mix_transformer import MixTransformerEncoder
    x = np.random.default_rng(5).standard_normal((1, HW, HW, 3)).astype(np.float32)
    model = JaxMiT("mit_b0")
    variables = _variables(model, 6, x)
    port = MixTransformerEncoder("mit_b0")
    port.load_state_dict(from_flax.mix_transformer_from_flax(variables["params"]))
    wants = model.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        gots = port.eval()(_nchw(x))
    assert len(gots) == len(wants) == 6
    for got, want in zip(gots, wants):
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)
    mit = t2f.convert_mix_transformer({k: v.numpy() for k, v in port.state_dict().items()})
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda u, v: np.array_equal(np.asarray(u), np.asarray(v)), mit,
        dict(variables["params"])))


def test_pixel_shuffle_and_icnr_match_jax():
    """pixel_shuffle against the JAX NHWC one, exactly; a PSUp with its conv
    weights carried over against JAX's PSUp; ICNR repeats each of the O
    sub-kernels scale^2 times, so the shuffled output of a constant input is a
    nearest-neighbour upsampling."""
    from stcd_tpu.layers.pixel_shuffle import PSUp as JaxPSUp
    from stcd_tpu.layers.pixel_shuffle import pixel_shuffle as jax_ps
    from stcd_tpu_torch.layers.pixel_shuffle import PSUp, icnr_, pixel_shuffle
    x = np.random.default_rng(7).standard_normal((2, 5, 6, 12)).astype(np.float32)
    np.testing.assert_array_equal(
        pixel_shuffle(_nchw(x), 2).numpy().transpose(0, 2, 3, 1),
        np.asarray(jax_ps(jnp.asarray(x), 2)))
    model = JaxPSUp(3, scale=2)
    variables = model.init(jax.random.PRNGKey(1), jnp.asarray(x))
    k = np.asarray(variables["params"]["conv"]["kernel"])  # (3, 3, 12, 12)
    # the JAX ICNR kernel: each group of scale^2 output channels is one sub-kernel
    assert np.array_equal(k[..., 0::4], k[..., 3::4])
    port = PSUp(12, 3, scale=2)
    port.load_state_dict({"conv.weight": torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
                          "conv.bias": torch.from_numpy(np.asarray(
                              variables["params"]["conv"]["bias"]).copy())})
    with torch.no_grad():
        got = port(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(model.apply(variables, jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)
    w = icnr_(torch.empty(12, 4, 3, 3), scale=2, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(w[4 * o], w[4 * o + r]) for o in range(3) for r in range(4))
    assert 0.2 < float(w.std()) / (2.0 / 36) ** 0.5 < 5.0
    up = pixel_shuffle(torch.nn.functional.conv2d(torch.ones(1, 4, 4, 4), w, padding=1), 2)
    np.testing.assert_array_equal(up[:, :, 2:4:2, 2:6].numpy(),
                                  up[:, :, 3:5:2, 2:6].numpy())


def _cf_new_shapes():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.CF_NEW_SHAPES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", _cf_new_shapes())
def test_attention_plans_take_the_v4_and_v5_shapes(shape, dtype):
    """The attention launch plans at the (B, H, N, M, D) shapes of V4 (D = 16,
    32, 40) and V5 (5 heads) that chip_smoke.py holds on the card: shared
    memory within a block's limit, the blocks' rows covering N, one scratch
    partial for every part. The card run holds the kernels to their plain
    versions there."""
    from stcd_tpu_torch.ops import attention as att
    b, h, n, m, d = shape
    variant = att.select_variant(dtype, m)
    assert variant == ("f32_cuda" if dtype == torch.float32 else "mma_bf16")
    fwd = att.forward_plan(variant, b * h, n, m, d)
    bwd = att.backward_plan(variant, b * h, n, m, d)
    for plan, rows in ((fwd, fwd["rows_per_block"]), (bwd, bwd["rows_per_split"])):
        assert 0 <= plan["smem_bytes"] <= att.MAX_SMEM_BYTES
        assert plan["blocks"] == b * h * -(-n // rows)
    assert fwd["kv_resident"]
    assert (bwd["splits"] - 1) * bwd["rows_per_split"] < n <= bwd["splits"] * bwd["rows_per_split"]
    assert bwd["scratch_shape"] == (b * h, bwd["parts"], m, d)
