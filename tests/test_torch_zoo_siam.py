"""stcd_tpu_torch's CNN change-detection zoo against the JAX package, float32
on the CPU: the FC-EF / FC-Siam UNets (Unet, SiamUnet_sub, SiamUnet_abs,
SiamUnet_conc, SiamUnet_cross_conc), SNUNet, DTCDSCN, IFNet (DSIFN with its
VGG16 base), the CDNet head and the SE layers.

Each model is built by both ``define_G`` factories at the JAX CLI defaults.
Its weights are the JAX model's variables (the tree of its ``init``, taken
with ``jax.eval_shape``) drawn with numpy (``jax_variables``: kernels
N(0, 1 / fan_in), BatchNorm scales and variances in [0.5, 1.5], biases and
means N(0, 0.1), PReLU slopes in [0, 0.5]), carried to the port by
``convert/from_flax.py``. A compiled JAX init of these models costs seconds to
tens of seconds each on a CPU; the tree is the same. Held to:
(a) the eval forward at 32x32, batch 2, within ATOL + RTOL |want| (the
    convolutions sum in another order in oneDNN than in XLA:CPU; measured at
    most 1.7e-6 at outputs of order 1);
(b) the converter round trip: the JAX converter of the port's state_dict gives
    the JAX variables back exactly;
(c) a train-mode forward of SiamUnet_conc and DTCDSCN (Dropout2d the identity
    on both sides inside the test): the loss, the running statistics and every
    parameter's gradient (within GRAD_TOL of the model's largest gradient
    entry, as tests/test_torch_changeformer_zoo.py holds V4);
(d) three CDTrainer steps of SiamUnet_abs under SGD against the JAX trainer;
(e) SNUNet's d2s upsample equal to its transposed conv, define_G's 24 keys,
    models/init.py's rules, max_pool and Dropout2d.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stcd_tpu.convert import torch_to_flax as t2f
from stcd_tpu.models.factory import define_G as jax_define_G
from stcd_tpu_torch.convert import from_flax
from stcd_tpu_torch.models.factory import NET_G_KEYS, define_G

from test_torch_changeformer import _inputs, _nchw

ATOL, RTOL = 2e-5, 1e-4
GRAD_TOL = 2e-3
HW, N = 32, 2

_FUSION = {"Unet": "ef", "SiamUnet_sub": "sub", "SiamUnet_abs": "diff",
           "SiamUnet_conc": "conc", "SiamUnet_cross_conc": "crossconc"}
# net_G -> (port converter of (params, batch_stats), JAX converter of a state_dict)
MODELS = {
    **{k: ((lambda f: lambda p, s: from_flax.siam_unet_from_flax(p, s, f))(f),
           (lambda f: lambda sd: t2f.convert_siam_unet(sd, f))(f))
       for k, f in _FUSION.items()},
    "SNUNet": (from_flax.snunet_from_flax, t2f.convert_snunet),
    "DTCDSCN": (from_flax.dtcdscn_from_flax, t2f.convert_dtcdscn),
    "IFNet": (from_flax.dsifn_from_flax, t2f.convert_dsifn),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread for this file's tests, as tests/test_torch_cli.py
    has: the suite runs several files at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_variables(jax_model, hw, seed, *, args=None):
    """The JAX model's variables, drawn with numpy (module docstring)."""
    z = jnp.zeros((1, hw, hw, 3))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), *(args or (z, z)))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                    ).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name.startswith("prelu"):
            return rng.uniform(0.0, 0.5, s.shape).astype(np.float32)
        if name in ("bias", "mean", "pos_embed"):
            return rng.normal(0, 0.1, s.shape).astype(np.float32)
        raise KeyError(name)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _build(net_G, seed=1):
    jmodel = jax_define_G(net_G, n_class=2, embed_dim=64, img_size=HW)
    variables = jax_variables(jmodel, HW, seed)
    port = define_G(net_G, n_class=2, embed_dim=64, img_size=HW)
    port.load_state_dict(MODELS[net_G][0](variables["params"], variables["batch_stats"]))
    return jmodel, variables, port


@pytest.mark.parametrize("net_G", list(MODELS))
def test_define_g_eval_forward_matches_jax(net_G):
    jmodel, variables, port = _build(net_G)
    a, b = _inputs(N, HW, seed=3)
    want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = port.eval()(_nchw(a), _nchw(b)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == (N, HW, HW, 1 if net_G == "IFNet" else 2)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _snunet_conc():
    from stcd_tpu.models.snunet import SiamNestedUNetConc as J
    from stcd_tpu_torch.models.snunet import SiamNestedUNetConc as T
    return J(out_ch=2), T(out_ch=2), lambda p, s: from_flax.snunet_from_flax(p, s, ecam=False)


def _snunet_d2s():
    from stcd_tpu.models.snunet import SNUNetECAM as J
    from stcd_tpu_torch.models.snunet import SNUNetECAM as T
    return J(out_ch=2, up_mode="d2s"), T(out_ch=2, up_mode="d2s"), from_flax.snunet_from_flax


def _dsifn_aux():
    from stcd_tpu.models.dsifn import DSIFN as J
    from stcd_tpu_torch.models.dsifn import DSIFN as T
    return J(return_aux=True), T(return_aux=True), from_flax.dsifn_from_flax


@pytest.mark.parametrize("build", [_snunet_conc, _snunet_d2s, _dsifn_aux],
                         ids=["snunet_no_ecam", "snunet_d2s", "dsifn_aux"])
def test_variant_eval_forward_matches_jax(build):
    """The options the keys do not reach; DSIFN's four deep-supervision
    sigmoids as well as its output."""
    jmodel, port, convert = build()
    variables = jax_variables(jmodel, HW, seed=2)
    port.load_state_dict(convert(variables["params"], variables["batch_stats"]))
    a, b = _inputs(N, HW, seed=4)
    wants = jax.jit(jmodel.apply)(variables, jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        gots = port.eval()(_nchw(a), _nchw(b))
    if isinstance(wants, tuple):
        wants, gots = [wants[0], *wants[1]], [gots[0], *gots[1]]
        assert len(gots) == 5
    else:
        wants, gots = [wants], [gots]
    for got, want in zip(gots, wants):
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("net_G", list(MODELS) + ["SiamNestedUNetConc", "CDNet"])
def test_converter_round_trip_is_exact(net_G):
    if net_G == "SiamNestedUNetConc":
        jmodel, port, convert = _snunet_conc()
        variables = jax_variables(jmodel, HW, seed=5)
        port.load_state_dict(convert(variables["params"], variables["batch_stats"]))
        jconvert = lambda sd: t2f.convert_snunet(sd, ecam=False)  # noqa: E731
    elif net_G == "CDNet":
        from stcd_tpu.models.segcd import CDNet as J
        from stcd_tpu_torch.models.segcd import CDNet as T
        jmodel, port = J(decoder_channels=(16, 12, 8, 6, 4)), T((16, 12, 8, 6, 4))
        feats = [jnp.zeros((1, 2 ** i, 2 ** i, c)) for i, c in enumerate((16, 12, 8, 6, 4))]
        variables = {"params": jax_variables(jmodel, HW, 5, args=(feats, feats))["params"],
                     "batch_stats": {}}
        port.load_state_dict(from_flax.cdnet_from_flax(variables["params"]))
        jconvert = lambda sd: (t2f.convert_cdnet(sd), {})  # noqa: E731
    else:
        _, variables, port = _build(net_G, seed=5)  # the load is strict
        jconvert = MODELS[net_G][1]
    params, stats = jconvert({k: v.numpy() for k, v in port.state_dict().items()})
    for want_tree, got_tree in ((variables["params"], params),
                                (variables["batch_stats"], stats)):
        want, got = flat(want_tree), flat(got_tree)
        assert set(want) == set(got), net_G
        for key, v in want.items():
            assert np.array_equal(got[key], v), key


def test_state_dict_names_are_the_reference_names():
    names = {k: set(define_G(k).state_dict()) for k in MODELS}
    expect = {
        "SiamUnet_abs": ("conv11.weight", "bn11.running_var", "conv43.bias", "upconv4.weight",
                         "conv43d.weight", "bn43d.weight", "conv12d.bias", "conv11d.weight"),
        "SiamUnet_cross_conc": ("cross_conc1.diff.0.weight", "cross_conc4.diff.1.running_mean",
                                "cross_conc2.conv_res.0.bias", "cross_conc3.conv_res.1.weight"),
        "SNUNet": ("conv0_0.conv1.weight", "conv0_4.bn2.running_var", "Up1_0.up.weight",
                   "Up4_0.up.bias", "ca.fc1.weight", "ca1.fc2.weight", "conv_final.bias"),
        "DTCDSCN": ("firstconv.weight", "firstbn.running_mean", "encoder1.0.se.fc.0.weight",
                    "encoder2.0.downsample.0.weight", "encoder4.2.bn2.weight",
                    "dblock_master.dilate4.bias", "decoder4_master.scse.channel_excitation.2"
                    ".weight", "decoder1_master.scse.spatial_se.0.weight",
                    "decoder2_master.deconv2.bias", "finaldeconv1_master.weight",
                    "finalconv3_master.bias"),
        "IFNet": ("t1_base.features.0.weight", "t1_base.features.28.bias",
                  "t2_base.features.28.bias", "o1_conv1.1.weight", "o5_conv3.2.running_var",
                  "sa3.conv1.weight", "bn_sa5.bias", "ca2.fc1.weight", "trans_conv4.weight",
                  "o5_conv4.bias", "o1_conv3.weight"),
    }
    for net_G, keys in expect.items():
        for key in keys:
            assert key in names[net_G], (net_G, key)
    assert not any(k.startswith("cross_conc") for k in names["SiamUnet_conc"])
    assert "conv11.weight" in names["Unet"]
    # the decoder's stride-1 convs keep the reference's ConvTranspose2d type
    m = define_G("SiamUnet_conc")
    assert isinstance(m.conv43d, torch.nn.ConvTranspose2d) and m.conv43d.stride == (1, 1)
    assert m.conv43d.in_channels == 384 and m.conv12d.in_channels == 48


def test_snunet_d2s_equals_convtranspose():
    """The same parameters in both modes; the outputs agree to float32
    summation order (the product and the transposed conv sum the same four
    terms in another order)."""
    from stcd_tpu_torch.models.snunet import SNUNetECAM
    a, b = (_nchw(x) for x in _inputs(N, HW, seed=6))
    ct = SNUNetECAM(out_ch=2)
    d2s = SNUNetECAM(out_ch=2, up_mode="d2s")
    d2s.load_state_dict(ct.state_dict())
    with torch.no_grad():
        want, got = ct.eval()(a, b), d2s.eval()(a, b)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
    x = torch.randn(2, 8, 5, 7)
    up = d2s.Up1_0.__class__(8, "d2s")
    torch.testing.assert_close(up(x), up.up(x), atol=1e-6, rtol=1e-5)


def test_cdnet_head_and_se_layers_match_jax():
    from stcd_tpu.layers import se as jse
    from stcd_tpu.models.segcd import CDNet as J
    from stcd_tpu_torch.layers import se as tse
    from stcd_tpu_torch.models.segcd import CDNet as T
    dec = (16, 12, 8, 6, 4)
    rng = np.random.default_rng(7)
    x1 = [rng.standard_normal((N, 2 ** (i + 1), 2 ** (i + 1), c)).astype(np.float32)
          for i, c in enumerate(dec)]
    x2 = [rng.standard_normal(f.shape).astype(np.float32) for f in x1]
    jmodel, port = J(decoder_channels=dec, classes=2), T(dec, classes=2)
    variables = {"params": jax_variables(jmodel, HW, 8, args=(x1, x2))["params"]}
    port.load_state_dict(from_flax.cdnet_from_flax(variables["params"]))
    want = jax.jit(jmodel.apply)(variables, [jnp.asarray(f) for f in x1],
                                 [jnp.asarray(f) for f in x2])
    with torch.no_grad():
        got = port([_nchw(f) for f in x1], [_nchw(f) for f in x2])
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    x = rng.standard_normal((N, 6, 5, 16)).astype(np.float32)
    for jcls, tcls, args in ((jse.ChannelSELayer, tse.ChannelSELayer, (16, 4)),
                             (jse.SpatialSELayer, tse.SpatialSELayer, (16,)),
                             (jse.ChannelSpatialSELayer, tse.ChannelSpatialSELayer, (16, 4))):
        jm = jcls(*args[1:])
        v = jax_variables(jm, HW, 9, args=(jnp.asarray(x),))
        tm = tcls(*args)
        sd = {}
        for path, val in flat(v["params"]).items():
            keys = [p.strip("[]'") for p in path.split("][")]
            name, kind = ".".join(keys[:-1]), keys[-1]
            if kind == "bias":
                sd[f"{name}.bias"] = torch.from_numpy(val)
            elif val.ndim == 2:
                sd[f"{name}.weight"] = torch.from_numpy(val.T.copy())
            else:
                sd[f"{name}.weight"] = torch.from_numpy(val.transpose(3, 2, 0, 1).copy())
        tm.load_state_dict(sd)
        with torch.no_grad():
            got = tm(_nchw(x)).numpy().transpose(0, 2, 3, 1)
        np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))), atol=1e-6,
                                   rtol=1e-5, err_msg=jcls.__name__)


def test_max_pool_and_dropout2d():
    """max_pool pads with -inf, as the JAX reduce_window does; Dropout2d
    drops whole (sample, channel) maps from its generator, scales the kept
    ones by 1 / (1 - p), and is the identity in eval and at p = 0."""
    from stcd_tpu.layers.modules import max_pool as jax_max_pool
    from stcd_tpu_torch.layers.modules import Dropout2d, max_pool
    from stcd_tpu_torch.layers.stochastic import set_generator
    x = np.random.default_rng(10).normal(-5, 1, (2, 7, 9, 3)).astype(np.float32)
    for window, stride, pad in ((2, 2, 0), (3, 2, 1)):
        want = np.asarray(jax_max_pool(jnp.asarray(x), window, stride, pad))
        got = max_pool(_nchw(x), window, stride, pad).numpy().transpose(0, 2, 3, 1)
        np.testing.assert_array_equal(got, want)
    drop = Dropout2d(0.5)
    t = torch.ones(4, 64, 3, 3)
    assert torch.equal(drop.eval()(t), t) and torch.equal(Dropout2d(0.0).train()(t), t)
    masks = []
    for _ in range(2):
        set_generator(drop.train(), torch.Generator().manual_seed(3))
        masks.append(drop(t))
    y = masks[0]
    assert torch.equal(masks[0], masks[1])
    per_map = y.reshape(4, 64, 9)
    assert torch.all(per_map == per_map[..., :1])  # whole maps
    assert set(per_map[..., 0].unique().tolist()) == {0.0, 2.0}
    with pytest.raises(ValueError):
        Dropout2d(1.0)


def _no_dropout(monkeypatch, port):
    """Dropout2d and Dropout the identity on both sides: flax's nn.Dropout
    (under the JAX Dropout2d) returns its input; the port's rates are 0."""
    from flax import linen as nn
    from stcd_tpu_torch.layers.modules import Dropout2d
    from stcd_tpu_torch.layers.stochastic import Dropout
    monkeypatch.setattr(nn.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None: inputs)
    for mod in port.modules():
        if isinstance(mod, (Dropout2d, Dropout)):
            mod.p = 0.0
    return port


# net_G -> (gradients against JAX, gradients against a float64 run of the port,
# as shares of the largest float64 gradient entry; running statistics against
# JAX, as a share of each tensor's largest entry) (module docstring, (c))
GRAD_BOUNDS = {"SiamUnet_conc": (GRAD_TOL, GRAD_TOL, 1e-5), "DTCDSCN": (1e-2, 4e-3, 1e-4)}


@pytest.mark.parametrize("net_G", list(GRAD_BOUNDS))
def test_train_mode_gradients_match_jax(net_G, monkeypatch):
    """Cross-entropy of the train-mode forward: the loss within 1e-5
    relative, the running statistics and every gradient against JAX's and
    every gradient against a float64 run of the port, each within its bound
    (GRAD_BOUNDS).
    SiamUnet_conc's float32 gradients are within 1e-6 of float64 on both
    sides (measured: the port 9.7e-7, JAX 3.7e-6), so GRAD_TOL holds both.
    DTCDSCN's are float32 noise at the 1e-3 level (measured: the port 1.7e-3
    off float64, at firstconv.weight, JAX 7.8e-3): its bound against JAX is
    for JAX's own rounding, and the port is held to float64 at 4e-3. Its
    running mean after the Dblock, a mean of two float32 sums of 512 x 9
    terms, is off float64 by 2.0e-5 (port) and 2.5e-5 (JAX) of its largest
    entry; held to JAX at 1e-4."""
    from stcd_tpu.losses.functional import cross_entropy as jax_ce
    from stcd_tpu_torch.losses.functional import cross_entropy
    from test_torch_changeformer_train import _assert_close
    from test_torch_train_steps import _float64_through_the_losses
    jmodel, variables, port = _build(net_G, seed=11)
    _no_dropout(monkeypatch, port)
    a, b = _inputs(N, HW, seed=12)
    label = np.random.default_rng(13).integers(0, 2, (N, HW, HW)).astype(np.int32)

    def loss_fn(params):
        pred, mutated = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                     jnp.asarray(a), jnp.asarray(b), True,
                                     mutable=["batch_stats"])
        return jax_ce(pred, jnp.asarray(label)), mutated["batch_stats"]

    (want_loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    convert = MODELS[net_G][0]
    want = convert(grads, new_stats)
    old = convert(variables["params"], variables["batch_stats"])
    port.train()
    loss = cross_entropy(port(_nchw(a), _nchw(b)), torch.from_numpy(label))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    port64 = _no_dropout(monkeypatch, _build(net_G, seed=11)[2].double().train())
    with _float64_through_the_losses():
        cross_entropy(port64(_nchw(a).double(), _nchw(b).double()),
                      torch.from_numpy(label)).backward()
    exact = {k: p.grad.numpy() for k, p in port64.named_parameters()}
    scale = max(float(np.abs(g).max()) for g in exact.values())
    to_jax, to_64, stats_tol = GRAD_BOUNDS[net_G]
    for name, p in port.named_parameters():
        assert p.grad is not None, name
        got = p.grad.double().numpy()
        err = float(np.abs(got - want[name].numpy()).max())
        assert err <= to_jax * scale, (name, "against JAX", err, scale)
        err = float(np.abs(got - exact[name]).max())
        assert err <= to_64 * scale, (name, "against float64", err, scale)
    for name, buf in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            _assert_close(buf.numpy(), want[name].numpy(), stats_tol, name)
            assert not np.allclose(buf.numpy(), old[name].numpy()), name


def test_three_trainer_steps_of_siamunet_abs_match_jax(tmp_path, monkeypatch):
    """TrainerConfig defaults (sgd momentum 0.99, weight decay 5e-4, lr 0.01,
    ce), Dropout2d the identity on both sides. The eval step on the initial
    state within the eval tolerance; three train steps: the first loss within
    1e-5 relative, the later ones within 1e-4; the confusion counts within 1 %
    of the pixels; every parameter's move from the init within 1e-2 of the
    JAX move's largest entry."""
    from stcd_tpu.train import trainer as jtrainer
    from stcd_tpu.train.state import TrainState as JaxTrainState
    from stcd_tpu_torch.train import trainer as ttrainer
    from test_torch_changeformer_train import _assert_close
    net_G = "SiamUnet_abs"
    kw = dict(net_G=net_G, img_size=HW, max_epochs=2)
    jt = jtrainer.CDTrainer(jtrainer.TrainerConfig(checkpoint_dir=str(tmp_path), **kw),
                            {"train": [None] * 2})
    variables = jax_variables(jt.model, HW, seed=14)
    jstate = JaxTrainState.create_with_stats(
        apply_fn=jt.model.apply, params=variables["params"],
        batch_stats=variables["batch_stats"], tx=jt.tx)
    tt = ttrainer.CDTrainer(ttrainer.TrainerConfig(**kw), steps_per_epoch=2)
    convert = MODELS[net_G][0]
    tt.model.load_state_dict(convert(variables["params"], variables["batch_stats"]))
    _no_dropout(monkeypatch, tt.model)
    tstate = tt.init_state("cpu")
    rng = np.random.default_rng(15)

    def batch():
        a, b = (rng.uniform(0, 1, (N, HW, HW, 3)).astype(np.float32) for _ in range(2))
        return a, b, (rng.uniform(size=(N, HW, HW, 1)) > 0.8).astype(np.float32)

    a, b, label = batch()
    final, cm = tt.eval_step(tstate, *(torch.from_numpy(t) for t in (a, b, label)))
    want_final, want_cm = jt.eval_step(jstate, jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(label))
    np.testing.assert_allclose(final.numpy().transpose(0, 2, 3, 1), np.asarray(want_final),
                               atol=ATOL, rtol=RTOL)
    assert np.abs(cm.numpy() - np.asarray(want_cm)).sum() <= 4
    for step in range(3):
        a, b, label = batch()
        jstate, want_loss, want_cm = jt.train_step(
            jstate, jnp.asarray(a), jnp.asarray(b), jnp.asarray(label),
            jax.random.PRNGKey(step))
        loss, cm = tt.train_step(tstate, *(torch.from_numpy(t) for t in (a, b, label)))
        np.testing.assert_allclose(loss.item(), float(want_loss),
                                   rtol=1e-5 if step == 0 else 1e-4, err_msg=f"step {step}")
        assert np.abs(cm.numpy() - np.asarray(want_cm)).sum() <= 0.01 * N * HW * HW
    want = convert(jstate.params, jstate.batch_stats)
    init = convert(variables["params"], variables["batch_stats"])
    for name, p in tstate.model.named_parameters():
        start = init[name].numpy()
        moved = want[name].numpy() - start
        assert np.abs(moved).max() > 0, name
        _assert_close(p.detach().numpy() - start, moved, 1e-2, f"change of {name}")


def test_define_g_builds_every_jax_key():
    """The 24 keys of the JAX factory (tests/test_models_zoo.py's list), with
    the JAX arguments: SNUNet's out_ch is n_class, IFNet's head has one
    channel, the BIT and ChangeFormer heads two; an unknown key raises."""
    keys = ["Unet", "SiamUnet_sub", "SiamUnet_abs", "SiamUnet_conc",
            "SiamUnet_cross_conc", "DTCDSCN", "IFNet", "SNUNet",
            "base_resnet18", "base_transformer_pos_s4",
            "base_transformer_pos_s4_dd8", "base_transformer_pos_s4_dd8_dedim8",
            "ChangeFormerV1", "ChangeFormerV2", "ChangeFormerV3",
            "ChangeFormerV4", "ChangeFormerV5", "ChangeFormerV6",
            "ChangeGNNV1", "ChangeGNNV2", "ChangeGNNV2_sub", "ChangeGNNV2_abs",
            "ChangeGNNV2_conc", "GNN"]
    assert list(NET_G_KEYS) == keys
    for k in keys:
        assert isinstance(define_G(k, n_class=2, embed_dim=64, img_size=64),
                          torch.nn.Module), k
    assert define_G("SNUNet", n_class=3).conv_final.out_channels == 3
    assert define_G("SiamUnet_conc", n_class=3).conv11d.out_channels == 3
    assert define_G("DTCDSCN", n_class=3).finalconv3_master.out_channels == 3
    assert define_G("IFNet", n_class=3).o5_conv4.out_channels == 1
    with pytest.raises(NotImplementedError, match="not recognized"):
        define_G("SNUNet_v9")


@pytest.mark.parametrize("init_type", ["normal", "xavier", "kaiming", "orthogonal"])
def test_init_weights_rules(init_type):
    """models/init.py: kernels by init_type (their spread), BatchNorm weights
    from N(1, gain), biases zero, LayerNorm weights and PReLU slopes kept;
    one generator seed gives the same weights; an unknown type raises."""
    from stcd_tpu_torch.layers.norm import BatchNorm
    from stcd_tpu_torch.models.init import init_weights
    gain = 0.02

    def build():
        m = torch.nn.Sequential(torch.nn.Conv2d(64, 128, 3), BatchNorm(128),
                                torch.nn.ConvTranspose2d(128, 32, 2, 2),
                                torch.nn.Linear(256, 512), torch.nn.LayerNorm(512),
                                torch.nn.PReLU(1, 0.25))
        with torch.no_grad():
            m[4].weight.fill_(0.7)
        return init_weights(m, init_type, gain, torch.Generator().manual_seed(0))

    m = build()
    assert all(torch.equal(p, q) for p, q in zip(m.parameters(), build().parameters()))
    conv, bn, convt, lin, ln, prelu = m
    for layer in (conv, convt, lin, bn, ln):
        assert torch.count_nonzero(layer.bias) == 0
    assert torch.all(ln.weight == 0.7) and torch.all(prelu.weight == 0.25)
    assert abs(bn.weight.mean().item() - 1.0) < 0.01 and 0.01 < bn.weight.std().item() < 0.03
    fan_in, fan_out = 64 * 9, 128 * 9
    std = {"normal": gain, "xavier": gain * (2.0 / (fan_in + fan_out)) ** 0.5,
           "kaiming": (2.0 / fan_in) ** 0.5}
    if init_type in std:
        assert abs(conv.weight.std().item() / std[init_type] - 1.0) < 0.05
        if init_type != "normal":  # truncated at two standard deviations
            assert conv.weight.abs().max().item() <= 2.0 * std[init_type] / 0.8796 + 1e-7
    else:  # the 128 output channels are orthogonal vectors of length gain
        w = conv.weight.reshape(128, -1)
        torch.testing.assert_close(w @ w.T, gain ** 2 * torch.eye(128), atol=1e-6, rtol=0)
    with pytest.raises(NotImplementedError):
        init_weights(m, "uniform")


def test_factory_init_weights_seeds_every_new_family():
    """One seed gives the same weights, another seed others; BatchNorm
    weights are drawn from N(1, 0.02)."""
    from stcd_tpu_torch.models.factory import init_weights
    for net_G in ("SiamUnet_cross_conc", "SNUNet", "DTCDSCN", "IFNet"):
        model = define_G(net_G)

        def weights(seed):
            return {k: v.clone() for k, v in init_weights(model, seed).state_dict().items()}

        w1, w2, w3 = weights(4), weights(4), weights(5)
        assert all(torch.equal(w1[k], w2[k]) for k in w1), net_G
        assert any(not torch.equal(w1[k], w3[k]) for k in w1), net_G
        bn_weights = [k.replace("running_var", "weight") for k in w1
                      if k.endswith("running_var")]
        assert bn_weights and all(not torch.all(w1[k] == 1) for k in bn_weights), net_G
