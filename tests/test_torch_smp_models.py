"""stcd_tpu_torch's ``create_model`` against the JAX package's, float32 on the
CPU: the 12 architectures (unet, unetseg, segcd, ffctlcd, unetplusplus, manet,
linknet, fpn, pspnet, deeplabv3, deeplabv3plus, pan) over resnet18 at narrow
decoder widths, Unet's scse gates, classification head and VGG center block,
and mit_b0 under FPN and under a gated Unet.

Each model's weights are the JAX model's variables (the tree of its ``init``,
taken with ``jax.eval_shape``) drawn with numpy
(``test_torch_zoo_siam.jax_variables``: kernels N(0, 1 / fan_in), BatchNorm and
GroupNorm scales and variances in [0.5, 1.5], biases and means N(0, 0.1)),
carried to the port by ``convert/from_flax.py::smp_model_from_flax``. One JAX
model and one draw of variables serve every test of an arch in this file.
Held to:
(a) the eval forward at 64x64 (PAN 128x128: its pyramid attention pools a
    /16 map three times), batch 2, within ATOL + RTOL |want|: the convolutions
    sum in another order in oneDNN than in XLA:CPU;
(b) the train-mode forward and the running statistics it leaves, the
    dropouts the identity on both sides (flax's ``nn.Dropout`` returns its
    input; the port's rates are 0), against JAX and against a float64 run of
    the port, each as a share of the largest float64 entry of the tensor
    (TRAIN_BOUNDS). Most archs are within 1e-5 of float64 on both sides.
    DeepLabV3, DeepLabV3+ and PAN hold a train-mode BatchNorm over a 1x1
    pooled map, so over N = 2 values a channel: its variance, E[x^2] - E[x]^2
    in float32 on both sides, loses digits where the two values are close, and
    both sides are off float64 by more (measured, outputs: DeepLabV3+ the port
    2.9e-4 and JAX 1.2e-4, PAN the port 9.2e-4 and JAX 5.5e-3; statistics:
    DeepLabV3+ 1.5e-4 and 6.0e-5, PAN 1.2e-4 and 6.6e-4);
(c) for DeepLabV3+ and MAnet, every parameter's gradient of a squared-error
    loss of that train-mode forward against a float64 run of the port within
    GRAD_TO_64 and against JAX's within GRAD_TO_JAX, of the largest float64
    gradient entry. JAX's float32 gradients are the noisier (measured at
    ``encoder.conv1.weight``: DeepLabV3+ the port 6.1e-5 off float64, JAX
    6.9e-4; MAnet 1.5e-5 and 3.9e-3), so the bound against JAX is for JAX's
    own rounding;
(d) ``make_seg_steps`` on FPN with its channel dropout live: the masks come
    from the step's generator, so two runs from one seed are equal, with and
    without ``remat`` (the recomputed forward draws the same masks);
(e) ``predict``, and the converter's names: the state_dict that
    ``smp_model_from_flax`` writes loads with ``strict=True`` (every load here
    is strict), and the JAX package's own converters of smp's state_dicts
    (``convert/torch_to_flax.py``) read the port's state_dict back into the JAX
    variables exactly.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stcd_tpu.models.factory import create_model as jax_create_model
from stcd_tpu_torch.convert.from_flax import smp_model_from_flax
from stcd_tpu_torch.layers.modules import Dropout2d
from stcd_tpu_torch.layers.stochastic import Dropout
from stcd_tpu_torch.models import create_model

from test_torch_changeformer import _nchw
from test_torch_train_steps import _float64_through_the_losses
from test_torch_zoo_siam import jax_variables

ATOL, RTOL = 2e-5, 1e-4
# (b): (outputs to JAX, outputs to float64, statistics to JAX, statistics to float64)
TRAIN_BOUNDS = {"deeplabv3": (2e-4, 2e-4, 1e-4, 1e-4),
                "deeplabv3plus": (2e-3, 1e-3, 1e-3, 5e-4),
                "pan": (2e-2, 3e-3, 3e-3, 5e-4)}
TRAIN_BOUND = (1e-4, 1e-4, 2e-5, 1e-5)
GRAD_TO_64, GRAD_TO_JAX = 2e-4, 1e-2  # (c)
N = 2
DEC = (16, 16, 12, 8, 8)

# name -> (arch, encoder, create_model keywords, input size)
MODELS = {
    "unet": ("unet", "resnet18", dict(decoder_channels=DEC), 64),
    "unetseg": ("unetseg", "resnet18", dict(decoder_channels=DEC), 64),
    "segcd": ("segcd", "resnet18", dict(decoder_channels=DEC), 64),
    "ffctlcd": ("ffctlcd", "resnet18", dict(decoder_channels=DEC), 64),
    "unetplusplus": ("unetplusplus", "resnet18", dict(decoder_channels=DEC), 64),
    "manet": ("manet", "resnet18", dict(decoder_channels=DEC, decoder_pab_channels=8), 64),
    "linknet": ("linknet", "resnet18", {}, 64),
    "fpn": ("fpn", "resnet18", dict(decoder_pyramid_channels=32,
                                    decoder_segmentation_channels=32), 64),
    "pspnet": ("pspnet", "resnet18", dict(psp_out_channels=32), 64),
    "deeplabv3": ("deeplabv3", "resnet18", dict(decoder_channels=32), 64),
    "deeplabv3plus": ("deeplabv3plus", "resnet18", dict(decoder_channels=32), 64),
    "pan": ("pan", "resnet18", dict(decoder_channels=16), 128),
    # the options: scse gates and the classification head; the VGG center block;
    # MiT under FPN and under a gated Unet (its zero-channel /2 level is a skip);
    # FPN's concatenating merge
    "unet_scse_aux": ("unet", "resnet18", dict(decoder_channels=DEC,
                                               decoder_attention_type="scse",
                                               aux_params={"classes": 4}), 64),
    "unet_vgg11": ("unet", "vgg11", dict(decoder_channels=DEC), 64),
    "fpn_mit_b0": ("fpn", "mit_b0", dict(decoder_pyramid_channels=32,
                                         decoder_segmentation_channels=32), 64),
    "unet_mit_b0_scse": ("unet", "mit_b0", dict(decoder_channels=DEC,
                                                decoder_attention_type="scse"), 64),
    "fpn_cat": ("fpn", "resnet18", dict(decoder_pyramid_channels=32,
                                        decoder_segmentation_channels=32,
                                        decoder_merge_policy="cat"), 64),
}
ARCHS = ("unet", "unetseg", "segcd", "ffctlcd", "unetplusplus", "manet", "linknet", "fpn",
         "pspnet", "deeplabv3", "deeplabv3plus", "pan")
SIAMESE = ("segcd", "ffctlcd")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread for this file's tests, as tests/test_torch_cli.py
    has: the suite runs several files at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax(name):
    """The JAX model of MODELS[name] and its variables (module docstring)."""
    arch, encoder, kw, hw = MODELS[name]
    jmodel = jax_create_model(arch, encoder_name=encoder, classes=2, **kw)
    z = jnp.zeros((1, hw, hw, 3))
    args = (z, z) if arch in SIAMESE else (z,)
    return jmodel, jax_variables(jmodel, hw, seed=len(name), args=args)


def _port(name, dtype=torch.float32):
    arch, encoder, kw, _ = MODELS[name]
    _, variables = _jax(name)
    port = create_model(arch, encoder, classes=2, **kw)
    port.load_state_dict(smp_model_from_flax(arch, variables["params"],
                                             variables.get("batch_stats")))
    return port.to(dtype)


def _inputs(name, seed):
    arch, _, _, hw = MODELS[name]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((N, hw, hw, 3)).astype(np.float32)
            for _ in range(2 if arch in SIAMESE else 1)]


def _outputs(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _to_nhwc(t):
    t = t.detach().numpy()
    return t.transpose(0, 2, 3, 1) if t.ndim == 4 else t


@pytest.mark.parametrize("name", list(MODELS))
def test_eval_forward_matches_jax(name):
    jmodel, variables = _jax(name)
    xs = _inputs(name, seed=3)
    wants = _outputs(jax.jit(jmodel.apply)(variables, *map(jnp.asarray, xs)))
    port = _port(name).eval()
    with torch.no_grad():
        gots = _outputs(port(*map(_nchw, xs)))
    hw = MODELS[name][3]
    assert len(gots) == len(wants) == {"segcd": 3, "ffctlcd": 3, "unet_scse_aux": 2}.get(name, 1)
    assert gots[0].shape == (N, 2, hw, hw)
    for got, want in zip(gots, wants):
        np.testing.assert_allclose(_to_nhwc(got), np.asarray(want), atol=ATOL, rtol=RTOL)


def _no_dropout(monkeypatch, port):
    from flax import linen as nn
    monkeypatch.setattr(nn.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None: inputs)
    for mod in port.modules():
        if isinstance(mod, (Dropout2d, Dropout)):
            mod.p = 0.0
    return port


def _running_stats(sd):
    return {k: v.numpy() for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def _train_port(name, monkeypatch, dtype=torch.float32):
    return _no_dropout(monkeypatch, _port(name, dtype)).train()


@pytest.mark.parametrize("name", ARCHS + ("unet_scse_aux",))
def test_train_forward_and_running_stats_match_jax(name, monkeypatch):
    arch = MODELS[name][0]
    jmodel, variables = _jax(name)
    port, port64 = _train_port(name, monkeypatch), _train_port(name, monkeypatch, torch.float64)
    xs = _inputs(name, seed=5)
    wants, mutated = jax.jit(lambda v, *x: jmodel.apply(v, *x, True, mutable=["batch_stats"]))(
        variables, *map(jnp.asarray, xs))
    with torch.no_grad(), _float64_through_the_losses():
        gots = _outputs(port(*map(_nchw, xs)))
        exact = _outputs(port64(*(_nchw(x).double() for x in xs)))
    out_jax, out_64, stats_jax, stats_64 = TRAIN_BOUNDS.get(arch, TRAIN_BOUND)

    def hold(got, want, ref, to_jax, to_64, what):
        scale = float(np.abs(ref).max())
        err = float(np.abs(got - want).max())
        assert err <= to_jax * scale, (what, "against JAX", err, scale)
        err = float(np.abs(got - ref).max())
        assert err <= to_64 * scale, (what, "against float64", err, scale)

    for got, want, ref in zip(gots, _outputs(wants), exact):
        hold(_to_nhwc(got), np.asarray(want), _to_nhwc(ref), out_jax, out_64, "output")
    got_stats = _running_stats(port.state_dict())
    ref_stats = _running_stats(port64.state_dict())
    old = _running_stats(smp_model_from_flax(arch, variables["params"],
                                             variables.get("batch_stats")))
    want = _running_stats(smp_model_from_flax(arch, variables["params"],
                                              mutated["batch_stats"]))
    assert set(got_stats) == set(want) and want
    for key, value in want.items():
        hold(got_stats[key], value, ref_stats[key], stats_jax, stats_64, key)
        assert not np.allclose(got_stats[key], old[key]), key


@pytest.mark.parametrize("name", ["deeplabv3plus", "manet"])
def test_train_gradients_match_jax_and_float64(name, monkeypatch):
    """The squared error of the train-mode output to a fixed target: every
    gradient against JAX's and against a float64 run of the port (module
    docstring, (c))."""
    arch = MODELS[name][0]
    jmodel, variables = _jax(name)
    port = _train_port(name, monkeypatch)
    xs = _inputs(name, seed=7)
    hw = MODELS[name][3]
    target = np.random.default_rng(8).standard_normal((N, hw, hw, 2)).astype(np.float32)

    def loss_fn(params):
        out, mutated = jmodel.apply({**variables, "params": params}, *map(jnp.asarray, xs),
                                    True, mutable=["batch_stats"])
        return jnp.mean((out - target) ** 2), mutated

    (want_loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    want = smp_model_from_flax(arch, grads, variables.get("batch_stats"))
    loss = ((port(*map(_nchw, xs)) - _nchw(target)) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    port64 = _train_port(name, monkeypatch, torch.float64)
    with _float64_through_the_losses():
        ((port64(*(_nchw(x).double() for x in xs)) - _nchw(target).double()) ** 2
         ).mean().backward()
    exact = {k: p.grad.numpy() for k, p in port64.named_parameters()}
    scale = max(float(np.abs(g).max()) for g in exact.values())
    for key, p in port.named_parameters():
        got = p.grad.double().numpy()
        err = float(np.abs(got - want[key].numpy()).max())
        assert err <= GRAD_TO_JAX * scale, (key, "against JAX", err, scale)
        err = float(np.abs(got - exact[key]).max())
        assert err <= GRAD_TO_64 * scale, (key, "against float64", err, scale)


def test_predict_is_the_eval_forward_without_grad():
    port = _port("deeplabv3plus").train()
    x = _nchw(_inputs("deeplabv3plus", seed=9)[0])
    got = port.predict(x)
    assert not port.training and not got.requires_grad
    with torch.no_grad():
        assert torch.equal(got, port(x))


def test_seg_step_dropout_draws_from_the_step_generator():
    from stcd_tpu_torch.models.segcd import init_weights
    from stcd_tpu_torch.train.state import adam_poly, create_train_state
    from stcd_tpu_torch.train.steps import make_seg_steps
    rng = np.random.default_rng(10)
    batch = {"image": torch.from_numpy(rng.integers(0, 256, (N, 64, 64, 3), dtype=np.uint8)),
             "label": torch.from_numpy((rng.random((N, 64, 64, 1)) > 0.7).astype(np.float32))}
    runs = []
    for remat in (False, False, True):
        model = init_weights(create_model("fpn", "resnet18", decoder_dropout=0.5,
                                          decoder_segmentation_channels=32), seed=1)
        state = create_train_state(model, adam_poly(1e-3, 2, 2), device="cpu", seed=3)
        train_step, _ = make_seg_steps(augment=True, remat=remat)
        runs.append([float(train_step(state, batch, state.generator)["loss"])
                     for _ in range(2)]
                    + [p.detach().clone() for p in state.model.parameters()])
    assert runs[0][:2] == runs[1][:2]
    np.testing.assert_allclose(runs[2][:2], runs[0][:2], rtol=1e-6)
    for a, b, c in zip(runs[0][2:], runs[1][2:], runs[2][2:]):
        assert torch.equal(a, b)
        torch.testing.assert_close(c, a, rtol=1e-5, atol=1e-6)


_JAX_DECODER_CONVERTERS = {
    "unetplusplus": "convert_unetplusplus_decoder", "manet": "convert_manet_decoder",
    "linknet": "convert_linknet_decoder", "fpn": "convert_fpn_decoder",
    "pspnet": "convert_psp_decoder", "deeplabv3": "convert_deeplabv3_decoder",
    "deeplabv3plus": "convert_deeplabv3plus_decoder", "pan": "convert_pan_decoder",
}


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", list(_JAX_DECODER_CONVERTERS) + ["unet_vgg11"])
def test_jax_converters_read_the_port_state_dict_back(name):
    """The port's state_dict under smp's names, through the JAX package's
    converter of smp's decoder (and of torchvision's VGG), gives the JAX
    variables back exactly."""
    from stcd_tpu.convert import torch_to_flax as t2f
    arch = MODELS[name][0]
    _, variables = _jax(name)
    sd = {k: v.numpy() for k, v in _port(name).state_dict().items()}
    if name == "unet_vgg11":
        enc = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
        got = t2f.convert_vgg(enc)
        want = (variables["params"]["encoder"], variables["batch_stats"].get("encoder", {}))
    else:
        dec = {k[len("decoder."):]: v for k, v in sd.items() if k.startswith("decoder.")}
        got = getattr(t2f, _JAX_DECODER_CONVERTERS[arch])(dec)
        want = (variables["params"]["decoder"],
                variables.get("batch_stats", {}).get("decoder", {}))
    for g, w in zip(got, want):
        g, w = _flat(g), _flat(w)
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_int8_sites_keep_the_scse_gates():
    """``serving/quant.py`` claims a U-Net decoder block for the split-form
    sites only without gates: with every site left in float (no conv has
    enough input channels), the quantized forward of a gated Unet is its float
    forward, gates included."""
    from stcd_tpu_torch.serving.quant import calibrate_conv_scales, quantize_fn
    port = _port("unet_scse_aux").eval()
    x = _nchw(_inputs("unet_scse_aux", seed=11)[0])
    fn = lambda t: port(t)[0]  # noqa: E731
    scales = calibrate_conv_scales(port, fn, [x], min_in_channels=10 ** 6)
    assert np.isnan(scales).all() and scales.size > 0
    with torch.no_grad():
        assert torch.equal(quantize_fn(port, fn, scales, min_in_channels=10 ** 6)(x), fn(x))
