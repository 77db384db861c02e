"""stcd_tpu_torch's encoder registry and encoders against the JAX package's,
float32 on the CPU: ``get_encoder``'s dilated ResNet (output stride 8 and 16,
torchvision's per-block rule), ResNeXt, the smp-contract VGG encoders, the
``in_channels`` of the first conv, the registry's names, out_channels and
preprocessing parameters, its errors, ``create_model``'s keys and
``encoder_weights``, ``make_dilated_rates``, ``ConvTranspose2x`` and the
BatchNorm of one sample.

Weights are the JAX encoder's variables drawn with numpy
(``test_torch_zoo_siam.jax_variables``), carried across by
``convert/from_flax.py::encoder_from_flax``. Every pyramid level is held within ATOL + RTOL
|want| in eval mode (the convolutions sum in another order in oneDNN than in
XLA:CPU; random running statistics over up to 16 residual blocks give levels
of order 10).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stcd_tpu import encoders as jenc
from stcd_tpu.models import factory as jfactory
from stcd_tpu_torch import encoders as tenc
from stcd_tpu_torch.convert.from_flax import encoder_from_flax
from stcd_tpu_torch.models import create_model
from stcd_tpu_torch.models import factory as tfactory

from test_torch_changeformer import _nchw
from test_torch_zoo_siam import jax_variables

ATOL, RTOL = 1e-4, 1e-4
N = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pyramids(name, hw, seed, in_channels=3, **kw):
    """The JAX and the port's pyramid of encoder ``name`` on the same weights
    and inputs, eval mode; the port's module is returned too."""
    jmodule, jch = jenc.get_encoder(name, **kw)
    variables = jax_variables(jmodule, hw, seed, args=(jnp.zeros((1, hw, hw, in_channels)),))
    x = np.random.default_rng(seed + 1).standard_normal((N, hw, hw, in_channels)).astype(
        np.float32)
    want = jax.jit(jmodule.apply)(variables, jnp.asarray(x))
    port, tch = tenc.get_encoder(name, in_channels=in_channels, **kw)
    port.load_state_dict(encoder_from_flax(name, variables["params"],
                                           variables.get("batch_stats", {})), strict=True)
    with torch.no_grad():
        got = port.eval()(_nchw(x))
    assert tch == jch and tuple(port.out_channels) == tuple(jch)
    return got, want, port


def _hold(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1), np.asarray(w),
                                   atol=ATOL, rtol=RTOL, err_msg=f"level {i}")


@pytest.mark.parametrize("name,output_stride", [("resnet18", 16), ("resnet18", 8),
                                                ("resnet50", 16), ("resnet50", 8)])
def test_dilated_resnet_matches_jax(name, output_stride):
    """JAX's per-block dilation, pinned (ROADMAP.md Queue 3, known issue 5):
    the deepest levels stay at /output_stride; a Bottleneck stage's first
    block takes the previous stage's rate, the others the doubled one; a
    BasicBlock never dilates, so resnet18's dilated stages only lose their
    strides."""
    got, want, port = _pyramids(name, 64, seed=1, output_stride=output_stride)
    _hold(got, want)
    assert [g.shape[2] for g in got] == [64, 32, 16, 8] + (
        [4, 4] if output_stride == 16 else [8, 8])
    rates = [[b.conv2.dilation[0] for b in getattr(port, f"layer{i}")] for i in (3, 4)]
    if name == "resnet18":
        assert rates == [[1, 1], [1, 1]]
    elif output_stride == 16:
        assert rates == [[1] * 6, [1, 2, 2]]
    else:
        assert rates == [[1] + [2] * 5, [2, 4, 4]]


@pytest.mark.parametrize("name,output_stride", [("resnet18", 4), ("mit_b0", 16),
                                                ("vgg16", 8)])
def test_dilation_refusals_match_jax(name, output_stride):
    """A stride other than 8, 16 or 32, and an encoder without stages to
    dilate: the JAX ValueError, word for word."""
    with pytest.raises(ValueError) as want:
        jenc.get_encoder(name, output_stride=output_stride)
    with pytest.raises(ValueError) as got:
        tenc.get_encoder(name, output_stride=output_stride)
    assert str(got.value) == str(want.value)


def test_resnext50_matches_jax():
    got, want, port = _pyramids("resnext50_32x4d", 32, seed=2)
    _hold(got, want)
    assert port.layer1[0].conv2.groups == 32 and port.layer1[0].conv2.in_channels == 128


@pytest.mark.parametrize("name,depth", [("vgg11", 5), ("vgg13_bn", 5), ("vgg16", 5),
                                        ("vgg19_bn", 5), ("vgg16_bn", 3)])
def test_vgg_encoder_matches_jax(name, depth):
    got, want, _ = _pyramids(name, 32, seed=3, depth=depth)
    _hold(got, want)


@pytest.mark.parametrize("name", ["resnet18", "vgg11_bn", "mit_b0"])
def test_in_channels_4_matches_jax(name):
    """A 4-channel input: the port builds the first conv at that width, flax
    infers it."""
    got, want, port = _pyramids(name, 32, seed=4, in_channels=4)
    assert next(m for m in port.modules() if isinstance(m, torch.nn.Conv2d)).in_channels == 4
    _hold(got, want)


def test_registry_matches_jax():
    """JAX's 124 names exactly, each one's out_channels at every depth;
    preprocessing parameters of all of them (also with ``tu-`` and for
    ``advprop``) and preprocess_input."""
    assert set(tenc.encoder_names()) == set(jenc.encoder_names())
    assert len(tenc.encoder_names()) == 124
    for name in tenc.encoder_names():
        for depth in range(1, 6):
            assert tenc.encoder_out_channels(name, depth) == jenc.encoder_out_channels(
                name, depth), (name, depth)
    for name in jenc.encoder_names():
        for query in (name, "tu-" + name.replace("timm-", "")):
            for pretrained in ("imagenet", "advprop"):
                assert (tenc.get_preprocessing_params(query, pretrained)
                        == jenc.get_preprocessing_params(query, pretrained)), query
    image = np.random.default_rng(5).integers(0, 256, (4, 4, 3)).astype(np.float32)
    for name in ("resnet34", "dpn68", "xception"):
        np.testing.assert_allclose(tenc.get_preprocessing_fn(name)(image),
                                   np.asarray(jenc.get_preprocessing_fn(name)(image)),
                                   rtol=1e-6)


@pytest.mark.parametrize("name", ["densenet121", "tu-regnetx_002", "timm-skresnet18",
                                  "efficientnet-b0"])
def test_pending_family_raises_not_implemented(name):
    """The four names that raised NotImplementedError while their families
    were not ported: each now builds with JAX's out_channels, and
    ``create_model("unet", name)`` gives JAX's output shape."""
    module, channels = tenc.get_encoder(name)
    assert channels == jenc.get_encoder(name)[1] == tuple(module.out_channels)
    jmodel = jfactory.create_model("unet", name, decoder_channels=(16, 16, 12, 8, 8))
    z = jnp.zeros((1, 64, 64, 3))
    want = jax.eval_shape(lambda: jmodel.init_with_output(jax.random.PRNGKey(0), z)[0])
    port = create_model("unet", name, decoder_channels=(16, 16, 12, 8, 8)).eval()
    with torch.no_grad():
        got = port(torch.zeros(1, 3, 64, 64))
    assert tuple(got.permute(0, 2, 3, 1).shape) == want.shape


def test_unknown_names_raise_key_error_as_jax():
    for name in ("resnet9", "tu-nothing"):
        with pytest.raises(KeyError) as want:
            jenc.get_encoder(name)
        with pytest.raises(KeyError) as got:
            tenc.get_encoder(name)
        prefix = str(want.value).split(":")[0]
        assert str(got.value).split(":")[0] == prefix
    with pytest.raises(KeyError) as want:
        jfactory.create_model("segformer")
    with pytest.raises(KeyError) as got:
        create_model("segformer")
    assert str(got.value) == str(want.value)
    assert set(tfactory._ARCHS) == set(jfactory._ARCHS)
    # tu-<name> resolves a registered <name>
    assert tenc.get_encoder("tu-resnet18")[1] == jenc.get_encoder("tu-resnet18")[1]
    assert create_model("DeepLabV3Plus", "resnet18", decoder_channels=16).__class__.__name__ \
        == "DeepLabV3Plus"


def test_encoder_weights_resolve_and_load(tmp_path, monkeypatch):
    """A torchvision state_dict (with its classifier) loads into the encoder,
    through create_model and through create_train_state; ``"imagenet"`` finds
    ``{encoder}.pth`` under $STCD_PRETRAINED_DIR; a missing file raises before
    anything is built; in_channels 4 with weights raises."""
    src = tenc.get_encoder("resnet18")[0]
    torch.nn.init.normal_(src.conv1.weight)
    sd = {**src.state_dict(), "fc.weight": torch.zeros(10, 512), "fc.bias": torch.zeros(10)}
    torch.save(sd, tmp_path / "resnet18.pth")
    model = create_model("fpn", "resnet18", encoder_weights=str(tmp_path / "resnet18.pth"))
    assert torch.equal(model.encoder.conv1.weight, src.conv1.weight)
    monkeypatch.setenv("STCD_PRETRAINED_DIR", str(tmp_path))
    model = create_model("unet", "resnet18", encoder_weights="imagenet")
    assert torch.equal(model.encoder.conv1.weight, src.conv1.weight)
    with pytest.raises(FileNotFoundError):
        create_model("unet", "resnet34", encoder_weights="imagenet")
    with pytest.raises(NotImplementedError):
        create_model("unet", "resnet18", encoder_weights="imagenet", in_channels=4)
    # a torchvision VGG state_dict keeps its classifier; create_train_state drops it too
    from stcd_tpu_torch.train.state import adam_poly, create_train_state
    vgg = tenc.get_encoder("vgg11")[0]
    torch.save({**vgg.state_dict(), "classifier.0.weight": torch.zeros(4096, 25088)},
               tmp_path / "vgg11.pth")
    state = create_train_state(create_model("unet", "vgg11"), adam_poly(), device="cpu",
                               encoder_weights="imagenet")
    assert torch.equal(state.model.encoder.features[0].weight, vgg.features[0].weight)


def test_make_dilated_rates_matches_jax():
    from stcd_tpu.encoders.dilation import make_dilated_rates as jrates
    from stcd_tpu_torch.encoders.dilation import make_dilated_rates
    for flags in [(False, False, True), (False, True, True), (True, True, True),
                  (False, False, False, True), (True, False, True)]:
        assert make_dilated_rates(flags) == jrates(flags)


def test_conv_transpose_2x_matches_jax():
    """k=3, stride 2, padding 1, output_padding 1 against the JAX module's
    ``transpose_kernel`` form, the kernel carried by from_flax's _conv_w."""
    from stcd_tpu.layers.modules import ConvTranspose2x as J
    from stcd_tpu_torch.convert.from_flax import _conv_b
    from stcd_tpu_torch.layers.modules import ConvTranspose2x
    x = np.random.default_rng(6).standard_normal((N, 5, 7, 6)).astype(np.float32)
    jm = J(4)
    variables = jax_variables(jm, 5, seed=7, args=(jnp.asarray(x),))
    want = jm.apply(variables, jnp.asarray(x))
    port = ConvTranspose2x(6, 4)
    sd = {}
    _conv_b(sd, "m", variables["params"]["ConvTranspose_0"])
    port.load_state_dict({k[2:]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == (N, 10, 14, 4)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


def test_batchnorm_of_one_sample_on_a_1x1_map_is_jax():
    """The ASPP and FPA pooling branches' train-mode BatchNorm at batch 1: one
    value a channel, variance 0; the port gives JAX's result (the bias) and
    moves the running statistics as JAX does, where torch.nn.BatchNorm2d
    raises."""
    from stcd_tpu.layers.norm import BatchNorm as JBN
    from stcd_tpu_torch.layers.norm import BatchNorm
    x = np.random.default_rng(8).standard_normal((1, 1, 1, 5)).astype(np.float32)
    jbn = JBN(use_running_average=False)
    variables = jax_variables(jbn, 1, seed=9, args=(jnp.asarray(x),))
    want, mutated = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm(5)
    with torch.no_grad():
        for name, p in (("weight", "scale"), ("bias", "bias")):
            getattr(port, name).copy_(torch.from_numpy(np.asarray(variables["params"][p])))
        port.running_mean.copy_(torch.from_numpy(np.asarray(variables["batch_stats"]["mean"])))
        port.running_var.copy_(torch.from_numpy(np.asarray(variables["batch_stats"]["var"])))
        got = port.train()(_nchw(x))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want), atol=1e-6)
    # x w + (bias - x w) with w = scale / sqrt(eps), about 300: float32 rounds the
    # two products of size 300 |x| apart by up to a few 1e-5
    np.testing.assert_allclose(got.numpy().ravel(), port.bias.detach().numpy(), atol=1e-4)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(mutated["batch_stats"]["var"]), rtol=1e-6)
    with pytest.raises(ValueError):
        torch.nn.BatchNorm2d(5).train()(_nchw(x))
