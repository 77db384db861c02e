"""stcd_tpu_torch's ResNet encoder, UNet decoder and SegCD family against the
JAX models, on one set of weights: a JAX init, perturbed with numpy so that
BatchNorm is not the identity, converted by unetseg_from_flax / resnet_from_flax.

The tolerance is atol 2e-4, rtol 1e-3: the convolutions sum in another order
in oneDNN than in XLA:CPU. Train mode also holds the BatchNorm running
statistics after one forward."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stcd_tpu.convert.torch_to_flax import convert_unetseg
from stcd_tpu.decoders.unet import UnetDecoder as JaxUnetDecoder
from stcd_tpu.encoders.resnet import ResNetEncoder as JaxResNetEncoder
from stcd_tpu.models import segcd as jsegcd
from stcd_tpu_torch.convert.from_flax import (resnet_from_flax, unet_decoder_from_flax,
                                              unetseg_from_flax)
from stcd_tpu_torch.decoders.unet import UnetDecoder
from stcd_tpu_torch.encoders import get_encoder
from stcd_tpu_torch.encoders.resnet import ResNetEncoder, resnet_out_channels
from stcd_tpu_torch.models import segcd as tsegcd

from test_torch_train_steps import _float64_through_the_losses

ATOL, RTOL = 2e-4, 1e-3
DEC = (32, 24, 16, 12, 8)
LAYERS = {"resnet18": (2, 2, 2, 2), "resnet50": (3, 4, 6, 3)}


def perturb(variables, seed):
    """BN scales, biases and running stats away from (1, 0, 0, 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1].key)
        x = np.asarray(x)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def images(seed, n=2, hw=32):
    return np.random.default_rng(seed).standard_normal((n, hw, hw, 3)).astype(np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def close(got, want, msg=""):
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=msg)


def hold_running_stats(port, stats, prefix_map):
    """The port's BN buffers against JAX's updated batch_stats."""
    sd = port.state_dict()
    flat = dict(jax.tree_util.tree_flatten_with_path(stats)[0])
    assert flat
    checked = 0
    for path, want in flat.items():
        keys = [str(p.key) for p in path]
        name = prefix_map(keys)
        if name is None:
            continue
        close(sd[name].numpy(), want, name)
        checked += 1
    assert checked >= 4


def _resnet_buffer_name(keys):
    # ['layer1', 'block0', 'bn1', 'mean'] -> layer1.0.bn1.running_mean
    leaf = {"mean": "running_mean", "var": "running_var"}[keys[-1]]
    mods = [k[5:] if k.startswith("block") else k for k in keys[:-1]]
    mods = [".".join(["downsample", "1"]) if m == "downsample_bn" else m for m in mods]
    return ".".join(mods + [leaf])


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet_pyramid_matches_jax(arch, train):
    # train mode: 16 values per channel at the 2x2 deepest level; with fewer,
    # batch normalisation amplifies the summation-order noise of the convs
    x = images(0, n=4, hw=64) if train else images(0)
    jmodel = JaxResNetEncoder(arch=arch)
    variables = perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    port = ResNetEncoder(arch)
    port.load_state_dict(resnet_from_flax(variables["params"], variables["batch_stats"]),
                         strict=True)
    if train:
        wants, mutated = jax.jit(lambda v, x: jmodel.apply(
            v, x, True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
        with torch.no_grad():
            gots = port.train()(nchw(x))
        hold_running_stats(port, mutated["batch_stats"], _resnet_buffer_name)
        if arch == "resnet50":  # the reference for the deep levels, below
            port64 = ResNetEncoder(arch).double()
            port64.load_state_dict(resnet_from_flax(variables["params"],
                                                    variables["batch_stats"]), strict=True)
            with torch.no_grad(), _float64_through_the_losses():
                exacts = port64.train()(nchw(x).double())
    else:
        wants = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
        with torch.no_grad():
            gots = port.eval()(nchw(x))
    assert len(gots) == len(wants) == 6
    assert tuple(g.shape[1] for g in gots) == resnet_out_channels(arch) == port.out_channels
    for i, (got, want) in enumerate(zip(gots, wants)):
        assert got.shape[2] == x.shape[1] // 2 ** i
        if train and arch == "resnet50" and i >= 2:
            # 3 to 13 train-mode bottlenecks deep, float32 noise is amplified: JAX
            # against the port 1.5e-4, 3.3e-4, 1.9e-3 and 3.7e-3 at levels 2 to 5,
            # past ATOL at level 3 on some hosts. Both are held against a float64
            # run of the port instead. Measured on a CPU host, the port's float32
            # is off by 1.8e-5, 6.6e-5, 3.6e-4 and 9.3e-4, JAX's by 1.6e-4,
            # 3.3e-4, 1.8e-3 and 4.0e-3: the gap is the reference's own rounding.
            # Bounds: the port ATOL at levels 2 and 3 and 2e-3 below; JAX 1e-3
            # and 1e-2 (the bound the deepest two levels had against the port).
            exact = nhwc(exacts[i])
            np.testing.assert_allclose(nhwc(got), exact, atol=ATOL if i < 4 else 2e-3,
                                       rtol=RTOL, err_msg=f"level {i}, against float64")
            np.testing.assert_allclose(np.asarray(want), exact, atol=1e-3 if i < 4 else 1e-2,
                                       rtol=RTOL, err_msg=f"level {i}, JAX against float64")
        else:
            close(nhwc(got), want, f"{arch} level {i}")


def test_resnet_stride_to_dilation():
    """replace_stride_with_dilation: Bottleneck dilates, BasicBlock only
    loses the stride (its dilation is clamped to 1)."""
    x = images(2)
    for arch, rswd in (("resnet50", (False, True, True)), ("resnet18", (False, True, True))):
        jmodel = JaxResNetEncoder(arch=arch, replace_stride_with_dilation=rswd)
        variables = perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.asarray(x)), 3)
        port = ResNetEncoder(arch, replace_stride_with_dilation=rswd).eval()
        port.load_state_dict(resnet_from_flax(variables["params"],
                                              variables["batch_stats"]), strict=True)
        wants = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
        with torch.no_grad():
            gots = port(nchw(x))
        assert gots[-1].shape[-1] == gots[-3].shape[-1] == 4  # /8 kept
        for got, want in zip(gots, wants):
            close(nhwc(got), want, arch)


@pytest.mark.parametrize("fused", [True, False], ids=["jax_split_conv", "jax_materialised"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_unet_decoder_matches_jax(fused, train):
    """The port's materialised upsample -> concat -> conv against both JAX
    forms (the split dilated conv is an exact rewrite of it)."""
    rng = np.random.default_rng(4)
    chans = (3, 8, 8, 16, 24, 32)
    feats = [rng.standard_normal((2, 32 // 2 ** i, 32 // 2 ** i, c)).astype(np.float32)
             for i, c in enumerate(chans)]
    jmodel = JaxUnetDecoder(decoder_channels=DEC, fused=fused)
    jfeats = [jnp.asarray(f) for f in feats]
    variables = perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jfeats), 5)
    port = UnetDecoder(chans, DEC)
    sd = unet_decoder_from_flax(variables["params"], variables["batch_stats"])
    port.load_state_dict({k[len("decoder."):]: v for k, v in sd.items()}, strict=True)
    tfeats = [nchw(f) for f in feats]
    if train:
        want, mutated = jax.jit(lambda v, f: jmodel.apply(
            v, f, True, mutable=["batch_stats"]))(variables, jfeats)
        with torch.no_grad():
            got = port.train()(tfeats)

        def name(keys):  # ['block0', 'conv1', 'bn', 'mean']
            leaf = {"mean": "running_mean", "var": "running_var"}[keys[-1]]
            return f"blocks.{keys[0][5:]}.{keys[1]}.1.{leaf}"

        hold_running_stats(port, mutated["batch_stats"], name)
    else:
        want = jax.jit(jmodel.apply)(variables, jfeats)
        with torch.no_grad():
            got = port.eval()(tfeats)
    assert got.shape == (2, DEC[-1], 32, 32)
    close(nhwc(got), want)


@pytest.fixture(scope="module")
def segcd_variables():
    """One JAX SegCD-resnet18 init, perturbed; UnetSeg and FFCTLCD share
    its parameter tree."""
    model = jsegcd.SegCD(encoder_name="resnet18", classes=1, decoder_channels=DEC)
    z = jnp.zeros((1, 32, 32, 3))
    return perturb(jax.jit(model.init)(jax.random.PRNGKey(0), z, z), 7)


def _port(cls, variables, **kw):
    port = cls("resnet18", decoder_channels=DEC, classes=1, **kw)
    port.load_state_dict(unetseg_from_flax(variables["params"], variables["batch_stats"]),
                         strict=True)
    return port


@pytest.mark.parametrize("name", ["SegCD", "FFCTLCD"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_siamese_models_match_jax(segcd_variables, name, train):
    a, b = images(8), images(9)
    jmodel = getattr(jsegcd, name)(encoder_name="resnet18", classes=1, decoder_channels=DEC)
    port = _port(getattr(tsegcd, name), segcd_variables)
    if train:  # the folded pass: BatchNorm statistics over A and B jointly
        wants, _ = jax.jit(lambda v, a, b: jmodel.apply(
            v, a, b, True, mutable=["batch_stats"]))(segcd_variables, jnp.asarray(a),
                                                     jnp.asarray(b))
        with torch.no_grad():
            gots = port.train()(nchw(a), nchw(b))
    else:
        wants = jax.jit(jmodel.apply)(segcd_variables, jnp.asarray(a), jnp.asarray(b))
        with torch.no_grad():
            gots = port.eval()(nchw(a), nchw(b))
    assert len(gots) == len(wants) == 3
    for i, (got, want) in enumerate(zip(gots, wants)):
        assert got.shape == (2, 1, 32, 32)
        close(nhwc(got), want, f"{name} output {i}")


def test_unetseg_matches_jax(segcd_variables):
    x = images(10)
    jmodel = jsegcd.UnetSeg(encoder_name="resnet18", classes=1, decoder_channels=DEC)
    want = jax.jit(jmodel.apply)(segcd_variables, jnp.asarray(x))
    for cls in (tsegcd.UnetSeg, tsegcd.Unet):
        with torch.no_grad():
            got = _port(cls, segcd_variables).eval()(nchw(x))
        close(nhwc(got), want)


@pytest.mark.parametrize("name", ["SegCD", "FFCTLCD"])
def test_siamese_batched_equals_two_passes_in_eval(segcd_variables, name):
    a, b = nchw(images(11)), nchw(images(12))
    cls = getattr(tsegcd, name)
    with torch.no_grad():
        folded = _port(cls, segcd_variables).eval()(a, b)
        apart = _port(cls, segcd_variables, siamese_batched=False).eval()(a, b)
    for f, s in zip(folded, apart):
        torch.testing.assert_close(f, s, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_converter_round_trip_is_exact(arch):
    model = jsegcd.SegCD(encoder_name=arch, classes=1, decoder_channels=DEC)
    z = jnp.zeros((1, 32, 32, 3))
    variables = perturb(jax.jit(model.init)(jax.random.PRNGKey(2), z, z), 13)
    sd = unetseg_from_flax(variables["params"], variables["batch_stats"])
    port = tsegcd.SegCD(arch, decoder_channels=DEC, classes=1)
    port.load_state_dict(sd, strict=True)
    params, stats = convert_unetseg({k: v.numpy() for k, v in port.state_dict().items()},
                                    LAYERS[arch])
    for want_tree, got_tree in ((variables["params"], params),
                                (variables["batch_stats"], stats)):
        want = {jax.tree_util.keystr(p): v
                for p, v in jax.tree_util.tree_flatten_with_path(want_tree)[0]}
        got = {jax.tree_util.keystr(p): v
               for p, v in jax.tree_util.tree_flatten_with_path(got_tree)[0]}
        assert set(want) == set(got)
        for key, v in want.items():
            assert np.array_equal(np.asarray(got[key]), np.asarray(v)), key


def test_input_shape_check_registry_and_init():
    port = tsegcd.SegCD("resnet18", decoder_channels=DEC)
    with pytest.raises(RuntimeError, match=r"divisible by 32.*\(64, 32\)"):
        port(torch.zeros(1, 3, 48, 32), torch.zeros(1, 3, 48, 32))
    with pytest.raises(NotImplementedError, match="Queue 1 #9"):
        get_encoder("vgg16")
    with pytest.raises(ValueError, match="decoder_channels"):
        tsegcd.UnetSeg("resnet18", decoder_channels=(8, 8))
    enc, chans = get_encoder("resnet34")
    assert chans == (3, 64, 64, 128, 256, 512)
    assert len([m for m in enc.layer3]) == 6
    # seeded init: same seed, same weights; the BN affine stays (1, 0)
    w1 = tsegcd.init_weights(tsegcd.SegCD("resnet18", decoder_channels=DEC), 3).state_dict()
    w2 = tsegcd.init_weights(tsegcd.SegCD("resnet18", decoder_channels=DEC), 3).state_dict()
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert torch.all(w1["encoder.bn1.weight"] == 1)
    assert abs(w1["encoder.conv1.weight"].std().item() - (3 * 49) ** -0.5) < 0.01
