"""The port's EfficientNet, MobileNet, RegNet, GERNet and MobileOne encoders
against the JAX package's, float32 on the CPU; and ``--encoder_weights`` and
the int8 conv sites over the new families.

(a) The eval pyramid of each family's representative of
    tests/test_encoders_zoo.py (and timm-efficientnet-b0, the timm names with
    squeeze-excite) at 64x64, batch 2, within ATOL 1e-4 + RTOL 1e-4 of JAX
    (``test_torch_smp_encoders._hold``). MobileOne's random-weight activations
    grow to about 1e13 (each block sums up to six BatchNorm branches), where
    float32 cancellation alone sets absolute errors of 1e7 on both sides: its
    levels are held to MOBILEONE_BOUND of the level's largest float64 value,
    against JAX and against a float64 run of the port.
(b) Output stride 16 and 8 for the families tests/test_encoders_dilated.py
    dilates, against JAX, with the deepest levels at /16 or /8.
(c) ``convert_<family>(<family>_from_flax(tree)) == tree`` exactly, with the
    JAX package's own converter, which pins the upstream state_dict names.
(d) The train-mode pyramid and running statistics of efficientnet-b0
    (drop_connect 0 on both sides) and timm-mobilenetv3_large_100 against
    JAX and against float64 of the port (TRAIN_BOUNDS, as measured), and the
    gradients of timm-regnety_002 against JAX's.
(e) drop_connect draws its per-sample masks from the step's generator.
(f) ``in_channels=4``, and ``make_cd_steps`` steps of SegCD over
    efficientnet-b0 and mobileone_s0 at narrow decoder widths.
(g) ``--encoder_weights`` over the new families: an upstream-named
    state_dict with its classifier or head keys (efficientnet-b0,
    se_resnet50, densenet121 also under its legacy names, timm-regnetx_002,
    and timm-skresnet18 without ``fc_select``'s bias, which timm's files
    lack) loads strictly through ``create_train_state(encoder_weights=...)``
    and gives the forward of the tree it came from; a fused MobileOne file
    raises.
(h) ``cli.evaluate --int8``'s conv-site sequence and quantized count for
    SegCD over efficientnet-b0 and over se_resnet50 are the JAX package's
    (``serving/quant.py``) on the same model.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stcd_tpu import encoders as jenc
from stcd_tpu.convert import torch_to_flax as jconv
from stcd_tpu_torch import encoders as tenc
from stcd_tpu_torch.convert.from_flax import encoder_from_flax
from stcd_tpu_torch.layers.stochastic import DropPath, set_generator

from test_torch_changeformer import _nchw
from test_torch_smp_encoders import _hold, _pyramids
from test_torch_train_steps import _float64_through_the_losses
from test_torch_zoo_siam import jax_variables

MOBILEONE_BOUND = 1e-5
# (pyramid to JAX, pyramid to float64, statistics to JAX, statistics to float64),
# of the largest float64 entry of each level or statistic; measured:
# efficientnet-b0 3.0e-5, 1.2e-5, 6.8e-7, 4.1e-7;
# timm-mobilenetv3_large_100 5.3e-5, 2.8e-5, 1.5e-5, 6.1e-6
TRAIN_BOUNDS = {"efficientnet-b0": (1e-4, 5e-5, 5e-6, 5e-6),
                "timm-mobilenetv3_large_100": (2e-4, 1e-4, 5e-5, 2e-5)}
GRAD_TO_JAX, GRAD_TO_64 = 5e-5, 2e-5  # measured: 6.4e-6 and 2.8e-6
N = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(name, hw=64, seed=1, **kw):
    """JAX module, variables, input and the port loaded from the same tree."""
    jmodule, _ = jenc.get_encoder(name, **kw)
    variables = jax_variables(jmodule, hw, seed, args=(jnp.zeros((1, hw, hw, 3)),))
    x = np.random.default_rng(seed + 1).standard_normal((N, hw, hw, 3)).astype(np.float32)
    port, _ = tenc.get_encoder(name, **kw)
    port.load_state_dict(encoder_from_flax(name, variables["params"],
                                           variables.get("batch_stats", {})), strict=True)
    return jmodule, variables, x, port


def _level_err(got, want):
    return float(np.abs(got.double().numpy().transpose(0, 2, 3, 1) - np.asarray(want)).max())


@pytest.mark.parametrize("name", ["efficientnet-b0", "timm-efficientnet-b0",
                                  "timm-tf_efficientnet_lite0", "mobilenet_v2",
                                  "timm-mobilenetv3_large_100", "timm-mobilenetv3_small_075",
                                  "timm-regnetx_002", "timm-regnety_002", "timm-gernet_s"])
def test_representative_pyramid_matches_jax(name):
    got, want, _ = _pyramids(name, 64, seed=1)
    _hold(got, want)


def test_mobileone_pyramid_matches_jax_and_float64():
    jmodule, variables, x, port = _setup("mobileone_s0")
    want = jax.jit(jmodule.apply)(variables, jnp.asarray(x))
    with torch.no_grad(), _float64_through_the_losses():
        got = port.eval()(_nchw(x))
        exact = port.double()(_nchw(x).double())
    assert max(float(e.abs().max()) for e in exact) > 1e9  # the growth the bound is for
    for i, (g, w, e) in enumerate(zip(got, want, exact)):
        scale = float(e.abs().max())
        assert _level_err(g, w) <= MOBILEONE_BOUND * scale, ("JAX", i)
        assert float((g.double() - e).abs().max()) <= MOBILEONE_BOUND * scale, ("float64", i)


@pytest.mark.parametrize("output_stride", [16, 8])
@pytest.mark.parametrize("name", ["efficientnet-b0", "mobilenet_v2",
                                  "timm-mobilenetv3_large_100", "timm-regnety_002",
                                  "timm-gernet_s"])
def test_dilated_matches_jax(name, output_stride):
    got, want, _ = _pyramids(name, 64, seed=2, output_stride=output_stride)
    _hold(got, want)
    assert [g.shape[2] for g in got] == [64, 32, 16, 8] + (
        [4, 4] if output_stride == 16 else [8, 8])


@pytest.mark.parametrize("output_stride", [16, 8])
def test_dilated_mobileone_matches_jax(output_stride):
    jmodule, variables, x, port = _setup("mobileone_s0", output_stride=output_stride)
    want = jax.jit(jmodule.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(_nchw(x))
    for i, (g, w) in enumerate(zip(got, want)):
        assert _level_err(g, w) <= MOBILEONE_BOUND * float(np.abs(np.asarray(w)).max()), i
    assert [g.shape[2] for g in got] == [64, 32, 16, 8] + (
        [4, 4] if output_stride == 16 else [8, 8])


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def roundtrip(name, convert, depth=5):
    """convert(from_flax(tree)) == tree: the keys and every array exactly."""
    jmodule, _ = jenc.get_encoder(name, depth=depth)
    variables = jax_variables(jmodule, 64, 3, args=(jnp.zeros((1, 64, 64, 3)),))
    sd = {k: v.numpy() for k, v in encoder_from_flax(name, variables["params"],
                                                      variables["batch_stats"]).items()}
    params, stats = convert(sd)
    for mine, theirs in ((params, variables["params"]), (stats, variables["batch_stats"])):
        a, b = _flat(mine), _flat(theirs)
        assert a.keys() == b.keys(), sorted(set(a) ^ set(b))[:6]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the names an upstream checkpoint has are the port's own
    assert set(sd) == set(tenc.get_encoder(name, depth=depth, device="meta")[0].state_dict())


@pytest.mark.parametrize("name,convert", [
    ("efficientnet-b0", jconv.convert_efficientnet),
    ("timm-efficientnet-b0", jconv.convert_timm_efficientnet),
    ("timm-tf_efficientnet_lite0", jconv.convert_timm_efficientnet),
    ("mobilenet_v2", jconv.convert_mobilenet_v2),
    ("timm-mobilenetv3_large_100", jconv.convert_mobilenet_v3),
    ("timm-mobilenetv3_small_075", jconv.convert_mobilenet_v3),
    ("timm-regnety_002", jconv.convert_timm_regnet),
    ("timm-gernet_s", jconv.convert_timm_gernet),
    ("mobileone_s0", jconv.convert_mobileone),
])
def test_from_flax_inverts_the_jax_converter(name, convert):
    roundtrip(name, convert)


def _stats(sd):
    return {k: v.double().numpy() for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def hold_train(bounds, name, jmodule, variables, x, port):
    """The train-mode pyramid and running statistics against JAX and
    against float64 of the port, within ``bounds`` (as TRAIN_BOUNDS')."""
    port64 = tenc.get_encoder(name)[0]
    port64.load_state_dict(port.state_dict())
    port64.double()
    for m in list(port.modules()) + list(port64.modules()):
        if isinstance(m, DropPath):
            m.rate = 0.0
    wants, mutated = jax.jit(lambda v, a: jmodule.apply(v, a, True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    with torch.no_grad(), _float64_through_the_losses():
        gots = port.train()(_nchw(x))
        exact = port64.train()(_nchw(x).double())
    errs = np.zeros(4)
    for g, w, e in zip(gots, wants, exact):
        scale = float(e.abs().max())
        errs[:2] = np.maximum(errs[:2], [_level_err(g, w) / scale,
                                         float((g.double() - e).abs().max()) / scale])
    got, ref = _stats(port.state_dict()), _stats(port64.state_dict())
    want = _stats(encoder_from_flax(name, variables["params"], mutated["batch_stats"]))
    old = _stats(encoder_from_flax(name, variables["params"], variables["batch_stats"]))
    assert got.keys() == want.keys() and want
    for k in want:
        scale = float(np.abs(ref[k]).max())
        errs[2:] = np.maximum(errs[2:], [float(np.abs(got[k] - want[k]).max()) / scale,
                                         float(np.abs(got[k] - ref[k]).max()) / scale])
        assert not np.allclose(got[k], old[k]), k
    assert np.all(errs <= bounds), (name, errs)


@pytest.mark.parametrize("name", ["efficientnet-b0", "timm-mobilenetv3_large_100"])
def test_train_pyramid_and_running_stats_match_jax(name):
    jmodule, variables, x, port = _setup(name, seed=4)
    if name.startswith("efficientnet"):
        jmodule = jmodule.clone(drop_connect_rate=0.0)
    hold_train(TRAIN_BOUNDS[name], name, jmodule, variables, x, port)


def test_regnety_gradients_match_jax():
    """The squared error of the train-mode level 4 (/16) to a fixed target:
    every gradient (stem, s1 .. s3) against JAX's and against float64 of the
    port, of the largest float64 gradient entry. Not level 5: its train-mode
    BatchNorm over 2 x 2 x 2 values a channel leaves both frameworks' float32
    gradients 2 % off float64 (measured; they agree with each other to 0.4 %)."""
    name = "timm-regnety_002"
    jmodule, variables, x, port = _setup(name, seed=5)
    target = np.random.default_rng(6).standard_normal((N, 4, 4, 152)).astype(np.float32)

    def loss_fn(params):
        out, _ = jmodule.apply({**variables, "params": params}, jnp.asarray(x), True,
                               mutable=["batch_stats"])
        return jnp.mean((out[4] - target) ** 2)

    want = encoder_from_flax(name, jax.jit(jax.grad(loss_fn))(variables["params"]),
                             variables["batch_stats"])
    ((port.train()(_nchw(x))[4] - _nchw(target)) ** 2).mean().backward()
    port64 = tenc.get_encoder(name)[0]
    port64.load_state_dict(encoder_from_flax(name, variables["params"],
                                             variables["batch_stats"]))
    port64.double().train()
    with _float64_through_the_losses():
        ((port64(_nchw(x).double())[4] - _nchw(target).double()) ** 2).mean().backward()
    exact = {k: p.grad.numpy() for k, p in port64.named_parameters() if p.grad is not None}
    assert {k.split(".")[0] for k in exact} == {"stem", "s1", "s2", "s3"}
    scale = max(float(np.abs(g).max()) for g in exact.values())
    for key, p in port.named_parameters():
        if key not in exact:
            assert p.grad is None, key
            continue
        got = p.grad.double().numpy()
        assert float(np.abs(got - want[key].numpy()).max()) <= GRAD_TO_JAX * scale, key
        assert float(np.abs(got - exact[key]).max()) <= GRAD_TO_64 * scale, key


def test_drop_connect_draws_from_the_step_generator():
    """Same seed, same output; another seed, another; and a block drops its
    residual branch for a share of the samples near its rate, scaling the
    kept ones by 1 / keep."""
    port = tenc.get_encoder("efficientnet-b0", depth=3)[0].train()
    paths = [m for m in port.modules() if isinstance(m, DropPath)]
    assert paths and max(m.rate for m in paths) > 0
    for m in paths:
        m.rate = 0.5
    x = torch.randn(4, 3, 32, 32)

    def run(seed):
        set_generator(port, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            return port(x)[-1]

    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    block = port._blocks[2]  # 24 -> 24, stride 1: a residual block
    assert block.residual
    block.drop_path.rate = 0.5
    h = torch.randn(4000, 24, 4, 4)
    set_generator(block, torch.Generator().manual_seed(3))
    with torch.no_grad():
        out = block(h) - h
        block.drop_path.rate = 0.0
        branch = block(h) - h
    ratio = (out.flatten(1) / branch.flatten(1)).median(1).values
    kept = ratio > 1.0
    assert torch.allclose(ratio[kept], torch.full_like(ratio[kept], 2.0), rtol=1e-4)
    assert torch.all(out.flatten(1)[~kept].abs().max(1).values == 0)
    share = kept.float().mean().item()
    assert abs(share - 0.5) < 4 * (0.25 / 4000) ** 0.5, share


def test_in_channels_4_matches_jax():
    got, want, port = _pyramids("efficientnet-b0", 32, seed=7, in_channels=4)
    assert port._conv_stem.in_channels == 4
    _hold(got, want)


def test_mobileone_cd_step_on_the_cpu():
    """make_cd_steps steps over SegCD-mobileone_s0 on the CPU, and the stem
    block's forward and backward on 4 threads: the step's channels_last images
    meet the stem's strided 1x1 scale branch, whose CPU backward over 3
    channels corrupts the heap in PyTorch's own kernel when it runs on several
    threads; the block gives that branch a contiguous copy
    (encoders/mobileone.py)."""
    from stcd_tpu_torch.encoders.mobileone import MobileOneBlock
    from stcd_tpu_torch.models.segcd import SegCD, init_weights
    from stcd_tpu_torch.train.state import adam_poly, create_train_state
    from stcd_tpu_torch.train.steps import make_cd_steps
    stem = MobileOneBlock(3, 48, 3, 2).train()
    x = torch.randn(2, 3, 64, 64).contiguous(memory_format=torch.channels_last)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        for _ in range(5):
            stem(x).square().mean().backward()
    finally:
        torch.set_num_threads(threads)
    model = init_weights(SegCD("mobileone_s0", decoder_channels=(16, 12, 8, 8, 8)), seed=0)
    state = create_train_state(model, adam_poly(1e-3, 2, 3), device="cpu")
    rng = np.random.default_rng(13)
    batch = {"A": torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)),
             "B": torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)),
             "label": torch.from_numpy((rng.random((2, 32, 32, 1)) > 0.8).astype(np.float32))}
    train_step, _ = make_cd_steps(augment=True)
    for _ in range(2):
        assert torch.isfinite(train_step(state, batch, torch.Generator().manual_seed(0))["loss"])
    assert state.step == 2


def test_segcd_efficientnet_b0_cd_step():
    """One make_cd_steps step with the augmentation over SegCD-efficientnet-b0
    at narrow decoder widths: a finite loss, step 1, every parameter and
    running statistic of the encoder moved."""
    from stcd_tpu_torch.models.segcd import SegCD, init_weights
    from stcd_tpu_torch.train.state import adam_poly, create_train_state
    from stcd_tpu_torch.train.steps import make_cd_steps
    model = init_weights(SegCD("efficientnet-b0", decoder_channels=(32, 24, 16, 12, 8)), seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, adam_poly(1e-3, 2, 3), device="cpu")
    rng = np.random.default_rng(8)
    batch = {"A": torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)),
             "B": torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)),
             "label": torch.from_numpy((rng.random((2, 64, 64, 1)) > 0.8).astype(np.float32))}
    train_step, _ = make_cd_steps(augment=True)
    loss = train_step(state, batch, torch.Generator().manual_seed(0))["loss"]
    assert torch.isfinite(loss) and state.step == 1
    after = state.model.state_dict()
    moved = [k for k in before if k.startswith("encoder.") and "num_batches" not in k
             and not torch.equal(before[k], after[k])]
    assert len(moved) == sum(1 for k in before if k.startswith("encoder.")
                             and "num_batches" not in k)


# encoder name -> the upstream checkpoint's classifier keys
HEADS = {"efficientnet-b0": {"_conv_head.weight": (1280, 320, 1, 1), "_bn1.weight": (1280,),
                             "_fc.weight": (1000, 1280), "_fc.bias": (1000,)},
         "se_resnet50": {"last_linear.weight": (1000, 2048), "last_linear.bias": (1000,)},
         "densenet121": {"classifier.weight": (1000, 1024), "classifier.bias": (1000,)},
         "timm-regnetx_002": {"head.fc.weight": (1000, 368), "head.fc.bias": (1000,)},
         "timm-skresnet18": {"fc.weight": (1000, 512), "fc.bias": (1000,)}}


def _legacy(key):
    """torchvision's old DenseNet names: ``norm1`` -> ``norm.1``."""
    import re
    return re.sub(r"(denselayer\d+\.(?:norm|conv))([12])\.", r"\1.\2.", key)


@pytest.mark.parametrize("name,variant", [("efficientnet-b0", None), ("se_resnet50", None),
                                          ("densenet121", None), ("densenet121", "legacy"),
                                          ("timm-regnetx_002", None),
                                          ("timm-skresnet18", "no fc_select bias")])
def test_encoder_weights_load_upstream_files(tmp_path, name, variant):
    from stcd_tpu_torch.models.segcd import SegCD
    from stcd_tpu_torch.train.state import adam_poly, create_train_state
    jmodule, _ = jenc.get_encoder(name)
    variables = jax_variables(jmodule, 32, 9, args=(jnp.zeros((1, 32, 32, 3)),))
    sd = encoder_from_flax(name, variables["params"], variables["batch_stats"])
    if variant == "no fc_select bias":  # timm's SelectiveKernelAttn has none
        for k in [k for k in sd if k.endswith("fc_select.bias")]:
            del sd[k]
    want = tenc.get_encoder(name)[0]
    want.load_state_dict(encoder_from_flax(name, variables["params"],
                                           variables["batch_stats"]))
    if variant == "no fc_select bias":
        for m in want.modules():
            if hasattr(m, "fc_select"):
                m.fc_select.bias.data.zero_()
    if variant == "legacy":  # torchvision's old files have no num_batches_tracked
        sd = {_legacy(k): v for k, v in sd.items() if "num_batches" not in k}
        assert any("norm.1" in k for k in sd)
    sd.update({k: torch.zeros(shape) for k, shape in HEADS[name].items()})
    torch.save(sd, tmp_path / "w.pth")
    model = SegCD(name, decoder_channels=(16, 12, 8, 8, 8))
    state = create_train_state(model, adam_poly(), device="cpu",
                               encoder_weights=str(tmp_path / "w.pth"))
    x = torch.randn(2, 3, 32, 32)
    with torch.no_grad():
        got, ref = state.model.encoder.eval()(x), want.eval()(x)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_fused_mobileone_file_raises(tmp_path):
    sd = tenc.get_encoder("mobileone_s0")[0].state_dict()
    sd["stage0.reparam_conv.weight"] = torch.zeros(48, 3, 3, 3)
    torch.save(sd, tmp_path / "fused.pth")
    with pytest.raises(ValueError, match="fused"):
        tenc.get_encoder("mobileone_s0", weights=str(tmp_path / "fused.pth"))


@pytest.mark.parametrize("name", ["efficientnet-b0", "se_resnet50"])
def test_int8_sites_match_jax(name):
    """``cli.evaluate --int8``'s table: the conv sites of SegCD over a new
    family, their order (the NaN pattern of the grouped and depthwise ones
    and the narrow stem), their scales and the quantized count, as the JAX
    package calibrates them on the same weights and images."""
    from stcd_tpu.models import segcd as jsegcd
    from stcd_tpu.serving import quant as jq
    from stcd_tpu_torch.convert.from_flax import unetseg_from_flax
    from stcd_tpu_torch.models import segcd as tsegcd
    from stcd_tpu_torch.serving import quant as tq
    dec = (16, 12, 8, 8, 8)
    jmodel = jsegcd.SegCD(encoder_name=name, classes=1, decoder_channels=dec)
    z = jnp.zeros((1, 32, 32, 3))
    variables = jax_variables(jmodel, 32, 11, args=(z, z))
    port = tsegcd.SegCD(name, decoder_channels=dec, classes=1).eval()
    port.load_state_dict(unetseg_from_flax(variables["params"], variables["batch_stats"],
                                           encoder_name=name), strict=True)
    rng = np.random.default_rng(12)
    a, b = (rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    jscales = jq.calibrate_conv_scales(lambda x, y: jmodel.apply(variables, x, y)[2],
                                       [(jnp.asarray(a), jnp.asarray(b))])
    scales = tq.calibrate_conv_scales(port, lambda x, y: port(x, y)[2],
                                      [(_nchw(a), _nchw(b))])
    assert scales.shape == jscales.shape and scales.shape[0] > 50
    np.testing.assert_array_equal(np.isnan(scales), np.isnan(jscales))
    np.testing.assert_allclose(scales, jscales, rtol=1e-4)
    assert 0 < tq.n_quantized_sites(scales) == jq.n_quantized_sites(jscales)
    assert np.isnan(scales).any()  # the depthwise or grouped convs stay float
