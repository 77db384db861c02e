"""The port's SENet, DenseNet, DPN, Xception, Inception and Res2Net /
ResNeSt / SKNet encoders against the JAX package's, float32 on the CPU.

(a) The eval pyramid of each family's representative of
    tests/test_encoders_zoo.py (and dpn68b, the b variant, and
    timm-resnest50d_4s2x40d, radix 4 over 2 groups with the avd pool first)
    at 64x64, batch 2, within ATOL 1e-4 + RTOL 1e-4 of JAX
    (``test_torch_smp_encoders._hold``).
(b) Output stride 16 and 8 for the families tests/test_encoders_dilated.py
    dilates, and JAX's ValueError, word for word, for the rest.
(c) ``convert_<family>(<family>_from_flax(tree)) == tree`` exactly, with the
    JAX package's own converter, which pins the upstream state_dict names
    (senet154 at depth 2: its three-conv stem).
(d) The train-mode pyramid and running statistics of timm-resnest14d and
    dpn68 against JAX and against float64 of the port (TRAIN_BOUNDS, as
    measured).
(e) ``in_channels=4``.

``--encoder_weights`` and the int8 conv sites over the new families are held
in tests/test_torch_encoders_mobile.py.
"""

import pytest
import torch

from stcd_tpu import encoders as jenc
from stcd_tpu.convert import torch_to_flax as jconv
from stcd_tpu_torch import encoders as tenc

from test_torch_encoders_mobile import _setup, hold_train, roundtrip
from test_torch_smp_encoders import _hold, _pyramids

# (pyramid to JAX, pyramid to float64, statistics to JAX, statistics to float64),
# of the largest float64 entry of each level or statistic; measured:
# timm-resnest14d 7.3e-3, 2.7e-3, 1.9e-4, 6.8e-5; dpn68 3.4e-4, 1.1e-4, 3.5e-5, 1.0e-5.
# Both come from level 5, a train-mode BatchNorm over 2 x 2 x 2 values a channel,
# where JAX's own float32 run is further off float64 than the port's (resnest14d
# 4.6e-3 against the port's 2.7e-3; dpn68 3.3e-4 against 1.1e-4).
TRAIN_BOUNDS = {"timm-resnest14d": (1e-2, 5e-3, 5e-4, 2e-4),
                "dpn68": (5e-4, 2e-4, 5e-5, 2e-5)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["se_resnet50", "se_resnext50_32x4d", "senet154",
                                  "densenet121", "dpn68", "dpn68b", "xception", "inceptionv4",
                                  "inceptionresnetv2", "timm-res2net50_26w_4s",
                                  "timm-resnest14d", "timm-resnest50d_4s2x40d",
                                  "timm-skresnet18", "timm-skresnext50_32x4d"])
def test_representative_pyramid_matches_jax(name):
    got, want, _ = _pyramids(name, 64, seed=1)
    _hold(got, want)


@pytest.mark.parametrize("name,output_stride", [
    ("se_resnet50", 16), ("se_resnet50", 8), ("dpn68", 16), ("dpn68", 8),
    ("timm-skresnet18", 16), ("timm-skresnet18", 8), ("timm-skresnext50_32x4d", 8)])
def test_dilated_matches_jax(name, output_stride):
    got, want, _ = _pyramids(name, 64, seed=2, output_stride=output_stride)
    _hold(got, want)
    assert [g.shape[2] for g in got] == [64, 32, 16, 8] + (
        [4, 4] if output_stride == 16 else [8, 8])


@pytest.mark.parametrize("name", ["densenet121", "xception", "inceptionv4",
                                  "inceptionresnetv2", "timm-res2net50_26w_4s",
                                  "timm-resnest14d"])
def test_dilation_refusals_match_jax(name):
    with pytest.raises(ValueError) as want:
        jenc.get_encoder(name, output_stride=16)
    with pytest.raises(ValueError) as got:
        tenc.get_encoder(name, output_stride=16)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name,convert,depth", [
    ("se_resnet50", jconv.convert_senet, 5),
    ("senet154", jconv.convert_senet, 2),  # its three-conv stem; the blocks are se_resnet50's
    ("densenet121", jconv.convert_densenet, 5),
    ("dpn68", jconv.convert_dpn, 5),
    ("dpn68b", jconv.convert_dpn, 5),
    ("xception", jconv.convert_xception, 5),
    ("inceptionv4", jconv.convert_inceptionv4, 5),
    ("inceptionresnetv2", jconv.convert_inceptionresnetv2, 5),
    ("timm-res2net50_26w_4s", jconv.convert_timm_res2net, 5),
    ("timm-resnest14d", jconv.convert_timm_resnest, 5),
    ("timm-skresnet18", jconv.convert_timm_sknet, 5),
    ("timm-skresnext50_32x4d", jconv.convert_timm_sknet, 5),
])
def test_from_flax_inverts_the_jax_converter(name, convert, depth):
    roundtrip(name, convert, depth)


@pytest.mark.parametrize("name", ["timm-resnest14d", "dpn68"])
def test_train_pyramid_and_running_stats_match_jax(name):
    hold_train(TRAIN_BOUNDS[name], name, *_setup(name, seed=4))


def test_in_channels_4_matches_jax():
    got, want, port = _pyramids("timm-skresnet18", 32, seed=7, in_channels=4)
    assert port.conv1.in_channels == 4
    _hold(got, want)
