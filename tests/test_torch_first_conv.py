"""stcd_tpu_torch.convert.pretrained.patch_first_conv against the JAX
package's own function (stcd_tpu/convert/torch_to_flax.py:1099), which works
on HWIO kernels where the port's works on OIHW tensors.

(a) One set of stem weights, transposed to HWIO for JAX: the adapted stem of
    every new width equal to JAX's, exactly (the same float32 products).
(b) For one encoder of every family of get_encoder, both functions pick the
    same stem: the JAX tree of random variables (shapes by jax.eval_shape,
    values from numpy) and the port's state_dict of it
    (convert.from_flax.encoder_from_flax) hold the same weights, and the
    tensor each function changes is the other's, transposed.
(c) The refusal and the identity width, and the create_model message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stcd_tpu import encoders as jenc
from stcd_tpu.convert.torch_to_flax import patch_first_conv as jax_patch_first_conv
from stcd_tpu_torch.convert.from_flax import encoder_from_flax
from stcd_tpu_torch.convert.pretrained import patch_first_conv
from stcd_tpu_torch.models import create_model


def _hwio(w: torch.Tensor) -> np.ndarray:
    return w.numpy().transpose(2, 3, 1, 0)


@pytest.mark.parametrize("new", [1, 2, 4, 7])
def test_adapted_stem_equals_jax(new):
    rng = np.random.default_rng(new)
    stem = torch.from_numpy(rng.standard_normal((64, 3, 7, 7)).astype(np.float32))
    bn = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    got = patch_first_conv({"conv1.weight": stem, "bn1.weight": bn}, new)
    want = jax_patch_first_conv({"bn1": {"scale": bn.numpy()},
                                 "conv1": {"kernel": _hwio(stem)}}, new)
    assert got["conv1.weight"].shape == (64, new, 7, 7)
    assert got["conv1.weight"].dtype == torch.float32
    np.testing.assert_array_equal(_hwio(got["conv1.weight"]), want["conv1"]["kernel"])
    assert got["bn1.weight"] is bn


def _random_variables(name, seed):
    """The JAX encoder's variables, shaped by eval_shape and drawn with numpy."""
    module, _ = jenc.get_encoder(name)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


# one encoder of each family of get_encoder
FAMILY_MEMBERS = ["resnet18", "vgg11", "mit_b0", "efficientnet-b0", "timm-efficientnet-b0",
                  "mobilenet_v2", "timm-mobilenetv3_small_075", "se_resnet50", "densenet121",
                  "timm-regnetx_002", "dpn68", "xception", "inceptionv4", "inceptionresnetv2",
                  "timm-res2net50_26w_4s", "timm-resnest14d", "timm-skresnet18",
                  "timm-gernet_s", "mobileone_s0"]


@pytest.mark.parametrize("name", FAMILY_MEMBERS)
def test_both_pick_the_same_stem(name):
    variables = _random_variables(name, seed=len(name))
    sd = encoder_from_flax(name, variables["params"], variables.get("batch_stats", {}))
    got = patch_first_conv(sd, 2)
    changed = [k for k in sd if got[k] is not sd[k]]
    assert len(changed) == 1, changed
    stem = changed[0]
    assert stem == next(k for k, v in sd.items() if v.dim() == 4 and v.shape[1] == 3)

    want = jax_patch_first_conv(variables["params"], 2)
    before = jax.tree_util.tree_leaves(variables["params"])
    after = jax.tree_util.tree_leaves(want)
    moved = [(b, a) for b, a in zip(before, after) if a.shape != b.shape or a is not b]
    assert len(moved) == 1
    np.testing.assert_array_equal(_hwio(sd[stem]), moved[0][0])
    np.testing.assert_array_equal(_hwio(got[stem]), moved[0][1])


def test_refusal_identity_and_the_create_model_message():
    with pytest.raises(ValueError, match="no stem conv with 3 input channels"):
        patch_first_conv({"fc.weight": torch.zeros(4, 3)}, 4)
    sd = {"conv.weight": torch.ones(8, 3, 3, 3)}
    same = patch_first_conv(sd, 3)
    assert same == sd and same is not sd
    with pytest.raises(NotImplementedError, match="patch_first_conv"):
        create_model("unet", "resnet18", encoder_weights="imagenet", in_channels=4)
