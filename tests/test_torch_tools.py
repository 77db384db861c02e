"""stcd_tpu_torch/tools/profile_step.py: the parts that run without a card.

The profile itself needs a CUDA card; here the device-busy union and the
switch to the plain attention are checked on the CPU."""

import numpy as np
import pytest
import torch

from stcd_tpu_torch.models import changeformer
from stcd_tpu_torch.ops import attention
from stcd_tpu_torch.tools.profile_step import plain_attention, union_length


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0, 2)], 2.0),
    ([(0, 2), (1, 3)], 3.0),           # overlap
    ([(0, 5), (1, 2)], 5.0),           # nested
    ([(4, 6), (0, 1), (1, 2)], 4.0),   # unsorted, touching
])
def test_union_length(spans, want):
    assert union_length(spans) == want


def test_plain_attention_swaps_and_restores_the_sra_call():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 2, 16, 8), (1, 2, 4, 8), (1, 2, 4, 8)))
    with pytest.raises(KeyError):
        with plain_attention():
            swapped = changeformer.cross_attention
            assert swapped.keywords == {"impl": "plain"}
            with torch.no_grad():
                out = swapped(q, k, v)
            torch.testing.assert_close(out, attention.attention_plain(q, k, v, 8 ** -0.5))
            raise KeyError("restored on the way out")
    assert changeformer.cross_attention is attention.cross_attention


def test_seeded_cd_batch_is_fixed_by_its_seed():
    from stcd_tpu_torch.tools.profile_step import seeded_cd_batch

    one, two = (seeded_cd_batch(3, 16, seed=1, device="cpu") for _ in range(2))
    assert one["A"].shape == one["B"].shape == (3, 16, 16, 3)
    assert one["A"].dtype == torch.uint8 and one["label"].shape == (3, 16, 16, 1)
    assert all(torch.equal(one[k], two[k]) for k in one)
    assert not torch.equal(one["A"], one["B"])
    assert 0.1 < one["label"].mean().item() < 0.3
    assert not torch.equal(one["A"], seeded_cd_batch(3, 16, seed=2, device="cpu")["A"])


@pytest.mark.parametrize("mode", ["serve", "train"])
def test_profile_step_needs_a_card(mode, monkeypatch):
    from stcd_tpu_torch.tools import profile_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        profile_step.main(["--mode", mode])


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_profile_step_takes_the_three_stages_and_needs_a_card(stage, monkeypatch):
    """--mode train --stage N parses (default 2); the step itself needs the
    card, and stage_setup's device is the card unless the caller asks for the
    CPU."""
    from stcd_tpu_torch.tools import profile_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        profile_step.main(["--mode", "train", "--stage", str(stage)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_step.stage_setup(stage, bf16=False)
    with pytest.raises(SystemExit):
        profile_step.main(["--mode", "train", "--stage", "4"])


@pytest.mark.parametrize("stage,keys", [
    (1, {"image", "label"}), (2, {"A", "B", "label"}),
    (3, {"A", "B", "CA", "CB", "s_label_A", "c_label", "CL"})])
def test_seeded_stage_batch_feeds_the_stage_step(stage, keys, monkeypatch):
    """The batch of each stage has the keys its step reads, and one step of
    the full-size setup's make_*_steps runs on it (narrowed here to resnet18)."""
    from stcd_tpu_torch.models import segcd
    from stcd_tpu_torch.tools import profile_step

    data = profile_step.seeded_stage_batch(stage, 4, 32, seed=1, device="cpu")
    assert set(data) == keys
    n = 2 if stage == 3 else 4  # stage 3: half synthesized, half real
    assert all(v.shape[0] == n and v.shape[1:3] == (32, 32) for v in data.values())
    again = profile_step.seeded_stage_batch(stage, 4, 32, seed=1, device="cpu")
    assert all(torch.equal(data[k], again[k]) for k in data)
    if stage == 3:
        assert not torch.equal(data["A"], data["CA"])
        with pytest.raises(ValueError, match="even batch"):
            profile_step.seeded_stage_batch(3, 3, 32, seed=1, device="cpu")

    narrow = {"UnetSeg": segcd.UnetSeg, "SegCD": segcd.SegCD}
    for name, cls in narrow.items():
        monkeypatch.setattr(segcd, name, lambda enc, classes, decoder_channels, cls=cls: cls(
            "resnet18", classes=classes, decoder_channels=(32, 24, 16, 12, 8)))
    state, train_step, eval_step = profile_step.stage_setup(stage, bf16=False, device="cpu")
    out = train_step(state, data, torch.Generator().manual_seed(0))
    assert torch.isfinite(out["loss"]) and state.step == 1
    assert int(out["cm"].sum()) == 4 * 32 * 32


def test_plain_attention_also_swaps_the_bit_decoder_call():
    from stcd_tpu_torch.models import bit

    with plain_attention():
        assert bit.cross_attention.keywords == {"impl": "plain"}
    assert bit.cross_attention is attention.cross_attention


@pytest.mark.parametrize("net_G", ["ChangeFormerV6", "base_transformer_pos_s4_dd8"])
def test_trainer_setups_are_trainer_configs(net_G):
    """The full-size setups name real TrainerConfig fields and models, and
    --mode train takes them; the step itself needs the card."""
    from stcd_tpu_torch.tools import profile_step
    from stcd_tpu_torch.train.trainer import TrainerConfig

    cfg = TrainerConfig(net_G=net_G, **profile_step.TRAINER_SETUPS[net_G])
    assert cfg.img_size in (256, 512) and cfg.batch_size in (8, 32)
    assert set(profile_step.TRAIN_GROUPS) >= {"attention_fwd", "attention_bwd",
                                              "augment_kernel", "optimizer"}


def test_profile_step_train_refuses_an_unknown_net_g():
    from stcd_tpu_torch.tools import profile_step

    with pytest.raises(SystemExit, match="--mode train takes"):
        profile_step.main(["--mode", "train", "--net_G", "SNUNet"])
