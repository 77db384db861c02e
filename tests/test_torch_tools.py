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
