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


# --- tools/bench_bnstats.py: the counterpart of benchmarks/bench_bnstats.py ---

import importlib.util  # noqa: E402
import os  # noqa: E402

import ml_dtypes  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from stcd_tpu_torch.tools import bench_bnstats  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_bench_bnstats():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_bnstats", os.path.join(REPO, "benchmarks", "bench_bnstats.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_bench_bnstats_rows_on_the_cpu(capsys):
    rows = bench_bnstats.main(["--device", "cpu", "--rows", "512"])
    assert [r["shape"] for r in rows] == [[512, 1, 1, s[-1]] for s in bench_bnstats.SHAPES]
    assert bench_bnstats.SHAPES[0] == (128, 64, 64, 256) and len(bench_bnstats.SHAPES) == 6
    variants = ("stats_plain", "bn_stats", "stats_gram2", "stats_gramA")
    for row in rows:
        assert row["impl"] == "plain"
        # a CPU run times no device: every time is None, never a host-clock number
        assert all(row[f"{v}_ms"] is None for v in variants) and row["apply_ms"] is None
        assert row["bound_ms"] == pytest.approx(512 * row["c"] * 2 / 3.35e12 * 1e3)
        assert row["apply_bound_ms"] == pytest.approx(2 * row["bound_ms"])
        # bn_stats on a CPU tensor is the plain version itself; the products sum in
        # another order: float32 rounding of sums of 512 values
        assert row["stats_plain_err"] == row["bn_stats_err"] == 0.0
        assert row["stats_gram2_rel_err"] < 1e-5 and row["stats_gramA_rel_err"] < 1e-5
    out = capsys.readouterr().out
    assert out.count("not measured") >= 6 and "torch.Generator(cpu) seed 0" in out


def test_bench_bnstats_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_bnstats.main([])


@pytest.mark.parametrize("shape", [(4, 8, 8, 32), (2, 16, 16, 16), (3, 5, 7, 24)])
@pytest.mark.parametrize("name,jax_name", [("stats_plain", "stats_jnp"),
                                           ("stats_gram2", "stats_gram2"),
                                           ("stats_gramA", "stats_gramA")])
def test_bench_bnstats_formulations_match_jax(jax_bench_bnstats, shape, name, jax_name):
    """The same numpy-seeded bf16 input through the JAX tool's function on the
    CPU and the port's. Both form float32 sums of the exact float32 values of
    bf16 inputs (the products' f32 accumulation on both sides), in different
    orders: within 1e-5 of the largest sum."""
    x = np.random.default_rng(3).standard_normal(shape).astype(ml_dtypes.bfloat16)
    want = getattr(jax_bench_bnstats, jax_name)(jnp.asarray(x))
    got = getattr(bench_bnstats, name)(torch.from_numpy(x.astype(np.float32)).bfloat16())
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (shape[-1],)
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
