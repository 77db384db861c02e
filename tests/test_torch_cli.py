"""The port's stage CLIs (stcd_tpu_torch/cli) on the CPU at a tiny size
(resnet18, decoder 16..4, 32x32 tiles of the demo tree, batch 2): each stage
ends with the weights of run_training wired by hand over the same datasets,
loader, weights seed and generator; --float_transfer gives the uint8 run's
weights; --select_data ranks like select_reliable over separately built
states; the whole pipeline demo runs; without a card a CLI raises."""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from stcd_tpu_torch.cli import (common, evaluate, make_demo_data, pipeline_demo, train_ffctl,
                                train_pse_cd, train_stcd, train_sup)
from stcd_tpu_torch.data import datasets as ds
from stcd_tpu_torch.data.io import read_list, set_uint8_transfer
from stcd_tpu_torch.data.loader import DataLoader
from stcd_tpu_torch.models.segcd import SegCD, UnetSeg, init_weights
from stcd_tpu_torch.train.checkpoint import CheckpointManager
from stcd_tpu_torch.train.loops import run_training, select_reliable
from stcd_tpu_torch.train.state import adam_poly, create_train_state
from stcd_tpu_torch.train.steps import make_cd_steps, make_seg_steps, make_semi_cd_steps

DEC = (16, 12, 8, 6, 4)
SEED = 1337  # the CLIs' default --seed
TINY = ["--encoder", "resnet18", "--decoder_channels", ",".join(map(str, DEC)),
        "--batch_size", "2", "--img_height", "32", "--img_width", "32", "--device", "cpu",
        "--no_preempt"]
LEVIR = ["--dataset_name", "LEVIR", "--CDdataset_name", "LEVIR"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("demo") / "data")
    make_demo_data.make_tree(root, n=4, size=32)
    return root


@pytest.fixture(autouse=True)
def drop_runs(tmp_path):
    """Delete the test's run directories when it ends: each holds checkpoints
    of hundreds of MB, and pytest keeps the temporary directories of its last
    three runs."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (at these sizes more threads cost CPU time and buy
    little, and the suite runs several files at once), and the scalar log as
    JSON lines only: importing TensorBoard imports TensorFlow."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def float_transfer_after():
    """The CLIs switch the host transfer to uint8; leave it as the tests found it."""
    yield
    set_uint8_transfer(False)


def _state_dicts_equal(got, want):
    assert got.keys() == want.keys() and len(want) > 50
    for name, tensor in want.items():
        assert torch.equal(got[name], tensor), name


STAGES = {
    1: (train_sup.main, ["--dataset_name", "WHU-AB"], UnetSeg, make_seg_steps,
        lambda root: (ds.WHUDataset(root, "WHU-AB", "train"),
                      ds.WHUDataset(root, "WHU-AB", "val"))),
    2: (train_pse_cd.main, LEVIR, SegCD, make_cd_steps,
        lambda root: (ds.PSEDataset(root, "LEVIR", "train"),
                      ds.CDDataset(root, "LEVIR", "val"))),
    3: (train_stcd.main, LEVIR, SegCD, make_semi_cd_steps,
        lambda root: (ds.LEVIRDataset(root, "LEVIR", "train"),
                      ds.CDDataset(root, "LEVIR", "val"))),
}


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_stage_cli_equals_run_training_wired_by_hand(data, tmp_path, stage):
    cli_main, dataset_args, cls, make_steps, datasets = STAGES[stage]
    got = cli_main([*TINY, "--root_path", data, *dataset_args, "--n_epochs", "1",
                    "--save_name", str(tmp_path / "cli")])
    assert got["state"].step == 2 and len(got["history"]) == 1

    set_uint8_transfer(True)
    train_ds, val_ds = datasets(data)
    train = DataLoader(train_ds, 2, shuffle=True, num_workers=4, seed=SEED, drop_last=True,
                       device="cpu")
    val = DataLoader(val_ds, 4, num_workers=4, device="cpu")
    model = init_weights(cls("resnet18", classes=1, decoder_channels=DEC), seed=SEED)
    state = create_train_state(model, adam_poly(1e-3, 1, len(train)), device="cpu")
    train_step, eval_step = make_steps(augment=True)
    _, best, history = run_training(train_step, eval_step, state, train, val, n_epochs=1,
                                    save_dir=str(tmp_path / "hand"),
                                    rng=torch.Generator().manual_seed(SEED))
    assert got["best"] == best
    np.testing.assert_equal(got["history"], history)  # nan where nothing is predicted changed
    _state_dicts_equal(got["state"].model.state_dict(), state.model.state_dict())
    assert sorted(os.listdir(tmp_path / "cli")) == sorted(os.listdir(tmp_path / "hand"))


def test_float_transfer_gives_the_uint8_weights(data, tmp_path):
    """uint8 on the wire scales by 1/255 on the device, float32 on the host:
    the same division, so the same inputs, losses and weights."""
    argv = [*TINY, "--root_path", data, *LEVIR, "--n_epochs", "1"]
    as_uint8 = train_pse_cd.main([*argv, "--save_name", str(tmp_path / "u8")])
    as_float = train_pse_cd.main([*argv, "--save_name", str(tmp_path / "f32"),
                                  "--float_transfer"])
    np.testing.assert_equal(as_uint8["history"], as_float["history"])
    _state_dicts_equal(as_float["state"].model.state_dict(),
                       as_uint8["state"].model.state_dict())


def test_train_ffctl_cli_trains_on_ff_labels(data, tmp_path):
    train_pse_cd.main([*TINY, "--root_path", data, *LEVIR, "--n_epochs", "1",
                       "--save_name", str(tmp_path / "psecd")])
    train_pse_cd.main([*TINY, "--root_path", data, *LEVIR, "--load_model", "--load_path",
                       str(tmp_path / "psecd"), "--generate_label"])
    ff = os.path.join(data, "LEVIR", "train", "ff_label")
    assert sorted(os.listdir(ff)) == sorted(os.listdir(os.path.join(data, "LEVIR", "train", "A")))
    for net in ("ffctlcd", "segcd"):
        out = train_ffctl.main([*TINY, "--root_path", data, *LEVIR, "--n_epochs", "1",
                                "--net", net, "--save_name", str(tmp_path / net)])
        assert out["state"].step == 2
        assert type(out["state"].model).__name__ == {"ffctlcd": "FFCTLCD", "segcd": "SegCD"}[net]
        assert any(f.endswith("_best_model") for f in os.listdir(tmp_path / net))


def test_snapshot_order_is_lexicographic(tmp_path):
    for name in ("2.00_model", "10.00_model", "1.00_model", "3.00_model", "5.00_best_model"):
        (tmp_path / name).write_bytes(b"")
    assert [os.path.basename(p) for p in common.snapshot_paths(str(tmp_path))] == [
        "1.00_model", "10.00_model", "2.00_model"]


def test_select_data_ranks_like_separately_built_states(data, tmp_path):
    """Three snapshots and a best model with different weights; --select_data
    writes the lists select_reliable writes over four states built apart. One
    state loaded in place four times would rank every pair at 1.0."""
    run = tmp_path / "run"

    def state_of(seed):
        return create_train_state(
            init_weights(SegCD("resnet18", classes=1, decoder_channels=DEC), seed=seed),
            adam_poly(), device="cpu")

    mgr = CheckpointManager(str(run))
    for seed, epoch in ((1, 1), (2, 2), (3, 10), (4, 3)):
        mgr.save_snapshot(state_of(seed), epoch)
    mgr.save_best(state_of(5), 0.5)

    got = train_pse_cd.main([*TINY, "--root_path", data, *LEVIR, "--load_model",
                             "--load_path", str(run), "--select_data"])["reliability"]
    list_dir = os.path.join(data, "LEVIR", "train", "list")
    lists = [read_list(os.path.join(list_dir, f"{k}_ids.txt")) for k in ("reliable", "unreliable")]

    set_uint8_transfer(True)
    states = []
    for name in ("1.00_model", "10.00_model", "2.00_model", "50.00_best_model"):
        st = state_of(0)
        mgr.load_weights(st, str(run / name))
        states.append(st)
    _, eval_step = make_cd_steps()
    loader = DataLoader(ds.CDDataset(data, "LEVIR", "train"), 1, device="cpu")
    want = select_reliable([eval_step] * 4, states, loader, str(tmp_path / "lists"))
    assert got == want
    assert lists == [read_list(str(tmp_path / "lists" / f"{k}_ids.txt"))
                     for k in ("reliable", "unreliable")]
    assert len({r for _, r in got}) > 1, got


def test_pipeline_demo_on_the_cpu(tmp_path, capsys):
    results = pipeline_demo.main([str(tmp_path), "--device", "cpu", "--n", "4", "--size",
                                  "32", "--n_epochs", "3", "--batch_size", "2",
                                  "--decoder_channels", ",".join(map(str, DEC))])
    assert capsys.readouterr().out.rstrip().endswith("PIPELINE DEMO COMPLETE")
    assert len(results) == 7 and all(r["seconds"] > 0 for r in results.values())
    runs, train = tmp_path / "runs", tmp_path / "data" / "LEVIR" / "train"
    for stage in ("seg", "psecd", "stcd"):
        files = os.listdir(runs / stage)
        assert {"last_ckpt", "1.00_model", "2.00_model", "3.00_model"} <= set(files), files
        assert sum(f.endswith("_best_model") for f in files) == 1
    reliable, unreliable = (read_list(str(train / "list" / f"{k}_ids.txt"))
                            for k in ("reliable", "unreliable"))
    assert len(reliable) == len(unreliable) == 2
    assert sorted(os.listdir(train / "ff_label")) == sorted(os.listdir(train / "A"))
    metrics = list(results.values())[-1]["result"]
    assert set(metrics) == {"OA", "precision", "recall", "F1", "IoU", "mIoU"}
    assert 0.0 <= metrics["OA"] <= 1.0


def test_every_cli_needs_the_card_unless_asked(data, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--root_path", data, *LEVIR, "--save_name", str(tmp_path / "x")]
    for cli_main in (train_sup.main, train_pse_cd.main, train_stcd.main, train_ffctl.main,
                     evaluate.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline_demo.main([str(tmp_path / "demo")])
    assert not (tmp_path / "demo").exists() and not (tmp_path / "x").exists()
    assert common.base_parser("a", "b").get_default("device") == "cuda"


@pytest.mark.parametrize("flags,match", [
    (["--data_axis", "2"], "Queue 1 #10"), (["--space_axis", "2"], "Queue 1 #11"),
    (["--model_axis", "4"], "Queue 1 #11")])
def test_mesh_flags_other_than_one_raise(data, flags, match):
    with pytest.raises(NotImplementedError, match=match):
        train_pse_cd.main([*TINY, "--root_path", data, *LEVIR, *flags])


def test_evaluate_matches_the_loop_and_refuses_int8(data, tmp_path):
    run = str(tmp_path / "run")
    trained = train_pse_cd.main([*TINY, "--root_path", data, *LEVIR, "--n_epochs", "1",
                                 "--save_name", run])
    got = evaluate.main([*TINY, "--root_path", data, "--dataset_name", "LEVIR",
                         "--load_path", run, "--batch_size", "4"])  # the val loader's batch
    np.testing.assert_equal(got, trained["history"][0]["val"])
    preds = str(tmp_path / "preds")
    evaluate.main([*TINY, "--root_path", data, "--dataset_name", "LEVIR", "--load_path", run,
                   "--save_preds", preds])
    assert sorted(os.listdir(preds)) == sorted(os.listdir(os.path.join(data, "LEVIR", "val",
                                                                       "A")))
    # --int8 was refused until the int8 path was ported; it now evaluates the int8
    # forward (tests/test_torch_export_int8_cli.py holds it)
    quantized = evaluate.main([*TINY, "--root_path", data, "--dataset_name", "LEVIR",
                               "--load_path", run, "--int8"])
    assert quantized.keys() == got.keys() and 0.0 <= quantized["OA"] <= 1.0
    with pytest.raises(SystemExit, match="no \\*_best_model"):
        evaluate.main([*TINY, "--root_path", data, "--load_path", str(tmp_path / "empty")])
    assert np.isfinite(got["OA"])
