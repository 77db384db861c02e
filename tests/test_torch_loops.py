"""stcd_tpu_torch/train/loops.py, train/checkpoint.py, utils/logging.py and
data/io.py. The loop utilities are held against the JAX functions of the
same names on the same probabilities: both sides get an eval step that hands
back probabilities stored in the batch, so the metrics are equal to float64
rounding, the PNG files byte for byte and the id lists exactly. run_training
runs on the port alone: SegCD resnet18, decoder (32, 24, 16, 12, 8), 32x32."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stcd_tpu.data import io as jio
from stcd_tpu.metrics.confusion import confusion_matrix as jax_confusion_matrix
from stcd_tpu.train import loops as jloops
from stcd_tpu_torch.data import io as tio
from stcd_tpu_torch.metrics.confusion import confusion_matrix
from stcd_tpu_torch.models.segcd import SegCD, init_weights
from stcd_tpu_torch.train import loops
from stcd_tpu_torch.train.checkpoint import CheckpointManager
from stcd_tpu_torch.train.state import adam_poly, create_train_state
from stcd_tpu_torch.train.steps import make_cd_steps, make_semi_cd_steps
from stcd_tpu_torch.utils.logging import ScalarLogger, Throughput


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread for this file's tests, as tests/test_torch_cli.py
    has: the suite runs several files at once, and at these sizes more threads
    cost CPU time and buy little."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DEC = (32, 24, 16, 12, 8)
HW = 32


def _prob_loader(seed, batches=3, n=2, keys=("probs",)):
    """Batches that carry their own probabilities (one map per key), a label and names."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(batches):
        batch = {k: rng.uniform(0, 1, (n, 16, 16, 1)).astype(np.float32) for k in keys}
        batch["label"] = (rng.uniform(size=(n, 16, 16, 1)) > 0.6).astype(np.float32)
        batch["name"] = [f"s{i}_{j}.png" for j in range(n)]
        out.append(batch)
    return out


def _copy(loader):
    return [dict(b) for b in loader]


def _jax_eval(key="probs", threshold=0.5):
    def step(state, batch):
        probs = jnp.asarray(batch[key])
        cm = jax_confusion_matrix((probs > threshold).astype(jnp.int32),
                                  jnp.asarray(batch["label"]).astype(jnp.int32), 2)
        return {"cm": cm, "probs": probs}
    return step


def _port_eval(key="probs", threshold=0.5):
    def step(state, batch):
        return {"cm": confusion_matrix(batch[key] > threshold, batch["label"]),
                "probs": batch[key]}
    return step


CPU = SimpleNamespace(device=torch.device("cpu"))


def _hold_metrics(got, want):
    assert set(got) == set(want) == {"OA", "precision", "recall", "F1", "IoU", "mIoU"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=k)


def test_evaluate_matches_jax():
    loader = _prob_loader(0)
    want = jloops.evaluate(_jax_eval(), None, _copy(loader))
    _hold_metrics(loops.evaluate(_port_eval(), CPU, _copy(loader)), want)
    assert "name" in loader[0]  # the port's loop leaves the caller's batches whole


def test_generate_pseudo_labels_matches_jax(tmp_path):
    loader = _prob_loader(1)
    want = jloops.generate_pseudo_labels(_jax_eval(), None, _copy(loader), str(tmp_path / "j"),
                                         threshold=0.7, vis_dir=str(tmp_path / "jv"))
    got = loops.generate_pseudo_labels(_port_eval(), CPU, _copy(loader), str(tmp_path / "p"),
                                       threshold=0.7, vis_dir=str(tmp_path / "pv"))
    _hold_metrics(got, want)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "p")) == sorted(
        n for b in loader for n in b["name"])
    for sub_j, sub_p in (("j", "p"), ("jv", "pv")):  # masks, then the jet-coloured maps
        for name in names:
            assert (tmp_path / sub_j / name).read_bytes() == (tmp_path / sub_p / name).read_bytes()
    # the saved mask is the thresholded map x 255, read back as a binary label
    mask = tio.read_label(str(tmp_path / "p" / names[0]))
    np.testing.assert_array_equal(mask, (loader[0]["probs"][0] > 0.7).astype(np.float32))
    np.testing.assert_array_equal(mask, jio.read_label(str(tmp_path / "j" / names[0])))


def test_select_reliable_matches_jax(tmp_path):
    keys = ("p0", "p1", "p2")
    loader = _prob_loader(2, batches=3, n=3, keys=keys)
    for batch in loader:  # the earlier models are noisy copies of the last one
        batch["p0"] = np.clip(batch["p2"] + 0.3 * (batch["p0"] - 0.5), 0, 1)
        batch["p1"] = np.clip(batch["p2"] + 0.1 * (batch["p1"] - 0.5), 0, 1)
    want = jloops.select_reliable([_jax_eval(k) for k in keys], [None] * 3, _copy(loader),
                                  str(tmp_path / "j"))
    got = loops.select_reliable([_port_eval(k) for k in keys], [CPU] * 3, _copy(loader),
                                str(tmp_path / "p"))
    assert [n for n, _ in got] == [n for n, _ in want] and len(got) == 9
    np.testing.assert_allclose([r for _, r in got], [r for _, r in want], rtol=1e-12)
    for name in ("reliable_ids.txt", "unreliable_ids.txt"):
        assert tio.read_list(str(tmp_path / "p" / name)) == jio.read_list(
            str(tmp_path / "j" / name))
    assert len(tio.read_list(str(tmp_path / "p" / "reliable_ids.txt"))) == 4
    with pytest.raises(ValueError, match=">= 2 model states"):
        loops.select_reliable([_port_eval()], [CPU], _copy(loader), str(tmp_path / "x"))


def test_io_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    values = rng.normal(size=(9, 7, 1)).astype(np.float32)
    tio.save_jet_png(values, str(tmp_path / "p" / "v.png"))
    jio.save_jet_png(values, str(tmp_path / "j" / "v.png"))
    assert (tmp_path / "p" / "v.png").read_bytes() == (tmp_path / "j" / "v.png").read_bytes()
    tio.save_jet_png(np.zeros((4, 4)), str(tmp_path / "flat.png"))  # hi == lo: no division
    tio.write_list(["a", 3, "c d"], str(tmp_path / "lists" / "ids.txt"))
    assert tio.read_list(str(tmp_path / "lists" / "ids.txt")) == ["a", "3", "c d"]
    assert jio.read_list(str(tmp_path / "lists" / "ids.txt")) == ["a", "3", "c d"]


def test_scalar_logger_and_throughput(tmp_path):
    logger = ScalarLogger(str(tmp_path / "logs"), use_tensorboard=False)
    logger.add_scalar("train/loss", torch.tensor(1.5), 0)
    logger.add_scalar("val/IoU", 0.25, 1)
    logger.close()
    again = ScalarLogger(str(tmp_path / "logs"), use_tensorboard=False)  # appends
    again.add_scalar("val/IoU", 0.5, 2)
    again.close()
    lines = [json.loads(ln) for ln in open(tmp_path / "logs" / "scalars.jsonl")]
    assert [(ln["tag"], ln["value"], ln["step"]) for ln in lines] == [
        ("train/loss", 1.5, 0), ("val/IoU", 0.25, 1), ("val/IoU", 0.5, 2)]
    assert all(set(ln) == {"tag", "value", "step", "time"} for ln in lines)
    meter = Throughput()
    assert meter.rate() == 0.0
    meter.update(4)
    meter.update(4)
    assert meter.rate() > 0
    meter.reset()
    assert meter.rate() == 0.0


def _state(seed=0):
    model = init_weights(SegCD("resnet18", decoder_channels=DEC), seed)
    return create_train_state(model, adam_poly(1e-3, 2, 3), device="cpu")


def _cd_loader(seed, batches=3, n=2):
    gen = torch.Generator().manual_seed(seed)
    return [{"A": torch.randint(0, 256, (n, HW, HW, 3), dtype=torch.uint8, generator=gen),
             "B": torch.randint(0, 256, (n, HW, HW, 3), dtype=torch.uint8, generator=gen),
             # numpy labels: a loader may hand over arrays or tensors
             "label": (torch.rand(n, HW, HW, 1, generator=gen) > 0.8).float().numpy(),
             "name": [f"b{i}_{j}.png" for j in range(n)]} for i in range(batches)]


def test_run_training_two_epochs_files_history_and_resume(tmp_path):
    train_step, eval_step = make_cd_steps(augment=True)
    state = _state()
    logger = ScalarLogger(str(tmp_path / "run" / "logs"), use_tensorboard=False)
    out, best, history = loops.run_training(
        train_step, eval_step, state, _cd_loader(1), _cd_loader(2, batches=2), n_epochs=2,
        save_dir=str(tmp_path / "run"), rng=torch.Generator().manual_seed(3), log_every=2,
        logger=logger)
    assert out is state and state.step == 6
    assert [h["epoch"] for h in history] == [1, 2]
    for h in history:
        assert set(h["train"]) == set(h["val"]) == {"OA", "precision", "recall", "F1", "IoU",
                                                     "mIoU"}
        assert 0 <= h["val"]["OA"] <= 1 and 0 <= h["train"]["OA"] <= 1
    score = [0.0 if np.isnan(h["val"]["IoU"]) else h["val"]["IoU"] for h in history]
    assert best == max(score) and best >= 0.0  # best starts at -1: epoch 1 always saves

    files = sorted(os.listdir(tmp_path / "run"))
    assert files == sorted(["%.2f_best_model" % (best * 100), "1.00_model", "2.00_model",
                            "last_ckpt", "logs"])
    lines = [json.loads(ln) for ln in open(tmp_path / "run" / "logs" / "scalars.jsonl")]
    assert [ln["step"] for ln in lines if ln["tag"] == "train/loss"] == [0, 2, 4]
    assert {ln["tag"] for ln in lines} == {
        "train/loss", "train/F1", "train/IoU", "train/imgs_per_sec", "val/OA",
        "val/precision", "val/recall", "val/F1", "val/IoU", "val/mIoU"}

    # restore_last into a fresh state: step, weights, Adam moments, epoch and best
    ckpt = CheckpointManager(str(tmp_path / "run"))
    fresh = _state(seed=9)
    restored, epoch_id, best_val, best_epoch = ckpt.restore_last(fresh)
    assert restored is fresh and fresh.step == 6 and epoch_id == 2
    assert best_val == pytest.approx(best) and best_epoch in (1, 2)
    for (k, want), got in zip(state.model.state_dict().items(),
                              fresh.model.state_dict().values()):
        assert torch.equal(want, got), k
    want_opt, got_opt = (s.optimizer.state_dict()["state"] for s in (state, fresh))
    assert all(torch.equal(want_opt[i]["exp_avg_sq"], got_opt[i]["exp_avg_sq"])
               for i in want_opt) and len(want_opt) > 60

    # resuming: one more epoch goes on from the restored step and keeps the best
    loops.run_training(train_step, eval_step, fresh, _cd_loader(1), _cd_loader(2, batches=2),
                       n_epochs=3, save_dir=str(tmp_path / "run"),
                       rng=torch.Generator().manual_seed(4), log_every=2, start_epoch=3,
                       best=best_val, best_epoch=best_epoch,
                       logger=ScalarLogger(str(tmp_path / "run" / "logs"),
                                           use_tensorboard=False))
    assert fresh.step == 9 and "3.00_model" in os.listdir(tmp_path / "run")
    lines = [json.loads(ln) for ln in open(tmp_path / "run" / "logs" / "scalars.jsonl")]
    assert [ln["step"] for ln in lines if ln["tag"] == "train/loss"] == [0, 2, 4, 6, 8]
    assert len(list((tmp_path / "run").glob("*_best_model"))) == 1

    # weights-only artifacts
    other = ckpt.load_weights(_state(seed=5), ckpt.best_path())
    assert other.step == 0
    assert ckpt.restore_last(_state(), name="no_such_ckpt") is None
    assert not list((tmp_path / "run").glob("*.tmp.*"))  # every file was renamed into place


def test_run_training_stops_at_preemption_and_logs_the_stage_3_terms(tmp_path):
    train_step, eval_step = make_semi_cd_steps(augment=False)
    gen = torch.Generator().manual_seed(6)

    def image():
        return torch.rand(2, HW, HW, 3, generator=gen)

    def label():
        return (torch.rand(2, HW, HW, 1, generator=gen) > 0.8).float()

    train = [{"A": image(), "B": image(), "CA": image(), "CB": image(), "s_label_A": label(),
              "c_label": label(), "CL": label()} for _ in range(3)]

    class StopAfter:
        def __init__(self, n):
            self.calls, self.n = 0, n

        def should_stop(self):
            self.calls += 1
            return self.calls > self.n

    state = _state()
    _, best, history = loops.run_training(
        train_step, eval_step, state, train, _cd_loader(7, batches=1), n_epochs=2,
        save_dir=str(tmp_path / "run"), rng=None, log_every=1, preemption=StopAfter(4),
        logger=ScalarLogger(str(tmp_path / "run" / "logs"), use_tensorboard=False))
    # epoch 1 ran whole, epoch 2 stopped before its second batch and is not counted
    assert len(history) == 1 and state.step == 4
    restored = CheckpointManager(str(tmp_path / "run")).restore_last(_state(seed=1))
    assert restored[1] == 1 and restored[0].step == 4 and restored[2] == pytest.approx(best)
    tags = {json.loads(ln)["tag"] for ln in open(tmp_path / "run" / "logs" / "scalars.jsonl")}
    assert {"train/seg_loss", "train/cd_loss", "train/ct_loss"} <= tags


def test_best_artifact_keeps_only_the_current_best(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    state = _state()
    first = ckpt.save_best(state, 0.1234)
    assert os.path.basename(first) == "12.34_best_model"
    second = ckpt.save_best(state, 0.5)
    assert os.path.basename(second) == "50.00_best_model" and ckpt.best_path() == second
    assert not os.path.exists(first)
    assert os.path.basename(ckpt.save_snapshot(state, 7)) == "7.00_model"
    payload = torch.load(second, weights_only=True)
    assert set(payload) == {"model"} and "encoder.conv1.weight" in payload["model"]
    last = torch.load(ckpt.save_last(state, 3, 0.5, 2), weights_only=True)
    assert set(last) == {"epoch_id", "best_val_acc", "best_epoch_id", "model", "optimizer",
                         "step"}


def test_predict_cli_loads_what_run_training_wrote(tmp_path):
    """Two epochs of run_training write a run directory; cli.predict and
    cli.serve's model flags take it with --load_path as scripts/predict.py
    resolves one (*_best_model, then best_ckpt, then last_ckpt, or a file)
    and unwrap the checkpoint's "model" entry. The loaded model is the
    trained one, tensor for tensor, and predicts a scene."""
    import argparse

    from PIL import Image

    from stcd_tpu_torch.cli import predict as cli_predict

    train_step, eval_step = make_cd_steps(augment=True)
    state = _state()
    run = tmp_path / "run"
    loops.run_training(train_step, eval_step, state, _cd_loader(1), _cd_loader(2, batches=2),
                       n_epochs=2, save_dir=str(run), rng=torch.Generator().manual_seed(3),
                       logger=ScalarLogger(str(run / "logs"), use_tensorboard=False))
    best = CheckpointManager(str(run)).best_path()
    assert best is not None and cli_predict.resolve_checkpoint(str(run)) == best
    parser = argparse.ArgumentParser()
    cli_predict.add_model_args(parser)
    flags = ["--device", "cpu", "--encoder", "resnet18", "--decoder_channels", "32,24,16,12,8",
             "--tile", str(HW)]
    for load_path, want in ((run, torch.load(best, weights_only=True)["model"]),
                            (run / "last_ckpt", state.model.state_dict())):
        model = cli_predict.build_model(parser.parse_args(flags + ["--load_path",
                                                                   str(load_path)]))
        got = model.state_dict()
        assert set(got) == set(want) and not model.training
        for name, tensor in want.items():
            assert torch.equal(got[name], tensor), name
    os.remove(best)  # a run directory without its best model falls back to last_ckpt
    assert cli_predict.resolve_checkpoint(str(run)) == str(run / "last_ckpt")
    os.makedirs(tmp_path / "empty_run")
    with pytest.raises(SystemExit, match="no \\*_best_model"):
        cli_predict.resolve_checkpoint(str(tmp_path / "empty_run"))
    torch.save(state.model.state_dict(), tmp_path / "bare.pt")
    with pytest.raises(SystemExit, match="--weights"):
        cli_predict.build_model(parser.parse_args(flags + ["--load_path",
                                                           str(tmp_path / "bare.pt")]))

    rng = np.random.default_rng(4)
    for name in ("a.png", "b.png"):
        Image.fromarray(rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)).save(tmp_path / name)
    cli_predict.main(flags + ["--image_a", str(tmp_path / "a.png"), "--image_b",
                              str(tmp_path / "b.png"), "--batch", "2", "--stride", "16",
                              "--load_path", str(run), "--out", str(tmp_path / "mask.png"),
                              "--prob_out", str(tmp_path / "p.npy")])
    probs = np.load(tmp_path / "p.npy")
    assert probs.shape == (48, 40, 1) and np.isfinite(probs).all()
    assert probs.min() >= 0 and probs.max() <= 1
