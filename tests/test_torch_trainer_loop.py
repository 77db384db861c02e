"""The port's CDTrainer epoch loop, CDEvaluator and cli.train_cd on the CPU at
a tiny size, and the repair of the torchvision encoder load.

- ``train_models`` on BIT dd8 at 32x32 (batch 2, 2 steps an epoch, 2 epochs)
  against the port's own ``train_step`` / ``eval_step`` wired by hand over the
  same loaders, seed and weights: the same weights, bit for bit, and the same
  curves. Those steps are held to JAX by tests/test_torch_bit.py. Then the
  artifacts, the curves, the scalar log and a resume to a third epoch.
- An evaluator with the sgd default reads an adamw run's ``best_ckpt``
  (weights only) and writes the masks; ``scores`` and ``get_alpha_from_loader``
  equal JAX's on one confusion matrix and one loader.
- ``cli.train_cd`` with default flags on the demo tree (ChangeFormerV6), then
  ``--eval_only``, then ``cli.predict`` with default flags loading what it
  wrote (tests/test_scripts_cli.py::test_train_cd_cli_and_zoo_predict).
- F1: a torchvision-layout state_dict (the encoder's keys plus ``fc.*``, minus
  ``num_batches_tracked``) loads as ``--encoder_weights`` and gives the
  encoder's own weights; any other unexpected or missing key still raises.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from stcd_tpu_torch.data.datasets import SyntheticCDDataset
from stcd_tpu_torch.data.loader import DataLoader
from stcd_tpu_torch.metrics.confusion import SegmentationMetric
from stcd_tpu_torch.train import trainer as tt

HW, BATCH, LENGTH = 32, 2, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, and the scalar log as JSON lines only (importing
    TensorBoard imports TensorFlow), as tests/test_torch_cli.py does."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield
    torch.set_num_threads(threads)


def _loaders():
    train = DataLoader(SyntheticCDDataset(LENGTH, HW), BATCH, shuffle=True, num_workers=1,
                       drop_last=True, device="cpu")
    val = DataLoader(SyntheticCDDataset(2, HW, seed=1), BATCH, num_workers=1, device="cpu")
    return {"train": train, "val": val}


def _cfg(tmp_path, **kw):
    kw = {"max_epochs": 2, **kw}
    return tt.TrainerConfig(net_G="base_transformer_pos_s4_dd8", img_size=HW,
                            batch_size=BATCH, augment=True, device="cpu",
                            checkpoint_dir=str(tmp_path / "run"),
                            vis_dir=str(tmp_path / "vis"), **kw)


def _by_hand(cfg, epochs):
    """The loop wired by hand from the trainer's steps: (state, train mF1s,
    val mF1s)."""
    loaders = _loaders()
    trainer = tt.CDTrainer(cfg, loaders)
    state = trainer.init_state(cfg.device, init_seed=cfg.seed)
    curves = ([], [])
    for _ in range(epochs):
        for training, curve in ((True, curves[0]), (False, curves[1])):
            metric = SegmentationMetric(2)
            for batch in loaders["train" if training else "val"]:
                a, b, label = (torch.as_tensor(batch[k]) for k in ("A", "B", "label"))
                step = trainer.train_step if training else trainer.eval_step
                _, cm = step(state, a, b, label.float())
                metric.confusionMatrix += cm.numpy().astype(np.float64)
            curve.append(tt.CDTrainer.scores(metric)["mf1"])
    return state, curves


def test_train_models_equals_the_steps_wired_by_hand_and_resumes(tmp_path):
    cfg = _cfg(tmp_path)
    trainer = tt.CDTrainer(cfg, _loaders())
    state = trainer.train_models()
    want, curves = _by_hand(cfg, 2)
    got_sd, want_sd = state.model.state_dict(), want.model.state_dict()
    assert got_sd.keys() == want_sd.keys()
    for name in want_sd:
        assert torch.equal(got_sd[name], want_sd[name]), name
    assert state.step == want.step == 2 * LENGTH // BATCH

    run = tmp_path / "run"
    assert {"best_ckpt", "last_ckpt", "train_acc.npy", "val_acc.npy", "logs"} <= \
        set(os.listdir(run))
    np.testing.assert_array_equal(np.load(run / "train_acc.npy"),
                                  np.asarray(curves[0], np.float32))
    np.testing.assert_array_equal(np.load(run / "val_acc.npy"),
                                  np.asarray(curves[1], np.float32))
    with open(run / "logs" / "scalars.jsonl") as f:
        tags = [(r["tag"], r["step"]) for r in map(json.loads, f)]
    assert {("train/mf1", 0), ("train/loss", 1), ("val/mf1", 1), ("val/recall_1", 0)} <= \
        set(tags)
    last = torch.load(run / "last_ckpt", weights_only=True)
    assert last["epoch_id"] == 1 and last["step"] == state.step
    assert last["best_val_acc"] == pytest.approx(max(curves[1]))

    # a third epoch resumes at epoch 2 and extends the curves
    resumed = tt.CDTrainer(_cfg(tmp_path, max_epochs=3), _loaders())
    state3 = resumed.train_models()
    assert resumed.epoch_to_start == 2 and state3.step == 3 * LENGTH // BATCH
    train3 = np.load(run / "train_acc.npy")
    assert len(train3) == 3 and np.array_equal(train3[:2], np.asarray(curves[0], np.float32))
    assert torch.load(run / "last_ckpt", weights_only=True)["epoch_id"] == 2


def test_evaluator_reads_another_optimizers_checkpoint_and_writes_masks(tmp_path):
    state = tt.CDTrainer(_cfg(tmp_path, optimizer="adamw", max_epochs=1),
                         _loaders()).train_models()
    cfg = _cfg(tmp_path)  # the sgd default
    evaluator = tt.CDEvaluator(cfg, _loaders()["val"])
    with pytest.raises(FileNotFoundError, match="no checkpoint nothing"):
        evaluator.load("nothing")
    assert (tmp_path / "run" / "best_ckpt").exists()
    scores = evaluator.eval_models()  # best_ckpt
    loaded = evaluator.load("best_ckpt")
    for name, tensor in state.model.state_dict().items():
        assert torch.equal(loaded.model.state_dict()[name], tensor), name
    metric = SegmentationMetric(2)
    for batch in _loaders()["val"]:
        _, cm = evaluator.trainer.eval_step(state, batch["A"], batch["B"], batch["label"])
        metric.confusionMatrix += cm.numpy().astype(np.float64)
    np.testing.assert_equal(scores, tt.CDTrainer.scores(metric))  # NaN equals NaN
    assert sorted(os.listdir(tmp_path / "vis")) == ["syn_0.png", "syn_1.png"]
    from PIL import Image
    mask = np.asarray(Image.open(tmp_path / "vis" / "syn_0.png"))
    assert mask.shape == (HW, HW) and set(np.unique(mask)) <= {0, 255}


def test_scores_and_alpha_match_jax():
    from stcd_tpu.metrics.confusion import SegmentationMetric as JaxMetric
    from stcd_tpu.train import trainer as jt
    cm = np.array([[812.0, 31.0], [17.0, 164.0]])
    port, ref = SegmentationMetric(2), JaxMetric(2)
    port.confusionMatrix += cm
    ref.confusionMatrix += cm
    assert tt.CDTrainer.scores(port) == jt.CDTrainer.scores(ref)
    rng = np.random.default_rng(0)
    batches = [{"label": rng.choice([0, 1, 255], size=(2, 8, 8, 1)).astype(np.float32)}
               for _ in range(3)]
    np.testing.assert_array_equal(tt.get_alpha_from_loader(batches),
                                  jt.get_alpha_from_loader(batches))


def test_parallel_fields_raise(tmp_path):
    for kw in (dict(tp_axis=2), dict(pp_stages=2)):
        with pytest.raises(NotImplementedError, match="Queue 1 #11"):
            tt.CDTrainer(_cfg(tmp_path, **kw))
    from stcd_tpu_torch.cli import train_cd
    with pytest.raises(NotImplementedError, match="Queue 1 #11"):
        train_cd.main(["--tp_axis", "2", "--device", "cpu"])


def test_train_cd_cli_and_predict_with_default_flags(tmp_path, capsys):
    """ChangeFormerV6 through cli.train_cd with the default --embed_dim (64, as
    the JAX package), adamw; --eval_only with the sgd default; cli.predict
    with the default --embed_dim loads its checkpoint."""
    from stcd_tpu_torch.cli import make_demo_data, predict, train_cd
    from stcd_tpu_torch.data.io import set_uint8_transfer
    root = str(tmp_path / "data")
    make_demo_data.make_tree(root, n=4, size=HW)
    run = str(tmp_path / "v6")
    base = ["--root_path", root, "--dataset_name", "LEVIR", "--net_G", "ChangeFormerV6",
            "--img_size", str(HW), "--batch_size", "2", "--checkpoint_dir", run,
            "--device", "cpu", "--n_cpu", "1"]
    try:
        out = train_cd.main(base + ["--max_epochs", "1", "--optimizer", "adamw",
                                    "--lr", "1e-3", "--augment"])
        assert out["trainer"].model.TDec_x2.linear_c1.proj.out_features == 64
        assert {"last_ckpt", "val_acc.npy", "vis"} <= set(os.listdir(run))
        again = train_cd.main(base + ["--eval_only", "--eval_ckpt", "last_ckpt"])
        assert again["trainer"] is None and again["scores"].keys() == out["scores"].keys()
        capsys.readouterr()
        predict.main(["--net_G", "ChangeFormerV6", "--load_path", run, "--image_a",
                      os.path.join(root, "LEVIR", "train", "A", "0.png"), "--image_b",
                      os.path.join(root, "LEVIR", "train", "B", "0.png"), "--out",
                      str(tmp_path / "change.png"), "--tile", str(HW), "--stride", str(HW),
                      "--device", "cpu"])
        printed = capsys.readouterr().out
        assert "_ckpt" in printed and (tmp_path / "change.png").exists()
    finally:
        set_uint8_transfer(False)


def test_torchvision_encoder_checkpoint_loads(tmp_path):
    from stcd_tpu_torch.models.segcd import SegCD, init_weights
    from stcd_tpu_torch.train.state import SGDConfig, create_train_state
    enc = init_weights(SegCD("resnet18", decoder_channels=(16, 12, 8, 6, 4)), seed=3).encoder
    own = enc.state_dict()
    torchvision = {k: v for k, v in own.items() if not k.endswith("num_batches_tracked")}
    torchvision["fc.weight"] = torch.randn(1000, 512)
    torchvision["fc.bias"] = torch.randn(1000)
    tx = SGDConfig(lambda step: 0.0, 0.0, 0.0)
    for name, sd in (("own", own), ("torchvision", torchvision)):
        path = tmp_path / f"{name}.pth"
        torch.save(sd, path)
        state = create_train_state(SegCD("resnet18", decoder_channels=(16, 12, 8, 6, 4)), tx,
                                   device="cpu", encoder_weights=str(path))
        got = state.model.encoder.state_dict()
        for key, tensor in own.items():
            if not key.endswith("num_batches_tracked"):
                assert torch.equal(got[key], tensor), (name, key)
    for bad in ({**torchvision, "fc2.weight": torch.zeros(1)},
                {k: v for k, v in torchvision.items() if k != "conv1.weight"}):
        torch.save(bad, tmp_path / "bad.pth")
        with pytest.raises(RuntimeError, match="Unexpected key|Missing key"):
            create_train_state(SegCD("resnet18", decoder_channels=(16, 12, 8, 6, 4)), tx,
                               device="cpu", encoder_weights=str(tmp_path / "bad.pth"))
