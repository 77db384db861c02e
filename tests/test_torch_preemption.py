"""Preemption and pretrained weights in the port: PreemptionGuard
(trigger, SIGTERM, the sync cadence) against the JAX guard's behaviour;
run_training saves last_ckpt when it fires and the stage CLI's --resume
continues from it, SIGTERM sent to a CLI in a subprocess; and each case of
resolve_encoder_weights' contract."""

import json
import os
import shutil
import signal
import subprocess
import sys

import pytest
import torch

from stcd_tpu.train.preemption import PreemptionGuard as JaxGuard
from stcd_tpu_torch.cli import make_demo_data, train_pse_cd
from stcd_tpu_torch.convert.pretrained import pretrained_dir, resolve_encoder_weights
from stcd_tpu_torch.data.datasets import SyntheticCDDataset
from stcd_tpu_torch.data.io import set_uint8_transfer
from stcd_tpu_torch.data.loader import DataLoader
from stcd_tpu_torch.models.segcd import SegCD, init_weights
from stcd_tpu_torch.train.checkpoint import CheckpointManager
from stcd_tpu_torch.train.loops import run_training
from stcd_tpu_torch.train.preemption import PreemptionGuard
from stcd_tpu_torch.train.state import adam_poly, create_train_state
from stcd_tpu_torch.train.steps import make_cd_steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEC = (16, 12, 8, 6, 4)
TINY = ["--encoder", "resnet18", "--decoder_channels", "16,12,8,6,4", "--batch_size", "2",
        "--device", "cpu", "--dataset_name", "LEVIR", "--CDdataset_name", "LEVIR"]


def test_sigterm_sets_the_flag_and_chains_the_previous_handler():
    chained = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: chained.append(s))
    try:
        guard = PreemptionGuard()
        assert not guard.should_stop() and not guard.fired
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.should_stop() and guard.fired
        assert chained == [signal.SIGTERM]
        guard.uninstall()
        assert signal.getsignal(signal.SIGTERM) is not guard._handler
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_trigger_and_sync_cadence_behave_as_in_jax():
    for cls in (JaxGuard, PreemptionGuard):
        guard = cls(install=False)
        assert not guard.should_stop()
        guard.trigger()
        assert guard.should_stop() and guard.fired and guard.should_stop()  # sticky

    def cadence(cls, **extra):
        calls = []

        def fake_or(flag):
            calls.append(flag)
            return flag

        guard = cls(install=False, sync_every=4, global_or=fake_or)
        for k, v in extra.items():
            setattr(guard, k, v)
        guard.trigger()
        seen = [guard.should_stop() for _ in range(6)]
        return seen, calls, guard.sync_every

    want = cadence(JaxGuard, _nprocs=2)  # the JAX guard's collective path
    assert cadence(PreemptionGuard) == want == ([False] * 3 + [True] * 3, [True], 4)


class _TriggerAfter:
    """Flags the guard while yielding the Nth batch, counted across epochs."""

    def __init__(self, loader, guard, after):
        self.loader, self.guard, self.after, self.count = loader, guard, after, 0

    def __iter__(self):
        for batch in self.loader:
            self.count += 1
            if self.count == self.after:
                self.guard.trigger()
            yield batch


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


def _tiny_state():
    model = init_weights(SegCD("resnet18", classes=1, decoder_channels=DEC), seed=0)
    return create_train_state(model, adam_poly(1e-3, 3, 2), device="cpu")


def test_preempted_run_saves_a_resume_point_and_resumes(tmp_path):
    state = _tiny_state()
    train_step, eval_step = make_cd_steps(augment=False)
    ds = SyntheticCDDataset(length=4, size=32)
    save_dir = str(tmp_path / "ckpt")
    guard = PreemptionGuard(install=False)
    loader = _TriggerAfter(DataLoader(ds, 2, device="cpu"), guard, after=3)
    eval_loader = DataLoader(ds, 2, device="cpu")
    state, best, history = run_training(train_step, eval_step, state, loader, eval_loader,
                                        n_epochs=3, save_dir=save_dir, rng=None,
                                        preemption=guard)
    assert guard.fired and len(history) == 1 and state.step == 2

    fresh = _tiny_state()
    rstate, epoch_id, rbest, rbest_epoch = CheckpointManager(save_dir).restore_last(fresh)
    assert epoch_id == 1 and rbest == best and rstate.step == 2
    for name, tensor in state.model.state_dict().items():
        assert torch.equal(rstate.model.state_dict()[name], tensor), name

    state2, _, history2 = run_training(train_step, eval_step, rstate,
                                       DataLoader(ds, 2, device="cpu"), eval_loader,
                                       n_epochs=3, save_dir=save_dir, rng=None,
                                       start_epoch=epoch_id + 1, best=rbest,
                                       best_epoch=rbest_epoch)
    assert [h["epoch"] for h in history2] == [2, 3] and state2.step == 6
    assert CheckpointManager(save_dir).restore_last(_tiny_state())[1] == 3


_KILL_AT_THIRD_TRAIN_BATCH = r"""
import json, os, signal, sys
sys.modules["torch.utils.tensorboard"] = None  # the scalar log as JSON lines only
from stcd_tpu_torch.data import loader

host_batches = loader.DataLoader._host_batches
seen = [0]

def killing(self, pin):
    for batch in host_batches(self, pin):
        if self.shuffle:  # the train loader
            seen[0] += 1
            if seen[0] == 3:
                os.kill(os.getpid(), signal.SIGTERM)
        yield batch

loader.DataLoader._host_batches = killing
from stcd_tpu_torch.cli import train_pse_cd
out = train_pse_cd.main(sys.argv[1:])
print(json.dumps({"step": out["state"].step,
                  "epochs": [h["epoch"] for h in out["history"]]}))
"""


def test_sigterm_to_a_stage_cli_saves_last_ckpt_and_resume_continues(tmp_path):
    data, run = str(tmp_path / "data"), str(tmp_path / "run")
    make_demo_data.make_tree(data, n=4, size=32)
    argv = [*TINY, "--root_path", data, "--n_epochs", "2", "--save_name", run]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", _KILL_AT_THIRD_TRAIN_BATCH, *argv],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "preemption: saved resume point at epoch 1" in proc.stdout
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"step": 2, "epochs": [1]}
    assert "2.00_model" not in os.listdir(run)

    try:
        out = train_pse_cd.main([*argv, "--resume", "--no_preempt"])
    finally:
        set_uint8_transfer(False)
    assert [h["epoch"] for h in out["history"]] == [2] and out["state"].step == 4
    files = os.listdir(run)
    assert {"1.00_model", "2.00_model", "last_ckpt"} <= set(files)


def test_resolve_encoder_weights_contract(tmp_path, monkeypatch):
    monkeypatch.setenv("STCD_PRETRAINED_DIR", str(tmp_path / "pre"))
    assert pretrained_dir() == str(tmp_path / "pre")
    assert resolve_encoder_weights(None, "resnet50") is None
    # a literal path is loaded, or raises if it is missing, never searched
    literal = tmp_path / "mine.pth"
    literal.write_bytes(b"x")
    assert resolve_encoder_weights(str(literal), "resnet50") == str(literal)
    (tmp_path / "pre").mkdir()
    (tmp_path / "pre" / "resnet50.pth").write_bytes(b"x")
    for missing in (str(tmp_path / "gone.pth"), "gone.pth", os.path.join("a", "b")):
        with pytest.raises(FileNotFoundError, match="Literal paths are not searched"):
            resolve_encoder_weights(missing, "resnet50")
    # a name resolves {encoder}.pth, then {encoder}_{name}.pth, under the directory
    assert resolve_encoder_weights("imagenet", "resnet50") == str(tmp_path / "pre" / "resnet50.pth")
    (tmp_path / "pre" / "resnet18_imagenet.pth").write_bytes(b"x")
    assert resolve_encoder_weights("imagenet", "resnet18") == str(
        tmp_path / "pre" / "resnet18_imagenet.pth")
    with pytest.raises(FileNotFoundError, match="Nothing is downloaded.*resnet34.pth"):
        resolve_encoder_weights("imagenet", "resnet34")
    with pytest.raises(FileNotFoundError, match="imagenet"):
        resolve_encoder_weights("imagenet")
    monkeypatch.delenv("STCD_PRETRAINED_DIR")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert pretrained_dir() == str(tmp_path / "home" / ".cache" / "stcd_tpu_torch" / "pretrained")
