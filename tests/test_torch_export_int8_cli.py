"""cli.export_model's three forms and the --int8 flags of cli.evaluate,
cli.predict and cli.serve, on the CPU at a tiny size (SegCD-r18 with decoder
16..4, BIT dd8, 32x32 tiles, batch 2).

Export: each program is written with torch.export.save, loaded back and run on
the same inputs as the eager forward it was traced from; the outputs agree to
1e-5 (the same ATen ops on the same weights). The --int8 program holds the
calibration scales of --calib_npz: it equals the eager quantized forward and
differs from the float one.
"""

import os
import sys

import numpy as np
import pytest
import torch

from stcd_tpu_torch.cli import evaluate, export_model, make_demo_data, predict, serve
from stcd_tpu_torch.data.io import set_uint8_transfer

HW = 32
SEGCD = ["--encoder", "resnet18", "--decoder_channels", "16,12,8,6,4"]
EXPORT = ["--img_height", str(HW), "--img_width", str(HW), "--batch_size", "2",
          "--device", "cpu", "--init_seed", "0"]
EXPORT_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("demo") / "data")
    make_demo_data.make_tree(root, n=4, size=HW)
    return root


def _pair(seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.uniform(size=(2, HW, HW, 3)).astype(np.float32))
                 for _ in range(2))


def _outs(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


@pytest.mark.parametrize("form", ["segcd", "segcd_raw_inputs", "bit", "segcd_int8"])
def test_export_round_trip(form, tmp_path, capsys):
    argv = {"segcd": SEGCD, "segcd_raw_inputs": SEGCD + ["--raw_inputs"],
            "bit": ["--net_G", "base_transformer_pos_s4_dd8"],
            "segcd_int8": SEGCD + ["--int8", "--calib_npz", str(tmp_path / "calib.npz")]}[form]
    a, b = _pair(1)
    np.savez(tmp_path / "calib.npz", A=a.numpy(), B=b.numpy())
    out = str(tmp_path / "model.pt2")
    res = export_model.main(argv + EXPORT + ["--out", out])
    printed = capsys.readouterr().out
    assert "roundtrip outputs:" in printed
    loaded = torch.export.load(out).module()
    a, b = _pair(2)
    with torch.no_grad():
        got, want = _outs(loaded(a, b)), _outs(res["fn"](a, b))
    assert len(got) == len(want) == (3 if form.startswith("segcd") and "int8" not in form
                                     else 1)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[:3] == (2, HW, HW)
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=EXPORT_ATOL, rtol=0)
    if form == "segcd_int8":
        assert "int8: " in printed and "conv sites quantized" in printed
        with torch.no_grad():
            flt = predict.make_base_fn(res["args"], res["model"])(a, b)
        assert (got[0] - flt).abs().max() > 0
    if form == "segcd_raw_inputs":  # the normalisation is not in the program
        with torch.no_grad():
            raw = export_model.segcd_forward(res["model"], normalize=True)(a, b)
        assert (got[0] - raw[0]).abs().max() > 0


def _segcd_run(path):
    """A run directory with a ``*_best_model`` of seeded SegCD-r18 weights."""
    from stcd_tpu_torch.models.segcd import SegCD, init_weights
    from stcd_tpu_torch.train.checkpoint import CheckpointManager
    from stcd_tpu_torch.train.state import SGDConfig, create_train_state
    model = init_weights(SegCD("resnet18", decoder_channels=(16, 12, 8, 6, 4)), seed=0)
    state = create_train_state(model, SGDConfig(lambda s: 0.0, 0.0, 0.0), device="cpu")
    CheckpointManager(path).save_best(state, 0.5)
    return path


def test_evaluate_and_predict_int8(data, tmp_path, capsys):
    run = _segcd_run(str(tmp_path / "run"))
    common = ["--root_path", data, "--dataset_name", "LEVIR", "--split", "val",
              "--load_path", run, "--batch_size", "2", "--img_height", str(HW),
              "--img_width", str(HW), "--device", "cpu", *SEGCD]
    try:
        flt = evaluate.main(common)
        q = evaluate.main(common + ["--int8"])
    finally:
        set_uint8_transfer(False)
    printed = capsys.readouterr().out
    line = [x for x in printed.splitlines() if x.startswith("int8: ")]
    assert len(line) == 1 and "conv sites quantized" in line[0]
    k, n = map(int, line[0].split()[1].split("/"))
    assert 0 < k < n
    assert q.keys() == flt.keys() and 0.0 <= q["OA"] <= 1.0

    scene = os.path.join(data, "LEVIR", "val")
    argv = ["--image_a", os.path.join(scene, "A", "0.png"), "--image_b",
            os.path.join(scene, "B", "0.png"), "--load_path", run, "--tile", str(HW),
            "--stride", str(HW), "--device", "cpu", *SEGCD]
    predict.main(argv + ["--out", str(tmp_path / "f.png"), "--prob_out",
                         str(tmp_path / "f.npy")])
    predict.main(argv + ["--out", str(tmp_path / "q.png"), "--prob_out",
                         str(tmp_path / "q.npy"), "--int8"])
    assert "int8: " in capsys.readouterr().out
    pf, pq = np.load(tmp_path / "f.npy"), np.load(tmp_path / "q.npy")
    assert pq.shape == pf.shape == (HW, HW, 1) and (tmp_path / "q.png").exists()
    assert 0 < np.abs(pq - pf).max() < 0.5


def test_serve_calibration_tiles(data, tmp_path):
    from PIL import Image
    val = os.path.join(data, "LEVIR", "val")
    a, b = serve.calibration_tiles(val, 16)
    assert a.shape == b.shape == (2, 16, 16, 3)  # the val split's two pairs, A/ and B/
    flat = tmp_path / "flat"
    flat.mkdir()
    rng = np.random.default_rng(0)
    for i, size in enumerate((32, 32, 8, 8, 32, 32)):  # the second pair is too small
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
            flat / f"{i // 2}_{'AB'[i % 2]}.png")
    a, b = serve.calibration_tiles(str(flat), 16)
    assert a.shape == (2, 16, 16, 3)
    with pytest.raises(SystemExit, match="usable pair"):
        serve.calibration_tiles(str(flat), 64)
    with pytest.raises(SystemExit, match="--int8 needs --calib_dir"):
        serve.main(["--int8", "--init_seed", "0", "--device", "cpu"])
