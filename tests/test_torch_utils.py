"""The port's profiling and debug helpers: trace() writes a Chrome trace of
what ran inside it, StepTimer counts steps per second, and save_to_mat
writes the .mat file the JAX package's save_to_mat writes."""

import json
import time

import numpy as np
import torch
from scipy.io import loadmat

from stcd_tpu.utils.debug import save_to_mat as jax_save_to_mat
from stcd_tpu_torch.utils.debug import save_to_mat
from stcd_tpu_torch.utils.profiling import StepTimer, trace


def test_trace_writes_a_chrome_trace_of_the_block(tmp_path):
    with trace(str(tmp_path / "prof")) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert prof is not None
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_step_timer():
    timer = StepTimer()
    assert timer.steps_per_sec() == 0.0
    for _ in range(3):
        with timer:
            time.sleep(0.01)
    assert len(timer.times) == 3 and 0 < timer.steps_per_sec() < 100


def test_save_to_mat_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    x1, x2 = rng.normal(size=(1, 8, 8, 3)).astype(np.float32), rng.normal(size=(1, 8, 8, 3))
    fx1 = [rng.normal(size=(1, 4, 4, 2)).astype(np.float32) for _ in range(2)]
    fx2 = [rng.normal(size=(1, 4, 4, 2)).astype(np.float32) for _ in range(2)]
    cp = [rng.normal(size=(1, 8, 8, 1)).astype(np.float32)]
    want = loadmat(jax_save_to_mat(x1, x2, fx1, fx2, cp, "f", str(tmp_path / "jax")))
    got = loadmat(save_to_mat(torch.from_numpy(x1), x2, [torch.from_numpy(f) for f in fx1],
                              fx2, [torch.from_numpy(cp[0]).bfloat16().float()], "f",
                              str(tmp_path / "port")))
    keys = {k for k in want if not k.startswith("__")}
    assert keys == {k for k in got if not k.startswith("__")} == {
        "x1", "x2", "final_pred", "fx1_0", "fx1_1", "fx2_0", "fx2_1"}
    for k in keys - {"final_pred"}:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["final_pred"],
                                  torch.from_numpy(cp[0]).bfloat16().float().numpy())
    bf = save_to_mat(x1, x2, [], [], [torch.ones(2, dtype=torch.bfloat16)], "b",
                     str(tmp_path / "port"))
    assert loadmat(bf)["final_pred"].dtype == np.float32
