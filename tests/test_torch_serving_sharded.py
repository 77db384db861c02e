"""Serving split over several devices (stcd_tpu_torch/serving/replicas.py,
BatchingEngine(devices=...), predict_scene(devices=...),
parallel/mesh.py::serving_devices, cli.predict.make_replicas) against the
one-device port engine and the JAX engine mesh-sharded over the 8 virtual CPU
devices (tests/test_serving_server.py's sharded tests, with the model's
preprocessing as cli.predict runs it).

Two replicas on the CPU, issued in turn by the engine's batcher thread, split
each batch of 8 tiles into two slices of 4. The CPU convs give the slices of a batch of 8
the same values as the whole batch (measured: 0 for the float and the int8
engine), so the split is held to 1e-6; against JAX 1e-4, as
tests/test_torch_serving.py holds the one-device engine, and int8 within
tests/test_torch_quant.py's bounds for int8 against JAX's int8.
"""

import argparse
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stcd_tpu.data.augment import eval_preprocess as jax_eval_preprocess
from stcd_tpu.models import SegCD as JaxSegCD
from stcd_tpu.parallel.mesh import batch_sharding, create_mesh
from stcd_tpu.serving import calibrate_conv_scales as jax_calibrate
from stcd_tpu.serving import quantize_fn as jax_quantize_fn
from stcd_tpu.serving.server import BatchingEngine as JaxBatchingEngine
from stcd_tpu_torch.cli import predict as cli_predict
from stcd_tpu_torch.convert.from_flax import unetseg_from_flax
from stcd_tpu_torch.data.tiled_inference import predict_scene
from stcd_tpu_torch.models.segcd import SegCD
from stcd_tpu_torch.parallel.mesh import serving_devices
from stcd_tpu_torch.serving.server import BatchingEngine

TILE, BATCH = 32, 8
DEC = (16, 12, 8, 6, 4)
SPLIT_ATOL = 1e-6  # two replicas against one device, the same CPU convs
JAX_ATOL = 1e-4  # the port against JAX (tests/test_torch_serving.py's bound)
CPU2 = ["cpu", "cpu"]
INT8_REL, DECISIONS = 0.02, 0.99  # int8 against JAX's int8: tests/test_torch_quant.py's


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread, as tests/test_torch_serving.py has."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scene(seed, hw=64, w=None):
    rng = np.random.default_rng(seed)
    shape = (hw, w or hw, 3)
    return (rng.uniform(0, 1, shape).astype(np.float32),
            rng.uniform(0, 1, shape).astype(np.float32))


@pytest.fixture(scope="module")
def segcd():
    """JAX's SegCD-r18 of the sharded serving tests and the port's copy."""
    model = JaxSegCD(encoder_name="resnet18", classes=1, decoder_channels=DEC)
    z = jnp.zeros((1, TILE, TILE, 3))
    variables = model.init(jax.random.PRNGKey(0), z, z)
    port = SegCD("resnet18", decoder_channels=DEC, classes=1)
    port.load_state_dict(unetseg_from_flax(variables["params"], variables["batch_stats"]))

    def fwd(a, b):
        _, _, diff = model.apply(variables, jax_eval_preprocess(a), jax_eval_preprocess(b))
        return jax.nn.sigmoid(diff.astype(jnp.float32))

    return fwd, port.eval()


def _serve(engine, scenes):
    try:
        return [engine.predict_pair(*s) for s in scenes], engine.stats_snapshot()
    finally:
        engine.close()


def _args(int8=False):
    return argparse.Namespace(bf16=False, int8=int8)


def _calib():
    rng = np.random.default_rng(0)
    return [rng.uniform(0, 1, (8, TILE, TILE, 3)).astype(np.float32) for _ in range(2)]


def test_two_replicas_equal_one_device_and_jax_sharded(segcd):
    fwd, port = segcd
    scenes = [_scene(i) for i in range(2)]
    want, jstats = _serve(JaxBatchingEngine(
        jax.jit(fwd), tile=TILE, batch=BATCH, max_wait_ms=20.0,
        sharding=batch_sharding(create_mesh(model=1))), scenes)
    one, _ = _serve(BatchingEngine(cli_predict.make_replicas(_args(), port, ["cpu"]),
                                   tile=TILE, batch=BATCH, max_wait_ms=20.0,
                                   devices=["cpu"]), scenes)
    fns = cli_predict.make_replicas(_args(), port, CPU2)
    got, stats = _serve(BatchingEngine(fns, tile=TILE, batch=BATCH, max_wait_ms=20.0,
                                       devices=CPU2), scenes)
    assert jstats["mesh_sharded"] is True and jstats["devices"] == len(jax.devices())
    assert stats["mesh_sharded"] is True and stats["devices"] == 2
    assert stats["quantized"] is jstats["quantized"] is False
    assert stats["errors"] == 0 and stats["tiles"] == 8
    for g, o, w in zip(got, one, want):
        assert g.shape == (64, 64, 1)
        np.testing.assert_allclose(g, o, atol=SPLIT_ATOL)
        np.testing.assert_allclose(g, w, atol=JAX_ATOL)


def test_two_int8_replicas_equal_one_device_and_jax_sharded(segcd):
    """JAX's test_batching_engine_sharded_and_quantized setup: one scale
    table from the same calibration tiles, applied to every replica."""
    fwd, port = segcd
    ca, cb = _calib()
    scales = jax_calibrate(fwd, [(jnp.asarray(ca), jnp.asarray(cb))])
    qfn = jax.jit(jax_quantize_fn(fwd, scales))
    scenes = [_scene(i) for i in range(2)]
    want, jstats = _serve(JaxBatchingEngine(
        qfn, tile=TILE, batch=BATCH, max_wait_ms=20.0,
        sharding=batch_sharding(create_mesh(model=1)), quantized=True), scenes)
    calib = [torch.from_numpy(t) for t in (ca, cb)]
    one, one_stats = _serve(BatchingEngine(
        cli_predict.make_replicas(_args(True), port, ["cpu"], calib), tile=TILE,
        batch=BATCH, max_wait_ms=20.0, devices=["cpu"], quantized=True), scenes)
    got, stats = _serve(BatchingEngine(
        cli_predict.make_replicas(_args(True), port, CPU2, calib), tile=TILE, batch=BATCH,
        max_wait_ms=20.0, devices=CPU2, quantized=True), scenes)
    for key in ("mesh_sharded", "quantized"):
        assert stats[key] is jstats[key] is True
    assert stats["devices"] == 2 and one_stats["devices"] == 1
    assert one_stats["mesh_sharded"] is False and one_stats["quantized"] is True
    for g, o, w in zip(got, one, want):
        np.testing.assert_allclose(g, o, atol=SPLIT_ATOL)
        # tests/test_torch_quant.py's int8 bounds: an activation within 1e-6 of a
        # half step rounds either way (measured: 8 of 4096 pixels off by 1.4e-4)
        assert np.linalg.norm(g - w) / np.linalg.norm(w) <= INT8_REL
        assert np.mean((g > 0.5) == (w > 0.5)) >= DECISIONS
    # it did run in int8: the float replicas give other values
    flt = predict_scene(cli_predict.make_replicas(_args(), port, CPU2), *scenes[0],
                        tile=TILE, stride=TILE, devices=CPU2)
    assert np.abs(flt - got[0]).max() > 0


def _recording(log, i):
    """A per-pixel predict function (a tile's output reads that tile alone)
    that logs which rows replica ``i`` saw, by their first pixel."""
    def fn(a, b):
        log.append((i, a[:, 0, 0, 0].tolist()))
        return (a - b).abs().mean(-1, keepdim=True)
    return fn


def _want(a, b):
    return np.abs(a - b).mean(-1, keepdims=True)


def test_each_tile_reaches_its_own_future():
    """Scenes that differ, sent at once, with partial zero-padded batches:
    each request gets its own tiles back, and replica i gets rows i B/D ..
    (i + 1) B/D - 1 of every batch."""
    log = []
    engine = BatchingEngine([_recording(log, 0), _recording(log, 1)], tile=16, batch=4,
                            max_wait_ms=30.0, devices=CPU2)
    scenes = [_scene(10 + i, 48, 16 * (i + 1)) for i in range(3)]  # 3, 6 and 9 tiles
    results = [None] * 3
    try:
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, engine.predict_pair(*scenes[i]))) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stats = engine.stats_snapshot()
    finally:
        engine.close()
    for (a, b), got in zip(scenes, results):
        np.testing.assert_array_equal(got, _want(a, b))
    assert stats["tiles"] == 18 and stats["errors"] == 0
    assert stats["batch_tiles"] < 4 * stats["batches"]  # a batch was padded
    assert sum(i == 0 for i, _ in log) == sum(i == 1 for i, _ in log) == stats["batches"]
    assert {len(rows) for _, rows in log} == {2}

    # one scene of 6 tiles: a full batch, then 2 tiles and 2 rows of padding
    log.clear()
    engine = BatchingEngine([_recording(log, 0), _recording(log, 1)], tile=16, batch=4,
                            max_wait_ms=30.0, devices=CPU2)
    a, b = _scene(13, 32, 48)
    try:
        np.testing.assert_array_equal(engine.predict_pair(a, b), _want(a, b))
    finally:
        engine.close()
    firsts = [float(a[y, x, 0]) for y in (0, 16) for x in (0, 16, 32)]
    assert [rows for i, rows in log if i == 0] == [firsts[0:2], firsts[4:6]]
    assert [rows for i, rows in log if i == 1] == [firsts[2:4], [0.0, 0.0]]


def test_a_batch_that_does_not_divide_raises():
    fn = _recording([], 0)
    with pytest.raises(ValueError, match=r"batch=6 does not divide across the 4 devices"):
        BatchingEngine([fn] * 4, tile=32, batch=6, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="one predict function per device"):
        BatchingEngine([fn], tile=32, batch=4, devices=CPU2)
    a, b = _scene(3)
    with pytest.raises(ValueError, match=r"batch=3 does not divide across the 2 devices"):
        predict_scene([fn, fn], a, b, tile=32, stride=32, batch=3, devices=CPU2)


def test_a_failing_replica_fails_its_batch_and_the_engine_serves_on():
    calls = {"n": 0}

    def flaky(a, b):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("replica 1 lost its card")
        return (a - b).abs().mean(-1, keepdim=True)

    log = []
    engine = BatchingEngine([_recording(log, 0), flaky], tile=32, batch=4,
                            max_wait_ms=5.0, devices=CPU2)
    try:
        a, b = _scene(4)
        with pytest.raises(RuntimeError, match="replica 1 lost its card"):
            engine.predict_pair(a, b)
        assert log, "replica 0 ran its slice of the failed batch"
        stats = engine.stats_snapshot()
        assert stats["errors"] == 1 and stats["batches"] == 0
        np.testing.assert_array_equal(engine.predict_pair(a, b), _want(a, b))
        assert engine.stats_snapshot()["batches"] == 1
    finally:
        engine.close()


def test_serving_devices_picks_the_cards(monkeypatch, capsys):
    """scripts/serve.py's rule: every visible card, cuda:N alone, --no_shard
    one card, and a --batch the card count does not divide the warning and one
    card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert serving_devices("cuda", 16) == cards
    assert serving_devices("cuda") == cards  # cli.predict's default batch: 4 x cards
    assert serving_devices("cuda:2", 16) == [torch.device("cuda", 2)]
    assert serving_devices("cuda", 16, no_shard=True) == [torch.device("cuda")]
    assert serving_devices("cpu", 16) == [torch.device("cpu")]
    assert capsys.readouterr().out == ""
    assert serving_devices("cuda", 6) == [torch.device("cuda", 0)]
    assert capsys.readouterr().out == (
        "warning: --batch 6 does not divide across 4 devices; serving single-device "
        "(pass a multiple of 4, or --no_shard to silence)\n")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert serving_devices("cuda", 6) == [torch.device("cuda")]
    assert capsys.readouterr().out == ""


def test_predict_scene_over_two_devices_equals_one():
    """predict_scene(devices=[cpu, cpu]) with its default batch, 4 x D: each
    replica sees 4 rows a step, and the stitched map is the one device's."""
    a, b = _scene(5, 80, 72)
    log = []
    got = predict_scene([_recording(log, 0), _recording(log, 1)], a, b, tile=32,
                        stride=24, devices=CPU2)
    one = predict_scene(_recording([], 0), a, b, tile=32, stride=24, device="cpu")
    np.testing.assert_array_equal(got, one)
    assert {len(rows) for _, rows in log} == {4}
    assert [i for i, _ in log[:2]] in ([0, 1], [1, 0])


def test_make_replicas_copies_the_model_to_each_device(segcd):
    _, port = segcd
    fns = cli_predict.make_replicas(_args(), port, CPU2)
    assert len(fns) == 2
    a, b = (torch.from_numpy(x[None, :TILE, :TILE]) for x in _scene(6))
    with torch.inference_mode():
        np.testing.assert_array_equal(fns[0](a, b).numpy(), fns[1](a, b).numpy())
    # the first replica is the model itself, the second a copy of it
    p = next(port.parameters())
    saved = p.detach().clone()
    try:
        with torch.no_grad():
            p.mul_(2.0)
        with torch.inference_mode():
            assert np.abs(fns[0](a, b).numpy() - fns[1](a, b).numpy()).max() > 0
    finally:
        with torch.no_grad():
            p.copy_(saved)


def test_serve_cli_reports_int8_and_its_devices(tmp_path, capsys):
    """cli.serve --int8 says quantized: true in /stats on one device too, as
    scripts/serve.py does; the warm-up line names the devices."""
    from PIL import Image

    from stcd_tpu_torch.cli import serve as cli_serve

    for sub in ("A", "B"):
        (tmp_path / sub).mkdir()
    for i in range(2):
        for sub, img in zip(("A", "B"), _scene(20 + i)):
            Image.fromarray((img * 255).astype(np.uint8)).save(tmp_path / sub / f"{i}.png")
    model = ["--device", "cpu", "--init_seed", "0", "--encoder", "resnet18",
             "--decoder_channels", ",".join(map(str, DEC)), "--tile", str(TILE),
             "--batch", "4"]
    engine = cli_serve.build_engine(cli_serve.parse_args(
        model + ["--int8", "--calib_dir", str(tmp_path)]))
    try:
        a, b = _scene(7)
        out = engine.predict_pair(a, b)
        stats = engine.stats_snapshot()
    finally:
        engine.close()
    assert out.shape == (64, 64, 1) and np.isfinite(out).all()
    assert stats["quantized"] is True and stats["mesh_sharded"] is False
    assert stats["devices"] == 1 and stats["errors"] == 0
    printed = capsys.readouterr().out
    assert "int8: " in printed and "warmed batch=4 tile=32 on 1 cpu device(s)\n" in printed
    engine = cli_serve.build_engine(cli_serve.parse_args(model + ["--no_shard"]))
    try:
        assert engine.stats_snapshot()["quantized"] is False
        assert engine.stats_snapshot()["batches"] == 0  # the warm-up is not counted
    finally:
        engine.close()
