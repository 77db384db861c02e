"""stcd_tpu_torch serving path: the BatchingEngine with the port's predict
function against the JAX BatchingEngine with the JAX model, the HTTP
endpoints, and the cli.serve / cli.predict entry points end to end."""

import argparse
import base64
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from stcd_tpu.data.augment import eval_preprocess as jax_eval_preprocess
from stcd_tpu.serving.server import BatchingEngine as JaxBatchingEngine
from stcd_tpu_torch.cli import predict as cli_predict
from stcd_tpu_torch.convert.from_flax import changeformer_v6_from_flax
from stcd_tpu_torch.models.changeformer import ChangeFormerV6
from stcd_tpu_torch.serving.server import BatchingEngine, serve

from stcd_tpu.models.segcd import SegCD as JaxSegCD
from stcd_tpu_torch.convert.from_flax import unetseg_from_flax
from stcd_tpu_torch.models.segcd import SegCD

from test_torch_changeformer import NARROW, NARROW_EMBED, JaxNarrowV6, _perturb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scene(seed, h=96, w=80):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
            rng.uniform(0, 1, (h, w, 3)).astype(np.float32))


def test_engine_with_port_model_matches_jax_engine():
    a, b = _scene(0)
    model = JaxNarrowV6()
    z = jnp.zeros((1, 64, 64, 3))
    variables = _perturb(jax.jit(model.init)(jax.random.PRNGKey(0), z, z), seed=5)

    @jax.jit
    def jax_fn(ta, tb):
        preds = model.apply(variables, jax_eval_preprocess(ta),
                            jax_eval_preprocess(tb))[-1].astype(jnp.float32)
        return jnp.sum(jax.nn.softmax(preds)[..., 1:], axis=-1, keepdims=True)

    engine = JaxBatchingEngine(jax_fn, tile=64, stride=48, batch=2)
    try:
        want = engine.predict_pair(a, b)
    finally:
        engine.close()

    port = ChangeFormerV6(embed_dim=NARROW_EMBED, **NARROW)
    port.load_state_dict(changeformer_v6_from_flax(variables["params"],
                                                   variables["batch_stats"]))
    fn = cli_predict.make_base_fn(argparse.Namespace(bf16=False), port.eval())
    engine = BatchingEngine(fn, tile=64, stride=48, batch=2, device="cpu")
    try:
        got = engine.predict_pair(a, b)
        stats = engine.stats_snapshot()
    finally:
        engine.close()
    assert got.shape == (96, 80, 1)
    assert stats["tiles"] == 4 and stats["batches"] >= 2 and stats["errors"] == 0
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_engine_with_port_segcd_matches_jax_engine():
    """SegCD returns (mask_t1, mask_t2, change): the predict function takes
    the change logit's sigmoid, as scripts/predict.py does."""
    a, b = _scene(1)
    dec = (32, 24, 16, 12, 8)
    model = JaxSegCD(encoder_name="resnet18", classes=1, decoder_channels=dec)
    z = jnp.zeros((1, 64, 64, 3))
    variables = _perturb(jax.jit(model.init)(jax.random.PRNGKey(0), z, z), seed=6)

    @jax.jit
    def jax_fn(ta, tb):
        _, _, diff = model.apply(variables, jax_eval_preprocess(ta), jax_eval_preprocess(tb))
        return jax.nn.sigmoid(diff.astype(jnp.float32))

    engine = JaxBatchingEngine(jax_fn, tile=64, stride=32, batch=2)
    try:
        want = engine.predict_pair(a, b)
    finally:
        engine.close()

    port = SegCD("resnet18", decoder_channels=dec, classes=1)
    port.load_state_dict(unetseg_from_flax(variables["params"], variables["batch_stats"]))
    fn = cli_predict.make_base_fn(argparse.Namespace(bf16=False), port.eval())
    engine = BatchingEngine(fn, tile=64, stride=32, batch=2, device="cpu")
    try:
        got = engine.predict_pair(a, b)
        stats = engine.stats_snapshot()
    finally:
        engine.close()
    assert got.shape == (96, 80, 1) and stats["errors"] == 0
    assert got.min() >= 0 and got.max() <= 1
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_predict_cli_defaults_to_segcd(tmp_path):
    """Without --net_G the model is SegCD with --encoder and
    --decoder_channels, from seeded weights or a saved state_dict."""
    parser = argparse.ArgumentParser()
    cli_predict.add_model_args(parser)
    args = parser.parse_args(["--init_seed", "0", "--device", "cpu"])
    assert args.net_G is None and args.encoder == "resnet50"
    assert args.decoder_channels == "256,128,64,32,16"
    a, b = _scene(5, 64, 64)
    Image.fromarray((a * 255).astype(np.uint8)).save(tmp_path / "a.png")
    Image.fromarray((b * 255).astype(np.uint8)).save(tmp_path / "b.png")
    common = ["--image_a", str(tmp_path / "a.png"), "--image_b", str(tmp_path / "b.png"),
              "--encoder", "resnet18", "--decoder_channels", "32,24,16,12,8",
              "--device", "cpu", "--tile", "64", "--batch", "1"]
    cli_predict.main(common + ["--init_seed", "0", "--prob_out", str(tmp_path / "p.npy"),
                               "--out", str(tmp_path / "mask.png")])
    probs = np.load(tmp_path / "p.npy")
    assert probs.shape == (64, 64, 1) and np.isfinite(probs).all()
    assert probs.min() >= 0 and probs.max() <= 1
    args = parser.parse_args(["--init_seed", "0", "--device", "cpu", "--encoder", "resnet18",
                              "--decoder_channels", "32,24,16,12,8"])
    model = cli_predict.build_model(args)
    assert isinstance(model, SegCD) and not model.training
    torch.save(model.state_dict(), tmp_path / "segcd.pt")
    cli_predict.main(common + ["--weights", str(tmp_path / "segcd.pt"),
                               "--prob_out", str(tmp_path / "p2.npy"),
                               "--out", str(tmp_path / "mask2.png")])
    np.testing.assert_array_equal(np.load(tmp_path / "p2.npy"), probs)


def _toy_fn(a, b):
    return (a - b).abs().mean(-1, keepdim=True)


def _b64_png(arr01):
    buf = io.BytesIO()
    Image.fromarray((arr01 * 255).astype(np.uint8)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _post(url, payload):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.load(r)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.load(r)


def test_http_server_endpoints():
    engine = BatchingEngine(_toy_fn, tile=32, batch=4, max_wait_ms=5.0, device="cpu")
    httpd = serve(engine, "127.0.0.1", 0)  # ephemeral port
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        assert _get(f"{url}/healthz") == {"status": "ok", "tile": 32, "batch": 4}

        a, b = _scene(7, 64, 64)
        out = _post(f"{url}/predict", {"image_a": _b64_png(a), "image_b": _b64_png(b),
                                       "threshold": 0.2})
        assert out["shape"] == [64, 64]
        mask = np.asarray(Image.open(io.BytesIO(base64.b64decode(out["mask_png"]))))
        a8, b8 = ((np.asarray(x * 255, np.float32).astype(np.uint8) / 255.0)
                  .astype(np.float32) for x in (a, b))
        scores = np.abs(a8 - b8).mean(-1)
        off = np.abs(scores - 0.2) > 1e-6  # exact-threshold pixels round either way
        np.testing.assert_array_equal((mask > 127)[off], (scores > 0.2)[off])
        assert out["changed"] == pytest.approx((mask > 127).mean(), abs=1e-6)

        stats = _get(f"{url}/stats")
        assert stats["requests"] == 1 and stats["tiles"] == 4
        assert 0 < stats["mean_batch_occupancy"] <= 1
        assert stats["request_latency_ms"]["n"] == 1
        assert stats["step_ms"]["n"] == stats["batches"]
        assert stats["mesh_sharded"] is False and stats["devices"] == 1

        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"{url}/predict", {"image_a": "zz"})
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{url}/nope")
        assert ei.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"{url}/nope", {})
        assert ei.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.close()


def test_serve_cli_end_to_end():
    """python -m stcd_tpu_torch.cli.serve with the full-width V6 on seeded
    weights: boot, warm, and round-trip a /predict request."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "stcd_tpu_torch.cli.serve", "--device", "cpu",
         "--net_G", "ChangeFormerV6", "--batch", "2", "--tile", "64", "--init_seed", "0",
         "--port", str(port)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                assert _get(f"{url}/healthz")["status"] == "ok"
                break
            except (urllib.error.URLError, ConnectionError):
                if proc.poll() is not None:
                    raise AssertionError(f"server died:\n{proc.stdout.read()[-3000:]}")
                if time.monotonic() > deadline:
                    raise AssertionError("server did not come up in 120 s")
                time.sleep(0.5)
        a, b = _scene(3, 96, 80)
        out = _post(f"{url}/predict", {"image_a": _b64_png(a), "image_b": _b64_png(b)})
        assert out["shape"] == [96, 80]
        assert 0.0 <= out["changed"] <= 1.0
        stats = _get(f"{url}/stats")
        assert stats["tiles"] == 4 and stats["errors"] == 0
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_predict_cli_writes_mask_and_probs(tmp_path):
    """cli.predict from seeded weights, then from the same weights saved as a
    state_dict: the same probabilities, and a mask that thresholds them."""
    a, b = _scene(4, 80, 72)
    Image.fromarray((a * 255).astype(np.uint8)).save(tmp_path / "a.png")
    Image.fromarray((b * 255).astype(np.uint8)).save(tmp_path / "b.png")
    common = ["--image_a", str(tmp_path / "a.png"), "--image_b", str(tmp_path / "b.png"),
              "--net_G", "ChangeFormerV6", "--device", "cpu", "--tile", "64",
              "--stride", "48", "--batch", "2"]
    cli_predict.main(common + ["--init_seed", "0", "--prob_out", str(tmp_path / "p.npy"),
                               "--out", str(tmp_path / "out" / "mask.png")])
    probs = np.load(tmp_path / "p.npy")
    assert probs.shape == (80, 72, 1) and probs.dtype == np.float32
    assert np.isfinite(probs).all() and probs.min() >= 0 and probs.max() <= 1
    mask = np.asarray(Image.open(tmp_path / "out" / "mask.png"))
    np.testing.assert_array_equal(mask > 127, probs[..., 0] > 0.5)

    args = argparse.Namespace(net_G="ChangeFormerV6", n_class=2, embed_dim=64,
                              device="cpu", weights=None, init_seed=0)  # the CLI's default
    torch.save(cli_predict.build_model(args).state_dict(), tmp_path / "v6.pt")
    cli_predict.main(common + ["--weights", str(tmp_path / "v6.pt"),
                               "--prob_out", str(tmp_path / "p2.npy"),
                               "--out", str(tmp_path / "mask2.png")])
    np.testing.assert_array_equal(np.load(tmp_path / "p2.npy"), probs)


def test_device_cuda_without_card_raises_and_other_models_wait(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_predict.resolve_device("cuda")
    from stcd_tpu_torch.encoders import get_encoder
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_encoder("densenet121")  # the other encoder families wait (Queue 1 #9d)


def test_every_entry_point_defaults_to_the_card(monkeypatch):
    """Every entry point's ``device`` default is "cuda", and on a host with
    no card the default raises instead of carrying on on the CPU."""
    import inspect

    from stcd_tpu_torch.cli import serve as cli_serve
    from stcd_tpu_torch.data.tiled_inference import predict_scene
    from stcd_tpu_torch.tools import bench_bnstats_diag, bench_conv_bn_epilogue
    from stcd_tpu_torch.tools.profile_step import stage_setup
    from stcd_tpu_torch.train.state import create_train_state
    from stcd_tpu_torch.train.trainer import CDTrainer

    from stcd_tpu_torch.cli import (common, evaluate, pipeline_demo, train_ffctl,
                                    train_pse_cd, train_stcd, train_sup)
    from stcd_tpu_torch.data.loader import DataLoader

    for fn in (BatchingEngine.__init__, predict_scene, create_train_state,
               CDTrainer.init_state, stage_setup, DataLoader.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    for add_args in (cli_predict.add_model_args, bench_conv_bn_epilogue.add_args):
        parser = argparse.ArgumentParser()
        add_args(parser)
        assert parser.get_default("device") == "cuda", add_args
    assert common.base_parser("LEVIR", "runs/x").get_default("device") == "cuda"

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchingEngine(_toy_fn)
    a, b = _scene(2, 64, 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_scene(_toy_fn, a, b, tile=32, stride=32)
    for main in (cli_serve.main, bench_conv_bn_epilogue.main, bench_bnstats_diag.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--init_seed", "0"] if main is cli_serve.main else [])
    # the stage CLIs and the demo refuse before they read or write anything
    for main in (train_sup.main, train_pse_cd.main, train_stcd.main, train_ffctl.main,
                 evaluate.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--root_path", "no/such/dir", "--save_name", "no/such/run"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline_demo.main(["no/such/root"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataLoader([{"A": np.zeros((2, 2, 3), np.uint8)}], batch_size=1)


@pytest.mark.parametrize("net_G", ["base_transformer_pos_s4_dd8", "ChangeFormerV6"])
def test_predict_cli_init_seed_gives_the_trainers_weights(net_G):
    """--init_seed initialises by the model family's rules
    (models.factory.init_weights), so one seed gives the CLI the weights that
    CDTrainer.init_state gives the trainer: for BIT fan-in normal convs and
    normal(0, 1) position embeddings, not ChangeFormer's rules. V6 at a
    decoder width of 32 to stay small."""
    from stcd_tpu_torch.train.trainer import CDTrainer, TrainerConfig

    parser = argparse.ArgumentParser()
    cli_predict.add_model_args(parser)
    model = cli_predict.build_model(parser.parse_args(
        ["--net_G", net_G, "--init_seed", "3", "--device", "cpu", "--embed_dim", "32"]))
    trainer = CDTrainer(TrainerConfig(net_G=net_G, embed_dim=32))
    want = trainer.init_state("cpu", init_seed=3).model.state_dict()
    got = model.state_dict()
    assert set(got) == set(want) and len(want) > 50
    for name, tensor in want.items():
        assert torch.equal(got[name], tensor), name
    other = cli_predict.build_model(parser.parse_args(
        ["--net_G", net_G, "--init_seed", "4", "--device", "cpu", "--embed_dim", "32"]))
    assert not all(torch.equal(a, b) for a, b in zip(other.state_dict().values(),
                                                       got.values()))
