"""The port's native decoder (stcd_tpu_torch/native) against the JAX
package's native decoder and PIL, on the fixtures of tests/test_native_io.py:
every PNG flavour (RGB, gray, palette, RGBA with the alpha stripped, 1-bit)
and baseline JPEG decode to PIL's pixels; formats other than JPEG/PNG and IO
errors go to PIL; the library is built under build/, never beside its
source; STCD_NO_NATIVE=1 switches it off."""

import logging
import os
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from stcd_tpu import native as jax_native
from stcd_tpu_torch import native
from stcd_tpu_torch.data import io as port_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (64, 48, 3), np.uint8)
    rgba = np.concatenate([rgb, rng.integers(0, 256, (64, 48, 1), np.uint8)], axis=-1)
    Image.fromarray(rgb).save(d / "rgb.png")
    Image.fromarray(rgb[..., 0]).save(d / "gray.png")
    Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE).save(d / "pal.png")
    Image.fromarray(rgba).save(d / "rgba.png")
    Image.fromarray(rgb[..., 0] > 128).save(d / "bit.png")
    Image.fromarray(rgb).save(d / "color.jpg", quality=90)
    Image.fromarray(rgb[..., 0]).save(d / "gray.jpg", quality=90)
    Image.fromarray(rgb).save(d / "other.bmp")
    lab = np.zeros((64, 48, 3), np.uint8)
    lab[10:20, 5:15] = 255
    lab[30:40, 20:30] = 1  # >= 1 counts as changed
    Image.fromarray(lab).save(d / "label.png")
    return d


@pytest.fixture
def fresh_native(monkeypatch):
    """The port's loader state reset for one test and restored after it."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    return native


def test_library_builds_under_build_not_beside_its_source():
    assert native.available()
    so = native.library_path()
    assert so.exists() and so.parent == Path(REPO, "build", "stcd_tpu_torch")
    assert so.name.startswith("libstcd_io_") and so.suffix == ".so"
    src_dir = os.path.join(REPO, "stcd_tpu_torch", "native")
    assert not [f for f in os.listdir(src_dir) if f.endswith(".so")]
    # the port's own source: a copy of the JAX package's decoder, not the JAX file
    assert native.SRC.parent == Path(src_dir)


@pytest.mark.parametrize("name", ["rgb.png", "gray.png", "pal.png", "rgba.png", "bit.png",
                                  "color.jpg", "gray.jpg"])
def test_decode_matches_jax_native_and_pil(images, name):
    path = str(images / name)
    with Image.open(path) as im:
        ref = np.asarray(im.convert("RGB"), np.uint8)
    got = native.decode_rgb(path)
    assert got is not None and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jax_native.decode_rgb(path))


def test_image_dims_and_what_goes_to_pil(images, tmp_path):
    assert native.image_dims(str(images / "rgb.png")) == (64, 48)
    assert native.image_dims(str(images / "color.jpg")) == (64, 48)
    assert native.image_dims(str(images / "missing.png")) is None
    assert native.image_dims(str(images / "other.bmp")) is None
    assert native.decode_rgb(str(images / "other.bmp")) is None
    raw = (images / "rgb.png").read_bytes()
    (tmp_path / "trunc.png").write_bytes(raw[: len(raw) // 2])
    assert native.decode_rgb(str(tmp_path / "trunc.png")) is None


def test_batch_decode_collates_and_flags_failures(images):
    paths = [str(images / "rgb.png"), str(images / "color.jpg"),
             str(images / "missing.png"), str(images / "pal.png")]
    batch, ok = native.decode_rgb_batch(paths, 64, 48, num_threads=3)
    want, want_ok = jax_native.decode_rgb_batch(paths, 64, 48, num_threads=3)
    assert ok == want_ok == [True, True, False, True]
    assert batch.shape == (4, 64, 48, 3) and batch.dtype == np.uint8
    np.testing.assert_array_equal(batch, want)
    assert not batch[2].any()  # the failed row is zero-filled
    batch, ok = native.decode_rgb_batch([str(images / "rgb.png")], 32, 48)
    assert ok == [False] and not batch.any()


@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
@pytest.mark.parametrize("name", ["rgba.png", "color.jpg", "other.bmp", "label.png"])
def test_read_image_and_label_native_and_pil_agree(images, name, uint8, monkeypatch):
    from stcd_tpu.data import io as jax_io
    path = str(images / name)
    port_io.set_uint8_transfer(uint8)
    jax_io.set_uint8_transfer(uint8)
    try:
        port_io.reset_decode_counts()
        via_native = port_io.read_image(path), port_io.read_label(path)
        how = "pil" if name.endswith(".bmp") else "native"
        assert port_io.decode_counts() == {how: 2}
        for got, want in zip(via_native, (jax_io.read_image(path), jax_io.read_label(path))):
            assert got.dtype == want.dtype == (np.uint8 if uint8 else np.float32)
            np.testing.assert_array_equal(got, want)
        monkeypatch.setattr(native, "decode_rgb", lambda p: None)
        port_io.reset_decode_counts()
        via_pil = port_io.read_image(path), port_io.read_label(path)
        assert port_io.decode_counts() == {"pil": 2}
        for a, b in zip(via_native, via_pil):
            np.testing.assert_array_equal(a, b)
    finally:
        port_io.set_uint8_transfer(False)
        jax_io.set_uint8_transfer(False)
    if name == "label.png":
        assert via_native[1].sum() == 2 * 10 * 10  # both boxes binarised to 1


def test_kill_switch_and_one_warning_when_the_build_fails(images, fresh_native, monkeypatch,
                                                          tmp_path, caplog):
    monkeypatch.setenv("STCD_NO_NATIVE", "1")
    assert fresh_native.load() is None and fresh_native.decode_rgb(str(images / "rgb.png")) is None
    port_io.reset_decode_counts()
    assert port_io.read_image(str(images / "rgb.png")).shape == (64, 48, 3)
    assert port_io.decode_counts() == {"pil": 1}

    monkeypatch.delenv("STCD_NO_NATIVE")
    monkeypatch.setattr(fresh_native, "library_path", lambda: tmp_path / "libstcd_io_x.so")
    monkeypatch.setattr(fresh_native, "LIBS", ["-lno_such_library_here"])
    with caplog.at_level(logging.WARNING, logger=fresh_native.__name__):
        assert fresh_native.load() is None
        assert fresh_native.load() is None
    assert len([r for r in caplog.records if "build failed" in r.message]) == 1
    assert not list(tmp_path.iterdir())  # nothing half-written is left behind
