"""The port's data path against the JAX package's, on the CPU: the dataset
classes (every key bit-equal, float and uint8 mode), the demo tree (the same
bytes for a seed), the loader (the same batches in the same order) and the
offline dataset tools (the same files)."""

import filecmp
import os

import numpy as np
import pytest
import torch
from PIL import Image

from scripts import make_demo_data as jax_demo
from stcd_tpu.data import datasets as jax_ds
from stcd_tpu.data import io as jax_io
from stcd_tpu.data import tools as jax_tools
from stcd_tpu.data.loader import DataLoader as JaxLoader
from stcd_tpu_torch.cli import make_demo_data as port_demo
from stcd_tpu_torch.data import datasets as port_ds
from stcd_tpu_torch.data import io as port_io
from stcd_tpu_torch.data import tools as port_tools
from stcd_tpu_torch.data.loader import DataLoader, _stack


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_tree(a, b):
    names = _files(a)
    assert names and names == _files(b)
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The JAX demo tree (4 train, 2 val tiles of 32x32), plus what stage 2's
    gated passes add and SCDataset(semi=True) and FFCDataset read: the
    reliable ids, pseudo_label/ and ff_label/ of the WHU-AB and LEVIR train
    splits."""
    root = str(tmp_path_factory.mktemp("demo"))
    jax_demo.make_tree(root, n=4, size=32, seed=0)
    rng = np.random.default_rng(5)
    for ds in ("WHU-AB", "LEVIR"):
        train = os.path.join(root, ds, "train")
        names = sorted(os.listdir(os.path.join(train, "A")))
        jax_io.write_list(names[1::2], os.path.join(train, "list", "reliable_ids.txt"))
        jax_io.write_list(names[::2], os.path.join(train, "list", "unreliable_ids.txt"))
        for sub in ("pseudo_label", "ff_label"):
            os.makedirs(os.path.join(train, sub))
            for name in names:
                lab = (rng.uniform(size=(32, 32)) > 0.6).astype(np.uint8) * 255
                Image.fromarray(lab).save(os.path.join(train, sub, name))
    return root


@pytest.fixture
def uint8_mode(request):
    """Both packages in float (False) or uint8 (True) mode for one test."""
    jax_io.set_uint8_transfer(request.param)
    port_io.set_uint8_transfer(request.param)
    yield request.param
    jax_io.set_uint8_transfer(False)
    port_io.set_uint8_transfer(False)


DATASETS = [
    ("WHUDataset", ("WHU-AB", "train"), {}),
    ("WHUDataset", ("WHU-AB", "val"), {}),
    ("CDDataset", ("LEVIR", "val"), {}),
    ("CDDataset", ("LEVIR", "train"), {"reliable": "reliable"}),
    ("CDDataset", ("LEVIR", "train"), {"reliable": "unreliable"}),
    ("FFCDataset", ("LEVIR", "train"), {}),
    ("PSEDataset", ("LEVIR", "train"), {}),
    ("SCDataset", ("WHU-AB", "train"), {}),
    ("SCDataset", ("WHU-AB", "train"), {"semi": True}),
    ("LEVIRDataset", ("LEVIR", "train"), {}),
    # seg_wrap below the length: indices 2 and 3 wrap as index % 1 (index > seg_wrap)
    ("LEVIRDataset", ("LEVIR", "train"), {"seg_wrap": 1}),
]


@pytest.mark.parametrize("uint8_mode", [False, True], indirect=True, ids=["float", "uint8"])
@pytest.mark.parametrize("cls,args,kwargs", DATASETS,
                         ids=[f"{c}-{a[1]}-{'-'.join(map(str, k.values()))}"
                              for c, a, k in DATASETS])
def test_dataset_matches_jax(tree, uint8_mode, cls, args, kwargs):
    want_ds = getattr(jax_ds, cls)(tree, *args, **kwargs)
    got_ds = getattr(port_ds, cls)(tree, *args, **kwargs)
    assert len(got_ds) == len(want_ds) > 0
    assert got_ds.augment == want_ds.augment
    for i in range(len(want_ds)):
        want, got = want_ds[i], got_ds[i]
        assert got.keys() == want.keys()
        assert got["name"] == want["name"]
        for key, w in want.items():
            if key == "name":
                continue
            assert got[key].dtype == w.dtype == (np.uint8 if uint8_mode else np.float32), key
            np.testing.assert_array_equal(got[key], w, err_msg=key)


def test_synthetic_dataset_matches_jax():
    want_ds, got_ds = jax_ds.SyntheticCDDataset(5, 20, seed=3), port_ds.SyntheticCDDataset(5, 20, seed=3)
    assert len(got_ds) == len(want_ds) == 5
    for i in range(5):
        want, got = want_ds[i], got_ds[i]
        assert got.keys() == want.keys() and got["name"] == want["name"]
        for key in ("A", "B", "label", "image"):
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("n,size,seed", [(4, 32, 0), (3, 24, 7)])
def test_make_demo_data_writes_the_jax_bytes(tmp_path, n, size, seed):
    jax_demo.make_tree(str(tmp_path / "jax"), n=n, size=size, seed=seed)
    port_demo.main([str(tmp_path / "port"), "--n", str(n), "--size", str(size),
                    "--seed", str(seed)])
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


LOADERS = [
    dict(batch_size=3, shuffle=True, drop_last=False),  # a partial final batch
    dict(batch_size=3, shuffle=True, drop_last=True),
    dict(batch_size=2, shuffle=False, drop_last=False, seed=9),
    dict(batch_size=8, shuffle=True, drop_last=False, seed=4),  # one partial batch
]


@pytest.mark.parametrize("kwargs", LOADERS, ids=lambda k: "-".join(f"{a}{b}" for a, b in k.items()))
def test_loader_matches_jax_over_two_epochs(kwargs):
    ds = port_ds.SyntheticCDDataset(7, 16, seed=2)
    want_loader = JaxLoader(jax_ds.SyntheticCDDataset(7, 16, seed=2), sharding=None,
                            prefetch=0, process_index=0, process_count=1, **kwargs)
    got_loader = DataLoader(ds, device="cpu", num_workers=3, **kwargs)
    assert len(got_loader) == len(want_loader)
    for _ in range(2):
        want, got = list(want_loader), list(got_loader)
        assert len(got) == len(want) == len(want_loader)
        for w, g in zip(want, got):
            assert g.keys() == w.keys() and g["name"] == w["name"]
            for key, value in w.items():
                if key != "name":
                    assert torch.is_tensor(g[key]) and g[key].device.type == "cpu"
                    np.testing.assert_array_equal(g[key].numpy(), value)


def test_loader_names_its_limits(monkeypatch):
    ds = port_ds.SyntheticCDDataset(4, 8)
    with pytest.raises(NotImplementedError, match="Queue 1 #10"):
        DataLoader(ds, device="cpu", process_index=0, process_count=2)
    with pytest.raises(ValueError, match="together"):
        DataLoader(ds, device="cpu", process_count=1)
    assert DataLoader(ds, device="cpu", process_index=0, process_count=1).device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataLoader(ds)


def test_stack_matches_jax_and_pins_nothing_on_the_cpu():
    from stcd_tpu.data.loader import _stack as jax_stack
    samples = [port_ds.SyntheticCDDataset(3, 8)[i] for i in range(3)]
    want, got = jax_stack(samples), _stack(samples)
    assert got["name"] == want["name"]
    for key in ("A", "B", "label", "image"):
        assert not got[key].is_pinned()
        np.testing.assert_array_equal(got[key].numpy(), want[key])


@pytest.fixture
def rasters(tmp_path):
    """Two 80x70 rasters for each of the five subdirs of image_data/."""
    rng = np.random.default_rng(1)
    src = tmp_path / "raw"
    for sub in ("A", "A_label", "B", "B_label", "C_label"):
        (src / "image_data" / sub).mkdir(parents=True)
        for i in range(2):
            arr = rng.integers(0, 256, (80, 70, 3), dtype=np.uint8)
            if "label" in sub:
                arr = ((arr > 200) * 255).astype(np.uint8)
            Image.fromarray(arr).save(src / "image_data" / sub / f"r{i}.tif")
    return tmp_path


def test_dataset_tools_match_jax(rasters):
    root = str(rasters)
    for pkg, out in ((jax_tools, "jax"), (port_tools, "port")):
        tiles = os.path.join(root, out, "tiles")
        n = pkg.tile_rasters(os.path.join(root, "raw"), tiles, crop_size=32, stride=24)
        assert n == 5 * 2 * (3 * 2)  # 3 x 2 tiles of an 80 x 70 raster
        pkg.split_dataset(tiles, os.path.join(root, out, "split"), n_train=2, n_val=1, seed=3)
        pkg.select_changed(tiles, os.path.join(root, out, "changed.txt"), threshold=300.0)
        pkg.create_list(tiles, "all.txt", subdir="B")
    _same_tree(os.path.join(root, "jax"), os.path.join(root, "port"))


def test_dataset_tools_main(rasters):
    root = str(rasters)
    port_tools.main(["tile", os.path.join(root, "raw"), os.path.join(root, "t"),
                     "--crop_size", "32", "--stride", "32"])
    port_tools.main(["create_list", os.path.join(root, "t"), "--name", "train.txt"])
    names = port_io.read_list(os.path.join(root, "t", "list", "train.txt"))
    assert names == sorted(os.listdir(os.path.join(root, "t", "A"))) and len(names) == 8
