"""stcd_tpu_torch's Oxford Pet datasets (data/oxford_pet.py, the ``datasets``
namespace) against the JAX package's, on a tiny tree in the dataset's layout
written to tmp_path: the same split rule, the trimap mapping, the 256x256
resizes (PIL bilinear and nearest) and the item keys, every array equal."""

import numpy as np
import pytest

from stcd_tpu.data import oxford_pet as joxford
from stcd_tpu_torch import datasets as tdatasets
from stcd_tpu_torch.data import oxford_pet as toxford


def write_oxford_tree(root, n_trainval=12, n_test=3):
    """A tiny tree: 40-90 px images, trimaps in {1, 2, 3}, both split lists."""
    return toxford.write_synthetic_tree(root, n_trainval, n_test, min_size=40, max_size=90)


@pytest.mark.parametrize("mode", ["train", "valid", "test"])
@pytest.mark.parametrize("simple", [False, True], ids=["full", "simple"])
def test_items_equal_jax(tmp_path, mode, simple):
    write_oxford_tree(str(tmp_path))
    name = "SimpleOxfordPetDataset" if simple else "OxfordPetDataset"
    got_ds = getattr(toxford, name)(str(tmp_path), mode)
    want_ds = getattr(joxford, name)(str(tmp_path), mode)
    assert got_ds.filenames == want_ds.filenames
    assert len(got_ds) == {"train": 10, "valid": 2, "test": 3}[mode]
    for i in range(len(got_ds)):
        got, want = got_ds[i], want_ds[i]
        assert set(got) == set(want)
        for key in want:
            if key == "name":
                assert got[key] == want[key]
            else:
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        if simple:
            assert got["image"].shape == (256, 256, 3) and got["label"].shape == (256, 256, 1)
        assert set(np.unique(got["mask"]).tolist()) <= {0.0, 1.0}


def test_datasets_namespace_and_mode_check(tmp_path):
    write_oxford_tree(str(tmp_path), n_trainval=4, n_test=1)
    assert tdatasets.SimpleOxfordPetDataset is toxford.SimpleOxfordPetDataset
    assert tdatasets.OxfordPetDataset is toxford.OxfordPetDataset
    assert sorted(tdatasets.__all__) == sorted(__import__("stcd_tpu.datasets", fromlist=["x"]).__all__)
    with pytest.raises(AssertionError):
        toxford.OxfordPetDataset(str(tmp_path), "val")


def test_synthetic_tree_has_the_dataset_layout(tmp_path):
    names = write_oxford_tree(str(tmp_path), n_trainval=10, n_test=2)
    item = toxford.OxfordPetDataset(str(tmp_path), "test")[0]
    assert item["name"] == names[10] and item["image"].dtype == np.uint8
    assert 40 <= min(item["image"].shape[:2]) and max(item["image"].shape[:2]) < 90
    assert set(np.unique(item["trimap"]).tolist()) == {1, 2, 3}
    assert item["mask"].mean() > 0.05  # the pet and its border are foreground


def test_preprocessing_fn_takes_the_loader_tensors():
    """The encoder's preprocessing on a tensor batch (uint8 or float, on its
    device) equals JAX's on the numpy array."""
    import torch

    from stcd_tpu.encoders import get_preprocessing_fn as jax_fn
    from stcd_tpu_torch.encoders import get_preprocessing_fn

    x = np.random.default_rng(0).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    for name in ("resnet34", "se_resnext50_32x4d"):
        want = np.asarray(jax_fn(name)(x))
        got = get_preprocessing_fn(name)(torch.from_numpy(x))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(get_preprocessing_fn(name)(x), want, rtol=1e-6, atol=1e-6)


def test_fit_loop_over_the_simple_dataset_on_the_cpu(tmp_path):
    """smp's binary-segmentation example at a toy size: TrainEpoch over
    SimpleOxfordPetDataset batches with the smp DiceLoss, then get_stats and
    iou_score on the valid split."""
    import torch

    from stcd_tpu_torch import losses, metrics
    from stcd_tpu_torch.data.loader import DataLoader
    from stcd_tpu_torch.encoders import get_preprocessing_fn
    from stcd_tpu_torch.models import create_model
    from stcd_tpu_torch.models.segcd import init_weights
    from stcd_tpu_torch.train.state import AdamConfig, create_train_state
    from stcd_tpu_torch.utils.meter import IoU, TrainEpoch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        write_oxford_tree(str(tmp_path), n_trainval=5, n_test=1)
        pre = get_preprocessing_fn("resnet18")
        model = init_weights(create_model("fpn", "resnet18", decoder_pyramid_channels=32,
                                          decoder_segmentation_channels=32), seed=0)
        state = create_train_state(model, AdamConfig(lambda step: 1e-3), device="cpu", seed=0)
        loader = DataLoader(toxford.SimpleOxfordPetDataset(str(tmp_path), "train"), 2,
                            shuffle=True, device="cpu")
        batches = ({"image": pre(b["image"]), "label": b["label"]} for b in loader)
        state, logs = TrainEpoch(None, losses.DiceLoss("binary", from_logits=True),
                                 [IoU(activation="sigmoid")]).run(state, batches)
        assert state.step == 2 and np.isfinite(logs["loss"]) and set(logs) == {"loss",
                                                                               "iou_score"}
        valid = next(iter(DataLoader(toxford.SimpleOxfordPetDataset(str(tmp_path), "valid"), 2,
                                     device="cpu")))
        logits = model.predict(pre(valid["image"]).permute(0, 3, 1, 2))
        stats = metrics.get_stats((logits.sigmoid() > 0.5).long(),
                                  valid["label"].permute(0, 3, 1, 2).long(), "binary")
        assert int(sum(s.sum() for s in stats)) == 256 * 256
        assert 0.0 <= float(metrics.iou_score(*stats, reduction="micro")) <= 1.0
    finally:
        torch.set_num_threads(threads)
