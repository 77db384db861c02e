"""Data layer (counterpart of stcd_tpu/data): the datasets, the loader, the
augmentation, the Oxford Pet datasets and the IO helpers. ``DataLoader`` and
the dataset classes load on first use."""

from stcd_tpu_torch._lazy import lazy_getattr

_EXPORTS = {"DataLoader": "loader", "CDDataset": "datasets", "FFCDataset": "datasets",
            "LEVIRDataset": "datasets", "PSEDataset": "datasets", "SCDataset": "datasets",
            "SyntheticCDDataset": "datasets", "WHUDataset": "datasets"}

__getattr__ = lazy_getattr(__name__, _EXPORTS)

__all__ = sorted(_EXPORTS)
