"""smp's ``datasets`` namespace (counterpart of stcd_tpu/datasets): the Oxford
Pet datasets of ``data/oxford_pet.py``. The STCD pair datasets are in
``data/datasets.py``."""

from stcd_tpu_torch.data.oxford_pet import OxfordPetDataset, SimpleOxfordPetDataset

__all__ = ["OxfordPetDataset", "SimpleOxfordPetDataset"]
