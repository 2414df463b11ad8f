"""Datasets and loading, the counterpart of `lara_tpu/data` (the
reference's dataLoader/__init__.py `dataset_dict`)."""

from lara_tpu_torch.data.gobjverse import GObjaverseDataset
from lara_tpu_torch.data.gso import GSODataset
from lara_tpu_torch.data.instant3d import Instant3DDataset
from lara_tpu_torch.data.loader import DataLoader, device_prefetch
from lara_tpu_torch.data.mipnerf import MipNeRF360Dataset
from lara_tpu_torch.data.mvgen import MVGenDataset
from lara_tpu_torch.data.synthetic import SyntheticDataset, write_synthetic_store

# the reference's spelling "gobjeverse" and the corrected one
dataset_dict = {
    "gobjeverse": GObjaverseDataset,
    "gobjaverse": GObjaverseDataset,
    "GSO": GSODataset,
    "instant3d": Instant3DDataset,
    "mipnerf360": MipNeRF360Dataset,
    "mvgen": MVGenDataset,
    "synthetic": SyntheticDataset,
}


def get_dataset(name: str):
    """The dataset class registered as `name`."""
    if name not in dataset_dict:
        raise KeyError(f"unknown dataset {name!r}; lara_tpu_torch has {sorted(dataset_dict)}, "
                       "every dataset of the JAX package")
    return dataset_dict[name]


__all__ = ["dataset_dict", "get_dataset", "DataLoader", "device_prefetch",
           "GObjaverseDataset", "GSODataset", "Instant3DDataset", "MipNeRF360Dataset",
           "MVGenDataset", "SyntheticDataset", "write_synthetic_store"]
