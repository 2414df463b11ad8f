"""Datasets and loading, the counterpart of `lara_tpu/data` (the
reference's dataLoader/__init__.py `dataset_dict`)."""

from lara_tpu_torch.data.gobjverse import GObjaverseDataset
from lara_tpu_torch.data.gso import GSODataset
from lara_tpu_torch.data.instant3d import Instant3DDataset
from lara_tpu_torch.data.loader import DataLoader, device_prefetch
from lara_tpu_torch.data.mipnerf import MipNeRF360Dataset
from lara_tpu_torch.data.synthetic import SyntheticDataset, write_synthetic_store

# the reference's spelling "gobjeverse" and the corrected one
dataset_dict = {
    "gobjeverse": GObjaverseDataset,
    "gobjaverse": GObjaverseDataset,
    "GSO": GSODataset,
    "instant3d": Instant3DDataset,
    "mipnerf360": MipNeRF360Dataset,
    "synthetic": SyntheticDataset,
}


def get_dataset(name: str):
    """The dataset class registered as `name`."""
    if name == "mvgen":
        raise KeyError("dataset 'mvgen' is not ported to lara_tpu_torch: it samples its "
                       "views from a multi-view diffusion model whose weights the port "
                       "does not load (ROADMAP.md A.7)")
    if name not in dataset_dict:
        raise KeyError(f"dataset {name!r} is not ported to lara_tpu_torch yet (ported: "
                       f"{sorted(dataset_dict)}; ROADMAP.md lists the rest)")
    return dataset_dict[name]


__all__ = ["dataset_dict", "get_dataset", "DataLoader", "device_prefetch",
           "GObjaverseDataset", "GSODataset", "Instant3DDataset", "MipNeRF360Dataset",
           "SyntheticDataset", "write_synthetic_store"]
