"""Dataset registry (`ngf_tpu/data/registry.py`,
`InfoInv/dataLoader/__init__.py:9-13`): every loader of the JAX package."""

from __future__ import annotations

from .blender import BlenderDataset
from .llff import LLFFDataset
from .nsvf import NSVFDataset
from .own_data import OwnDataDataset
from .synthetic import SyntheticDataset
from .tankstemple import TanksTempleDataset

dataset_dict = {
    "blender": BlenderDataset,
    "llff": LLFFDataset,
    "nsvf": NSVFDataset,
    "tankstemple": TanksTempleDataset,
    "own_data": OwnDataDataset,
    "synthetic": SyntheticDataset,  # built-in analytic scene (no disk data)
}


def load_dataset(name: str, datadir: str, split: str = "train",
                 downsample: float = 1.0, is_stack: bool | None = None, **kw):
    if name not in dataset_dict:
        raise ValueError(f"unknown dataset {name!r}; choices: {sorted(dataset_dict)}")
    return dataset_dict[name](datadir, split=split, downsample=downsample, is_stack=is_stack, **kw)
