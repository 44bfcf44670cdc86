"""Dataset registry (`ngf_tpu/data/registry.py`). The port has the analytic
synthetic scene and the Blender loader: the LLFF, NSVF, Tanks-and-Temples
and own-data loaders are still to port (ROADMAP.md, items still missing)."""

from __future__ import annotations

from .blender import BlenderDataset
from .synthetic import SyntheticDataset

dataset_dict = {"synthetic": SyntheticDataset, "blender": BlenderDataset}
_NOT_PORTED = ("llff", "nsvf", "tankstemple", "own_data")


def load_dataset(name: str, datadir: str, split: str = "train",
                 downsample: float = 1.0, is_stack: bool | None = None, **kw):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"dataset {name!r} is not ported to ngf_tpu_torch yet (ROADMAP.md, "
            f"items still missing); use one of {sorted(dataset_dict)}"
        )
    if name not in dataset_dict:
        raise ValueError(f"unknown dataset {name!r}; choices: {sorted(dataset_dict)}")
    return dataset_dict[name](datadir, split=split, downsample=downsample, is_stack=is_stack, **kw)
