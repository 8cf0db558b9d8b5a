"""The data layer (counterpart of ``hgsfusion_tpu/datasets``): KITTI-format
frames read, encoded, filtered, padded to static shapes and collated, in
numpy. The View-of-Delft and TJ4DRadSet datasets are ported."""
from __future__ import annotations

from .dataset import DatasetTemplate
from .tj4d import TJ4DDataset
from .vod import VODDataset

__all__ = {"DatasetTemplate": DatasetTemplate, "VODDataset": VODDataset,
           "TJ4DDataset": TJ4DDataset}

# the ROADMAP.md item that ports each of the JAX package's other datasets
NOT_PORTED = {name: "queue 1 item 10" for name in (
    "KittiDataset", "CustomDataset", "NuScenesDataset", "ONCEDataset", "WaymoDataset",
    "LyftDataset", "PandasetDataset", "Argo2Dataset")}


def build_dataset(dataset_cfg, class_names, training=False, root_path=None, logger=None):
    name = dataset_cfg["DATASET"]
    if name not in __all__ or name == "DatasetTemplate":
        where = NOT_PORTED.get(name, "no item yet")
        raise NotImplementedError(f"DATASET: {name} is not ported (ROADMAP.md {where})")
    return __all__[name](dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger)
