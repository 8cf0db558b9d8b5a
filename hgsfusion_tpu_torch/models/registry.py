"""The model registry: a config's ``MODEL.NAME`` -> its detector family.

Counterpart of ``hgsfusion_tpu/models/registry.py::build_network`` for the
families the port has: HGSFusion (``HGSFusion``, and ``CaDDN``, the
reference's name for its topology), the radar-only detector (``RadarOnly``,
``PillarNet``), PointPillars (``PointPillar``; with
``DENSE_HEAD.NAME: AnchorHeadMulti`` the grouped multi-head variant),
BEVFusion (``BevFusion``, ``BEVFusion``), TransFusion-L
(``TransFusion``), CenterPoint (``CenterPoint``), SECOND (``SECONDNet``,
``SECOND``; with ``BACKBONE_3D.NAME: VoxelBackBone8xFocal`` the focal
SECOND), SECOND-IoU (``SECONDNetIoU``), Voxel R-CNN (``VoxelRCNN``),
PV-RCNN (``PVRCNN``, ``PV-RCNN``), PV-RCNN++ (``PVRCNNPlusPlus``,
``PV-RCNN++``), Part-A2 (``PartA2Net``, ``PartA2``) and VoxelNeXt
(``VoxelNeXt``). Every other name of the JAX registry raises,
naming the ROADMAP.md item that ports it.
"""
from __future__ import annotations

from ..config import model_config_from_yaml
from .detector import (BEVFusionModel, CenterPointModel, HGSFusionModel, PartA2Model,
                       PointPillarModel, PointPillarMultiHeadModel, PVRCNNModel,
                       PVRCNNPlusPlusModel, RadarOnlyModel, SECONDIoUModel, SECONDModel,
                       TransFusionModel, VoxelNeXtModel, VoxelRCNNModel)

DETECTORS = {
    "HGSFusion": HGSFusionModel,
    "CaDDN": HGSFusionModel,
    "RadarOnly": RadarOnlyModel,
    "PillarNet": RadarOnlyModel,
    "PointPillar": PointPillarModel,
    "BevFusion": BEVFusionModel,
    "BEVFusion": BEVFusionModel,
    "TransFusion": TransFusionModel,
    "CenterPoint": CenterPointModel,
    "SECONDNet": SECONDModel,
    "SECOND": SECONDModel,
    "SECONDNetIoU": SECONDIoUModel,
    "VoxelRCNN": VoxelRCNNModel,
    "PVRCNN": PVRCNNModel,
    "PV-RCNN": PVRCNNModel,
    "PVRCNNPlusPlus": PVRCNNPlusPlusModel,
    "PV-RCNN++": PVRCNNPlusPlusModel,
    "PartA2Net": PartA2Model,
    "PartA2": PartA2Model,
    "VoxelNeXt": VoxelNeXtModel,
}


def network_class(name: str, multihead: bool = False):
    """The detector class of a ``MODEL.NAME`` (``multihead``: its
    ``DENSE_HEAD.NAME`` is AnchorHeadMulti)."""
    if name in ("PointPillar", "PointPillarMultiHead") and multihead:
        return PointPillarMultiHeadModel
    if name not in DETECTORS:
        raise NotImplementedError(
            f"MODEL.NAME: {name} is not ported (ROADMAP.md queue 1 item 9 (c7)-(c9), the "
            f"inherited zoo's PointRCNN, DSVT and MPPNet); the port builds "
            f"{sorted(DETECTORS)}")
    return DETECTORS[name]


def yaml_network_class(cfg: dict):
    """The detector class of a loaded YAML config."""
    head = (cfg["MODEL"].get("DENSE_HEAD") or {}).get("NAME")
    return network_class(cfg["MODEL"]["NAME"], head == "AnchorHeadMulti")


def build_network(cfg, model_cfg=None, device="cuda", seed: int = 0):
    """The detector on ``device`` with weights from ``seed``. ``cfg``: a
    loaded YAML config (``model_cfg``, its ``model_config_from_yaml``, is
    read here when not given), or a ``MODEL.NAME`` with ``model_cfg`` (a
    preset; its ``rpn_head_cfgs`` say whether the head is AnchorHeadMulti)."""
    if isinstance(cfg, str):
        if model_cfg is None:
            raise ValueError("build_network by MODEL.NAME needs model_cfg")
        return network_class(cfg, bool(model_cfg.rpn_head_cfgs))(model_cfg, device=device,
                                                                 seed=seed)
    if model_cfg is None:
        model_cfg = model_config_from_yaml(cfg)
    return yaml_network_class(cfg)(model_cfg, device=device, seed=seed)
