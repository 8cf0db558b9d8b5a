"""Static model configuration and the YAML loader.

``HGSFusionConfig`` carries the fields of the JAX package's
``models/detector.py::HGSFusionConfig`` that the ported serving and training
paths read, with the same names and defaults, plus what the JAX package
reads from the YAML beside it: the anchor generator with the target
assigner's thresholds, the loss weights, the post-processing values and the
OPTIMIZATION block. ``load_config`` and
``model_config_from_yaml`` read the repo's reference-schema YAMLs as the JAX
package's ``config.py`` does; ``vod_pallas_config`` and ``vod_polar_config``
are the flagship presets (``configs/hgsfusion_vod_pallas.yaml`` and
``configs/hgsfusion_vod_polar.yaml``, bf16) in plain Python, so serving needs
no YAML parser.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Tuple

import torch

_VOD_ANCHORS = (
    {"class_name": "Car", "anchor_sizes": ((3.9, 1.6, 1.56),),
     "anchor_rotations": (0.0, 1.57), "anchor_bottom_heights": (-1.78,),
     "align_center": False, "feature_map_stride": 1,
     "matched_threshold": 0.6, "unmatched_threshold": 0.45},
    {"class_name": "Pedestrian", "anchor_sizes": ((0.8, 0.6, 1.73),),
     "anchor_rotations": (0.0, 1.57), "anchor_bottom_heights": (-0.6,),
     "align_center": False, "feature_map_stride": 1,
     "matched_threshold": 0.5, "unmatched_threshold": 0.35},
    {"class_name": "Cyclist", "anchor_sizes": ((1.76, 0.6, 1.73),),
     "anchor_rotations": (0.0, 1.57), "anchor_bottom_heights": (-0.6,),
     "align_center": False, "feature_map_stride": 1,
     "matched_threshold": 0.5, "unmatched_threshold": 0.35},
)
# DENSE_HEAD.LOSS_CONFIG.LOSS_WEIGHTS and OPTIMIZATION of configs/hgsfusion_vod.yaml
_VOD_LOSS_WEIGHTS = {"cls_weight": 1.0, "loc_weight": 2.0, "dir_weight": 0.2,
                     "code_weights": (1.0,) * 7}
_VOD_OPTIMIZATION = {
    "BATCH_SIZE_PER_DEVICE": 1, "NUM_EPOCHS": 25, "OPTIMIZER": "adam_onecycle",
    "LR": 0.001, "WEIGHT_DECAY": 0.01, "MOMENTUM": 0.9, "MOMS": (0.95, 0.85),
    "PCT_START": 0.4, "DIV_FACTOR": 10, "DECAY_STEP_LIST": (35, 45), "LR_DECAY": 0.1,
    "LR_CLIP": 1e-07, "LR_WARMUP": False, "WARMUP_EPOCH": 1, "GRAD_NORM_CLIP": 10,
}


def _frozen(v):
    """YAML lists as tuples, so configs compare and print alike."""
    if isinstance(v, dict):
        return {k: _frozen(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return tuple(_frozen(x) for x in v)
    return v


@dataclasses.dataclass(frozen=True)
class HGSFusionConfig:
    class_names: Tuple[str, ...] = ("Car", "Pedestrian", "Cyclist")
    pc_range: Tuple[float, ...] = (0.0, -25.6, -3.0, 51.2, 25.6, 2.0)
    voxel_size: Tuple[float, ...] = (0.16, 0.16, 0.16)
    # image branch
    image_backbone: str = "ResNet101"
    ddn_quant: str = "none"
    channel_reduce_out: int = 64
    f2v_out_channels: int = 128
    f2v_quant: str = "none"
    f2v_sampler_kernel: str = "xla"
    f2v_view: str = "gather"
    f2v_polar_zeta_bins: int = 128
    f2v_polar_near_columns: int = 20
    disc_mode: str = "LID"
    disc_num_bins: int = 80
    disc_depth_min: float = 1.0
    disc_depth_max: float = 51.2
    bev_aug: bool = True
    image_size: Tuple[int, int] = (516, 1936)
    use_depth: bool = False
    # radar branch
    num_point_features: int = 17
    reader_num_input: int = 29
    backbone_out_indices: Tuple[int, ...] = (0, 1, 2)
    neck_out_channels: Tuple[int, ...] = (128, 128)
    # occupancy / fusion
    radar_input_channels: int = 128
    aspp_dilation: int = 6
    use_aspp: bool = True
    aspp_dilations: tuple | None = None
    use_dcn: tuple | None = None
    occ_use_mask: bool = False
    occ_fuse_mode: str = "MUL"
    fusion_image_out: int = 128
    fusion_radar_out: int = 128
    # head
    num_anchors_per_location: int = 6
    num_dir_bins: int = 2
    dir_offset: float = 0.78539
    dir_limit_offset: float = 0.0
    code_size: int = 7
    compute_dtype: str = "float32"
    # port-only: DENSE_HEAD.ANCHOR_GENERATOR_CONFIG (with the target
    # assigner's thresholds), LOSS_WEIGHTS, POST_PROCESSING and OPTIMIZATION
    anchor_generator: Tuple[Dict[str, Any], ...] = _VOD_ANCHORS
    loss_weights: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: dict(_VOD_LOSS_WEIGHTS))
    score_thresh: float = 0.1
    nms_thresh: float = 0.01
    nms_pre_max_size: int = 4096
    nms_post_max_size: int = 500
    optimization: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: dict(_VOD_OPTIMIZATION))

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        return tuple(
            int(round((self.pc_range[3 + i] - self.pc_range[i]) / self.voxel_size[i]))
            for i in range(3))

    @property
    def num_class(self) -> int:
        return len(self.class_names)

    @property
    def dtype(self):
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    @property
    def disc_cfg(self) -> Dict[str, Any]:
        return dict(mode=self.disc_mode, depth_min=self.disc_depth_min,
                    depth_max=self.disc_depth_max, num_bins=self.disc_num_bins)


def vod_pallas_config() -> HGSFusionConfig:
    """``configs/hgsfusion_vod_pallas.yaml`` in bf16, as the JAX package's
    flagship entry builds it."""
    return HGSFusionConfig(
        pc_range=(0.0, -25.6, -3.0, 51.2, 25.6, 2.0),
        voxel_size=(0.16, 0.16, 0.16),
        image_backbone="ResNet101",
        f2v_sampler_kernel="pallas",
        bev_aug=True,
        image_size=(516, 1936),
        num_point_features=17,
        reader_num_input=29,
        use_aspp=True,
        aspp_dilation=6,
        compute_dtype="bfloat16",
    )


def vod_polar_config() -> HGSFusionConfig:
    """``configs/hgsfusion_vod_polar.yaml`` (bf16 by its base config): the
    JAX package's serving default, the polar view transform."""
    return HGSFusionConfig(
        pc_range=(0.0, -25.6, -3.0, 51.2, 25.6, 2.0),
        voxel_size=(0.16, 0.16, 0.16),
        image_backbone="ResNet101",
        f2v_view="polar",
        f2v_polar_zeta_bins=128,
        f2v_polar_near_columns=20,
        bev_aug=True,
        image_size=(516, 1936),
        num_point_features=17,
        reader_num_input=29,
        use_aspp=True,
        aspp_dilation=6,
        compute_dtype="bfloat16",
    )


def _merge(base: dict, new: dict) -> dict:
    out = dict(base)
    for k, v in new.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path, root_dir=None) -> dict:
    """Load a YAML config, resolving ``_BASE_CONFIG_`` inheritance. Base
    paths resolve against ``root_dir`` (default: the repo root) first, then
    against the config's own directory."""
    import yaml

    path = Path(path)
    if root_dir is None:
        root_dir = Path(__file__).resolve().parent.parent
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}

    def resolve(node, cfg_dir):
        if not isinstance(node, dict):
            return node
        base_rel = node.pop("_BASE_CONFIG_", None)
        node = {k: resolve(v, cfg_dir) for k, v in node.items()}
        if base_rel is not None:
            cand = Path(root_dir) / base_rel
            if not cand.exists():
                cand = cfg_dir / base_rel
            node = _merge(load_config(cand, root_dir=root_dir), node)
        return node

    out = resolve(cfg, path.parent)
    out["TAG"] = path.stem
    return out


def model_config_from_yaml(cfg: dict) -> HGSFusionConfig:
    """HGSFusionConfig from a loaded reference-schema YAML (HGSFusion with an
    AnchorHeadSingle)."""
    model, data = cfg["MODEL"], cfg["DATA_CONFIG"]
    fusion_vfe = model["FusionVFE"]
    image_vfe = fusion_vfe["ImageVFE"]
    radar = fusion_vfe["RadarBackbone"]
    occ = fusion_vfe["RadarOccupancy"]
    fuse = model["FUSION_AFTER_BEV"]
    head = model["DENSE_HEAD"]
    ffn = image_vfe["FFN"]
    f2v = image_vfe["F2V"]
    disc = ffn.get("DISCRETIZE", {"mode": "LID", "num_bins": 80,
                                  "depth_min": 1.0, "depth_max": 51.2})
    voxel_size = next(p["VOXEL_SIZE"] for p in data["DATA_PROCESSOR"]
                      if p["NAME"] == "calculate_grid_size")
    anchors = tuple(
        {"class_name": c["class_name"],
         "anchor_sizes": tuple(tuple(float(v) for v in s) for s in c["anchor_sizes"]),
         "anchor_rotations": tuple(float(r) for r in c["anchor_rotations"]),
         "anchor_bottom_heights": tuple(float(h) for h in c["anchor_bottom_heights"]),
         "align_center": c.get("align_center", False),
         "feature_map_stride": c.get("feature_map_stride", 1),
         "matched_threshold": float(c["matched_threshold"]),
         "unmatched_threshold": float(c["unmatched_threshold"])}
        for c in head["ANCHOR_GENERATOR_CONFIG"])
    nms = model.get("POST_PROCESSING", {}).get("NMS_CONFIG", {})
    return HGSFusionConfig(
        class_names=tuple(cfg["CLASS_NAMES"]),
        pc_range=tuple(data["POINT_CLOUD_RANGE"]),
        voxel_size=tuple(voxel_size),
        image_backbone=ffn.get("DDN", {}).get("BACKBONE_NAME", "ResNet101"),
        ddn_quant=ffn.get("DDN", {}).get("QUANT", "none"),
        channel_reduce_out=ffn.get("CHANNEL_REDUCE", {}).get("out_channels", 64),
        f2v_out_channels=f2v.get("OUT_CHANNELS", 128),
        f2v_quant=f2v.get("QUANT", "none"),
        f2v_sampler_kernel=f2v.get("SAMPLER_KERNEL", "xla"),
        f2v_view=f2v.get("VIEW", "gather"),
        f2v_polar_zeta_bins=f2v.get("POLAR_ZETA_BINS", 128),
        f2v_polar_near_columns=f2v.get("POLAR_NEAR_COLUMNS", 20),
        disc_mode=disc["mode"],
        disc_num_bins=disc["num_bins"],
        disc_depth_min=disc["depth_min"],
        disc_depth_max=disc["depth_max"],
        bev_aug=f2v.get("BEV_AUG", False),
        image_size=tuple(data.get("IMAGE_SIZE", (516, 1936))),
        use_depth=image_vfe.get("USE_DEPTH", True),
        num_point_features=len(data["POINT_FEATURE_ENCODING"]["used_feature_list"]),
        reader_num_input=radar.get("READER", {}).get("NUM_INPUT_FEATURES", 29),
        backbone_out_indices=tuple(radar.get("BACKBONE", {}).get("OUT_INDICES", (0, 1, 2))),
        neck_out_channels=tuple(radar.get("NECK", {}).get("OUT_CHANNELS", (128, 128))),
        radar_input_channels=occ.get("RADAR_INPUT_CHANNELS", 128),
        aspp_dilation=occ.get("ASPP_SHAPE", 6),
        use_aspp=occ.get("USE_ASPP", False),
        aspp_dilations=tuple(occ["ASPP_DIAL"]) if occ.get("ASPP_DIAL") else None,
        use_dcn=tuple(occ["USE_DCN"]) if occ.get("USE_DCN") else None,
        occ_use_mask=occ.get("USE_MASK", False),
        occ_fuse_mode=occ.get("FUSE_MODE", "MUL"),
        fusion_image_out=fuse.get("IMAGE_OUT_CHANNELS", 128),
        fusion_radar_out=fuse.get("RADAR_OUT_CHANNELS", 128),
        num_anchors_per_location=sum(
            len(c["anchor_rotations"]) * len(c["anchor_sizes"]) * len(c["anchor_bottom_heights"])
            for c in head["ANCHOR_GENERATOR_CONFIG"]),
        num_dir_bins=head.get("NUM_DIR_BINS", 2),
        dir_offset=head.get("DIR_OFFSET", 0.78539),
        dir_limit_offset=head.get("DIR_LIMIT_OFFSET", 0.0),
        compute_dtype=model.get("COMPUTE_DTYPE", "float32"),
        anchor_generator=anchors,
        loss_weights=_frozen(head["LOSS_CONFIG"]["LOSS_WEIGHTS"]),
        optimization=_frozen(cfg["OPTIMIZATION"]),
        score_thresh=model.get("POST_PROCESSING", {}).get("SCORE_THRESH", 0.1),
        nms_thresh=nms.get("NMS_THRESH", 0.01),
        nms_pre_max_size=nms.get("NMS_PRE_MAXSIZE", 4096),
        nms_post_max_size=nms.get("NMS_POST_MAXSIZE", 500),
    )
