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
no YAML parser; ``vod_dataset_config`` is their data, class and
post-processing blocks, for the evaluation loop. ``cfg_from_list`` applies
the CLIs' ``--set`` overrides.
"""
from __future__ import annotations

import ast
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


# the CenterHead branches' default widths (SEPARATE_HEAD_CFG.HEAD_DICT)
_DEFAULT_CENTER_CHANNELS = {"center": 2, "center_z": 1, "dim": 3, "rot": 2, "vel": 2, "iou": 1}
# BACKBONE_3D.NAME -> backbone_3d_arch (any other name, or none: "voxel8x")
_BACKBONE_3D_ARCH = {"VoxelBackBone8xFocal": "voxel8x_focal", "PillarBackBone8x": "pillar_8x",
                     "PillarRes18BackBone8x": "pillar_res2d_8x",
                     "VoxelResBackBone8xVoxelNeXt2D": "voxelnext2d"}


def _center_head_layout(head: dict):
    """(HEAD_ORDER, each branch's out_channels) of a CenterHead block, with
    the defaults where SEPARATE_HEAD_CFG leaves them out."""
    sep = head.get("SEPARATE_HEAD_CFG", {})
    order = tuple(sep.get("HEAD_ORDER", ("center", "center_z", "dim", "rot")))
    head_dict = sep.get("HEAD_DICT", {})
    return order, tuple(head_dict.get(k, {}).get("out_channels",
                                                 _DEFAULT_CENTER_CHANNELS.get(k, 2))
                        for k in order)


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
    # AnchorHeadMulti (the grouped multi-head head): the class groups, the
    # anchors per location of each class, the shared and separate convs,
    # and the box coder of TARGET_ASSIGNER_CONFIG.BOX_CODER_CONFIG
    rpn_head_cfgs: tuple | None = None
    mh_num_per_loc: Tuple[int, ...] = ()
    mh_shared_conv_filters: int = 64
    mh_separate_reg_list: Tuple[str, ...] = ("reg:2", "height:1", "size:3", "angle:2", "velo:2")
    mh_num_middle_conv: int = 1
    mh_num_middle_filter: int = 64
    mh_separate_multihead: bool = True
    mh_use_dir: bool = False
    box_coder_size: int = 7
    box_coder_sincos: bool = False
    # the BEVFusion camera branch (IMAGE_BACKBONE / NECK): "swin" (Swin +
    # GeneralizedLSSFPN) or "ddn" (the ResNet-DeepLab DDN)
    image_backbone_arch: str = "ddn"
    swin_embed_dims: int = 96
    swin_depths: Tuple[int, ...] = (2, 2, 6, 2)
    swin_num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    swin_window_size: int = 7
    swin_mlp_ratio: int = 4
    swin_out_indices: Tuple[int, ...] = (1, 2, 3)
    swin_drop_path: float = 0.2
    swin_patch_size: int = 4
    fpn_out_channels: int = 256
    # anchor-free heads (TransFusion): the target map's stride, the proposals
    # (MAX_OBJ_PER_SAMPLE), the heatmap gaussians, the box-center limits, and
    # the classes exempt from peak pooling (TARGET_ASSIGNER_CONFIG.DATASET:
    # nuScenes 8, 9; Waymo 1, 2; any other dataset none)
    center_feature_map_stride: int = 2
    center_max_k: int = 500
    tf_no_pool_classes: Tuple[int, ...] = ()
    center_gaussian_overlap: float = 0.1
    center_min_radius: int = 2
    center_post_limit: Tuple[float, ...] = (-75.0, -75.0, -10.0, 75.0, 75.0, 10.0)
    # the CenterHead's regression branches (SEPARATE_HEAD_CFG.HEAD_ORDER and
    # their out_channels; ``vel`` adds 2)
    center_head_order: Tuple[str, ...] = ("center", "center_z", "dim", "rot")
    center_head_channels: Tuple[int, ...] = (2, 1, 3, 2)
    # BACKBONE_3D.NAME: "voxel8x" (VoxelBackBone8x, or none), "voxel8x_focal",
    # "pillar_8x", "pillar_res2d_8x", "voxelnext2d"; and BaseBEVBackboneV1's
    # BACKBONE_2D
    backbone_3d_arch: str = "voxel8x"
    # VoxelBackBone8xFocal's foreground rule (BACKBONE_3D.TOPK, THRESHOLD,
    # MASK_MULTI, SKIP_MASK_KERNEL)
    focal_topk: bool = True
    focal_threshold: float = 0.5
    focal_mask_multi: bool = False
    focal_skip_mask_kernel: bool = False
    # the two-stage families: PV-RCNN's keypoints (PFE.NUM_KEYPOINTS),
    # proposals kept (ROI_HEAD.NUM_ROIS) and their NMS (NMS_THRESH_TRAIN);
    # SECOND-IoU's BEV grid (GRID_SIZE_2D) and NMS score
    # (POST_PROCESSING.SCORE_TYPE). ROI_HEAD.AGGREGATION is not read, as in
    # JAX: the family (PV-RCNN or PV-RCNN++) fixes it
    pv_num_keypoints: int = 1024
    pv_num_rois: int = 128
    pv_nms_thresh: float = 0.8
    iou_grid_size: int = 7
    iou_score_type: str = "iou"
    # Part-A2's RoI-aware pool (ROI_HEAD.POOL_SIZE; the reference pools at
    # 12). ROI_AWARE_POOL is not read, nor its MAX_POINTS_PER_VOXEL cap, as in JAX
    parta2_pool_size: int = 6
    bev_v1_layer_nums: Tuple[int, ...] = (5, 5)
    bev_v1_num_filters: Tuple[int, ...] = (256, 256)
    bev_v1_upsample_strides: Tuple[int, ...] = (1, 2)
    bev_v1_num_upsample_filters: Tuple[int, ...] = (128, 128)
    compute_dtype: str = "float32"
    # recompute the gather f2v's sample + reduce product and the polar view's
    # pass 2 in the backward pass instead of keeping what they save
    remat: bool = True
    # port-only: DENSE_HEAD.ANCHOR_GENERATOR_CONFIG (with the target
    # assigner's thresholds), LOSS_WEIGHTS, POST_PROCESSING and OPTIMIZATION
    anchor_generator: Tuple[Dict[str, Any], ...] = _VOD_ANCHORS
    loss_weights: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: dict(_VOD_LOSS_WEIGHTS))
    score_thresh: float = 0.1
    nms_thresh: float = 0.01
    nms_pre_max_size: int = 4096
    nms_post_max_size: int = 500
    # NMS_CONFIG.NMS_TYPE; None where POST_PROCESSING has no NMS_CONFIG (a
    # CenterHead then keeps its raw decode)
    nms_type: str | None = "nms_gpu"
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


_VOD_FEATURES = (["x", "y", "z", "rcs", "v_r", "v_r_comp", "time"]
                 + [f"label{i}" for i in range(1, 9)] + ["idf1", "idf2"])


def vod_dataset_config(data_path) -> dict:
    """``CLASS_NAMES``, ``DATA_CONFIG`` and ``MODEL.POST_PROCESSING`` of
    ``configs/hgsfusion_vod.yaml`` (its ``dataset_configs/vod_fusion.yaml``
    base merged with its overrides) in plain Python, as ``load_config``
    returns them, with ``DATA_PATH`` set to ``data_path``: the evaluation
    loop's configuration without a YAML parser."""
    return {
        "CLASS_NAMES": ["Car", "Pedestrian", "Cyclist"],
        "DATA_CONFIG": {
            "DATASET": "VODDataset",
            "DATA_PATH": str(data_path),
            "POINT_CLOUD_RANGE": [0, -25.6, -3, 51.2, 25.6, 2],
            "DATA_SPLIT": {"train": "train", "test": "val"},
            "INFO_PATH": {"train": ["kitti_infos_train.pkl"],
                          "test": ["kitti_infos_val.pkl"]},
            "GET_ITEM_LIST": ["points", "images", "calib_matricies", "gt_boxes2d"],
            "FOV_POINTS_ONLY": True,
            "MAX_POINTS": 16384,
            "MAX_GT_BOXES": 64,
            "IMAGE_SIZE": [516, 1936],
            "POINT_FEATURE_ENCODING": {"encoding_type": "absolute_coordinates_encoding",
                                       "used_feature_list": list(_VOD_FEATURES),
                                       "src_feature_list": list(_VOD_FEATURES)},
            "DATA_PROCESSOR": [
                {"NAME": "mask_points_and_boxes_outside_range", "REMOVE_OUTSIDE_BOXES": True},
                {"NAME": "calculate_grid_size", "VOXEL_SIZE": [0.16, 0.16, 0.16]},
                {"NAME": "shuffle_points", "SHUFFLE_ENABLED": {"train": True, "test": False}},
            ],
            "DATA_AUGMENTOR": {
                "DISABLE_AUG_LIST": ["gt_sampling"],
                "AUG_CONFIG_LIST": [
                    {"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x"]},
                    {"NAME": "random_image_flip_fusion", "ALONG_AXIS_LIST": ["horizontal"]},
                    {"NAME": "random_world_rotation", "WORLD_ROT_ANGLE": [-0.3926, 0.3926]},
                    {"NAME": "random_world_scaling", "WORLD_SCALE_RANGE": [0.95, 1.05]},
                ],
            },
            "USE_VIRTUAL_POINTS": True,
            "VIRTUAL_POINT_PREFIX": "mask_maskformer_with_label_k_1_gauss_k_4_uniform",
        },
        "MODEL": {"POST_PROCESSING": {
            "RECALL_THRESH_LIST": [0.3, 0.5, 0.7],
            "SCORE_THRESH": 0.1,
            "OUTPUT_RAW_SCORE": False,
            "EVAL_METRIC": "kitti",
            "NMS_CONFIG": {"MULTI_CLASSES_NMS": False, "NMS_TYPE": "nms_gpu",
                           "NMS_THRESH": 0.01, "NMS_PRE_MAXSIZE": 4096,
                           "NMS_POST_MAXSIZE": 500},
        }},
    }


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


def cfg_from_list(cfg: dict, kv_list) -> dict:
    """Apply ``KEY.SUBKEY value`` overrides (the CLIs' ``--set``) in place,
    each value read as a Python literal where it parses as one and cast to
    the type of the scalar it replaces."""
    if len(kv_list) % 2:
        raise ValueError("--set takes key/value pairs")
    for key, value in zip(kv_list[0::2], kv_list[1::2]):
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
        *parents, leaf = key.split(".")
        node = cfg
        for p in parents:
            node = node.setdefault(p, {})
        old = node.get(leaf)
        if old is not None and not isinstance(old, (dict, list)) and not isinstance(value, type(old)):
            value = type(old)(value)
        node[leaf] = value
    return cfg


def model_config_from_yaml(cfg: dict) -> HGSFusionConfig:
    """HGSFusionConfig from a loaded reference-schema YAML: the HGSFusion,
    radar-only, PointPillar, BEVFusion, TransFusion-L, CenterPoint, SECOND
    (and its focal backbone), SECOND-IoU, Voxel R-CNN and VoxelNeXt
    families, with an AnchorHeadSingle, an AnchorHeadMulti or the
    anchor-free TransFusionHead or CenterHead (its static fields as the JAX
    package reads them)."""
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
    anchor_cfgs = head.get("ANCHOR_GENERATOR_CONFIG", ())  # none: anchor-free
    anchors = tuple(
        {"class_name": c["class_name"],
         "anchor_sizes": tuple(tuple(float(v) for v in s) for s in c["anchor_sizes"]),
         "anchor_rotations": tuple(float(r) for r in c["anchor_rotations"]),
         "anchor_bottom_heights": tuple(float(h) for h in c["anchor_bottom_heights"]),
         "align_center": c.get("align_center", False),
         "feature_map_stride": c.get("feature_map_stride", 1),
         "matched_threshold": float(c["matched_threshold"]),
         "unmatched_threshold": float(c["unmatched_threshold"])}
        for c in anchor_cfgs)
    nms = model.get("POST_PROCESSING", {}).get("NMS_CONFIG", {})
    coder = head.get("TARGET_ASSIGNER_CONFIG", {}).get("BOX_CODER_CONFIG", {})
    sep_reg = head.get("SEPARATE_REG_CONFIG", {})
    multihead = head.get("NAME") == "AnchorHeadMulti"
    per_loc = tuple(
        len(c["anchor_rotations"]) * len(c["anchor_sizes"]) * len(c["anchor_bottom_heights"])
        for c in anchor_cfgs)
    tgt = head.get("TARGET_ASSIGNER_CONFIG", {})
    post = model.get("POST_PROCESSING", {})
    image_backbone = model.get("IMAGE_BACKBONE", {})
    backbone_2d = model.get("BACKBONE_2D", {})
    head_order, head_channels = _center_head_layout(head)
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
        num_anchors_per_location=sum(per_loc),
        rpn_head_cfgs=(tuple(tuple(h["HEAD_CLS_NAME"]) for h in head["RPN_HEAD_CFGS"])
                       if multihead else None),
        mh_num_per_loc=per_loc if multihead else (),
        mh_shared_conv_filters=head.get("SHARED_CONV_NUM_FILTER", 64),
        mh_separate_reg_list=tuple(sep_reg.get(
            "REG_LIST", ("reg:2", "height:1", "size:3", "angle:2", "velo:2"))),
        mh_num_middle_conv=sep_reg.get("NUM_MIDDLE_CONV", 1),
        mh_num_middle_filter=sep_reg.get("NUM_MIDDLE_FILTER", 64),
        mh_separate_multihead=head.get("SEPARATE_MULTIHEAD", True),
        # the reference emits direction predictions (and applies the
        # direction loss) only where USE_DIRECTION_CLASSIFIER is true
        mh_use_dir=bool(head.get("USE_DIRECTION_CLASSIFIER", False)) if multihead else False,
        box_coder_size=coder.get("code_size", 7),
        box_coder_sincos=coder.get("encode_angle_by_sincos", False),
        num_dir_bins=head.get("NUM_DIR_BINS", 2),
        dir_offset=head.get("DIR_OFFSET", 0.78539),
        dir_limit_offset=head.get("DIR_LIMIT_OFFSET", 0.0),
        image_backbone_arch="swin" if image_backbone.get("NAME") == "SwinTransformer" else "ddn",
        swin_embed_dims=image_backbone.get("EMBED_DIMS", 96),
        swin_depths=tuple(image_backbone.get("DEPTHS", (2, 2, 6, 2))),
        swin_num_heads=tuple(image_backbone.get("NUM_HEADS", (3, 6, 12, 24))),
        swin_window_size=image_backbone.get("WINDOW_SIZE", 7),
        swin_mlp_ratio=image_backbone.get("MLP_RATIO", 4),
        swin_out_indices=tuple(image_backbone.get("OUT_INDICES", (1, 2, 3))),
        swin_drop_path=image_backbone.get("DROP_PATH_RATE", 0.2),
        swin_patch_size=image_backbone.get("PATCH_SIZE", 4),
        fpn_out_channels=model.get("NECK", {}).get("OUT_CHANNELS", 256),
        center_feature_map_stride=tgt.get("FEATURE_MAP_STRIDE", 2),
        center_max_k=post.get("MAX_OBJ_PER_SAMPLE", 500),
        tf_no_pool_classes={"nuScenes": (8, 9), "Waymo": (1, 2)}.get(tgt.get("DATASET", ""), ()),
        center_gaussian_overlap=tgt.get("GAUSSIAN_OVERLAP", 0.1),
        center_min_radius=tgt.get("MIN_RADIUS", 2),
        center_post_limit=tuple(post.get("POST_CENTER_LIMIT_RANGE",
                                         (-75.0, -75.0, -10.0, 75.0, 75.0, 10.0))),
        center_head_order=head_order,
        center_head_channels=head_channels,
        backbone_3d_arch=_BACKBONE_3D_ARCH.get(model.get("BACKBONE_3D", {}).get("NAME"),
                                               "voxel8x"),
        focal_topk=model.get("BACKBONE_3D", {}).get("TOPK", True),
        focal_threshold=model.get("BACKBONE_3D", {}).get("THRESHOLD", 0.5),
        focal_mask_multi=model.get("BACKBONE_3D", {}).get("MASK_MULTI", False),
        focal_skip_mask_kernel=model.get("BACKBONE_3D", {}).get("SKIP_MASK_KERNEL", False),
        pv_num_keypoints=model.get("PFE", {}).get("NUM_KEYPOINTS", 1024),
        pv_num_rois=model.get("ROI_HEAD", {}).get("NUM_ROIS", 128),
        pv_nms_thresh=model.get("ROI_HEAD", {}).get("NMS_THRESH_TRAIN", 0.8),
        iou_grid_size=model.get("ROI_HEAD", {}).get("GRID_SIZE_2D", 7),
        iou_score_type=post.get("SCORE_TYPE", "iou"),
        parta2_pool_size=model.get("ROI_HEAD", {}).get("POOL_SIZE", 6),
        bev_v1_layer_nums=tuple(backbone_2d.get("LAYER_NUMS", (5, 5))),
        bev_v1_num_filters=tuple(backbone_2d.get("NUM_FILTERS", (256, 256))),
        bev_v1_upsample_strides=tuple(backbone_2d.get("UPSAMPLE_STRIDES", (1, 2))),
        bev_v1_num_upsample_filters=tuple(backbone_2d.get("NUM_UPSAMPLE_FILTERS", (128, 128))),
        compute_dtype=model.get("COMPUTE_DTYPE", "float32"),
        remat=model.get("REMAT", True),
        anchor_generator=anchors,
        loss_weights=_frozen(head["LOSS_CONFIG"]["LOSS_WEIGHTS"]),
        optimization=_frozen(cfg["OPTIMIZATION"]),
        score_thresh=model.get("POST_PROCESSING", {}).get("SCORE_THRESH", 0.1),
        nms_thresh=nms.get("NMS_THRESH", 0.01),
        nms_pre_max_size=nms.get("NMS_PRE_MAXSIZE", 4096),
        nms_post_max_size=nms.get("NMS_POST_MAXSIZE", 500),
        nms_type=nms.get("NMS_TYPE", "nms_gpu") if nms else None,
    )
