"""Detectors: HGSFusion (camera + radar branches, DSM fusion, anchor head),
the radar-only detector, the PointPillar families, BEVFusion,
TransFusion-L, CenterPoint, SECOND (and the focal SECOND), SECOND-IoU,
Voxel R-CNN, PV-RCNN, PV-RCNN++, Part-A2 and VoxelNeXt; post-processing.

Counterpart of ``hgsfusion_tpu/models/detector.py`` (HGSFusionModel with
``f2v_view="gather"`` under either ``f2v_sampler_kernel``, or
``f2v_view="polar"``; RadarOnlyModel, PointPillarModel,
PointPillarMultiHeadModel, BEVFusionModel, TransFusionModel,
CenterPointModel, SECONDModel, _RPNProposals, VoxelRCNNModel,
SECONDIoUModel, PVRCNNModel, PVRCNNPlusPlusModel, PartA2Model, VoxelNeXtModel;
post_process, post_process_multihead)
and of the JAX package's ``train/trainer.py::make_center_eval_step``
(``center_post_process``), ``make_pvrcnn_eval_step``
(``refine_post_process``) and ``make_secondiou_eval_step``
(``rectified_post_process``).
``models/registry.py::build_network`` picks the family of a config.

  images --ResNet-DeepLab--> 4 taps --1x1 reduce--> frustum sample -> voxel
    --collapse--> image BEV   (gather view)
                           --> polar resample + collapse + one sample per
    BEV cell --> image BEV    (polar view, ``polar_f2v.py``)
  points --pillar encode--> masked ResNet-18 BEV encoder --FPN--> radar BEV
  image BEV x occupancy(radar BEV) -> concat+SE -> anchor head -> NMS

The module tree carries the reference pcdet names (``fusion_vfe.image_vfe.
ffn.ddn.model.backbone...``, ``dense_head.conv_cls``, ...), so
``state_dict()`` speaks the reference checkpoint's keys. In eval mode (the
default, and ``serve``) every BatchNorm uses its running statistics; in train
mode every BatchNorm, the frozen backbone's included, normalizes with batch
statistics and updates its running ones, as the JAX model under
``train=True``. The backbone runs without autograd: nothing upstream of the
trainable channel reduces and the depth classifier trains, so autograd keeps
nothing inside it, and ``REMAT`` (``jax.checkpoint`` of the backbone in the
JAX package) has nothing to recompute there.

``DDN.QUANT: w8a8`` runs every convolution of the frozen backbone as int8
(``resnet.py``, ``ops/conv_int8.py``) in eval mode and raises in train
mode, as the JAX model does; ``F2V.QUANT: int8`` quantizes the gather
view's sampled maps (``frustum.py``). The polar view refuses the latter only.

With ``USE_DEPTH`` (gather view only) a DeepLabV3 head
(``ffn.ddn.model.classifier``, trainable) classifies depth on layer4; its
logits, resized to layer1's resolution, are ``preds["depth_logits"]``, and
their softmax over the D + 1 bins, without the overflow bin, at each
distinct map size weights the frustum sample (``frustum.py``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from ..config import HGSFusionConfig
from ..ops.deform_conv import ModulatedDeformConv2d
from ..ops.nms import NEG_INF, class_agnostic_nms, kept_slots, multi_set_nms, top_scores
from ..utils.box_coder import ResidualCoder
from .anchor_head import (AnchorHeadMulti, AnchorHeadSingle, decode_selected_boxes,
                          generate_predicted_boxes_multihead)
from .anchors import TargetAssigner, flatten_anchors, generate_anchors
from .base_bev_backbone import BaseBEVBackbone
from .bev_encoder import PillarNetRadar, SparseConv2d
from .center_head import CenterHead, decode_center_boxes
from .focal_conv import VoxelBackBone8xFocal
from .frustum import FrustumGridGenerator, FrustumToVoxelMultiScale
from .fusion_bev import FusionAfterBEVSE
from .layers import ConvBNReLU, batch_norm, compute_dtype, conv_nhwc, resize_bilinear
from .occupancy import Conv2DCollapse, RadarOccupancy2D, bias_init_with_prob
from .parta2 import PartA2RoIHead, PointPartHead, UNetDecoder, gather_point_voxel_features
from .pillar_encoder import PillarFeatureNet
from .polar_f2v import PolarF2V, polar_image_bev
from .pvrcnn import (KeypointWeighting, RCNNHead, RoIGridPool, VoxelSetAbstraction,
                     decode_canonical, generate_proposals)
from .resnet import DeepLabClassifier, ResNetDeepLabBackbone, preprocess_images
from .roi_heads import SECONDIoUHead, VoxelRCNNPool, rectified_scores, rotated_bev_grid_pool
from .sparse_backbone_2d import BaseBEVBackboneV1, PillarRes18BackBone8x, VoxelNeXt2DBackbone
from .swin import GeneralizedLSSFPN, SwinTransformer
from .transfusion_head import MultiheadAttention, TransFusionHead, transfusion_get_boxes
from .voxel_backbone import (SparseConv3d, VoxelBackBone8x, VoxelResBackBone8xVoxelNeXt,
                             height_compression, mean_vfe)

__all__ = ["HGSFusionConfig", "HGSFusionModel", "RadarOnlyModel", "PointPillarModel",
           "PointPillarMultiHeadModel", "BEVFusionModel", "TransFusionModel", "CenterPointModel",
           "SECONDModel", "VoxelRCNNModel", "SECONDIoUModel", "PVRCNNModel",
           "PVRCNNPlusPlusModel", "PartA2Model", "VoxelNeXtModel", "post_process",
           "post_process_multihead", "center_post_process", "refine_post_process",
           "rectified_post_process", "resolve_device"]

# the batch keys the model and its losses read; TARGET_KEYS only the losses
BATCH_KEYS = ("points", "points_valid", "images", "trans_lidar_to_cam",
              "trans_cam_to_img", "lidar_aug_matrix", "gt_boxes", "gt_boxes2d", "depth_maps")
TARGET_KEYS = ("gt_boxes", "gt_boxes2d", "depth_maps")


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; a CUDA request without a CUDA
    device raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


class _Scope(nn.Module):
    """A named level of the reference module tree."""

    def __init__(self, **children):
        super().__init__()
        for name, child in children.items():
            setattr(self, name, child)


def init_weights(model: nn.Module, generator: torch.Generator):
    """LeCun-normal kernels and zero biases from ``generator`` (BatchNorms
    keep their identity initialization; a deformable convolution's
    ``conv_offset`` stays zero, as JAX's and mmcv's; an attention's packed
    q, k, v rows each have fan-in ``channels``)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MultiheadAttention):
                m.in_proj_weight.normal_(0.0, 1.0 / math.sqrt(m.in_proj_weight.shape[1]),
                                         generator=generator)
                m.in_proj_bias.zero_()
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear, SparseConv2d, SparseConv3d,
                              ModulatedDeformConv2d, nn.ConvTranspose2d)):
                # a transposed conv's weight is (I, O, kH, kW)
                fan_in = (m.weight.numel() // m.weight.shape[1]
                          if isinstance(m, nn.ConvTranspose2d)
                          else m.weight.numel() // m.weight.shape[0])
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        for m in model.modules():
            if isinstance(m, ModulatedDeformConv2d):
                m.conv_offset.weight.zero_()
                m.conv_offset.bias.zero_()


class Detector(nn.Module):
    """What every family shares: the device of its anchors, the batch moved
    there, and ``serve``."""

    @property
    def device(self) -> torch.device:
        return self.anchors.device

    def batch_to_device(self, batch):
        """The batch keys the model reads, as tensors on the model's device;
        a tensor in pinned memory is copied without making the host wait."""
        return {k: (batch[k] if isinstance(batch[k], torch.Tensor)
                    else torch.from_numpy(np.array(batch[k]))).to(self.device, non_blocking=True)
                for k in BATCH_KEYS if k in batch}

    def parameters_without_grad(self):
        """The trainable parameters a training step never differentiates."""
        return []

    def serve(self, batch):
        """One batch of frames -> fixed-shape detections (see post_process),
        in eval mode."""
        self.eval()
        with torch.inference_mode():
            return self.post_process(self(self.batch_to_device(batch)))


def _radar_parameters_without_grad(radar, prefix: str):
    """The radar backbone's stages past its last output, which train mode
    runs only for their BN statistics. Their gradient reads 0 in the update
    (weight decay alone moves them, as in JAX), and
    ``DistributedDataParallel`` must not wait for them."""
    backbone = radar.backbone
    return [f"{prefix}backbone.{stage}.{name}" for stage in backbone.stages_without_grad()
            for name, _ in getattr(backbone, stage).named_parameters()]


def _init_anchor_head(head: AnchorHeadSingle, gen: torch.Generator):
    """The reference's prior-probability cls bias and small box kernel."""
    with torch.no_grad():
        head.conv_cls.bias.fill_(-math.log((1 - 0.01) / 0.01))
        head.conv_box.weight.normal_(0.0, 0.001, generator=gen)


class HGSFusionModel(Detector):
    """End-to-end HGSFusion forward (images + radar points -> head outputs).

    ``device`` defaults to "cuda" and raises without a CUDA device; weights
    are drawn from ``seed`` on the CPU, so they are the same on any device.
    """

    def __init__(self, cfg: HGSFusionConfig, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        if cfg.f2v_view not in ("gather", "polar"):
            raise NotImplementedError(f"F2V.VIEW: {cfg.f2v_view} is not ported")
        if cfg.f2v_view == "polar" and (cfg.use_depth or cfg.f2v_quant != "none"
                                        or cfg.f2v_sampler_kernel != "xla"):
            raise ValueError(
                "F2V.VIEW: polar covers the USE_DEPTH: False CONCAT path with the "
                "default XLA sampler only (QUANT and SAMPLER_KERNEL are gather-path "
                "options)")
        self.cfg = cfg
        dt = cfg.dtype
        stage_sizes = (3, 4, 23, 3) if cfg.image_backbone == "ResNet101" else (3, 4, 6, 3)
        nz = cfg.grid_size[2]
        if cfg.f2v_view == "polar":
            f2v = PolarF2V(4 * cfg.channel_reduce_out, cfg.f2v_out_channels)
        else:
            f2v = FrustumToVoxelMultiScale(
                [cfg.channel_reduce_out] * 4, cfg.f2v_out_channels, dtype=dt,
                quant=cfg.f2v_quant, sampler_kernel=cfg.f2v_sampler_kernel, remat=cfg.remat)
        ddn = _Scope(backbone=ResNetDeepLabBackbone(stage_sizes, dt, cfg.ddn_quant))
        if cfg.use_depth:
            ddn.classifier = DeepLabClassifier(2048, cfg.disc_num_bins + 1, dt)
        image_vfe = _Scope(
            ffn=_Scope(
                ddn=_Scope(model=ddn),
                channel_reduce=nn.ModuleList(
                    ConvBNReLU(cin, cfg.channel_reduce_out, (1, 1), use_bias=False, dtype=dt)
                    for cin in (256, 512, 1024, 2048))),
            f2v=f2v)
        reader = PillarFeatureNet(cfg.reader_num_input, (32,), cfg.voxel_size[0],
                                  cfg.pc_range, dtype=dt)
        self.fusion_vfe = _Scope(
            image_vfe=image_vfe,
            radar_backbone=PillarNetRadar(reader, 32, cfg.backbone_out_indices,
                                          cfg.neck_out_channels, dt),
            radar_occupancy=RadarOccupancy2D(
                cfg.radar_input_channels, cfg.use_aspp, cfg.aspp_dilation,
                cfg.aspp_dilations, cfg.use_dcn, cfg.occ_use_mask, cfg.occ_fuse_mode,
                map_to_bev=Conv2DCollapse(cfg.f2v_out_channels, nz,
                                          cfg.radar_input_channels, dt),
                dtype=dt))
        self.fusion_after_bev = FusionAfterBEVSE(
            cfg.radar_input_channels + cfg.neck_out_channels[0],
            cfg.fusion_image_out, cfg.fusion_radar_out, dt)
        self.dense_head = AnchorHeadSingle(
            cfg.fusion_image_out + cfg.fusion_radar_out, cfg.num_class,
            cfg.num_anchors_per_location, cfg.code_size, cfg.num_dir_bins)
        anchors = flatten_anchors(
            generate_anchors(cfg.anchor_generator, cfg.grid_size, cfg.pc_range)[0])
        self.register_buffer("anchors", torch.from_numpy(anchors), persistent=False)
        self.box_coder = ResidualCoder(cfg.code_size)
        self.grid_gen = FrustumGridGenerator(cfg.grid_size, cfg.pc_range,
                                             cfg.disc_cfg, cfg.bev_aug)
        gen = torch.Generator().manual_seed(seed)
        init_weights(self, gen)
        _init_anchor_head(self.dense_head, gen)
        with torch.no_grad():  # the occupancy head's prior-probability bias
            self.fusion_vfe.radar_occupancy.pred_occupancy[9].bias.fill_(
                bias_init_with_prob(0.01))
        self.to(device)
        self.eval()

    def parameters_without_grad(self):
        """The names of the trainable parameters that a training step never
        differentiates (``_radar_parameters_without_grad``)."""
        return _radar_parameters_without_grad(self.fusion_vfe.radar_backbone,
                                              "fusion_vfe.radar_backbone.")

    # -- stages (separate so a caller can time each) -------------------------
    def image_features(self, batch):
        """Backbone + per-scale channel reduce -> (4 NHWC maps, depth): depth
        is None, or with USE_DEPTH {"logits": the classifier's logits on
        layer4 resized to layer1's resolution, (B, H1, W1, D + 1) f32,
        "probs": one (B, Hi, Wi, D) f32 distribution per map, the softmax
        computed once per distinct map size (layers 2-4 share theirs)}."""
        ffn = self.fusion_vfe.image_vfe.ffn
        if self.cfg.ddn_quant != "none" and self.training:
            raise NotImplementedError(
                "DDN.QUANT is an eval-only serving knob (the backbone "
                "is frozen; training still runs it in bf16/f32)")
        with torch.no_grad():  # frozen: its BN statistics still update in train mode
            taps = ffn.ddn.model.backbone(preprocess_images(batch["images"]))
        feats = [reduce(t) for reduce, t in zip(ffn.channel_reduce, taps)]
        if not self.cfg.use_depth:
            return feats, None
        logits = resize_bilinear(ffn.ddn.model.classifier(taps[-1]), feats[0].shape[1:3])
        probs = {}
        for f in feats:
            hw = tuple(f.shape[1:3])
            if hw not in probs:
                lg = logits if hw == tuple(logits.shape[1:3]) else resize_bilinear(logits, hw)
                probs[hw] = torch.softmax(lg, dim=-1)[..., :self.cfg.disc_num_bins]
        return feats, {"logits": logits, "probs": [probs[tuple(f.shape[1:3])] for f in feats]}

    def view_transform(self, feats, batch, depth=None):
        """Frustum grid -> quad-sample kernel (with ``depth``, the
        depth-weighted one) -> voxel -> collapsed image BEV; in the polar
        view, ``polar_f2v.polar_image_bev``."""
        cfg = self.cfg
        if cfg.f2v_view == "polar":
            return polar_image_bev(
                self.fusion_vfe.image_vfe.f2v, self.fusion_vfe.radar_occupancy.map_to_bev,
                feats, batch["trans_lidar_to_cam"], batch["trans_cam_to_img"],
                cfg.image_size, batch.get("lidar_aug_matrix"), grid_size=cfg.grid_size,
                pc_range=cfg.pc_range, zeta_bins=cfg.f2v_polar_zeta_bins,
                near_columns=cfg.f2v_polar_near_columns, bev_aug=cfg.bev_aug,
                remat=cfg.remat, dtype=cfg.dtype)
        grid = self.grid_gen(batch["trans_lidar_to_cam"], batch["trans_cam_to_img"],
                             self.cfg.image_size, bda=batch.get("lidar_aug_matrix"))
        voxel = self.fusion_vfe.image_vfe.f2v(feats, grid,
                                              None if depth is None else depth["probs"])
        return self.fusion_vfe.radar_occupancy.map_to_bev(voxel)

    def radar_branch(self, batch):
        radar = self.fusion_vfe.radar_backbone
        pillar_bev, occ = radar.reader(batch["points"], batch["points_valid"])
        return radar(pillar_bev, occ)

    def fusion_and_head(self, image_bev, radar_bev):
        gated, occupancy = self.fusion_vfe.radar_occupancy(image_bev, radar_bev)
        preds = self.dense_head(self.fusion_after_bev(gated, radar_bev))
        preds["occupancy"] = occupancy
        return preds

    def forward(self, batch):
        feats, depth = self.image_features(batch)
        image_bev = self.view_transform(feats, batch, depth)
        preds = self.fusion_and_head(image_bev, self.radar_branch(batch))
        if depth is not None:
            preds["depth_logits"] = depth["logits"]
        return preds

    def post_process(self, preds):
        cfg = self.cfg
        return post_process(preds, self.anchors, self.box_coder, cfg,
                            cfg.score_thresh, cfg.nms_thresh,
                            cfg.nms_pre_max_size, cfg.nms_post_max_size)


class _SingleHeadDetector(Detector):
    """A detector with an AnchorHeadSingle over the config's anchors and the
    class-agnostic post-processing."""

    def _finish(self, cfg, head_in: int, device, seed: int):
        self.cfg = cfg
        self.dense_head = AnchorHeadSingle(head_in, cfg.num_class, cfg.num_anchors_per_location,
                                           cfg.code_size, cfg.num_dir_bins)
        anchors = flatten_anchors(
            generate_anchors(cfg.anchor_generator, cfg.grid_size, cfg.pc_range)[0])
        self.register_buffer("anchors", torch.from_numpy(anchors), persistent=False)
        self.box_coder = ResidualCoder(cfg.code_size)
        gen = torch.Generator().manual_seed(seed)
        init_weights(self, gen)
        _init_anchor_head(self.dense_head, gen)
        self.to(device)
        self.eval()

    def post_process(self, preds):
        cfg = self.cfg
        return post_process(preds, self.anchors, self.box_coder, cfg,
                            cfg.score_thresh, cfg.nms_thresh,
                            cfg.nms_pre_max_size, cfg.nms_post_max_size)


class RadarOnlyModel(_SingleHeadDetector):
    """The radar-only pillar detector (BASELINE.json config 1): HGSFusion's
    radar branch (pillar encoder, masked ResNet-18 BEV encoder, FPN) and an
    anchor head, no camera branch; its batch carries no image. Parameters
    ``radar_backbone.{reader, backbone, neck}`` (the reference PillarNet's
    names) and ``dense_head``."""

    def __init__(self, cfg: HGSFusionConfig, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        dt = cfg.dtype
        reader = PillarFeatureNet(cfg.reader_num_input, (32,), cfg.voxel_size[0],
                                  cfg.pc_range, dtype=dt)
        self.radar_backbone = PillarNetRadar(reader, 32, cfg.backbone_out_indices,
                                             cfg.neck_out_channels, dt)
        self._finish(cfg, cfg.neck_out_channels[0], device, seed)

    def parameters_without_grad(self):
        return _radar_parameters_without_grad(self.radar_backbone, "radar_backbone.")

    def forward(self, batch):
        radar = self.radar_backbone
        pillar_bev, occ = radar.reader(batch["points"], batch["points_valid"])
        return self.dense_head(radar(pillar_bev, occ))


def _pillar_net(cfg):
    """The PointPillar families' reader: the raw point encoding (no virtual
    points), one 64-wide layer."""
    return PillarFeatureNet(cfg.num_point_features, (64,), cfg.voxel_size[0], cfg.pc_range,
                            use_virtual=False, encoding_type="mixed", dtype=cfg.dtype)


class PointPillarModel(_SingleHeadDetector):
    """PointPillars over the point cloud (zoo family): pillar encoder ->
    BaseBEVBackbone (stride 2 out) -> AnchorHeadSingle. Parameters
    ``pillar_net``, ``backbone_2d``, ``dense_head``."""

    def __init__(self, cfg: HGSFusionConfig, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.pillar_net = _pillar_net(cfg)
        self.backbone_2d = BaseBEVBackbone(64, dtype=cfg.dtype)
        self._finish(cfg, self.backbone_2d.out_channels, device, seed)

    def forward(self, batch):
        bev, _ = self.pillar_net(batch["points"], batch["points_valid"])
        return self.dense_head(self.backbone_2d(bev))


def make_multihead_assigner(cfg: HGSFusionConfig, device="cuda") -> TargetAssigner:
    """The multi-head anchor order and the config's box coder (code size,
    sin-cos), as the JAX package's ``make_anchor_assigner`` builds them."""
    return TargetAssigner(cfg.anchor_generator, cfg.grid_size, cfg.pc_range, cfg.class_names,
                          box_coder=ResidualCoder(cfg.box_coder_size, cfg.box_coder_sincos),
                          use_multihead=True, device=device)


class PointPillarMultiHeadModel(Detector):
    """PointPillars with the grouped multi-head anchor head (the nuScenes
    CBGS topology, zoo family): pillar encoder -> BaseBEVBackbone ->
    AnchorHeadMulti; per-head output lists in the multi-head anchor order.
    Parameters ``pillar_net``, ``backbone_2d``, ``dense_head``."""

    def __init__(self, cfg: HGSFusionConfig, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        if not cfg.rpn_head_cfgs:
            raise ValueError("PointPillarMultiHeadModel needs DENSE_HEAD.RPN_HEAD_CFGS")
        self.cfg = cfg
        self.pillar_net = _pillar_net(cfg)
        self.backbone_2d = BaseBEVBackbone(64, dtype=cfg.dtype)
        self.box_coder = ResidualCoder(cfg.box_coder_size, cfg.box_coder_sincos)
        self.dense_head = AnchorHeadMulti(
            self.backbone_2d.out_channels, cfg.class_names, cfg.rpn_head_cfgs,
            cfg.mh_num_per_loc, self.box_coder.code_size, cfg.mh_shared_conv_filters,
            cfg.mh_separate_reg_list, cfg.mh_num_middle_conv, cfg.mh_num_middle_filter,
            cfg.num_dir_bins, cfg.mh_use_dir, cfg.mh_separate_multihead, cfg.dtype)
        assigner = make_multihead_assigner(cfg, device="cpu")
        self.register_buffer("anchors", assigner.flat_anchors, persistent=False)
        gen = torch.Generator().manual_seed(seed)
        init_weights(self, gen)
        with torch.no_grad():  # the reference's prior-probability cls biases
            for hi in range(self.dense_head.num_heads):
                getattr(self.dense_head, f"head_{hi}").conv_cls.bias.fill_(
                    -math.log((1 - 0.01) / 0.01))
        self.to(device)
        self.eval()

    def forward(self, batch):
        bev, _ = self.pillar_net(batch["points"], batch["points_valid"])
        return self.dense_head(self.backbone_2d(bev))

    def post_process(self, preds):
        cfg = self.cfg
        return post_process_multihead(preds, self.anchors, self.box_coder, cfg,
                                      cfg.score_thresh, cfg.nms_thresh,
                                      cfg.nms_pre_max_size, cfg.nms_post_max_size)


class _TransFusionDetector(Detector):
    """A detector with the TransFusion head: anchor-free, its detections
    one per query (``transfusion_get_boxes``, no NMS)."""

    @property
    def device(self) -> torch.device:
        return self.dense_head.shared_conv.weight.device

    def _finish(self, cfg, head_in: int, device, seed: int):
        self.dense_head = TransFusionHead(head_in, cfg.num_class, num_proposals=cfg.center_max_k,
                                          no_pool_classes=cfg.tf_no_pool_classes, dtype=cfg.dtype)
        init_weights(self, torch.Generator().manual_seed(seed))
        self.dense_head.init_biases()
        self.to(device)
        self.eval()

    def post_process(self, preds):
        cfg = self.cfg
        return transfusion_get_boxes(preds, cfg.pc_range, cfg.voxel_size,
                                     cfg.center_feature_map_stride, cfg.score_thresh,
                                     cfg.center_post_limit)


def voxel_backbone_depth(nz: int) -> int:
    """The z planes ``VoxelBackBone8x`` leaves of a grid with ``nz``
    (mean_vfe adds one): three stride-2 convolutions (padding 1, 1, 0), then
    ``conv_out`` (kernel 3, stride 2, no padding)."""
    d = nz + 1
    for pad in (1, 1, 0, 0):
        d = (d + 2 * pad - 3) // 2 + 1
    return d


class BEVFusionModel(_TransFusionDetector):
    """BEVFusion (zoo family): a camera BEV lifted by a depth distribution,
    a voxel lidar BEV, a ConvFuser, BaseBEVBackbone and the TransFusion head.

    Camera branch, by ``image_backbone_arch``: "swin" (Swin ->
    ``GeneralizedLSSFPN``; ``channel_reduce`` and a 1x1 ``depth_head`` on
    the finest FPN level; the backbone trains, with stochastic depth drawn
    from a generator seeded by ``seed`` on ``device``) or "ddn" (the frozen
    ResNet-50 DeepLab backbone ``ddn_backbone``, run without autograd;
    ``channel_reduce`` on layer1, ``ddn_classifier`` on layer4). The depth
    logits, resized to the reduced map, give a softmax over
    ``disc_num_bins`` + 1 bins without the overflow bin; the frustum grid at
    (nx/8, ny/8, max(nz/2, 1)) samples the depth-weighted map
    (``FrustumToVoxelMultiScale`` on one group: the D1 kernel, in training
    D1, K2 and D2 with their bins), and the z axis is summed. Lidar branch:
    ``mean_vfe`` -> ``backbone_3d`` (VoxelBackBone8x) ->
    ``height_compression``. Then ``fuser_conv`` (3x3, no bias) ->
    ``fuser_bn`` -> ReLU over the concatenation -> ``backbone_2d`` ->
    ``dense_head``. The JAX package's names."""

    def __init__(self, cfg: HGSFusionConfig, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        dt = cfg.dtype
        nx, ny, nz = cfg.grid_size
        bins = cfg.disc_num_bins
        if cfg.image_backbone_arch == "swin":
            self.image_backbone = SwinTransformer(
                cfg.swin_embed_dims, cfg.swin_depths, cfg.swin_num_heads, cfg.swin_window_size,
                cfg.swin_mlp_ratio, cfg.swin_out_indices, cfg.swin_patch_size,
                drop_path_rate=cfg.swin_drop_path)
            self.neck = GeneralizedLSSFPN([cfg.swin_embed_dims * 2 ** i
                                           for i in cfg.swin_out_indices],
                                          cfg.fpn_out_channels, dt)
            feat_in = cfg.fpn_out_channels
            self.depth_head = nn.Conv2d(feat_in, bins + 1, 1)
        elif cfg.image_backbone_arch == "ddn":
            self.ddn_backbone = ResNetDeepLabBackbone((3, 4, 6, 3), dt)
            self.ddn_classifier = DeepLabClassifier(2048, bins + 1, dt)
            feat_in = 256
        else:
            raise NotImplementedError(f"image backbone {cfg.image_backbone_arch}")
        self.channel_reduce = ConvBNReLU(feat_in, cfg.channel_reduce_out, (1, 1), use_bias=False,
                                         dtype=dt)
        self.f2v = FrustumToVoxelMultiScale([cfg.channel_reduce_out], cfg.f2v_out_channels,
                                            dtype=dt, remat=cfg.remat)
        self.grid_gen = FrustumGridGenerator((nx // 8, ny // 8, max(nz // 2, 1)), cfg.pc_range,
                                             cfg.disc_cfg, cfg.bev_aug)
        self.backbone_3d = VoxelBackBone8x(cfg.num_point_features, dt)
        self.fuser_conv = nn.Conv2d(cfg.f2v_out_channels + 128 * voxel_backbone_depth(nz),
                                    cfg.fusion_radar_out, 3, padding=1, bias=False)
        self.fuser_bn = nn.BatchNorm2d(cfg.fusion_radar_out, eps=1e-5, momentum=0.1)
        self.backbone_2d = BaseBEVBackbone(cfg.fusion_radar_out, (5, 5), (1, 2), (128, 256),
                                           (1, 2), (128, 128), dtype=dt)
        self._finish(cfg, self.backbone_2d.out_channels, device, seed)
        if cfg.image_backbone_arch == "swin":
            self.image_backbone.generator = torch.Generator(device=device).manual_seed(seed)

    def image_features(self, batch):
        """-> (the reduced map (B, H, W, C), the depth logits (B, H, W, D + 1)
        at its size)."""
        dt = compute_dtype(self.cfg.dtype)
        images = preprocess_images(batch["images"])
        if self.cfg.image_backbone_arch == "swin":
            level0 = self.neck(self.image_backbone(images))[0]
            feat = self.channel_reduce(level0)
            logits = conv_nhwc(level0, self.depth_head, dt)
        else:
            with torch.no_grad():  # frozen: its BN statistics still update in train mode
                taps = self.ddn_backbone(images)
            feat = self.channel_reduce(taps[0])
            logits = self.ddn_classifier(taps[-1])
        return feat, resize_bilinear(logits, feat.shape[1:3])

    def camera_bev(self, feat, logits, batch):
        """The depth-weighted frustum sample of ``feat``, summed over z:
        (B, ny/8, nx/8, C)."""
        probs = torch.softmax(logits, dim=-1)[..., :self.cfg.disc_num_bins]
        grid = self.grid_gen(batch["trans_lidar_to_cam"], batch["trans_cam_to_img"],
                             self.cfg.image_size, bda=batch.get("lidar_aug_matrix"))
        return self.f2v([feat], grid, [probs]).sum(dim=3)

    def lidar_bev(self, batch):
        cfg = self.cfg
        dense, mask = mean_vfe(batch["points"], batch["points_valid"], cfg.pc_range,
                               cfg.voxel_size, cfg.grid_size)
        x3d, _ = self.backbone_3d(dense.to(compute_dtype(cfg.dtype)), mask)
        return height_compression(x3d)

    def forward(self, batch):
        dt = compute_dtype(self.cfg.dtype)
        feat, logits = self.image_features(batch)
        cam = self.camera_bev(feat, logits, batch)
        fused = torch.cat([cam, self.lidar_bev(batch).to(cam.dtype)], dim=-1)
        fused = torch.relu(batch_norm(conv_nhwc(fused, self.fuser_conv, dt), self.fuser_bn, dt))
        return self.dense_head(self.backbone_2d(fused))


class TransFusionModel(_TransFusionDetector):
    """TransFusion-L (zoo family): the PointPillars reader (``pillar_net``)
    -> ``backbone_2d`` (BaseBEVBackbone) -> the TransFusion head
    (``dense_head``)."""

    def __init__(self, cfg: HGSFusionConfig, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.pillar_net = _pillar_net(cfg)
        self.backbone_2d = BaseBEVBackbone(64, dtype=cfg.dtype)
        self._finish(cfg, self.backbone_2d.out_channels, device, seed)

    def forward(self, batch):
        bev, _ = self.pillar_net(batch["points"], batch["points_valid"])
        return self.dense_head(self.backbone_2d(bev))


def _voxel_backbone_3d(cfg: HGSFusionConfig):
    """The SECOND-style 3-D backbone of ``backbone_3d_arch``: "voxel8x"
    (VoxelBackBone8x) or "voxel8x_focal" (VoxelBackBone8xFocal with the
    config's foreground rule)."""
    if cfg.backbone_3d_arch == "voxel8x_focal":
        return VoxelBackBone8xFocal(cfg.num_point_features, cfg.focal_topk, cfg.focal_threshold,
                                    cfg.focal_mask_multi, cfg.focal_skip_mask_kernel, cfg.dtype)
    if cfg.backbone_3d_arch != "voxel8x":
        raise NotImplementedError(f"a SECOND-style detector with backbone_3d_arch "
                                  f"{cfg.backbone_3d_arch!r}")
    return VoxelBackBone8x(cfg.num_point_features, cfg.dtype)


def _second_bev_backbone(cfg: HGSFusionConfig):
    """SECOND's BaseBEVBackbone: (5, 5) layers at strides (1, 2), 128 and
    256 wide, upsampled (1, 2) to 256 each, over the height-compressed
    voxel features."""
    return BaseBEVBackbone(128 * voxel_backbone_depth(cfg.grid_size[2]), (5, 5), (1, 2),
                           (128, 256), (1, 2), (256, 256), dtype=cfg.dtype)


class SECONDModel(_SingleHeadDetector):
    """SECOND (zoo family): ``mean_vfe`` -> ``backbone_3d``
    (VoxelBackBone8x, or VoxelBackBone8xFocal where ``backbone_3d_arch`` is
    "voxel8x_focal", the focal SECOND) -> ``height_compression`` ->
    ``backbone_2d`` (``_second_bev_backbone``) -> ``dense_head``
    (AnchorHeadSingle; the config's anchors at ``feature_map_stride`` 8).
    In train mode the focal backbone's importance maps ride along as
    ``preds["focal_aux"]`` for ``focal_conv_loss``."""

    def __init__(self, cfg: HGSFusionConfig, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.backbone_3d = self.voxel_backbone(cfg)
        self.backbone_2d = _second_bev_backbone(cfg)
        self.build_second_stage(cfg)
        self._finish(cfg, self.backbone_2d.out_channels, device, seed)

    def voxel_backbone(self, cfg):
        return _voxel_backbone_3d(cfg)

    def build_second_stage(self, cfg):
        """The modules after the RPN (none for SECOND)."""

    def voxel_features(self, batch):
        """-> (the 3-D backbone's output, its stages, the focal backbone's
        aux list or None)."""
        cfg = self.cfg
        dense, mask = mean_vfe(batch["points"], batch["points_valid"], cfg.pc_range,
                               cfg.voxel_size, cfg.grid_size)
        dense = dense.to(compute_dtype(cfg.dtype))
        if isinstance(self.backbone_3d, VoxelBackBone8xFocal):
            x3d, _, stages, aux = self.backbone_3d(dense, mask)
            return x3d, stages, aux
        x3d, _, stages = self.backbone_3d(dense, mask, with_stages=True)
        return x3d, stages, None

    def forward(self, batch):
        x3d, _, aux = self.voxel_features(batch)
        out = self.dense_head(self.backbone_2d(height_compression(x3d)))
        if aux is not None and self.training:
            out["focal_aux"] = aux
        return out


class _TwoStageDetector(SECONDModel):
    """The anchor-RPN two-stage families: SECOND's RPN, its proposals
    (``rpn_proposals``, JAX's ``_RPNProposals``), then a second stage
    (``roi_stage``, which sees the batch, the proposals, the 3-D stages,
    the stride-8 BEV features and the 2-D backbone's features)."""

    def rpn_proposals(self, rpn):
        """Every anchor's box decoded from the detached RPN outputs, each
        anchor's max-class sigmoid and label, then ``generate_proposals``
        at ``pv_num_rois`` and ``pv_nms_thresh``: (rois, scores, labels,
        valid)."""
        cfg = self.cfg
        bsz, a = rpn["cls_preds"].shape[0], self.anchors.shape[0]
        with torch.no_grad():
            cls = rpn["cls_preds"].detach().reshape(bsz, a, cfg.num_class).float()
            dirs = rpn.get("dir_cls_preds")
            boxes = decode_selected_boxes(
                rpn["box_preds"].detach().reshape(bsz, a, -1).float(),
                None if dirs is None else dirs.detach().reshape(bsz, a, -1), self.anchors,
                self.box_coder, dir_offset=cfg.dir_offset,
                dir_limit_offset=cfg.dir_limit_offset, num_dir_bins=cfg.num_dir_bins)
            scores, labels = torch.sigmoid(cls).max(dim=-1)
            return generate_proposals(scores, labels + 1, boxes, cfg.pv_num_rois,
                                      cfg.pv_nms_thresh)

    def forward(self, batch):
        x3d, stages, aux = self.voxel_features(batch)
        bev = height_compression(x3d)
        feats2d = self.backbone_2d(bev)
        rpn = self.dense_head(feats2d)
        rois, roi_scores, roi_labels, roi_valid = self.rpn_proposals(rpn)
        out = {**rpn, "rois": rois, "roi_scores": roi_scores, "roi_labels": roi_labels,
               "roi_valid": roi_valid,
               **self.roi_stage(batch, rois, roi_valid, stages, bev, feats2d)}
        if aux is not None and self.training:
            out["focal_aux"] = aux
        return out

    def roi_stage(self, batch, rois, roi_valid, stages, bev, feats2d):
        """The second stage's outputs from the batch, the (B, R, 7) proposals
        and their (B, R) mask, the 3-D backbone's stages, the stride-8 BEV
        features (B, H, W, C) and the 2-D backbone's."""
        raise NotImplementedError


class VoxelRCNNModel(_TwoStageDetector):
    """Voxel R-CNN (zoo family): SECOND's RPN (either 3-D backbone), then
    ``roi_grid_pool`` (VoxelRCNNPool: x_conv2 .. x_conv4 at each proposal's
    6^3 grid points) and ``roi_head`` (RCNNHead: ``rcnn_cls``,
    ``rcnn_reg``). ``post_process``: the refined boxes
    (``decode_canonical``) scored by sigmoid(``rcnn_cls``), one rotated NMS
    (the JAX package's ``make_pvrcnn_eval_step``)."""

    def build_second_stage(self, cfg):
        self.roi_grid_pool = VoxelRCNNPool(cfg.pc_range, cfg.voxel_size, cfg.dtype)
        self.roi_head = RCNNHead(6 ** 3 * 96, cfg.dtype)

    def roi_stage(self, batch, rois, roi_valid, stages, bev, feats2d):
        rcnn_cls, rcnn_reg = self.roi_head(self.roi_grid_pool(rois, stages))
        return {"rcnn_cls": rcnn_cls, "rcnn_reg": rcnn_reg}

    def post_process(self, preds):
        return refine_post_process(preds, self.box_coder, self.cfg)


class SECONDIoUModel(_TwoStageDetector):
    """SECOND-IoU (zoo family): SECOND's RPN (VoxelBackBone8x, as JAX),
    then ``rotated_bev_grid_pool`` of the detached stride-8 BEV features
    over each proposal (``iou_grid_size`` squared) and ``roi_head``
    (SECONDIoUHead: ``iou_preds``). ``post_process``: the proposals scored
    by ``rectified_scores`` (``iou_score_type``), one class-agnostic
    rotated NMS (``rectified_post_process``)."""

    def voxel_backbone(self, cfg):
        return VoxelBackBone8x(cfg.num_point_features, cfg.dtype)

    def build_second_stage(self, cfg):
        self.roi_head = SECONDIoUHead(cfg.iou_grid_size ** 2 * self.backbone_2d.out_channels,
                                      dtype=cfg.dtype)

    def roi_stage(self, batch, rois, roi_valid, stages, bev, feats2d):
        cfg = self.cfg
        pooled = rotated_bev_grid_pool(feats2d.detach(), rois, cfg.pc_range, cfg.voxel_size,
                                       8, cfg.iou_grid_size)
        return {"iou_preds": self.roi_head(pooled)}

    def post_process(self, preds):
        return rectified_post_process(preds, self.cfg)


class PVRCNNModel(_TwoStageDetector):
    """PV-RCNN (zoo family): SECOND's RPN (either 3-D backbone, as JAX's
    ``_voxel_backbone_3d``), its proposals, then ``pfe``
    (VoxelSetAbstraction: 1,024 keypoints by FPS over the raw points, the
    stride-8 BEV features, the raw points, x_conv3 and x_conv4), ``point_head``
    (KeypointWeighting: ``point_logits``), ``roi_grid_pool`` (RoIGridPool:
    the keypoints at each proposal's 6^3 grid points) and ``roi_head``
    (RCNNHead: ``rcnn_cls``, ``rcnn_reg``); ``keypoints`` ride along for the
    loss. ``post_process``: ``refine_post_process``, as Voxel R-CNN. The
    YAML's FusionVFE block is not read (nor by JAX's model)."""

    AGGREGATION = "sa"
    PROPOSAL_CENTRIC = False

    def build_second_stage(self, cfg):
        self.pfe = VoxelSetAbstraction(
            cfg.num_point_features - 3, 128 * voxel_backbone_depth(cfg.grid_size[2]),
            {"x_conv3": 64, "x_conv4": 64}, cfg.pv_num_keypoints, cfg.pc_range,
            cfg.voxel_size, aggregation=self.AGGREGATION, dtype=cfg.dtype)
        self.point_head = KeypointWeighting(128, cfg.dtype)
        self.roi_grid_pool = RoIGridPool(128, aggregation=self.AGGREGATION, dtype=cfg.dtype)
        self.roi_head = RCNNHead(6 ** 3 * 128, cfg.dtype)

    def roi_stage(self, batch, rois, roi_valid, stages, bev, feats2d):
        centric = (rois, roi_valid) if self.PROPOSAL_CENTRIC else ()
        keypoints, kp_feats = self.pfe(batch["points"], batch["points_valid"], bev, stages,
                                       *centric)
        kp_feats, point_logits = self.point_head(kp_feats)
        rcnn_cls, rcnn_reg = self.roi_head(self.roi_grid_pool(rois, keypoints, kp_feats))
        return {"keypoints": keypoints, "point_logits": point_logits, "rcnn_cls": rcnn_cls,
                "rcnn_reg": rcnn_reg}

    def post_process(self, preds):
        return refine_post_process(preds, self.box_coder, self.cfg)


class PartA2Model(_TwoStageDetector):
    """Part-A2 (zoo family): SECOND's RPN on the plain VoxelBackBone8x (as
    JAX, whatever ``backbone_3d_arch`` says), its proposals, then the
    part-aware stage, ``unet_decoder`` (UNetDecoder: the backbone's stages
    back to stride 1) and ``point_head`` (PointPartHead over each point's
    voxel feature: ``seg_logits``, ``part_pred``), and the aggregation,
    ``roi_head`` (PartA2RoIHead: the proposals' RoI-aware pools of the
    detached parts and segmentation scores and of the point features,
    which keep their gradient: ``rcnn_cls``, ``rcnn_reg``).
    ``post_process``: ``refine_post_process``, as Voxel R-CNN. The YAML's
    FusionVFE block is not read (nor by JAX's model)."""

    def voxel_backbone(self, cfg):
        return VoxelBackBone8x(cfg.num_point_features, cfg.dtype)

    def build_second_stage(self, cfg):
        self.unet_decoder = UNetDecoder(cfg.dtype)
        self.point_head = PointPartHead(16, cfg.num_class, cfg.dtype)
        self.roi_head = PartA2RoIHead(16, cfg.parta2_pool_size, dtype=cfg.dtype)

    def point_features(self, batch, stages):
        """Each point's stride-1 decoder feature (B, N, 16), f32."""
        cfg = self.cfg
        voxels, _ = self.unet_decoder(stages)
        return gather_point_voxel_features(voxels.float(), batch["points"],
                                           batch["points_valid"], cfg.pc_range, cfg.voxel_size,
                                           cfg.grid_size)

    def roi_stage(self, batch, rois, roi_valid, stages, bev, feats2d):
        point_feats = self.point_features(batch, stages)
        seg_logits, part_pred = self.point_head(point_feats)
        rcnn_cls, rcnn_reg = self.roi_head(
            rois, batch["points"][..., :3], batch["points_valid"], point_feats,
            torch.sigmoid(seg_logits).amax(dim=-1).detach(), torch.sigmoid(part_pred).detach())
        return {"seg_logits": seg_logits, "part_pred": part_pred, "rcnn_cls": rcnn_cls,
                "rcnn_reg": rcnn_reg}

    def post_process(self, preds):
        return refine_post_process(preds, self.box_coder, self.cfg)


class PVRCNNPlusPlusModel(PVRCNNModel):
    """PV-RCNN++ (zoo family): PV-RCNN on the plain VoxelBackBone8x (as
    JAX), its keypoints sampled around the proposals
    (``sample_keypoints_proposal_centric``), and VectorPool aggregation in
    the set abstraction and the RoI-grid pool."""

    AGGREGATION = "vectorpool"
    PROPOSAL_CENTRIC = True

    def voxel_backbone(self, cfg):
        return VoxelBackBone8x(cfg.num_point_features, cfg.dtype)


def rectified_post_process(preds, cfg):
    """SECOND-IoU's detections (the JAX package's
    ``make_secondiou_eval_step`` after the forward): each proposal scored by
    ``rectified_scores`` of its class score and sigmoid(``iou_preds``) (0
    where not valid), then ``class_agnostic_nms`` with the config's
    threshold, sizes and score threshold, one NMS call for the batch."""
    scores = rectified_scores(preds["roi_scores"], torch.sigmoid(preds["iou_preds"]),
                              cfg.iou_score_type) * preds["roi_valid"]
    idx, valid = class_agnostic_nms(scores, preds["rois"], cfg.score_thresh, cfg.nms_thresh,
                                    cfg.nms_pre_max_size, cfg.nms_post_max_size,
                                    valid=preds["roi_valid"])
    return {"boxes": torch.take_along_dim(preds["rois"], idx[..., None], dim=1),
            "scores": torch.where(valid, torch.take_along_dim(scores, idx, dim=1),
                                  torch.zeros((), device=idx.device)),
            "labels": torch.take_along_dim(preds["roi_labels"], idx, dim=1), "valid": valid}


def refine_post_process(preds, box_coder, cfg):
    """The refining second stage's detections (the JAX package's
    ``make_pvrcnn_eval_step`` after the forward): each RoI's box refined by
    ``decode_canonical``, scored by sigmoid(``rcnn_cls``) (0 where the RoI
    is not valid), those above ``score_thresh`` ranked (ties by index), one
    rotated NMS at ``nms_thresh`` for the batch keeping
    ``nms_post_max_size``. Returns {"boxes", "scores", "labels", "valid"},
    zeros in the unfilled slots."""
    refined = decode_canonical(preds["rcnn_reg"], preds["rois"], box_coder)
    scores = torch.sigmoid(preds["rcnn_cls"]) * preds["roi_valid"]
    ranked = torch.where(scores > cfg.score_thresh, scores, torch.full_like(scores, NEG_INF))
    top_s, top_i = top_scores(ranked, ranked.shape[-1])
    top_b = torch.take_along_dim(refined, top_i[..., None], dim=1)
    idx, valid = kept_slots(top_s, top_b, top_i, cfg.nms_thresh, cfg.nms_post_max_size)
    zero = torch.zeros((), device=idx.device)
    return {"boxes": torch.where(valid[..., None],
                                 torch.take_along_dim(refined, idx[..., None], dim=1), zero),
            "scores": torch.where(valid, torch.take_along_dim(scores, idx, dim=1), zero),
            "labels": torch.where(valid, torch.take_along_dim(preds["roi_labels"], idx, dim=1),
                                  torch.zeros((), dtype=preds["roi_labels"].dtype,
                                              device=idx.device)),
            "valid": valid}


class _CenterDetector(Detector):
    """A detector with the CenterHead: decode and one class-agnostic NMS
    (``center_post_process``)."""

    @property
    def device(self) -> torch.device:
        return self.dense_head.shared_conv.weight.device

    def _finish(self, cfg, head_in: int, device, seed: int, shared_channels: int = 64):
        self.cfg = cfg
        self.dense_head = CenterHead(head_in, cfg.num_class, shared_channels,
                                     cfg.center_head_order, cfg.center_head_channels,
                                     dtype=cfg.dtype)
        init_weights(self, torch.Generator().manual_seed(seed))
        self.dense_head.init_biases()
        self.to(device)
        self.eval()

    def post_process(self, preds):
        return center_post_process(preds, self.cfg)


class CenterPointModel(_CenterDetector):
    """CenterPoint (zoo family). ``backbone_3d_arch`` "voxel8x" (the
    classic pillar model): ``pillar_net`` (the raw point, 64 wide) ->
    ``backbone_2d`` (BaseBEVBackbone, stride 2 out) -> ``dense_head``.
    "pillar_res2d_8x" / "pillar_8x": ``pillar_net`` (32 wide) ->
    ``backbone_3d`` (PillarRes18BackBone8x, residual or post-activation
    blocks) -> ``backbone_2d`` (BaseBEVBackboneV1 over x_conv4 and x_conv5,
    stride 8 out) -> ``dense_head``. The head's stride is the config's
    ``center_feature_map_stride``."""

    def __init__(self, cfg: HGSFusionConfig, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        dt = cfg.dtype
        if cfg.backbone_3d_arch in ("pillar_8x", "pillar_res2d_8x"):
            self.pillar_net = PillarFeatureNet(cfg.num_point_features, (32,), cfg.voxel_size[0],
                                               cfg.pc_range, use_virtual=False,
                                               encoding_type="mixed", dtype=dt)
            self.backbone_3d = PillarRes18BackBone8x(cfg.backbone_3d_arch == "pillar_res2d_8x",
                                                     dt)
            self.backbone_2d = BaseBEVBackboneV1(
                (256, 256), cfg.bev_v1_layer_nums, cfg.bev_v1_num_filters,
                cfg.bev_v1_upsample_strides, cfg.bev_v1_num_upsample_filters, dt)
        elif cfg.backbone_3d_arch == "voxel8x":
            self.pillar_net = _pillar_net(cfg)
            self.backbone_2d = BaseBEVBackbone(64, dtype=dt)
        else:
            raise NotImplementedError(f"CenterPoint with backbone_3d_arch "
                                      f"{cfg.backbone_3d_arch!r}")
        self._finish(cfg, self.backbone_2d.out_channels, device, seed)

    def forward(self, batch):
        bev, occ = self.pillar_net(batch["points"], batch["points_valid"])
        if not hasattr(self, "backbone_3d"):
            return self.dense_head(self.backbone_2d(bev))
        outs, _ = self.backbone_3d(bev, occ)
        return self.dense_head(self.backbone_2d(outs["x_conv4"], outs["x_conv5"]))


class VoxelNeXtModel(_CenterDetector):
    """VoxelNeXt (zoo family). ``backbone_3d_arch`` "voxel8x": ``mean_vfe``
    -> ``backbone_3d`` (VoxelResBackBone8xVoxelNeXt); "voxelnext2d":
    ``pillar_net`` (32 wide) -> ``backbone_3d`` (VoxelNeXt2DBackbone); then
    ``dense_head`` (the CenterHead, 128 shared channels) at stride 8, dense
    over the masked BEV as in JAX."""

    def __init__(self, cfg: HGSFusionConfig, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        dt = cfg.dtype
        if cfg.backbone_3d_arch == "voxelnext2d":
            self.pillar_net = PillarFeatureNet(cfg.num_point_features, (32,), cfg.voxel_size[0],
                                               cfg.pc_range, use_virtual=False,
                                               encoding_type="mixed", dtype=dt)
            self.backbone_3d = VoxelNeXt2DBackbone(dt)
            head_in = 256
        elif cfg.backbone_3d_arch == "voxel8x":
            self.backbone_3d = VoxelResBackBone8xVoxelNeXt(cfg.num_point_features, dtype=dt)
            head_in = 128
        else:
            raise NotImplementedError(f"VoxelNeXt with backbone_3d_arch "
                                      f"{cfg.backbone_3d_arch!r}")
        self._finish(cfg, head_in, device, seed, shared_channels=128)

    def forward(self, batch):
        cfg = self.cfg
        if hasattr(self, "pillar_net"):
            bev, occ = self.pillar_net(batch["points"], batch["points_valid"])
            feats, _, _ = self.backbone_3d(bev, occ)
        else:
            dense, mask = mean_vfe(batch["points"], batch["points_valid"], cfg.pc_range,
                                   cfg.voxel_size, cfg.grid_size)
            feats, _ = self.backbone_3d(dense.to(compute_dtype(cfg.dtype)), mask)
        return self.dense_head(feats)


def center_post_process(preds, cfg):
    """The CenterHead's detections (the JAX package's ``make_center_eval_step``
    after the forward): ``decode_center_boxes`` at ``center_max_k`` with the
    config's stride, center limits and score threshold; then, unless the
    config has no NMS_CONFIG (``nms_type`` None: the raw decode), one
    class-agnostic rotated NMS over each frame's decoded candidates (the
    decode's ``valid``, no score threshold: the decode applied it; equal
    scores ranked by index), the whole batch in one ``hgsfusion::nms_lazy``
    call. ``circle_nms`` and ``class_specific_nms`` raise, as in JAX.
    Returns {"boxes" (B, post_max, 7), "scores" (0 where not valid),
    "labels", "valid", and "vels" (B, post_max, 2) with a ``vel`` branch}."""
    if cfg.nms_type in ("circle_nms", "class_specific_nms"):
        raise NotImplementedError(f"CenterPoint eval NMS_TYPE {cfg.nms_type} is not "
                                  "implemented")
    out = decode_center_boxes(preds, cfg.center_max_k, cfg.center_feature_map_stride,
                              cfg.pc_range, cfg.voxel_size, cfg.center_post_limit,
                              cfg.score_thresh)
    if cfg.nms_type is None:
        return out
    idx, valid = class_agnostic_nms(out["scores"], out["boxes"], -1.0, cfg.nms_thresh,
                                    cfg.nms_pre_max_size, cfg.nms_post_max_size,
                                    valid=out["valid"])

    def kept(t):  # (B, K, ...) -> the kept slots (B, post_max, ...)
        return torch.take_along_dim(t, idx.reshape(idx.shape + (1,) * (t.dim() - 2)), dim=1)

    res = {"boxes": kept(out["boxes"]),
           "scores": torch.where(valid, kept(out["scores"]), torch.zeros((), device=idx.device)),
           "labels": kept(out["labels"]), "valid": valid}
    if "vels" in out:
        res["vels"] = kept(out["vels"])
    return res


def post_process(preds, anchors, box_coder, cfg, score_thresh: float = 0.1,
                 nms_thresh: float = 0.01, pre_max_size: int = 4096,
                 post_max_size: int = 500):
    """Sigmoid -> per-anchor max class -> top ``pre_max_size`` -> decode ->
    class-agnostic rotated NMS, the whole batch at once (one NMS launch on
    the card, no host read). Returns {"boxes" (B, post_max, 7), "scores",
    "labels" (1-based), "valid"}, fixed shapes."""
    bsz = preds["cls_preds"].shape[0]
    a = anchors.shape[0]
    scores = torch.sigmoid(preds["cls_preds"].reshape(bsz, a, cfg.num_class).float())
    cls_scores, labels = scores.max(dim=-1)
    labels = labels + 1
    raw_box = preds["box_preds"].reshape(bsz, a, -1)
    raw_dir = preds.get("dir_cls_preds")
    k = min(pre_max_size, a)
    masked = torch.where(cls_scores >= score_thresh, cls_scores,
                         torch.full_like(cls_scores, NEG_INF))
    top_s, top_i = top_scores(masked, k)

    def rows(t):  # (B, A, ...) -> the top candidates' rows (B, k, ...)
        return torch.take_along_dim(t, top_i.reshape(top_i.shape + (1,) * (t.dim() - 2)), dim=1)

    dec = decode_selected_boxes(
        rows(raw_box), None if raw_dir is None else rows(raw_dir.reshape(bsz, a, -1)),
        anchors[top_i], box_coder, dir_offset=cfg.dir_offset,
        dir_limit_offset=cfg.dir_limit_offset, num_dir_bins=cfg.num_dir_bins)
    idx, valid = class_agnostic_nms(top_s, dec, score_thresh, nms_thresh, k, post_max_size)

    def kept(t):  # (B, k, ...) -> the kept slots (B, post_max, ...)
        return torch.take_along_dim(t, idx.reshape(idx.shape + (1,) * (t.dim() - 2)), dim=1)

    return {"boxes": kept(dec), "scores": kept(rows(cls_scores)),
            "labels": kept(rows(labels)), "valid": valid}


def post_process_multihead(preds, anchors, box_coder, cfg, score_thresh: float = 0.1,
                           nms_thresh: float = 0.2, pre_max_size: int = 1000,
                           post_max_size: int = 83):
    """Per head and per class of the head, rotated NMS on that class's
    scores (the reference's MULTI_CLASSES_NMS branch), labels mapped to the
    global classes. Every (frame, head, class) candidate set is a frame of
    one ``hgsfusion::nms_lazy`` call (``ops.nms.multi_set_nms``). ``anchors``:
    the multi-head flat anchors. Returns {"boxes" (B, S*post_max, 7),
    "scores", "labels" (1-based), "valid", and "vels" (B, S*post_max, C) when
    the boxes carry velocities}, S = the classes of all heads, each set a
    block of ``post_max_size`` rows in head, then class order."""
    set_scores, set_boxes, set_labels = multihead_candidate_sets(preds, anchors, box_coder, cfg)
    idx, valid = multi_set_nms(set_scores, set_boxes, score_thresh, nms_thresh,
                               pre_max_size, post_max_size)
    kept_boxes = torch.cat([torch.take_along_dim(b, idx[:, si, :, None], dim=1)
                            for si, b in enumerate(set_boxes)], dim=1)
    kept_scores = torch.cat([torch.take_along_dim(s, idx[:, si], dim=1)
                             for si, s in enumerate(set_scores)], dim=1)
    labels = torch.cat([torch.full_like(idx[:, si], lab, dtype=torch.int64)
                        for si, lab in enumerate(set_labels)], dim=1)
    out = {"boxes": kept_boxes[..., :7], "scores": kept_scores, "labels": labels,
           "valid": valid.flatten(1)}
    if kept_boxes.shape[-1] > 7:  # velocities ride along
        out["vels"] = kept_boxes[..., 7:]
    return out


def multihead_candidate_sets(preds, anchors, box_coder, cfg):
    """The (head, class) candidate sets of a multi-head model's outputs:
    per set its sigmoid scores (B, A_h), the head's decoded boxes (B, A_h,
    7 + C) and the class's global 1-based label, in head, then class
    order."""
    cls_list, box_list, label_idx = generate_predicted_boxes_multihead(
        preds, anchors, box_coder, cfg.class_names, cfg.rpn_head_cfgs, cfg.mh_num_per_loc,
        cfg.dir_offset, cfg.dir_limit_offset, cfg.num_dir_bins)
    set_scores, set_boxes, set_labels = [], [], []
    for cp, boxes, labels in zip(cls_list, box_list, label_idx):
        scores = torch.sigmoid(cp.float())
        for ci, label in enumerate(labels):
            set_scores.append(scores[..., ci])
            set_boxes.append(boxes)
            set_labels.append(label)
    return set_scores, set_boxes, set_labels
