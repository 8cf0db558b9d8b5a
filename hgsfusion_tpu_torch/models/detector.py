"""HGSFusion detector: camera + radar branches, DSM fusion, anchor head,
post-processing.

Counterpart of ``hgsfusion_tpu/models/detector.py`` (HGSFusionModel with
``f2v_view="gather"`` and ``f2v_sampler_kernel="pallas"``, or
``f2v_view="polar"``; post_process):

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
trainable channel reduces trains.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from ..config import HGSFusionConfig
from ..ops.nms import NEG_INF, class_agnostic_nms
from ..utils.box_coder import ResidualCoder
from .anchor_head import AnchorHeadSingle, decode_selected_boxes
from .anchors import flatten_anchors, generate_anchors
from .bev_encoder import PillarNetRadar, SparseConv2d
from .frustum import FrustumGridGenerator, FrustumToVoxelMultiScale
from .fusion_bev import FusionAfterBEVSE
from .layers import ConvBNReLU
from .occupancy import Conv2DCollapse, RadarOccupancy2D, bias_init_with_prob
from .pillar_encoder import PillarFeatureNet
from .polar_f2v import PolarF2V, polar_image_bev
from .resnet import ResNetDeepLabBackbone, preprocess_images

__all__ = ["HGSFusionConfig", "HGSFusionModel", "post_process", "resolve_device"]

BATCH_KEYS = ("points", "points_valid", "images", "trans_lidar_to_cam",
              "trans_cam_to_img", "lidar_aug_matrix", "gt_boxes")


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
    keep their identity initialization)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear, SparseConv2d)):
                fan_in = m.weight.numel() // m.weight.shape[0]
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()


class HGSFusionModel(nn.Module):
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
        if cfg.ddn_quant != "none":
            raise NotImplementedError(f"DDN.QUANT: {cfg.ddn_quant} is not ported")
        self.cfg = cfg
        dt = cfg.dtype
        stage_sizes = (3, 4, 23, 3) if cfg.image_backbone == "ResNet101" else (3, 4, 6, 3)
        nz = cfg.grid_size[2]
        if cfg.f2v_view == "polar":
            f2v = PolarF2V(4 * cfg.channel_reduce_out, cfg.f2v_out_channels)
        else:
            f2v = FrustumToVoxelMultiScale(
                [cfg.channel_reduce_out] * 4, cfg.f2v_out_channels, dtype=dt,
                quant=cfg.f2v_quant, sampler_kernel=cfg.f2v_sampler_kernel,
                use_depth=cfg.use_depth)
        image_vfe = _Scope(
            ffn=_Scope(
                ddn=_Scope(model=_Scope(backbone=ResNetDeepLabBackbone(stage_sizes, dt))),
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
        with torch.no_grad():  # the reference's prior-probability output biases
            self.dense_head.conv_cls.bias.fill_(-math.log((1 - 0.01) / 0.01))
            self.dense_head.conv_box.weight.normal_(0.0, 0.001, generator=gen)
            self.fusion_vfe.radar_occupancy.pred_occupancy[9].bias.fill_(
                bias_init_with_prob(0.01))
        self.to(device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.anchors.device

    def batch_to_device(self, batch):
        """The batch keys the model reads, as tensors on the model's device."""
        return {k: (batch[k] if isinstance(batch[k], torch.Tensor)
                    else torch.from_numpy(np.array(batch[k]))).to(self.device)
                for k in BATCH_KEYS if k in batch}

    # -- stages (separate so a caller can time each) -------------------------
    def image_features(self, batch):
        """Backbone + per-scale channel reduce: 4 NHWC maps."""
        ffn = self.fusion_vfe.image_vfe.ffn
        with torch.no_grad():  # frozen: its BN statistics still update in train mode
            taps = ffn.ddn.model.backbone(preprocess_images(batch["images"]))
        return [reduce(t) for reduce, t in zip(ffn.channel_reduce, taps)]

    def view_transform(self, feats, batch):
        """Frustum grid -> quad-sample kernel -> voxel -> collapsed image BEV;
        in the polar view, ``polar_f2v.polar_image_bev``."""
        cfg = self.cfg
        if cfg.f2v_view == "polar":
            return polar_image_bev(
                self.fusion_vfe.image_vfe.f2v, self.fusion_vfe.radar_occupancy.map_to_bev,
                feats, batch["trans_lidar_to_cam"], batch["trans_cam_to_img"],
                cfg.image_size, batch.get("lidar_aug_matrix"), grid_size=cfg.grid_size,
                pc_range=cfg.pc_range, zeta_bins=cfg.f2v_polar_zeta_bins,
                near_columns=cfg.f2v_polar_near_columns, bev_aug=cfg.bev_aug,
                dtype=cfg.dtype)
        grid = self.grid_gen(batch["trans_lidar_to_cam"], batch["trans_cam_to_img"],
                             self.cfg.image_size, bda=batch.get("lidar_aug_matrix"))
        voxel = self.fusion_vfe.image_vfe.f2v(feats, grid)
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
        image_bev = self.view_transform(self.image_features(batch), batch)
        return self.fusion_and_head(image_bev, self.radar_branch(batch))

    def post_process(self, preds):
        cfg = self.cfg
        return post_process(preds, self.anchors, self.box_coder, cfg,
                            cfg.score_thresh, cfg.nms_thresh,
                            cfg.nms_pre_max_size, cfg.nms_post_max_size)

    def serve(self, batch):
        """One batch of frames -> fixed-shape detections (see post_process),
        in eval mode."""
        self.eval()
        with torch.inference_mode():
            return self.post_process(self(self.batch_to_device(batch)))


def post_process(preds, anchors, box_coder, cfg, score_thresh: float = 0.1,
                 nms_thresh: float = 0.01, pre_max_size: int = 4096,
                 post_max_size: int = 500):
    """Sigmoid -> per-anchor max class -> top ``pre_max_size`` -> decode ->
    class-agnostic rotated NMS. Returns {"boxes" (B, post_max, 7), "scores",
    "labels" (1-based), "valid"}, fixed shapes."""
    bsz = preds["cls_preds"].shape[0]
    a = anchors.shape[0]
    scores = torch.sigmoid(preds["cls_preds"].reshape(bsz, a, cfg.num_class).float())
    cls_scores, labels = scores.max(dim=-1)
    labels = labels + 1
    raw_box = preds["box_preds"].reshape(bsz, a, -1)
    raw_dir = preds.get("dir_cls_preds")
    if raw_dir is not None:
        raw_dir = raw_dir.reshape(bsz, a, cfg.num_dir_bins)
    k = min(pre_max_size, a)
    out = {"boxes": [], "scores": [], "labels": [], "valid": []}
    for i in range(bsz):
        s = cls_scores[i]
        masked = torch.where(s >= score_thresh, s, torch.full_like(s, NEG_INF))
        top_s, top_i = torch.topk(masked, k)
        dec = decode_selected_boxes(
            raw_box[i][top_i], None if raw_dir is None else raw_dir[i][top_i],
            anchors[top_i], box_coder, dir_offset=cfg.dir_offset,
            dir_limit_offset=cfg.dir_limit_offset, num_dir_bins=cfg.num_dir_bins)
        idx, valid = class_agnostic_nms(top_s, dec, score_thresh, nms_thresh, k,
                                        post_max_size)
        out["boxes"].append(dec[idx])
        out["scores"].append(s[top_i][idx])
        out["labels"].append(labels[i][top_i][idx])
        out["valid"].append(valid)
    return {key: torch.stack(v) for key, v in out.items()}
