"""DSM spatial sync: BEV collapse + radar-occupancy gating of the image BEV,
and the occupancy loss.

Counterpart of ``hgsfusion_tpu/models/occupancy.py`` (Conv2DCollapse,
RadarOccupancy2D with its serial or parallel ASPP or none, the MUL or SE
gate or the USE_MASK blend, rasterize_gt_boxes_bev, binary_focal_loss,
occupancy_loss). Parameter names follow the reference RadarOccupancy2DV2:
``map_to_bev.block.{conv, bn}`` and ``pred_occupancy.{0,1,3,4,6,7,9}``
(0-4 the serial ASPP). The parallel ASPP's and the SE gate's parameters take
the JAX package's names (``aspp_branch{i}``, ``aspp_dcn{i}`` with mmcv's
``conv_offset``, ``aspp_branch_bn{i}``, ``aspp_fuse``, ``aspp_fuse_bn``,
``se``, ``se_squeeze_conv``, ``se_squeeze_bn``): the reference's names for
them are not in this repository.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops.deform_conv import ModulatedDeformConv2d
from ..ops.grid_sample import div_exact
from ..utils.common import device_constant
from .layers import SEBlock, batch_norm, compute_dtype, conv_nhwc, resize_bilinear
from .resnet import dilated_conv3x3


# USE_MASK's radial Gaussian, in BEV cells (the JAX package's mask_sigma)
MASK_SIGMA = 240.0


def bias_init_with_prob(prior_prob: float) -> float:
    """Focal-style bias init."""
    return float(-math.log((1 - prior_prob) / prior_prob))


class Conv2DCollapse(nn.Module):
    """Voxel (B, Y, X, Z, C) -> BEV (B, Y, X, O) by Z-flatten + 1x1 conv + BN
    + ReLU. The conv weight keeps the reference's (O, C*Z) channel order
    c*Z + z; the contraction runs on the voxel as it lies, (z, c)-major."""

    def __init__(self, in_channels: int, nz: int, num_bev_features: int = 128,
                 dtype=None):
        super().__init__()
        self.nz = nz
        self.dtype = dtype
        self.block = nn.Module()
        self.block.conv = nn.Conv2d(in_channels * nz, num_bev_features, 1, bias=False)
        self.block.bn = nn.BatchNorm2d(num_bev_features)

    def forward(self, voxel):
        b, y, x, z, c = voxel.shape
        cdt = compute_dtype(self.dtype)
        o = self.block.conv.weight.shape[0]
        k = self.block.conv.weight.reshape(o, c, z).permute(2, 1, 0).reshape(z * c, o)
        out = (voxel.to(cdt).reshape(b * y * x, z * c) @ k.to(cdt)).reshape(b, y, x, o)
        return torch.relu_(batch_norm(out, self.block.bn, cdt))


class RadarOccupancy2D(nn.Module):
    """Occupancy head over the radar BEV + gating of the image BEV.

    The head: an ASPP, then 3x3 conv (C/2, bias) -> BN -> ReLU -> 3x3 conv
    (1, bias) -> sigmoid. The ASPP is serial (1x1 conv -> BN -> ReLU -> 3x3
    conv dilated ``aspp_dilation`` -> BN -> ReLU, the shipped head), or with
    ``aspp_dilations`` parallel (one branch a dilation: 1 a 1x1 conv, others
    a dilated 3x3 conv (``resnet.dilated_conv3x3``), or where ``use_dcn``
    says so a modulated deformable conv; each -> BN -> ReLU, concatenated,
    1x1 ``aspp_fuse`` -> BN -> ReLU), or with ``use_aspp`` False none.
    The gate: FUSE_MODE MUL multiplies the image BEV by the occupancy; SE
    squeezes the concat of the gated and the ungated image BEV (``se``,
    1x1 ``se_squeeze_conv`` -> BN -> ReLU); USE_MASK blends the occupancy
    with 1 by a radial Gaussian over the BEV grid (sigma 240 cells) and
    ignores FUSE_MODE, as the JAX package does. ``map_to_bev`` (the
    Conv2DCollapse) is held here for the reference's parameter names; the
    detector calls it.
    """

    def __init__(self, radar_input_channels: int = 128, use_aspp: bool = True,
                 aspp_dilation: int = 6, aspp_dilations=None, use_dcn=None,
                 use_mask: bool = False, fuse_mode: str = "MUL",
                 map_to_bev=None, dtype=None):
        super().__init__()
        if fuse_mode not in ("MUL", "SE"):
            raise NotImplementedError(fuse_mode)
        c, d = radar_input_channels, aspp_dilation
        self.dtype = dtype
        self.use_mask, self.fuse_mode = use_mask, fuse_mode
        if map_to_bev is not None:
            self.map_to_bev = map_to_bev
        self.serial = use_aspp and aspp_dilations is None
        self.branches = ()
        if use_aspp and aspp_dilations is not None:
            dcn = tuple(use_dcn) if use_dcn else (False,) * len(aspp_dilations)
            if len(dcn) != len(aspp_dilations):
                raise ValueError(f"USE_DCN has {len(dcn)} entries for {len(aspp_dilations)} "
                                 "ASPP_DIAL branches (the reference asserts equal lengths)")
            self.branches = tuple((int(dial), bool(dc)) for dial, dc in zip(aspp_dilations, dcn))
            for i, (dial, dc) in enumerate(self.branches):
                if dc:
                    setattr(self, f"aspp_dcn{i}", ModulatedDeformConv2d(
                        c, c, 1 if dial == 1 else 3, dilation=dial, dtype=dtype))
                elif dial == 1:
                    setattr(self, f"aspp_branch{i}", nn.Conv2d(c, c, 1, bias=False))
                else:
                    setattr(self, f"aspp_branch{i}",
                            nn.Conv2d(c, c, 3, padding=dial, dilation=dial, bias=False))
                setattr(self, f"aspp_branch_bn{i}", nn.BatchNorm2d(c))
            self.aspp_fuse = nn.Conv2d(len(self.branches) * c, c, 1, bias=False)
            self.aspp_fuse_bn = nn.BatchNorm2d(c)
        serial = ([nn.Conv2d(c, c, 1, bias=False), nn.BatchNorm2d(c), nn.ReLU(),
                   nn.Conv2d(c, c, 3, padding=d, dilation=d, bias=False), nn.BatchNorm2d(c),
                   nn.ReLU()] if self.serial else [nn.Identity() for _ in range(6)])
        self.pred_occupancy = nn.Sequential(
            *serial,
            nn.Conv2d(c, c // 2, 3, padding=1, bias=True), nn.BatchNorm2d(c // 2), nn.ReLU(),
            nn.Conv2d(c // 2, 1, 3, padding=1, bias=True))
        if fuse_mode == "SE" and not use_mask:
            self.se = SEBlock(2 * c)
            self.se_squeeze_conv = nn.Conv2d(2 * c, c, 1, bias=True)
            self.se_squeeze_bn = nn.BatchNorm2d(c)

    def aspp(self, h, dt):
        """The parallel ASPP of (B, Y, X, C) in ``dt``."""
        out = []
        for i, (dial, dc) in enumerate(self.branches):
            if dc:
                hb = getattr(self, f"aspp_dcn{i}")(h)
            elif dial == 1:
                hb = conv_nhwc(h, getattr(self, f"aspp_branch{i}"), dt)
            else:
                hb = dilated_conv3x3(h, getattr(self, f"aspp_branch{i}").weight, dial, dt)
            out.append(torch.relu(batch_norm(hb, getattr(self, f"aspp_branch_bn{i}"), dt)))
        return torch.relu(batch_norm(conv_nhwc(torch.cat(out, dim=-1), self.aspp_fuse, dt),
                                     self.aspp_fuse_bn, dt))

    def forward(self, image_bev, radar_bev):
        """image_bev (B, Yi, Xi, C), radar_bev (B, Y, X, C) -> (gated image
        BEV (B, Y, X, C), occupancy (B, Y, X, 1) f32)."""
        if image_bev.shape[1:3] != radar_bev.shape[1:3]:
            image_bev = resize_bilinear(image_bev, radar_bev.shape[1:3])
        dt = compute_dtype(self.dtype)
        p = self.pred_occupancy
        h = radar_bev
        if self.branches:
            h = self.aspp(h, dt)
        for i in (0, 3, 6) if self.serial else (6,):
            h = torch.relu(batch_norm(conv_nhwc(h, p[i], dt), p[i + 1], dt))
        h = conv_nhwc(h, p[9], torch.float32)
        occupancy = torch.sigmoid(h)
        if self.use_mask:
            ny, nx = radar_bev.shape[1:3]
            dev = radar_bev.device
            ys = (torch.arange(ny, dtype=torch.float32, device=dev) - ny // 2)[:, None]
            xs = torch.arange(nx, dtype=torch.float32, device=dev)[None, :]
            ratio = torch.exp(div_exact(-(xs * xs + ys * ys), 2.0 * MASK_SIGMA ** 2))
            ratio = ratio[None, :, :, None]
            return image_bev * (occupancy * ratio + (1.0 - ratio)), occupancy
        if self.fuse_mode == "MUL":
            return image_bev * occupancy, occupancy
        fused = self.se(torch.cat([image_bev * occupancy, image_bev.to(torch.float32)], dim=-1))
        fused = conv_nhwc(fused, self.se_squeeze_conv, torch.float32)
        return torch.relu(batch_norm(fused, self.se_squeeze_bn, dt)), occupancy


def _rotated_bev_footprint(gt_boxes, nx: int, ny: int, pc_range, voxel_size,
                           max_half_extent: int):
    """Rotated xy footprint of the gt boxes on the BEV voxel grid.

    Per box, integer voxel offsets dx, dy in [-d, d) (d = floor(half-dim /
    voxel)) are rotated by the heading (x toward y), floored, shifted by the
    floored center voxel and clamped into the grid; a static (2K)^2 offset
    grid with a per-box membership mask (K = ``max_half_extent``). Returns
    (px, py, osel): (B, M, P) x/y voxel indices and the bool mask of the
    real (in-extent, valid-box) offsets.
    """
    k = max_half_extent
    dev = gt_boxes.device
    vox = device_constant(tuple(voxel_size[:2]), torch.float32, dev)
    low = device_constant(tuple(pc_range[:2]), torch.float32, dev)
    center = torch.floor((gt_boxes[..., 0:2] - low) / vox)  # (B, M, 2)
    halfdim = torch.floor(gt_boxes[..., 3:5] / 2.0 / vox)
    heading = gt_boxes[..., 6]
    valid = gt_boxes[..., -1] > 0

    offs = torch.arange(-k, k, dtype=torch.float32, device=dev)
    dxg, dyg = torch.meshgrid(offs, offs, indexing="ij")
    dxg, dyg = dxg.reshape(-1), dyg.reshape(-1)  # (P,)
    in_x = (dxg >= -halfdim[..., 0:1]) & (dxg < halfdim[..., 0:1])
    in_y = (dyg >= -halfdim[..., 1:2]) & (dyg < halfdim[..., 1:2])
    osel = in_x & in_y & valid[..., None]  # (B, M, P)

    cosa = torch.cos(heading)[..., None]
    sina = torch.sin(heading)[..., None]
    rx = torch.floor(dxg * cosa - dyg * sina)
    ry = torch.floor(dxg * sina + dyg * cosa)
    px = torch.clamp(center[..., 0:1] + rx, 0, nx - 1).to(torch.int64)
    py = torch.clamp(center[..., 1:2] + ry, 0, ny - 1).to(torch.int64)
    return px, py, osel


def rasterize_gt_boxes_bev(gt_boxes, grid_size, pc_range, voxel_size,
                           max_half_extent: int = 48):
    """Binary BEV occupancy target (B, ny, nx) f32 of the gt boxes (B, M, 8);
    a box's footprint is limited to +/- ``max_half_extent`` voxels per axis."""
    nx, ny = int(grid_size[0]), int(grid_size[1])
    px, py, osel = _rotated_bev_footprint(gt_boxes, nx, ny, pc_range, voxel_size,
                                          max_half_extent)
    flat = torch.where(osel, py * nx + px, torch.full_like(px, nx * ny))  # dump slot
    b = gt_boxes.shape[0]
    tgt = torch.zeros((b, nx * ny + 1), dtype=torch.float32, device=gt_boxes.device)
    tgt.scatter_(1, flat.reshape(b, -1), 1.0)
    return tgt[:, :nx * ny].reshape(b, ny, nx)


def binary_focal_loss(probs, labels, alpha: float = 0.25, gamma: float = 2.0,
                      eps: float = 1e-7):
    """Mean binary focal loss on probabilities."""
    loss_pos = -alpha * torch.pow(1 - probs, gamma) * torch.log(probs + eps) * labels
    loss_neg = -(1 - alpha) * torch.pow(probs, gamma) * torch.log(1 - probs + eps) * (1 - labels)
    return torch.mean(loss_pos + loss_neg)


def occupancy_loss(occupancy, gt_boxes, grid_size, pc_range, voxel_size,
                   max_half_extent: int = 32):
    """Focal loss of the predicted occupancy (B, ny, nx, 1) against the
    rasterized gt boxes."""
    target = rasterize_gt_boxes_bev(gt_boxes, grid_size, pc_range, voxel_size, max_half_extent)
    return binary_focal_loss(occupancy[..., 0], target)
