"""The focal sparse convolution, its auxiliary loss and VoxelBackBone8xFocal,
dense-masked.

Counterpart of ``hgsfusion_tpu/models/focal_conv.py`` (``_kernel_offsets``,
``_shift``, ``FocalSparseConv3D``, ``focal_conv_loss``,
``VoxelBackBone8xFocal``; lidar only, as there). A focal convolution is a
submanifold convolution whose active set grows at the voxels its
importance head marks as foreground: a 27-channel head scores each voxel
(its last channel) and its 26 neighbours; the foreground voxels (the top
``threshold`` share of the active ones by their own score, or those above
``threshold``) spawn the neighbours they score at ``threshold`` or more as
new active sites before the main convolution runs. As in JAX:

- the foreground is ``score >= k-th score`` over the active sites, k =
  floor(count * threshold), and nothing when k is 0;
- a dilation target needs an index above 0 on every axis (the reference's
  strict ``> 0``);
- where several land on one site the new features are zeros and the kernel
  multiplier is the mean of the landed scores (an original foreground site
  adds 1 and counts once), its denominator clamped to 1.

Both convolutions are ``conv3d_ndhwc`` (``voxel_backbone.py``), so their
weight gradients stay one product a kernel tap. Parameter names:
``conv_imp``, ``conv`` (spconv (O, kD, kH, kW, I) layout) and ``bn1``;
``VoxelBackBone8xFocal`` is VoxelBackBone8x's tree with ``focal1`` ..
``focal3`` closing stages 1-3.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.points_in_boxes import points_in_boxes
from ..ops.pointnet2 import affine_axis
from .layers import MaskedBatchNorm, compute_dtype
from .voxel_backbone import SparseConv3d, VoxelBackBone8x, _refuse_shallow


def kernel_offsets():
    """The 26 neighbour offsets (dz, dy, dx) of a 3 x 3 x 3 kernel, z-major,
    the centre left out: the importance head's channel order."""
    rng = range(-1, 2)
    return [(i, j, m) for i in rng for j in rng for m in rng if (i, j, m) != (0, 0, 0)]


def shift(v, off):
    """shifted[t] = v[t - off], zeros where t - off leaves the volume; v is
    (B, D, H, W, C)."""
    dz, dy, dx = off
    d, h, w = v.shape[1:4]
    p = torch.nn.functional.pad(v, (0, 0, 1, 1, 1, 1, 1, 1))
    return p[:, 1 - dz:1 - dz + d, 1 - dy:1 - dy + h, 1 - dx:1 - dx + w]


class FocalSparseConv3D(nn.Module):
    """The lidar-only focal convolution: (x (B, D, H, W, I), mask (B, D,
    H, W, 1)) -> (features (B, D, H, W, O), the grown mask, aux), aux the
    importance sigmoid of the active voxels (``mask_voxel``, 0 elsewhere),
    the input's active set and ``voxel_stride``, for ``focal_conv_loss``."""

    def __init__(self, in_channels: int, features: int, voxel_stride: int = 1,
                 threshold: float = 0.5, topk: bool = True, mask_multi: bool = False,
                 skip_mask_kernel: bool = False, dtype=None):
        super().__init__()
        self.voxel_stride, self.threshold, self.topk = voxel_stride, threshold, topk
        self.mask_multi, self.skip_mask_kernel, self.dtype = mask_multi, skip_mask_kernel, dtype
        self.conv_imp = SparseConv3d(in_channels, 27)
        self.conv = SparseConv3d(in_channels, features)
        self.bn1 = MaskedBatchNorm(features, eps=1e-3, momentum=0.01)

    def foreground(self, mv, active):
        """The foreground sites of (B, D, H, W) importances ``mv`` (0 off
        the active set) by the top-k or the threshold rule."""
        if not self.topk:
            return active & (mv > self.threshold)
        b = mv.shape[0]
        flat, act = mv.reshape(b, -1), active.reshape(b, -1)
        n_fore = (act.sum(1).to(torch.float32) * self.threshold).to(torch.int32)
        kth = torch.clamp(n_fore - 1, min=0).long()
        ranked = torch.sort(torch.where(act, flat, torch.full_like(flat, -1.0)), dim=1,
                            descending=True).values
        kth_val = torch.take_along_dim(ranked, kth[:, None], dim=1)
        return (act & (flat >= kth_val) & (n_fore[:, None] > 0)).reshape(active.shape)

    def forward(self, x, mask):
        dt = compute_dtype(self.dtype)
        m = mask.to(x.dtype)
        imps = self.conv_imp(x * m, dt) * mask.to(dt)
        imps = torch.sigmoid(imps.float())
        active = mask[..., 0]
        mv = torch.where(active, imps[..., -1], torch.zeros((), device=x.device))
        fore = self.foreground(mv, active)
        feats = x * m
        if self.mask_multi:
            feats = feats * imps[..., -1:].to(feats.dtype)
        interior = torch.zeros(active.shape[1:4], dtype=torch.float32, device=x.device)
        interior[1:, 1:, 1:] = 1.0
        interior = interior[None, ..., None]
        fore_f = fore[..., None].to(torch.float32)
        land_sum, land_cnt = fore_f, fore_f
        dilated = torch.zeros_like(fore)
        for j, off in enumerate(kernel_offsets()):
            imp_j = imps[..., j:j + 1]
            sel = fore_f * (imp_j >= self.threshold).to(torch.float32)
            landed = shift(sel, off) * interior
            land_sum = land_sum + shift(sel * imp_j, off) * interior
            land_cnt = land_cnt + landed
            dilated = dilated | (landed[..., 0] > 0)
        kernel_avg = torch.where(land_cnt > 0, land_sum / torch.clamp(land_cnt, min=1.0),
                                 torch.ones((), device=x.device))
        if not self.skip_mask_kernel:
            feats = torch.where(fore[..., None], feats * kernel_avg.to(feats.dtype), feats)
        new_mask = (active | dilated)[..., None]
        nm = new_mask.to(dt)
        y = self.conv(feats, dt) * nm
        y = torch.relu(self.bn1(y, new_mask)) * nm
        return y, new_mask, {"mask_voxel": mv, "active": active,
                             "voxel_stride": self.voxel_stride}


def _corner_targets(active_shape, stride: int, gt_boxes, pc_range, voxel_size,
                    max_pairs: int = 1 << 24):
    """(B, D, H, W) bool: each cell's corner (index * voxel * stride + range
    min, no half-cell shift) inside any real gt box (dx > 0) of its frame,
    the boxes taken a chunk at a time so that a chunk tests at most
    ``max_pairs`` (box, corner) pairs."""
    b, d, h, w = active_shape
    dev = gt_boxes.device
    axes = [affine_axis(torch.arange(n, device=dev) * stride, voxel_size[axis], 1,
                        pc_range[axis]) for n, axis in zip((d, h, w), (2, 1, 0))]
    zz, yy, xx = torch.meshgrid(*axes, indexing="ij")
    pts = torch.stack([xx, yy, zz], dim=-1).reshape(-1, 3)
    step = max(1, max_pairs // pts.shape[0])
    out = []
    for f in range(b):
        boxes = gt_boxes[f, :, :7].float()
        real = gt_boxes[f, :, 3] > 0
        hit = torch.zeros(pts.shape[0], dtype=torch.bool, device=dev)
        for s in range(0, boxes.shape[0], step):
            inside = points_in_boxes(pts, boxes[s:s + step]) & real[s:s + step, None]
            hit = hit | inside.any(dim=0)
        out.append(hit)
    return torch.stack(out).reshape(b, d, h, w)


def focal_conv_loss(aux_list, gt_boxes, pc_range, voxel_size):
    """The auxiliary focal loss of the importance sigmoids: target = the
    cell corner lies in a gt box; the probabilities [1 - mv, mv] through a
    second softmax (the reference's), clamped to [1e-7, 1 - 1e-7], CE x
    (1 - p)^2, over twice the active count, summed over the focal layers."""
    gamma, eps = 2.0, 1e-7
    total = gt_boxes.new_zeros((), dtype=torch.float32)
    for aux in aux_list:
        mv, active = aux["mask_voxel"], aux["active"]
        tgt = _corner_targets(active.shape, aux["voxel_stride"], gt_boxes, pc_range,
                              voxel_size).to(torch.float32)
        logit = torch.softmax(torch.stack([1.0 - mv, mv], dim=-1), dim=-1)
        logit = torch.clamp(logit, eps, 1.0 - eps)
        y = torch.stack([1.0 - tgt, tgt], dim=-1)
        ce = -y * torch.log(logit) * (1.0 - logit) ** gamma
        n = torch.clamp(active.sum(), min=1).to(torch.float32)
        total = total + (ce * active[..., None].to(ce.dtype)).sum() / (2.0 * n)
    return total


class VoxelBackBone8xFocal(VoxelBackBone8x):
    """VoxelBackBone8x with a focal convolution closing stages 1-3
    (``focal1`` 16 wide at stride 1, ``focal2`` 32 at 2, ``focal3`` 64 at
    4). forward -> (features, mask, stages, aux_list); ``stages`` maps
    x_conv1 .. x_conv4 to (features, mask, stride) after the focal layers,
    ``aux_list`` feeds ``focal_conv_loss``. Refuses fewer than 25
    z-planes, as JAX."""

    def __init__(self, in_channels: int, topk: bool = True, threshold: float = 0.5,
                 mask_multi: bool = False, skip_mask_kernel: bool = False, dtype=None):
        super().__init__(in_channels, dtype)
        for i, (ch, stride) in enumerate(((16, 1), (32, 2), (64, 4)), start=1):
            setattr(self, f"focal{i}", FocalSparseConv3D(
                ch, ch, stride, threshold=threshold, topk=topk, mask_multi=mask_multi,
                skip_mask_kernel=skip_mask_kernel, dtype=dtype))

    def forward(self, x, mask):
        _refuse_shallow("VoxelBackBone8xFocal", x)
        aux_list, stages = [], {}
        x, mask = self.conv_input(x, mask)
        for i, stage in enumerate((self.conv1, self.conv2, self.conv3, self.conv4), start=1):
            x, mask = stage(x, mask)
            if i < 4:
                x, mask, aux = getattr(self, f"focal{i}")(x, mask)
                aux_list.append(aux)
            stages[f"x_conv{i}"] = (x, mask, 2 ** (i - 1))
        x, mask = self.conv_out(x, mask)
        return x, mask, stages, aux_list
