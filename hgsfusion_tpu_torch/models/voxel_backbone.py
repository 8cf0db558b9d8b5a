"""The SECOND-family 3-D voxel backbones: sparse convolutions as dense
masked 3-D convolutions, the voxel mean of the points, and the height
compression.

Counterpart of ``hgsfusion_tpu/models/voxel_backbone.py``
(``points_to_voxel_ids``, ``mean_vfe``, ``_SubMConvBN3D``,
``_SparseDown3D``, ``VoxelBackBone8x``, ``_SparseBasicBlock3D``,
``_place_strided``, ``VoxelResBackBone8xVoxelNeXt``,
``height_compression``). As there:

- a submanifold convolution is a dense 3x3x3 convolution of the masked
  volume, re-masked to the input's active set;
- a strided sparse convolution is a dense strided convolution whose active
  set is the max-pool dilation of the old one (``F.max_pool3d`` of the mask);
- spconv's BatchNorm1d over the active rows is ``MaskedBatchNorm`` (eps
  1e-3, momentum 0.01).

The convolutions are ``F.conv3d`` on permuted NCDHW views of the
channels-last (B, D, H, W, C) volumes, as the JAX package runs ``nn.Conv``;
their input gradient is cuDNN's, their weight gradient one product a kernel
tap (``conv3d_ndhwc``): cuDNN's f32 3-D weight gradient took 180-250 ms a
convolution on the 51 x 320 x 320 grid (``compare_conv3d_layout.py``).
A bias is added outside it. Parameter names are the reference pcdet
``VoxelBackBone8x``'s (``conv_input``, ``conv1``, ``conv2`` .. ``conv4``,
``conv_out``; each block's ``0`` is the convolution, ``1`` its BatchNorm)
and ``VoxelResBackBone8xVoxelNeXt``'s (``conv_input``; ``conv1`` two
residual blocks ``conv1``/``bn1``/``conv2``/``bn2``; ``conv2`` .. ``conv6``
a strided block then two residual ones; ``conv_out`` and ``shared_conv``
the 2-D sparse conv and its BN), the weights in spconv's (O, kD, kH, kW, I)
or (O, kH, kW, I) layout.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.common import device_constant
from .bev_encoder import SparseConv2d
from .layers import MaskedBatchNorm, compute_dtype


def points_to_voxel_ids(points, valid, pc_range, voxel_size, grid_size: Tuple[int, int, int]):
    """Point -> flat 3-D voxel id (B, N) int64, iz (ny nx) + iy nx + ix (a
    reshape to (nz, ny, nx) is the depth-major layout), and the in-grid
    mask; an invalid or out-of-grid point gets nx ny nz."""
    nx, ny, nz = grid_size
    lo = device_constant(tuple(pc_range[:3]), points.dtype, points.device)
    size = device_constant(tuple(voxel_size), points.dtype, points.device)
    ijk = torch.floor((points[..., :3] - lo) / size).to(torch.int32).long()
    ix, iy, iz = ijk.unbind(-1)
    in_grid = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) & (iz >= 0) & (iz < nz) & valid
    flat = (iz * ny + iy) * nx + ix
    return torch.where(in_grid, flat, torch.full_like(flat, nx * ny * nz)), in_grid


def mean_vfe(points, valid, pc_range, voxel_size, grid_size: Tuple[int, int, int]):
    """MeanVFE: the mean of each voxel's point features in a dense (B, D, H,
    W, C) volume and its active mask (B, D, H, W, 1) bool, D = nz + 1 (the
    empty top plane spconv's sparse shape adds). A plain scatter: the sums
    and counts in f32 by ``index_put_`` with ``accumulate``, which on the
    card sorts the voxel ids stably and sums each voxel's points in point
    order, as the CPU does, so a frame's volume is the same bits in every
    process (``index_add_``'s atomics would add them in any order)."""
    nx, ny, nz = grid_size
    b, n, c = points.shape
    ids, in_grid = points_to_voxel_ids(points, valid, pc_range, voxel_size, grid_size)
    cells = (nz + 1) * ny * nx  # the top plane stays empty; slot ``cells`` takes the rest
    ids = torch.where(in_grid, ids, torch.full_like(ids, cells))
    flat = (ids + torch.arange(b, device=ids.device)[:, None] * (cells + 1)).reshape(-1)
    m = in_grid.to(torch.float32).reshape(-1)
    fsum = torch.zeros((b * (cells + 1), c), dtype=torch.float32, device=points.device)
    fsum.index_put_((flat,), points.reshape(-1, c).float() * m[:, None], accumulate=True)
    cnt = torch.zeros(b * (cells + 1), dtype=torch.float32, device=points.device)
    cnt.index_put_((flat,), m, accumulate=True)
    fsum = fsum.view(b, cells + 1, c)[:, :cells]
    cnt = cnt.view(b, cells + 1)[:, :cells]
    dense = (fsum / torch.clamp(cnt, min=1.0)[..., None]).to(points.dtype)
    return dense.reshape(b, nz + 1, ny, nx, c), (cnt > 0).reshape(b, nz + 1, ny, nx, 1)


class _Conv3dNDHWC(torch.autograd.Function):
    """``F.conv3d`` of a (B, D, H, W, I) volume by an (O, kD, kH, kW, I)
    weight, no bias; the weight's gradient as one (O, N) x (N, I) product a
    kernel tap over the padded input's strided view."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(0, 4, 1, 2, 3), None, stride, padding)
        return y.permute(0, 2, 3, 4, 1)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding = ctx.stride, ctx.padding
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv3d_input(
                x.permute(0, 4, 1, 2, 3).shape, w.permute(0, 4, 1, 2, 3),
                gy.permute(0, 4, 1, 2, 3), stride, padding).permute(0, 2, 3, 4, 1)
        if ctx.needs_input_grad[1]:
            (pz, py, px), (sz, sy, sx) = padding, stride
            xp = F.pad(x, (0, 0, px, px, py, py, pz, pz))
            _, do, ho, wo, o = gy.shape
            g2 = gy.reshape(-1, o).t()
            gw = torch.empty_like(w)
            for kz in range(w.shape[1]):
                for ky in range(w.shape[2]):
                    for kx in range(w.shape[3]):
                        xs = xp[:, kz:kz + sz * (do - 1) + 1:sz, ky:ky + sy * (ho - 1) + 1:sy,
                                kx:kx + sx * (wo - 1) + 1:sx]
                        gw[:, kz, ky, kx] = g2 @ xs.reshape(-1, x.shape[-1])
        return gx, gw, None, None


def conv3d_ndhwc(x, w, stride, padding):
    """``x`` (B, D, H, W, I) convolved with ``w`` (O, kD, kH, kW, I), both
    in one dtype -> (B, D', H', W', O); differentiable in both (the weight's
    gradient by taps, ``_Conv3dNDHWC``)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv3dNDHWC.apply(x, w, tuple(stride), tuple(padding))
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(0, 4, 1, 2, 3), None, stride, padding)
    return y.permute(0, 2, 3, 4, 1)


class SparseConv3d(nn.Module):
    """A 3-D sparse convolution's weight in spconv's (O, kD, kH, kW, I)
    layout (and its bias, where it has one), applied densely to a (B, D, H,
    W, I) volume."""

    def __init__(self, in_channels: int, out_channels: int, kernel=(3, 3, 3), stride=(1, 1, 1),
                 padding=(1, 1, 1), bias: bool = False):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.weight = nn.Parameter(torch.empty((out_channels,) + tuple(kernel) + (in_channels,)))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x, dtype):
        y = conv3d_ndhwc(x.to(dtype), self.weight.to(dtype), self.stride, self.padding)
        return y if self.bias is None else y + self.bias.to(dtype)


class _ConvBN3D(nn.Sequential):
    """``0``: the convolution, ``1``: its masked BatchNorm; conv -> BN ->
    ReLU, every step re-masked. A stride or a kernel other than 3x3x3 makes
    it the growing (strided) kind: its active set is the max-pool dilation
    of the input's."""

    def __init__(self, in_channels: int, features: int, kernel=(3, 3, 3), stride=(1, 1, 1),
                 padding=(1, 1, 1), dtype=None):
        super().__init__(SparseConv3d(in_channels, features, kernel, stride, padding),
                         MaskedBatchNorm(features, eps=1e-3, momentum=0.01))
        self.dtype = dtype
        self.subm = tuple(kernel) == (3, 3, 3) and tuple(stride) == (1, 1, 1)

    def forward(self, x, mask):
        conv = self[0]
        dt = compute_dtype(self.dtype)
        y = conv(x * mask.to(x.dtype), dt)
        if not self.subm:
            mask = F.max_pool3d(mask.to(torch.float32).permute(0, 4, 1, 2, 3),
                                tuple(conv.weight.shape[1:4]), conv.stride,
                                conv.padding).permute(0, 2, 3, 4, 1) > 0
        m = mask.to(y.dtype)
        y = self[1](y * m, mask)
        return torch.relu(y) * m, mask


class _Stage(nn.Sequential):
    """A stage's blocks (``0``, ``1``, ...; pcdet's post_act_blocks) in order."""

    def forward(self, x, mask):
        for block in self:
            x, mask = block(x, mask)
        return x, mask


class VoxelBackBone8x(nn.Module):
    """16 -> 16 -> 32/s2 -> 64/s2 -> 64/s2 (z padding 0) -> 128, the z axis
    collapsing 2x once more: (B, D, H, W, C) + (B, D, H, W, 1) mask ->
    (features (B, D', H/8, W/8, 128), mask), and with ``with_stages`` also
    the stages as JAX returns them: x_conv1 .. x_conv4 -> (features, mask,
    stride 1, 2, 4, 8), the multi-scale taps a two-stage head pools from.
    Refuses fewer than 25 z-planes, as JAX: the four stride-2
    z-downsamples would collapse depth to 0."""

    def __init__(self, in_channels: int, dtype=None):
        super().__init__()
        self.conv_input = _ConvBN3D(in_channels, 16, dtype=dtype)
        self.conv1 = _Stage(_ConvBN3D(16, 16, dtype=dtype))
        for name, cin, cout, pad in (("conv2", 16, 32, (1, 1, 1)), ("conv3", 32, 64, (1, 1, 1)),
                                     ("conv4", 64, 64, (0, 1, 1))):
            setattr(self, name, _Stage(
                _ConvBN3D(cin, cout, stride=(2, 2, 2), padding=pad, dtype=dtype),
                _ConvBN3D(cout, cout, dtype=dtype), _ConvBN3D(cout, cout, dtype=dtype)))
        self.conv_out = _ConvBN3D(64, 128, kernel=(3, 1, 1), stride=(2, 1, 1),
                                  padding=(0, 0, 0), dtype=dtype)

    def forward(self, x, mask, with_stages: bool = False):
        _refuse_shallow("VoxelBackBone8x", x)
        x, mask = self.conv_input(x, mask)
        stages = {}
        for i, stage in enumerate((self.conv1, self.conv2, self.conv3, self.conv4), start=1):
            x, mask = stage(x, mask)
            stages[f"x_conv{i}"] = (x, mask, 2 ** (i - 1))
        x, mask = self.conv_out(x, mask)
        return (x, mask, stages) if with_stages else (x, mask)


def _refuse_shallow(name: str, x):
    if x.shape[1] < 25:
        raise ValueError(
            f"{name} needs >= 25 z-planes (got {x.shape[1]}): the four stride-2 "
            "z-downsamples otherwise collapse depth to 0. Use a finer VOXEL_SIZE z "
            "(reference KITTI: 41 planes).")


class _SparseBasicBlock3D(nn.Module):
    """The residual submanifold block, (conv1 -> BN -> ReLU -> conv2 -> BN)
    + identity -> ReLU, re-masked; both convolutions with a bias (the
    reference's bias = norm_fn is not None). Called as block(x, mask) ->
    (x, mask)."""

    def __init__(self, features: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = SparseConv3d(features, features, bias=True)
        self.bn1 = MaskedBatchNorm(features, eps=1e-3, momentum=0.01)
        self.conv2 = SparseConv3d(features, features, bias=True)
        self.bn2 = MaskedBatchNorm(features, eps=1e-3, momentum=0.01)

    def forward(self, x, mask):
        dt = compute_dtype(self.dtype)
        m = mask.to(x.dtype)
        out = self.bn1(self.conv1(x * m, dt) * m, mask)
        out = torch.relu(out) * m
        out = self.bn2(self.conv2(out * m, dt) * m, mask)
        return torch.relu(out + x) * m, mask


def _place_strided(src, src_mask, target_dhw, stride: int):
    """A coarser volume (B, d, h, w, C) and its mask placed on a finer grid
    ``target_dhw`` at every ``stride``-th site, zeros elsewhere (the dense
    image of the reference's ``indices *= stride``; not an upsample); sites
    past the grid's edge are dropped."""
    d, h, w = target_dhw
    nd = min(src.shape[1], (d + stride - 1) // stride)
    nh = min(src.shape[2], (h + stride - 1) // stride)
    nw = min(src.shape[3], (w + stride - 1) // stride)
    out = src.new_zeros(src.shape[:1] + (d, h, w) + src.shape[-1:])
    m = torch.zeros(src_mask.shape[:1] + (d, h, w, 1), dtype=torch.bool, device=src.device)
    out[:, :nd * stride:stride, :nh * stride:stride, :nw * stride:stride] = src[:, :nd, :nh, :nw]
    m[:, :nd * stride:stride, :nh * stride:stride, :nw * stride:stride] = \
        src_mask.bool()[:, :nd, :nh, :nw]
    return out, m


class VoxelResBackBone8xVoxelNeXt(nn.Module):
    """The VoxelNeXt backbone: residual stages of 16, 32, 64, 128 channels
    at strides 1, 2, 4, 8 and two more stride-2 stages of 128 (``conv5``,
    ``conv6``) placed back on the stride-8 grid (``_place_strided``) and
    summed with ``conv4``; the z axis summed to BEV (its mask: any plane
    active); then ``conv_out`` (a regular sparse 3x3 2-D conv, its active
    set dilated) and ``shared_conv`` (submanifold, with a bias; BN eps 1e-5,
    momentum 0.1). (B, D, H, W, C) + mask -> (features (B, H/8, W/8,
    out_channel), mask (B, H/8, W/8, 1)). Refuses fewer than 25 z-planes,
    as JAX."""

    STAGES = (("conv2", 16, 32), ("conv3", 32, 64), ("conv4", 64, 128), ("conv5", 128, 128),
              ("conv6", 128, 128))

    def __init__(self, in_channels: int, out_channel: int = 128, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv_input = _ConvBN3D(in_channels, 16, dtype=dtype)
        self.conv1 = _Stage(_SparseBasicBlock3D(16, dtype), _SparseBasicBlock3D(16, dtype))
        for name, cin, cout in self.STAGES:
            setattr(self, name, _Stage(
                _ConvBN3D(cin, cout, stride=(2, 2, 2), dtype=dtype),
                _SparseBasicBlock3D(cout, dtype), _SparseBasicBlock3D(cout, dtype)))
        self.conv_out = nn.Sequential(SparseConv2d(128, out_channel, bias=False),
                                      MaskedBatchNorm(out_channel, eps=1e-3, momentum=0.01))
        self.shared_conv = nn.Sequential(SparseConv2d(out_channel, out_channel, bias=True),
                                         MaskedBatchNorm(out_channel, eps=1e-5, momentum=0.1))

    def forward(self, x, mask):
        _refuse_shallow("VoxelNeXt backbone", x)
        dt = compute_dtype(self.dtype)
        x, mask = self.conv_input(x, mask)
        x, mask = self.conv1(x, mask)
        feats = {}
        for name, *_ in self.STAGES:
            x, mask = getattr(self, name)(x, mask)
            feats[name] = (x, mask)
        x4, m4 = feats["conv4"]
        d4 = tuple(x4.shape[1:4])
        p5, m5 = _place_strided(*feats["conv5"], d4, 2)
        p6, m6 = _place_strided(*feats["conv6"], d4, 4)
        bev = (x4 + p5 + p6).sum(dim=1)
        bev_mask = (m4.bool() | m5 | m6).any(dim=1)
        out_mask = F.max_pool2d(bev_mask.to(torch.float32).permute(0, 3, 1, 2), 3, 1,
                                1).permute(0, 2, 3, 1) > 0
        om = out_mask.to(dt)
        y = self.conv_out[0](bev * bev_mask.to(bev.dtype), dt) * om
        y = torch.relu(self.conv_out[1](y, out_mask)) * om
        y = self.shared_conv[0](y, dt) * om
        return torch.relu(self.shared_conv[1](y, out_mask)) * om, out_mask


def height_compression(x):
    """(B, D, H, W, C) -> (B, H, W, C D) BEV features, channel c D + d, as
    HeightCompression's view of (B, C, D, H, W)."""
    b, d, h, w, c = x.shape
    return x.permute(0, 2, 3, 4, 1).reshape(b, h, w, c * d)
