"""The SECOND-family 3-D voxel backbone: sparse convolutions as dense masked
3-D convolutions, the voxel mean of the points, and the height compression.

Counterpart of ``hgsfusion_tpu/models/voxel_backbone.py``
(``points_to_voxel_ids``, ``mean_vfe``, ``_SubMConvBN3D``,
``_SparseDown3D``, ``VoxelBackBone8x``, ``height_compression``). As there:

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
Parameter names are the reference pcdet ``VoxelBackBone8x``'s
(``conv_input``, ``conv1``, ``conv2`` .. ``conv4``, ``conv_out``; each
block's ``0`` is the convolution, ``1`` its BatchNorm), the weights in
spconv's (O, kD, kH, kW, I) layout.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.common import device_constant
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
    and counts by ``index_add_`` in f32."""
    nx, ny, nz = grid_size
    b, n, c = points.shape
    ids, in_grid = points_to_voxel_ids(points, valid, pc_range, voxel_size, grid_size)
    cells = (nz + 1) * ny * nx  # the top plane stays empty; slot ``cells`` takes the rest
    ids = torch.where(in_grid, ids, torch.full_like(ids, cells))
    flat = (ids + torch.arange(b, device=ids.device)[:, None] * (cells + 1)).reshape(-1)
    m = in_grid.to(torch.float32).reshape(-1)
    fsum = torch.zeros((b * (cells + 1), c), dtype=torch.float32, device=points.device)
    fsum.index_add_(0, flat, points.reshape(-1, c).float() * m[:, None])
    cnt = torch.zeros(b * (cells + 1), dtype=torch.float32, device=points.device)
    cnt.index_add_(0, flat, m)
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
    layout, applied densely to a (B, D, H, W, I) volume."""

    def __init__(self, in_channels: int, out_channels: int, kernel=(3, 3, 3), stride=(1, 1, 1),
                 padding=(1, 1, 1)):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.weight = nn.Parameter(torch.empty((out_channels,) + tuple(kernel) + (in_channels,)))
        self.bias = None

    def forward(self, x, dtype):
        return conv3d_ndhwc(x.to(dtype), self.weight.to(dtype), self.stride, self.padding)


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
    (features (B, D', H/8, W/8, 128), mask). Refuses fewer than 25
    z-planes, as JAX: the four stride-2 z-downsamples would collapse depth
    to 0."""

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

    def forward(self, x, mask):
        if x.shape[1] < 25:
            raise ValueError(
                f"VoxelBackBone8x needs >= 25 z-planes (got {x.shape[1]}): the four stride-2 "
                "z-downsamples otherwise collapse depth to 0. Use a finer VOXEL_SIZE z "
                "(reference KITTI: 41 planes).")
        x, mask = self.conv_input(x, mask)
        for stage in (self.conv1, self.conv2, self.conv3, self.conv4):
            x, mask = stage(x, mask)
        return self.conv_out(x, mask)


def height_compression(x):
    """(B, D, H, W, C) -> (B, H, W, C D) BEV features, channel c D + d, as
    HeightCompression's view of (B, C, D, H, W)."""
    b, d, h, w, c = x.shape
    return x.permute(0, 2, 3, 4, 1).reshape(b, h, w, c * d)
