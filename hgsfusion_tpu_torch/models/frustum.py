"""Image -> voxel frustum view transform (multi-scale grid sampling).

Counterpart of ``hgsfusion_tpu/models/frustum.py`` for the path the
HGSFusion VoD configs run under either ``F2V.SAMPLER_KERNEL`` (``xla``, the
default, or ``pallas``): FUSE_MODE CONCAT, USE_DEPTH False, same-resolution
taps grouped into one gather, each group sampled by the ``quad_sample_fwd``
kernel and reduced by a matmul into an f32 accumulator (the 1x1x1 Conv3d of
the reference), cast to the compute dtype, then BN and ReLU. Where no
gradient is taken, the taps, the samples, the reduce and the cast are one
``quad_sample_reduce_fwd`` launch on the unpadded maps.

With USE_DEPTH False the reference samples a D=1 volume where
align_corners=True collapses any depth coordinate onto plane 0, so the
transform is a per-voxel 2-D bilinear sample of (u, v).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops.quad_sample import (grid_sample_2d_quad_kernel, quad_sample_reduce_fwd,
                               quad_sample_reduce_plain)
from ..utils.common import device_constant
from .layers import batch_norm, compute_dtype, matmul_f32


def bin_depths(depth, mode: str, depth_min: float, depth_max: float, num_bins: int):
    """Continuous depth-bin index (transform_utils.bin_depths, target=False)."""
    if mode == "UD":
        bin_size = (depth_max - depth_min) / num_bins
        return (depth - depth_min) / bin_size
    if mode == "LID":
        bin_size = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
        return -0.5 + 0.5 * torch.sqrt(1 + 8 * (depth - depth_min) / bin_size)
    if mode == "SID":
        return (num_bins * (torch.log(1 + depth) - math.log(1 + depth_min))
                / (math.log(1 + depth_max) - math.log(1 + depth_min)))
    raise NotImplementedError(mode)


class FrustumGridGenerator:
    """Builds the (B, Y, X, Z, 3) normalized frustum sampling grid, last dim
    (u, v, depth_bin) in [-1, 1], non-finite entries set to -2."""

    def __init__(self, grid_size, pc_range, disc_cfg, bev_aug: bool = False):
        self.nx, self.ny, self.nz = (int(g) for g in grid_size)
        self.pc_range = tuple(float(v) for v in pc_range)
        self.disc_cfg = dict(disc_cfg)
        self.bev_aug = bev_aug

    def lidar_grid(self, device):
        """Voxel-center lidar coordinates, (Y, X, Z, 3)."""
        pc_min = device_constant(self.pc_range[:3], torch.float32, device)
        pc_max = device_constant(self.pc_range[3:], torch.float32, device)
        n = device_constant((self.nx, self.ny, self.nz), torch.float32, device)
        voxel = (pc_max - pc_min) / n
        ix = torch.arange(self.nx, dtype=torch.float32, device=device) + 0.5
        iy = torch.arange(self.ny, dtype=torch.float32, device=device) + 0.5
        iz = torch.arange(self.nz, dtype=torch.float32, device=device) + 0.5
        gy, gx, gz = torch.meshgrid(iy, ix, iz, indexing="ij")
        return torch.stack([gx, gy, gz], dim=-1) * voxel + pc_min

    def __call__(self, lidar_to_cam, cam_to_img, image_shape, bda=None):
        """lidar_to_cam (B,4,4), cam_to_img (B,3,4), image_shape (H, W),
        bda (B,4,4) lidar augmentation matrix -> (B, Y, X, Z, 3)."""
        b = lidar_to_cam.shape[0]
        grid = self.lidar_grid(lidar_to_cam.device)
        pts = grid[None].expand((b,) + grid.shape)
        if self.bev_aug:
            if bda is None:
                raise ValueError(
                    "BEV_AUG is enabled but the batch has no lidar_aug_matrix "
                    "— sampling would silently use the augmented (misaligned) "
                    "voxel positions")
            inv_bda = torch.linalg.inv_ex(bda).inverse  # no host read of the check
            pts = (torch.einsum("byxzi,bji->byxzj", pts, inv_bda[:, :3, :3])
                   + inv_bda[:, None, None, None, :3, 3])
        cam = (torch.einsum("byxzi,bji->byxzj", pts, lidar_to_cam[:, :3, :3])
               + lidar_to_cam[:, None, None, None, :3, 3])
        p = (torch.einsum("byxzi,bji->byxzj", cam, cam_to_img[:, :, :3])
             + cam_to_img[:, None, None, None, :, 3])
        depth = p[..., 2] - cam_to_img[:, 2, 3][:, None, None, None]
        uv = p[..., 0:2] / p[..., 2:3]
        dbin = bin_depths(depth, **self.disc_cfg)
        h, w = image_shape
        norm = device_constant((w - 1, h - 1, self.disc_cfg["num_bins"] - 1), torch.float32,
                               uv.device)
        grid = torch.cat([uv, dbin[..., None]], dim=-1) / norm * 2.0 - 1.0
        return torch.where(torch.isfinite(grid), grid, torch.full_like(grid, -2.0))


class FrustumToVoxelMultiScale(nn.Module):
    """Sample per-scale image features into the voxel grid and reduce.

    ``channel_reduce`` = (Conv3d 1x1x1 with bias, BatchNorm3d), the
    reference's names. The Conv3d is applied as a sum of per-group matmuls
    into an f32 accumulator, so the (B, Y, X, Z, sum C) concat volume is
    never built.
    """

    def __init__(self, in_channels, out_channels: int = 128,
                 fuse_mode: str = "CONCAT", dtype=None, quant: str = "none",
                 sampler_kernel: str = "pallas", use_depth: bool = False):
        super().__init__()
        # refuse loudly what the port does not run: the int8 payload and the
        # USE_DEPTH / ADD paths are later slices. The JAX package's two
        # samplers (XLA and Pallas) have the same numerics, so both run the
        # quad_sample_fwd kernel here
        if quant != "none":
            raise ValueError(
                f"F2V.QUANT: {quant} is not ported: the quad_sample_fwd kernel "
                "path is bf16-payload (int8 is ROADMAP queue 1 item 6)")
        if use_depth or fuse_mode != "CONCAT":
            raise NotImplementedError(
                "the port's view transform covers the CONCAT grouped-quad "
                "path only (not USE_DEPTH / FUSE_MODE ADD)")
        if sampler_kernel not in ("xla", "pallas"):
            raise NotImplementedError(f"F2V.SAMPLER_KERNEL: {sampler_kernel}")
        self.in_channels = tuple(int(c) for c in in_channels)
        self.dtype = dtype
        self.channel_reduce = nn.Sequential(
            nn.Conv3d(sum(self.in_channels), out_channels, 1, bias=True),
            nn.BatchNorm3d(out_channels))

    def forward(self, features, grid):
        """features: list of (B, Hi, Wi, Ci); grid (B, Y, X, Z, 3) ->
        (B, Y, X, Z, out_channels) in the compute dtype."""
        cdt = compute_dtype(self.dtype)
        vox = self.accumulate(features, grid)
        return torch.relu_(batch_norm(vox.to(cdt), self.channel_reduce[1], cdt))

    def accumulate(self, features, grid):
        """The accumulator before the BN: the Conv3d bias plus, for each
        gather group, its sampled features (compute dtype) times its kernel
        rows (compute dtype), each product reaching the f32 sum unrounded.

        Where no gradient is taken (serving, evaluation) all groups go
        through one ``quad_sample_reduce_fwd`` launch (its plain version on
        CPU tensors), which reads the grid's (u, v) in place and the unpadded
        maps, and returns the sum rounded once to the compute dtype: no
        padded map, no tap indices and no sampled features reach memory.
        Otherwise each group is sampled by ``grid_sample_2d_quad_kernel``,
        which keeps what its backward needs, and reduced by ``matmul_f32``
        into an f32 accumulator."""
        cdt = compute_dtype(self.dtype)
        conv = self.channel_reduce[0]
        kernel = conv.weight.reshape(conv.weight.shape[0], -1).t()  # (sum C, O)
        uv = grid[..., 0:2]
        # same-resolution maps share one gather (layers 2-4 all live at /8)
        groups = []
        off = 0
        for f in features:
            if groups and groups[-1][0][0].shape[1:3] == f.shape[1:3]:
                groups[-1][0].append(f)
            else:
                groups.append(([f], off))
            off += f.shape[-1]
        groups = [(torch.cat([t.to(cdt) for t in fs], dim=-1) if len(fs) > 1 else fs[0].to(cdt),
                   k_off) for fs, k_off in groups]
        out_shape = uv.shape[:-1] + (kernel.shape[1],)
        needs_grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (*features, conv.weight, conv.bias))
        if not needs_grad:
            reduce = quad_sample_reduce_fwd if uv.is_cuda else quad_sample_reduce_plain
            return reduce(uv, [(f.contiguous(), k_off) for f, k_off in groups],
                          kernel.to(cdt).contiguous(),
                          conv.bias.to(torch.float32)).view(out_shape)
        vox = conv.bias.to(torch.float32).expand(out_shape).clone()
        flat = vox.view(-1, kernel.shape[1])
        for f, k_off in groups:
            cg = f.shape[-1]
            sampled = grid_sample_2d_quad_kernel(f, uv)  # (B, Y, X, Z, cg)
            flat.add_(matmul_f32(sampled.reshape(-1, cg), kernel[k_off:k_off + cg].to(cdt)))
        return vox
