"""Image -> voxel frustum view transform (multi-scale grid sampling).

Counterpart of ``hgsfusion_tpu/models/frustum.py`` under either
``F2V.SAMPLER_KERNEL`` (``xla``, the default, or ``pallas``): FUSE_MODE
CONCAT, same-resolution taps grouped into one gather, each group sampled by
a kernel and reduced by a matmul into an f32 accumulator (the 1x1x1 Conv3d
of the reference), cast to the compute dtype, then BN and ReLU.

With USE_DEPTH False the reference samples a D=1 volume where
align_corners=True collapses any depth coordinate onto plane 0, so the
transform is a per-voxel 2-D bilinear sample of (u, v): the
``quad_sample_fwd`` kernel, and where no gradient is taken the taps, the
samples, the reduce and the cast are one ``quad_sample_reduce_fwd`` launch
on the unpadded maps. With USE_DEPTH each group is sampled from its
depth-weighted frustum volume by ``quad_sample_depth_fwd``
(``ops/depth_sample.py``); layers 2-4 share one depth distribution, so their
192 channels are one sample, exact per channel, and only the order of the
f32 sums of the reduce product differs from JAX's per-scale einsum.

``REMAT`` recomputes the sample + reduce product in the backward pass
(``torch.utils.checkpoint``) instead of keeping the tap indices, weights,
bins and sampled features; the BatchNorm stays outside, so its running
statistics update once a step.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.depth_sample import grid_sample_depth_kernel
from ..ops.matmul import matmul_f32
from ..ops.quad_sample import grid_sample_2d_quad_kernel, quad_sample_reduce
from ..utils.common import device_constant
from .layers import batch_norm, compute_dtype


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
    never built. ``fuse_mode`` ADD (no parameters: the scales' samples
    summed) is held at module level only: the detector never passes a
    fuse mode, in the JAX package either, so no config reaches it.
    """

    def __init__(self, in_channels, out_channels: int = 128,
                 fuse_mode: str = "CONCAT", dtype=None, quant: str = "none",
                 sampler_kernel: str = "pallas", remat: bool = False):
        super().__init__()
        # refuse loudly what the port does not run. The JAX package's two
        # samplers (XLA and Pallas) have the same numerics, so both run the
        # same kernels here
        if quant != "none":
            raise ValueError(
                f"F2V.QUANT: {quant} is not ported: the quad_sample_fwd kernel "
                "path is bf16-payload (int8 is ROADMAP queue 1 item 6)")
        if fuse_mode not in ("CONCAT", "ADD"):
            raise NotImplementedError(f"F2V.FUSE_MODE: {fuse_mode}")
        if sampler_kernel not in ("xla", "pallas"):
            raise NotImplementedError(f"F2V.SAMPLER_KERNEL: {sampler_kernel}")
        self.in_channels = tuple(int(c) for c in in_channels)
        self.dtype = dtype
        self.fuse_mode = fuse_mode
        self.remat = remat
        if fuse_mode == "CONCAT":
            self.channel_reduce = nn.Sequential(
                nn.Conv3d(sum(self.in_channels), out_channels, 1, bias=True),
                nn.BatchNorm3d(out_channels))

    def forward(self, features, grid, depth_probs=None):
        """features: list of (B, Hi, Wi, Ci); grid (B, Y, X, Z, 3);
        depth_probs: None, or (USE_DEPTH) one (B, Hi, Wi, D) distribution per
        map, maps of one size sharing one tensor -> (B, Y, X, Z, out_channels)
        in the compute dtype (ADD: (B, Y, X, Z, C), the samples summed)."""
        cdt = compute_dtype(self.dtype)
        if self.fuse_mode == "ADD":
            if depth_probs is not None:
                return sum(grid_sample_depth_kernel(f.to(cdt), p.to(cdt), grid)
                           for f, p in zip(features, depth_probs))
            return sum(grid_sample_2d_quad_kernel(f, grid[..., 0:2]) for f in features)
        if self.remat and torch.is_grad_enabled():
            vox = checkpoint(self.accumulate, features, grid, depth_probs, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            vox = self.accumulate(features, grid, depth_probs)
        return torch.relu_(batch_norm(vox.to(cdt), self.channel_reduce[1], cdt))

    def accumulate(self, features, grid, depth_probs=None):
        """The accumulator before the BN: the Conv3d bias plus, for each
        gather group, its sampled features (compute dtype) times its kernel
        rows (compute dtype), each product reaching the f32 sum unrounded.

        Without depth, where no gradient is taken (serving, evaluation), all
        groups go through one ``quad_sample_reduce_fwd`` launch (the op
        ``hgsfusion::quad_sample_reduce_fwd``: its plain version on CPU
        tensors), which reads the grid's (u, v) in place and the unpadded
        maps, and returns the sum rounded once to the compute dtype: no
        padded map, no tap indices and no sampled features reach memory.
        Otherwise each group is sampled by ``grid_sample_2d_quad_kernel``, or
        with depth by ``grid_sample_depth_kernel`` on its distribution in
        the compute dtype (as JAX casts it), which keep what their backward
        needs, and reduced by ``matmul_f32`` into an f32 accumulator."""
        cdt = compute_dtype(self.dtype)
        conv = self.channel_reduce[0]
        kernel = conv.weight.reshape(conv.weight.shape[0], -1).t()  # (sum C, O)
        uv = grid[..., 0:2]
        # same-resolution maps (layers 2-4 all live at /8) that share a
        # depth distribution share one gather
        probs = [None] * len(features) if depth_probs is None else list(depth_probs)
        groups = []
        off = 0
        for f, p in zip(features, probs):
            if groups and groups[-1][0][0].shape[1:3] == f.shape[1:3] and groups[-1][1] is p:
                groups[-1][0].append(f)
            else:
                groups.append(([f], p, off))
            off += f.shape[-1]
        groups = [(torch.cat([t.to(cdt) for t in fs], dim=-1) if len(fs) > 1 else fs[0].to(cdt),
                   None if p is None else p.to(cdt), k_off) for fs, p, k_off in groups]
        out_shape = uv.shape[:-1] + (kernel.shape[1],)
        needs_grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (*features, *(p for p in probs if p is not None),
                                      conv.weight, conv.bias))
        if depth_probs is None and not needs_grad:
            return quad_sample_reduce(uv, [(f.contiguous(), k_off) for f, _, k_off in groups],
                                      kernel.to(cdt).contiguous(),
                                      conv.bias.to(torch.float32)).view(out_shape)
        vox = conv.bias.to(torch.float32).expand(out_shape).clone()
        flat = vox.view(-1, kernel.shape[1])
        for f, p, k_off in groups:
            cg = f.shape[-1]
            if p is None:
                sampled = grid_sample_2d_quad_kernel(f, uv)  # (B, Y, X, Z, cg)
            else:
                sampled = grid_sample_depth_kernel(f, p, grid)
            flat.add_(matmul_f32(sampled.reshape(-1, cg), kernel[k_off:k_off + cg].to(cdt)))
        return vox


class FrustumToVoxelSingleScale(nn.Module):
    """Single-scale frustum -> voxel sampling, no reduce (the registry's
    ``FrustumToVoxel``; counterpart of the JAX package's
    ``FrustumToVoxelSingleScale``): the depth-weighted frustum volume of one
    map sampled at the voxel grid, (B, Y, X, Z, C) in the compute dtype; with
    ``use_depth`` False, or no distribution given, the 2-D bilinear sample.
    No config of the repository builds it; it is held at module level."""

    def __init__(self, use_depth: bool = True, dtype=None):
        super().__init__()
        self.use_depth, self.dtype = use_depth, dtype

    def forward(self, feature, grid, depth_probs=None):
        """feature (B, H, W, C); grid (B, Y, X, Z, 3); depth_probs (B, H, W, D)."""
        cdt = compute_dtype(self.dtype)
        if self.use_depth and depth_probs is not None:
            return grid_sample_depth_kernel(feature.to(cdt), depth_probs.to(cdt), grid)
        return grid_sample_2d_quad_kernel(feature.to(cdt), grid[..., 0:2])
