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

``QUANT: int8`` samples each group's per-channel int8 quantization and
folds the scales into the group's reduce rows (f32, then the compute
dtype), as the JAX package's ``grid_sample_2d_quad_q8``: where no gradient
is taken one ``quad_sample_reduce_q8_fwd`` launch, otherwise
``quad_sample_fwd`` on each group's int8 map with a straight-through
backward (K2 on the cotangent divided by the scales). ``USE_DEPTH``
ignores it, as in JAX.

``merge_nested_gather`` (module level; no config sets it, in the JAX
package either) packs a fine map and a 2x-coarser nested one into one
canvas (``merge_nested_groups``) that one gather serves exactly; at VoD's
shapes the grids do not nest and the two groups stay as they are.

``REMAT`` recomputes the sample + reduce product in the backward pass
(``torch.utils.checkpoint``) instead of keeping the tap indices, weights,
bins and sampled features (under QUANT int8 the quantization too); the
BatchNorm stays outside, so its running statistics update once a step.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.depth_sample import grid_sample_depth_kernel
from ..ops.grid_sample import div_exact, quantize_per_channel_int8
from ..ops.matmul import matmul_f32
from ..ops.quad_sample import (grid_sample_2d_quad_kernel, grid_sample_2d_quad_q8_kernel,
                               quad_sample_reduce, quad_sample_reduce_q8)
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


def _nested_refine_2x(x):
    """(B, h, w, C) -> (B, 2h-1, 2w-1, C): the align_corners midpoint
    refinement, whose bilinear interpolation reproduces the input's
    bilinear surface exactly."""
    b, h, w, c = x.shape
    mid_h = 0.5 * (x[:, :-1] + x[:, 1:])
    rows = torch.stack([x[:, :-1], mid_h], dim=2).reshape(b, 2 * (h - 1), w, c)
    rows = torch.cat([rows, x[:, -1:]], dim=1)  # (B, 2h-1, w, C)
    mid_w = 0.5 * (rows[:, :, :-1] + rows[:, :, 1:])
    out = torch.stack([rows[:, :, :-1], mid_w], dim=3).reshape(b, 2 * h - 1, 2 * (w - 1), c)
    return torch.cat([out, rows[:, :, -1:]], dim=2)


def nests(fine_hw, coarse_hw) -> bool:
    """The coarse grid's align_corners knots lie on the fine grid's."""
    return all(f - 1 == 2 * (c - 1) for f, c in zip(fine_hw, coarse_hw))


def merge_nested_groups(f_fine, f_coarse):
    """A fine map and a 2x-coarser nested map packed into one canvas that a
    single bilinear gather serves exactly, the zeros-padding fade of each
    included (the JAX package's ``merge_nested_groups``): the coarse map is
    ringed with one coarse pixel of zeros and refined, the fine map padded
    with two fine pixels, the two concatenated along the channels.

    Returns (canvas (B, hf+4, wf+4, Cf+Cc), remap), remap taking the fine
    map's normalized (u, v) to the canvas's.
    """
    b, hf, wf, _ = f_fine.shape
    if not nests((hf, wf), f_coarse.shape[1:3]):
        raise ValueError(f"maps {tuple(f_fine.shape)} and {tuple(f_coarse.shape)} do not nest")
    up = _nested_refine_2x(F.pad(f_coarse, (0, 0, 1, 1, 1, 1)))  # (B, hf+4, wf+4, Cc)
    canvas = torch.cat([F.pad(f_fine, (0, 0, 2, 2, 2, 2)), up], dim=-1)

    def remap(uv):
        # fine pixel p = (u+1)/2 (n-1); canvas u' = 2 (p+2)/(n+3) - 1
        pf_x = (uv[..., 0] + 1.0) * 0.5 * (wf - 1)
        pf_y = (uv[..., 1] + 1.0) * 0.5 * (hf - 1)
        return torch.stack([div_exact(2.0 * (pf_x + 2.0), wf + 3) - 1.0,
                            div_exact(2.0 * (pf_y + 2.0), hf + 3) - 1.0], dim=-1)

    return canvas, remap


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
                 sampler_kernel: str = "pallas", remat: bool = False,
                 merge_nested_gather: bool = False):
        super().__init__()
        # refuse loudly what the port does not run. The JAX package's two
        # samplers (XLA and Pallas) have the same numerics, so both run the
        # same kernels here; like JAX's, the Pallas one refuses QUANT int8
        if quant not in ("none", "int8"):
            raise NotImplementedError(f"F2V.QUANT: {quant}")
        if quant == "int8" and sampler_kernel == "pallas":
            raise ValueError("F2V.SAMPLER_KERNEL: pallas is mutually exclusive with "
                             "QUANT: int8 (the pallas path is bf16-payload)")
        if fuse_mode not in ("CONCAT", "ADD"):
            raise NotImplementedError(f"F2V.FUSE_MODE: {fuse_mode}")
        if sampler_kernel not in ("xla", "pallas"):
            raise NotImplementedError(f"F2V.SAMPLER_KERNEL: {sampler_kernel}")
        self.in_channels = tuple(int(c) for c in in_channels)
        self.dtype = dtype
        self.fuse_mode = fuse_mode
        self.quant = quant
        self.remat = remat
        self.merge_nested_gather = merge_nested_gather
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
        padded map, no tap indices and no sampled features reach memory;
        under QUANT int8 ``quad_sample_reduce_q8_fwd`` on the groups' int8
        maps with the scaled rows. Otherwise each group is sampled by
        ``grid_sample_2d_quad_kernel`` (int8: ``grid_sample_2d_quad_q8_kernel``,
        its scales folded into the rows), or with depth by
        ``grid_sample_depth_kernel`` on its distribution in the compute dtype
        (as JAX casts it), which keep what their backward needs, and reduced
        by ``matmul_f32`` into an f32 accumulator."""
        cdt = compute_dtype(self.dtype)
        conv = self.channel_reduce[0]
        kernel = conv.weight.reshape(conv.weight.shape[0], -1).t()  # (sum C, O)
        uv = grid[..., 0:2]
        q8 = self.quant == "int8" and depth_probs is None
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
        # the maps as given (int8 quantizes them, as JAX's), else in the
        # compute dtype
        groups = [(torch.cat(fs, dim=-1) if len(fs) > 1 else fs[0], p, k_off)
                  for fs, p, k_off in groups]
        if (self.merge_nested_gather and depth_probs is None and len(groups) == 2
                and groups[0][2] == 0 and nests(groups[0][0].shape[1:3], groups[1][0].shape[1:3])):
            canvas, remap = merge_nested_groups(groups[0][0], groups[1][0])
            groups, uv = [(canvas, None, 0)], remap(uv)
        if not q8:
            groups = [(f.to(cdt), None if p is None else p.to(cdt), k_off)
                      for f, p, k_off in groups]
        out_shape = uv.shape[:-1] + (kernel.shape[1],)
        needs_grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (*features, *(p for p in probs if p is not None),
                                      conv.weight, conv.bias))
        bias = conv.bias.to(torch.float32)
        if depth_probs is None and not needs_grad:
            if q8:
                qs = [quantize_per_channel_int8(f) for f, _, _ in groups]
                kmat = torch.cat([kernel[k_off:k_off + q.shape[-1]] * scale[:, None]
                                  for (q, scale), (_, _, k_off) in zip(qs, groups)])
                return quad_sample_reduce_q8(
                    uv, [(q, k_off) for (q, _), (_, _, k_off) in zip(qs, groups)],
                    kmat.to(cdt).contiguous(), bias).view(out_shape)
            return quad_sample_reduce(uv, [(f.contiguous(), k_off) for f, _, k_off in groups],
                                      kernel.to(cdt).contiguous(), bias).view(out_shape)
        vox = bias.expand(out_shape).clone()
        flat = vox.view(-1, kernel.shape[1])
        for f, p, k_off in groups:
            cg = f.shape[-1]
            k_rows = kernel[k_off:k_off + cg]
            if p is not None:
                sampled = grid_sample_depth_kernel(f, p, grid)
            elif q8:  # unscaled; the per-channel scales fold into the rows
                sampled, scale = grid_sample_2d_quad_q8_kernel(f, uv, cdt)
                k_rows = k_rows * scale[:, None]
            else:
                sampled = grid_sample_2d_quad_kernel(f, uv)  # (B, Y, X, Z, cg)
            flat.add_(matmul_f32(sampled.reshape(-1, cg), k_rows.to(cdt)))
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
