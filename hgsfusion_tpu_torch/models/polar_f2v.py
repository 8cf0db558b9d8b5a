"""Polar-factorized image -> BEV view transform (f2v + Z-collapse fused).

Counterpart of ``hgsfusion_tpu/models/polar_f2v.py`` (``F2V.VIEW: polar``,
``configs/hgsfusion_vod_polar.yaml``). For a BEV cell at (x, y) let
w' = m20 x + m21 y + m22 z_ref + m23 and zeta = 1 / w' (m = cam_to_img @
lidar_to_cam [@ inv(bda)]). On a regular (u, zeta) grid the image row v of
every height z is exactly affine in u, so the whole voxel volume becomes:

  1. reduce first: each scale group's map times its rows of the f2v reduce
     kernel (f32 products, rounded once), 128 channels wide;
  2. pass 2: per scale, a static column resample onto a common padded
     u-grid, a vertical shear, and a hat-weight product over image rows
     that lands the (B, J, Z, K, C) slab, the product's own output order;
     the scales' parts and the reduce bias summed in the compute dtype;
  3. the f2v BatchNorm and ReLU, then the Z-collapse with the map_to_bev
     kernel at polar nodes: a (B, J, K, O) polar table ``q``;
  4. pass 3: one bilinear sample of ``q`` per far-field BEV cell;
  5. near field (the first ``near_columns`` BEV columns): the exact voxel
     path on the reduced maps, sample(f) @ K == sample(f @ K).

The three bilinear samples (the two reduced maps in the near field, ``q`` in
pass 3) run through ``ops/quad_sample.py::grid_sample_2d_quad_kernel``: the
``quad_sample_fwd`` kernel, and ``quad_sample_bwd`` with its bins for their
gradients. The JAX package samples with XLA's ``grid_sample_2d_quad``, the
same function; in bf16 the kernel sums the four taps in f32 and rounds once.
The one-axis resamples (``_shear_rows``, ``_resample_cols``) are gathers in
PyTorch, as JAX leaves them to XLA. Nothing reads back to the host.

The parameters are the gather path's: ``PolarF2V`` holds the f2v reduce and
BN under ``channel_reduce.{0,1}``, the detector's ``Conv2DCollapse`` the
collapse kernel and BN, so one ``state_dict`` serves both views. Not ported:
``REMAT`` (``jax.checkpoint`` of pass 2), which changes memory, not results.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.quad_sample import grid_sample_2d_quad_kernel
from ..utils.common import device_constant
from .frustum import FrustumGridGenerator
from .layers import batch_norm, batch_norm_joint, compute_dtype, matmul_f32

# dead u-nodes on each side of the common grid, fully outside every scale's
# one-source-pixel border fade
PAD_U = 3


def _project_uv_zeta(m, x, y, z_ref):
    """Per-cell polar coordinates (u, zeta) at the reference height.

    ``m[..., i, j]`` broadcasts against x, y: a (3, 4) matrix, or (B, 1, 1,
    3, 4) against (B, Y, X) cells. Cells behind the camera (w' <= 1e-4) get
    u = -1e9 and zeta = 0, so the pass-3 clamp lands them on the dead edge."""
    wp = m[..., 2, 0] * x + m[..., 2, 1] * y + m[..., 2, 2] * z_ref + m[..., 2, 3]
    safe = wp > 1e-4
    zeta = torch.where(safe, 1.0 / torch.where(safe, wp, torch.ones_like(wp)),
                       torch.zeros_like(wp))
    u = (m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2] * z_ref + m[..., 0, 3]) * zeta
    return torch.where(safe, u, torch.full_like(u, -1e9)), zeta


def _solve_cell(m, u, zeta, z_ref):
    """Invert (u, zeta) -> (x, y) at z_ref: the exact 2x2 linear solve."""
    rhs1 = u / zeta - m[..., 0, 2] * z_ref - m[..., 0, 3]
    rhs2 = 1.0 / zeta - m[..., 2, 2] * z_ref - m[..., 2, 3]
    det = m[..., 0, 0] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 0]
    x = (rhs1 * m[..., 2, 1] - rhs2 * m[..., 0, 1]) / det
    y = (m[..., 0, 0] * rhs2 - m[..., 2, 0] * rhs1) / det
    return x, y


def _v_exact(m, u, zeta, z, z_ref):
    """Exact image row v of the cell at polar (u, zeta) and height z; u,
    zeta, z and ``m[..., i, j]`` broadcast together."""
    x, y = _solve_cell(m, u, zeta, z_ref)
    num = m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2] * z + m[..., 1, 3]
    den = m[..., 2, 0] * x + m[..., 2, 1] * y + m[..., 2, 2] * z + m[..., 2, 3]
    return num / den


def _shear_rows(src, shift):
    """Vertical fractional shear: out[b, h, k] = src[b, h + shift[b, k], k].

    src (B, H, K, C); shift (B, K) f32. Rows outside the map read zero (the
    sampler's zeros padding)."""
    b, h, k, c = src.shape
    pos = torch.arange(h, dtype=shift.dtype, device=src.device)[None, :, None] + shift[:, None, :]
    i0 = torch.floor(pos)
    t = (pos - i0).to(src.dtype)[..., None]

    def take(idx):
        ok = ((idx >= 0) & (idx <= h - 1)).to(src.dtype)[..., None]
        ic = torch.clamp(idx, 0, h - 1).long()
        return torch.gather(src, 1, ic[..., None].expand(b, h, k, c)) * ok

    return take(i0) * (1.0 - t) + take(i0 + 1.0) * t


def _hat_weights(v0, num_rows: int):
    """The zeros-padded 2-tap lerp along one axis as a hat matrix,
    W[..., h] = relu(1 - |v0 - h|), in f32."""
    rows = torch.arange(num_rows, dtype=torch.float32, device=v0.device)
    return torch.clamp(1.0 - torch.abs(v0[..., None] - rows), min=0.0)


def _resample_cols(src, pad_dst: int, n_dst: int, ratio: float):
    """Static 2-tap column resample from a scale's zero-padded grid onto the
    common padded u-grid.

    src (B, H, Ws + 2, C), one zero column on each side. Destination node k
    (of ``n_dst``, the first ``pad_dst`` off-image) sits at source column
    (k - pad_dst) * ratio + 1."""
    kd = torch.arange(n_dst, dtype=torch.float32, device=src.device) - pad_dst
    pos = kd * ratio + 1.0
    i0 = torch.floor(pos)
    t = (pos - i0).to(src.dtype)[None, None, :, None]
    w_src = src.shape[2]

    def take(idx):
        ok = ((idx >= 0) & (idx <= w_src - 1)).to(src.dtype)[None, None, :, None]
        return torch.index_select(src, 2, torch.clamp(idx, 0, w_src - 1).long()) * ok

    return take(i0) * (1.0 - t) + take(i0 + 1.0) * t


class PolarF2V(nn.Module):
    """The polar view's f2v parameters under the gather path's names:
    ``channel_reduce`` = (Conv3d 1x1x1 with bias, BatchNorm3d), the JAX
    package's ``_F2VScope`` (reduce kernel, reduce bias, BN)."""

    def __init__(self, sum_channels: int, out_channels: int = 128):
        super().__init__()
        self.channel_reduce = nn.Sequential(
            nn.Conv3d(sum_channels, out_channels, 1, bias=True),
            nn.BatchNorm3d(out_channels))


class PolarGeometry(NamedTuple):
    """What the polar view computes from the calibration alone (f32)."""
    u_cell: torch.Tensor      # (B, Y, X) u of every BEV cell at z_ref, orig px
    zeta_cell: torch.Tensor   # (B, Y, X)
    z_lo: torch.Tensor        # (B,) far-field zeta range
    z_hi: torch.Tensor        # (B,)
    v0: torch.Tensor          # (B, J, Z) exact v at the reference column
    lam: torch.Tensor         # (B,) the shear slope dv/du, orig px
    near_uv: torch.Tensor     # (B, Y, Nn, Z, 2) near-field sample coords, or None
    far_coords: torch.Tensor  # (B, Y, X - Nn, 2) pass-3 coords into q (W = K, H = J)
    s_fine: float             # original px per column of the finest scale
    kp: int                   # nodes of the common padded u-grid
    k_ref: float              # its reference column


def polar_geometry(l2c, c2i, image_size, bda, *, grid_size, pc_range, w_fine: int,
                   zeta_bins: int = 128, near_columns: int = 20,
                   bev_aug: bool = False) -> PolarGeometry:
    """The calibration-only part of ``polar_image_bev``: the projection per
    frame (inv(bda) folded in with ``bev_aug``), every cell's (u, zeta), the
    far-field zeta node range, the exact rows v0 at the reference column,
    the shear slope, and the near-field and pass-3 sample coordinates.
    ``w_fine`` is the width of the finest feature map."""
    nx, ny, nz = (int(g) for g in grid_size)
    n_near = min(int(near_columns), nx)
    jbins = int(zeta_bins)
    if jbins < 2:
        raise ValueError("zeta_bins must be >= 2")
    h_img, w_img = (int(s) for s in image_size)
    dev = l2c.device
    m = torch.matmul(c2i, l2c)  # (B, 3, 4)
    if bev_aug:
        if bda is None:
            raise ValueError("BEV_AUG is enabled but the batch has no lidar_aug_matrix "
                             "(see FrustumGridGenerator)")
        m = torch.matmul(m, torch.linalg.inv_ex(bda).inverse)  # no host read of the check

    pc = [float(v) for v in pc_range]
    vx = (pc[3] - pc[0]) / nx
    f32 = dict(dtype=torch.float32, device=dev)
    xs = pc[0] + (torch.arange(nx, **f32) + 0.5) * vx
    ys = pc[1] + (torch.arange(ny, **f32) + 0.5) * ((pc[4] - pc[1]) / ny)
    zs = pc[2] + (torch.arange(nz, **f32) + 0.5) * ((pc[5] - pc[2]) / nz)
    z_ref = 0.5 * (pc[2] + pc[5])
    u_cell, zeta_cell = _project_uv_zeta(m[:, None, None], xs[None, None, :],
                                         ys[None, :, None], z_ref)  # (B, Y, X)

    # the common padded u-grid: the finest scale's columns plus dead pads
    s_fine = (w_img - 1) / (w_fine - 1)
    kp = w_fine + 2 * PAD_U
    k_ref = (kp - 1) / 2.0
    u_ref = (k_ref - PAD_U) * s_fine

    # far-field zeta span over the cells that can read anything but the dead
    # edge columns (this also drops the behind-camera sentinel)
    bsz = l2c.shape[0]
    zeta_far = zeta_cell[:, :, n_near:].reshape(bsz, -1)
    u_far = u_cell[:, :, n_near:].reshape(bsz, -1)
    live = (u_far > -PAD_U * s_fine) & (u_far < (w_fine + PAD_U - 1) * s_fine)
    any_live = live.any(dim=1)
    big = 3.4e38
    z_lo = torch.where(live, zeta_far, torch.full_like(zeta_far, big)).amin(dim=1)
    z_hi = torch.where(live, zeta_far, torch.full_like(zeta_far, -big)).amax(dim=1)
    z_lo = torch.where(any_live, z_lo, torch.zeros_like(z_lo))
    z_hi = torch.where(any_live, z_hi, torch.ones_like(z_hi))
    z_hi = torch.maximum(z_hi, z_lo + 1e-6)
    frac = torch.arange(jbins, **f32) / (jbins - 1)
    zeta_nodes = z_lo[:, None] + frac[None, :] * (z_hi - z_lo)[:, None]  # (B, J)

    # exact v at the reference column, (B, J, Z), and the global shear slope
    # from two exact evaluations (v is affine in u)
    v0 = _v_exact(m[:, None, None], u_ref, zeta_nodes[:, :, None], zs[None, None, :], z_ref)
    zeta_mid = 0.5 * (z_lo + z_hi)
    du = (w_img - 1) * 0.25
    u_lr = device_constant((u_ref - du, u_ref + du), torch.float32, dev)
    v_lr = _v_exact(m[:, None], u_lr[None, :], zeta_mid[:, None], z_ref, z_ref)  # (B, 2)
    lam = (v_lr[:, 1] - v_lr[:, 0]) / (2.0 * du)

    near_uv = None
    if n_near > 0:
        near_gen = FrustumGridGenerator(
            (n_near, ny, nz), (pc[0], pc[1], pc[2], pc[0] + n_near * vx, pc[4], pc[5]),
            {"mode": "UD", "depth_min": 0.0, "depth_max": 1.0, "num_bins": 2}, bev_aug)
        near_uv = near_gen(l2c, c2i, image_size, bda=bda)[..., 0:2]

    # pass 3: each far cell's (u*, zeta*) on the polar table, clamped so
    # off-image cells read the dead edge nodes
    px_u = torch.clamp(u_cell[:, :, n_near:] / s_fine + PAD_U, 0.0, kp - 1.0)
    dz = (z_hi - z_lo) / (jbins - 1)
    px_z = torch.clamp((zeta_cell[:, :, n_near:] - z_lo[:, None, None]) / dz[:, None, None],
                       0.0, jbins - 1.0)
    far_coords = torch.stack([px_u / (kp - 1) * 2.0 - 1.0, px_z / (jbins - 1) * 2.0 - 1.0],
                             dim=-1)
    return PolarGeometry(u_cell, zeta_cell, z_lo, z_hi, v0, lam, near_uv, far_coords,
                         s_fine, kp, k_ref)


class _CollapseF32(torch.autograd.Function):
    """The Z-collapse at polar nodes: q[b, j, k] = sum over z of
    slab[b, j, z, k] @ kz[z], every product accumulated in f32 and the sum
    returned in f32 (the JAX package's einsum "bjzkc,czo->bjko" with
    preferred_element_type f32). One batched product per z on strided views
    of the slab, so the slab is never permuted; its gradient is written
    slice by slice into one tensor."""

    @staticmethod
    def forward(ctx, slab, kz):
        b, j, nz, k, c = slab.shape
        ctx.save_for_backward(slab, kz)
        out = None
        for z in range(nz):
            part = matmul_f32(slab[:, :, z].reshape(b * j, k, c),
                              kz[z].expand(b * j, c, kz.shape[-1]))
            out = part if out is None else out.add_(part)
        return out.view(b, j, k, -1)

    @staticmethod
    def backward(ctx, g):
        slab, kz = ctx.saved_tensors
        b, j, nz, k, c = slab.shape
        g3 = g.reshape(b * j, k, -1)
        g_slab = g_kz = None
        if ctx.needs_input_grad[0]:
            g_slab = torch.empty_like(slab)
            for z in range(nz):
                g_slab[:, :, z] = (g3 @ kz[z].float().t()).view(b, j, k, c)
        if ctx.needs_input_grad[1]:
            g_kz = torch.stack([
                (slab[:, :, z].reshape(b * j, k, c).float().mT @ g3).sum(0)
                for z in range(nz)]).to(kz.dtype)
        return g_slab, g_kz


def polar_image_bev(f2v: PolarF2V, collapse, features, l2c, c2i, image_size, bda, *,
                    grid_size, pc_range, zeta_bins: int = 128, near_columns: int = 20,
                    bev_aug: bool = False, dtype=None):
    """Fused polar f2v + Z-collapse producing the image BEV directly.

    ``f2v`` holds the reduce and its BN, ``collapse`` (an
    ``occupancy.Conv2DCollapse``) the collapse kernel and its BN; their mode
    (train or eval) is the BNs'. features: list of (B, Hs, Ws, Cs) maps,
    finest first (the channel-reduce outputs); l2c (B, 4, 4); c2i (B, 3, 4);
    image_size (H, W); bda (B, 4, 4) or None. Returns (B, Y, X, O), what
    ``Conv2DCollapse`` gives on the gather path's voxel volume.
    """
    cdt = compute_dtype(dtype)
    nz = int(grid_size[2])
    h_img, w_img = (int(s) for s in image_size)
    conv, bn = f2v.channel_reduce
    kernel = conv.weight.reshape(conv.weight.shape[0], -1).t()  # (sum C, O)

    # same-resolution maps form one group; reduce first, since the reduce is
    # linear per channel and commutes with bilinear sampling
    groups = []
    off = 0
    for f in features:
        if groups and groups[-1][0][0].shape[1:3] == f.shape[1:3]:
            groups[-1][0].append(f)
        else:
            groups.append(([f], off))
        off += f.shape[-1]
    reduced = []
    for fs, k_off in groups:
        f = torch.cat([t.to(cdt) for t in fs], dim=-1) if len(fs) > 1 else fs[0].to(cdt)
        b, hs, ws, cg = f.shape
        red = matmul_f32(f.reshape(-1, cg), kernel[k_off:k_off + cg].to(cdt))
        reduced.append(red.to(cdt).view(b, hs, ws, -1))

    geo = polar_geometry(l2c, c2i, image_size, bda, grid_size=grid_size, pc_range=pc_range,
                         w_fine=reduced[0].shape[2], zeta_bins=zeta_bins,
                         near_columns=near_columns, bev_aug=bev_aug)
    bias = conv.bias.to(cdt)

    # pass 2 per scale onto the common polar grid: (B, J, Z, K, C), summed
    slab = None
    kps = torch.arange(geo.kp, dtype=torch.float32, device=l2c.device)
    for f_red in reduced:
        b, hs, ws, c = f_red.shape
        ratio = geo.s_fine / ((w_img - 1) / (ws - 1))
        row_scale = (hs - 1) / (h_img - 1)
        src = _resample_cols(F.pad(f_red, (0, 0, 1, 1)), PAD_U, geo.kp, ratio)
        shift = geo.lam[:, None] * (kps[None, :] - geo.k_ref) * geo.s_fine * row_scale
        sheared = _shear_rows(src, shift)  # (B, Hs, K, C)
        wv = _hat_weights(geo.v0 * row_scale, hs).to(cdt)  # (B, J, Z, Hs)
        jb, zb = wv.shape[1:3]
        part = matmul_f32(wv.reshape(b, jb * zb, hs), sheared.reshape(b, hs, geo.kp * c))
        part = part.to(cdt).view(b, jb, zb, geo.kp, c)
        slab = part if slab is None else slab + part
    slab = slab + bias

    # the exact near field on the reduced maps: (B, Y, Nn, Z, C)
    near = None
    if geo.near_uv is not None:
        for f_red in reduced:
            s = grid_sample_2d_quad_kernel(f_red, geo.near_uv)
            near = s if near is None else near + s
        near = near + bias

    # the shared f2v BN + ReLU: in train mode one call over the slab and the
    # near field joined (one running-statistics update); in eval mode it is
    # elementwise, so each part takes its own call
    if near is not None and bn.training:
        slab, near = (torch.relu_(y) for y in batch_norm_joint((slab, near), bn, cdt))
    else:
        slab = torch.relu_(batch_norm(slab, bn, cdt))
        if near is not None:
            near = torch.relu_(batch_norm(near, bn, cdt))

    # Z-collapse at polar nodes and on the near slice; the conv weight's
    # channel order is c * Z + z
    w = collapse.block.conv.weight
    o = w.shape[0]
    kz = w.reshape(o, -1, nz).permute(2, 1, 0).contiguous().to(cdt)  # (Z, C, O)
    q = _CollapseF32.apply(slab, kz).to(cdt)  # (B, J, K, O)
    far_bev = grid_sample_2d_quad_kernel(q, geo.far_coords)  # (B, Y, X - Nn, O)
    if near is None:
        bev = far_bev
    else:
        b, y, n_near = near.shape[:3]
        near_bev = matmul_f32(near.reshape(b * y * n_near, -1), kz.reshape(-1, o))
        bev = torch.cat([near_bev.to(cdt).view(b, y, n_near, o), far_bev], dim=2)

    # the map_to_bev BN + ReLU in Cartesian space (the reference order)
    return torch.relu_(batch_norm(bev, collapse.block.bn, cdt))
