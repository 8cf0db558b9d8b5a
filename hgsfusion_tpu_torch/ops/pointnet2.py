"""Farthest-point sampling, ball query and grouping over point sets and
over dense voxel-center grids.

Counterpart of ``hgsfusion_tpu/ops/pointnet2.py`` (``farthest_point_sample``,
``ball_query``, ``query_and_group``). ``farthest_point_sample`` is the op
``hgsfusion::farthest_point_sample`` (``ops/library.py``): on the card the
hand kernel ``csrc/fps.cu``, one launch a batch; on the CPU its plain
version, ``farthest_point_sample_plain``, the max-min loop. ``ball_query``
is JAX's dense form: the (M, N) squared-distance matrix and its cumulative
count, taken ``chunk`` centres at a time so that it fits (PV-RCNN's RoI
grid: 27,648 centres over 1,024 keypoints). A two-stage detector pools
from voxel-center sets of up to 640,000 cells (Voxel R-CNN's ``x_conv2``
at full width), where that matrix would take 71 GB for 27,648 centres, so
``ball_query_grid`` walks only the window of cells that can lie within the
radius of each centre and keeps the dense form's rule exactly:

- a cell counts when it is valid and its squared distance, summed over x,
  y, z in that order, is below radius * radius;
- the first ``nsample`` such cells in flat (z, y, x) index order fill the
  slots, the unfilled ones repeat the first cell found;
- a centre with no cell in its ball gets all zeros, ``any_nb`` False.

The window is a box of cells walked in (z, y, x) order, which is the flat
index order within it; it is one cell wider on each side than the ball's
span on that axis, and the f32 test decides. JAX leaves the query to XLA,
so this is a module of gathers and not a hand kernel.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import library  # noqa: F401  (registers hgsfusion::farthest_point_sample)


def farthest_point_sample_plain(xyz, valid, k: int):
    """(B, N, 3) f32 points and (B, N) bool -> (B, k) int64 indices, the JAX
    package's max-min loop: index 0 first (even where it is not valid), each
    valid point's distance to the chosen set ((dx*dx + dy*dy) + dz*dz, f32)
    its running minimum from 1e10, an invalid one's -1, then the first
    argmax. The kernel's plain version (``csrc/fps.cu``)."""
    b = xyz.shape[0]
    dists = torch.where(valid, torch.full((), 1e10, device=xyz.device),
                        torch.full((), -1.0, device=xyz.device))
    rows = torch.arange(b, device=xyz.device)
    idx = torch.zeros((b, k), dtype=torch.int64, device=xyz.device)
    last = xyz[:, 0]
    for i in range(1, k):
        d = xyz - last[:, None]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        dists = torch.minimum(dists, torch.where(valid, d2, torch.full_like(d2, -1.0)))
        nxt = dists.argmax(dim=1)
        idx[:, i] = nxt
        last = xyz[rows, nxt]
    return idx


def farthest_point_sample(xyz, valid, k: int):
    """(B, N, 3) points, (B, N) valid -> (B, k) int64 keypoint indices: the
    op ``hgsfusion::farthest_point_sample`` (the kernel on the card, one
    launch a batch; ``farthest_point_sample_plain`` on the CPU)."""
    return torch.ops.hgsfusion.farthest_point_sample(
        xyz.float().contiguous(), valid.contiguous(), k)


def ball_query(new_xyz, xyz, valid, radius: float, nsample: int, chunk: int = 4096):
    """(M, 3) centres x (N, 3) points -> (M, nsample) neighbour indices
    (int64) and the (M,) any-neighbour mask, the dense form (an (M, N)
    matrix), ``chunk`` centres at a time."""
    cols = torch.arange(xyz.shape[0], device=xyz.device)[None, :]
    idx_out, any_out = [], []
    for c0 in range(0, max(new_xyz.shape[0], 1), chunk):
        d = new_xyz[c0:c0 + chunk, None, :] - xyz[None, :, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        idx, any_nb = _first_in_order((d2 < radius * radius) & valid[None, :], cols, nsample)
        idx_out.append(idx)
        any_out.append(any_nb)
    return torch.cat(idx_out), torch.cat(any_out)


def _first_in_order(mask, cells, nsample: int):
    """The first ``nsample`` of each row's ``cells`` where ``mask`` holds,
    in column order; the unfilled slots repeat the first one, a row with
    none is all zeros. ``cells`` broadcasts to ``mask``'s shape."""
    any_nb = mask.any(dim=1)
    cells = cells.expand(mask.shape)
    first = torch.take_along_dim(cells, mask.to(torch.uint8).argmax(dim=1, keepdim=True), dim=1)
    first = torch.where(any_nb[:, None], first, torch.zeros_like(first))
    order = torch.cumsum(mask.to(torch.int32), dim=1)
    slot = torch.where(mask & (order <= nsample), order - 1, torch.full_like(order, nsample))
    idx = first.expand(-1, nsample + 1).clone()
    idx.scatter_(1, slot.long(), cells)
    return idx[:, :nsample], any_nb


def affine_axis(index, step: float, stride: int, origin: float):
    """index * (f32 step x stride) + origin with one rounding to f32, as XLA
    on the CPU folds the constants of the JAX package's ``index * step *
    stride + origin`` and fuses the rest into one multiply-add (f64 here,
    then f32)."""
    scale = float(np.float32(step) * np.float32(stride))
    return (index.double() * scale + float(np.float32(origin))).float()


def grid_axes(shape_dhw, stride: int, pc_range, voxel_size, device):
    """The cell centres of a (D, H, W) voxel stage at ``stride`` along each
    axis, (zs, ys, xs) f32: (i + 0.5) * voxel * stride + range min, the JAX
    package's ``_stage_point_set`` centres bit for bit."""
    return tuple(affine_axis(torch.arange(n, dtype=torch.float32, device=device) + 0.5,
                             voxel_size[axis], stride, pc_range[axis])
                 for n, axis in zip(shape_dhw, (2, 1, 0)))


def grid_centers(axes):
    """(D H W, 3) x, y, z centres of the cells of ``grid_axes``, flat in
    (z, y, x) order."""
    zs, ys, xs = axes
    zz, yy, xx = torch.meshgrid(zs, ys, xs, indexing="ij")
    return torch.stack([xx, yy, zz], dim=-1).reshape(-1, 3)


def window_span(radius: float, pitch: float) -> int:
    """Cells a window spans on an axis of cell ``pitch``: the ball's
    floor(2 r / pitch) + 1, one more on each side, and one for the start
    rounded down."""
    return int(math.floor(2.0 * radius / pitch)) + 4


def ball_query_grid(new_xyz, axes, pitch, origin, valid, radius: float, nsample: int,
                    chunk: int = 8192):
    """``ball_query`` of (M, 3) centres over the cells of a (D, H, W) grid
    (``axes`` its (zs, ys, xs) centres, ``pitch`` and ``origin`` its
    (z, y, x) cell size and range minimum, ``valid`` (D H W,) its active
    mask, flat in (z, y, x) order), walking only each centre's window:
    the same (M, nsample) indices into the flat grid and (M,) mask as the
    dense form. Centres go ``chunk`` at a time."""
    zs, ys, xs = axes
    dims = (zs.shape[0], ys.shape[0], xs.shape[0])
    spans = [window_span(radius, p) for p in pitch]
    device = new_xyz.device
    offs = [torch.arange(s, device=device) for s in spans]
    r2 = radius * radius
    idx_out, any_out = [], []
    for c0 in range(0, new_xyz.shape[0], chunk):
        c = new_xyz[c0:c0 + chunk]
        starts = []
        for a, col in enumerate((2, 1, 0)):
            lo = (c[:, col] - radius - origin[a]) / pitch[a] - 0.5
            lo = torch.nan_to_num(lo, nan=-1e9, posinf=1e9, neginf=-1e9).clamp(-1e9, 1e9)
            starts.append(torch.floor(lo).long() - 1)
        iz = (starts[0][:, None] + offs[0])[:, :, None, None]
        iy = (starts[1][:, None] + offs[1])[:, None, :, None]
        ix = (starts[2][:, None] + offs[2])[:, None, None, :]
        inside = ((iz >= 0) & (iz < dims[0]) & (iy >= 0) & (iy < dims[1])
                  & (ix >= 0) & (ix < dims[2]))
        cz, cy, cx = (t.clamp(0, n - 1) for t, n in zip((iz, iy, ix), dims))
        dx = xs[cx] - c[:, 0, None, None, None]
        dy = ys[cy] - c[:, 1, None, None, None]
        dz = zs[cz] - c[:, 2, None, None, None]
        d2 = (dx * dx + dy * dy) + dz * dz
        flat = (cz * dims[1] + cy) * dims[2] + cx
        mask = (d2 < r2) & inside & valid[flat]
        idx, any_nb = _first_in_order(mask.flatten(1), flat.expand(mask.shape).flatten(1),
                                      nsample)
        idx_out.append(idx)
        any_out.append(any_nb)
    return torch.cat(idx_out), torch.cat(any_out)


def query_and_group(new_xyz, xyz, features, valid, radius: float, nsample: int,
                    zero_empty: bool = True, grid=None):
    """QueryAndGroup: (M, nsample, 3 [+ C]) relative xyz (and features) of
    each centre's ball, zeroed for an empty ball where ``zero_empty`` (the
    stack modules; the batch modules group point 0 instead); returns
    (grouped, idx, any_nb). ``grid``: (axes, pitch, origin) of
    ``grid_axes`` when ``xyz`` are that grid's cell centres: the windowed
    query (``ball_query_grid``)."""
    if grid is None:
        idx, any_nb = ball_query(new_xyz, xyz, valid, radius, nsample)
    else:
        idx, any_nb = ball_query_grid(new_xyz, *grid, valid, radius, nsample)
    out = xyz[idx] - new_xyz[:, None, :]
    if features is not None:
        out = torch.cat([out, features[idx].to(out.dtype)], dim=-1)
    if zero_empty:
        out = out * any_nb[:, None, None].to(out.dtype)
    return out, idx, any_nb
