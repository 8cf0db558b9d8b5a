"""RoI-aware 3-D grid pooling: each RoI split into an out^3 grid in its
own frame, the features of the points inside pooled per cell (max or
mean), empty cells 0.

Counterpart of ``hgsfusion_tpu/ops/roiaware_pool.py::roiaware_pool3d``
(the pooling of pcdet's roiaware_pool3d). JAX maps one RoI at a time over
the points; here every (frame, RoI, point) pair is computed at once, in
JAX's arithmetic op by op: the point rotated by -heading about the box
centre (``cos`` / ``sin`` of -yaw), inside when ``|local| < dims / 2`` on
every axis (and valid), its cell ``floor((local + dims / 2) / (dims /
out))`` clipped to the grid, flattened x-major as ``(i o + j) o + k``; a
point outside a RoI goes to a dump slot of its own past the grid's cells
(JAX's one dump slot would collect nearly every pair of a RoI: at full
width 8,192 a RoI, which ``index_put_`` sums one after another and
``scatter_reduce``'s atomics contend for). The cell size is
divided by a device tensor (``grid_sample.div_exact``): a Python divisor
makes PyTorch's CUDA division multiply by its reciprocal, one ulp off, and
a point on a cell boundary would then change cells between devices.

No pooling step uses atomics, so a frame's pooled grids are the same bits
in every process: the mean's sums and counts go through ``index_put_``
with ``accumulate`` (on the card a stable sort, then each slot summed in
point order, as ``mean_vfe``); the max through ``scatter_reduce`` "amax",
whose result does not depend on order. The max's gradient splits each
cell's cotangent evenly among the points that tie for its maximum, as
JAX's ``segment_max`` VJP does (the points of one voxel carry the same
features, so ties are the rule), the tie counts again by ``index_put_``
(a slot's row of channels at a time: one sort of the pairs).
"""
from __future__ import annotations

import torch

from .grid_sample import div_exact


def roi_local_points(points, rois):
    """(B, N, 3) points in each of the (B, R, 7) RoIs' frames: (B, R, N, 3)."""
    rel = points[:, None, :, :] - rois[:, :, None, :3]
    c = torch.cos(-rois[..., 6])[..., None]
    s = torch.sin(-rois[..., 6])[..., None]
    x = rel[..., 0] * c - rel[..., 1] * s
    y = rel[..., 0] * s + rel[..., 1] * c
    return torch.stack([x, y, rel[..., 2]], dim=-1)


def roiaware_cells(rois, points, valid, out_size: int):
    """Each (frame, RoI, point) pair's flat cell, (B, R, N) int64: ``out^3``
    plus the point's index (its dump slot) where the point is not valid or
    not inside the RoI."""
    o = out_size
    local = roi_local_points(points, rois)
    dims = rois[:, :, None, 3:6]
    half = dims / 2.0
    inside = (local.abs() < half).all(dim=-1) & valid[:, None, :]
    ijk = torch.floor((local + half) / div_exact(dims, float(o)))
    ijk = torch.clamp(ijk, 0, o - 1).to(torch.int64)
    flat = (ijk[..., 0] * o + ijk[..., 1]) * o + ijk[..., 2]
    dump = o ** 3 + torch.arange(points.shape[1], device=points.device)
    return torch.where(inside, flat, dump)


def _slot_index(cells):
    """Index tensors of (B, R, slot) for ``index_put_`` on a (B, R, S, ...)
    tensor, broadcasting to the cells' (B, R, N)."""
    b, r = cells.shape[:2]
    return (torch.arange(b, device=cells.device)[:, None, None],
            torch.arange(r, device=cells.device)[None, :, None], cells)


def _scatter_max(cells, features, n_slots: int):
    """(B, R, n_slots, C): each slot's max over its points' features, 0
    where no point lands."""
    b, r, n = cells.shape
    c = features.shape[-1]
    out = features.new_zeros((b, r, n_slots, c))
    return out.scatter_reduce_(2, cells[..., None].expand(b, r, n, c),
                               features[:, None].expand(b, r, n, c), "amax",
                               include_self=False)


class _RoIMaxPool(torch.autograd.Function):
    """The max pool with JAX's tie rule in its gradient: a cell's cotangent
    times 1 / (the number of its points equal to its max) to each of
    them, summed over the RoIs for each point."""

    @staticmethod
    def forward(ctx, features, cells, n_slots):
        out = _scatter_max(cells, features, n_slots)
        ctx.save_for_backward(features, cells, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        features, cells, out = ctx.saved_tensors
        b, r, n = cells.shape
        c = features.shape[-1]
        src = features[:, None].expand(b, r, n, c)
        idx = cells[..., None].expand(b, r, n, c)
        tie = src == out.gather(2, idx)
        count = torch.zeros_like(out)
        count.index_put_(_slot_index(cells), tie.to(out.dtype), accumulate=True)
        coef = grad * (1.0 / torch.clamp(count, min=1.0))
        pair = torch.where(tie, coef.gather(2, idx), torch.zeros((), dtype=grad.dtype,
                                                                 device=grad.device))
        return pair.sum(dim=1), None, None


def pool_cells(cells, features, out_size: int, pool_method: str = "max"):
    """(B, N, C) point features pooled into each RoI's cells (``cells``:
    ``roiaware_cells``, (B, R, N)): (B, R, o, o, o, C), 0 in empty cells;
    "max" or "avg" (the mean)."""
    b, r, n = cells.shape
    c = features.shape[-1]
    n_cells = out_size ** 3
    if pool_method == "max":
        if torch.is_grad_enabled() and features.requires_grad:
            pooled = _RoIMaxPool.apply(features, cells, n_cells + n)
        else:
            pooled = _scatter_max(cells, features, n_cells + n)
    elif pool_method == "avg":
        # the sums and the count (a last channel) in one sorted pass
        inside = (cells < n_cells).to(features.dtype)[..., None]
        ssum = features.new_zeros((b, r, n_cells + n, c + 1))
        ssum.index_put_(_slot_index(cells), torch.cat(
            [features[:, None] * inside, inside], dim=-1), accumulate=True)
        pooled = ssum[..., :c] / torch.clamp(ssum[..., c:], min=1.0)
    else:
        raise ValueError(f"unknown pool_method {pool_method!r}")
    return pooled[:, :, :n_cells].reshape(b, r, out_size, out_size, out_size, c)


def roiaware_pool3d(rois, points, features, valid, out_size: int = 6,
                    pool_method: str = "max"):
    """(B, R, 7) RoIs over (B, N, 3) points with (B, N, C) features and
    (B, N) validity -> (B, R, out, out, out, C)."""
    return pool_cells(roiaware_cells(rois, points, valid, out_size), features, out_size,
                      pool_method)
