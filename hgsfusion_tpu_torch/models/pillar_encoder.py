"""Pillar feature net: point encoding -> MLP -> scatter-max.

Counterpart of ``hgsfusion_tpu/models/pillar_encoder.py::PillarFeatureNet``:
the split real/virtual encoding the HGSFusion and radar-only configs use,
and the ``mixed`` (the raw point as it is; also what ``split`` means without
virtual points) and ``direct`` (the point without its two idf columns)
encodings of the PointPillar families, with any number of MLP layers.
Parameter names follow the reference reader: ``pfn_layers.shared_mlps`` is
(Linear, BatchNorm1d, ReLU) per layer, so layer i's Linear is ``3 i`` and
its BatchNorm ``3 i + 1``.

Feature layout (VoD): input [xyz 3 | radar 4 | label one-hot 8 | idf 2] = 17,
split re-encoding [xyz 3 | real 12 | virtual 12 | idf 2] = 29, MLP input
[encoded | xyz_rel 3 | xyz_rel - pillar_center 3].
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.voxelize import points_to_pillar_ids, scatter_any_dense, scatter_max_dense
from ..utils.common import device_constant
from .layers import MaskedBatchNorm, compute_dtype


class PillarFeatureNet(nn.Module):
    def __init__(self, num_input_features: int = 29, num_filters=(32,),
                 pillar_size: float = 0.16, pc_range=(0, -25.6, -3, 51.2, 25.6, 2),
                 use_virtual: bool = True, encoding_type: str = "split", dtype=None):
        """``num_input_features``: the split encoding's width, else the raw
        point's."""
        super().__init__()
        if encoding_type not in ("split", "mixed", "direct"):
            raise ValueError(f"encoding_type {encoding_type!r}")
        self.num_input_features = num_input_features
        self.pillar_size = float(pillar_size)
        self.pc_range = tuple(float(v) for v in pc_range)
        self.split = use_virtual and encoding_type == "split"
        self.encoding_type = encoding_type
        self.dtype = dtype
        width = num_input_features - (2 if encoding_type == "direct" and not self.split else 0)
        layers = []
        for out in num_filters:
            layers += [nn.Linear(width + 6 if not layers else width, out, bias=False),
                       MaskedBatchNorm(out, eps=1e-3, momentum=0.01), nn.ReLU()]
            width = out
        self.pfn_layers = nn.Module()
        self.pfn_layers.shared_mlps = nn.Sequential(*layers)

    @property
    def grid_shape(self):
        """(ny, nx)."""
        nx = int(round((self.pc_range[3] - self.pc_range[0]) / self.pillar_size))
        ny = int(round((self.pc_range[4] - self.pc_range[1]) / self.pillar_size))
        return ny, nx

    def _split_encode(self, points):
        """A point's feature block lands in the real slot when idf1 >= 0.5
        and in the virtual slot otherwise."""
        k = points.shape[-1] - 5
        if self.num_input_features != 3 + 2 * k + 2:
            raise ValueError(f"num_input_features {self.num_input_features} "
                             f"inconsistent with point dim {points.shape[-1]}")
        feats = points[..., 3:3 + k]
        is_virtual = (points[..., -2:-1] < 0.5).to(points.dtype)
        return torch.cat([points[..., 0:3], feats * (1 - is_virtual),
                          feats * is_virtual, points[..., -2:]], dim=-1)

    def forward(self, points, points_valid):
        """points (B, N, D), points_valid (B, N) bool -> (bev (B, ny, nx, C),
        occupancy mask (B, ny, nx, 1) bool)."""
        ny, nx = self.grid_shape
        if self.split:
            pt_features = self._split_encode(points)
        elif self.encoding_type == "direct":
            pt_features = points[..., :-2]
        else:
            pt_features = points
        pc_min = device_constant(tuple(self.pc_range[:3]), points.dtype, points.device)
        xyz_rel = points[..., 0:3] - pc_min
        ids, in_grid = points_to_pillar_ids(xyz_rel, points_valid, self.pillar_size, nx, ny)
        # z center is the absolute range midpoint while xyz is relative: an
        # inherited quirk of the reference's gen_indice_pairs
        ix = (ids % nx).to(points.dtype)
        iy = torch.div(ids, nx, rounding_mode="floor").to(points.dtype)
        center = torch.stack([
            (ix + 0.5) * self.pillar_size,
            (iy + 0.5) * self.pillar_size,
            torch.full_like(ix, (self.pc_range[5] + self.pc_range[2]) / 2),
        ], dim=-1)
        x = torch.cat([pt_features, xyz_rel, xyz_rel - center], dim=-1)
        dt = compute_dtype(self.dtype)
        mask = in_grid[..., None]
        mlps = self.pfn_layers.shared_mlps
        for i in range(0, len(mlps), 3):
            x = torch.relu(mlps[i + 1](x.to(dt) @ mlps[i].weight.t().to(dt), mask))
        x = x * mask.to(x.dtype)
        bev = scatter_max_dense(x, ids, ny * nx).reshape(x.shape[0], ny, nx, x.shape[-1])
        occ = scatter_any_dense(ids, ny * nx).reshape(x.shape[0], ny, nx, 1)
        return bev, occ
