"""SECOND-style residual box coder (counterpart of
``hgsfusion_tpu/utils/box_coder.py::ResidualCoder``): the 7-dof code of the
HGSFusion heads and the 9-dof (velocity) / sin-cos codes of the multi-head
zoo configs."""
from __future__ import annotations

import torch


class ResidualCoder:
    """Boxes as anchor residuals: center / diagonal, log-size, d-theta (or,
    with ``encode_angle_by_sincos``, cos and sin differences, one column
    more), then the extra columns (velocities) as plain differences.
    ``code_size`` is the encoding's width: the box width plus one with
    sin-cos."""

    def __init__(self, code_size: int = 7, encode_angle_by_sincos: bool = False):
        self.encode_angle_by_sincos = bool(encode_angle_by_sincos)
        self.code_size = int(code_size) + (1 if self.encode_angle_by_sincos else 0)

    def encode(self, boxes, anchors):
        """(..., 7 + C) gt boxes + (..., >= 7 + C) anchors (broadcast) ->
        (..., code_size) targets; sizes clamped to 1e-5 before the log."""
        xa, ya, za, dxa, dya, dza, ra = anchors[..., :7].unbind(-1)
        xg, yg, zg, dxg, dyg, dzg, rg = boxes[..., :7].unbind(-1)
        dxa, dya, dza = (torch.clamp(v, min=1e-5) for v in (dxa, dya, dza))
        dxg, dyg, dzg = (torch.clamp(v, min=1e-5) for v in (dxg, dyg, dzg))
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        if self.encode_angle_by_sincos:
            rts = [torch.cos(rg) - torch.cos(ra), torch.sin(rg) - torch.sin(ra)]
        else:
            rts = [rg - ra]
        cts = [boxes[..., 7 + i] - anchors[..., 7 + i] for i in range(boxes.shape[-1] - 7)]
        cols = [(xg - xa) / diagonal, (yg - ya) / diagonal, (zg - za) / dza,
                torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza), *rts, *cts]
        return torch.stack(torch.broadcast_tensors(*cols), dim=-1)

    def decode(self, box_encodings, anchors):
        """(..., code_size) encodings + (..., >= 7) anchors -> (..., 7 + C)
        boxes."""
        xa, ya, za, dxa, dya, dza, ra = anchors[..., :7].unbind(-1)
        off = 8 if self.encode_angle_by_sincos else 7
        xt, yt, zt, dxt, dyt, dzt = box_encodings[..., :6].unbind(-1)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        if self.encode_angle_by_sincos:
            rg = torch.atan2(box_encodings[..., 7] + torch.sin(ra),
                             box_encodings[..., 6] + torch.cos(ra))
        else:
            rg = box_encodings[..., 6] + ra
        cgs = [box_encodings[..., off + i] + anchors[..., 7 + i]
               for i in range(box_encodings.shape[-1] - off)]
        return torch.stack([
            xt * diagonal + xa, yt * diagonal + ya, zt * dza + za,
            torch.exp(dxt) * dxa, torch.exp(dyt) * dya, torch.exp(dzt) * dza, rg, *cgs,
        ], dim=-1)
