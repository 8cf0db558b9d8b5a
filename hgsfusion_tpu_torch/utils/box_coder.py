"""SECOND-style 7-dof residual box coder (counterpart of
``hgsfusion_tpu/utils/box_coder.py::ResidualCoder``)."""
from __future__ import annotations

import torch


class ResidualCoder:
    """Boxes as anchor residuals: center / diagonal, log-size, d-theta."""

    def __init__(self, code_size: int = 7):
        if code_size != 7:
            raise NotImplementedError("only the 7-dof coder is ported")
        self.code_size = code_size

    def encode(self, boxes, anchors):
        """(..., 7) gt boxes + (..., 7) anchors -> (..., 7) targets; sizes
        clamped to 1e-5 before the log."""
        xa, ya, za, dxa, dya, dza, ra = anchors.unbind(-1)
        xg, yg, zg, dxg, dyg, dzg, rg = boxes.unbind(-1)
        dxa, dya, dza = (torch.clamp(v, min=1e-5) for v in (dxa, dya, dza))
        dxg, dyg, dzg = (torch.clamp(v, min=1e-5) for v in (dxg, dyg, dzg))
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        return torch.stack([
            (xg - xa) / diagonal, (yg - ya) / diagonal, (zg - za) / dza,
            torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza),
            rg - ra,
        ], dim=-1)

    def decode(self, box_encodings, anchors):
        """(..., 7) encodings + (..., 7) anchors -> (..., 7) boxes."""
        xa, ya, za, dxa, dya, dza, ra = anchors.unbind(-1)
        xt, yt, zt, dxt, dyt, dzt, rt = box_encodings.unbind(-1)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        return torch.stack([
            xt * diagonal + xa, yt * diagonal + ya, zt * dza + za,
            torch.exp(dxt) * dxa, torch.exp(dyt) * dya, torch.exp(dzt) * dza,
            rt + ra,
        ], dim=-1)
