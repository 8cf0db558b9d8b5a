"""Point-in-rotated-box test (counterpart of
``hgsfusion_tpu/ops/points_in_boxes.py``): numpy where infos are created,
torch where a loss tests its targets on the device."""
from __future__ import annotations

import numpy as np
import torch


def points_in_boxes(points, boxes):
    """points (N, 3), boxes (M, 7), both numpy or both torch -> (M, N) bool
    containment: local z within [-dz/2, dz/2], |local x| < dx/2, |local y|
    < dy/2 after rotating by -heading."""
    xp = torch if isinstance(points, torch.Tensor) else np
    shift = points[None, :, 0:3] - boxes[:, None, 0:3]  # (M, N, 3)
    cosa = xp.cos(-boxes[:, 6])[:, None]
    sina = xp.sin(-boxes[:, 6])[:, None]
    local_x = shift[..., 0] * cosa - shift[..., 1] * sina
    local_y = shift[..., 0] * sina + shift[..., 1] * cosa
    in_x = xp.abs(local_x) < boxes[:, None, 3] / 2
    in_y = xp.abs(local_y) < boxes[:, None, 4] / 2
    in_z = xp.abs(shift[..., 2]) <= boxes[:, None, 5] / 2
    return in_x & in_y & in_z
