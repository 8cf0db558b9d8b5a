"""Point-in-rotated-box test in numpy (counterpart of the numpy branch of
``hgsfusion_tpu/ops/points_in_boxes.py``), used when infos are created."""
from __future__ import annotations

import numpy as np


def points_in_boxes(points, boxes):
    """points (N, 3), boxes (M, 7) -> (M, N) bool containment: local z within
    [-dz/2, dz/2], |local x| < dx/2, |local y| < dy/2 after rotating by
    -heading."""
    shift = points[None, :, 0:3] - boxes[:, None, 0:3]  # (M, N, 3)
    cosa = np.cos(-boxes[:, 6])[:, None]
    sina = np.sin(-boxes[:, 6])[:, None]
    local_x = shift[..., 0] * cosa - shift[..., 1] * sina
    local_y = shift[..., 0] * sina + shift[..., 1] * cosa
    in_x = np.abs(local_x) < boxes[:, None, 3] / 2
    in_y = np.abs(local_y) < boxes[:, None, 4] / 2
    in_z = np.abs(shift[..., 2]) <= boxes[:, None, 5] / 2
    return in_x & in_y & in_z
