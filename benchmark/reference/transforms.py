"""Rigid-transform helpers (y-axis rotation + translation), numpy and torch.

Counterpart of ``monopsr_tpu/geometry/transforms.py``: its numpy half
for the host (``np_get_tr_mat`` ... ``invert_tf``, copied), and its
device half in torch, whose functions broadcast over any leading axes
(the JAX versions take one box axis).

Convention: tr_mat = R(ry) @ T(t), i.e. translation applied first,
then rotation.
"""

import numpy as np
import torch


# ---------------------------------------------------------------------------
# NumPy (host-side)
# ---------------------------------------------------------------------------

def np_get_tr_mat(ry, t):
    """(4, 4) transform: translate by t then rotate by ry about y."""
    c, s = np.cos(ry), np.sin(ry)
    rot_mat = np.asarray([
        [c, 0.0, s, 0.0],
        [0.0, 1.0, 0.0, 0.0],
        [-s, 0.0, c, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ])
    t_mat = np.asarray([
        [1.0, 0.0, 0.0, t[0]],
        [0.0, 1.0, 0.0, t[1]],
        [0.0, 0.0, 1.0, t[2]],
        [0.0, 0.0, 0.0, 1.0],
    ])
    return rot_mat @ t_mat


def invert_tf(tr_mat):
    """Inverts a rigid (4, 4) transformation matrix."""
    rot_inv = tr_mat[0:3, 0:3].T
    t_inv = -tr_mat[0:3, 3]
    mat_inv = np.zeros((4, 4), np.float32)
    mat_inv[0:3, 0:3] = rot_inv
    mat_inv[0:3, 3] = rot_inv @ t_inv
    mat_inv[3, 3] = 1.0
    return mat_inv


# ---------------------------------------------------------------------------
# torch (device-side, batched)
# ---------------------------------------------------------------------------


def rotate_y_batch(points, ry):
    """Rotates (..., P, 3) points about the y axis by angles ry (...,)."""
    c = torch.cos(ry)[..., None]
    s = torch.sin(ry)[..., None]
    x, y, z = points.unbind(-1)
    xr = c * x + s * z
    zr = -s * x + c * z
    return torch.stack([xr, y, zr], dim=-1)
