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
import torch.nn.functional as F


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


def pad_pc(point_cloud):
    """(3, N) -> (4, N) homogeneous point cloud."""
    return np.pad(point_cloud, ((0, 1), (0, 0)), mode='constant',
                  constant_values=1.0)


def pad_points(points):
    """(N, 3) -> (N, 4) homogeneous points."""
    return np.pad(points, ((0, 0), (0, 1)), mode='constant',
                  constant_values=1.0)


def apply_tr_mat_to_points(tr_mat, points):
    """Applies a (4, 4) transform to (N, 3) points; returns (N, 3)."""
    pc_padded = pad_points(points).T
    return (tr_mat @ pc_padded)[0:3].T


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


def get_tr_mat_batch(ry, t):
    """Batched (..., 4, 4) transforms: translate by t then rotate by ry.

    Args:
        ry: (...,) rotations about y.
        t: (..., 3) translations.

    Returns:
        tr_mat, rot_mat, t_mat: each (..., 4, 4).
    """
    zeros = torch.zeros_like(ry)
    ones = torch.ones_like(ry)
    c, s = torch.cos(ry), torch.sin(ry)

    def rows(*entries):
        return torch.stack([torch.stack(r, dim=-1) for r in entries], dim=-2)

    rot_mat = rows((c, zeros, s, zeros),
                   (zeros, ones, zeros, zeros),
                   (-s, zeros, c, zeros),
                   (zeros, zeros, zeros, ones))
    t_mat = rows((ones, zeros, zeros, t[..., 0]),
                 (zeros, ones, zeros, t[..., 1]),
                 (zeros, zeros, ones, t[..., 2]),
                 (zeros, zeros, zeros, ones))
    return rot_mat @ t_mat, rot_mat, t_mat


def pad_pc_batch(point_cloud):
    """(..., 3, N) -> (..., 4, N) homogeneous point cloud."""
    return F.pad(point_cloud, (0, 0, 0, 1), value=1.0)


def rotate_y_batch(points, ry):
    """Rotates (..., P, 3) points about the y axis by angles ry (...,)."""
    c = torch.cos(ry)[..., None]
    s = torch.sin(ry)[..., None]
    x, y, z = points.unbind(-1)
    xr = c * x + s * z
    zr = -s * x + c * z
    return torch.stack([xr, y, zr], dim=-1)
