"""Ground-plane helpers (numpy); own copy of
``monopsr_tpu/geometry/planes.py``."""

import numpy as np


def dist_to_plane(plane, points):
    """Signed distances from (N, 3) points to a plane [a, b, c, d]."""
    a, b, c, d = plane
    points = np.asarray(points)
    num = a * points[:, 0] + b * points[:, 1] + c * points[:, 2] + d
    return num / np.sqrt(a * a + b * b + c * c)


def project_points_to_plane(plane, points):
    """Projects (N, 3) points onto the plane."""
    normal = np.asarray(plane[0:3], np.float64)
    normal = normal / np.linalg.norm(normal)
    dists = dist_to_plane(plane, points)
    return np.asarray(points) - dists[:, None] * normal[None, :]
