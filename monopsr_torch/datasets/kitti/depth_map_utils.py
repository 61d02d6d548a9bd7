"""Depth-map IO and LiDAR depth rendering (host side).

Counterpart of ``read_depth_map``, ``save_depth_map`` and
``project_depths`` in ``monopsr_tpu/datasets/kitti/depth_map_utils.py``,
reading and writing through ``utils.image_io`` instead of cv2.
"""

import numpy as np

from monopsr_torch.geometry import projection
from monopsr_torch.utils import image_io


def read_depth_map(depth_map_path):
    """Reads a uint16 png depth map; depths < 0.1m are zeroed."""
    try:
        depth_image = image_io.read_png(depth_map_path)
    except FileNotFoundError:
        raise FileNotFoundError(
            'Depth map not found: ' + depth_map_path) from None
    depth_map = depth_image / 256.0
    depth_map[depth_map < 0.1] = 0.0
    return depth_map.astype(np.float32)


def save_depth_map(save_path, depth_map):
    """Saves a depth map to disk as a uint16 png (metres * 256, truncated
    towards zero as numpy casts). The zlib level is the writer's own, so
    the file's bytes differ from cv2's; its pixels do not."""
    depth_image = (depth_map * 256.0).astype(np.uint16)
    image_io.write_png(save_path, depth_image)


def project_depths(point_cloud, cam_p, image_shape, max_depth=100.0):
    """Projects a (3, N) cam0 point cloud to a sparse (H, W) depth map.

    Keeps the closest point per pixel via an inverted-depth max-scatter
    (np.maximum.at).
    """
    points_in_img = projection.np_project_pc_to_image(point_cloud, cam_p)
    points_int = np.int32(np.round(points_in_img))

    valid = ((points_int[0] >= 0) & (points_int[0] < image_shape[1]) &
             (points_int[1] >= 0) & (points_int[1] < image_shape[0]))

    depths = point_cloud[2, valid]
    us = points_int[0, valid]
    vs = points_int[1, valid]

    inverted = max_depth - depths
    projected = np.zeros(image_shape, np.float32)
    np.maximum.at(projected, (vs, us), inverted)

    nonzero = projected > 0
    projected[nonzero] = max_depth - projected[nonzero]
    return projected.astype(np.float32)
