"""Camera projection and depth-patch backprojection, torch and numpy.

Counterpart of ``monopsr_tpu/geometry/projection.py``: its device-side
half, and its numpy functions for the host dataset layer, the
data-preparation tools and the numpy instance crops
(``datasets/kitti/instance_utils``). The JAX
functions take one sample's box axis and a (3, 4) camera; here
``depth_patch_to_pc_map_batch`` takes a leading image axis B with one
(3, 4) camera per image, and the other two broadcast over any leading
axes.
"""

import numpy as np
import torch

from benchmark.reference.grids import linspace


def np_project_pc_to_image(point_cloud, cam_p):
    """Projects a (3, N) point cloud to (2, N) [u, v] image points."""
    pc_padded = np.append(
        point_cloud, np.ones((1, point_cloud.shape[1])), axis=0)
    pts = cam_p @ pc_padded
    return pts[0:2] / pts[2]


def project_pc_to_image_batch(point_cloud, cam_p, min_depth=1e-3):
    """Projects point clouds to image space.

    The homogeneous divide uses a sign-preserving depth clamp: points at
    z ~ 0 (invalid slots, or predictions mid-training) would otherwise
    emit inf.

    Args:
        point_cloud: (..., 3, N) point clouds.
        cam_p: (..., 3, 4) camera matrices, broadcastable against the
            point clouds' leading axes (a plain (3, 4) works too).
        min_depth: minimum |z| used in the divide.

    Returns:
        (..., 2, N) projected [u, v] coordinates.
    """
    pc_padded = torch.cat(
        [point_cloud, torch.ones_like(point_cloud[..., :1, :])], dim=-2)
    pts = torch.matmul(cam_p, pc_padded)
    z = pts[..., 2:3, :]
    z_safe = torch.where(z.abs() < min_depth,
                         torch.where(z < 0, -min_depth, min_depth), z)
    return pts[..., 0:2, :] / z_safe


def _roi_axis(c1, c2, num, use_pixel_centres):
    """Evenly spaced ROI coordinates between box edges: (..., num)."""
    pixel = (c2 - c1) / num
    t = linspace(0.0, 1.0, num, c1.device).to(c1.dtype)
    start = c1 + pixel / 2.0 if use_pixel_centres else c1
    return start[..., None] + t * (c2 - c1 - pixel)[..., None]


def depth_patch_to_pc_map_batch(depth_patches, boxes_2d, cam_p, roi_size,
                                use_pixel_centres=True):
    """Batched depth-patch backprojection.

    Args:
        depth_patches: (B, N, h, w) depth patches (already resized to ROI).
        boxes_2d: (B, N, 4) [y1, x1, y2, x2] source boxes (unrounded).
        cam_p: (B, 3, 4) camera projection matrices.
        roi_size: (h, w) ROI size.
        use_pixel_centres: sample at ROI pixel centres.

    Returns:
        (B, N, h, w, 3) point-cloud maps.
    """
    num_y, num_x = roi_size
    y1, x1, y2, x2 = boxes_2d.unbind(-1)
    xs = _roi_axis(x1, x2, num_x, use_pixel_centres)    # (B, N, w)
    ys = _roi_axis(y1, y2, num_y, use_pixel_centres)    # (B, N, h)
    xx = xs[..., None, :]
    yy = ys[..., :, None]

    def cam(r, c):
        return cam_p[:, r, c][:, None, None, None]

    ratio = depth_patches / cam(0, 0)
    x = (xx - cam(0, 2)) * ratio
    y = (yy - cam(1, 2)) * ratio
    return torch.stack([x, y, depth_patches], dim=-1)


def get_exp_proj_uv_map_batch(boxes_2d, roi_size, round_box_2d=False,
                              use_pixel_centres=True):
    """(..., N, h, w, 2) expected uv grids of evenly spaced ROI pixels,
    with pixel-centre sampling by default."""
    if round_box_2d:
        boxes_2d = torch.round(boxes_2d)
    v1, u1, v2, u2 = boxes_2d.unbind(-1)
    roi_h, roi_w = roi_size
    grid_u = _roi_axis(u1, u2, roi_w, use_pixel_centres)   # (..., w)
    grid_v = _roi_axis(v1, v2, roi_h, use_pixel_centres)   # (..., h)
    shape = grid_u.shape[:-1] + (roi_h, roi_w)
    uu = grid_u[..., None, :].expand(shape)
    vv = grid_v[..., :, None].expand(shape)
    return torch.stack([uu, vv], dim=-1)
