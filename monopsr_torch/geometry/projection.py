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

from monopsr_torch.utils.grids import linspace


def np_project_pc_to_image(point_cloud, cam_p):
    """Projects a (3, N) point cloud to (2, N) [u, v] image points."""
    pc_padded = np.append(
        point_cloud, np.ones((1, point_cloud.shape[1])), axis=0)
    pts = cam_p @ pc_padded
    return pts[0:2] / pts[2]


def np_get_depth_point_cloud(depth_map, cam_p):
    """Backprojects a full (H, W) depth map to a (3, H * W) float32 point
    cloud in the cam0 frame, row by row."""
    depth_map = np.asarray(depth_map, np.float32)
    h, w = depth_map.shape[0:2]
    xx, yy = np.meshgrid(np.linspace(0, w - 1, w), np.linspace(0, h - 1, h))

    cu, cv, f = cam_p[0, 2], cam_p[1, 2], cam_p[0, 0]
    ratio = depth_map / f
    x = (xx - cu) * ratio - cam_p[0, 3] / f
    y = (yy - cv) * ratio
    return np.reshape(np.asarray([x, y, depth_map]), (3, -1)).astype(
        np.float32)


def _corr_factors(valid_depths, depth_map_shape):
    """Empirical projection-correction offsets by depth-map width.

    Clipped power laws fit per resolution
    (ref: depth_map_utils.py:128-158). Only 1242- and 1224-wide maps have
    published factors.
    """
    depth_map_h, depth_map_w = depth_map_shape
    if depth_map_w == 1242:
        xx_off = np.clip(3.38 * valid_depths ** -0.998, 0.049, 0.68)
        yy_off = np.clip(0.729 * valid_depths ** -0.998, 0.0105, 0.146)
    elif depth_map_w == 1224:
        xx_off = np.clip(6.07 * valid_depths ** -1.0, 0.087, 1.22)
        yy_off = np.clip(2.30 * valid_depths ** -1.0, 0.033, 0.459)
    else:
        raise NotImplementedError(
            'No correction factors for depth_map_w={}'.format(depth_map_w))
    return xx_off, yy_off


def np_depth_patch_to_pc_map(depth_patch, box_2d, cam_p, roi_size,
                             round_box_2d=True, use_pixel_centres=True,
                             use_corr_factors=True, depth_map_shape=None):
    """Backprojects an ROI depth patch to a (3, H, W) point-cloud map.

    Args:
        depth_patch: (H, W) depth patch resized to roi_size.
        box_2d: [y1, x1, y2, x2] 2D box the patch was cropped from.
        cam_p: (3, 4) camera projection matrix.
        roi_size: (h, w) ROI size.
        round_box_2d: round the 2D box before building the pixel grid.
        use_pixel_centres: sample at ROI pixel centres (vs top-left).
        use_corr_factors: apply per-resolution correction offsets.
        depth_map_shape: original (H, W) depth-map shape, required when
            use_corr_factors.

    Returns:
        (3, h, w) point-cloud map in the camera frame of cam_p.
    """
    depth_patch = np.squeeze(np.asarray(depth_patch))
    if round_box_2d:
        y1, x1, y2, x2 = np.round(box_2d)
    else:
        y1, x1, y2, x2 = box_2d

    num_x, num_y = roi_size[0], roi_size[1]
    pixel_w = (x2 - x1) / num_x
    pixel_h = (y2 - y1) / num_y

    if use_pixel_centres:
        xx, yy = np.meshgrid(
            np.linspace(x1 + pixel_w / 2.0, x2 - pixel_w / 2.0, num_x),
            np.linspace(y1 + pixel_h / 2.0, y2 - pixel_h / 2.0, num_y))
    else:
        xx, yy = np.meshgrid(
            np.linspace(x1, x2 - pixel_w, num_x),
            np.linspace(y1, y2 - pixel_h, num_y))

    if use_corr_factors:
        h, w = depth_map_shape
        valid_mask = depth_patch > 0.1
        xx_off, yy_off = _corr_factors(depth_patch[valid_mask],
                                       depth_map_shape)
        xx[valid_mask] += xx_off * (xx[valid_mask] / w)
        yy[valid_mask] += yy_off * (yy[valid_mask] / h)

    f = cam_p[0, 0]
    cu, cv = cam_p[0, 2], cam_p[1, 2]
    ratio = depth_patch / f
    return np.asarray(((xx - cu) * ratio, (yy - cv) * ratio, depth_patch))


def np_get_exp_proj_uv_map(box_2d, roi_size, round_box_2d=False,
                           use_pixel_centres=False):
    """(H, W, 2) expected uv grid of evenly spaced ROI pixels
    (ref: instance_utils.py:684-735)."""
    if round_box_2d:
        u1, u2 = np.round(box_2d[[1, 3]])
        v1, v2 = np.round(box_2d[[0, 2]])
    else:
        u1, u2 = box_2d[[1, 3]]
        v1, v2 = box_2d[[0, 2]]

    roi_h, roi_w = roi_size
    du = (u2 - u1) / roi_w
    dv = (v2 - v1) / roi_h

    if use_pixel_centres:
        grid_u = np.linspace(u1 + du / 2.0, u2 - du / 2.0, roi_w)
        grid_v = np.linspace(v1 + dv / 2.0, v2 - dv / 2.0, roi_h)
    else:
        grid_u = np.linspace(u1, u2 - du, roi_w)
        grid_v = np.linspace(v1, v2 - dv, roi_h)

    return np.dstack(np.meshgrid(grid_u, grid_v))


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
