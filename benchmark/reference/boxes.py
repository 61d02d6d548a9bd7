"""box_3d format helpers: [x, y, z, l, w, h, ry].

Counterpart of ``monopsr_tpu/geometry/boxes.py``: the numpy functions,
which the evaluator's prediction formatting runs (corners, their
projection, the 2D box reorder and ``project_to_image_space``, whose
scalar rules the vectorised ``eval/predictions.score_boxes`` follows) and
the instance-mask tool runs (``points_in_box_3d``), and the batched
corners in torch (``compute_box_3d_corners_batch``).

Corner convention: 8 corners with y in {0 (bottom), -h (top)}, i.e. the
box_3d origin is the bottom-face centre.
"""

import numpy as np
import torch

from benchmark.reference import projection
from benchmark.reference.device import constant


def np_compute_box_3d_corners(box_3d):
    """(7,) box_3d -> (3, 8) corners."""
    tx, ty, tz, l, w, h, ry = box_3d
    half_l, half_w = l / 2.0, w / 2.0
    c, s = np.cos(ry), np.sin(ry)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    x_c = np.array([half_l, half_l, -half_l, -half_l,
                    half_l, half_l, -half_l, -half_l])
    y_c = np.array([0, 0, 0, 0, -h, -h, -h, -h], dtype=np.float64)
    z_c = np.array([half_w, -half_w, -half_w, half_w,
                    half_w, -half_w, -half_w, half_w])
    corners = rot @ np.array([x_c, y_c, z_c])
    corners[0] += tx
    corners[1] += ty
    corners[2] += tz
    return corners


def np_compute_box_3d_corners_batch(boxes_3d):
    """(N, 7) boxes_3d -> (N, 3, 8) corners."""
    b = np.asarray(boxes_3d, np.float64)
    tx, ty, tz = b[:, 0], b[:, 1], b[:, 2]
    l, w, h, ry = b[:, 3], b[:, 4], b[:, 5], b[:, 6]

    sign_x = np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float64)
    sign_y = np.array([0, 0, 0, 0, -1, -1, -1, -1], np.float64)
    sign_z = np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float64)

    x_c = (l / 2.0)[:, None] * sign_x[None, :]
    y_c = h[:, None] * sign_y[None, :]
    z_c = (w / 2.0)[:, None] * sign_z[None, :]

    c, s = np.cos(ry)[:, None], np.sin(ry)[:, None]
    xr = c * x_c + s * z_c + tx[:, None]
    yr = y_c + ty[:, None]
    zr = -s * x_c + c * z_c + tz[:, None]
    return np.stack([xr, yr, zr], axis=1)


def np_project_corners_batch(corners, cam_p):
    """(N, 3, K) points + (3, 4) cam_p -> (N, 2, K) pixel coords."""
    pts = (np.einsum('ij,njk->nik', cam_p[:, :3], corners) +
           cam_p[:, 3][None, :, None])
    return pts[:, 0:2] / pts[:, 2:3]


def compute_box_3d_corners_batch(boxes_3d):
    """(N, 7) boxes_3d tensor -> (N, 3, 8) corners, in its dtype."""
    tx, ty, tz = boxes_3d[:, 0], boxes_3d[:, 1], boxes_3d[:, 2]
    l, w, h, ry = (boxes_3d[:, i] for i in range(3, 7))
    half_l, half_w = l / 2.0, w / 2.0

    def signs(values):
        return constant(values, boxes_3d.dtype, boxes_3d.device)

    sign_x = signs([1, 1, -1, -1, 1, 1, -1, -1])
    sign_y = signs([0, 0, 0, 0, -1, -1, -1, -1])
    sign_z = signs([1, -1, -1, 1, 1, -1, -1, 1])

    x_c = half_l[:, None] * sign_x[None, :]
    y_c = h[:, None] * sign_y[None, :]
    z_c = half_w[:, None] * sign_z[None, :]

    c, s = torch.cos(ry)[:, None], torch.sin(ry)[:, None]
    xr = c * x_c + s * z_c + tx[:, None]
    yr = y_c + ty[:, None]
    zr = -s * x_c + c * z_c + tz[:, None]
    return torch.stack([xr, yr, zr], dim=1)


def points_in_box_3d(box_3d, points):
    """Selects (N, 3) points inside a box_3d; returns (points, mask).

    Axis-projection containment test.
    """
    corners = np_compute_box_3d_corners(box_3d).T  # (8, 3)
    u = corners[0] - corners[1]
    v = corners[0] - corners[3]
    w = corners[0] - corners[4]

    u_dot = points @ u
    v_dot = points @ v
    w_dot = points @ w

    mask = ((u_dot <= u @ corners[0]) & (u_dot >= u @ corners[1]) &
            (v_dot <= v @ corners[0]) & (v_dot >= v @ corners[3]) &
            (w_dot <= w @ corners[0]) & (w_dot >= w @ corners[4]))
    return points[mask], mask


def boxes_2d_to_iou_fmt(boxes_2d):
    """[y1, x1, y2, x2] -> [x1, y1, x2, y2]."""
    boxes_2d = np.asarray(boxes_2d)
    return boxes_2d[:, [1, 0, 3, 2]]


def project_to_image_space(box_3d, cam_p, truncate=False, image_size=None,
                           discard=True, discard_before_truncation=True):
    """Projects a box_3d into image space -> [x1, y1, x2, y2] or None.

    Boxes fully outside the image return None; boxes wider or taller than
    80% of the image are discarded before truncation (or, with
    discard_before_truncation=False, boxes covering >80% of width AND
    height after truncation).
    """
    corners = np_compute_box_3d_corners(box_3d)
    projected = projection.np_project_pc_to_image(corners, cam_p)

    img_box = np.array([np.amin(projected[0]), np.amin(projected[1]),
                        np.amax(projected[0]), np.amax(projected[1])])

    if not truncate:
        return img_box

    if not image_size:
        raise ValueError('Image size must be provided')
    image_w, image_h = image_size[0], image_size[1]

    if (img_box[0] > image_w or img_box[1] > image_h or
            img_box[2] < 0 or img_box[3] < 0):
        return None

    if discard and discard_before_truncation:
        bw = img_box[2] - img_box[0]
        bh = img_box[3] - img_box[1]
        if bw > image_w * 0.8 or bh > image_h * 0.8:
            return None

    img_box[0] = max(img_box[0], 0)
    img_box[1] = max(img_box[1], 0)
    img_box[2] = min(img_box[2], image_w)
    img_box[3] = min(img_box[3], image_h)

    if discard and not discard_before_truncation:
        bw = img_box[2] - img_box[0]
        bh = img_box[3] - img_box[1]
        if bw > image_w * 0.8 and bh > image_h * 0.8:
            return None

    return img_box
