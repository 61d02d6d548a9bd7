"""Instance-image IO and the cen_x post-process (host side).

Counterpart of ``read_instance_image``, ``get_instance_image``,
``get_instance_mask_list``, ``postprocess_cen_x`` and
``postprocess_cen_x_batch`` in ``monopsr_tpu/datasets/kitti/
instance_utils.py``, reading through ``utils.image_io`` instead of cv2.
The numpy instance-crop functions of that module have no caller on the
training or evaluation path and are not ported (ROADMAP M15).
"""

import os

import numpy as np

from monopsr_torch.geometry import boxes as box_geom
from monopsr_torch.geometry import projection
from monopsr_torch.utils import image_io


def read_instance_image(instance_image_path):
    """The (H, W) uint8 instance image: pixels hold the index of the
    object label they belong to, 255 elsewhere."""
    try:
        instance_image = image_io.read_png(instance_image_path)
    except FileNotFoundError:
        raise FileNotFoundError('Instance image not found: ' +
                                instance_image_path) from None
    if instance_image.ndim != 2 or instance_image.dtype != np.uint8:
        raise ValueError('Instance image is not 8-bit gray: ' +
                         instance_image_path)
    return instance_image


def get_instance_image(sample_name, instance_dir):
    return read_instance_image(
        os.path.join(instance_dir, '{}.png'.format(sample_name)))


def get_instance_mask_list(instance_img, num_instances=None):
    """(H, W) instance image -> (k, H, W) boolean masks.

    Pixels hold the instance index; 255 = background.
    """
    if num_instances is None:
        valid = instance_img[instance_img != 255]
        if len(valid) == 0:
            return []
        num_instances = np.max(valid) + 1
    return np.asarray([(instance_img == idx)
                       for idx in range(num_instances)])


def postprocess_cen_x(pred_box_2d, pred_box_3d, cam_p):
    """Refines cen_x from the projected-corner width ratio.

    Projects the predicted 3D box, finds where the centroid sits within
    the projected width, maps that ratio onto the detected 2D box, and
    backprojects at the predicted depth. The scalar rule that
    ``postprocess_cen_x_batch`` vectorises.
    """
    focal_length = cam_p[0, 0]
    centre_u = cam_p[0, 2]

    corners = box_geom.np_compute_box_3d_corners(pred_box_3d)
    corners_uv = projection.np_project_pc_to_image(corners, cam_p)

    cen_uv = projection.np_project_pc_to_image(
        np.asarray(pred_box_3d[0:3]).reshape(3, 1), cam_p)

    min_u = np.amin(corners_uv[0])
    max_u = np.amax(corners_uv[0])
    u_ratio = (cen_uv[0] - min_u) / (max_u - min_u)

    box_w = pred_box_2d[3] - pred_box_2d[1]
    pred_u = pred_box_2d[1] + u_ratio * box_w

    ratio = pred_box_3d[2] / focal_length
    return (pred_u - centre_u) * ratio


def postprocess_cen_x_batch(pred_boxes_2d, pred_boxes_3d, cam_p):
    """Vectorised postprocess_cen_x over (N, 4+) boxes_2d / (N, 7)
    boxes_3d: one pass of batched corner projection."""
    pred_boxes_2d = np.asarray(pred_boxes_2d, np.float64)
    pred_boxes_3d = np.asarray(pred_boxes_3d, np.float64)
    if len(pred_boxes_3d) == 0:
        return np.zeros((0,), np.float64)

    focal_length = cam_p[0, 0]
    centre_u = cam_p[0, 2]

    corners = box_geom.np_compute_box_3d_corners_batch(
        pred_boxes_3d[:, 0:7])
    corners_uv = box_geom.np_project_corners_batch(corners, cam_p)
    cen_uv = box_geom.np_project_corners_batch(
        pred_boxes_3d[:, 0:3, None], cam_p)

    min_u = corners_uv[:, 0].min(-1)
    max_u = corners_uv[:, 0].max(-1)
    with np.errstate(divide='ignore', invalid='ignore'):
        u_ratio = (cen_uv[:, 0, 0] - min_u) / (max_u - min_u)

    box_w = pred_boxes_2d[:, 3] - pred_boxes_2d[:, 1]
    pred_u = pred_boxes_2d[:, 1] + u_ratio * box_w
    return (pred_u - centre_u) * pred_boxes_3d[:, 2] / focal_length
