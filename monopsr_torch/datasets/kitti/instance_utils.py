"""Instance-mask IO and host-side (numpy) instance-crop geometry.

Counterpart of ``monopsr_tpu/datasets/kitti/instance_utils.py``, reading
through ``utils.image_io`` instead of cv2. The numpy crop path mirrors
the device crop (``geometry/instance.instance_xyz_crop_from_depth_map``)
with the same nearest align-corners gather; it serves tests and offline
analysis, not the training or evaluation path.
"""

import os

import numpy as np

from monopsr_torch.geometry import boxes as box_geom
from monopsr_torch.geometry import class_stats, projection, transforms
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


def _nearest_align_corners_grid(box_2d, roi_size, map_shape):
    """Integer gather grid for crop + nearest resize (align_corners=True).

    Matches TF1 ResizeNearestNeighbor(align_corners=True) on the rounded
    box crop: scale = (in - 1) / (out - 1), src = round(i * scale).
    """
    roi_h, roi_w = roi_size
    height, width = map_shape

    y1, x1, y2, x2 = np.round(box_2d).astype(np.int64)
    ch = max(y2 - y1, 1)
    cw = max(x2 - x1, 1)

    iy = np.arange(roi_h, dtype=np.float32)
    ix = np.arange(roi_w, dtype=np.float32)
    src_y = y1 + np.round(iy * (ch - 1) / max(roi_h - 1, 1)).astype(np.int64)
    src_x = x1 + np.round(ix * (cw - 1) / max(roi_w - 1, 1)).astype(np.int64)

    return (np.clip(src_y, 0, height - 1), np.clip(src_x, 0, width - 1))


def np_instance_xyz_crop_from_depth_map(boxes_2d, boxes_3d, instance_masks,
                                        depth_map, roi_size, cam_p,
                                        viewing_angles,
                                        view_norm=True,
                                        centroid_type='middle',
                                        rotate_view=True):
    """GT instance xyz crops from a depth map (NumPy mirror of the device op).

    Args:
        boxes_2d: (N, 4) [y1, x1, y2, x2] boxes.
        boxes_3d: (N, 7) boxes_3d.
        instance_masks: (N, H, W) boolean masks.
        depth_map: (H, W) depth map.
        roi_size: (h, w).
        cam_p: (3, 4).
        viewing_angles: (N,).
        view_norm: shift (and optionally rotate) into local frame.
        centroid_type: 'middle' or 'bottom'.
        rotate_view: rotate by -viewing angle.

    Returns:
        xyz_maps: (N, h, w, 3), valid_masks: (N, h, w, 1).
    """
    xyz_maps = []
    valid_masks = []
    for box_2d, box_3d, mask, view_ang in zip(
            boxes_2d, boxes_3d, instance_masks, viewing_angles):
        src_y, src_x = _nearest_align_corners_grid(
            box_2d, roi_size, depth_map.shape)
        depth_crop = (depth_map * mask)[np.ix_(src_y, src_x)]

        valid = (np.abs(depth_crop) >= 0.1).astype(np.float32)

        pc_map = projection.np_depth_patch_to_pc_map(
            depth_crop, box_2d, cam_p, roi_size, round_box_2d=False,
            use_pixel_centres=True, use_corr_factors=False)

        if view_norm:
            x_offset = -cam_p[0, 3] / cam_p[0, 0]
            cen = np.asarray(box_3d[0:3], np.float64) - [x_offset, 0, 0]
            if centroid_type == 'middle':
                cen[1] -= box_3d[5] / 2.0

            points = pc_map.reshape(3, -1).T - cen
            if rotate_view:
                tr = transforms.np_get_tr_mat(-view_ang, (0, 0, 0))
                points = transforms.apply_tr_mat_to_points(tr, points)
            xyz = points.reshape(*roi_size, 3) * valid[..., None]
        else:
            xyz = pc_map.transpose(1, 2, 0) * valid[..., None]

        xyz_maps.append(xyz.astype(np.float32))
        valid_masks.append(valid[..., None])

    return np.asarray(xyz_maps), np.asarray(valid_masks)


def apply_view_norm_to_pc_map(inst_pc_map, valid_mask_map, viewing_angle,
                              centroid, roi_size):
    """(3, H, W) pc map -> (H, W, 3) view-normalized local xyz map."""
    tr_mat = transforms.np_get_tr_mat(-viewing_angle, -np.asarray(centroid))
    pc_padded = transforms.pad_pc(inst_pc_map.reshape(3, -1))
    pc_local = (tr_mat @ pc_padded)[0:3]
    xyz_map = pc_local.T.reshape(*roi_size, 3)
    return xyz_map * np.expand_dims(valid_mask_map, 2)


def inst_points_global_to_local(points_global, viewing_angle, centroid):
    """(N, 3) global points -> local frame (translate then rotate)."""
    tr_mat = transforms.np_get_tr_mat(-viewing_angle, -np.asarray(centroid))
    return transforms.apply_tr_mat_to_points(tr_mat, points_global)


def inst_points_local_to_global(points_local, viewing_angle, centroid):
    """(N, 3) local points -> global frame (rotate then translate)."""
    rot_mat = transforms.np_get_tr_mat(viewing_angle, (0.0, 0.0, 0.0))
    t_mat = transforms.np_get_tr_mat(0.0, centroid)
    rotated = transforms.apply_tr_mat_to_points(rot_mat, points_local)
    return transforms.apply_tr_mat_to_points(t_mat, rotated)


def est_y_from_box_2d_and_depth(cam_p, box_2d, depth, centroid_type,
                                obj_h=None, class_str=None,
                                trend_data='kitti'):
    """Estimates cen_y by projecting the 2D box centre at the given depth.

    Per-class trend offsets from class_stats (ref: instance_utils.py:841-904).
    """
    focal_length = cam_p[0, 0]
    centre_v = cam_p[1, 2]
    box_centre_v = (box_2d[2] + box_2d[0]) / 2.0 - centre_v
    cen_y_mid = box_centre_v * (depth / focal_length)

    if centroid_type == 'middle':
        return cen_y_mid - class_stats.cen_y_trend_offset(
            class_str, trend_data, 'middle')
    if centroid_type == 'bottom':
        if obj_h is None:
            obj_h = class_stats.MEAN_HEIGHTS[class_str]
        return (cen_y_mid + obj_h / 2.0 -
                class_stats.cen_y_trend_offset('Car', trend_data, 'bottom'))
    raise ValueError('Invalid centroid type: ' + str(centroid_type))


def get_prop_cen_z_offset(class_str):
    return class_stats.PROP_CEN_Z_OFFSET[class_str]


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
