"""Prediction formatting and re-scoring (host-side numpy).

Counterpart of ``monopsr_tpu/eval/predictions.py``: ``score_boxes``,
``format_predictions`` and ``save_predictions``, with the same float64
host math. Per-detection scalar math and file IO, so they stay on the
host; they take one sample's outputs as numpy arrays (the evaluator's
pipeline moves a dispatched group to the host once). The mask PNGs are
written by ``utils.image_io.write_png`` in place of ``cv2.imwrite``:
the same pixels, other compressed bytes.
"""

import os

import numpy as np

from monopsr_torch import constants as C
from monopsr_torch.datasets.kitti import calib_utils, instance_utils
from monopsr_torch.geometry import boxes as box_geom
from monopsr_torch.geometry import orientation
from monopsr_torch.utils import image_io


def score_boxes(dataset, sample_name, img_shape, boxes_2d, boxes_3d,
                valid_scores, max_depth=45.0):
    """Re-scores detections: 0.95 * mscnn + 0.05 * (depth + box-fit)/2.

    Box fit compares the projected 3D box corners against the 2D
    detection; truncated projections get a 0.1 fit score. One vectorised
    pass over all boxes, following the scalar rules of
    ``geometry.boxes.project_to_image_space``
    (tests/test_torch_eval_host.py holds the two together).
    """
    boxes_2d = np.asarray(boxes_2d, np.float64)
    boxes_3d = np.asarray(boxes_3d, np.float64)
    valid_scores = np.asarray(valid_scores, np.float64)
    if len(boxes_3d) == 0:
        return np.zeros_like(valid_scores)

    cam_p = calib_utils.get_frame_calib(dataset.calib_dir, sample_name).p2
    image_h, image_w = img_shape[0], img_shape[1]

    corners = box_geom.np_compute_box_3d_corners_batch(boxes_3d[:, 0:7])
    uv = box_geom.np_project_corners_batch(corners, cam_p)
    img_boxes = np.stack([uv[:, 0].min(-1), uv[:, 1].min(-1),
                          uv[:, 0].max(-1), uv[:, 1].max(-1)], axis=-1)

    # Discard rules of project_to_image_space(truncate=True,
    # discard_before_truncation=True): fully outside the image, or wider/
    # taller than 80% of it before truncation -> fit score 0.1
    outside = ((img_boxes[:, 0] > image_w) | (img_boxes[:, 1] > image_h) |
               (img_boxes[:, 2] < 0) | (img_boxes[:, 3] < 0))
    too_big = (
        (img_boxes[:, 2] - img_boxes[:, 0] > image_w * 0.8) |
        (img_boxes[:, 3] - img_boxes[:, 1] > image_h * 0.8))
    discarded = outside | too_big

    trunc = np.empty_like(img_boxes)
    trunc[:, 0] = np.maximum(img_boxes[:, 0], 0)
    trunc[:, 1] = np.maximum(img_boxes[:, 1], 0)
    trunc[:, 2] = np.minimum(img_boxes[:, 2], image_w)
    trunc[:, 3] = np.minimum(img_boxes[:, 3], image_h)

    iou_fmt = box_geom.boxes_2d_to_iou_fmt(boxes_2d)  # [x1 y1 x2 y2]
    with np.errstate(divide='ignore', invalid='ignore'):
        width = iou_fmt[:, 2] - iou_fmt[:, 0]
        height = iou_fmt[:, 3] - iou_fmt[:, 1]
        corner_err = (
            np.abs((iou_fmt[:, 0] - trunc[:, 0]) / width) +
            np.abs((iou_fmt[:, 2] - trunc[:, 2]) / width) +
            np.abs((iou_fmt[:, 1] - trunc[:, 1]) / height) +
            np.abs((iou_fmt[:, 3] - trunc[:, 3]) / height))
    fit_score = np.where(discarded, 0.1, 1.0 - corner_err)

    depth_score = np.clip(1.0 - boxes_3d[:, 2] / max_depth, 0.1, 1.0)
    combined = (depth_score + fit_score) / 2.0
    return (0.95 * valid_scores +
            0.05 * combined.reshape(valid_scores.shape))


def format_predictions(cfg, output_dict, sample_dict, dataset,
                       train_val_test, post_process_cen_x=True):
    """Formats raw network outputs into detection arrays.

    Args:
        cfg: NetConfig.
        output_dict: numpy dict of network outputs for one sample.
        sample_dict: the host sample dict.
        dataset: KittiDataset (for calibration lookup in score_boxes).
        train_val_test: run mode.
        post_process_cen_x: refine cen_x from projected corner ratios.

    Returns:
        pred_dict with KEY_BOX_3D (num_objs, 9) rows
        [x y z l w h ry score class], KEY_BOX_2D (num_objs, 7) rows
        [y1 x1 y2 x2 alpha score class], masked local xyz maps, masks.
    """
    sample_name = sample_dict[C.SAMPLE_NAME]
    img = sample_dict[C.SAMPLE_IMAGE_INPUT]
    num_objs = int(sample_dict[C.SAMPLE_NUM_OBJS])
    cam_p = sample_dict[C.SAMPLE_CAM_P]
    all_scores = sample_dict[C.SAMPLE_LABEL_SCORES]
    valid_scores = np.expand_dims(all_scores[0:num_objs], 1)

    pred_dict = {}

    # Masks are logits from a sigmoid loss -> threshold at 0
    valid_mask_maps = (np.asarray(
        output_dict[C.KEY_VALID_MASK_MAPS])[0:num_objs] > 0.0
        ).astype(np.float32)
    pred_dict[C.KEY_VALID_MASK_MAPS] = valid_mask_maps

    pred_local = np.asarray(
        output_dict[C.KEY_INST_XYZ_MAP_LOCAL])[0:num_objs]
    pred_dict[C.KEY_INST_XYZ_MAP_LOCAL] = pred_local * valid_mask_maps

    # Device outputs may arrive truncated to a slot bucket
    # (pack_outputs_for_host max_slots); the host-side label arrays are
    # always full num_boxes — trim them to the device slot count
    # (bucket >= num_objs always, so no valid row is lost).
    n_slots = int(np.asarray(output_dict[C.KEY_LWH]).shape[0])

    # Assemble boxes_3d
    new_boxes_2d = np.copy(
        sample_dict[C.SAMPLE_LABEL_BOXES_2D][:n_slots])
    if train_val_test in ('train', 'val'):
        new_boxes_3d = np.copy(
            sample_dict[C.SAMPLE_LABEL_BOXES_3D][:n_slots])
    else:
        new_boxes_3d = np.zeros([n_slots, 7], np.float32)

    new_boxes_3d[:, 3:6] = np.asarray(output_dict[C.KEY_LWH])

    sample_viewing_angles = np.asarray(output_dict[C.KEY_VIEW_ANG])

    # Alpha from the discrete-continuous head
    if cfg.alpha_type in ('dc', 'dc_rotation'):
        pred_bins = np.asarray(output_dict[C.KEY_ALPHA_BINS])
        pred_regs = np.asarray(output_dict[C.KEY_ALPHA_REGS])
        best_bins = np.argmax(pred_bins, axis=1)
        best_regs = pred_regs[np.arange(len(best_bins)), best_bins]
        pred_alphas = orientation.np_angle_bin_to_orientation(
            best_bins, best_regs, cfg.num_alpha_bins)
    elif cfg.alpha_type == 'prob':
        pred_alphas = np.squeeze(np.asarray(output_dict[C.KEY_ALPHA]))
    else:
        raise ValueError('Invalid alpha type: ' + cfg.alpha_type)

    pred_rys = pred_alphas + np.squeeze(sample_viewing_angles)
    new_boxes_3d[:, 6] = pred_rys

    pred_centroids = np.copy(np.asarray(output_dict[C.KEY_CENTROIDS]))
    if cfg.centroid_type == 'middle':
        pred_centroids[:, 1:2] += new_boxes_3d[:, 5:6] / 2.0
    new_boxes_3d[:, 0:3] = pred_centroids

    if post_process_cen_x:
        new_boxes_3d[:, 0] = instance_utils.postprocess_cen_x_batch(
            new_boxes_2d, new_boxes_3d, cam_p)

    valid_boxes_3d = new_boxes_3d[0:num_objs]
    valid_boxes_2d = new_boxes_2d[0:num_objs]

    new_scores = score_boxes(dataset, sample_name, img.shape,
                             valid_boxes_2d, valid_boxes_3d, valid_scores)

    classes = (np.asarray(
        sample_dict[C.SAMPLE_LABEL_CLASS_INDICES])[0:num_objs] - 1)

    pred_dict[C.KEY_BOX_3D] = np.hstack(
        [valid_boxes_3d, new_scores, classes])

    valid_alphas = np.expand_dims(np.asarray(pred_alphas)[0:num_objs], 1)
    pred_dict[C.KEY_BOX_2D] = np.hstack(
        [valid_boxes_2d, valid_alphas, new_scores, classes])

    return pred_dict


def save_predictions(pred_dict, sample_name, output_dirs):
    """Writes one sample's float16 local xyz maps (.npy), its masks (one
    8-bit PNG per detection, 0 or 255) and its box_3d / box_2d rows."""
    if C.OUT_DIR_XYZ_MAP_LOCAL in output_dirs:
        xyz_dir = output_dirs[C.OUT_DIR_XYZ_MAP_LOCAL]
        np.save(os.path.join(xyz_dir, sample_name + '.npy'),
                pred_dict[C.KEY_INST_XYZ_MAP_LOCAL].astype(np.float16))

        masks = (pred_dict[C.KEY_VALID_MASK_MAPS].astype(np.uint8) * 255)
        for mask_idx, mask in enumerate(masks):
            image_io.write_png(os.path.join(
                xyz_dir, '{}_{}.png'.format(sample_name, mask_idx)), mask)

    if C.OUT_DIR_BOX_3D in output_dirs:
        np.savetxt(os.path.join(output_dirs[C.OUT_DIR_BOX_3D],
                                sample_name + '.txt'),
                   pred_dict[C.KEY_BOX_3D], fmt='%0.5f')

    if C.OUT_DIR_BOX_2D in output_dirs:
        np.savetxt(os.path.join(output_dirs[C.OUT_DIR_BOX_2D],
                                sample_name + '.txt'),
                   pred_dict[C.KEY_BOX_2D], fmt='%0.5f')
