"""Demo/analysis helpers: experiment info, GT matching by 3D IoU.

Counterpart of ``monopsr_tpu/utils/demo_utils.py``, on the port's
config reader and 3D IoU.
"""

import os

import numpy as np

import monopsr_torch
from monopsr_torch import config as config_utils
from monopsr_torch.datasets.kitti import evaluation


def get_experiment_info(checkpoint_name, output_base_dir=None):
    """Loads the frozen config of an experiment and its key paths."""
    if output_base_dir is None:
        output_base_dir = os.path.join(monopsr_torch.data_dir(), 'outputs')
    exp_dir = os.path.join(output_base_dir, checkpoint_name)
    yaml_path = os.path.join(exp_dir, checkpoint_name + '.yaml')
    if not os.path.exists(yaml_path):
        raise FileNotFoundError('Experiment config not found: ' +
                                yaml_path)
    config = config_utils.parse_yaml_config(
        yaml_path, output_base_dir=output_base_dir)
    return config, exp_dir


def match_predictions_to_gt(pred_boxes_3d, gt_boxes_3d):
    """Greedy max-3D-IoU matching of predictions to GT boxes_3d.

    Args:
        pred_boxes_3d: (N, 7) predictions [x y z l w h ry].
        gt_boxes_3d: (M, 7) ground truth.

    Returns:
        (match_idx (N,), match_iou (N,)): GT index (-1 unmatched) and IoU.
    """
    def to_iou_fmt(b):
        # [ry, l, h, w, tx, ty, tz]
        return np.asarray([b[6], b[3], b[5], b[4], b[0], b[1], b[2]])

    match_idx = np.full(len(pred_boxes_3d), -1, np.int64)
    match_iou = np.zeros(len(pred_boxes_3d))
    if len(gt_boxes_3d) == 0:
        return match_idx, match_iou

    gt_fmt = np.stack([to_iou_fmt(g) for g in gt_boxes_3d])
    for i, pred in enumerate(pred_boxes_3d):
        ious = np.atleast_1d(
            evaluation.three_d_iou(to_iou_fmt(pred), gt_fmt))
        j = int(np.argmax(ious))
        if ious[j] > 0:
            match_idx[i] = j
            match_iou[i] = ious[j]
    return match_idx, match_iou


def difficulty_colour(obj):
    """Colour by KITTI difficulty (green easy / yellow mod / red hard)."""
    from monopsr_torch.datasets.kitti.obj_utils import (
        HEIGHT, OCCLUSION, TRUNCATION)
    height = obj.y2 - obj.y1
    for level, colour in ((0, 'green'), (1, 'yellow'), (2, 'red')):
        if (obj.occlusion <= OCCLUSION[level] and
                obj.truncation <= TRUNCATION[level] and
                height >= HEIGHT[level]):
            return colour
    return 'magenta'
