"""NumPy 2D/3D IoU and PR-curve AP (host side).

Own copy of ``monopsr_tpu/datasets/kitti/evaluation.py`` (the
reference's src/monopsr/core/evaluation.py:23-500). Used for the MSCNN merge,
box jitter, and offline analysis; the authoritative KITTI AP comes from
the native C++ evaluator (scripts/kitti_native_eval).
"""

import numpy as np


def two_d_iou(box, boxes):
    """IoU between one [x1, y1, x2, y2] box and (N, 4) boxes."""
    boxes = np.asarray(boxes, np.float64)
    iou = np.zeros(len(boxes), np.float64)

    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])

    w = x2 - x1
    h = y2 - y1
    non_empty = (w > 0) & (h > 0)

    if non_empty.any():
        intersection = w[non_empty] * h[non_empty]
        box_area = (box[2] - box[0]) * (box[3] - box[1])
        boxes_area = ((boxes[non_empty, 2] - boxes[non_empty, 0]) *
                      (boxes[non_empty, 3] - boxes[non_empty, 1]))
        union = box_area + boxes_area - intersection
        iou[non_empty] = intersection / union
    return iou


def _rotated_rect_corners(cx, cz, length, width, ry):
    """(4, 2) BEV corners of a rotated rectangle (x-z plane), CCW.

    Counterclockwise order matters: the Sutherland-Hodgman clipper keeps
    the left side of each directed clip edge.
    """
    c, s = np.cos(ry), np.sin(ry)
    half_l, half_w = length / 2.0, width / 2.0
    local = np.array([[half_l, half_w], [-half_l, half_w],
                      [-half_l, -half_w], [half_l, -half_w]])
    rot = np.array([[c, s], [-s, c]])
    return local @ rot.T + np.array([cx, cz])


def _polygon_area(poly):
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def _clip_polygon(subject, clip):
    """Sutherland-Hodgman convex polygon clipping."""
    output = list(subject)
    for i in range(len(clip)):
        a = clip[i]
        b = clip[(i + 1) % len(clip)]
        edge = b - a
        input_list = output
        output = []
        if not input_list:
            break
        prev = input_list[-1]
        prev_inside = np.cross(edge, prev - a) >= 0
        for curr in input_list:
            curr_inside = np.cross(edge, curr - a) >= 0
            if curr_inside:
                if not prev_inside:
                    output.append(_line_intersect(prev, curr, a, b))
                output.append(curr)
            elif prev_inside:
                output.append(_line_intersect(prev, curr, a, b))
            prev, prev_inside = curr, curr_inside
    return np.asarray(output)


def _line_intersect(p1, p2, a, b):
    d1 = p2 - p1
    d2 = b - a
    denom = d1[0] * d2[1] - d1[1] * d2[0]
    if abs(denom) < 1e-12:
        return p2
    t = ((a[0] - p1[0]) * d2[1] - (a[1] - p1[1]) * d2[0]) / denom
    return p1 + t * d1


def rotated_rect_intersection(rect1, rect2):
    """Intersection area of two (4, 2) convex rectangles."""
    inter = _clip_polygon(rect1, rect2)
    if len(inter) < 3:
        return 0.0
    return _polygon_area(inter)


def three_d_iou(box, boxes):
    """3D IoU between a box and boxes in [ry, l, h, w, tx, ty, tz] format.

    Boxes are gravity-aligned with rotation only about the y axis.
    """
    boxes = np.asarray(boxes)
    if boxes.ndim == 1:
        boxes = boxes[None]

    iou = np.zeros(len(boxes), np.float64)

    # Sphere pre-check
    box_diag = np.sqrt(np.sum(np.square(box[1:4]))) / 2
    boxes_diag = np.sqrt(np.sum(np.square(boxes[:, 1:4]), axis=1)) / 2
    dist = np.sqrt(np.sum(np.square(boxes[:, 4:7] - box[4:7]), axis=1))
    candidates = np.nonzero(box_diag + boxes_diag >= dist)[0]

    if len(candidates):
        # Height overlap (KITTI y points down; box origin at bottom face)
        min_y_box = -box[2] + box[5]
        max_y_box = box[5]

        rect1 = _rotated_rect_corners(box[4], box[6], box[1], box[3], box[0])
        vol_box = np.prod(box[1:4])

        for idx in candidates:
            other = boxes[idx]
            min_y_other = -other[2] + other[5]
            max_y_other = other[5]
            height_int = (min(max_y_box, max_y_other) -
                          max(min_y_box, min_y_other))
            if height_int <= 0:
                continue

            rect2 = _rotated_rect_corners(other[4], other[6], other[1],
                                          other[3], other[0])
            rect_int = rotated_rect_intersection(rect1, rect2)
            if rect_int <= 0:
                continue

            intersection = height_int * rect_int
            vol_other = np.prod(other[1:4])
            iou[idx] = intersection / (vol_box + vol_other - intersection)

    if iou.shape[0] == 1:
        return iou[0]
    return iou


def average_precision(recalls, precisions):
    """AP with 11-interval interpolation over monotonized precision."""
    recalls = np.concatenate([[0.0], recalls, [1.0]])
    precisions = np.concatenate([[0.0], precisions, [0.0]])
    for i in range(len(precisions) - 2, -1, -1):
        precisions[i] = max(precisions[i], precisions[i + 1])
    idx = np.nonzero(recalls[1:] != recalls[:-1])[0]
    return np.sum((recalls[idx + 1] - recalls[idx]) * precisions[idx + 1])


# ---------------------------------------------------------------------------
# Dataset-level PR curves (ref: src/monopsr/core/evaluation.py:285-500).
#
# Matching protocol: per frame, each detection above the score threshold
# greedily claims the GT box of maximum IoU; a claim below the IoU
# threshold or on an already-claimed GT counts as a false positive.
# Detections are visited in input order (NOT score-sorted) — identical to
# the reference. One shared matcher serves both the 2D and 3D variants;
# the reference duplicates the loop.
# ---------------------------------------------------------------------------

def _pr_curve(gt_boxes, detection_boxes, scores, score_thresholds,
              iou_threshold, iou_fn, valid_fn=None):
    assert len(gt_boxes) == len(detection_boxes) == len(scores)
    score_thresholds = np.asarray(score_thresholds, np.float64)

    precision = np.zeros(score_thresholds.shape)
    recall = np.zeros(score_thresholds.shape)

    for t_idx, threshold in enumerate(score_thresholds):
        total_tp = 0.0
        total_fp = 0.0
        recall_denom = 0.0

        for gt, dets, det_scores in zip(gt_boxes, detection_boxes, scores):
            gt = np.asarray(gt, np.float64)
            dets = np.asarray(dets, np.float64)
            det_scores = np.asarray(det_scores, np.float64).reshape(-1)
            dets = dets[det_scores > threshold]

            if len(gt) == 0:
                total_fp += len(dets)
                continue
            recall_denom += len(gt)

            claimed = np.zeros(len(gt), bool)
            for box in dets:
                if valid_fn is not None and not valid_fn(box):
                    continue
                ious = np.atleast_1d(iou_fn(box, gt))
                best = int(np.argmax(ious))
                if ious[best] > iou_threshold and not claimed[best]:
                    claimed[best] = True
                    total_tp += 1
                else:
                    total_fp += 1

        precision[t_idx] = total_tp / max(total_tp + total_fp, 1e-12)
        recall[t_idx] = total_tp / max(recall_denom, 1e-12)

    return precision, recall


def evaluate_2d(gt_boxes, detection_boxes, scores,
                score_thresholds=np.array([0.5]), iou_threshold=0.5):
    """Dataset-level 2D PR curve (ref: core/evaluation.py:285-375).

    Args:
        gt_boxes: per-frame list of (G, 4) [x1, y1, x2, y2] arrays.
        detection_boxes: per-frame list of (D, 4) arrays.
        scores: per-frame list of (D,) score arrays.
        score_thresholds: thresholds at which precision/recall are sampled.
        iou_threshold: minimum 2D IoU for a true positive.

    Returns:
        (precision_array, recall_array), each shaped like score_thresholds.
    """
    return _pr_curve(gt_boxes, detection_boxes, scores, score_thresholds,
                     iou_threshold, two_d_iou)


def evaluate_3d(gt_boxes, detection_boxes, scores,
                score_thresholds=np.array([0.5]), iou_threshold=0.25):
    """Dataset-level 3D PR curve (ref: core/evaluation.py:378-473).

    Boxes are [ry, l, h, w, tx, ty, tz]; detections with tx < -999 are
    treated as invalid slots and skipped (the reference's empty-box flag).
    """
    return _pr_curve(gt_boxes, detection_boxes, scores, score_thresholds,
                     iou_threshold, three_d_iou,
                     valid_fn=lambda box: box[4] >= -999)


def average_precision_computation(recall_array, precision_array,
                                  use_07_metric=True):
    """AP from sampled PR points (ref: core/evaluation.py:477-525).

    use_07_metric=True: PASCAL VOC 11-point metric (max precision at
    recall >= t for t in 0, 0.1, ..., 1.0, averaged). Otherwise exact
    area under the monotonized PR curve.
    """
    recall_array = np.asarray(recall_array, np.float64)
    precision_array = np.asarray(precision_array, np.float64)

    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            mask = recall_array >= t
            p = np.max(precision_array[mask]) if mask.any() else 0.0
            ap += p / 11.0
        return ap
    return average_precision(np.sort(recall_array),
                             precision_array[np.argsort(recall_array)])
