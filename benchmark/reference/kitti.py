"""The eval cells' reference: KITTI sample assembly, the eval step and the
predictions, in plain numpy and PyTorch, from the arrays and label rows
that the traffic generator wrote.

It follows the semantics of the port's ``datasets/kitti/kitti_dataset``
(val and test mode, a seeded dataset), ``train/trainer.prepare_sample``,
``eval/evaluator.make_eval_step`` (eager) and ``eval/predictions``, and
imports none of them: labels are parsed from the rows the generator
wrote, the image is resized by OpenCV's fixed-point INTER_LINEAR in
numpy, and the network is ``monopsr_net`` of this package.
"""

import zlib

import numpy as np
import torch

from benchmark.reference import boxes as box_geom
from benchmark.reference import class_stats, monopsr, orientation
from benchmark.reference import constants as C

# The dataset config's object filter ('hard', truncation < 0.3, depth in
# (5, 45)); class_stats' difficulty thresholds
_HARD = 2


def parse_rows(rows):
    """Label rows -> list of dicts, with the reader's dtypes: the box,
    dimensions and location float32, the rest float."""
    labels = []
    for row in rows:
        f = row.split()
        labels.append(dict(
            type=f[0], truncation=float(f[1]), occlusion=float(f[2]),
            alpha=float(f[3]),
            box=np.asarray(f[4:8], np.float32),            # x1 y1 x2 y2
            hwl=np.asarray(f[8:11], np.float32),
            t=np.asarray(f[11:14], np.float32), ry=float(f[14]),
            score=float(f[15]) if len(f) == 16 else 0.0))
    return labels


def _kept(label, mode):
    """Whether the object filter keeps a label: class alone in test mode;
    class, 'hard' difficulty, truncation < 0.3 and 5 < z < 45 in val."""
    if label['type'] != 'Car':
        return False
    if mode == 'test':
        return True
    x1, y1, x2, y2 = label['box']
    hard = (label['occlusion'] <= class_stats.DIFFICULTY_OCCLUSION[_HARD] and
            label['truncation'] <=
            class_stats.DIFFICULTY_TRUNCATION[_HARD] and
            (y2 - y1) >= class_stats.DIFFICULTY_HEIGHT[_HARD])
    return bool(hard and label['truncation'] < 0.3 and
                5 < label['t'][2] < 45)


def _iou(box, boxes):
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.where((x2 > x1) & (y2 > y1), (x2 - x1) * (y2 - y1), 0.0)
    area = (box[2] - box[0]) * (box[3] - box[1])
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return np.where(inter > 0, inter / (area + areas - inter), 0.0)


def merge_detections(labels, detections, min_iou):
    """Each detection replaces the box and score of the label it overlaps
    best, at IoU >= ``min_iou``; a label left with score 0 scores
    clip(1 - z / 45, 0.1, 1)."""
    labels = [dict(label, box=label['box'].copy()) for label in labels]
    if labels and detections:
        boxes = np.stack([label['box'] for label in labels]).astype(
            np.float64)
        for det in detections:
            ious = _iou(det['box'].astype(np.float64), boxes)
            best = int(np.argmax(ious))
            if ious[best] >= min_iou:
                labels[best]['box'] = det['box'].copy()
                labels[best]['score'] = det['score']
    for label in labels:
        if label['score'] == 0:
            label['score'] = float(np.clip(1.0 - label['t'][2] / 45.0,
                                           0.1, 1.0))
    return labels


def frame_labels(frame, mode):
    """(labels kept, their indices in the label file) of one frame, as
    the dataset takes them: val mode merges the MSCNN detections into
    the KITTI labels; test mode takes the detections. Empty when the
    frame yields no sample."""
    detections = parse_rows(frame.detections)
    if mode == 'test':
        kept = [d for d in detections if _kept(d, mode)]
        return kept, np.arange(len(kept))
    labels = parse_rows(frame.labels)
    merged = merge_detections(labels, detections,
                              class_stats.MSCNN_MERGE_MIN_IOU['Car'])
    keep = [i for i, label in enumerate(merged) if _kept(label, mode)]
    if not keep or not any(_kept(label, mode) for label in labels):
        return [], np.zeros(0, np.int64)
    return [merged[i] for i in keep], np.asarray(keep)


def _oversample(num_objs, num_boxes, seed, name):
    """Slot indices: every object, then draws with replacement from the
    dataset's per-sample RNG (seed, name, epoch 0)."""
    if num_objs >= num_boxes:
        return np.arange(num_boxes)
    rng = np.random.RandomState(
        (seed * 1000003 + zlib.crc32(name.encode('utf8'))) % (2 ** 32))
    extra = rng.choice(num_objs, num_boxes - num_objs, replace=True)
    return np.hstack([np.arange(num_objs), extra])


def _pad(arr, shape, fill):
    out = np.full(shape, fill, arr.dtype)
    out[:arr.shape[0], :arr.shape[1]] = arr
    return out


# -- OpenCV's INTER_LINEAR on uint8, fixed point, in numpy -----------------

_COEF_SCALE = 2048


def _taps(src, dst):
    f = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(
        np.float32)
    i0 = np.floor(f).astype(np.int64)
    return i0, (f - i0.astype(np.float32)).astype(np.float32)


def resize_uint8(image, shape):
    """(H, W, C) uint8 -> ``shape`` with OpenCV's INTER_LINEAR integer
    arithmetic (11-bit weights, rounded as OpenCV rounds them)."""
    sh, sw = image.shape[:2]
    dh, dw = shape
    x0, fx = _taps(sw, dw)
    fx[(x0 < 0) | (x0 >= sw - 1)] = 0.0
    x0 = np.clip(x0, 0, sw - 1)
    x1 = np.clip(x0 + 1, 0, sw - 1)
    ax0 = np.rint((np.float32(1.0) - fx) * _COEF_SCALE).astype(np.int32)
    ax1 = np.rint(fx * _COEF_SCALE).astype(np.int32)
    y0, fy = _taps(sh, dh)
    by0 = np.rint((np.float32(1.0) - fy) * _COEF_SCALE).astype(np.int32)
    by1 = np.rint(fy * _COEF_SCALE).astype(np.int32)
    y1 = np.clip(y0 + 1, 0, sh - 1)
    y0 = np.clip(y0, 0, sh - 1)
    src = image.astype(np.int32)
    rows = src[:, x0] * ax0[:, None] + src[:, x1] * ax1[:, None]
    out = (((by0[:, None, None] * (rows[y0] >> 4)) >> 16) +
           ((by1[:, None, None] * (rows[y1] >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


# -- samples ---------------------------------------------------------------

def assemble(frame, mode, cfg, seed, cam_p, depth_pad_shape):
    """(host sample, device sample) of one frame, or None when it yields
    no sample. The host sample holds what the predictions read; the
    device sample the arrays the eval step takes, in the encodings the
    port ships (uint8 image at the input shape, uint16 depth, uint8
    instance image)."""
    labels, orig = frame_labels(frame, mode)
    if not labels:
        return None
    slots = _oversample(len(labels), cfg.num_boxes, seed, frame.name)
    labels = [labels[i] for i in slots]
    num_objs = min(len(orig), cfg.num_boxes)
    image_shape = frame.image.shape[:2]
    boxes_2d = np.asarray([[lb['box'][1], lb['box'][0], lb['box'][3],
                            lb['box'][2]] for lb in labels], np.float32)
    n = len(labels)
    view_2d = np.arctan2(((boxes_2d[:, 1].astype(np.float64) +
                           boxes_2d[:, 3]) / 2.0 - cam_p[0, 2]) /
                         cam_p[0, 0], 1.0).astype(np.float32)
    host = {
        C.SAMPLE_NAME: frame.name,
        C.SAMPLE_NUM_OBJS: num_objs,
        C.SAMPLE_LABEL_BOXES_2D: boxes_2d,
        C.SAMPLE_LABEL_SCORES: np.asarray([lb['score'] for lb in labels],
                                          np.float32),
        C.SAMPLE_LABEL_CLASS_INDICES: np.ones((n, 1), np.int32),
        C.SAMPLE_CAM_P: np.asarray(cam_p, np.float32),
        'image_shape': image_shape,
    }
    device = {
        'image': resize_uint8(frame.image, cfg.image_input_shape),
        C.SAMPLE_LABEL_BOXES_2D: boxes_2d,
        C.SAMPLE_LABEL_BOXES_2D_NORM: (
            boxes_2d / np.tile(image_shape, 2)).astype(np.float32),
        C.SAMPLE_VIEWING_ANGLES_2D: view_2d,
        C.SAMPLE_LABEL_CLASS_INDICES: host[C.SAMPLE_LABEL_CLASS_INDICES],
        C.SAMPLE_MEAN_LWH: np.tile(class_stats.MEAN_LWH['Car'], (n, 1)).astype(
            np.float32),
        C.SAMPLE_PROP_CEN_Z_OFFSET: np.full(
            n, class_stats.PROP_CEN_Z_OFFSET['Car'], np.float32),
        C.SAMPLE_CEN_Y_OFFSETS: np.full(
            n, class_stats.CEN_Y_TREND_OFFSET_MIDDLE[('Car', 'kitti')],
            np.float32),
        C.SAMPLE_CAM_P: host[C.SAMPLE_CAM_P],
    }
    if mode == 'val':
        boxes_3d = np.asarray([np.concatenate([lb['t'], lb['hwl'][[2, 1, 0]],
                                               [lb['ry']]]) for lb in labels],
                              np.float32)
        alphas = np.asarray([lb['alpha'] for lb in labels])
        bins, regs, valid_bins = orientation.np_orientation_to_angle_bin(
            alphas, cfg.num_alpha_bins, 0.0)
        x_offset = -cam_p[0, 3] / cam_p[0, 0]
        host[C.SAMPLE_LABEL_BOXES_3D] = boxes_3d
        device.update({
            C.SAMPLE_LABEL_BOXES_3D: boxes_3d,
            C.SAMPLE_VIEWING_ANGLES_3D: np.arctan2(
                boxes_3d[:, 0].astype(np.float64) - x_offset,
                boxes_3d[:, 2]).astype(np.float32),
            C.SAMPLE_DEPTH_MAP: _pad(frame.depth, depth_pad_shape, 0),
            C.SAMPLE_INSTANCE_IMAGE: _pad(frame.instance, depth_pad_shape,
                                          255),
            C.SAMPLE_INSTANCE_INDICES: orig[slots].astype(np.int32),
            C.SAMPLE_ALPHAS: alphas.astype(np.float32),
            C.SAMPLE_ALPHA_BINS: np.asarray(bins, np.int32),
            C.SAMPLE_ALPHA_REGS: np.asarray(regs, np.float32),
            C.SAMPLE_ALPHA_VALID_BINS: np.asarray(valid_bins, np.float32),
        })
    return host, device


def groups_of(samples, eval_batch):
    """The evaluator's dispatch groups: ``eval_batch`` samples in order,
    the last padded by repeating its last sample."""
    out = []
    for i in range(0, len(samples), eval_batch):
        group = samples[i:i + eval_batch]
        out.append((group, group + [group[-1]] * (eval_batch - len(group))))
    return out


def eval_step(net, cfg, loss_config, mode, device_rows, device):
    """The eager eval step over one group: (packed outputs, per-sample
    losses, per-slot metrics, GT valid masks), numpy."""
    batch = {key: torch.from_numpy(np.stack([row[key] for row in
                                             device_rows])).to(device)
             for key in device_rows[0]}
    with torch.inference_mode():
        outputs = net(**monopsr.net_inputs_from_batch(batch))
        losses, metrics, valid = {}, {}, None
        if mode == 'val':
            gt = monopsr.build_gt_dict(cfg, batch, outputs)
            outputs, gt = monopsr.add_global_outputs(cfg, batch, outputs, gt)
            losses, _ = monopsr.compute_losses(cfg, loss_config, outputs, gt)
            metrics = monopsr.compute_metrics(cfg, outputs, gt)
            valid = gt[C.KEY_VALID_MASK_MAPS]
        packed = monopsr.pack_outputs_for_host(outputs)

        def host(tree):
            return {k: v.float().cpu().numpy() if v.is_floating_point()
                    else v.cpu().numpy() for k, v in tree.items()}
        return (host(packed), host(losses), host(metrics),
                None if valid is None else valid.float().cpu().numpy())


def _postprocess_cen_x(boxes_2d, boxes_3d, cam_p):
    boxes_2d = np.asarray(boxes_2d, np.float64)
    boxes_3d = np.asarray(boxes_3d, np.float64)
    corners = box_geom.np_compute_box_3d_corners_batch(boxes_3d[:, 0:7])
    corners_uv = box_geom.np_project_corners_batch(corners, cam_p)
    cen_uv = box_geom.np_project_corners_batch(boxes_3d[:, 0:3, None], cam_p)
    min_u = corners_uv[:, 0].min(-1)
    max_u = corners_uv[:, 0].max(-1)
    with np.errstate(divide='ignore', invalid='ignore'):
        u_ratio = (cen_uv[:, 0, 0] - min_u) / (max_u - min_u)
    pred_u = boxes_2d[:, 1] + u_ratio * (boxes_2d[:, 3] - boxes_2d[:, 1])
    return (pred_u - cam_p[0, 2]) * boxes_3d[:, 2] / cam_p[0, 0]


def _score_boxes(cam_p, image_shape, boxes_2d, boxes_3d, scores,
                 max_depth=45.0):
    """0.95 * detection score + 0.05 * (depth score + box fit) / 2."""
    boxes_2d = np.asarray(boxes_2d, np.float64)
    boxes_3d = np.asarray(boxes_3d, np.float64)
    scores = np.asarray(scores, np.float64)
    corners = box_geom.np_compute_box_3d_corners_batch(boxes_3d[:, 0:7])
    uv = box_geom.np_project_corners_batch(corners, cam_p)
    img = np.stack([uv[:, 0].min(-1), uv[:, 1].min(-1),
                    uv[:, 0].max(-1), uv[:, 1].max(-1)], axis=-1)
    h, w = image_shape
    discarded = ((img[:, 0] > w) | (img[:, 1] > h) | (img[:, 2] < 0) |
                 (img[:, 3] < 0) | (img[:, 2] - img[:, 0] > w * 0.8) |
                 (img[:, 3] - img[:, 1] > h * 0.8))
    trunc = np.stack([np.maximum(img[:, 0], 0), np.maximum(img[:, 1], 0),
                      np.minimum(img[:, 2], w), np.minimum(img[:, 3], h)],
                     axis=-1)
    iou_fmt = box_geom.boxes_2d_to_iou_fmt(boxes_2d)
    with np.errstate(divide='ignore', invalid='ignore'):
        bw = iou_fmt[:, 2] - iou_fmt[:, 0]
        bh = iou_fmt[:, 3] - iou_fmt[:, 1]
        err = (np.abs((iou_fmt[:, 0] - trunc[:, 0]) / bw) +
               np.abs((iou_fmt[:, 2] - trunc[:, 2]) / bw) +
               np.abs((iou_fmt[:, 1] - trunc[:, 1]) / bh) +
               np.abs((iou_fmt[:, 3] - trunc[:, 3]) / bh))
    fit = np.where(discarded, 0.1, 1.0 - err)
    depth = np.clip(1.0 - boxes_3d[:, 2] / max_depth, 0.1, 1.0)
    return 0.95 * scores + 0.05 * ((depth + fit) / 2.0).reshape(
        scores.shape)


def format_boxes(cfg, packed, host, mode, calib_p2):
    """(box_3d rows (num_objs, 9): x y z l w h ry score class, the masked
    local xyz maps (num_objs, h, w, 3)) of one sample's packed outputs."""
    n = int(host[C.SAMPLE_NUM_OBJS])
    masks = (packed[C.KEY_VALID_MASK_MAPS][:n] > 0).astype(np.float32)
    xyz = packed[C.KEY_INST_XYZ_MAP_LOCAL][:n] * masks
    boxes_3d = (np.copy(host[C.SAMPLE_LABEL_BOXES_3D]) if mode == 'val'
                else np.zeros((cfg.num_boxes, 7), np.float32))
    boxes_3d[:, 3:6] = packed[C.KEY_LWH]
    bins = packed[C.KEY_ALPHA_BINS]
    best = np.argmax(bins, axis=1)
    regs = packed[C.KEY_ALPHA_REGS][np.arange(len(best)), best]
    alphas = orientation.np_angle_bin_to_orientation(best, regs,
                                                     cfg.num_alpha_bins)
    boxes_3d[:, 6] = alphas + np.squeeze(packed[C.KEY_VIEW_ANG])
    centroids = np.copy(packed[C.KEY_CENTROIDS])
    centroids[:, 1:2] += boxes_3d[:, 5:6] / 2.0
    boxes_3d[:, 0:3] = centroids
    boxes_2d = host[C.SAMPLE_LABEL_BOXES_2D]
    boxes_3d[:, 0] = _postprocess_cen_x(boxes_2d, boxes_3d,
                                        host[C.SAMPLE_CAM_P])
    scores = _score_boxes(calib_p2, host['image_shape'], boxes_2d[:n],
                          boxes_3d[:n], host[C.SAMPLE_LABEL_SCORES][:n, None])
    classes = host[C.SAMPLE_LABEL_CLASS_INDICES][:n] - 1
    return np.hstack([boxes_3d[:n], scores, classes]), xyz
