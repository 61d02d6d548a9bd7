"""KITTI-format prediction writers and metrics CSVs.

Own copy of ``monopsr_tpu/eval/kitti_writers.py`` (numpy only): KITTI
text rows (lwh -> hwl reorder, CRLF line endings, 3-decimal rounding,
score-threshold filtering, an empty file for a sample without a kept
detection), the avg/std/avg_abs/std_abs metrics CSV tables, and the
timing statistics the evaluator prints. The files are byte-identical to
the JAX package's for the same inputs (tests/test_torch_eval_host.py,
tests/test_torch_eval_tools.py). The 2D-only writer serves
``tools/save_kitti_predictions --save_2d``.
"""

import csv
import os

import numpy as np


def save_predictions_box_3d_in_kitti_format(score_threshold, dataset,
                                            predictions_base_dir,
                                            predictions_box_3d_dir,
                                            predictions_box_2d_dir,
                                            global_step):
    """Converts saved (N, 9)/(N, 7) prediction txts into KITTI rows.

    Output: <base>/kitti_predictions_3d/<split>/<thr>/<step>/data/*.txt
    with rows 'type -1 -1 alpha x1 y1 x2 y2 h w l x y z ry score'.
    """
    score_threshold = round(score_threshold, 3)
    kitti_dir = os.path.join(
        predictions_base_dir, 'kitti_predictions_3d',
        dataset.data_split, str(score_threshold), str(global_step), 'data')
    os.makedirs(kitti_dir, exist_ok=True)

    num_valid = 0
    for sample in dataset.sample_list:
        sample_name = sample.name
        out_path = os.path.join(kitti_dir, sample_name + '.txt')
        pred_3d_path = os.path.join(predictions_box_3d_dir,
                                    sample_name + '.txt')
        pred_2d_path = os.path.join(predictions_box_2d_dir,
                                    sample_name + '.txt')

        if not os.path.exists(pred_3d_path):
            np.savetxt(out_path, [])
            continue

        preds_3d = np.loadtxt(pred_3d_path).reshape(-1, 9)
        if len(preds_3d) == 0:
            np.savetxt(out_path, [])
            continue
        preds_2d = np.loadtxt(pred_2d_path).reshape(-1, 7)

        keep = preds_3d[:, 7] >= score_threshold
        preds_3d = preds_3d[keep]
        preds_2d = preds_2d[keep]
        if len(preds_3d) == 0:
            np.savetxt(out_path, [])
            continue

        num_valid += 1

        # box_2d rows are [y1 x1 y2 x2 ...] -> KITTI [x1 y1 x2 y2]
        boxes_2d = preds_2d[:, [1, 0, 3, 2]]

        kitti = np.zeros([len(preds_3d), 16])
        kitti[:, 3] = preds_2d[:, 4]            # alpha
        kitti[:, 4:8] = boxes_2d
        kitti[:, 8] = preds_3d[:, 5]            # h
        kitti[:, 9] = preds_3d[:, 4]            # w
        kitti[:, 10] = preds_3d[:, 3]           # l
        kitti[:, 11:14] = preds_3d[:, 0:3]      # x y z
        kitti[:, 14:16] = preds_3d[:, 6:8]      # ry score
        kitti = np.round(kitti, 3)

        obj_types = [dataset.classes[int(c)] for c in preds_3d[:, 8]]
        trunc_occ = -1 * np.ones((len(kitti), 2), np.int32)

        rows = np.column_stack([obj_types, trunc_occ, kitti[:, 3:16]])
        np.savetxt(out_path, rows, newline='\r\n', fmt='%s')

    return kitti_dir, num_valid


def save_predictions_box_2d_in_kitti_format(score_threshold, dataset,
                                            predictions_base_dir,
                                            predictions_box_2d_dir,
                                            global_step):
    """2D-only variant: KITTI rows from the (N, 7) box_2d txts, with the
    3D fields -1000 placeholders and alpha -10, into the same
    kitti_predictions_3d/<split>/<thr>/<step>/data/ tree."""
    score_threshold = round(score_threshold, 3)
    kitti_dir = os.path.join(
        predictions_base_dir, 'kitti_predictions_3d',
        dataset.data_split, str(score_threshold), str(global_step), 'data')
    os.makedirs(kitti_dir, exist_ok=True)

    for sample in dataset.sample_list:
        sample_name = sample.name
        out_path = os.path.join(kitti_dir, sample_name + '.txt')
        pred_path = os.path.join(predictions_box_2d_dir,
                                 sample_name + '.txt')
        if not os.path.exists(pred_path):
            np.savetxt(out_path, [])
            continue

        preds = np.loadtxt(pred_path).reshape(-1, 7)
        boxes = preds[:, [1, 0, 3, 2]]
        keep = preds[:, 5] >= score_threshold
        preds, boxes = preds[keep], boxes[keep]
        if len(preds) == 0:
            np.savetxt(out_path, [])
            continue

        kitti = np.full([len(preds), 16], -1000.0)
        kitti[:, 3] = -10.0
        kitti[:, 4:8] = boxes
        kitti[:, 15] = preds[:, 5]
        kitti = np.round(kitti, 3)

        obj_types = [dataset.classes[int(c)] for c in preds[:, 6]]
        rows = np.column_stack([obj_types, kitti[:, 1:16]])
        np.savetxt(out_path, rows, newline='\r\n', fmt='%s')

    return kitti_dir


def save_metrics(metrics_dir, global_step, data_split, metrics_dict):
    """Writes avg/std/avg_abs/std_abs CSV tables per checkpoint.

    metrics_dict maps metric name -> 1-D array of per-box values
    aggregated over the epoch (NaN-filtered before aggregation).
    """
    out_dir = os.path.join(metrics_dir, str(global_step), data_split)
    os.makedirs(out_dir, exist_ok=True)

    names = sorted(metrics_dict.keys())
    rows = {
        'avg': [], 'std': [], 'avg_abs': [], 'std_abs': [],
    }
    for name in names:
        values = np.asarray(metrics_dict[name], np.float64).ravel()
        values = values[np.isfinite(values)]
        if len(values) == 0:
            values = np.asarray([np.nan])
        rows['avg'].append(np.mean(values))
        rows['std'].append(np.std(values))
        rows['avg_abs'].append(np.mean(np.abs(values)))
        rows['std_abs'].append(np.std(np.abs(values)))

    header = [n[7:] if n.startswith('metric_') else n for n in names]
    for stat, values in rows.items():
        path = os.path.join(out_dir, 'metrics_{}.csv'.format(stat))
        with open(path, 'w', newline='') as f:
            writer = csv.writer(f)
            writer.writerow(header)
            writer.writerow(['{:.6f}'.format(v) for v in values])

    return out_dir


def print_inference_time_statistics(total_feed_dict_time,
                                    total_inference_time):
    """Prints min/max/mean/median of the per-image feed and inference
    seconds."""
    def stats(name, times):
        times = np.asarray(times)
        if len(times) == 0:
            return
        print('{}: min {:.4f}, max {:.4f}, mean {:.4f}, median {:.4f}'
              .format(name, times.min(), times.max(), times.mean(),
                      np.median(times)))

    stats('feed dict time', total_feed_dict_time)
    stats('inference time', total_inference_time)
