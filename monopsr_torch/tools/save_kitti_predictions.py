"""Standalone predictions -> KITTI-format conversion for chosen steps.

Counterpart of ``scripts/offline_eval/save_kitti_predictions.py``, with
the same flags: re-runs the KITTI-format writer over already-saved
box_3d/box_2d prediction dumps without re-running inference.

Usage:
    python -m monopsr_torch.tools.save_kitti_predictions \\
        --config_path configs/monopsr_model_000.yaml \\
        --data_split val --steps 100000 [--score_threshold 0.1] \\
        [--save_2d] [--output_base_dir <dir>]
"""

import argparse
import os

from monopsr_torch import config as config_utils
from monopsr_torch.datasets.kitti.kitti_dataset import KittiDataset
from monopsr_torch.eval import kitti_writers


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--config_path', required=True)
    parser.add_argument('--data_split', default='val')
    parser.add_argument('--steps', nargs='+', required=True, type=int)
    parser.add_argument('--score_threshold', type=float, default=None)
    parser.add_argument('--save_2d', action='store_true',
                        help='2D-only conversion: write box_2d predictions '
                             'in KITTI format with -1000/-10 3D placeholder '
                             'fields')
    parser.add_argument('--output_base_dir', default=None,
                        help='Override for the outputs root '
                             '(default <repo>/data/outputs)')
    args = parser.parse_args(argv)

    config = config_utils.parse_yaml_config(
        args.config_path, output_base_dir=args.output_base_dir)
    config.dataset_config.data_split = args.data_split
    mode = 'test' if args.data_split.startswith('test') else 'val'
    dataset = KittiDataset(config.dataset_config, mode)

    threshold = (args.score_threshold if args.score_threshold is not None
                 else config.train_config.get('kitti_score_threshold', 0.1))

    for step in args.steps:
        box_3d_dir = os.path.join(config.pred_dir, 'box_3d',
                                  args.data_split, str(step))
        box_2d_dir = os.path.join(config.pred_dir, 'box_2d',
                                  args.data_split, str(step))
        if args.save_2d:
            if not os.path.isdir(box_2d_dir):
                print('Missing predictions for step', step, ':', box_2d_dir)
                continue
            out_dir = kitti_writers.save_predictions_box_2d_in_kitti_format(
                threshold, dataset, config.pred_dir, box_2d_dir, step)
            print('step {}: 2D-only predictions -> {}'.format(step, out_dir))
            continue
        if not os.path.isdir(box_3d_dir):
            print('Missing predictions for step', step, ':', box_3d_dir)
            continue
        out_dir, num_valid = \
            kitti_writers.save_predictions_box_3d_in_kitti_format(
                threshold, dataset, config.pred_dir, box_3d_dir,
                box_2d_dir, step)
        print('step {}: {} samples with predictions -> {}'.format(
            step, num_valid, out_dir))


if __name__ == '__main__':
    main()
