"""Inference entry point (test mode: predictions only, no losses).

Counterpart of ``monopsr_tpu/experiments/run_inference.py``, with the
same flags:

    python -m monopsr_torch.experiments.run_inference \\
        --config_path configs/monopsr_model_000.yaml \\
        --data_split val --ckpt_num 100000 [--device cpu]

``--checkpoint_name NAME`` reads the frozen config
``data/outputs/NAME/NAME.yaml`` instead of ``--config_path``;
``--det_2d_score_thr`` overrides the MSCNN score thresholds; a test
split reads ``testing/`` without labels. Runs on CUDA unless ``--device
cpu`` is given, and raises when CUDA is asked for and absent. Spawns
data-parallel ranks as ``run_evaluation`` does.
"""

import argparse
import os

import monopsr_torch
from monopsr_torch import config as config_utils
from monopsr_torch.eval.evaluator import requested_eval_ranks
from monopsr_torch.parallel import data_parallel
from monopsr_torch.utils import device as device_lib


def inference(config, data_split, ckpt_indices='all', device=None):
    from monopsr_torch.datasets.kitti.kitti_dataset import KittiDataset
    from monopsr_torch.eval.evaluator import Evaluator

    config.dataset_config.data_split = data_split
    if data_split.startswith('test'):
        config.dataset_config.data_split_dir = 'testing'
        config.dataset_config.has_kitti_labels = False

    # Inference mode: no losses, even on a val split
    dataset = KittiDataset(config.dataset_config, 'test')
    evaluator = Evaluator(config, dataset, eval_mode='test',
                          do_kitti_native_eval=False, device=device)
    return evaluator.run_latest_checkpoints(ckpt_indices)


def _inference_rank(device, config, data_split, ckpt_indices):
    inference(config, data_split, ckpt_indices, device)


def main(argv=None):
    parser = argparse.ArgumentParser()
    default_config = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        'configs', 'monopsr_model_000.yaml')
    parser.add_argument('--config_path', type=str, default=default_config)
    parser.add_argument('--checkpoint_name', type=str, default=None,
                        help='Load the frozen config from '
                             'data/outputs/<name>/<name>.yaml instead of '
                             '--config_path')
    parser.add_argument('--data_split', type=str, default='val')
    parser.add_argument('--ckpt_num', type=str, nargs='+', default=None,
                        help="Checkpoint steps to run, or 'all'")
    parser.add_argument('--det_2d_score_thr', type=float, nargs='+',
                        default=None,
                        help='Override the per-class MSCNN 2D score '
                             'thresholds')
    parser.add_argument('--device', type=str, default=None,
                        help="'cuda' (default), 'cuda:N' or 'cpu'")
    args = parser.parse_args(argv)

    device = device_lib.resolve_device(args.device)
    if args.checkpoint_name:
        config_path = os.path.join(
            monopsr_torch.data_dir(), 'outputs', args.checkpoint_name,
            args.checkpoint_name + '.yaml')
    else:
        config_path = args.config_path
    config = config_utils.parse_yaml_config(config_path)
    if args.det_2d_score_thr is not None:
        config.dataset_config.mscnn_thr = list(args.det_2d_score_thr)
    ckpt_indices = args.ckpt_num if args.ckpt_num else 'all'
    if ckpt_indices != 'all' and ckpt_indices != ['all']:
        ckpt_indices = [int(c) for c in ckpt_indices]
    else:
        ckpt_indices = 'all'
    ranks = data_parallel.clamped_ranks(
        requested_eval_ranks(config.train_config), device)
    if ranks > 1:
        return data_parallel.launch(_inference_rank, ranks, device, config,
                                    args.data_split, ckpt_indices)
    return inference(config, args.data_split, ckpt_indices, device)


if __name__ == '__main__':
    main()
