"""Evaluation entry point (val mode: losses, metrics, KITTI files, AP).

Counterpart of ``monopsr_tpu/experiments/run_evaluation.py``, with the
same flags:

    python -m monopsr_torch.experiments.run_evaluation \\
        --config_path configs/monopsr_model_000.yaml [--data_split val] \\
        [--repeated] [--no_kitti_native_eval] [--device cpu]

Evaluates every checkpoint under ``data/outputs/<config name>/
checkpoints/`` (with ``--repeated``, polls for new ones and skips those
in ``evaluated_<split>.txt``). Runs on CUDA unless ``--device cpu`` is
given, and raises when CUDA is asked for and absent. Waits for the
native AP evaluator's runs before it returns. When the config's
``eval_data_parallel`` (or ``data_parallel``), clamped to the visible
cards, is above 1, that many ranks are spawned
(``parallel.data_parallel.launch``), one per card.
"""

import argparse
import os

from monopsr_torch import config as config_utils
from monopsr_torch.eval.evaluator import requested_eval_ranks
from monopsr_torch.parallel import data_parallel
from monopsr_torch.utils import device as device_lib


def evaluate(config, data_split='val', repeated=True,
             kitti_native_eval=True, device=None):
    from monopsr_torch.datasets.kitti.kitti_dataset import KittiDataset
    from monopsr_torch.eval.evaluator import Evaluator

    config.dataset_config.data_split = data_split
    dataset = KittiDataset(config.dataset_config, 'val')
    evaluator = Evaluator(config, dataset, eval_mode='val',
                          do_kitti_native_eval=kitti_native_eval,
                          device=device)
    if repeated:
        return evaluator.repeated_checkpoint_run()
    return evaluator.run_latest_checkpoints('all')


def _evaluate_rank(device, config, data_split, repeated, kitti_native_eval):
    evaluate(config, data_split, repeated, kitti_native_eval, device)


def main(argv=None):
    parser = argparse.ArgumentParser()
    default_config = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        'configs', 'monopsr_model_000.yaml')
    parser.add_argument('--config_path', type=str, default=default_config)
    parser.add_argument('--data_split', type=str, default='val')
    parser.add_argument('--repeated', action='store_true', default=False,
                        help='Poll for new checkpoints')
    parser.add_argument('--no_kitti_native_eval', action='store_true')
    parser.add_argument('--device', type=str, default=None,
                        help="'cuda' (default), 'cuda:N' or 'cpu'")
    args = parser.parse_args(argv)

    device = device_lib.resolve_device(args.device)
    config = config_utils.parse_yaml_config(args.config_path)
    ranks = data_parallel.clamped_ranks(
        requested_eval_ranks(config.train_config), device)
    if ranks > 1:
        return data_parallel.launch(
            _evaluate_rank, ranks, device, config, args.data_split,
            args.repeated, not args.no_kitti_native_eval)
    return evaluate(config, args.data_split, repeated=args.repeated,
                    kitti_native_eval=not args.no_kitti_native_eval,
                    device=device)


if __name__ == '__main__':
    main()
