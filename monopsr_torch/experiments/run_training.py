"""Training entry point.

Counterpart of ``monopsr_tpu/experiments/run_training.py``, with the
same flags:

    python -m monopsr_torch.experiments.run_training \\
        --config_path configs/monopsr_model_000.yaml [--data_split train] \\
        [--device cpu]

Runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
asked for and absent. Outputs (config copy, checkpoints, logs) go to
``data/outputs/<config name>/``; a second call resumes from the latest
checkpoint unless the config sets ``overwrite_checkpoints``.
"""

import argparse
import os

from monopsr_torch import config as config_utils
from monopsr_torch.utils import device as device_lib


def train(config, data_split=None, device=None):
    from monopsr_torch.datasets.kitti.kitti_dataset import KittiDataset
    from monopsr_torch.train import trainer

    if data_split:
        config.dataset_config.data_split = data_split

    dataset = KittiDataset(config.dataset_config, 'train')
    return trainer.train(config, dataset, device=device)


def main(argv=None):
    parser = argparse.ArgumentParser()
    default_config = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        'configs', 'monopsr_model_000.yaml')
    parser.add_argument('--config_path', type=str, default=default_config,
                        help='Path to the experiment YAML config')
    parser.add_argument('--data_split', type=str, default=None,
                        help="Override the dataset split (e.g. 'train')")
    parser.add_argument('--device', type=str, default=None,
                        help="'cuda' (default), 'cuda:N' or 'cpu'")
    args = parser.parse_args(argv)

    device = device_lib.resolve_device(args.device)
    config = config_utils.parse_yaml_config(args.config_path)
    config_utils.copy_config_into_experiment_dir(args.config_path, config)
    train(config, args.data_split, device)


if __name__ == '__main__':
    main()
