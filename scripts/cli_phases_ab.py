#!/usr/bin/env python3
"""Runs the training and evaluation CLI phases of ``chip_smoke.py`` (phase
9: ``run_training`` at production width on the KITTI fixture, 4 steps
then a resume to 6; phase 11: ``run_evaluation`` over checkpoints 2, 4,
6 and ``run_inference`` at step 6) for one or more checkouts of the
PyTorch/CUDA port on one NVIDIA GPU, in turns:

    python3 scripts/cli_phases_ab.py --trees OLD NEW NEW OLD

Each tree is a checkout's root (holding ``monopsr_torch/`` and
``chip_smoke.py``); each run is a process of its own that runs that
tree's phases, whose CLIs are subprocesses of that tree's code, so each
runs under its own tree's precision policy. One JSON line per run with
the loop's ms per step and the CLIs' ms per image; the card's name and
power limit first.

It reads the report keys of ``chip_smoke.train_loop_phase`` and
``chip_smoke.eval_cli_phase`` and serves one open question, whether the
float32 precision policy moves the CLIs' times (ROADMAP.md); it goes
when that is settled.
"""

import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import emd_kernels_ab  # noqa: E402  (the turn runner)


def one(tree):
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from monopsr_torch import config as config_lib

    card = cs.nvidia_smi('name,power.limit')
    loop_dir = config_lib.parse_yaml_config(
        cs.train_loop_config(4)).exp_output_dir
    shutil.rmtree(loop_dir, ignore_errors=True)
    try:
        loop = cs.train_loop_phase(card)
        evals = cs.eval_cli_phase(card)
    finally:
        shutil.rmtree(loop_dir, ignore_errors=True)
    print(json.dumps({
        'tree': tree,
        'train_ms_per_step': loop['ms_per_step'],
        'train_steady_ms_per_step': loop['steady_ms_per_step'],
        'loader_ms_per_delivered_sample':
            loop['loader']['ms_per_delivered_sample'],
        'val_ms_per_image': evals['val_ms_per_image'],
        'val_infer_ms': evals['val_infer_ms'],
        'inference_val_ms_per_image': evals['inference_val_ms_per_image'],
        'test_ms_per_image': evals['test_ms_per_image'],
        'test_infer_ms': evals['test_infer_ms']}))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--trees', nargs='+', help='checkout roots, run '
                        'in this order')
    parser.add_argument('--one', help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        one(args.one)
        return 0
    return emd_kernels_ab.run_in_turns(__file__, args.trees)


if __name__ == '__main__':
    sys.exit(main())
