"""Accuracy regression gate: train -> eval -> native KITTI AP as one JSON.

Counterpart of ``scripts/accuracy_gate.py``, with the same functions,
arguments, defaults, gates and report keys:

    python -m monopsr_torch.experiments.accuracy_gate --out ACCURACY.json
    python -m monopsr_torch.experiments.accuracy_gate --steps 200 \\
        --min_ap 0 --min_val_ap -1

It overfits the full production model (``configs/monopsr_model_000.yaml``:
ResNet-101 dual towers, bfloat16, 320x1216, 32 proposal slots), from
random init (no pretrained NPZ), on the checked-in mini-KITTI fixture
through the whole pipeline: ``trainer.train``, the EMA weights, the
``Evaluator`` in val mode, the KITTI writers and the native C++
evaluator. Phase 1 evaluates the train split it overfit and gates at
the low-IoU regime (0.5/0.25/0.25): an image-AP floor, a 3D-AP floor,
image, BEV and 3D AP agreeing, a nonzero 3D AP at 0.7, and ceilings on
the mean |cen_z error| and the Chamfer metric. Phase 2 evaluates the
same checkpoint on the held-out val split: an image-AP floor, a nonzero
metric-space AP at the low regime, and ceilings on the cen_z bias (|mean
signed error|) and magnitude (mean |error|). Split 0 is the fixture's
own train/val assignment; split k rotates the 13 trainval frames by 3k
(``make_rotated_fixture``). The reasons for each gate and threshold are
the JAX script's (its module docstring and argparse help).

Where this module differs from the JAX script:

- there is no ``compile_cache`` to enable (nothing is compiled ahead);
- the JAX script's ``run_kitti_native_eval(step, background=False)`` is
  ``run_kitti_native_eval(step)`` followed by ``wait_for_native_eval()``,
  which runs the native evaluator at both IoU regimes and waits for it;
- the report gains a ``device`` entry: the torch device, and on CUDA
  the card's name and power limit as ``nvidia-smi --query-gpu=
  name,power.limit --format=csv,noheader`` prints them;
- ``--device`` ('cuda' by default, or 'cpu'), as every entry point of
  the port takes it: the gate runs on CUDA unless the CPU is asked for.

The config is read by the port's YAML reader and written back by its
writer (``config.dump_yaml``), not by PyYAML. On failure the process
exits with ``ACCURACY GATE FAILED: <checks>``.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import time

import monopsr_torch
from monopsr_torch import config as config_utils

REPO = monopsr_torch.top_dir()

FIXTURE = os.path.join(REPO, 'tests', 'datasets', 'Kitti', 'object')
CANONICAL = os.path.join(REPO, 'configs', 'monopsr_model_000.yaml')

CURVES = ('car_detection', 'car_orientation', 'car_detection_BEV',
          'car_detection_3D')


def build_gate_config(args, out_dir, data_split, suffix='',
                      dataset_dir=FIXTURE, exp_name='accuracy_gate'):
    """Canonical config re-targeted at the fixture."""
    raw = config_utils.load_yaml(CANONICAL)

    ds = raw['dataset_config']
    ds['dataset_dir'] = dataset_dir
    # Rotated fixtures carry their own split-consistent mscnn tree
    ds['mscnn_dir'] = os.path.join(dataset_dir, 'mscnn')
    ds['data_split'] = data_split
    ds['seed'] = args.seed
    # Flip augmentation applies only when train_val_test == 'train'
    ds['aug_config']['use_flip_aug'] = bool(args.flip)

    tc = raw['train_config']
    tc['max_iterations'] = args.steps
    tc['checkpoint_interval'] = args.steps
    tc['summary_interval'] = max(args.steps // 20, 1)
    tc['overwrite_checkpoints'] = True
    opt = tc['optimizer']['adam_optimizer']
    opt['moving_average_decay'] = args.ema_decay

    # The yaml basename is the experiment identity (checkpoint dir), so
    # split variants live in subdirectories under the same name: the val
    # phase must find the train phase's checkpoints.
    if suffix:
        out_dir = os.path.join(out_dir, suffix.strip('_'))
        os.makedirs(out_dir, exist_ok=True)
    config_path = os.path.join(out_dir, exp_name + '.yaml')
    config_utils.dump_yaml(raw, config_path)
    return config_path


def make_rotated_fixture(rotation, tmp_root):
    """Fixture view with a rotated train/val assignment.

    Builds a dataset_dir of symlinks to the checked-in fixture's data
    plus rewritten split files: the 13 trainval frames are rotated left
    by `rotation`, the first 7 become train, the last 6 val. MSCNN
    detections are stored per split, so the view gets its own mscnn tree
    of symlinks to each frame's detection file.
    """
    with open(os.path.join(FIXTURE, 'trainval.txt')) as f:
        frames = f.read().split()
    rotated = frames[rotation:] + frames[:rotation]

    root = os.path.join(tmp_root, 'fixture_rot{}'.format(rotation))
    if os.path.exists(root):
        shutil.rmtree(root)
    os.makedirs(root)
    for entry in os.listdir(FIXTURE):
        if not entry.endswith('.txt') and entry != 'mscnn':
            os.symlink(os.path.join(FIXTURE, entry),
                       os.path.join(root, entry))
    splits = {'train': rotated[:7], 'val': rotated[7:],
              'trainval': rotated}
    for name, names in splits.items():
        with open(os.path.join(root, name + '.txt'), 'w') as f:
            f.write('\n'.join(sorted(names)) + '\n')
    shutil.copy(os.path.join(FIXTURE, 'test.txt'),
                os.path.join(root, 'test.txt'))

    thr_dir = 'merged_0.2_0.2_0.2'
    src = {}
    for split in ('train', 'val'):
        data_dir = os.path.join(FIXTURE, 'mscnn', split, thr_dir, 'data')
        for fname in os.listdir(data_dir):
            src[fname[:-4]] = os.path.join(data_dir, fname)
    for name, names in splits.items():
        data_dir = os.path.join(root, 'mscnn', name, thr_dir, 'data')
        os.makedirs(data_dir)
        for frame in names:
            os.symlink(src[frame],
                       os.path.join(data_dir, frame + '.txt'))
    os.symlink(os.path.join(FIXTURE, 'mscnn', 'test'),
               os.path.join(root, 'mscnn', 'test'))
    return root


def parse_results_text(text):
    """Parses a native evaluator transcript into {curve: [E, M, H]},
    keeping the last occurrence of each curve."""
    aps = {}
    for curve in CURVES:
        matches = re.findall(
            curve + r' AP: ([\d.]+) ([\d.]+) ([\d.]+)', text)
        if matches:
            aps[curve] = [float(v) for v in matches[-1]]
    return aps


def read_results(config, evaluator, low_iou=False):
    from monopsr_torch.eval import native_eval
    path = native_eval.results_paths(
        config.pred_dir, config.config_name,
        evaluator.score_threshold)[1 if low_iou else 0]
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return parse_results_text(f.read())


def device_entry(device):
    """The report's ``device``: the torch device, and on CUDA the card's
    name and power limit from nvidia-smi."""
    entry = {'torch': str(device)}
    if device.type == 'cuda':
        import torch
        entry['name'] = torch.cuda.get_device_name(device)
        entry['nvidia_smi'] = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    return entry


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--out', default=None,
                        help='Output JSON path (default ACCURACY.json)')
    parser.add_argument('--steps', type=int, default=2500)
    parser.add_argument('--seed', type=int, default=42)
    parser.add_argument('--ema_decay', type=float, default=0.995,
                        help='EMA decay sized for the overfit horizon '
                             '(the canonical 0.9999 barely moves in 2.5k '
                             'steps; the evaluator scores EMA weights)')
    parser.add_argument('--min_ap', type=float, default=25.0,
                        help='Gate: minimum train-split Car AP (image, and '
                             '3D at the low IoU regime), moderate')
    parser.add_argument('--ap_agreement', type=float, default=3.0,
                        help='Gate: max |AP_3D - AP_BEV| and '
                             '|AP_3D - AP_image| on the train split, low '
                             'IoU regime')
    parser.add_argument('--max_cen_z_err', type=float, default=0.3,
                        help='Gate: ceiling on mean |cen_z error| (m)')
    parser.add_argument('--max_chamfer', type=float, default=0.2,
                        help='Gate: ceiling on avg chamfer metric')
    parser.add_argument('--splits', type=int, default=2,
                        help='Number of train/val assignments to gate: '
                             'split 0 is the canonical fixture split, '
                             'split k rotates the 13 trainval frames '
                             'by 3k')
    parser.add_argument('--max_val_cen_z_bias', type=float, default=1.5,
                        help='Gate: ceiling on held-out val cen_z bias '
                             '|mean signed error| (m)')
    parser.add_argument('--max_val_cen_z_abs', type=float, default=2.0,
                        help='Gate: ceiling on held-out val cen_z '
                             'magnitude, mean |error| (m)')
    parser.add_argument('--min_val_ap', type=float, default=0.0,
                        help='Gate: held-out val Car AP (BEV or 3D) '
                             'moderate at the low IoU regime must exceed '
                             'this (negative disables the val phase)')
    parser.add_argument('--flip', action=argparse.BooleanOptionalAction,
                        default=True,
                        help='Horizontal-flip augmentation during the '
                             'train phase')
    parser.add_argument('--skip_train', action='store_true',
                        help='Evaluate the existing checkpoint only')
    parser.add_argument('--device', type=str, default=None,
                        help="'cuda' (default), 'cuda:N' or 'cpu'")
    args = parser.parse_args(argv)

    from monopsr_torch.utils import device as device_lib
    device = device_lib.resolve_device(args.device)

    staging = os.path.join(monopsr_torch.data_dir(), 'outputs',
                           '_accuracy_gate_cfg')
    os.makedirs(staging, exist_ok=True)

    split_reports = []
    checks = {}
    for split_idx in range(max(1, args.splits)):
        report, split_checks = run_split(args, staging, split_idx)
        split_reports.append(report)
        prefix = '' if split_idx == 0 else 's{}_'.format(split_idx)
        checks.update({prefix + k: v for k, v in split_checks.items()})

    gate = dict(split_reports[0])
    gate['splits'] = split_reports
    gate['num_splits'] = len(split_reports)
    gate['checks'] = checks
    gate['pass'] = bool(all(checks.values()))
    gate['device'] = device_entry(device)

    out_path = args.out or os.path.join(REPO, 'ACCURACY.json')
    with open(out_path, 'w') as f:
        json.dump(gate, f, indent=2)
    print(json.dumps(gate))

    if not gate['pass']:
        failed = [k for k, v in checks.items() if not v]
        raise SystemExit('ACCURACY GATE FAILED: ' + ', '.join(failed))
    print('ACCURACY GATE PASSED ({} split(s)): train AP_3D (E/M/H) = '
          '{}; val AP_3D low = {}'.format(
              len(split_reports), gate['train']['ap_3d'],
              gate.get('val', {}).get('ap_3d_low')))


def run_split(args, staging, split_idx):
    """Runs the train and val phases of the gate on one train/val
    assignment (split 0: the fixture's; split k: rotated by 3k).

    Returns:
        (report_dict, checks_dict)
    """
    device = args.device
    from monopsr_torch.datasets.kitti.kitti_dataset import KittiDataset
    from monopsr_torch.eval.evaluator import Evaluator
    from monopsr_torch.train import trainer as trainer_lib

    if split_idx == 0:
        dataset_dir = FIXTURE
        exp_name = 'accuracy_gate'
    else:
        dataset_dir = make_rotated_fixture(3 * split_idx, staging)
        exp_name = 'accuracy_gate_s{}'.format(split_idx)

    config_path = build_gate_config(args, staging, 'train',
                                    dataset_dir=dataset_dir,
                                    exp_name=exp_name)
    config = config_utils.parse_yaml_config(config_path)

    t0 = time.time()
    if not args.skip_train:
        # A fresh experiment dir, so the gate never scores a stale run
        if os.path.exists(config.exp_output_dir):
            shutil.rmtree(config.exp_output_dir)
        train_dataset = KittiDataset(config.dataset_config, 'train')
        trainer_lib.train(config, train_dataset, device=device)
    train_time = time.time() - t0

    # ---- Phase 1: overfit consistency on the train split ----
    eval_dataset = KittiDataset(config.dataset_config, 'val')
    evaluator = Evaluator(config, eval_dataset, 'val',
                          do_kitti_native_eval=False, device=device)
    results = evaluator.run_latest_checkpoints('all')[-1]
    step = results['step']

    evaluator.run_kitti_native_eval(step)
    evaluator.wait_for_native_eval()
    train_aps = read_results(config, evaluator)
    # Phase 2 reuses the same pred_dir, overwriting these transcripts:
    # both regimes are read before the val phase runs.
    train_aps_low = read_results(config, evaluator, low_iou=True)
    if not train_aps:
        raise SystemExit('No train-split AP curves produced')

    ap_3d = train_aps.get('car_detection_3D', [0, 0, 0])
    ap_bev = train_aps.get('car_detection_BEV', [0, 0, 0])
    ap_2d = train_aps.get('car_detection', [0, 0, 0])
    ap_3d_low = train_aps_low.get('car_detection_3D', [0, 0, 0])
    ap_bev_low = train_aps_low.get('car_detection_BEV', [0, 0, 0])
    ap_2d_low = train_aps_low.get('car_detection', [0, 0, 0])

    metrics = results.get('metrics', {})
    metrics_abs = results.get('metrics_abs', {})
    # Mean |error|, not |mean error|: signed per-sample errors cancel
    cen_z_err = metrics_abs.get('metric_cen_z_err', float('inf'))
    chamfer = metrics.get('metric_chamfer', float('inf'))

    # Gated at the low IoU regime: the 0.7-IoU 3D AP of a short overfit
    # from random init moves by whole recall-grid quanta from run to run
    # (the JAX script's comment has the measurements); the 0.7 figures
    # stay in the report with a nonzero gate.
    checks = {
        'train_image_ap_floor': bool(ap_2d[1] >= args.min_ap),
        'train_ap_floor_low': bool(ap_3d_low[1] >= args.min_ap),
        'train_ap_agreement_low': bool(
            abs(ap_3d_low[1] - ap_bev_low[1]) <= args.ap_agreement and
            abs(ap_3d_low[1] - ap_2d_low[1]) <= args.ap_agreement),
        'train_ap_3d_07_nonzero': bool(ap_3d[1] > 0.0),
        'metric_cen_z_ceiling': bool(cen_z_err <= args.max_cen_z_err),
        'metric_chamfer_ceiling': bool(chamfer <= args.max_chamfer),
    }

    with open(os.path.join(config.dataset_config.dataset_dir,
                           'val.txt')) as f:
        val_frames = sorted(f.read().split())
    gate = {
        'metric': 'fixture_accuracy_gate',
        'split_index': split_idx,
        'split_rotation': 0 if split_idx == 0 else 3 * split_idx,
        'val_frames': val_frames,
        'steps': args.steps,
        'step_evaluated': step,
        'train_seconds': round(train_time, 1),
        'train': {
            'split': 'train',
            'ap_image': ap_2d,
            'ap_bev': ap_bev,
            'ap_3d': ap_3d,
            'ap_image_low': ap_2d_low,
            'ap_bev_low': ap_bev_low,
            'ap_3d_low': ap_3d_low,
            'low_iou_regime': '0.5/0.25/0.25',
            'aos': train_aps.get('car_orientation', [0, 0, 0]),
            'iou_regime': '0.7/0.5/0.5',
            'losses': results.get('losses', {}),
            'metrics': metrics,
            'metrics_abs': metrics_abs,
        },
        'gates': {
            'min_ap': args.min_ap,
            'ap_agreement': args.ap_agreement,
            'max_cen_z_err': args.max_cen_z_err,
            'max_chamfer': args.max_chamfer,
            'min_val_ap': args.min_val_ap,
            'max_val_cen_z_bias': args.max_val_cen_z_bias,
            'max_val_cen_z_abs': args.max_val_cen_z_abs,
        },
    }

    # ---- Phase 2: held-out val split through the real val path ----
    if args.min_val_ap >= 0:
        val_config = config_utils.parse_yaml_config(
            build_gate_config(args, staging, 'val', suffix='_val',
                              dataset_dir=config.dataset_config
                              .dataset_dir, exp_name=exp_name))
        # Same experiment and checkpoints: only data_split differs
        val_dataset = KittiDataset(val_config.dataset_config, 'val')
        val_eval = Evaluator(val_config, val_dataset, 'val',
                             do_kitti_native_eval=False, device=device)
        val_results = val_eval.run_latest_checkpoints([step])[-1]
        val_eval.run_kitti_native_eval(step)
        val_eval.wait_for_native_eval()
        val_aps = read_results(val_config, val_eval)
        val_aps_low = read_results(val_config, val_eval, low_iou=True)

        val_ap_3d_low = val_aps_low.get('car_detection_3D', [0, 0, 0])
        val_ap_bev_low = val_aps_low.get('car_detection_BEV', [0, 0, 0])
        val_ap_image = val_aps.get('car_detection', [0, 0, 0])
        # max over difficulty buckets: rotated splits change the val
        # set's difficulty mix
        checks['val_image_ap_floor'] = bool(
            max(val_ap_image) >= args.min_ap)
        checks['val_metric_ap_nonzero'] = bool(
            max(val_ap_bev_low[1], val_ap_3d_low[1]) > args.min_val_ap)
        # Two held-out depth gates: bias = |mean signed error| catches
        # systematic offsets; magnitude = mean |error| bounds the
        # per-frame error
        val_cen_z_bias = abs(val_results.get('metrics', {}).get(
            'metric_cen_z_err', float('inf')))
        val_cen_z_abs = val_results.get('metrics_abs', {}).get(
            'metric_cen_z_err', float('inf'))
        checks['val_cen_z_bias_ceiling'] = bool(
            val_cen_z_bias <= args.max_val_cen_z_bias)
        checks['val_cen_z_abs_ceiling'] = bool(
            val_cen_z_abs <= args.max_val_cen_z_abs)

        gate['val'] = {
            'split': 'val',
            'num_samples': val_results.get('num_samples'),
            'ap_image': val_aps.get('car_detection', [0, 0, 0]),
            'ap_bev': val_aps.get('car_detection_BEV', [0, 0, 0]),
            'ap_3d': val_aps.get('car_detection_3D', [0, 0, 0]),
            'iou_regime': '0.7/0.5/0.5',
            'ap_image_low': val_aps_low.get('car_detection', [0, 0, 0]),
            'ap_bev_low': val_aps_low.get(
                'car_detection_BEV', [0, 0, 0]),
            'ap_3d_low': val_ap_3d_low,
            'low_iou_regime': '0.5/0.25/0.25',
            'losses': val_results.get('losses', {}),
            'metrics': val_results.get('metrics', {}),
            'metrics_abs': val_results.get('metrics_abs', {}),
            'cen_z_bias_m': val_cen_z_bias,
            'cen_z_abs_m': val_cen_z_abs,
        }

    gate['split_checks'] = checks
    return gate, checks


if __name__ == '__main__':
    main()
