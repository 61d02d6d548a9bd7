"""Tiny cells for the CPU tests: the real mixes and configurations cut
to a ResNet of one unit per block, small input and ROI shapes and few
frames and samples, run with the plain kernels on the CPU."""

import copy
import os

from benchmark import harness

SEED = 2 ** 33 + 12345
# Limits at the tiny size, for the faults and the control to cross
LIMITS = {'loss_gap.s2': 1e-3, 'loss_gap.s3': 1e-3, 'grad_gap': 1e-3,
          'change_gap': 1e-2, 'loss_gap': 1e-3,
          'ema_gap': 5e-2, 'box_gap': 1e-3, 'xyz_gap': 1e-3,
          'emd_gap': 1e-3}


def tiny_config(name, dtype='float32'):
    config = copy.deepcopy(harness.load_json(os.path.join(
        harness.BENCH_DIR, 'configs', name + '.json')))
    model = config['experiment']['model_config']
    model.update(image_input_shape=[96, 320], resized_full_img_shape=[48, 160],
                 img_roi_size=[16, 16], map_roi_size=[16, 16],
                 resnet='resnet_tiny', compute_dtype=dtype)
    model['proposal_fc_layers']['layer_sizes'] = [16, 16]
    model['regression_fc_layers']['layer_sizes'] = [16, 16]
    config['experiment']['dataset_config']['num_boxes'] = 8
    return config


# The metrics a tiny cell of each kind reports (readers under
# benchmark/metrics/, found by name)
METRICS = {
    'train': (['train_samples_per_s', 'peak_device_gb', 'setup_s'],
              ['train.step_mfu_pct', 'train.device_idle_pct']),
    'eval': (['eval_fps', 'peak_device_gb', 'setup_s'],
             ['eval.step_mfu_pct', 'eval.device_idle_pct',
              'eval.assembly_ms_per_frame', 'eval.output_ms_per_frame',
              'k1_emd_cost_roofline']),
}


def tiny_cell(traffic_name, dtype='float32', mode=None):
    """A Cell of the mix ``traffic_name`` on the tiny configuration, with
    the metrics of its kind; ``mode`` sets an eval mix's mode ('test':
    ``run_inference``'s path over the same split)."""
    name = 'tiny.' + traffic_name + ('.' + mode if mode else '')
    traffic = harness.load_json(os.path.join(
        harness.BENCH_DIR, 'workloads', traffic_name + '.json'))
    if mode:
        traffic = dict(traffic, mode=mode)
    e2e, per_layer = METRICS[traffic['kind']]
    spec = {'configs': [{'name': 'tiny', 'file': 'none'}],
            'workloads': [{'name': name, 'config': 'tiny',
                           'traffic': traffic_name, 'chips': 1}],
            'end_to_end': [{'name': m, 'unit': 'u'} for m in e2e],
            'per_layer': [{'name': m, 'unit': 'u'} for m in per_layer]}
    if traffic['kind'] == 'train':
        traffic = dict(traffic, distinct_samples=8, traced_dispatches=1)
    else:
        traffic = dict(traffic, frames=6, frames_per_pass=12,
                       generator_threads=2,
                       objects_per_frame=dict(traffic['objects_per_frame'],
                                              crowded_share=0.2,
                                              crowded_range=[9, 12]))
    limits = {key: {'limit': value} for key, value in LIMITS.items()}
    return harness.Cell(name, spec, tiny_config('monopsr_r101_bf16', dtype),
                        traffic, limits)
