"""The eval cells' driver: ``Evaluator.run_checkpoint_once``, what
``run_evaluation`` (val mode) and ``run_inference`` (test mode) do to
every checkpoint.

Set-up generates the mix's KITTI-format split from the seed
(``traffic/kitti_split.py``: ``frames`` generated, listed over and over
up to ``frames_per_pass``) under a temporary directory, builds the
port's ``KittiDataset`` and ``Evaluator`` on it (native AP off), saves a
checkpoint of the seed's weights there and restores it, and runs one
pass over the generated frames once each (a second ``KittiDataset`` of
the split, cut to its first run through them), which warms up and
captures the graphed eval step and meets every slot bucket the split
holds. The window runs whole passes over the split list until
``seconds`` have passed; ``eval_fps`` is the frames whose predictions
were written over the window's wall time.

Correctness: once the window has closed and the program is freed, the
plain reference (``reference/kitti.py``) assembles every generated
frame from the arrays and label rows the generator wrote, runs the eager
eval step in the evaluator's groups, and formats the predictions; a
frame listed again in a pass is held to the same answers. Compared, each
against its limit: ``box_gap`` (the widest gap of the box_3d files the
last pass wrote: x y z l w h ry and score), ``xyz_gap`` (the widest gap
of the instance xyz maps it wrote, in metres) and, in val mode,
``emd_gap`` (every pass's per-box EMD metric, K1's output, relative)
and ``loss_gap`` (every pass's loss means, relative). A frame without
its files, or with another number of rows, fails the run.
"""

import os
import shutil
import tempfile
import time

import numpy as np

from benchmark import harness
from benchmark.drivers import common
from benchmark.reference import constants as C
from benchmark.reference import kitti as ref_kitti
from benchmark.traffic import kitti_split

STAGES = ('assembly', 'dispatch', 'pull', 'format', 'write')


def _calib_p2(split, name):
    path = os.path.join(split.dataset_dir, 'training', 'calib', name + '.txt')
    with open(path) as f:
        for line in f:
            if line.startswith('P2:'):
                return np.asarray(line.split()[1:], np.float64).reshape(3, 4)
    raise ValueError('no P2 in ' + path)


def eval_batch(cell):
    """The evaluator's batch, the frames of one dispatch group, as the
    program reads it: the split permutes its layouts in blocks of it."""
    train_config = dict(cell.experiment['train_config'],
                        **cell.traffic.get('train_config', {}))
    return int(train_config.get('eval_batch', 4))


def make_split(cell, seed, root):
    """The cell's KITTI-format split for ``seed`` under ``root``."""
    return kitti_split.make_split(
        cell.traffic, seed, root,
        threads=int(cell.traffic.get('generator_threads', 4)),
        block=eval_batch(cell))


def reference_outputs(cell, cfg, split, seed, device, lower=None,
                      count_flops=False):
    """The reference's answers for every frame of the split: {'rows':
    {name: box_3d rows}, 'xyz': {name: maps}, 'losses': {name: mean},
    'metrics': {name: per-box values in sample order}, 'k1_points': [per
    group, the valid points of each pair]}, and the forward's FLOPs per
    frame with ``count_flops``. ``lower`` makes it the control."""
    import torch
    mode = cell.traffic['mode']
    batch = eval_batch(cell)
    samples = []
    for frame in split.frames:
        p2 = _calib_p2(split, frame.name)
        out = ref_kitti.assemble(frame, mode, cfg, seed % (2 ** 32), p2,
                                 C.DEPTH_PAD_SHAPE)
        if out is not None:
            samples.append(out + (p2,))
    net, _ = common.reference_net(cfg, seed, device)
    net.eval()
    common.lower_precision(net, lower)
    rows, xyz, loss_sums, metrics, k1_points = {}, {}, {}, {}, []
    loss_config = common.loss_config(cell)
    with common.tf32(lower == 'tf32'):
        for group, padded in ref_kitti.groups_of(samples, batch):
            packed, losses, mets, valid = ref_kitti.eval_step(
                net, cfg, loss_config, mode, [d for _, d, _ in padded],
                device)
            if valid is not None:
                k1_points.append(valid.reshape(
                    valid.shape[0] * valid.shape[1], -1).sum(1))
            for i, (host, _, p2) in enumerate(group):
                name = host[C.SAMPLE_NAME]
                n = int(host[C.SAMPLE_NUM_OBJS])
                rows[name], xyz[name] = ref_kitti.format_boxes(
                    cfg, {k: v[i] for k, v in packed.items()}, host, mode,
                    p2)
                for key, value in losses.items():
                    loss_sums.setdefault(key, []).append(float(value[i]))
                for key, value in mets.items():
                    metrics.setdefault(key, []).append(
                        np.asarray(value[i])[:n].ravel())
        flops = None
        if count_flops:
            from torch.utils.flop_counter import FlopCounterMode
            from benchmark.reference import monopsr
            batch = {k: torch.from_numpy(v[None]).to(device)
                     for k, v in samples[0][1].items()
                     if k in monopsr.NET_INPUT_SAMPLE_KEYS}
            counter = FlopCounterMode(display=False)
            with counter, torch.inference_mode():
                net(**monopsr.net_inputs_from_batch(batch))
            flops = counter.get_total_flops()
    del net
    common.free(device)
    return {'rows': rows, 'xyz': xyz,
            'losses': {k: float(np.mean(v)) for k, v in loss_sums.items()},
            'metrics': {k: np.concatenate(v) for k, v in metrics.items()},
            'k1_points': k1_points, 'names': sorted(rows)}, flops


def _gap(got, want):
    return float(np.abs(np.asarray(got, np.float64) -
                        np.asarray(want, np.float64)).max(initial=0.0))


def _relative(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    floor = max(1e-3 * float(np.median(np.abs(want))), 1e-30)
    return float((np.abs(got - want) / np.maximum(np.abs(want), floor)).max(
        initial=0.0))


def compare(mode, got, want):
    """{number: value} of one side's answers against the reference's, and
    the frames whose answers are missing or of another shape."""
    numbers = {'box_gap': 0.0, 'xyz_gap': 0.0}
    missing = 0
    for name in want['names']:
        rows, maps = got['rows'].get(name), got['xyz'].get(name)
        if rows is None or maps is None or \
                rows.shape != want['rows'][name].shape or \
                maps.shape != want['xyz'][name].shape:
            missing += 1
            continue
        numbers['box_gap'] = max(numbers['box_gap'], _gap(
            rows[:, :8], want['rows'][name][:, :8]))
        numbers['xyz_gap'] = max(numbers['xyz_gap'], _gap(
            maps, want['xyz'][name]))
    if mode == 'val':
        numbers['emd_gap'] = max(
            _relative(m[C.METRIC_EMD], want['metrics'][C.METRIC_EMD])
            if m[C.METRIC_EMD].shape == want['metrics'][C.METRIC_EMD].shape
            else float('inf') for m in got['metrics'])
        numbers['loss_gap'] = max(
            _relative([losses.get(k, np.nan) for k in want['losses']],
                      list(want['losses'].values()))
            for losses in got['losses'])
    if missing:
        numbers = {k: float('inf') for k in numbers}
    return numbers, missing


def _program_answers(config, split, results, names):
    """What the program wrote and returned: the last pass's box_3d rows
    and xyz maps per frame, and every pass's per-box metrics and loss
    means."""
    step_dir = os.path.join(config.pred_dir, '{}', split.split, '1')
    rows, xyz = {}, {}
    for name in names:
        box = os.path.join(step_dir.format('box_3d'), name + '.txt')
        maps = os.path.join(step_dir.format('xyz_map_local'), name + '.npy')
        if os.path.exists(box) and os.path.exists(maps):
            rows[name] = np.loadtxt(box, ndmin=2)
            xyz[name] = np.load(maps).astype(np.float32)
    return {'rows': rows, 'xyz': xyz,
            'metrics': [r.get('metrics_per_box', {}) for r in results],
            'losses': [r.get('losses', {}) for r in results]}


class _Tracing:
    """Spans around the calls into the evaluator's layers, for one traced
    pass: assembly, dispatch, pull, format and write."""

    def __init__(self, ev, dataset, spans):
        from monopsr_torch.eval import kitti_writers, pipeline, predictions
        self.patches = [
            (ev, '_dispatch_groups', 'groups'),
            (kitti_writers, 'save_predictions_box_3d_in_kitti_format',
             'kitti_files'),
            (kitti_writers, 'save_metrics', 'metrics_csv'),
            (dataset, 'get_sample_dict', 'assembly'),
            (ev, '_eval_step', 'dispatch'),
            (pipeline, '_seconds_between', 'pull'),
            (predictions, 'format_predictions', 'format'),
            (predictions, 'save_predictions', 'write'),
        ]
        self.spans = spans
        self.saved = []

    def __enter__(self):
        for owner, attr, name in self.patches:
            fn = getattr(owner, attr)
            self.saved.append((owner, attr, fn, attr in vars(owner)))
            setattr(owner, attr, self.spans.wrap(fn, name))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn, own in reversed(self.saved):
            if own:
                setattr(owner, attr, fn)
            else:
                delattr(owner, attr)


def run(cell, seed, seconds, tracing, t0, device='cuda'):
    import torch
    from monopsr_torch.datasets.kitti.kitti_dataset import KittiDataset
    from monopsr_torch.eval import evaluator
    from monopsr_torch.train import trainer
    from monopsr_torch.train.train_state import TrainState
    from monopsr_torch.utils import device as device_lib
    device = device_lib.resolve_device(device)
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    traffic = cell.traffic
    mode = traffic['mode']
    spans = harness.Spans(tracing)
    workdir = tempfile.mkdtemp(prefix='monopsr_bench_')
    try:
        split = make_split(cell, seed, os.path.join(workdir, 'split'))
        config = common.program_config(
            cell, seed, workdir, dataset_dir=split.dataset_dir,
            mscnn_dir=split.mscnn_dir, data_split=split.split,
            data_split_dir='training')
        dataset = KittiDataset(config.dataset_config, mode)
        ev = evaluator.Evaluator(config, dataset, mode,
                                 do_kitti_native_eval=False, device=device)
        cfg = common.ref_config(cell)
        weights = common.make_weights(cfg, seed, device)
        params = {k: weights[k] for k, _ in ev.net.named_parameters()}
        buffers = {k: weights[k] for k, _ in ev.net.named_buffers()}
        manager = trainer.CheckpointManager(config.checkpoint_dir)
        trainer.save_checkpoint(manager, TrainState(
            step=1, params=params, batch_stats=buffers, opt_state=None,
            ema_params=params), 1)
        del weights, params, buffers
        state = ev.restore_checkpoint(manager, 1)
        # warm-up and capture: one pass over the generated frames once each
        warm = KittiDataset(config.dataset_config, mode)
        warm.sample_list = warm.sample_list[:len(split.frames)]
        warm.num_samples = len(warm.sample_list)
        ev.dataset = warm
        ev.run_checkpoint_once(state, 1)
        ev.dataset = dataset
        del warm
        # the split and the checkpoint reach the disk now, not while the
        # window reads
        os.sync()
        common.synchronize(device)
        setup_s = time.perf_counter() - t0

        results, frames, stage_ms = [], 0, dict.fromkeys(STAGES, 0.0)
        t_start = time.perf_counter()
        while True:
            result = ev.run_checkpoint_once(state, 1)
            results.append(result)
            frames += result['num_samples']
            per_item = ev.stage_times.per_item_ms()
            for stage in STAGES:
                stage_ms[stage] += per_item.get(stage, 0.0) * \
                    result['num_samples']
            if time.perf_counter() - t_start >= seconds:
                break
        common.synchronize(device)
        window_s = time.perf_counter() - t_start
        peak = common.memory_peak(device)

        trace = None
        if tracing:
            with _Tracing(ev, dataset, spans):
                result, trace = harness.traced(
                    lambda: ev.run_checkpoint_once(state, 1), spans)
            results.append(result)
        got = _program_answers(config, split, results, split.names)
        del ev, state, dataset
        common.free(device)

        want, flops = reference_outputs(cell, cfg, split, seed, device,
                                        count_flops=True)
        # a pass runs through the generated frames ``cycles`` times
        want['metrics'] = {k: np.tile(v, split.cycles)
                           for k, v in want['metrics'].items()}
        want['k1_points'] = want['k1_points'] * split.cycles
        numbers, missing = compare(mode, got, want)
        checks = common.checks(cell, numbers)
        k1 = None
        if trace is not None and want['k1_points']:
            launches = [s for n, s in trace['kernels']
                        if harness.kernel_group(n) == 'emd_kernel']
            if len(launches) == len(want['k1_points']):
                k1 = {'kernel_s': sum(launches),
                      'valid_points': want['k1_points']}
        context = dict(
            kind='eval', setup_s=setup_s, window_s=window_s, units=frames,
            memory_peak_bytes=peak, flops_per_frame=flops,
            compute_dtype=cell.experiment['model_config']['compute_dtype'],
            stage_ms={k: v / max(frames, 1) for k, v in stage_ms.items()},
            trace=trace, k1=k1, numbers=numbers)
        correct = missing == 0 and common.passed(checks)
        return common.Run(context, checks, frames, missing, correct)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
