"""Benchmark of the port on one NVIDIA GPU at production width.

Counterpart of the JAX system's ``bench.py`` and ``scripts/bench_ops.py``:

    python -m monopsr_torch.experiments.bench [--device cuda|cpu]
        [--seed 0] [--repeats 5] [--config YAML]

Every reading runs the code the CLIs run (``MonoPSRNet``,
``evaluator.Evaluator``, ``trainer.make_train_step``,
``step_graph.GraphedTrainStep``, ``eval.step_graph.GraphedEvalStep``,
the K1/K2 CUDA kernels) on the config of ``--config`` (default
``configs/monopsr_model_000.yaml``: ResNet-101 towers, 32 boxes,
320x1216, bfloat16, 100.4 M parameters) with seeded weights and
synthetic samples (``experiments/flagship.py``):

- ``device_fps``: the test-mode forward at batch 1 on inputs already on
  the card, as replays of a CUDA graph of it (the card's own rate, as
  the JAX bench's compiled forward gives it), by CUDA events over a run
  of calls;
- ``forward_fps``: the same with the upload of a pinned uint8 sample
  into the graph's inputs before each replay;
- ``eager_forward_fps``: the same forward at batch 1 run eagerly, op by
  op from the host; the host's launches set its pace;
- ``batched8_fps``: the graphed forward at 8 images on the card;
- ``eval_val_step_ms``: the val eval step (``make_eval_step`` in val
  mode: forward, GT, losses, metrics with K1, packing) at eval batch on
  one host batch, each call with its upload, as the evaluator runs it on
  the card (``graphed``: replays of ``eval.step_graph.GraphedEvalStep``)
  and eagerly (``eager``), by CUDA events over a run of calls;
  ``eval_dispatch_overhead_ms`` is the eager median less the graphed one;
- ``tf32_val_step_device_ms``: the device's busy ms of one val eval step
  (K1 included) at eval batch under the precision policy (TF32 off) and
  with TF32 on, in turns;
- ``e2e_fps`` and ``e2e_stages_ms_per_frame`` (assembly, dispatch,
  pull, format, write, wall): ``Evaluator`` in test mode over the KITTI
  fixture's val split repeated E2E_EPOCHS times per pass (several pulls
  of the pull pipeline; on the card the evaluator's eval step is a CUDA
  graph, captured in the warm-up pass), from a checkpoint of the seeded
  weights saved to a temporary directory, native AP off; the stages are
  the evaluator's own marks (``Evaluator.stage_times``);
- ``train_batch_curve``: the graphed train step (K = 4 steps per
  dispatch) at batches 1, 2, 4, 8 and at 8 with 'unit' remat (``8r``)
  and with 'conv_outs' remat (``8c``): ms/step, peak GB and
  ``train_mfu_pct``; ``train_dispatch_overhead_ms`` is the
  eager step's ms at batch 1 less the graphed one's;
- ``mfu``: FLOPs counted over one eager call at the same shapes
  (``profiling.count_flops``: convolutions and matmuls, forward and, for
  the train step, backward) times the rate, over the H100 SXM's dense
  bfloat16 peak (989 TFLOP/s) beside the card's power limit; a remat
  entry's share uses the model's FLOPs (the step without remat at its
  batch), and its recomputation stays in ``counted_gflops_per_step``;
- ``device_busy_pct``: the device's busy share of FORWARD_CALLS
  batch-1 forwards in a row (graphed and eager) and of one graphed
  dispatch at batch 1 under ``torch.profiler``, with their largest
  kernel groups (``device_busy_groups``);
- ``kernels``: K1 at the val eval step's shape (eval batch x boxes, ROI
  points) and K2 at the train step's (boxes, ROI points): ms, their
  bound (``profiling.emd_bound_ms`` from the card's SM count and maximum
  clock), ``pct_of_bound``, and each against its plain version on one
  call (phases 3 and 6 of ``chip_smoke.py``: cost 1e-3 relative, K2's
  accumulators 5e-3); ``chamfer_ms`` of ``ops/chamfer.nn_distance`` at
  the train step's shape.

Each timed reading is repeated ``--repeats`` times after a warm-up and
given as ``{median, q1, q3, n, unit}`` (``profiling.spread``). Every
output must be finite, the e2e pass must write a KITTI file per frame,
and no ``*_mfu_pct`` or ``pct_of_bound`` may exceed 100 (a share above
it means the timing is broken): any failed reading or check ends the run
with a non-zero exit and no result line. The last line of the output is
one JSON object with every reading, ``metric: inference_fps_h100`` and
``value`` = the median ``device_fps``.

With ``--device cpu`` each reading runs once, on the kernels' plain
versions, and every time, rate, share, busy figure and memory size is
null (not measured); only counts are filled (FLOPs, launches, frames,
files written). Without a card and without ``--device cpu`` it raises.
"""

import argparse
import json
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

import monopsr_torch
from monopsr_torch import config as config_lib
from monopsr_torch.datasets.kitti.kitti_dataset import KittiDataset
from monopsr_torch.eval import evaluator
from monopsr_torch.eval import step_graph as eval_graph
from monopsr_torch.experiments import flagship
from monopsr_torch.models import monopsr
from monopsr_torch.ops import chamfer as chamfer_ops
from monopsr_torch.ops import emd as emd_ops
from monopsr_torch.train import step_graph, trainer
from monopsr_torch.train.train_state import TrainState
from monopsr_torch.utils import cuda_graph
from monopsr_torch.utils import device as device_lib
from monopsr_torch.utils import profiling

REPO = monopsr_torch.top_dir()
FIXTURE = os.path.join(REPO, 'tests', 'datasets', 'Kitti', 'object')

# Dense bfloat16 rate of one H100 SXM at 700 W (NVIDIA's data sheet)
H100_BF16_PEAK_FLOPS = 989e12

FORWARD_CALLS = 10          # calls per timed run of the batch-1 forward
BATCHED = 8                 # images of the batched forward
BATCHED_CALLS = 5
EVAL_STEP_CALLS = 5         # calls per timed run of the val eval step
E2E_EPOCHS = 8              # the fixture's val split per e2e pass
GRAPH_K = 4                 # train steps per graphed dispatch
# (images per step, tower remat policy) of the train-step curve, each
# remat policy captured and replayed at batch 8
TRAIN_BATCHES = ((1, None), (2, None), (4, None), (8, None), (8, 'unit'),
                 (8, 'conv_outs'))
# An entry's key: its images, then this suffix of its remat policy
REMAT_KEYS = {None: '', 'unit': 'r', 'conv_outs': 'c'}
KERNEL_CALLS = 5
STAGES = ('assembly', 'dispatch', 'pull', 'format', 'write', 'wall')
KEEP = 0.6                  # share of unmasked points of the EMD clouds


class BenchFailure(RuntimeError):
    """A reading gave a non-finite output, a wrong count or a share of
    the card above 100%."""


def _check(ok, message):
    if not ok:
        raise BenchFailure(message)


def _finite(tree, what):
    """Raises unless every floating tensor of ``tree`` is finite."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            _finite(value, '{}[{}]'.format(what, key))
    elif torch.is_tensor(tree) and tree.is_floating_point():
        _check(bool(torch.isfinite(tree).all()),
               '{} is not finite'.format(what))


def _spread(samples, unit):
    """profiling.spread with its unit; None when not measured."""
    if samples is None:
        return None
    return dict(profiling.spread(samples), unit=unit)


def _median(reading):
    return None if reading is None else reading['median']


def _share(value, what):
    """A share of the card in percent, held to at most 100."""
    if value is not None:
        _check(value <= 100.0, '{} is {:.3f}%, above 100%: the timing is '
               'broken'.format(what, value))
    return value


def _mfu_pct(flops, per_second):
    if per_second is None:
        return None
    return 100.0 * flops * per_second / H100_BF16_PEAK_FLOPS


def _fps(ms, images=1):
    return None if ms is None else [1e3 * images / t for t in ms]


class Run:
    """One run's device, seed, repeats and config, and its timers."""

    def __init__(self, device, seed, repeats, yaml_path):
        self.device = device
        self.cuda = device.type == 'cuda'
        self.seed = seed
        self.repeats = repeats
        self.yaml_path = yaml_path
        self.config = flagship.flagship_yaml(yaml_path)
        self.cfg = flagship.flagship_config(self.config)

    def repeat_ms(self, fn, calls):
        """ms per call of ``fn``: on the card, one untimed run of
        ``calls`` calls (the card leaves its idle clocks), then
        ``repeats`` runs of ``calls`` calls, each timed by CUDA events;
        on the CPU one call and None."""
        if not self.cuda:
            fn()
            return None
        return [profiling.time_cuda(fn, calls, warmup=calls if i == 0 else 0)
                for i in range(self.repeats)]

    def repeat_wall_ms(self, fn):
        """ms of ``fn`` by the host clock up to a synchronize: one
        warm-up call, then ``repeats`` timed ones; on the CPU one call
        and None."""
        fn()
        if not self.cuda:
            return None
        out = []
        for _ in range(self.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    def profile(self, fn, arg, calls=1):
        """(busy %, the five largest kernel groups as [name, ms,
        launches]) of ``calls`` calls ``fn(arg)`` in a row under the
        profiler (a run of short calls spreads the profiler's own start
        over them); (None, None) on the CPU or when the trace holds no
        device time."""
        if not self.cuda:
            return None, None
        wall, busy, groups = profiling.profile_step(
            lambda a: [fn(a) for _ in range(calls)], arg, top=6)
        if busy is None:
            return None, None
        return 100.0 * busy / wall, [[name, ms, launches] for name, (
            ms, launches) in list(groups.items())[:5]]


# -- the forward ---------------------------------------------------------

def forward_flops(net, batch):
    """FLOPs of one test-mode forward of ``net`` on ``batch``."""
    return profiling.count_flops(flagship.forward, net, batch)


def graphed_forward(run, net, batch):
    """(replay, outputs) of the test-mode forward of ``net`` on the device
    batch ``batch``. On the card ``replay()`` replays a CUDA graph of the
    forward, captured after one eager call on the capture's stream: the
    batch's tensors are its inputs (copy into them to change the sample)
    and ``outputs`` its output tensors, which each replay overwrites. On
    the CPU ``replay()`` runs the forward eagerly into ``outputs``."""
    if not run.cuda:
        outputs = {}

        def replay():
            outputs.update(flagship.forward(net, batch))
        replay()
        return replay, outputs
    graph = cuda_graph.SideStreamGraph(run.device, 'forward')
    graph.warm_up(lambda: flagship.forward(net, batch))
    outputs = graph.capture(lambda: flagship.forward(net, batch))
    graph.replay()
    return graph.replay, outputs


def bench_device_only(run, net, sample):
    """Frames/s of the graphed test-mode forward at batch 1 on a sample
    already on the device: ms per call by CUDA events over FORWARD_CALLS
    calls, ``repeats`` times. Returns (frames/s, replay, the graph's
    outputs, its input tensors)."""
    on_device = evaluator.batch_to_device(sample, run.device)
    replay, outputs = graphed_forward(run, net, on_device)
    _finite(outputs, 'the graphed forward')
    return (_spread(_fps(run.repeat_ms(replay, FORWARD_CALLS)), 'frames/s'),
            replay, outputs, on_device)


def bench_forward(run, sample, replay, outputs, inputs):
    """Frames/s of the same with the upload of the sample from pinned
    host memory (uint8 image) into the graph's ``inputs`` before each
    replay."""
    host = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sample.items()}
    if run.cuda:
        host = {k: v.pin_memory() for k, v in host.items()}

    def upload_and_replay():
        for key, value in host.items():
            inputs[key].copy_(value, non_blocking=True)
        replay()
    upload_and_replay()
    _finite(outputs, 'the graphed forward after its upload')
    return _spread(_fps(run.repeat_ms(upload_and_replay, FORWARD_CALLS)),
                   'frames/s')


def bench_eager_forward(run, net, sample):
    """Frames/s of the eager test-mode forward at batch 1 on a sample
    already on the device."""
    on_device = evaluator.batch_to_device(sample, run.device)
    _finite(flagship.forward(net, on_device), 'the eager forward')
    return _spread(_fps(run.repeat_ms(
        lambda: flagship.forward(net, on_device), FORWARD_CALLS)),
        'frames/s')


def bench_batched(run, net, images=BATCHED):
    """(frames/s, FLOPs per frame) of the graphed forward at ``images``
    images on the device."""
    batch = evaluator.batch_to_device(monopsr.strip_to_net_inputs(
        flagship.synthetic_batch(run.seed + 1, run.cfg, images)),
        run.device)
    flops = forward_flops(net, batch)
    replay, outputs = graphed_forward(run, net, batch)
    _finite(outputs, 'the batched forward')
    ms = run.repeat_ms(replay, BATCHED_CALLS)
    return _spread(_fps(ms, images), 'frames/s'), flops / images


def bench_eval_val_step(run, net):
    """ms per call of the val eval step at eval batch on one synthetic
    host batch, each call with its upload: {'graphed': replays of a
    ``GraphedEvalStep`` (after its warm-up call and its capture),
    'eager': ``make_eval_step`` itself}, by CUDA events over
    EVAL_STEP_CALLS calls, ``repeats`` times each. On the CPU one eager
    step and None for both."""
    eval_batch = int(run.config.train_config.get('eval_batch', 4))
    step = evaluator.make_eval_step(net, run.cfg,
                                    flagship.loss_config(run.config), 'val',
                                    device=run.device)
    batch = flagship.synthetic_batch(run.seed + 2, run.cfg, eval_batch)
    _finite(dict(enumerate(step(batch))), 'the eager val eval step')
    if not run.cuda:
        return {'graphed': None, 'eager': None}
    graphed = eval_graph.GraphedEvalStep(step, run.device, net,
                                         run.cfg.num_boxes)
    graphed(batch)                    # the warm-up call
    _finite(dict(enumerate(graphed(batch))), 'the graphed val eval step')
    ms = {'graphed': run.repeat_ms(lambda: graphed(batch), EVAL_STEP_CALLS),
          'eager': run.repeat_ms(lambda: step(batch), EVAL_STEP_CALLS)}
    del graphed
    torch.cuda.empty_cache()
    return {key: _spread(value, 'ms/step') for key, value in ms.items()}


def bench_tf32(run, net):
    """The device's busy ms of one val eval step (``make_eval_step`` in
    val mode: forward, GT, losses, metrics with K1) at eval batch under
    the precision policy (TF32 off) and with TF32 on for cuBLAS and
    cuDNN, in turns off, on, on, off, ... (``repeats`` each), each turn
    a warm-up step and one step under the profiler: {'tf32_off': ms,
    'tf32_on': ms}. TF32 reaches only the float32 convolutions and
    matmuls (the map heads, the FC trunks, the geometry); the towers and
    the decoder run in bfloat16 either way. On the CPU one step and
    None."""
    eval_batch = int(run.config.train_config.get('eval_batch', 4))
    step = evaluator.make_eval_step(net, run.cfg,
                                    flagship.loss_config(run.config), 'val',
                                    device=run.device)
    batch = evaluator.batch_to_device(flagship.synthetic_batch(
        run.seed + 2, run.cfg, eval_batch), run.device)
    _finite(dict(enumerate(step(batch))), 'the val eval step')
    if not run.cuda:
        return None
    busy = {'tf32_off': [], 'tf32_on': []}
    try:
        for i in range(2 * run.repeats):
            on = (i + i // 2) % 2 == 1
            torch.backends.cuda.matmul.allow_tf32 = on
            torch.backends.cudnn.allow_tf32 = on
            step(batch)
            _, ms, _ = profiling.profile_step(step, batch, top=0)
            if ms is None:
                return None
            busy['tf32_on' if on else 'tf32_off'].append(ms)
    finally:
        device_lib.set_float32_precision()
    return {key: _spread(ms, 'device ms/step') for key, ms in busy.items()}


# -- end to end ---------------------------------------------------------

def bench_e2e(run):
    """``Evaluator`` in test mode over the KITTI fixture's val split
    repeated E2E_EPOCHS times in one pass (assembly on its producer
    threads, the eval step, the pull pipeline, formatting and writing),
    from a checkpoint of the seeded weights in a temporary directory,
    native AP off: frames/s and the evaluator's stage times per frame of
    each pass after a warm-up pass, the frames and the samples with
    objects of a pass, and the KITTI files written (one per frame of the
    split)."""
    base = tempfile.mkdtemp(prefix='monopsr_bench_')
    try:
        config = config_lib.parse_yaml_config(run.yaml_path,
                                              output_base_dir=base)
        dataset_config = config.dataset_config
        dataset_config.dataset_dir = FIXTURE
        dataset_config.mscnn_dir = os.path.join(FIXTURE, 'mscnn')
        dataset_config.data_split = 'val'     # the fixture's, in training/
        dataset_config.data_split_dir = 'training'
        dataset = KittiDataset(dataset_config, 'test')
        names = {sample.name for sample in dataset.sample_list}
        dataset.sample_list = np.concatenate([dataset.sample_list] *
                                             E2E_EPOCHS)
        dataset.num_samples = len(dataset.sample_list)
        ev = evaluator.Evaluator(config, dataset, 'test',
                                 do_kitti_native_eval=False,
                                 device=run.device)
        net = monopsr.create_net(run.cfg, device=run.device, seed=run.seed)
        params = {k: p.detach() for k, p in net.named_parameters()}
        manager = trainer.CheckpointManager(config.checkpoint_dir)
        trainer.save_checkpoint(manager, TrainState(
            step=1, params=params, batch_stats=dict(net.named_buffers()),
            opt_state=None, ema_params=params), 1)
        del net, params
        state = ev.restore_checkpoint(manager, 1)

        passes = []
        for _ in range(1 + (run.repeats if run.cuda else 0)):
            t0 = time.perf_counter()
            result = ev.run_checkpoint_once(state, 1)
            wall = time.perf_counter() - t0
            stages = ev.stage_times.per_item_ms()
            stages['wall'] = 1e3 * wall / result['num_samples']
            passes.append((result['num_samples'] / wall, stages))
        passes = passes[1:] if run.cuda else None

        kitti_dir = os.path.join(
            config.pred_dir, 'kitti_predictions_3d', 'val',
            str(round(ev.score_threshold, 3)), '1', 'data')
        box_dir = os.path.join(config.pred_dir, 'box_3d', 'val', '1')
        frames = dataset.num_samples
        files = len(os.listdir(kitti_dir))
        _check(files == len(names), 'the e2e pass wrote {} KITTI files for '
               '{} frames'.format(files, len(names)))
        boxes = os.listdir(box_dir)
        _check(len(boxes) * E2E_EPOCHS == result['num_samples'],
               'the e2e pass wrote {} box files for {} samples in {} '
               'epochs'.format(len(boxes), result['num_samples'],
                               E2E_EPOCHS))
        for name in boxes:
            rows = np.loadtxt(os.path.join(box_dir, name), ndmin=2)
            _check(bool(np.isfinite(rows).all()),
                   'e2e box file {} is not finite'.format(name))
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return dict(
        e2e_fps=_spread(passes and [p[0] for p in passes], 'frames/s'),
        e2e_stages_ms_per_frame={
            stage: _spread(passes and [p[1][stage] for p in passes],
                           'ms/frame') for stage in STAGES},
        e2e_epochs=E2E_EPOCHS, e2e_frames=frames,
        e2e_samples=result['num_samples'], e2e_kitti_files=files)


# -- training -----------------------------------------------------------

def bench_train_step(run, images=1):
    """ms/step of the eager train step (one step per host dispatch) at
    ``images`` images, by the host clock up to a synchronize."""
    step, state, batch = flagship.build_train_setup(
        run.cfg, images, run.device, run.seed, None, run.config)
    return _spread(run.repeat_wall_ms(lambda: step(state, batch)),
                   'ms/step')


def bench_train_step_graphed(run, images, remat=None, profile=False):
    """The train step at ``images`` images per step (tower remat policy
    ``remat``) as the training loop runs it at ``steps_per_dispatch:
    GRAPH_K``: on the card, dispatches of GRAPH_K replays of a CUDA graph
    of the step (``GraphedTrainStep``); on the CPU, GRAPH_K eager steps.
    Its FLOPs are counted over one eager step before (a remat policy's
    recomputed forward included). Returns the curve's entry: ms/step of a
    dispatch after the warm-up dispatch (which holds the eager first step
    and the capture), the peak GB from before the capture and the counted
    GFLOPs per step; with ``profile``, the device's busy share of one
    dispatch and its largest kernel groups."""
    step, state, batch = flagship.build_train_setup(
        run.cfg, images, run.device, run.seed, remat, run.config)
    flops = profiling.count_flops(step, state, batch)
    dispatch = [batch] * GRAPH_K
    if run.cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        graphed = step_graph.GraphedTrainStep(step, run.device)
    else:
        graphed = trainer.eager_steps(step)
    holder = [state, None]

    def run_dispatch(batches):
        holder[:] = graphed(holder[0], batches)

    ms = run.repeat_wall_ms(lambda: run_dispatch(dispatch))
    _finite(holder[1], 'the train step losses at batch {}'.format(images))
    entry = dict(
        batch=images, remat=remat,
        ms_per_step=_spread(ms and [t / GRAPH_K for t in ms], 'ms/step'),
        peak_gb=(torch.cuda.max_memory_allocated() / 1e9
                 if run.cuda else None),
        counted_gflops_per_step=flops / 1e9)
    if profile:
        entry['device_busy_pct'], entry['device_busy_groups'] = \
            run.profile(run_dispatch, dispatch)
    del step, state, batch, graphed, holder
    if run.cuda:
        torch.cuda.empty_cache()
    return entry


# -- kernels ------------------------------------------------------------

def _clouds(run, gen, b, n):
    """Random masked clouds, as ``chip_smoke.py`` draws them for its
    kernel phases: both zeroed outside one random mask (a share 1 - KEEP
    of exact zero points), as the metrics and the 'emd' loss mask the
    maps."""
    xyz1 = torch.randn(b, n, 3, generator=gen, device=run.device)
    xyz2 = torch.randn(b, n, 3, generator=gen, device=run.device) * 0.6 + 0.1
    mask = (torch.rand(b, n, 1, generator=gen, device=run.device)
            < KEEP).float()
    return (xyz1 * mask).contiguous(), (xyz2 * mask).contiguous()


def bench_kernels(run):
    """K1 at the val eval step's shape (eval batch x boxes pairs of ROI
    points) and K2 at the train step's (boxes pairs), each checked
    against its plain version on one call and timed by CUDA events, with
    its bound; then ``chamfer.nn_distance`` at the train step's shape.
    Returns (kernel entries, chamfer ms, chamfer shape)."""
    eval_batch = int(run.config.train_config.get('eval_batch', 4))
    boxes = run.cfg.num_boxes
    points = run.cfg.map_roi_size[0] * run.cfg.map_roi_size[1]
    gen = torch.Generator(device=run.device).manual_seed(run.seed)
    if run.cuda:
        sms = torch.cuda.get_device_properties(
            run.device).multi_processor_count
        clock = float(profiling.nvidia_smi('clocks.max.sm').split()[0])
    kernels = []
    for name, b, fp32_ops in (('emd_cost_fused', eval_batch * boxes, 129),
                              ('emd_loss', boxes, 230)):
        xyz1, xyz2 = _clouds(run, gen, b, points)
        if name == 'emd_cost_fused':
            counter = fn = emd_ops.emd_cost_fused
            out_floats = b
        else:
            counter, fn = emd_ops.emd_distance, emd_ops.emd_loss_accumulators
            out_floats = b * (1 + 4 * 2 * points)
        launches = counter.launches
        got = fn(xyz1, xyz2)
        if name == 'emd_cost_fused':
            got = (got,)
            want = (emd_ops.emd_cost_fused_plain(xyz1, xyz2, batch_chunk=8),)
            acc = []
        else:
            want = emd_ops.emd_loss_plain_accumulators(xyz1, xyz2,
                                                       batch_chunk=8)
            acc = emd_ops.accumulator_errors(
                got, want, *emd_ops.floored_points(xyz1, xyz2))
        _finite(dict(enumerate(got)), name)
        floor = max(1e-6 * float(want[0].abs().max()), 1e-30)
        cost_rel = float(((got[0] - want[0]).abs() /
                          want[0].abs().clamp(min=floor)).max())
        _check(cost_rel <= 1e-3, '{} cost is {:.3e} from its plain version '
               '(bound 1e-3)'.format(name, cost_rel))
        _check(max(acc, default=0.0) < 5e-3, '{} accumulators are {} from '
               'the plain version (bound 5e-3)'.format(name, acc))
        ms = _spread(run.repeat_ms(lambda: fn(xyz1, xyz2), KERNEL_CALLS),
                     'ms')
        bound_ms = bound_by = pct = None
        if run.cuda:
            bound_ms, bound_by = profiling.emd_bound_ms(
                b, points, points, sms, clock, fp32_ops, out_floats)
            pct = _share(100.0 * bound_ms / ms['median'],
                         '{} pct_of_bound'.format(name))
        kernels.append(dict(
            name=name, shape=[b, points, points], ms=ms, bound_ms=bound_ms,
            bound_by=bound_by, pct_of_bound=pct, cost_max_rel_err=cost_rel,
            accumulators_max_rel_err=acc,
            launches=counter.launches - launches))
        del xyz1, xyz2, got, want

    xyz1, xyz2 = _clouds(run, gen, boxes, points)
    _finite(dict(enumerate(chamfer_ops.nn_distance(xyz1, xyz2)[::2])),
            'the Chamfer distances')
    chamfer_ms = _spread(run.repeat_ms(
        lambda: chamfer_ops.nn_distance(xyz1, xyz2), KERNEL_CALLS), 'ms')
    return kernels, chamfer_ms, [boxes, points, points]


def device_readings(device):
    """The torch and CUDA versions; on the card its name, the card count,
    and the power limit and SM clock as nvidia-smi prints them."""
    info = {'torch': torch.__version__, 'cuda': torch.version.cuda,
            'device': str(device), 'name': None, 'count': None,
            'power_limit': None, 'sm_clock': None}
    if device.type == 'cuda':
        _, power, clock = [part.strip() for part in profiling.nvidia_smi(
            'name,power.limit,clocks.sm').split(',')]
        info.update(name=torch.cuda.get_device_name(device),
                    count=torch.cuda.device_count(), power_limit=power,
                    sm_clock=clock)
    return info


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', choices=('cuda', 'cpu'), default=None,
                        help='cuda (default; raises without a card) or cpu '
                        '(counts only, every timing null)')
    parser.add_argument('--seed', type=int, default=0,
                        help='seed of the weights, samples and clouds')
    parser.add_argument('--repeats', type=int, default=5,
                        help='timed repeats of each reading on the card')
    parser.add_argument('--config', default=flagship.CONFIG_PATH,
                        help='experiment YAML (default: the production '
                        'config)')
    args = parser.parse_args(argv)
    if args.repeats < 1:
        parser.error('--repeats must be at least 1')
    run = Run(device_lib.resolve_device(args.device), args.seed,
              args.repeats, args.config)
    card = device_readings(run.device)
    print('bench: {}, {}'.format(card['name'] or 'cpu (not measured)',
                                 card['power_limit']), flush=True)

    fwd, (net, sample) = flagship.entry(run.device, run.seed, run.config)
    device_fps, replay, outputs, inputs = bench_device_only(run, net,
                                                           sample)
    forward_fps = bench_forward(run, sample, replay, outputs, inputs)
    forward_busy, forward_groups = run.profile(lambda _: replay(), None,
                                               FORWARD_CALLS)
    eager_fps = bench_eager_forward(run, net, sample)
    on_device = evaluator.batch_to_device(sample, run.device)
    fwd_flops = forward_flops(net, on_device)
    eager_busy, eager_groups = run.profile(lambda b: fwd(net, b), on_device,
                                           FORWARD_CALLS)
    batched_fps, batched_flops = bench_batched(run, net)
    val_step = bench_eval_val_step(run, net)
    tf32 = bench_tf32(run, net)
    del net, on_device, replay, outputs, inputs
    if run.cuda:
        torch.cuda.empty_cache()
    e2e = bench_e2e(run)
    eager = bench_train_step(run)
    curve = {'{}{}'.format(images, REMAT_KEYS[remat]):
             bench_train_step_graphed(run, images, remat,
                                      profile=images == 1 and not remat)
             for images, remat in TRAIN_BATCHES}
    for key, entry in curve.items():
        # Model FLOPs: a remat policy's recomputed forward is work the
        # step does, not work the model needs
        entry['gflops_per_step'] = curve[str(entry['batch'])][
            'counted_gflops_per_step']
        ms = _median(entry['ms_per_step'])
        entry['train_mfu_pct'] = _share(_mfu_pct(
            entry['gflops_per_step'] * 1e9, ms and 1e3 / ms),
            'train_mfu_pct of {}'.format(key))
    kernels, chamfer_ms, chamfer_shape = bench_kernels(run)

    timed = [key for key, entry in curve.items() if entry['ms_per_step']]
    best = max(timed, key=lambda key: curve[key]['train_mfu_pct'],
               default=None)
    graphed1 = curve['1']['ms_per_step']
    mfu = dict(
        peak_tflops_bf16=H100_BF16_PEAK_FLOPS / 1e12,
        peak_power_limit=card['power_limit'],
        forward_gflops_per_frame=fwd_flops / 1e9,
        device_mfu_pct=_share(_mfu_pct(fwd_flops, _median(device_fps)),
                              'device_mfu_pct'),
        batched8_gflops_per_frame=batched_flops / 1e9,
        batched8_mfu_pct=_share(_mfu_pct(batched_flops,
                                         _median(batched_fps)),
                                'batched8_mfu_pct'),
        train_gflops_per_step=curve['1']['gflops_per_step'],
        train_mfu_pct=None if best is None else curve[best]['train_mfu_pct'],
        train_mfu_batch=None if best is None else curve[best]['batch'],
        train_mfu_remat=None if best is None else bool(curve[best]['remat']),
        train_mfu_batch1_pct=curve['1']['train_mfu_pct'])
    overhead = (None if eager is None else
                eager['median'] - graphed1['median'])
    eval_overhead = (None if val_step['eager'] is None else
                     val_step['eager']['median'] -
                     val_step['graphed']['median'])
    result = {
        'metric': 'inference_fps_h100',
        'value': _median(device_fps),
        'unit': 'frames/s',
        'device': card,
        'config': os.path.relpath(os.path.abspath(args.config), REPO),
        'seed': args.seed,
        'repeats': args.repeats if run.cuda else 1,
        'device_fps': device_fps,
        'forward_fps': forward_fps,
        'eager_forward_fps': eager_fps,
        'batched8_fps': batched_fps,
        'eval_val_step_ms': val_step,
        'eval_dispatch_overhead_ms': eval_overhead,
        'tf32_val_step_device_ms': tf32,
        'train_batch_curve': curve,
        'train_steps_per_dispatch': GRAPH_K,
        'train_eager_ms_per_step_batch1': eager,
        'train_dispatch_overhead_ms': overhead,
        'mfu': mfu,
        'device_busy_pct': {
            'forward_batch1': forward_busy,
            'eager_forward_batch1': eager_busy,
            'graphed_dispatch_batch1': curve['1'].get('device_busy_pct')},
        'device_busy_groups': {
            'forward_batch1': forward_groups,
            'eager_forward_batch1': eager_groups,
            'graphed_dispatch_batch1': curve['1'].get('device_busy_groups')},
        'kernels': kernels,
        'chamfer_ms': chamfer_ms,
        'chamfer_shape': chamfer_shape,
    }
    result.update(e2e)
    for value in (result['value'], overhead, eval_overhead):
        _check(value is None or math.isfinite(value),
               'a reading is not finite: {}'.format(value))
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
