"""Evaluation: the eval step, and the runtime around it.

Counterpart of ``monopsr_tpu/eval/evaluator.py`` and of
``stack_samples`` in ``monopsr_tpu/train/trainer.py``.

- ``make_eval_step``: forward, then (val mode) GT, losses and metrics,
  over a stacked batch. The JAX step vmaps the per-sample GT, loss and
  metric functions; here they take the batch axis directly. In val mode
  the EMD metric launches the kernel K1 once per step (on CUDA).
- ``Evaluator``: per checkpoint, restores the weights (EMA preferred)
  into a net built once, runs one epoch of the dataset in groups of
  ``eval_batch`` (the tail padded by repeating its last sample) through
  its eval step, built once as JAX builds its jit (on CUDA a
  ``step_graph.GraphedEvalStep``: one CUDA graph of the step, captured
  at the second group and replayed for every later group of every
  checkpoint; on the CPU the eager step), saves
  the predictions, the loss means, the per-box metrics' CSVs and the
  KITTI files, and (val mode) runs the native AP evaluator; a polling
  loop with an ``evaluated_<split>.txt`` ledger skips finished
  checkpoints.

Where the JAX evaluator leans on the TPU or on JAX: checkpoints are the
port's ``torch.save`` files (``train/trainer.py``), memory-mapped and
read for the weights only; the device-to-host pipeline copies tensor by
tensor (``eval/pipeline.py``), not as one packed buffer; the native
evaluator is built and started by ``eval/native_eval.py`` with
``subprocess.Popen``, not by ``make`` and a forked process. As in
JAX, only the polling loop writes the ledger.

``eval_data_parallel`` (or ``data_parallel``) is clamped to the visible
devices, as JAX clamps its mesh, and counts processes: the evaluator
runs in each rank of a process group that ``parallel.data_parallel
.launch`` starts (the evaluation and inference CLIs start it when the
clamped count is above 1). ``eval_batch`` is rounded up to a multiple
of the ranks. The dispatch groups are formed from the samples' label
files (``KittiDataset.has_objects``), as one rank forms them; each rank
assembles only its rows of each group and runs the eval step, K1
included, on them. Rank 0 gathers the group's outputs and the host
fields of its samples, and alone writes the predictions, KITTI files,
metrics, logs and ledger and runs the native AP evaluator.
"""

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from monopsr_torch import constants as C
from monopsr_torch.eval import kitti_writers, native_eval, pipeline
from monopsr_torch.eval import predictions, step_graph
from monopsr_torch.models import monopsr
from monopsr_torch.parallel import data_parallel as dp_lib
from monopsr_torch.train import optimizer as opt_lib
from monopsr_torch.train import trainer as trainer_lib
from monopsr_torch.train.train_state import TrainState
from monopsr_torch.utils import device as device_lib
from monopsr_torch.utils import prefetch, profiling, tb_events


def stack_samples(samples):
    """Stacks per-sample dicts into arrays with a leading batch axis."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def batch_to_device(batch, device):
    """Moves a stacked batch (numpy arrays or tensors) to ``device``,
    keeping each array's dtype (uint8/uint16 encodings decode on device);
    non-array values are dropped."""
    out = {}
    for key, value in batch.items():
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(np.ascontiguousarray(value))
        if torch.is_tensor(value):
            out[key] = value.to(device, non_blocking=True)
    return out


def requested_eval_ranks(train_config):
    """A config's ``eval_data_parallel``, else its ``data_parallel``."""
    return train_config.get('eval_data_parallel',
                            train_config.get('data_parallel', 1))


def _gather_outputs(out):
    """An eval step's (outputs, losses, metrics) dicts with every rank's
    rows, in rank order (``data_parallel.gather_rows``); each dict keeps
    its keys' order."""
    keys = [list(part) for part in out]
    flat = dp_lib.gather_rows([part[k] for part, ks in zip(out, keys)
                               for k in ks])
    gathered, i = [], 0
    for ks in keys:
        gathered.append(dict(zip(ks, flat[i:i + len(ks)])))
        i += len(ks)
    return tuple(gathered)


# What rank 0 reads of a sample another rank assembled: what formats its
# predictions (``predictions.format_predictions``) and sizes its group's
# slot bucket
_HOST_KEYS = (C.SAMPLE_NAME, C.SAMPLE_NUM_OBJS, C.SAMPLE_CAM_P,
              C.SAMPLE_LABEL_SCORES, C.SAMPLE_LABEL_BOXES_2D,
              C.SAMPLE_LABEL_BOXES_3D, C.SAMPLE_LABEL_CLASS_INDICES)


def _gather_host_samples(rows):
    """A group's host samples from every rank's ``rows``, in rank order;
    ``rows`` themselves without a process group. The samples that cross
    ranks carry ``_HOST_KEYS`` and, of the image, only its shape (a
    zero-strided stand-in: the predictions read its shape alone)."""
    if dp_lib.world_size() == 1:
        return list(rows)
    sent = [dict({k: s[k] for k in _HOST_KEYS if k in s},
                 image_shape=s[C.SAMPLE_IMAGE_INPUT].shape) for s in rows]
    samples = []
    for fields in dp_lib.all_gather_objects(sent):
        shape = fields.pop('image_shape')
        fields[C.SAMPLE_IMAGE_INPUT] = np.broadcast_to(
            np.zeros((), np.uint8), shape)
        samples.append(fields)
    return samples


def make_eval_step(net, cfg, loss_config, eval_mode, device=None):
    """Builds the eval step over a stacked sample batch.

    Args:
        net: a MonoPSRNet; moved to ``device`` and put in eval mode.
        cfg: its NetConfig.
        loss_config: dict of {name: [loss_type, weight, ...]}.
        eval_mode: 'val' (forward + GT + losses + metrics) or 'test'
            (forward only).
        device: CUDA unless 'cpu' is asked for; raises when CUDA is asked
            for and absent.

    Returns:
        eval_step(batch, max_slots=None) -> (packed outputs, losses,
        metrics), each a dict of tensors with a leading batch axis
        (losses and metrics are empty in test mode). ``max_slots``
        truncates per-box outputs and metrics to that many slots.
    """
    if eval_mode not in ('val', 'test'):
        raise ValueError('Invalid eval_mode: ' + str(eval_mode))
    device = device_lib.resolve_device(device)
    net = net.to(device).eval()
    compute_losses = eval_mode == 'val'

    def eval_step(batch, max_slots=None):
        with torch.inference_mode():
            batch = batch_to_device(batch, device)
            outputs = net(**monopsr.net_inputs_from_batch(batch))
            if not compute_losses:
                return (monopsr.pack_outputs_for_host(
                    outputs, cfg.num_boxes, max_slots), {}, {})
            gt = monopsr.build_gt_dict(cfg, batch, outputs)
            outputs, gt = monopsr.add_global_outputs(cfg, batch, outputs, gt)
            losses, _ = monopsr.compute_losses(cfg, loss_config, outputs, gt)
            metrics = monopsr.slice_box_slots(
                monopsr.compute_metrics(cfg, outputs, gt),
                cfg.num_boxes, max_slots)
            return (monopsr.pack_outputs_for_host(
                outputs, cfg.num_boxes, max_slots), losses, metrics)

    return eval_step


class Evaluator:
    """Evaluates the checkpoints of one experiment on one dataset split.

    Args:
        config: parsed experiment config (``config.parse_yaml_config``).
        dataset: KittiDataset of the split ('val' mode with labels, or
            'test' mode).
        eval_mode: 'val' (losses, metrics, KITTI files, native AP) or
            'test' (predictions and KITTI files only).
        skip_evaluated_checkpoints: the polling loop skips the steps in
            the ledger.
        eval_wait_interval: seconds between the polling loop's polls.
        do_kitti_native_eval: run the native AP evaluator (val mode).
        use_ema_weights: evaluate the EMA weights where the checkpoint
            has them.
        device: CUDA unless 'cpu' is asked for; raises when CUDA is asked
            for and absent.

    Attributes:
        stage_times: ``utils.profiling.StageTimes`` of the last
            checkpoint's pass (``run_checkpoint_once``), its spans and
            counters named 'eval.*'. Its ``per_item_ms``, per sample:
            'assembly' (KITTI reads, merge, ``prepare_sample``),
            'dispatch' (stacking a group, its upload, the step's launch
            and the start of its copies to the host), 'format' and
            'write' (the predictions); per group: 'pull' (the pipeline's
            worker waiting for a group's copies), and the other spans
            below.
        kernel_launches: {'emd_cost_fused': K1 launches, 'emd_loss': K2
            launches, 'groups': dispatch groups} of the last checkpoint's
            pass on this rank, a launch captured in the eval step's graph
            counted once per replay (``step_graph.kernel_launches``).

    Raises ValueError when ``eval_data_parallel`` (or ``data_parallel``),
    clamped to the visible cards, is above 1 and this process is not one
    of the ranks ``parallel.data_parallel.launch`` starts. Inside a
    process group the group's size is the number of ranks.
    """

    _tb = None     # TB event writer, opened at its first scalars

    def __init__(self, config, dataset, eval_mode,
                 skip_evaluated_checkpoints=True,
                 eval_wait_interval=30,
                 do_kitti_native_eval=True,
                 use_ema_weights=True,
                 device=None):
        if eval_mode not in ('val', 'test'):
            raise ValueError('Invalid eval_mode: ' + str(eval_mode))
        self.device = device_lib.resolve_device(device)

        self.config = config
        self.dataset = dataset
        self.eval_mode = eval_mode
        self.skip_evaluated_checkpoints = skip_evaluated_checkpoints
        self.eval_wait_interval = eval_wait_interval
        self.do_kitti_native_eval = do_kitti_native_eval
        self.use_ema_weights = use_ema_weights

        train_config = config.train_config
        dp_lib.require_ranks(requested_eval_ranks(train_config),
                             self.device, 'eval_data_parallel')
        # Samples per eval dispatch (tails padded), rounded up to fill
        # every rank
        ranks = dp_lib.world_size()
        eval_batch = max(1, int(train_config.get('eval_batch', 4) or 4))
        self.eval_batch = -(-eval_batch // ranks) * ranks
        # Dispatch groups the pipeline's worker takes at a time
        pull_samples = int(train_config.get('eval_pull_batch', 8) or 8)
        self.pull_batch = max(1, pull_samples // self.eval_batch)
        # Host assembly worker threads (KITTI IO / merge / resize)
        self.producer_threads = max(1, int(
            train_config.get('eval_producer_threads', 2) or 2))
        # Per-box-slot truncation buckets for device->host copies; the
        # full num_boxes bucket is always present as the fallback.
        buckets = train_config.get('eval_slot_buckets', (8, 16))

        model_config = config.model_config
        self.net, self.cfg = monopsr.create_net_from_config(
            model_config, config.dataset_config, device=self.device)
        self._slot_buckets = sorted(
            {int(b) for b in (buckets or ())
             if 0 < int(b) < self.cfg.num_boxes} | {self.cfg.num_boxes})
        self.loss_config = model_config.loss_config.to_dict()
        self.post_process_cen_x = bool(
            model_config.get('post_process_cen_x', True))
        self.metrics_to_show = [
            tuple(entry) for entry in
            (model_config.get('metrics_to_show') or [])]
        self.score_threshold = float(
            train_config.get('kitti_score_threshold', 0.1))

        _, _, self._use_ema, _ = opt_lib.build_optimizer(
            train_config.to_dict())
        self._eval_step = make_eval_step(self.net, self.cfg,
                                         self.loss_config, eval_mode,
                                         device=self.device)
        self._graphed = None
        if self.device.type == 'cuda':
            self._eval_step = self._graphed = step_graph.GraphedEvalStep(
                self._eval_step, self.device, self.net, self.cfg.num_boxes)
        self._graph_reported = set()     # what _report_graph printed
        self._template_state = None
        self.stage_times = profiling.StageTimes('eval.')
        self.kernel_launches = None

        # Ledger of evaluated checkpoints
        os.makedirs(config.exp_output_dir, exist_ok=True)
        self.ledger_path = os.path.join(
            config.exp_output_dir,
            'evaluated_{}.txt'.format(dataset.data_split))

        # Native AP runs, one at a time, overlapping the next checkpoint
        self._native_pool = None
        self._native_jobs = []

        self._tensorboard = bool(train_config.get('tensorboard', True))

    def _tb_writer(self):
        """Lazy TB event writer under logdir/<split> (one per run)."""
        if self._tb is None:
            self._tb = tb_events.TBWriter(
                os.path.join(self.config.logdir, self.dataset.data_split),
                enabled=self._tensorboard)
        return self._tb

    def _close_tb(self):
        """Flushes and closes the TB writer (a later run opens another),
        before a rank's process exits under it."""
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def _dispatch_groups(self):
        """The dataset's indices in dispatch groups of ``eval_batch``
        samples with an object each, in order (the last group may be
        short). Under data-parallel ranks each rank reads the labels of
        every world-th sample and the ranks exchange what they found."""
        dataset = self.dataset
        mine = [idx for idx in range(dp_lib.rank(), dataset.num_samples,
                                     dp_lib.world_size())
                if dataset.has_objects(dataset.sample_list[idx].name)]
        valid = sorted(dp_lib.all_gather_objects(mine))
        return [valid[i:i + self.eval_batch]
                for i in range(0, len(valid), self.eval_batch)]

    def _slot_bucket(self, samples):
        return pipeline.slot_bucket(samples, self._slot_buckets,
                                    self.cfg.num_boxes)

    # -- checkpoint management ----------------------------------------------

    def _get_template_state(self):
        """The state checkpoints are restored into, built once: copies of
        the net's parameters, buffers and (with an EMA in the optimizer
        config) EMA, on the device, with no optimizer state."""
        if self._template_state is None:
            with torch.no_grad():
                params = {name: p.detach().clone()
                          for name, p in self.net.named_parameters()}
                ema = ({name: p.clone() for name, p in params.items()}
                       if self._use_ema else None)
                batch_stats = {name: b.clone()
                               for name, b in self.net.named_buffers()}
            self._template_state = TrainState(
                step=0, params=params, batch_stats=batch_stats,
                opt_state=None, ema_params=ema)
        return self._template_state

    def restore_checkpoint(self, manager, step):
        """Reads checkpoint ``step``'s weights into the template state (the
        span 'eval.restore')."""
        with self.stage_times.span('eval.restore', step) as span:
            state = trainer_lib.restore_checkpoint(
                manager, step, self._get_template_state())
            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
        if dp_lib.is_main():
            print('restored checkpoint {} in {:.3f} s'.format(
                step, span.seconds))
        return state

    def get_evaluated_ckpts(self):
        if not os.path.exists(self.ledger_path):
            return set()
        with open(self.ledger_path) as f:
            return {int(line) for line in f.read().split() if line}

    def _mark_evaluated(self, step):
        with open(self.ledger_path, 'a') as f:
            f.write('{}\n'.format(int(step)))

    # -- single-checkpoint evaluation -------------------------------------

    def _output_dirs(self, global_step):
        base = self.config.pred_dir
        split = self.dataset.data_split
        dirs = {
            C.OUT_DIR_BOX_3D: os.path.join(
                base, 'box_3d', split, str(global_step)),
            C.OUT_DIR_BOX_2D: os.path.join(
                base, 'box_2d', split, str(global_step)),
            C.OUT_DIR_XYZ_MAP_LOCAL: os.path.join(
                base, 'xyz_map_local', split, str(global_step)),
        }
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)
        return dirs

    def run_checkpoint_once(self, state, global_step):
        """Evaluates one checkpoint over a full dataset epoch.

        Returns the record appended to ``logs/eval_<split>.jsonl`` (step,
        num_samples; in val mode the loss means, the metric means and
        mean magnitudes), plus, in val mode, ``metrics_per_box``: each
        metric's values over the valid box slots, in sample order. Under
        data-parallel ranks, rank 0 returns it and the others None.

        Its spans and counters go to a new ``stage_times``: the root
        'eval.pass'; 'eval.groups' (``_dispatch_groups``); on the
        producers 'eval.assembly' (item: the dataset index), within it
        'eval.assembly.read' and 'eval.assembly.prepare'; per group (item:
        its number) 'eval.feed_wait' (for the producers), 'eval.dispatch'
        (within it 'eval.stack', the step's and the pipeline's spans) and
        'eval.pull_queue_wait'; 'eval.drain' (the producers and the
        pipeline closed); on the pipeline's worker 'eval.pull',
        'eval.format' and 'eval.write' (item: the dataset index); then
        'eval.metrics_csv', 'eval.log' (the jsonl record and TensorBoard)
        and 'eval.kitti_files'. Counters: 'eval.frames', 'eval.groups',
        'eval.pad_rows', 'eval.bytes_up' and the pipeline's
        'eval.bytes_down'.
        """
        stages = self.stage_times = profiling.StageTimes('eval.')
        if self._graphed is not None:
            self._graphed.times = stages
        with stages.span('eval.pass', global_step):
            return self._evaluate(state, global_step, stages)

    def _evaluate(self, state, global_step, stages):
        """``run_checkpoint_once``'s pass, its spans into ``stages``."""
        dataset = self.dataset
        is_main, world = dp_lib.is_main(), dp_lib.world_size()
        self.net.load_state_dict(
            state.eval_variables(use_ema=self.use_ema_weights))
        output_dirs = self._output_dirs(global_step) if is_main else None

        loss_sums, loss_counts = {}, {}
        metric_values = {}
        feed_times, infer_times = [], []

        num_evaluated = 0
        t_epoch = time.perf_counter()
        dataset._index_in_epoch = 0
        dataset.epochs_completed = 0
        launches_before = step_graph.kernel_launches(self._eval_step)

        def process(idx, sample, outputs, losses, metrics):
            """Aggregates, formats, and saves one sample's results."""
            nonlocal num_evaluated
            num_objs = int(sample[C.SAMPLE_NUM_OBJS])

            # Aggregate losses (NaN-filtered)
            for name, value in losses.items():
                v = float(value)
                if np.isfinite(v):
                    loss_sums[name] = loss_sums.get(name, 0.0) + v
                    loss_counts[name] = loss_counts.get(name, 0) + 1

            # Aggregate per-box metrics over valid slots
            for name, value in metrics.items():
                arr = np.asarray(value)[0:num_objs]
                metric_values.setdefault(name, []).append(arr.ravel())

            with stages.span('eval.format', idx):
                pred_dict = predictions.format_predictions(
                    self.cfg, outputs, sample, dataset, self.eval_mode,
                    post_process_cen_x=self.post_process_cen_x)
            with stages.span('eval.write', idx):
                predictions.save_predictions(
                    pred_dict, sample[C.SAMPLE_NAME], output_dirs)
            num_evaluated += 1
            if num_evaluated == 1:
                print('first sample saved at step {}'.format(global_step),
                      flush=True)

        def process_group(group, batched_out):
            """Splits one group's host outputs (leading axis: the group's
            samples, then its padding) into its real samples; ``group``
            is (their dataset indices, their host samples)."""
            outputs, losses, metrics = batched_out
            for i, (idx, sample) in enumerate(zip(*group)):
                process(idx, sample, {k: v[i] for k, v in outputs.items()},
                        {k: v[i] for k, v in losses.items()},
                        {k: v[i] for k, v in metrics.items()})

        eval_batch = self.eval_batch

        def pulled(dt, n):
            """``n`` groups whose spans from launch to host took ``dt`` s
            each on average."""
            infer_times.extend([dt / eval_batch] * (n * eval_batch))

        pipe = pipeline.BatchedPullPipeline(
            process_group, pull_batch=self.pull_batch,
            on_pull_time=pulled, times=stages) if is_main else None

        num_groups = 0
        share = eval_batch // world

        def dispatch_group(number, group, host_rows, device_rows):
            """Group ``number``'s step on this rank's rows (padded to its
            share by repeating its last row); rank 0 hands the gathered
            rows to the pipeline with the group's dataset indices
            (``group``) and host samples."""
            nonlocal num_groups
            with stages.span('eval.dispatch', number, len(host_rows)):
                with stages.span('eval.stack', number):
                    padded = device_rows + [device_rows[-1]] * (
                        share - len(device_rows))
                    batch = stack_samples(padded)
                group_samples = _gather_host_samples(host_rows)
                # Pad rows ride along (no extra dispatches); process_group
                # only iterates the real samples. Per-box outputs are
                # truncated on the device to the group's slot bucket.
                bucket = self._slot_bucket(group_samples)
                start = pipeline.mark(self.device) if is_main else None
                out = self._eval_step(batch, bucket)
                if world > 1:
                    out = _gather_outputs(out)
                if is_main:
                    pipe.start_pull((group, group_samples), out, start,
                                    number)
            if is_main:
                pipe.hand_over()
                stages.count('eval.frames', len(group_samples))
            stages.count('eval.groups')
            stages.count('eval.pad_rows', share - len(host_rows))
            stages.count('eval.bytes_up', sum(
                v.nbytes for v in batch.values()
                if isinstance(v, np.ndarray)))
            num_groups += 1

        # Ordered producer pool: sample assembly (KITTI IO, MSCNN merge,
        # resize, encode) overlaps the device's steps and the pipeline
        # worker's formatting.
        def assemble(idx):
            with stages.span('eval.assembly', idx) as span:
                with stages.span('eval.assembly.read', idx):
                    sample = dataset.get_sample_dict([idx])[0]
                if sample is None:
                    raise RuntimeError(
                        'sample {} keeps an object by its labels and yields '
                        'none'.format(dataset.sample_list[idx].name))
                with stages.span('eval.assembly.prepare', idx):
                    device_sample = trainer_lib.prepare_sample(
                        sample, self.cfg.image_input_shape)
                    if self.eval_mode == 'test':
                        # Inference needs no GT arrays on the device
                        device_sample = monopsr.strip_to_net_inputs(
                            device_sample)
            feed_times.append(span.seconds)
            return sample, device_sample

        # This rank's rows of each group; a rank with no row in a tail
        # group assembles the group's last sample for its pad rows
        with stages.span('eval.groups', global_step):
            groups = self._dispatch_groups()
        lo = dp_lib.rank() * share
        own = [group[lo:lo + share] for group in groups]
        todo = [idx for group, rows in zip(groups, own)
                for idx in (rows or group[-1:])]
        items = prefetch.ordered_prefetch(assemble, todo,
                                          num_threads=self.producer_threads)
        try:
            for number, (group, rows) in enumerate(zip(groups, own)):
                with stages.span('eval.feed_wait', number):
                    assembled = [next(items) for _ in (rows or group[-1:])]
                dispatch_group(
                    number, group,
                    [sample for sample, _ in assembled[:len(rows)]],
                    [device for _, device in assembled])
        finally:
            with stages.span('eval.drain', global_step):
                items.close()
                if pipe is not None:
                    pipe.close()
        if not num_groups:
            raise RuntimeError('Dataset produced no valid samples')

        if is_main:
            print('Evaluated {} samples at step {} in {:.3f} s'.format(
                num_evaluated, global_step, time.perf_counter() - t_epoch))
        ranks = ''
        if world > 1:
            ranks = ' (rank {} of {})'.format(dp_lib.rank(), world)
        launches = step_graph.kernel_launches(self._eval_step)
        self.kernel_launches = dict(
            {name: n - launches_before[name] for name, n in launches.items()},
            groups=num_groups)
        print('kernel launches: emd_cost_fused {}, emd_loss {} in {} groups'
              '{}'.format(self.kernel_launches['emd_cost_fused'],
                          self.kernel_launches['emd_loss'], num_groups,
                          ranks))
        self._report_graph(ranks)
        if not is_main:
            return None
        kitti_writers.print_inference_time_statistics(
            feed_times, infer_times)

        results = {'step': int(global_step),
                   'num_samples': num_evaluated}
        metrics_flat = {}

        if self.eval_mode == 'val':
            avg_losses = {name: loss_sums[name] / max(loss_counts[name], 1)
                          for name in loss_sums}
            results['losses'] = avg_losses

            metrics_flat = {name: np.concatenate(vals)
                            for name, vals in metric_values.items()}
            metrics_dir = os.path.join(self.config.exp_output_dir,
                                       'metrics')
            with stages.span('eval.metrics_csv', global_step):
                kitti_writers.save_metrics(
                    metrics_dir, global_step, dataset.data_split,
                    metrics_flat)
            results['metrics'] = {
                name: float(np.mean(v[np.isfinite(v)]))
                if np.isfinite(v).any() else float('nan')
                for name, v in metrics_flat.items()}
            # Signed means cancel across samples (a +2 m and a -2 m
            # cen_z error average to 0); the mean magnitude too
            results['metrics_abs'] = {
                name: float(np.mean(np.abs(v[np.isfinite(v)])))
                if np.isfinite(v).any() else float('nan')
                for name, v in metrics_flat.items()}

            # Print the configured subset
            for name, stat in self.metrics_to_show:
                values = metrics_flat.get(name)
                if values is None:
                    continue
                values = values[np.isfinite(values)]
                if not len(values):
                    continue
                if stat == 'avg':
                    value = float(np.mean(values))
                elif stat == 'std':
                    value = float(np.std(values))
                elif stat == 'avg_abs':
                    value = float(np.mean(np.abs(values)))
                elif stat == 'std_abs':
                    value = float(np.std(np.abs(values)))
                else:
                    continue
                print('  {} ({}): {:.4f}'.format(name, stat, value))

        with stages.span('eval.log', global_step):
            self._log_results(results, metric_values, global_step)

        # Convert to KITTI format + native AP eval
        with stages.span('eval.kitti_files', global_step):
            kitti_writers.save_predictions_box_3d_in_kitti_format(
                self.score_threshold, dataset, self.config.pred_dir,
                output_dirs[C.OUT_DIR_BOX_3D], output_dirs[C.OUT_DIR_BOX_2D],
                global_step)

        if self.do_kitti_native_eval and self.eval_mode == 'val':
            self.run_kitti_native_eval(global_step)

        if self.eval_mode == 'val':
            results['metrics_per_box'] = metrics_flat
        return results

    def _log_results(self, results, metric_values, global_step):
        """Appends ``results`` to ``logs/eval_<split>.jsonl`` and mirrors
        the loss means and the ``metrics_to_show`` subset of
        ``metric_values`` to TensorBoard."""
        dataset = self.dataset
        # Write eval scalar log
        log_path = os.path.join(self.config.logdir,
                                'eval_{}.jsonl'.format(dataset.data_split))
        os.makedirs(self.config.logdir, exist_ok=True)
        with open(log_path, 'a') as f:
            f.write(json.dumps(results, default=float) + '\n')

        # Mirror eval scalars to TensorBoard: the loss means and the
        # metrics_to_show subset, under logdir/<split>
        tb_scalars = {}
        for name, value in (results.get('losses') or {}).items():
            tb_scalars['losses/' + name] = value
        for name, stat in self.metrics_to_show:
            values = metric_values.get(name)
            if not values:
                continue
            flat = np.concatenate(values)
            flat = flat[np.isfinite(flat)]
            if not len(flat):
                continue
            fn = {'avg': np.mean, 'std': np.std,
                  'avg_abs': lambda v: np.mean(np.abs(v)),
                  'std_abs': lambda v: np.std(np.abs(v))}.get(stat)
            if fn is not None:
                tb_scalars['metrics/{}_{}'.format(name, stat)] = (
                    float(fn(flat)))
        if tb_scalars:
            self._tb_writer().scalars(global_step, tb_scalars)

    def _report_graph(self, ranks):
        """Prints, once each, the graphed eval step's warm-up seconds and
        its capture seconds, after the pass that ran them (a pass of one
        group runs the warm-up call alone)."""
        graphed = self._graphed
        if graphed is None:
            return
        if 'warm-up' not in self._graph_reported and (
                graphed.warm_up_seconds is not None):
            self._graph_reported.add('warm-up')
            print('eval step graph: warm-up {:.3f} s{}'.format(
                graphed.warm_up_seconds, ranks))
        if 'capture' not in self._graph_reported and (
                graphed.capture_seconds is not None):
            self._graph_reported.add('capture')
            print('eval step graph: capture {:.3f} s, captured launches '
                  'emd_cost_fused {}, emd_loss {}{}'.format(
                      graphed.capture_seconds,
                      graphed.captured_launches['emd_cost_fused'],
                      graphed.captured_launches['emd_loss'], ranks))

    # -- native eval -------------------------------------------------------

    def run_kitti_native_eval(self, global_step):
        """Starts the native AP evaluator on step ``global_step``'s KITTI
        files at both IoU regimes, the binary built at first use
        (``eval/native_eval.py``), in the background: one run at a time,
        in step order, overlapping the next checkpoint's evaluation. The
        polling loops wait for every run before they return
        (``wait_for_native_eval``)."""
        binary = native_eval.build()
        pred_dir = os.path.abspath(self.config.pred_dir)
        result_dir = os.path.join(
            pred_dir, 'kitti_predictions_3d', self.dataset.data_split,
            str(round(self.score_threshold, 3)), str(int(global_step)))
        gt_dir = os.path.abspath(os.path.join(self.dataset.data_split_dir,
                                              'label_2'))
        if self._native_pool is None:
            self._native_pool = ThreadPoolExecutor(max_workers=1)
        self._native_jobs.append(self._native_pool.submit(
            native_eval.run, binary, gt_dir, result_dir, global_step,
            native_eval.results_paths(pred_dir, self.config.config_name,
                                      self.score_threshold)))

    def wait_for_native_eval(self):
        """Waits for the background native AP runs and stops their
        thread; re-raises the first failure."""
        jobs, self._native_jobs = self._native_jobs, []
        if self._native_pool is not None:
            self._native_pool.shutdown(wait=True)
            self._native_pool = None
        for job in jobs:
            job.result()

    # -- polling loops ------------------------------------------------------

    def repeated_checkpoint_run(self, max_wait_iterations=100):
        """Polls the checkpoint dir, evaluating new checkpoints (oldest
        first) as they appear and appending each to the ledger; stops
        after ``max_wait_iterations`` polls in a row found nothing new.
        Returns the last step evaluated in the final round, or None.
        Under data-parallel ranks, rank 0 polls and every rank evaluates
        the steps it found."""
        manager = trainer_lib.CheckpointManager(self.config.checkpoint_dir)
        waits = 0
        last_seen = None
        try:
            while waits < max_wait_iterations:
                todo = None
                if dp_lib.is_main():
                    steps = sorted(manager.all_steps())
                    evaluated = (self.get_evaluated_ckpts()
                                 if self.skip_evaluated_checkpoints
                                 else set())
                    todo = [s for s in steps if s not in evaluated]
                todo = dp_lib.broadcast_object(todo)

                if todo:
                    waits = 0
                    for step in todo:
                        state = self.restore_checkpoint(manager, step)
                        self.run_checkpoint_once(state, step)
                        if dp_lib.is_main():
                            self._mark_evaluated(step)
                        last_seen = step
                else:
                    waits += 1
                    time.sleep(self.eval_wait_interval)
        finally:
            self.wait_for_native_eval()
            self._close_tb()
        return last_seen

    def run_latest_checkpoints(self, ckpt_indices=None):
        """Evaluates specific checkpoints ('all', None or a list of
        steps), oldest first, without touching the ledger (as JAX).
        Returns their ``run_checkpoint_once`` records. Under data-parallel
        ranks every rank evaluates the steps rank 0 found."""
        manager = trainer_lib.CheckpointManager(self.config.checkpoint_dir)
        steps = dp_lib.broadcast_object(sorted(manager.all_steps()))
        if not steps:
            raise RuntimeError('No checkpoints found in ' +
                               self.config.checkpoint_dir)
        if ckpt_indices is not None and ckpt_indices != 'all':
            wanted = {int(i) for i in np.atleast_1d(ckpt_indices)}
            steps = [s for s in steps if s in wanted]

        results = []
        try:
            for step in steps:
                state = self.restore_checkpoint(manager, step)
                results.append(self.run_checkpoint_once(state, step))
        finally:
            self.wait_for_native_eval()
            self._close_tb()
        return results
