"""Training: host collation, train step, checkpoints, resume, the loop.

Counterpart of ``monopsr_tpu/train/trainer.py``: global-norm clip 1.0,
Adam with staircase exponential decay, EMA weights, a checkpoint every
``checkpoint_interval`` and at the last step, automatic resume from the
latest checkpoint unless ``overwrite_checkpoints``, loss scalars every
``summary_interval`` to a JSONL log.

The JAX step vmaps GT assembly and the losses over the images; here they
take the image axis directly (``make_train_step``; ``create_train_state``
for ``TrainState.create``). Where the JAX loop leans on a TPU mechanism:

- checkpoints are ``torch.save`` files in place of Orbax, one directory
  per step under ``checkpoint_dir`` as Orbax lays them out;
- ``steps_per_dispatch`` K > 1 (JAX: K steps in one device program, a
  ``lax.scan``) keeps the JAX loop's rules: a full dispatch takes K
  batches and K steps, logs and checkpoints where a step crossed an
  interval, logs its last step's losses and draws the summary images
  from its last batch; a tail shorter than K runs single steps; K is 1
  when ``profile_step`` is set. On one CUDA device the steps are replays
  of a CUDA graph of the train step (``train.step_graph``); on the CPU,
  and under data-parallel ranks (whose all-reduces a graph would have
  to capture), a dispatch runs its K steps eagerly, in order, and the
  ranks say so;
- ``data_parallel`` (clamped to the visible cards, as JAX clamps its
  mesh) counts processes, not mesh devices: the loop runs in each rank
  of a process group that ``parallel.data_parallel.launch`` starts (the
  training CLI starts it when the clamped count is above 1). The global
  batch is ``world_size * batch_size`` images, each rank's loader reads
  its rows, the gradients are averaged over ranks before the clip, the
  decoder's batch norms use global statistics, and only rank 0 writes
  logs and checkpoints.

With ``summary_images``, each summary step writes grids of the
backbone's two outputs for the batch's first sample under
``<logdir>/images/`` (``utils.summary_images``); ``profile_step: N``
traces step N with ``utils.profiling.trace``.
"""

import json
import os
import time

import numpy as np
import torch

from monopsr_torch import constants as C
from monopsr_torch.eval import evaluator
from monopsr_torch.models import monopsr
from monopsr_torch.ops import emd as emd_ops
from monopsr_torch.parallel import data_parallel as dp_lib
from monopsr_torch.train import optimizer as opt_lib
from monopsr_torch.train import pretrained, step_graph
from monopsr_torch.train.train_state import TrainState
from monopsr_torch.utils import device as device_lib
from monopsr_torch.utils import image_io, profiling, summary_images
from monopsr_torch.utils import tb_events

# Batch keys shipped to the device for training
DEVICE_KEYS = (
    'image',
    C.SAMPLE_LABEL_BOXES_2D, C.SAMPLE_LABEL_BOXES_2D_NORM,
    C.SAMPLE_LABEL_BOXES_3D,
    C.SAMPLE_VIEWING_ANGLES_2D, C.SAMPLE_VIEWING_ANGLES_3D,
    C.SAMPLE_LABEL_CLASS_INDICES, C.SAMPLE_MEAN_LWH,
    C.SAMPLE_PROP_CEN_Z_OFFSET, C.SAMPLE_CEN_Y_OFFSETS,
    C.SAMPLE_CAM_P, C.SAMPLE_DEPTH_MAP,
    C.SAMPLE_INSTANCE_IMAGE, C.SAMPLE_INSTANCE_INDICES,
    C.SAMPLE_ALPHAS, C.SAMPLE_ALPHA_BINS, C.SAMPLE_ALPHA_REGS,
    C.SAMPLE_ALPHA_VALID_BINS,
)

CHECKPOINT_FILE = 'train_state.pt'


def prepare_sample(sample_dict, image_input_shape):
    """Host-side collation: resize the image, keep device keys only.

    The resize runs here on the host (resize and the mean subtraction
    commute for a linear resampler; the subtraction stays on the device).
    The big arrays ship in compact encodings, decoded by
    ``monopsr.decode_device_sample``: the uint8 image resized by
    OpenCV's fixed-point INTER_LINEAR (``image_io.resize_bilinear_uint8``),
    the depth map as the uint16 metres*256 its png stores, the instance
    image as uint8 indices (lossless, indices < 255).
    """
    out = {'image': image_io.resize_bilinear_uint8(
        sample_dict[C.SAMPLE_IMAGE_INPUT], image_input_shape)}
    for key in DEVICE_KEYS:
        if key == 'image':
            continue
        if key in sample_dict:   # test mode carries no GT keys
            out[key] = np.asarray(sample_dict[key])
    if C.SAMPLE_DEPTH_MAP in out:
        out[C.SAMPLE_DEPTH_MAP] = np.rint(
            out[C.SAMPLE_DEPTH_MAP] * 256.0).astype(np.uint16)
    if C.SAMPLE_INSTANCE_IMAGE in out:
        out[C.SAMPLE_INSTANCE_IMAGE] = (
            out[C.SAMPLE_INSTANCE_IMAGE].astype(np.uint8))
    return out


def create_train_state(net, tx, use_ema):
    """TrainState over ``net`` on its current device (make the train step
    first: it moves the net)."""
    return TrainState.create(net, tx, use_ema=use_ema)


def make_train_step(net, cfg, loss_config, tx, use_ema, ema_decay,
                    device=None):
    """Builds the train step over a stacked sample batch.

    Args:
        net: a MonoPSRNet; moved to ``device`` and put in train mode (the
            map decoder's batch norms use and update batch statistics).
        cfg: its NetConfig.
        loss_config: dict of {name: [loss_type, weight, ...]}.
        tx: optimizer from ``train.optimizer.build_optimizer``.
        use_ema, ema_decay: EMA of the parameters.
        device: CUDA unless 'cpu' is asked for; raises when CUDA is asked
            for and absent.

    Returns:
        train_step(state, batch) -> (state, losses): ``state`` is a
        TrainState over ``net`` (``create_train_state``), updated in
        place; ``losses`` maps each loss name to its mean over the images
        (detached scalars). The step minimizes the mean over images of
        the per-image total loss. GT offset targets stay coupled to the
        live predictions, as in the reference; GT crops carry no gradient.
        Under data-parallel ranks ``batch`` is this rank's rows; the
        gradients are averaged over the ranks before the optimizer clips
        them, so every rank applies the global batch's update, and
        ``losses`` stay this rank's means.

        ``train_step.times`` is the ``profiling.StageTimes`` the step
        counts ``train.emd_loss`` in: the launches of K2 that the
        ``'emd'`` loss makes (``ops/emd.emd_distance.launches`` over the
        step; one a step on a CUDA device, none on the CPU, whose plain
        twin launches nothing). An owner may replace ``times`` with its
        own: ``step_graph.GraphedTrainStep`` does, and counts at each
        replay what its capture counted.
    """
    device = device_lib.resolve_device(device)
    net = net.to(device).train()

    def train_step(state, batch):
        first = next(iter(state.params.values())).device
        if first.type != device.type or device.index not in (
                None, first.index):
            raise ValueError(
                'the train state lies on {}, the step runs on {}: create '
                'it after make_train_step has moved the net'.format(
                    first, device))
        batch = evaluator.batch_to_device(batch, device)
        outputs = net(**monopsr.net_inputs_from_batch(batch))
        gt = monopsr.build_gt_dict(cfg, batch, outputs)
        outputs, gt = monopsr.add_global_outputs(cfg, batch, outputs, gt)
        before = emd_ops.emd_distance.launches
        losses, totals = monopsr.compute_losses(cfg, loss_config, outputs, gt)
        launched = emd_ops.emd_distance.launches - before
        if launched:
            train_step.times.count('train.emd_loss', launched)
        totals.mean().backward()
        grads = {name: p.grad if p.grad is not None else torch.zeros_like(p)
                 for name, p in state.params.items()}
        dp_lib.mean_over_ranks(grads.values())
        state.apply_gradients(grads, tx,
                              ema_decay=ema_decay if use_ema else None)
        for p in state.params.values():
            p.grad = None
        return state, {k: v.detach().mean() for k, v in losses.items()}

    train_step.times = profiling.StageTimes()
    return train_step


class ScalarLogger:
    """JSONL scalar sink, mirrored to TensorBoard events when
    ``tensorboard`` is true and tensorboardX is installed."""

    def __init__(self, logdir, filename='train_log.jsonl',
                 tensorboard=True):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, filename)
        self.tb = tb_events.TBWriter(logdir, enabled=tensorboard)

    def log(self, step, scalars):
        record = {'step': int(step)}
        record.update({k: float(v) for k, v in scalars.items()})
        with open(self.path, 'a') as f:
            f.write(json.dumps(record) + '\n')
        self.tb.scalars(step, record)

    def close(self):
        self.tb.close()


# --------------------------------------------------------------------------
# Checkpoints
# --------------------------------------------------------------------------

class CheckpointManager:
    """Checkpoints under ``directory``, one sub-directory per step (as
    Orbax lays them out, so a poller lists them the same way), each
    holding ``CHECKPOINT_FILE``. Only the newest ``max_to_keep`` stay."""

    def __init__(self, directory, max_to_keep=10000):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step):
        return os.path.join(self.directory, str(int(step)), CHECKPOINT_FILE)

    def all_steps(self):
        """Steps with a complete checkpoint, ascending."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.exists(self.path(name)))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None


def save_checkpoint(manager, state, step):
    """Writes the TrainState (step, params, batch stats, optimizer state,
    EMA) with ``torch.save`` under a temporary name, renames it into
    place, then prunes to ``max_to_keep``. A reader never sees half a
    file: the file it lists is complete or absent."""
    path = manager.path(step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + '.tmp'
    torch.save({'step': int(step),
                'params': {k: v.detach() for k, v in state.params.items()},
                'batch_stats': state.batch_stats,
                'opt_state': state.opt_state,
                'ema_params': state.ema_params}, tmp)
    os.replace(tmp, path)
    steps = manager.all_steps()
    if manager.max_to_keep:
        for old in steps[:-manager.max_to_keep]:
            os.remove(manager.path(old))
            os.rmdir(os.path.dirname(manager.path(old)))


def _same_keys(what, got, want):
    if (got is None) != (want is None) or (
            got is not None and set(got) != set(want)):
        raise ValueError('checkpoint {} do not match the train state'.format(
            what))


def _copy_into(target, saved, what):
    """Copies a nested dict of tensors into ``target``'s tensors."""
    _same_keys(what, saved, target)
    for key, value in target.items():
        if isinstance(value, dict):
            _copy_into(value, saved[key], what)
        else:
            value.copy_(saved[key])


def restore_checkpoint(manager, step, state):
    """Restores checkpoint ``step`` into ``state`` in place and returns
    it: every tensor of the state (parameters, batch stats, EMA,
    optimizer state) is copied into, so a CUDA graph captured over the
    state reads the restored values. The file is memory-mapped, so only
    what is copied is read: a state whose ``opt_state`` is None (the
    evaluator's) restores the weights and leaves the optimizer's moments,
    half the file, unread."""
    saved = torch.load(manager.path(step), map_location='cpu',
                       weights_only=True, mmap=True)
    parts = ('params', 'batch_stats', 'ema_params')
    for part in parts:
        _same_keys(part, saved[part], getattr(state, part))
    if state.opt_state is not None:
        _same_keys('optimizer state', saved['opt_state'], state.opt_state)
    with torch.no_grad():
        for part in parts:
            target = getattr(state, part) or {}
            for key, value in target.items():
                value.copy_(saved[part][key])
        if state.opt_state is not None:
            _copy_into(state.opt_state, saved['opt_state'],
                       'optimizer state')
    state.step = int(saved['step'])
    return state


def state_tensors(state):
    """Every tensor of a TrainState: parameters, batch stats, EMA and
    optimizer state."""
    out = []

    def walk(tree):
        if isinstance(tree, dict):
            for value in tree.values():
                walk(value)
        elif torch.is_tensor(tree):
            out.append(tree)

    for part in (state.params, state.batch_stats, state.ema_params,
                 state.opt_state):
        walk(part)
    return out


def restore_latest(manager, state):
    """Restores the latest checkpoint into ``state`` in place
    (``restore_checkpoint``) and returns (state, step), or (state, 0) when
    there is none. Under data-parallel ranks every rank restores the step
    rank 0 found."""
    latest = dp_lib.broadcast_object(manager.latest_step())
    if latest is None:
        return state, 0
    return restore_checkpoint(manager, latest, state), latest


# --------------------------------------------------------------------------
# The loop
# --------------------------------------------------------------------------

def _log_device_memory(logger, step, device):
    """Device memory once at start (the reference logs GPU memory)."""
    if device.type == 'cuda':
        index = device.index if device.index is not None else \
            torch.cuda.current_device()
        stats = profiling.device_memory_stats()['cuda:{}'.format(index)]
        logger.log(step, {'bytes_in_use_cuda_{}'.format(index):
                          stats.get('allocated_bytes.all.current', 0)})


def _profiled_step(train_step, state, batch, logdir, step):
    """One train step under ``profiling.trace``; the trace goes to
    <logdir>/profile/train_step_<step>.json."""
    with profiling.trace(os.path.join(logdir, 'profile'),
                         name='train_step_{}'.format(step)):
        state, losses = train_step(state, batch)
    return state, losses


def _save_feature_grids(net, batch, logdir, step, device):
    """Grids of the backbone's two outputs (map features, box features)
    for the batch's first sample, the net in eval mode with its current
    parameters (JAX captures them with ``train=False``):
    <logdir>/images/<step>_features_for_{map,box_3d}.png."""
    sample = {k: v[:1] for k, v in batch.items()
              if isinstance(v, np.ndarray)}
    captured = []
    hook = net.backbone.register_forward_hook(
        lambda module, args, out: captured.append(out))
    net.eval()
    try:
        with torch.no_grad():
            net(**monopsr.net_inputs_from_batch(
                evaluator.batch_to_device(sample, device)))
    finally:
        hook.remove()
        net.train()
    maps_f, box_f = captured[0]
    summary_images.save_feature_maps(logdir, step, 'features_for_map',
                                     maps_f[0].float().cpu().numpy())
    summary_images.save_feature_maps(logdir, step, 'features_for_box_3d',
                                     box_f[0].float().cpu().numpy())


def steps_per_dispatch(train_config):
    """The JAX loop's K: ``max(1, int(steps_per_dispatch or 1))``, and 1
    when ``profile_step`` is set, so that the trace brackets one step."""
    if train_config.get('profile_step') is not None:
        return 1
    return max(1, int(train_config.get('steps_per_dispatch', 1) or 1))


def eager_steps(train_step):
    """A dispatch that takes its batches' steps one by one: (state,
    batches) -> (state, losses of the last step)."""
    def run(state, batches):
        for batch in batches:
            state, losses = train_step(state, batch)
        return state, losses
    return run


def train(config, dataset, max_steps=None, log_every=None, device=None):
    """Full training loop driven by a parsed YAML config.

    Args:
        config: parsed experiment config (config.parse_yaml_config).
        dataset: KittiDataset in 'train' mode.
        max_steps: optional override of train_config.max_iterations.
        log_every: optional override of summary_interval.
        device: CUDA unless 'cpu' is asked for; raises when CUDA is asked
            for and absent.

    Returns:
        final TrainState (this rank's, under data-parallel ranks).

    Raises ValueError when ``data_parallel``, clamped to the visible
    cards, is above 1 and this process is not one of the ranks that
    ``parallel.data_parallel.launch`` starts: run it in those ranks (the
    training CLI does). Inside a process group the group's size is the
    number of ranks.
    """
    device = device_lib.resolve_device(device)
    train_config = config.train_config
    model_config = config.model_config
    dataset_config = config.dataset_config

    dp_lib.require_ranks(train_config.get('data_parallel', 1), device,
                         'data_parallel')
    world, is_main = dp_lib.world_size(), dp_lib.is_main()
    summary_images_on = bool(config.get('summary_images', False))

    net, cfg = monopsr.create_net_from_config(model_config, dataset_config,
                                              device=device, seed=0)
    loss_config = model_config.loss_config.to_dict()
    tx, schedule, use_ema, ema_decay = opt_lib.build_optimizer(
        train_config.to_dict(), clip_gradient_norm=1.0)

    # The JAX loop initialises its net on the first valid sample; that
    # read sets the dataset's position (and skips the first-epoch
    # shuffle), so it is made here too, for the same order of samples.
    _skip_first_valid_sample(dataset)

    train_step = make_train_step(net, cfg, loss_config, tx, use_ema,
                                 ema_decay, device=device)
    state = create_train_state(net, tx, use_ema)
    pretrained.maybe_load_pretrained(state, model_config)

    manager = CheckpointManager(
        config.checkpoint_dir,
        max_to_keep=train_config.max_checkpoints_to_keep)
    if not train_config.get('overwrite_checkpoints', False):
        t0 = time.perf_counter()
        state, start_step = restore_latest(manager, state)
        if start_step and is_main:
            print('restored checkpoint {} in {:.3f} s'.format(
                start_step, time.perf_counter() - t0))
    else:
        start_step = 0
    # Every rank starts from rank 0's state (JAX replicates it on the mesh)
    dp_lib.replicate(state_tensors(state))

    logger = ScalarLogger(
        config.logdir,
        tensorboard=bool(train_config.get('tensorboard', True))) \
        if is_main else None
    max_iterations = max_steps or train_config.max_iterations
    summary_interval = log_every or train_config.summary_interval
    checkpoint_interval = train_config.checkpoint_interval
    batch_size = max(1, int(train_config.get('batch_size', 1) or 1))
    profile_step = train_config.get('profile_step')
    k_max = steps_per_dispatch(train_config)
    if k_max > 1 and device.type == 'cuda' and world == 1:
        dispatch = step_graph.GraphedTrainStep(train_step, device)
    else:
        dispatch = eager_steps(train_step)
        if k_max > 1 and world > 1 and is_main:
            print('steps_per_dispatch {}: under {} data-parallel ranks the '
                  'steps of a dispatch run eagerly (a CUDA graph of the '
                  'step would capture its all-reduces)'.format(k_max, world))

    from monopsr_torch.train.input_pipeline import PrefetchingLoader
    loader = PrefetchingLoader(
        dataset, batch_size, cfg.image_input_shape,
        queue_depth=int(train_config.get('prefetch_depth', 4) or 4),
        num_threads=int(train_config.get('prefetch_threads', 2) or 2),
        rank=dp_lib.rank(), world_size=world)
    try:
        if is_main:
            _log_device_memory(logger, start_step, device)
        last_time = time.time()
        step = start_step
        last_log_step = start_step
        while step < max_iterations:
            k = min(k_max, max_iterations - step)
            if k_max > 1 and k == k_max:
                batches = [loader.get_batch() for _ in range(k)]
                state, losses = dispatch(state, batches)
                batch = batches[-1]       # the summary images' batch
                prev, step = step, step + k
                crossed = step // summary_interval > prev // summary_interval
                crossed_ckpt = (step // checkpoint_interval >
                                prev // checkpoint_interval)
            else:
                batch = loader.get_batch()
                if (profile_step is not None and
                        step + 1 == int(profile_step) and is_main):
                    state, losses = _profiled_step(train_step, state, batch,
                                                   config.logdir, step + 1)
                else:
                    state, losses = dispatch(state, [batch])
                step += 1
                crossed = step % summary_interval == 0
                crossed_ckpt = step % checkpoint_interval == 0

            if crossed:
                # the global batch's means (each rank's are over its rows)
                dp_lib.mean_over_ranks(losses.values())
            if crossed and is_main:
                scalars = {k: float(v) for k, v in losses.items()}
                scalars['learning_rate'] = float(schedule(step))
                scalars['steps_per_sec'] = (
                    (step - last_log_step) / (time.time() - last_time))
                last_time = time.time()
                last_log_step = step
                logger.log(step, scalars)
                print('step {:6d}  total {:.4f}  {:.2f} steps/s'.format(
                    step, scalars['total_loss'], scalars['steps_per_sec']))
                if summary_images_on:
                    _save_feature_grids(net, batch, config.logdir, step,
                                        device)

            if is_main and (crossed_ckpt or step == max_iterations):
                if device.type == 'cuda':
                    torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                save_checkpoint(manager, state, step)
                print('checkpoint {}: {} bytes in {:.3f} s'.format(
                    step, os.path.getsize(manager.path(step)),
                    time.perf_counter() - t0))
    finally:
        loader.stop()
        if logger is not None:
            logger.close()
    return state


def _skip_first_valid_sample(dataset):
    """Reads up to the first valid sample, as the JAX loop does for its
    init (the net here is built from a seed, so the sample is dropped)."""
    for _ in range(dataset.num_samples + 1):
        batch = dataset.next_batch(1, shuffle=False)
        if batch and batch[0] is not None:
            return
    raise RuntimeError('Dataset produced no valid samples')
