"""The graphed eval step (monopsr_torch/eval/step_graph.py) on the CPU:
what lets one capture serve every slot bucket, the evaluator's choice of
step, and the host-side guards of a capture.

A CUDA graph runs only on a card (tests/test_torch_kernels_cuda.py and
phase 20 of chip_smoke.py replay it against the eager step). Here, on a
tiny configuration (configs/monopsr_model_000.yaml cut to resnet_tiny,
float32, 4 box slots) and the KITTI fixture's samples as the evaluator
assembles them:

- the full-slot eager step cut to a bucket (``step_graph.bucket_views``,
  what a replay returns) equals the eager step at that bucket, bit for
  bit, for every bucket in val and in test mode;
- every val and every test sample has the same keys, shapes and dtypes
  after ``trainer.prepare_sample``, so one set of static input buffers
  serves a whole split;
- ``GraphedEvalStep`` refuses the CPU and ``Evaluator(device='cpu')``
  runs the eager step;
- the weight guard passes after ``load_state_dict`` (a copy into the same
  storage) and raises after a restore that moves a tensor; the input
  guard raises on another key, shape or dtype;
- ``kernel_launches`` counts a captured launch once per replay.
"""

import functools
import re

import numpy as np
import pytest
import torch

from monopsr_torch import config as config_lib
from monopsr_torch import constants as C
from monopsr_torch.datasets.kitti.kitti_dataset import KittiDataset
from monopsr_torch.eval import evaluator, step_graph
from monopsr_torch.experiments import flagship
from monopsr_torch.models import monopsr
from monopsr_torch.ops import emd as emd_ops
from monopsr_torch.train import trainer

from test_torch_train_loop import FIXTURE, tiny_yaml

NUM_BOXES = 4
EVAL_BATCH = 2


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
    """(config path, output base, NetConfig, a seeded net on the CPU,
    samples(mode) -> the fixture's samples of that mode's split as the
    evaluator assembles them)."""
    base = tmp_path_factory.mktemp('eval_graph')
    with open(flagship.CONFIG_PATH) as f:
        text = tiny_yaml(f.read(), FIXTURE, 2)
    text, n = re.subn(r'(?m)^(\s*num_boxes:)[^#\n]*',
                      r'\g<1> {}'.format(NUM_BOXES), text)
    assert n == 1
    path = base / 'tiny_graph.yaml'
    path.write_text(text)
    config = config_lib.parse_yaml_config(str(path),
                                          output_base_dir=str(base))
    net, cfg = monopsr.create_net_from_config(
        config.model_config, config.dataset_config, device='cpu', seed=0)
    assert cfg.num_boxes == NUM_BOXES

    @functools.lru_cache(maxsize=None)
    def samples(mode):
        dataset = KittiDataset(_split_config(path, base, mode), mode)
        out = []
        for idx in range(dataset.num_samples):
            sample = dataset.get_sample_dict([idx])[0]
            if sample is None:
                continue
            device_sample = trainer.prepare_sample(sample,
                                                   cfg.image_input_shape)
            if mode == 'test':
                device_sample = monopsr.strip_to_net_inputs(device_sample)
            out.append(device_sample)
        assert len(out) >= EVAL_BATCH
        return out

    return path, base, cfg, net, samples


def _split_config(path, base, mode):
    """The dataset config of the fixture's val split ('val' mode) or test
    split ('test' mode)."""
    dataset_config = config_lib.parse_yaml_config(
        str(path), output_base_dir=str(base)).dataset_config
    if mode == 'test':
        dataset_config.data_split = 'test'
        dataset_config.data_split_dir = 'testing'
        dataset_config.has_kitti_labels = False
    else:
        dataset_config.data_split = 'val'
    return dataset_config


def _assert_same(got, want):
    """Two eval step results (packed outputs, losses, metrics): the same
    keys, and each tensor of the same shape, dtype and bits
    (``chip_smoke.eval_results_against``, which phase 20 holds the graph
    to on the card; ``chip_smoke`` lies at the repository root, which
    ``python -m pytest`` from there puts on the path)."""
    import chip_smoke
    equal, worst = chip_smoke.eval_results_against(got, want)
    assert equal, {key: value for key, value in worst.items() if value}


@pytest.fixture(scope='module')
def full_step(tiny):
    """full_step(mode) -> (eager step, batch, its full-slot result) on the
    first EVAL_BATCH fixture samples of that mode."""
    path, base, cfg, net, samples = tiny
    loss_config = config_lib.parse_yaml_config(
        str(path), output_base_dir=str(base)).model_config.loss_config

    @functools.lru_cache(maxsize=None)
    def run(mode):
        step = evaluator.make_eval_step(net, cfg, loss_config.to_dict(),
                                        mode, device='cpu')
        batch = evaluator.stack_samples(samples(mode)[:EVAL_BATCH])
        return step, batch, step(batch, None)

    return run


@pytest.mark.parametrize('mode', ['val', 'test'])
@pytest.mark.parametrize('bucket', list(range(1, NUM_BOXES + 1)))
def test_full_slot_step_cut_to_a_bucket_equals_the_step_at_it(
        full_step, mode, bucket):
    """One capture at the full num_boxes slots serves every bucket: the
    views a replay returns at ``bucket`` hold what the eager step returns
    there, bit for bit."""
    step, batch, full = full_step(mode)
    want = step(batch, bucket)
    got = step_graph.bucket_views(full, NUM_BOXES, bucket)
    _assert_same(got, want)
    packed, losses, metrics = got
    assert packed[C.KEY_CENTROIDS].shape[:2] == (EVAL_BATCH, bucket)
    if mode == 'val':
        assert metrics[C.METRIC_EMD].shape == (EVAL_BATCH, bucket)
        assert losses['total_loss'].shape == (EVAL_BATCH,)
    else:
        assert losses == {} and metrics == {}


@pytest.mark.parametrize('mode', ['val', 'test'])
def test_fixture_samples_have_one_shape_per_split(tiny, mode):
    """Every sample of the split has the first one's keys, shapes and
    dtypes after prepare_sample: one set of static input buffers serves
    every group of an epoch."""
    samples = tiny[4](mode)
    want = step_graph.batch_spec(evaluator.stack_samples(samples[:1]))
    for sample in samples[1:]:
        step_graph.check_batch(evaluator.stack_samples([sample]), want)
    assert want['image'] == ((1, 48, 160, 3), torch.uint8)


def test_graphed_step_refuses_the_cpu(full_step, tiny):
    step, _, _ = full_step('val')
    with pytest.raises(ValueError, match='CUDA device'):
        step_graph.GraphedEvalStep(step, 'cpu', tiny[3], NUM_BOXES)


def test_evaluator_on_the_cpu_runs_the_eager_step(tiny, full_step):
    path, base, cfg, _, samples = tiny
    config = config_lib.parse_yaml_config(str(path),
                                          output_base_dir=str(base))
    config.dataset_config = _split_config(path, base, 'val')
    ev = evaluator.Evaluator(config, KittiDataset(config.dataset_config,
                                                  'val'), 'val',
                             do_kitti_native_eval=False, device='cpu')
    assert not isinstance(ev._eval_step, step_graph.GraphedEvalStep)
    ev.net.load_state_dict(tiny[3].state_dict())
    _, batch, full = full_step('val')
    _assert_same(ev._eval_step(batch, None), full)
    # No graph: the launches are the counters'
    assert step_graph.kernel_launches(ev._eval_step) == {
        'emd_cost_fused': emd_ops.emd_cost_fused.launches,
        'emd_loss': emd_ops.emd_distance.launches}


def _fresh_net(cfg, seed):
    return monopsr.create_net(cfg, device='cpu', seed=seed)


def test_weight_guard_passes_a_restore_that_copies(tiny):
    cfg = tiny[2]
    net, other = _fresh_net(cfg, 0), _fresh_net(cfg, 1)
    pointers = step_graph.weight_pointers(net)
    assert len(pointers) == len(list(net.parameters())) + len(
        list(net.buffers()))
    net.load_state_dict(other.state_dict())
    step_graph.check_weights(net, pointers)
    name, value = next(iter(other.state_dict().items()))
    assert torch.equal(net.state_dict()[name], value)


def _assign(net, other):
    net.load_state_dict(other.state_dict(), assign=True)


def _to_double(net, other):
    net.double()


def _replace_buffer(net, other):
    name = next(name for name, _ in net.named_buffers())
    module_name, _, buffer_name = name.rpartition('.')
    module = net.get_submodule(module_name)
    setattr(module, buffer_name, getattr(module, buffer_name).clone())


@pytest.mark.parametrize('restore', [_assign, _to_double, _replace_buffer],
                         ids=['assign', 'to_double', 'replaced_buffer'])
def test_weight_guard_raises_when_a_tensor_moves(tiny, restore):
    cfg = tiny[2]
    net, other = _fresh_net(cfg, 0), _fresh_net(cfg, 1)
    pointers = step_graph.weight_pointers(net)
    restore(net, other)
    with pytest.raises(RuntimeError, match='load_state_dict'):
        step_graph.check_weights(net, pointers)


def _drop_key(batch):
    batch.pop(sorted(batch)[0])


def _add_key(batch):
    batch['extra'] = np.zeros((EVAL_BATCH, 3), np.float32)


def _other_shape(batch):
    batch['image'] = batch['image'][:, :-1]


def _other_dtype(batch):
    batch['image'] = batch['image'].astype(np.float32)


@pytest.mark.parametrize('change', [None, _drop_key, _add_key, _other_shape,
                                    _other_dtype],
                         ids=['same', 'dropped_key', 'added_key',
                              'other_shape', 'other_dtype'])
def test_input_guard(full_step, change):
    _, batch, _ = full_step('val')
    spec = step_graph.batch_spec(batch)
    batch = dict(batch)
    if change is None:
        step_graph.check_batch(batch, spec)
        # a batch of tensors is held to the same spec as numpy arrays
        step_graph.check_batch({k: torch.from_numpy(v) if isinstance(
            v, np.ndarray) else v for k, v in batch.items()}, spec)
        return
    change(batch)
    with pytest.raises(ValueError, match='differs'):
        step_graph.check_batch(batch, spec)


def test_kernel_launches_count_a_captured_launch_per_replay():
    class Captured(step_graph.GraphedEvalStep):
        def __init__(self, captured, replays):   # no device: counts only
            self.captured_launches, self.replays = captured, replays

    counters = step_graph.kernel_launches()
    graphed = Captured({'emd_cost_fused': 1, 'emd_loss': 0}, 4)
    # the counters hold the captured launch once; three replays more ran it
    assert step_graph.kernel_launches(graphed) == {
        'emd_cost_fused': counters['emd_cost_fused'] + 3,
        'emd_loss': counters['emd_loss']}
    assert step_graph.kernel_launches(Captured(None, 0)) == counters
