"""The host side of the multi-tensor Adam kernels (``ops/multi_tensor_adam``)
and the optimizer's choice of path, on the CPU.

The kernels themselves run only on a card: ``tests/test_torch_kernels_cuda.py``
holds them against the plain twin there. Here: the chunk table covers
every element of every tensor exactly once (empty tensors, tensors
shorter than a vector, longer than a chunk), the device table's layout is
what the kernels read, the wrapper refuses CPU tensors, the schedule's
kernel arguments are its own numbers, and ``Optimizer.apply`` runs the
plain twin on the CPU and for every other update rule.
"""

import numpy as np
import pytest
import torch

from monopsr_torch.ops import multi_tensor_adam as mta
from monopsr_torch.train import optimizer
from monopsr_torch.train.train_state import TrainState

CHUNK = mta.CHUNK


def _coverage(numels, rows, chunk):
    """Per tensor, how often each element is covered by ``rows``."""
    seen = [np.zeros(n, np.int64) for n in numels]
    for t, start, length in rows:
        assert 0 < length <= chunk
        assert start % chunk == 0
        seen[t][start:start + length] += 1
    return seen


@pytest.mark.parametrize('numels,chunk', [
    ([0], CHUNK),
    ([1], CHUNK),
    ([3], CHUNK),
    ([4], CHUNK),
    ([5, 0, 7], CHUNK),
    ([CHUNK], CHUNK),
    ([CHUNK + 1], CHUNK),
    ([0, 3 * CHUNK + 5, 0, 2, CHUNK - 1, 0], CHUNK),
    ([0, 1, 8, 9, 17, 0, 64], 8),
    (list(range(40)), 4),
])
def test_chunk_table_covers_every_element_once(numels, chunk):
    rows = mta.chunk_table(numels, chunk)
    assert rows.shape == (sum(-(-n // chunk) for n in numels), 3)
    for seen in _coverage(numels, rows, chunk):
        assert (seen == 1).all()
    # in order of tensor, then start
    assert (np.lexsort((rows[:, 1], rows[:, 0])) ==
            np.arange(len(rows))).all()


def test_chunk_table_of_the_production_parameter_list():
    """The net's own 100.4 M parameters, by the shapes of the production
    config (built on the meta device: no storage)."""
    from monopsr_torch.experiments import flagship
    from monopsr_torch.models.monopsr_net import MonoPSRNet
    with torch.device('meta'):
        net = MonoPSRNet(flagship.flagship_config())
    numels = [p.numel() for p in net.parameters()]
    assert 100.0e6 < sum(numels) < 100.8e6
    rows = mta.chunk_table(numels)
    assert int(rows[:, 2].sum()) == sum(numels)
    for seen in _coverage(numels, rows, CHUNK):
        assert (seen == 1).all()


def test_device_table_layout():
    """Five pointer arrays of n tensors, padded to an even word count, then
    one (tensor, start, length, 0) int32 row per chunk."""
    numels = [5, 0, 2 * CHUNK + 1]
    pointers = [[100 * k + t for t in range(3)] for k in range(5)]
    words, n_chunks = mta.device_table(pointers, numels)
    assert n_chunks == 1 + 3
    offset = (5 * 3 + 1) & ~1
    assert words[:15].tolist() == [p for column in pointers for p in column]
    assert words.size == offset + 2 * n_chunks
    rows = words[offset:].view(np.int32).reshape(n_chunks, 4)
    assert rows.tolist() == [[0, 0, 5, 0], [2, 0, CHUNK, 0],
                             [2, CHUNK, CHUNK, 0], [2, 2 * CHUNK, 1, 0]]


def _adam(**extra):
    return optimizer.build_optimizer({'optimizer': {
        'optimizer_type': 'adam_optimizer',
        'adam_optimizer': {'learning_rate_type': 'exponential_decay',
                           'initial_learning_rate': 1e-3,
                           'decay_steps': 3, 'decay_factor': 0.8,
                           'staircase': True, 'use_moving_average': True,
                           'moving_average_decay': 0.9}}, **extra})


def test_kernel_refuses_cpu_tensors():
    tx, *_ = _adam()
    params = {'w': torch.zeros(4)}
    state = tx.init(params)
    with pytest.raises(ValueError, match='CUDA'):
        mta.adam_update([torch.zeros(4)], [params['w']], [state['mu']['w']],
                        [state['nu']['w']], state['count'],
                        mta.AdamHyper(), [])


@pytest.mark.parametrize('staircase', [True, False])
def test_schedule_kernel_args_give_the_schedule(staircase):
    """The finalize's schedule, in numpy float32 from ``kernel_args``,
    against the schedule itself (both pow's from numpy and torch on the
    CPU may differ by an ulp)."""
    schedule = optimizer.build_learning_rate({
        'learning_rate_type': 'exponential_decay',
        'initial_learning_rate': 3e-4, 'decay_steps': 7,
        'decay_factor': 0.5, 'staircase': staircase})
    args = schedule.kernel_args
    assert args['lr_type'] == 1 and args['staircase'] == int(staircase)
    f32 = np.float32
    for count in (0, 1, 6, 7, 8, 50):
        p = f32(count) / f32(args['decay_steps'])
        if args['staircase']:
            p = np.floor(p)
        want = f32(args['lr']) if count <= 0 else \
            f32(args['lr']) * np.power(f32(args['decay_rate']), p)
        assert float(schedule(count)) == pytest.approx(float(want),
                                                       rel=2e-7)
    constant = optimizer.build_learning_rate(
        {'learning_rate_type': 'constant', 'learning_rate': 0.1})
    assert constant.kernel_args['lr_type'] == 0
    assert constant.kernel_args['lr'] == float(np.float32(0.1)) == \
        float(constant(5))


@pytest.mark.parametrize('opt_type', ['adam_optimizer', 'momentum_optimizer',
                                      'rms_prop_optimizer',
                                      'gradient_descent_optimizer'])
def test_apply_runs_the_plain_twin_on_the_cpu(opt_type):
    """``TrainState.apply_gradients`` (through ``Optimizer.apply``) equals
    ``update`` followed by the foreach add and EMA, bit for bit, and
    counts no fused update on the CPU."""
    config = {'optimizer': {'optimizer_type': opt_type, opt_type: {
        'learning_rate_type': 'constant', 'learning_rate': 0.01,
        'momentum_optimizer_value': 0.9}}}
    rng = np.random.RandomState(3)
    shapes = {'a': (3, 5), 'b': (7,)}
    start = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: torch.from_numpy(rng.randn(*s).astype(np.float32))
              for k, s in shapes.items()} for _ in range(3)]
    grads[1]['b'][2] = float('nan')

    tx, _, _, _ = optimizer.build_optimizer(config)
    net = torch.nn.Module()
    for k, v in start.items():
        net.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v)))
    state = TrainState.create(net, tx, use_ema=True)

    ref_tx, _, _, _ = optimizer.build_optimizer(config)
    params = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    ref_state = ref_tx.init(params)
    ema = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    for g in grads:
        state.apply_gradients(g, tx, ema_decay=0.9)
        updates, _ = ref_tx.update(g, ref_state)
        for k in params:
            params[k] += updates[k]
            ema[k].mul_(0.9).add_(params[k] * (1.0 - 0.9))
    for k in params:
        assert torch.equal(state.params[k].detach(), params[k])
        assert torch.equal(state.ema_params[k], ema[k])
    assert state.step == 3 and int(state.opt_state['count']) == 2
    assert tx.times.totals()[1].get('train.fused_update', 0) == 0
