"""The ``'emd'``-loss configuration (``benchmark/configs/monopsr_r101_bf16_emd.json``)
through the port's train step, against the benchmark's plain reference, on
the CPU at a tiny size.

The configuration is cut as the benchmark's CPU tests cut it (ResNet of one
unit per block, 96x320 images, 8 boxes, 16x16 ROIs, so 8 clouds of 256
points a step) and run in float32, with the seed's weights on both sides:
the port's eager step (``trainer.make_train_step``, whose ``'emd'`` loss
runs K2's plain twin here), then a dispatch of K = 2 steps as the CPU runs
it (``trainer.eager_steps``), against ``benchmark/reference/train.py``'s
step on the same weights and batches. Compared: every loss term of each
step, the EMD term among them, and the first step's clipped gradient per
leaf (read from Adam's first moment, as the benchmark reads it).

The counter ``train.emd_loss`` counts K2's launches; the CPU launches none,
so a test stands a counted launch in for the kernel's.
"""

import math
import shutil
import tempfile

import numpy as np
import pytest
import torch

from benchmark.drivers import common
from benchmark.drivers import train as train_driver
from benchmark.reference import monopsr as ref_monopsr
from benchmark.reference import train as ref_train
from benchmark.tests import tiny_cells
from monopsr_torch.models import monopsr
from monopsr_torch.models.monopsr_net import NetConfig
from monopsr_torch.ops import emd as emd_ops
from monopsr_torch.train import optimizer as opt_lib
from monopsr_torch.train import trainer

SEED = 2 ** 33 + 777
STEPS = 3     # one eager step, then a dispatch of K = 2


@pytest.fixture(scope='module')
def setup():
    """(cell, the port's parsed config, the reference's NetConfig, the
    first STEPS batches)."""
    cell = tiny_cells.tiny_cell('train_b1')
    cell.config = tiny_cells.tiny_config('monopsr_r101_bf16_emd')
    assert common.loss_config(cell)['inst_xyz_map_local'] == ['emd', 1.0]
    workdir = tempfile.mkdtemp(prefix='emd_config_')
    try:
        config = common.program_config(cell, SEED, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    cfg = common.ref_config(cell)
    batches = train_driver._batches(cell, SEED, cfg)[:STEPS]
    return cell, config, cfg, batches


def _port_step(config, cfg, device='cpu'):
    """(train step, state) of the port over the seed's weights."""
    net_cfg = NetConfig.from_model_config(config.model_config,
                                          config.dataset_config)
    net = monopsr.create_net(net_cfg, device=device, seed=0)
    net.load_state_dict(common.make_weights(cfg, SEED, torch.device(device)))
    tx, _, use_ema, decay = opt_lib.build_optimizer(
        config.train_config.to_dict(), clip_gradient_norm=1.0)
    step = trainer.make_train_step(
        net, net_cfg, config.model_config.loss_config.to_dict(), tx,
        use_ema, decay, device=device)
    return step, trainer.create_train_state(net, tx, use_ema)


@pytest.fixture(scope='module')
def port(setup):
    """The port's loss terms per step ({name: float}) and the first
    step's clipped gradient norm per leaf (Adam's first moment / 0.1)."""
    _, config, cfg, batches = setup
    step, state = _port_step(config, cfg)
    terms = []

    def recorded(state, batch):
        state, losses = step(state, batch)
        terms.append({k: float(v) for k, v in losses.items()})
        return state, losses

    dispatch = trainer.eager_steps(recorded)
    state, _ = dispatch(state, batches[:1])
    names = list(state.params)
    grad = [float(state.opt_state['mu'][n].norm()) / 0.1 for n in names]
    dispatch(state, batches[1:])
    return terms, dict(zip(names, grad))


@pytest.fixture(scope='module')
def reference(setup):
    """The reference's loss terms per step and the first step's clipped
    gradient norm per leaf, from the same weights and batches."""
    cell, _, cfg, batches = setup
    device = torch.device('cpu')
    net, _ = common.reference_net(cfg, SEED, device)
    net.train()
    adam = ref_train.Adam(cell.experiment['train_config']['optimizer'][
        'adam_optimizer'], common.ema_decay(cell))
    params = dict(net.named_parameters())
    terms, grad = [], None
    with common.tf32(False):
        for batch in batches:
            batch = ref_train.to_device(batch, device)
            outputs = net(**ref_monopsr.net_inputs_from_batch(batch))
            gt = ref_monopsr.build_gt_dict(cfg, batch, outputs)
            outputs, gt = ref_monopsr.add_global_outputs(cfg, batch,
                                                         outputs, gt)
            losses, totals = ref_monopsr.compute_losses(
                cfg, common.loss_config(cell), outputs, gt)
            totals.mean().backward()
            grads = {n: (p.grad if p.grad is not None else
                         torch.zeros_like(p)) for n, p in params.items()}
            clipped = adam.step(params, grads)
            for p in params.values():
                p.grad = None
            step_terms = {k: float(v.detach().mean())
                          for k, v in losses.items()}
            step_terms['total_loss'] = float(totals.detach().mean())
            terms.append(step_terms)
            if grad is None:
                grad = {n: float(g.norm()) for n, g in clipped.items()}
    return terms, grad


def _gap(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


# Relative gap of a loss term, per step (largest read over four seeds: 0,
# 2.8e-5, 2.2e-4). Step 1 reads the same weights and inputs on both sides,
# which run the same float32 operations in the same order on the CPU: the
# same bits, 1e-6 for a library that sums in another order. Each Adam step
# moves every weight by ~lr whatever its gradient's size, so a rounding gap
# in a tiny gradient becomes a whole step on that weight, and the EMD plan's
# exp(-4^j d) rounds amplify a gap in d by up to 4^8 d: the gap grows about
# tenfold a step, 2e-4 and 2e-3 leave that room over the readings.
LOSS_RTOL = (1e-6, 2e-4, 2e-3)
# The first step's clipped gradient per leaf, over the larger of the leaf's
# norm and the median leaf's (largest read over four seeds: 6.4e-6): float32
# sums of the backward in another order, amplified where the EMD gradient
# divides by a pair's distance (floored at 1e-10 for the masked points at
# the origin).
GRAD_RTOL = 1e-4


def _worst_gap(got, want):
    """(leaf, gap) of the worst leaf, each gap over the larger of the
    leaf's reference norm and the median leaf's."""
    names = sorted(want)
    g = np.array([got[n] for n in names])
    w = np.array([want[n] for n in names])
    gaps = np.abs(g - w) / np.maximum(w, np.median(w))
    worst = int(np.argmax(gaps))
    return names[worst], float(gaps[worst])


@pytest.mark.parametrize('step', range(STEPS))
def test_loss_terms_match_the_reference(port, reference, step):
    """Every loss term of the eager step (step 0) and of the K = 2
    dispatch's two steps, the EMD term and the total among them."""
    got, want = port[0][step], reference[0][step]
    assert set(got) == set(want)
    assert want['inst_xyz_map_local'] > 0
    for name in want:
        assert math.isfinite(got[name]), name
        assert _gap(got[name], want[name]) <= LOSS_RTOL[step], (
            name, got[name], want[name])


def test_first_gradient_norms_match_the_reference(port, reference):
    """The first step's clipped gradient per leaf, within GRAD_RTOL."""
    got, want = port[1], reference[1]
    assert set(got) == set(want)
    assert all(math.isfinite(v) for v in got.values())
    leaf, gap = _worst_gap(got, want)
    assert gap <= GRAD_RTOL, (leaf, gap)


def test_only_the_emd_term_differs_from_production(setup, port):
    """The configuration changes one key: on the first step (the same
    weights and batch) every loss term but the local xyz maps' equals the
    production configuration's bit for bit, and that one is the EMD."""
    _, _, cfg, batches = setup
    workdir = tempfile.mkdtemp(prefix='emd_config_')
    try:
        config = common.program_config(tiny_cells.tiny_cell('train_b1'),
                                       SEED, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    step, state = _port_step(config, cfg)
    _, losses = step(state, batches[0])
    production = {k: float(v) for k, v in losses.items()}
    emd = port[0][0]
    assert set(production) == set(emd)
    for name in emd:
        if name not in ('inst_xyz_map_local', 'total_loss'):
            assert production[name] == emd[name], name
    assert _gap(production['inst_xyz_map_local'],
                emd['inst_xyz_map_local']) > 0.1


def test_a_planted_plan_fault_fails_the_comparison(setup, reference,
                                                   monkeypatch):
    """The port's plan without its last annealing round (level 0) gives
    an EMD term and gradients beyond the tolerances."""
    real = emd_ops._levels
    monkeypatch.setattr(emd_ops, '_levels', lambda: real()[:-1])
    _, config, cfg, batches = setup
    step, state = _port_step(config, cfg)
    state, losses = step(state, batches[0])
    assert _gap(float(losses['inst_xyz_map_local']),
                reference[0][0]['inst_xyz_map_local']) > LOSS_RTOL[0]
    names = list(state.params)
    got = {n: float(state.opt_state['mu'][n].norm()) / 0.1 for n in names}
    assert _worst_gap(got, reference[1])[1] > GRAD_RTOL


def test_emd_loss_counter_counts_one_per_step(setup, monkeypatch):
    """``train.emd_loss`` counts each K2 launch of the step: none on the
    CPU, where the plain twin runs; one a step, eager steps and a K = 2
    dispatch alike, when each ``emd_distance`` call counts a launch (the
    kernel's counter, stood in for here)."""
    _, config, cfg, batches = setup
    step, state = _port_step(config, cfg)
    state, _ = step(state, batches[0])
    assert step.times.totals()[1].get('train.emd_loss', 0) == 0

    real = emd_ops.emd_distance

    def launching(xyz1, xyz2, batch_chunk=4):
        launching.launches += 1
        return real(xyz1, xyz2, batch_chunk)
    launching.launches = 0
    monkeypatch.setattr(emd_ops, 'emd_distance', launching)
    dispatch = trainer.eager_steps(step)
    state, _ = dispatch(state, batches[:1])
    assert step.times.totals()[1]['train.emd_loss'] == 1
    dispatch(state, batches[1:3])
    assert step.times.totals()[1]['train.emd_loss'] == 3
    assert launching.launches == 3


def test_production_loss_counts_no_emd_launch(setup, monkeypatch):
    """The production loss (smooth L1) makes no ``emd_distance`` call:
    the counter stays absent."""
    cell, _, cfg, batches = setup
    production = tiny_cells.tiny_cell('train_b1')
    workdir = tempfile.mkdtemp(prefix='emd_config_')
    try:
        config = common.program_config(production, SEED, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    calls = []
    real = emd_ops.emd_distance

    def called(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    called.launches = real.launches
    monkeypatch.setattr(emd_ops, 'emd_distance', called)
    step, state = _port_step(config, cfg)
    step(state, batches[0])
    assert not calls
    assert 'train.emd_loss' not in step.times.totals()[1]


@pytest.mark.cuda
def test_graphed_step_counts_every_replay(setup):
    """On the card: the graphed step's ``times`` holds ``train.emd_loss``
    as the warm-up step and each replay launched K2, one a step (the
    capture launches nothing): one dispatch of one batch, then one of two
    (capture, two replays) reads 1 + 2, while the kernel's own counter
    saw the two Python calls."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from monopsr_torch.train import step_graph
    _, config, cfg, batches = setup
    step, state = _port_step(config, cfg, device='cuda')
    graphed = step_graph.GraphedTrainStep(step, torch.device('cuda'))
    assert step.times is graphed.times
    before = emd_ops.emd_distance.launches
    state, _ = graphed(state, batches[:1])
    state, losses = graphed(state, batches[1:3])
    torch.cuda.synchronize()
    assert math.isfinite(float(losses['total_loss']))
    assert emd_ops.emd_distance.launches - before == 2
    assert graphed.replayed_counts == {'train.emd_loss': 1}
    assert graphed.times.totals()[1]['train.emd_loss'] == 3
