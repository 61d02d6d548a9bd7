"""Whole train steps of monopsr_torch against the JAX package's
``make_train_step``.

Both packages start mid-training from the same state: the JAX train step
runs once from the flax init (so Adam's count is 1, its moments and the
EMA have moved and the decoder batch statistics are no longer the
init's), and ``weights.train_state_from_flax`` carries that state into
the port. Then both take three steps on the same numpy-seeded batch:
2 images with the production loss_config, 1 image (the production
train batch) with the 'emd' loss, whose plan path is the costly part on
the CPU. The schedule decays by 0.8 every 2 updates, so the steps run
at counts 1, 2 and 3 and cross a staircase boundary. The tiny
configuration of tests/torch_parity.py, float32, on the CPU.

Tolerances. Gradients agree as tests/test_torch_train_grads.py holds
them; Adam divides each by its own root-mean-square, so a leaf whose
gradient is noise in both packages (the decoder conv biases ahead of a
train-mode batch norm, whose true gradient is 0) can step in opposite
directions: each step moves a parameter by at most ~3 lr here, so
parameters and the EMA agree to rtol 1e-5 plus atol 4 lr per step taken
in the port. Such differences in a 3x3x512 decoder conv's weights add up
to ~1e-2 in a batch mean, of which the running statistics take 0.003 a
step: the decoder batch statistics agree to rtol 1e-4 plus atol 1e-3 of
each leaf's largest value. Logged losses as the gradient test's.
"""

import jax
import numpy as np
import pytest
import torch

from monopsr_tpu.config import ConfigObj
from monopsr_tpu.models import monopsr_net as jax_net
from monopsr_tpu.train import optimizer as jax_opt
from monopsr_tpu.train import trainer as jax_trainer
from monopsr_tpu.train.train_state import TrainState as JaxTrainState
from monopsr_torch import weights
from monopsr_torch.eval import evaluator
from monopsr_torch.models import monopsr_net as torch_net
from monopsr_torch.train import optimizer, trainer

import torch_parity as tp

LR = 8e-5
EMA_DECAY = 0.9


def _compare(got, want, atol, rtol, what, leaf_atol=0.0):
    got, want = tp.leaves(got), tp.leaves(want)
    assert set(got) == set(want), what
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k], w, rtol=rtol, atol=atol + leaf_atol * np.abs(w).max(),
            err_msg='{} {}'.format(what, '/'.join(k)))


@pytest.fixture(scope='module')
def setup():
    jcfg, tcfg = tp.configs()
    rng = np.random.RandomState(11)
    samples = [tp.make_sample(rng, jcfg) for _ in range(2)]
    jnet = jax_net.MonoPSRNet(cfg=jcfg)
    return jcfg, tcfg, samples, jnet, tp.init_flax(jnet, samples[0])


@pytest.mark.parametrize('xyz_loss,images', [
    (['smooth_l1_nonzero', 100.0], 2), (['emd', 1.0], 1)])
def test_three_train_steps_match_jax(setup, xyz_loss, images):
    jcfg, tcfg, samples, jnet, variables = setup
    batch = evaluator.stack_samples(samples[:images])
    loss_config = tp.loss_config(xyz_loss)
    train_config = tp.train_config(decay_steps=2)

    jtx, _, use_ema, ema_decay = jax_opt.build_optimizer(
        ConfigObj(train_config))
    assert use_ema and ema_decay == EMA_DECAY
    jstep = jax_trainer.make_train_step(jnet, jcfg, loss_config, jtx,
                                        use_ema, ema_decay)
    jstate = JaxTrainState.create(variables, jtx, use_ema=True)
    jstate, _ = jstep(jstate, batch)             # the carried-across start

    ttx, _, _, _ = optimizer.build_optimizer(train_config)
    net = torch_net.MonoPSRNet(tcfg)
    host = jax.device_get(jstate)
    tstate = weights.train_state_from_flax(
        net, ttx, host.step, host.params, host.batch_stats, host.opt_state,
        host.ema_params)
    assert int(tstate.opt_state['count']) == 1 and tstate.step == 1
    tstep = trainer.make_train_step(net, tcfg, loss_config, ttx, use_ema,
                                    ema_decay, device='cpu')

    for step in range(1, 4):
        jstate, jlosses = jstep(jstate, batch)
        tstate, tlosses = tstep(tstate, batch)
        want = jax.device_get(jstate)
        assert tstate.step == int(want.step) == step + 1
        atol = 4 * LR * step
        _compare(weights.to_flax_variables(tstate.params)['params'],
                 want.params, atol, 1e-5, 'params')
        _compare(weights.to_flax_variables(tstate.ema_params)['params'],
                 want.ema_params, atol, 1e-5, 'ema')
        _compare(weights.to_flax_variables(tstate.batch_stats)['batch_stats'],
                 want.batch_stats, 0.0, 1e-4, 'batch_stats',
                 leaf_atol=1e-3)
        assert set(tlosses) == set(jlosses)
        for key, value in tlosses.items():
            w = float(jlosses[key])
            rtol = 1e-3 if xyz_loss[0] == 'emd' and key in (
                'inst_xyz_map_local', 'total_loss') else 1e-4
            np.testing.assert_allclose(float(value), w, rtol=rtol,
                                       atol=1e-4 * max(1.0, abs(w)),
                                       err_msg='step {} {}'.format(step, key))
        found = {}
        weights._flax_opt_leaves(want.opt_state, found)
        assert set(found['counts']) == {int(tstate.opt_state['count'])}
    # The parameters really moved
    moved = tp.leaves(weights.to_flax_variables(tstate.params)['params'])
    first = tp.leaves(host.params)
    assert max(np.abs(moved[k] - first[k]).max() for k in first) > LR


@pytest.mark.parametrize('xyz_loss', [['smooth_l1_nonzero', 100.0],
                                      ['emd', 1.0]])
def test_train_step_reads_nothing_on_the_host(xyz_loss):
    """A whole make_train_step step (Adam with the clip, the EMA,
    skip_nonfinite) after a first one, as a CUDA graph captures it
    (``train.step_graph``), under tests/test_torch_optimizer.NoHostRead
    widened to tensors made from host numbers, then a non-finite step (a
    NaN planted in a parameter makes every loss and gradient NaN), which
    the optimizer skips the same way. Tiny widths (16x16 ROIs, 2 boxes)
    keep it short."""
    from tests.test_torch_optimizer import NoHostRead

    class NoHostData(NoHostRead):
        """NoHostRead, and no tensor made from host numbers
        (``aten.lift_fresh``): on a card that is a copy from pageable
        memory, which a capture refuses. The step's constants are made
        at its first run and kept (``utils.device.constant``)."""
        READS = NoHostRead.READS + (torch.ops.aten.lift_fresh.default,)

    jcfg, tcfg = tp.configs(img_roi_size=(16, 16), map_roi_size=(16, 16),
                            num_boxes=2)
    rng = np.random.RandomState(13)
    batch = evaluator.stack_samples([tp.make_sample(rng, jcfg)])
    train_config = tp.train_config(decay_steps=2)
    assert train_config.get('skip_nonfinite_updates', True)
    tx, _, use_ema, ema_decay = optimizer.build_optimizer(train_config)
    net = torch_net.MonoPSRNet(tcfg)
    step = trainer.make_train_step(net, tcfg, tp.loss_config(xyz_loss), tx,
                                   use_ema, ema_decay, device='cpu')
    state = trainer.create_train_state(net, tx, use_ema)
    state, _ = step(state, batch)          # makes the kept constants
    # the batch reaches the step as tensors, as the graph's input buffers
    batch = evaluator.batch_to_device(batch, 'cpu')
    with NoHostData():
        state, losses = step(state, batch)
    assert all(np.isfinite(float(v)) for v in losses.values())
    assert int(state.opt_state['count']) == 2

    name = next(iter(state.params))
    with torch.no_grad():
        state.params[name].view(-1)[0] = float('nan')
    before = {k: v.detach().clone() for k, v in state.params.items()}
    with NoHostData():
        state, losses = step(state, batch)
    assert not np.isfinite(float(losses['total_loss']))
    assert int(state.opt_state['count']) == 2          # skipped
    assert int(state.opt_state['notfinite_count']) == 1
    for key, value in before.items():
        torch.testing.assert_close(state.params[key].detach(), value,
                                   rtol=0, atol=0, equal_nan=True)
