"""Gradients of the whole train loss: monopsr_torch against the JAX
package.

The tiny configuration of tests/torch_parity.py (resnet_tiny towers,
float32, 4 box slots) runs the train-mode forward, GT assembly, global
outputs and the losses on the same flax weights and numpy-seeded
samples (2 images) in both packages; the JAX side is
``jax.value_and_grad`` of the train step's loss_fn. Three loss
configurations differ in the local xyz map loss: the production
``smooth_l1_nonzero``, ``emd`` and ``chamfer_dist``.

Tolerances. The gradients of the loss with respect to the net's outputs
agree to ~1e-6, but the backbone's backward is sensitive at the ReLU
kinks: an ulp-level change of the weights moves torch's own gradients
by up to 2.4e-3 on some leaves, and the two packages differ by up to
1.4e-2 on a few (the squash conv's). So: the whole gradient within
5e-3 in L2 norm (observed 3e-4 to 1.1e-3); each leaf within 2e-2 of its
largest component plus 1e-5 of the largest component of any leaf (the
map decoder's conv biases feed a train-mode batch norm, so their true
gradient is 0 and both packages give noise). The EMD loss goes through
each package's own plan (rtol 1e-3 on its value, as
tests/test_torch_emd_loss.py); the other losses rtol 1e-4 and atol
1e-4 * max(1, |loss|), as tests/test_torch_eval_step.py; the new decoder
batch statistics rtol 1e-4 (biased variance, flax's).
"""

import jax
import numpy as np
import pytest

from monopsr_tpu.models import monopsr_net as jax_net
from monopsr_torch import weights
from monopsr_torch.eval import evaluator
from monopsr_torch.models import monopsr

import torch_parity as tp


@pytest.fixture(scope='module')
def setup():
    jcfg, tcfg = tp.configs()
    rng = np.random.RandomState(7)
    samples = [tp.make_sample(rng, jcfg) for _ in range(2)]
    jnet = jax_net.MonoPSRNet(cfg=jcfg)
    variables = tp.init_flax(jnet, samples[0])
    return jcfg, tcfg, jnet, variables, evaluator.stack_samples(samples)


def check_gradients(got, want):
    """got, want: {path: array} of the same parameter leaves."""
    assert set(got) == set(want)
    gmax = max(np.abs(w).max() for w in want.values())
    num = np.sqrt(sum(((got[k] - want[k]) ** 2).sum() for k in want))
    den = np.sqrt(sum((want[k] ** 2).sum() for k in want))
    assert num / den < 5e-3, num / den
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        assert err <= 2e-2 * np.abs(w).max() + 1e-5 * gmax, (k, err)


@pytest.mark.parametrize('xyz_loss', [
    ['smooth_l1_nonzero', 100.0], ['emd', 1.0], ['chamfer_dist', 1.0]])
def test_loss_gradients_match_jax(setup, xyz_loss):
    jcfg, tcfg, jnet, variables, batch = setup
    loss_config = tp.loss_config(xyz_loss)
    loss_fn = tp.jax_loss_fn(jnet, jcfg, loss_config,
                             variables['batch_stats'], batch)
    (want_total, (want_losses, want_stats)), want_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables['params'])

    net = tp.torch_net_from_flax(tcfg, variables).train()
    dev = evaluator.batch_to_device(batch, 'cpu')
    outputs = net(**monopsr.net_inputs_from_batch(dev))
    gt = monopsr.build_gt_dict(tcfg, dev, outputs)
    outputs, gt = monopsr.add_global_outputs(tcfg, dev, outputs, gt)
    losses, totals = monopsr.compute_losses(tcfg, loss_config, outputs, gt)
    total = totals.mean()
    total.backward()

    rtol = 1e-3 if xyz_loss[0] == 'emd' else 1e-4
    np.testing.assert_allclose(float(total.detach()), float(want_total),
                               rtol=rtol)
    assert set(losses) == set(want_losses)
    for key, value in losses.items():
        want = float(want_losses[key])
        np.testing.assert_allclose(
            float(value.detach().mean()), want,
            rtol=rtol if key in ('inst_xyz_map_local', 'total_loss')
            else 1e-4, atol=1e-4 * max(1.0, abs(want)), err_msg=key)

    got = tp.leaves(weights.to_flax_variables(
        {k: p.grad for k, p in net.named_parameters()})['params'])
    check_gradients(got, tp.leaves(jax.device_get(want_grads)))

    got_stats = tp.leaves(weights.to_flax_variables(
        dict(net.named_buffers()))['batch_stats'])
    want_stats = tp.leaves(jax.device_get(want_stats))
    assert set(got_stats) == set(want_stats)
    for k, w in want_stats.items():
        np.testing.assert_allclose(got_stats[k], w, rtol=1e-4, atol=1e-6,
                                   err_msg='/'.join(k))


def test_weight_bridge_round_trips(setup):
    """to_flax_variables inverts from_flax_variables exactly."""
    _, tcfg, _, variables, _ = setup
    back = weights.to_flax_variables(
        tp.torch_net_from_flax(tcfg, variables).state_dict())
    for part in ('params', 'batch_stats'):
        got, want = tp.leaves(back[part]), tp.leaves(variables[part])
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg='/'.join(k))
