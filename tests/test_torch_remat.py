"""Tower remat in the port: a memory choice, never a numerics choice.

Mirrors tests/test_remat_policies.py at ``resnet_tiny`` in float32: for
each policy the loss and every parameter gradient of the port's tower
equal its no-remat run (the JAX test's bounds) and the JAX tower's run
under the same policy, for the same weights. Beyond the JAX test: what
the backward pass keeps shrinks ('unit' below 'conv_outs' below none),
'conv_outs' re-runs no convolution, and a config's ``remat_towers``
reaches both towers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from monopsr_torch import weights
from monopsr_torch.models import monopsr as torch_monopsr
from monopsr_torch.models.monopsr_net import NetConfig
from monopsr_torch.models.resnet import RESNET_SPECS, ResNetV1
from monopsr_tpu.models.resnet import ResNetV1 as JaxResNetV1

POLICIES = ('unit', 'conv_outs', 'another')


def _tower(remat, policy='unit'):
    torch.manual_seed(0)
    tower = ResNetV1(RESNET_SPECS['resnet_tiny'], output_stride=4,
                     num_blocks=3, dtype=torch.float32, remat=remat,
                     remat_policy=policy)
    # frozen statistics away from 0/1, so the BN tail is exercised
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, buf in tower.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=gen) * 0.5 +
                      (0.75 if name.endswith('var') else -0.25))
    return tower


def _input():
    return np.random.RandomState(0).normal(0, 1, (2, 16, 16, 3)).astype(
        np.float32)


def _loss_and_grads(tower, x):
    tower.zero_grad()
    out = tower(torch.from_numpy(x))
    loss = (out * out).sum()
    loss.backward()
    return loss.item(), {k: p.grad.clone()
                         for k, p in tower.named_parameters()}


def _jax_loss_and_grads(state_dict, x, remat, policy):
    variables = weights.to_flax_variables(state_dict)
    tower = JaxResNetV1(spec=RESNET_SPECS['resnet_tiny'], output_stride=4,
                        num_blocks=3, dtype=jnp.float32, remat=remat,
                        remat_policy=policy)

    def loss(params):
        out = tower.apply({'params': params,
                           'batch_stats': variables['batch_stats']}, x)
        return jnp.sum(out * out)

    val, grads = jax.jit(jax.value_and_grad(loss))(variables['params'])
    grads = weights.from_flax_variables(
        {'params': jax.tree.map(np.asarray, grads)})
    return float(val), grads


@pytest.fixture(scope='module')
def base_run():
    x = _input()
    tower = _tower(remat=False)
    return x, tower.state_dict(), _loss_and_grads(tower, x)


@pytest.mark.parametrize('policy', POLICIES)
def test_remat_policy_matches_no_remat_and_jax(base_run, policy):
    x, state_dict, (val0, grad0) = base_run
    tower = _tower(remat=True, policy=policy)
    tower.load_state_dict(state_dict)
    val1, grad1 = _loss_and_grads(tower, x)

    np.testing.assert_allclose(val0, val1, rtol=1e-6)
    assert sorted(grad0) == sorted(grad1)
    for key in grad0:
        np.testing.assert_allclose(grad1[key].numpy(), grad0[key].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=key)

    if policy not in ('unit', 'conv_outs'):
        return              # JAX's 'unit' branch; the port's is held above
    jax_val, jax_grads = _jax_loss_and_grads(state_dict, x, True, policy)
    np.testing.assert_allclose(val1, jax_val, rtol=1e-6)
    assert sorted(jax_grads) == sorted(grad1)
    for key in grad1:
        np.testing.assert_allclose(grad1[key].numpy(),
                                   jax_grads[key].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


class _OpRecorder(TorchDispatchMode):
    """Counts convolutions and keeps a weak reference to the storage of
    every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.convs = 0
        self.outputs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.convolution.default:
            self.convs += 1
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.outputs.append((StorageWeakRef(t.untyped_storage()),
                                     t.untyped_storage().nbytes()))
        return out


def _kept_bytes_and_backward_convs(remat, policy):
    """Bytes of forward intermediates still alive when backward starts
    (what autograd and the checkpoints keep for it, the output aside),
    and the convolutions the backward pass re-runs."""
    tower = _tower(remat=remat, policy=policy)
    x = torch.from_numpy(_input())
    with _OpRecorder() as fwd:
        out = tower(x)
        loss = (out * out).sum()
    alive = {ref.cdata: nbytes for ref, nbytes in fwd.outputs
             if not ref.expired()}        # views share their base's
    alive.pop(StorageWeakRef(out.untyped_storage()).cdata)
    kept = sum(alive.values())
    with _OpRecorder() as bwd:
        loss.backward()
    return kept, bwd.convs


def test_remat_changes_what_backward_keeps():
    none_kept, none_convs = _kept_bytes_and_backward_convs(False, 'unit')
    unit_kept, unit_convs = _kept_bytes_and_backward_convs(True, 'unit')
    conv_kept, conv_convs = _kept_bytes_and_backward_convs(True,
                                                           'conv_outs')
    other = _kept_bytes_and_backward_convs(True, 'another')
    assert unit_kept < conv_kept < none_kept, (unit_kept, conv_kept,
                                               none_kept)
    # 'unit' re-runs every conv of every unit (3 + the first unit's
    # shortcut per unit, one unit per block at resnet_tiny); 'conv_outs'
    # and no remat re-run none
    assert unit_convs == 3 * 4
    assert conv_convs == 0 and none_convs == 0
    assert other == (unit_kept, unit_convs)


def test_remat_is_a_no_op_without_gradients():
    x = torch.from_numpy(_input())
    base = _tower(remat=False)
    with torch.no_grad():
        want = base(x)
    for policy in POLICIES:
        tower = _tower(remat=True, policy=policy)
        tower.load_state_dict(base.state_dict())
        with torch.no_grad(), _OpRecorder() as rec:
            got = tower(x)
        assert torch.equal(got, want)
        assert rec.convs == 1 + 3 * 4


@pytest.mark.parametrize('policy', ['unit', 'conv_outs'])
def test_config_remat_reaches_both_towers(policy):
    cfg = NetConfig(num_boxes=2, resnet='resnet_tiny',
                    proposal_fc_sizes=(8,), regression_fc_sizes=(8,),
                    remat_towers=True, remat_policy=policy)
    net = torch_monopsr.create_net(cfg, device='cpu')
    for tower in (net.backbone.tower_crop, net.backbone.tower_full):
        assert tower.remat and tower.remat_policy == policy
    plain = torch_monopsr.create_net(
        NetConfig(num_boxes=2, resnet='resnet_tiny', proposal_fc_sizes=(8,),
                  regression_fc_sizes=(8,)), device='cpu')
    assert not plain.backbone.tower_crop.remat
    assert not plain.backbone.tower_full.remat
