"""monopsr_torch.models.losses against the JAX package.

The JAX losses reduce one sample to a scalar and the JAX step vmaps
them; the port takes the sample axis S as the leading axis. Each loss
type runs through both packages' ``apply_loss`` on the same
numpy-seeded inputs: the port at S=2 against the JAX loss vmapped over
the two samples. Tolerance: the same float32 formulas, reduced in
another order: rtol 1e-5, atol 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from monopsr_tpu.models import losses as jax_losses
from monopsr_torch.models import losses

S = 2


def _inputs(rng, loss_type):
    if loss_type in ('chamfer_dist',):
        shape, mask_shape = (S, 3, 6, 6, 3), (S, 3, 6, 6, 1)
    elif loss_type in ('softmax', 'softmax_temp'):
        shape, mask_shape = (S, 4, 12), (S, 4, 1)
    else:
        shape, mask_shape = (S, 4, 6, 6, 3), (S, 4, 6, 6, 1)
    pred = rng.normal(0, 2, shape).astype(np.float32)
    if loss_type in ('softmax', 'softmax_temp'):
        target = np.eye(shape[-1], dtype=np.float32)[
            rng.randint(0, shape[-1], shape[:-1])]
    elif loss_type in ('sigmoid_ce', 'focal'):
        target = (rng.uniform(size=shape) < 0.5).astype(np.float32)
    else:
        target = rng.normal(0, 2, shape).astype(np.float32)
    mask = (rng.uniform(size=mask_shape) < 0.6).astype(np.float32)
    return pred, target, mask


LOSS_TYPES = ['smooth_l1', 'smooth_l1_nonzero', 'softmax', 'softmax_temp',
              'sigmoid_ce', 'focal', 'berHu', 'chamfer_dist']


@pytest.mark.parametrize('loss_type', LOSS_TYPES)
def test_loss_matches_jax(loss_type):
    rng = np.random.RandomState(LOSS_TYPES.index(loss_type))
    pred, target, mask = _inputs(rng, loss_type)
    entry = [loss_type, 0.7]
    if loss_type == 'smooth_l1':
        # Per-row form: the JAX step calls it on one sample's (1, N, C)
        # with (1, N, 1) weights; the port on (S, N, C), (S, N, 1)
        pred, target = pred.reshape(S, 4, -1), target.reshape(S, 4, -1)
        mask = mask.reshape(S, 4, -1)[..., :1]
        want = jax.vmap(lambda p, t, m: jax_losses.apply_loss(
            entry, p[None], t[None], m[None])[0])(pred, target, mask)
    else:
        want = jax.vmap(lambda p, t, m: jax_losses.apply_loss(
            entry, p, t, m))(pred, target, mask)
    got = losses.apply_loss(entry, torch.from_numpy(pred),
                            torch.from_numpy(target), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_berhu_with_no_valid_weight_is_zero():
    pred = torch.ones(S, 2, 3)
    got = losses.weighted_ber_hu(pred, torch.zeros_like(pred),
                                 torch.zeros_like(pred))
    assert got.tolist() == [0.0, 0.0]


def test_none_and_emd_and_unknown_types():
    """None gives zeros; 'emd' of identical maps is 0 per sample (its value
    against the JAX loss is held in tests/test_torch_emd_loss.py); an
    unknown type raises."""
    x = torch.ones(S, 2, 3)
    assert torch.equal(losses.apply_loss([None, 1.0], x, x, x),
                       torch.zeros_like(x))
    emd = losses.apply_loss(['emd', 1.0], x, x, x)
    assert emd.shape == (S,) and float(emd.abs().max()) == 0.0
    with pytest.raises(ValueError):
        losses.apply_loss(['bogus', 1.0], x, x, x)
