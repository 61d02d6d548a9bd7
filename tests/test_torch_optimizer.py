"""monopsr_torch.train.optimizer and train_state against the JAX package.

Each optimizer type that ``build_optimizer`` knows runs 12 steps on the
same numpy gradients in both packages (the JAX one through optax),
crossing two staircase boundaries of an exponential-decay schedule, with
global-norm clipping on (most steps' norms exceed 1) and off, and with a
NaN step that both must skip. Parameters are compared after every step.

Tolerances: both run the same float32 arithmetic in the same order; the
global norm sums the leaves in another order and XLA's and torch's pow,
sqrt and rsqrt may differ by an ulp, so parameters agree to rtol 2e-6
(atol 1e-7 for the few near zero). With a bfloat16 first moment both
round mu to bfloat16 at the same points, and an ulp of mu before the
cast can flip a bfloat16 rounding: atol 1e-3 * lr there (a flip moves
one update by at most 2^-8 of its size, and the updates are ~lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from monopsr_tpu.config import ConfigObj
from monopsr_tpu.train import optimizer as jax_opt
from monopsr_tpu.train.train_state import TrainState as JaxTrainState
from monopsr_torch import weights
from monopsr_torch.train import optimizer
from monopsr_torch.train.train_state import TrainState

SHAPES = {'a': (7, 5), 'b': (11,), 'c': (3, 2, 4)}
LR = 1e-2


def _train_config(opt_type, **extra):
    opt = {
        'learning_rate_type': 'exponential_decay',
        'initial_learning_rate': LR,
        'decay_steps': 5,
        'decay_factor': 0.8,
        'staircase': True,
        'momentum_optimizer_value': 0.9,
    }
    return {'optimizer': {'optimizer_type': opt_type, opt_type: opt},
            **extra}


def _gradients(seed, steps, nan_step):
    rng = np.random.RandomState(seed)
    grads = []
    for t in range(steps):
        scale = 0.05 if t % 3 == 2 else 1.0      # some steps under the clip
        g = {k: (rng.randn(*s) * scale).astype(np.float32)
             for k, s in SHAPES.items()}
        if t == nan_step:
            g['b'][3] = np.nan
        grads.append(g)
    return grads


def _run_jax(train_config, params, grads, clip):
    tx, _, _, _ = jax_opt.build_optimizer(ConfigObj(train_config),
                                          clip_gradient_norm=clip)
    state = tx.init(params)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    history = []
    for g in grads:
        updates, state = update(g, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        history.append(jax.device_get(params))
    return history, jax.device_get(state)


def _run_torch(train_config, params, grads, clip):
    tx, _, _, _ = optimizer.build_optimizer(train_config,
                                            clip_gradient_norm=clip)
    params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = tx.init(params)
    history = []
    for g in grads:
        updates, state = tx.update(
            {k: torch.from_numpy(v) for k, v in g.items()}, state)
        params = {k: p + updates[k] for k, p in params.items()}
        history.append({k: p.numpy() for k, p in params.items()})
    return history, state


@pytest.mark.parametrize('opt_type,mu_dtype', [
    ('adam_optimizer', None),
    ('adam_optimizer', 'bfloat16'),
    ('momentum_optimizer', None),
    ('momentum_optimizer', 'bfloat16'),
    ('rms_prop_optimizer', None),
    ('gradient_descent_optimizer', None),
])
@pytest.mark.parametrize('clip', [1.0, None])
def test_optimizer_matches_optax(opt_type, mu_dtype, clip):
    config = _train_config(opt_type, optimizer_mu_dtype=mu_dtype)
    rng = np.random.RandomState(1)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = _gradients(2, 12, nan_step=6)
    want, jax_state = _run_jax(config, params, grads, clip)
    got, state = _run_torch(config, params, grads, clip)
    for t, (g, w) in enumerate(zip(got, want)):
        for k in SHAPES:
            if mu_dtype is None:
                np.testing.assert_allclose(g[k], w[k], rtol=2e-6, atol=1e-7,
                                           err_msg='{} step {}'.format(k, t))
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=2e-6,
                                           atol=1e-3 * LR,
                                           err_msg='{} step {}'.format(k, t))
    # The NaN step changed nothing
    for k in SHAPES:
        np.testing.assert_array_equal(got[6][k], got[5][k])
    found = {}
    weights._flax_opt_leaves(jax_state, found)
    assert set(found['counts']) == {int(state['count'])} == {11}
    assert int(state['notfinite_count']) == int(found['notfinite_count'])
    assert int(state['total_notfinite']) == int(found['total_notfinite']) == 1
    assert bool(state['last_finite']) == bool(found['last_finite'])
    for key in ('mu', 'nu', 'trace'):
        assert (key in state) == (key in found), key
        if key in state:
            for k in SHAPES:
                assert state[key][k].dtype == {
                    None: torch.float32, 'bfloat16': torch.bfloat16}[
                        mu_dtype if key != 'nu' else None]


def test_gives_up_after_max_consecutive_errors():
    """51 non-finite steps in a row: the 51st update goes through (NaN
    parameters on both sides), as optax.apply_if_finite(max 50) does."""
    config = _train_config('gradient_descent_optimizer')
    params = {'w': np.ones(4, np.float32)}
    grads = [{'w': np.full(4, np.nan, np.float32)}] * 51
    want, jax_state = _run_jax(config, params, grads, None)
    got, state = _run_torch(config, params, grads, None)
    np.testing.assert_array_equal(got[49]['w'], np.ones(4, np.float32))
    assert np.all(np.isnan(got[50]['w'])) and np.all(np.isnan(want[50]['w']))
    found = {}
    weights._flax_opt_leaves(jax_state, found)
    assert int(state['notfinite_count']) == int(found['notfinite_count']) \
        == 51
    assert int(state['count']) == found['counts'][0] == 1


@pytest.mark.parametrize('staircase', [True, False])
def test_learning_rate_schedule_matches_optax(staircase):
    """The learning rate at the update count, as optax evaluates it in
    float32: rtol 1e-6."""
    opt = {'learning_rate_type': 'exponential_decay',
           'initial_learning_rate': 8e-5, 'decay_steps': 10000,
           'decay_factor': 0.8, 'staircase': staircase}
    want = jax_opt.build_learning_rate(ConfigObj(opt))
    got = optimizer.build_learning_rate(opt)
    for count in (0, 1, 9999, 10000, 10001, 25000, 142000):
        np.testing.assert_allclose(
            float(got(torch.tensor(count, dtype=torch.int32))),
            float(want(jnp.asarray(count, jnp.int32))), rtol=1e-6)
    const = optimizer.build_learning_rate(
        {'learning_rate_type': 'constant', 'learning_rate': 0.5})
    assert float(const(torch.tensor(7))) == 0.5
    with pytest.raises(ValueError):
        optimizer.build_learning_rate({'learning_rate_type': 'cosine'})


def test_clip_uses_no_epsilon():
    """optax clips t * max / norm, where torch's clip_grad_norm_ divides by
    norm + 1e-6: with a norm of 2 the clipped gradient is exactly t / 2,
    and a norm under 1 leaves it as it is (SGD at learning rate 1)."""
    config = {'optimizer': {
        'optimizer_type': 'gradient_descent_optimizer',
        'gradient_descent_optimizer': {'learning_rate_type': 'constant',
                                       'learning_rate': 1.0}}}
    tx, _, _, _ = optimizer.build_optimizer(config, clip_gradient_norm=1.0)
    state = tx.init({'w': torch.zeros(2)})
    for g, want in (([2.0, 0.0], [-1.0, 0.0]), ([0.5, 0.0], [-0.5, 0.0])):
        updates, state = tx.update({'w': torch.tensor(g)}, state)
        assert updates['w'].tolist() == want


def test_build_optimizer_refuses_unknown_type():
    with pytest.raises(ValueError):
        optimizer.build_optimizer(_train_config('adagrad_optimizer'))


def test_train_state_ema_follows_jax():
    """TrainState.apply_gradients (in place, on a module's parameters)
    against the JAX TrainState, EMA decay 0.9, over 3 steps with Adam:
    parameters and EMA to rtol 2e-6; the EMA also moves on a skipped
    step, as in the JAX state."""
    config = _train_config('adam_optimizer')
    rng = np.random.RandomState(3)
    w0 = rng.randn(4, 3).astype(np.float32)
    grads = [rng.randn(4, 3).astype(np.float32) for _ in range(3)]
    grads[1][0, 0] = np.inf

    tx_j, _, _, _ = jax_opt.build_optimizer(ConfigObj(config))
    js = JaxTrainState.create({'params': {'w': jnp.asarray(w0)}}, tx_j,
                              use_ema=True)
    tx_t, _, _, _ = optimizer.build_optimizer(config)
    module = torch.nn.Module()
    module.w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    ts = TrainState.create(module, tx_t, use_ema=True)
    for g in grads:
        js = js.apply_gradients({'w': jnp.asarray(g)}, tx_j, ema_decay=0.9)
        ts.apply_gradients({'w': torch.from_numpy(g)}, tx_t, ema_decay=0.9)
        np.testing.assert_allclose(module.w.detach().numpy(),
                                   np.asarray(js.params['w']), rtol=2e-6)
        np.testing.assert_allclose(ts.ema_params['w'].numpy(),
                                   np.asarray(js.ema_params['w']), rtol=2e-6)
    assert ts.step == int(js.step) == 3
    assert ts.eval_variables()['w'] is not module.w
    np.testing.assert_array_equal(ts.eval_variables()['w'].numpy(),
                                  ts.ema_params['w'].numpy())
    np.testing.assert_array_equal(ts.train_variables()['w'].numpy(),
                                  module.w.detach().numpy())


class NoHostRead(TorchDispatchMode):
    """Raises on the two ops through which a tensor's value reaches the
    host: ``aten._local_scalar_dense`` (``.item()``, ``int()``,
    ``float()``, ``.tolist()`` of a device tensor) and ``aten.is_nonzero``
    (``bool()``). A step that passes under it makes no host read, so a
    CUDA graph can capture it."""

    READS = (torch.ops.aten._local_scalar_dense.default,
             torch.ops.aten.is_nonzero.default)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.READS:
            raise AssertionError('host read: {}'.format(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize('opt_type,mu_dtype', [
    ('adam_optimizer', None), ('adam_optimizer', 'bfloat16'),
    ('momentum_optimizer', None), ('rms_prop_optimizer', None),
    ('gradient_descent_optimizer', None)])
def test_update_reads_nothing_on_the_host(opt_type, mu_dtype):
    """A clipped step, a step under the clip and a skipped non-finite step
    under NoHostRead, through TrainState.apply_gradients with the EMA;
    every state tensor is updated in place (the same tensor objects
    before and after)."""
    config = _train_config(opt_type, optimizer_mu_dtype=mu_dtype)
    tx, _, _, _ = optimizer.build_optimizer(config, clip_gradient_norm=1.0)
    module = torch.nn.Module()
    for k, s in SHAPES.items():
        setattr(module, k, torch.nn.Parameter(torch.ones(s)))
    state = TrainState.create(module, tx, use_ema=True)
    tensors = {id(t) for t in _state_tensors(state)}
    grads = _gradients(4, 3, nan_step=2)
    with NoHostRead():
        for g in grads:
            state.apply_gradients({k: torch.from_numpy(v)
                                   for k, v in g.items()}, tx, ema_decay=0.9)
    assert {id(t) for t in _state_tensors(state)} == tensors
    assert int(state.opt_state['count']) == 2
    assert int(state.opt_state['notfinite_count']) == 1
    assert not bool(state.opt_state['last_finite'])


def _state_tensors(state):
    out = list(state.params.values()) + list(state.ema_params.values())
    for value in state.opt_state.values():
        out.extend(value.values() if isinstance(value, dict) else [value])
    return out


@pytest.mark.parametrize('opt_type', ['adam_optimizer',
                                      'rms_prop_optimizer'])
def test_fifty_nonfinite_steps_in_a_row_as_masked_apply_if_finite(opt_type):
    """With the clip: 2 finite steps, 50 non-finite ones (all skipped),
    a finite one (applied, the run of skips reset), then 51 non-finite
    ones, of which the 51st goes through. Parameters after every step
    against the JAX package's masked_apply_if_finite over optax (NaN
    where it has NaN), and its counters at the end."""
    config = _train_config(opt_type)
    rng = np.random.RandomState(5)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}

    def finite():
        return {k: rng.randn(*s).astype(np.float32) for k, s in
                SHAPES.items()}

    def nonfinite(i):
        g = finite()
        g['c'][0, 1, i % 4] = np.inf if i % 2 else np.nan
        return g

    grads = ([finite() for _ in range(2)] +
             [nonfinite(i) for i in range(50)] + [finite()] +
             [nonfinite(i) for i in range(51)])
    want, jax_state = _run_jax(config, params, grads, 1.0)
    got, state = _run_torch(config, params, grads, 1.0)
    for t, (g, w) in enumerate(zip(got, want)):
        for k in SHAPES:
            np.testing.assert_allclose(g[k], w[k], rtol=2e-6, atol=1e-7,
                                       err_msg='{} step {}'.format(k, t))
    for t in range(2, 52):                      # the skipped run
        for k in SHAPES:
            np.testing.assert_array_equal(got[t][k], got[1][k])
    assert not np.isfinite(got[-1]['c']).all()
    assert np.isfinite(got[-2]['c']).all()
    found = {}
    weights._flax_opt_leaves(jax_state, found)
    assert int(state['notfinite_count']) == int(found['notfinite_count']) \
        == 51
    assert int(state['total_notfinite']) == int(found['total_notfinite']) \
        == 101
    assert set(found['counts']) == {int(state['count'])} == {4}
