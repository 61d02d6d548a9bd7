"""Optimizer construction from the train_config, as optax defines it.

Counterpart of ``monopsr_tpu/train/optimizer.py``, written out in torch
without ``torch.optim``: the update rules below are optax's, whose
constants and orders differ from torch's optimizers (RMSProp's eps sits
inside the root and its second moment starts at 0; Adam's eps is
outside; global-norm clipping scales by max / norm only when the norm
reaches max, with no 1e-6). The ``train_config`` is plain nested dicts,
as in the YAML:

    {'optimizer': {'optimizer_type': 'adam_optimizer',
                   'adam_optimizer': {'learning_rate_type': ...}},
     'optimizer_mu_dtype': None, 'skip_nonfinite_updates': True}

The optimizer is functional, like an optax GradientTransformation:
``init(params)`` returns the state and ``update(grads, state)`` returns
(updates, new state); params, grads and updates are {name: tensor}
dicts. The arithmetic runs as ``torch._foreach_*`` ops over all the
tensors at once (a few launches per operation, not one per tensor).
Each step reads three numbers on the host (whether every gradient is
finite, the global norm, the update count): the clip and the skip of a
non-finite step are host decisions, and the learning rate and Adam's
bias corrections are float32 numbers computed there, as optax computes
them on the device.

A moment stored in ``optimizer_mu_dtype`` (bfloat16) is decayed as the
JAX package's jitted step decays it: the decay rounded to bfloat16
(JAX's weak typing makes 0.9 a bfloat16 0.8984375), the product taken in
float32 (XLA fuses it unrounded), the moment rounded when stored.

State keys: ``count`` (int32, updates applied so far; optax keeps one
count in the optimizer and one in the schedule, which always agree),
``mu``/``nu`` (Adam), ``nu`` (RMSProp), ``trace`` (momentum, and
RMSProp's momentum), and with ``skip_nonfinite_updates`` the
apply-if-finite counters ``notfinite_count``, ``last_finite`` and
``total_notfinite``.
"""

import numpy as np
import torch

_INT32_MAX = 2 ** 31 - 1

# Non-finite steps skipped in a row before one is applied all the same
# (the JAX package builds masked_apply_if_finite with 50)
_MAX_CONSECUTIVE_ERRORS = 50

_DTYPES = {None: None, 'float32': torch.float32, 'bfloat16': torch.bfloat16,
           'float16': torch.float16}


def _safe_increment(count):
    """count + 1, saturating at the int32 maximum (optax.safe_increment)."""
    return min(count + 1, _INT32_MAX)


def build_learning_rate(opt_config):
    """Schedule: update count (updates applied so far) -> learning rate,
    a float32 value. 'constant' or 'exponential_decay':
    init * rate ** (count / steps), the exponent floored with
    ``staircase``, and init at count <= 0 (optax.exponential_decay)."""
    lr_type = opt_config['learning_rate_type']
    f32 = np.float32

    if lr_type == 'constant':
        value = float(f32(opt_config['learning_rate']))
        return lambda count: value

    if lr_type == 'exponential_decay':
        init = f32(opt_config['initial_learning_rate'])
        steps = f32(opt_config['decay_steps'])
        rate = f32(opt_config['decay_factor'])
        staircase = bool(opt_config.get('staircase', True))

        def exponential_decay(count):
            count = int(count)
            if count <= 0:
                return float(init)
            p = f32(count) / steps
            if staircase:
                p = np.floor(p)
            return float(init * rate ** p)
        return exponential_decay

    raise ValueError('Invalid learning rate type: ' + str(lr_type))


def _decayed(tensors, decay, dtype):
    """decay * t for each stored moment t, in float32; a moment stored in
    a narrower dtype takes the decay rounded to that dtype."""
    if dtype is None or dtype == torch.float32:
        return torch._foreach_mul(tensors, decay)
    decay = float(torch.tensor(decay, dtype=dtype))
    return torch._foreach_mul([t.float() for t in tensors], decay)


def _stored(tensors, dtype):
    if dtype is None or dtype == torch.float32:
        return tensors
    return [t.to(dtype) for t in tensors]


class Optimizer:
    """clip_by_global_norm (optional) -> one of adam / momentum / rmsprop /
    sgd -> apply-if-finite (optional), as build_optimizer chains them."""

    def __init__(self, opt_type, schedule, clip_norm=None, mu_dtype=None,
                 momentum=None, decay=0.9, eps=1.0, skip_nonfinite=True):
        if opt_type not in ('adam', 'momentum', 'rmsprop', 'sgd'):
            raise ValueError('Invalid optimizer type: ' + str(opt_type))
        self.opt_type = opt_type
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.mu_dtype = mu_dtype
        self.momentum = momentum
        self.decay = decay
        self.eps = eps
        self.skip_nonfinite = skip_nonfinite

    def _moments(self):
        """State entries holding one tensor per parameter, with the dtype
        each is stored in (None: the parameter's)."""
        if self.opt_type == 'adam':
            return {'mu': self.mu_dtype, 'nu': None}
        if self.opt_type == 'momentum':
            return {'trace': self.mu_dtype}
        if self.opt_type == 'rmsprop':
            out = {'nu': None}
            if self.momentum is not None:
                out['trace'] = None
            return out
        return {}

    def init(self, params):
        device = next(iter(params.values())).device
        zero = torch.zeros((), dtype=torch.int32, device=device)
        state = {'count': zero.clone()}
        for key, dtype in self._moments().items():
            state[key] = {name: torch.zeros_like(p, dtype=dtype or p.dtype)
                          for name, p in params.items()}
        if self.skip_nonfinite:
            state['notfinite_count'] = zero.clone()
            state['last_finite'] = torch.ones((), dtype=torch.bool,
                                              device=device)
            state['total_notfinite'] = zero.clone()
        return state

    def _inner(self, names, g, state, count, norm):
        """The clipped optimizer step on gradient list g: (updates list,
        new inner state)."""
        if self.clip_norm and not norm < self.clip_norm:
            g = torch._foreach_mul(torch._foreach_div(g, norm),
                                   self.clip_norm)
        neg_lr = -self.schedule(count)
        count_inc = _safe_increment(count)
        new = {'count': torch.full_like(state['count'], count_inc)}
        moment = {key: [state[key][n] for n in names]
                  for key in self._moments()}

        if self.opt_type == 'adam':
            b1, b2, eps = 0.9, 0.999, 1e-8
            c = np.float32(count_inc)
            correct1 = float(np.float32(1) - np.float32(b1) ** c)
            correct2 = float(np.float32(1) - np.float32(b2) ** c)
            mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                    _decayed(moment['mu'], b1, self.mu_dtype))
            nu = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                torch._foreach_mul(moment['nu'], b2))
            denom = torch._foreach_add(
                torch._foreach_sqrt(torch._foreach_div(nu, correct2)), eps)
            updates = torch._foreach_mul(torch._foreach_div(
                torch._foreach_div(mu, correct1), denom), neg_lr)
            new['mu'] = _stored(mu, self.mu_dtype)
            new['nu'] = nu
        elif self.opt_type == 'momentum':
            trace = torch._foreach_add(
                g, _decayed(moment['trace'], self.momentum, self.mu_dtype))
            updates = torch._foreach_mul(trace, neg_lr)
            new['trace'] = _stored(trace, self.mu_dtype)
        elif self.opt_type == 'rmsprop':
            nu = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.decay),
                torch._foreach_mul(moment['nu'], self.decay))
            scale = [torch.rsqrt(v) for v in torch._foreach_add(nu, self.eps)]
            updates = torch._foreach_mul(torch._foreach_mul(scale, g), neg_lr)
            if self.momentum is not None:
                updates = torch._foreach_add(
                    updates, torch._foreach_mul(moment['trace'],
                                                self.momentum))
                new['trace'] = updates
            new['nu'] = nu
        else:
            updates = torch._foreach_mul(g, neg_lr)
        for key in self._moments():
            new[key] = dict(zip(names, new[key]))
        return updates, new

    def update(self, grads, state):
        """(updates, new state). With skip_nonfinite, a step whose raw
        gradients hold a NaN or inf yields zero updates and keeps the old
        optimizer state (counters updated), unless more than
        _MAX_CONSECUTIVE_ERRORS (50) such steps ran in a row, as the JAX
        package's masked_apply_if_finite does."""
        names = list(grads)
        g = [grads[n] for n in names]
        finite, norm = True, None
        if self.clip_norm or self.skip_nonfinite:
            flat = torch.cat([x.reshape(-1) for x in g])
            finite, norm = torch.stack([
                torch.isfinite(flat).all().float(),
                torch.sqrt((flat * flat).sum())]).tolist()
            finite = bool(finite)
            del flat
        count = int(state['count'])
        new = dict(state)
        if self.skip_nonfinite:
            notfinite = (0 if finite else
                         _safe_increment(int(state['notfinite_count'])))
            new['notfinite_count'] = torch.full_like(
                state['notfinite_count'], notfinite)
            new['last_finite'] = torch.full_like(state['last_finite'], finite)
            if not finite:
                new['total_notfinite'] = torch.full_like(
                    state['total_notfinite'],
                    _safe_increment(int(state['total_notfinite'])))
            if notfinite and notfinite <= _MAX_CONSECUTIVE_ERRORS:
                return {n: torch.zeros_like(x) for n, x in grads.items()}, new
        updates, inner = self._inner(names, g, state, count, norm)
        new.update(inner)
        return dict(zip(names, updates)), new


_TYPES = {'adam_optimizer': 'adam', 'momentum_optimizer': 'momentum',
          'rms_prop_optimizer': 'rmsprop',
          'gradient_descent_optimizer': 'sgd'}


def build_optimizer(train_config, clip_gradient_norm=1.0):
    """Builds the optimizer and schedule from a train_config dict.

    Returns:
        (tx, schedule, use_ema, ema_decay)
    """
    optimizer_config = train_config['optimizer']
    opt_type = optimizer_config['optimizer_type']
    if opt_type not in _TYPES:
        raise ValueError('Invalid optimizer type: ' + str(opt_type))
    opt_config = optimizer_config[opt_type]
    schedule = build_learning_rate(opt_config)
    kind = _TYPES[opt_type]

    momentum = None
    if kind == 'momentum':
        momentum = float(opt_config['momentum_optimizer_value'])
    elif kind == 'rmsprop':
        momentum = opt_config.get('momentum_optimizer_value', 0.9)
        momentum = None if momentum is None else float(momentum)

    tx = Optimizer(
        kind, schedule, clip_norm=clip_gradient_norm or None,
        mu_dtype=_DTYPES[train_config.get('optimizer_mu_dtype', None)],
        momentum=momentum, decay=float(opt_config.get('decay', 0.9)),
        eps=float(opt_config.get('epsilon', 1.0)),
        skip_nonfinite=bool(train_config.get('skip_nonfinite_updates',
                                             True)))
    use_ema = bool(opt_config.get('use_moving_average', False))
    ema_decay = float(opt_config.get('moving_average_decay', 0.9999))
    return tx, schedule, use_ema, ema_decay
