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

Two entries, every tensor updated in place (a CUDA graph of the train
step replays its kernels on the tensors it captured, so a state held in
new tensors would never advance under replay):

- ``apply(grads, state, params, ema, ema_decay)``, the train step's:
  the update, the parameter add and the EMA. Where it runs what:
  - Adam on CUDA tensors: the hand-written kernels of
    ``ops/multi_tensor_adam`` (``csrc/multi_tensor_adam.cu``), three
    launches over every tensor; they take the tensors or raise, with no
    fallback. Each such call counts ``train.fused_update`` in ``times``.
  - CPU tensors, and momentum, RMSProp and SGD on any device: the plain
    twin ``apply_plain``, ``update`` followed by ``torch._foreach_*`` ops
    for the add and the EMA (a few launches per operation on a card).
- ``update(grads, state)``, optax's functional form: returns (updates,
  state) as a GradientTransformation does, the state written into the
  tensors it is given; its arithmetic runs as ``torch._foreach_*`` ops
  over all the tensors at once. The CPU parity tests hold it against
  optax; the kernels equal it bit for bit for a given global norm (their
  norm sums in another order).

No step reads a number on the host. Whether the gradients are finite,
their global norm, the update count, the learning rate and Adam's bias
corrections are float32 or int32 tensors on the parameters' device, as
optax computes them on its device; the clip and the skip of a
non-finite step are selections between device scalars:

- the clip divides by the norm and multiplies by the maximum, or by 1
  and 1 where the norm is under the maximum (optax's ``(g / norm) *
  max`` where it clips, ``g`` exactly where it does not);
- a non-finite step that is skipped (``skip_nonfinite_updates``) runs
  the update on zero gradients, with every decay set to 1 and the
  learning rate to 0: the moments keep their values and the updates are
  0, as the JAX package's ``masked_apply_if_finite`` keeps the old state
  and returns zeros. That equality needs a finite state; once a
  non-finite update went through (after 50 skipped in a row), the
  parameters are non-finite in both packages.

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

from monopsr_torch.ops import multi_tensor_adam
from monopsr_torch.utils import profiling

_INT32_MAX = 2 ** 31 - 1

# Adam's constants (optax.adam's defaults)
_B1, _B2, _EPS = 0.9, 0.999, 1e-8

# Non-finite steps skipped in a row before one is applied all the same
# (the JAX package builds masked_apply_if_finite with 50)
_MAX_CONSECUTIVE_ERRORS = 50

_DTYPES = {None: None, 'float32': torch.float32, 'bfloat16': torch.bfloat16,
           'float16': torch.float16}


def _safe_increment(count):
    """count + 1, saturating at the int32 maximum (optax.safe_increment),
    on count's device."""
    return torch.where(count < _INT32_MAX, count + 1, count)


def _f32(value, like):
    """A float32 scalar tensor on ``like``'s device (a fill, no copy from
    the host)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def build_learning_rate(opt_config):
    """Schedule: update count (updates applied so far: an int, or an int
    tensor) -> learning rate, a float32 scalar tensor on the count's
    device. 'constant' or 'exponential_decay': init * rate ** (count /
    steps), the exponent floored with ``staircase``, and init at count
    <= 0 (optax.exponential_decay), each operation in float32. The
    function's ``kernel_args`` give its numbers to the kernels of
    ``ops/multi_tensor_adam``, which compute it on the device."""
    lr_type = opt_config['learning_rate_type']

    def as_tensor(count):
        return count if torch.is_tensor(count) else torch.tensor(
            count, dtype=torch.int32)

    if lr_type == 'constant':
        value = float(np.float32(opt_config['learning_rate']))

        def constant(count):
            return _f32(value, as_tensor(count))
        constant.kernel_args = dict(lr_type=0, lr=value, decay_steps=1.0,
                                    decay_rate=1.0, staircase=0)
        return constant

    if lr_type == 'exponential_decay':
        init = float(np.float32(opt_config['initial_learning_rate']))
        steps = float(np.float32(opt_config['decay_steps']))
        rate = float(np.float32(opt_config['decay_factor']))
        staircase = bool(opt_config.get('staircase', True))

        def exponential_decay(count):
            count = as_tensor(count)
            # a divisor on the device divides (a host scalar would
            # multiply by its reciprocal on a CUDA device)
            p = count.float() / _f32(steps, count)
            if staircase:
                p = torch.floor(p)
            return torch.where(count <= 0, init, init * torch.pow(rate, p))
        exponential_decay.kernel_args = dict(
            lr_type=1, lr=init, decay_steps=steps, decay_rate=rate,
            staircase=int(staircase))
        return exponential_decay

    raise ValueError('Invalid learning rate type: ' + str(lr_type))


def _where(keep, value, otherwise):
    """``value``, or ``otherwise`` where the step is skipped; ``value``
    itself when no step can be skipped (``keep`` None)."""
    return value if keep is None else torch.where(keep, value, otherwise)


class Optimizer:
    """clip_by_global_norm (optional) -> one of adam / momentum / rmsprop /
    sgd -> apply-if-finite (optional), as build_optimizer chains them.

    ``times``: the ``profiling.StageTimes`` that ``apply`` counts
    ``train.fused_update`` in (an owner may replace it with its own)."""

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
        # the decay of a moment stored in mu_dtype, rounded to that dtype
        stored_decay = {'adam': 0.9, 'momentum': momentum}.get(opt_type)
        self._mu_decay = stored_decay
        if mu_dtype not in (None, torch.float32) and stored_decay is not None:
            self._mu_decay = float(torch.tensor(stored_decay, dtype=mu_dtype))
        self.times = profiling.StageTimes()
        # the device tables that captured graphs of the kernels read
        self._kept_tables = []

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

    @staticmethod
    def _decay(stored, decay, keep):
        """decay * t for each stored moment t (1 * t on a skipped step),
        in float32: in place for a float32 moment, which is returned; a
        moment stored in a narrower dtype (its decay already rounded to
        that dtype) yields float32 copies, which ``_store`` writes back."""
        decay = _where(keep, decay, 1.0)
        if stored[0].dtype == torch.float32:
            torch._foreach_mul_(stored, decay)
            return stored
        return torch._foreach_mul([t.float() for t in stored], decay)

    @staticmethod
    def _store(stored, values):
        """Writes float32 ``values`` into the stored moments (rounding to
        their dtype); nothing to do when they are the same tensors."""
        if values is not stored:
            torch._foreach_copy_(stored, values)

    def _inner(self, g, state, names, count_inc, keep):
        """The optimizer step on the (clipped) gradient list g: updates
        the moments in place and returns the updates list."""
        neg_lr = _where(keep, -self.schedule(state['count']), 0.0)
        moment = {key: [state[key][n] for n in names]
                  for key in self._moments()}

        if self.opt_type == 'adam':
            c = count_inc.float()
            correct1 = 1.0 - torch.pow(_B1, c)
            correct2 = 1.0 - torch.pow(_B2, c)
            mu = self._decay(moment['mu'], self._mu_decay, keep)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1 - _B1))
            nu = self._decay(moment['nu'], _B2, keep)
            torch._foreach_add_(nu, torch._foreach_mul(
                torch._foreach_mul(g, g), 1 - _B2))
            denom = torch._foreach_div(nu, correct2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, _EPS)
            updates = torch._foreach_div(mu, correct1)
            torch._foreach_div_(updates, denom)
            torch._foreach_mul_(updates, neg_lr)
            self._store(moment['mu'], mu)
        elif self.opt_type == 'momentum':
            trace = self._decay(moment['trace'], self._mu_decay, keep)
            torch._foreach_add_(trace, g)
            updates = torch._foreach_mul(trace, neg_lr)
            self._store(moment['trace'], trace)
        elif self.opt_type == 'rmsprop':
            nu = self._decay(moment['nu'], self.decay, keep)
            torch._foreach_add_(nu, torch._foreach_mul(
                torch._foreach_mul(g, g), 1 - self.decay))
            scale = torch._foreach_add(nu, self.eps)
            for s in scale:
                s.rsqrt_()
            updates = torch._foreach_mul(scale, g)
            torch._foreach_mul_(updates, neg_lr)
            if self.momentum is not None:
                trace = self._decay(moment['trace'], self.momentum, keep)
                torch._foreach_add_(trace, updates)
                # the trace is the update; a skipped step returns zeros
                updates = (trace if keep is None else
                           torch._foreach_mul(trace, keep.float()))
        else:
            updates = torch._foreach_mul(g, neg_lr)
        return updates

    def update(self, grads, state):
        """(updates, state), ``state`` updated in place. With
        skip_nonfinite, a step whose raw gradients hold a NaN or inf
        yields zero updates and keeps the optimizer state (counters
        updated), unless more than _MAX_CONSECUTIVE_ERRORS (50) such
        steps ran in a row, as the JAX package's masked_apply_if_finite
        does."""
        names = list(grads)
        g = [grads[n] for n in names]
        keep = None
        if self.clip_norm or self.skip_nonfinite:
            flat = torch.cat([x.reshape(-1) for x in g])
        if self.clip_norm:
            norm = torch.sqrt((flat * flat).sum())
        if self.skip_nonfinite:
            finite = torch.isfinite(flat).all()
            notfinite = torch.where(
                finite, 0, _safe_increment(state['notfinite_count']))
            keep = finite | (notfinite > _MAX_CONSECUTIVE_ERRORS)
            state['notfinite_count'].copy_(notfinite)
            state['last_finite'].copy_(finite)
            state['total_notfinite'].copy_(torch.where(
                finite, state['total_notfinite'],
                _safe_increment(state['total_notfinite'])))
            # a skipped step runs on zero gradients (see the module)
            flat.masked_fill_(~keep, 0.0)
            g = [piece.view_as(x) for piece, x in zip(
                flat.split([x.numel() for x in g]), g)]
        if self.clip_norm:
            # (g / norm) * max where the norm reaches max, else g / 1 * 1
            unclipped = norm < self.clip_norm
            if keep is not None:
                unclipped = unclipped | ~keep
            g = torch._foreach_div(g, torch.where(unclipped, 1.0, norm))
            torch._foreach_mul_(g, torch.where(unclipped, 1.0,
                                               float(self.clip_norm)))
        count_inc = _safe_increment(state['count'])
        updates = self._inner(g, state, names, count_inc, keep)
        state['count'].copy_(_where(keep, count_inc, state['count']))
        return dict(zip(names, updates)), state

    def apply(self, grads, state, params, ema=None, ema_decay=None):
        """The train step's update, in place: the optimizer ``state``, the
        parameters ({name: tensor}, whose order the gradients follow)
        and, with ``ema`` and ``ema_decay``, the EMA of the updated
        parameters, e * decay + p * (1 - decay), also after a step the
        optimizer skipped. Adam on CUDA tensors launches the kernels of
        ``ops/multi_tensor_adam`` (or raises on a tensor they do not
        take); anything else runs ``apply_plain``."""
        names = list(params)
        device = params[names[0]].device if names else None
        if self.opt_type != 'adam' or device is None or \
                device.type != 'cuda':
            return self.apply_plain(grads, state, params, ema, ema_decay)
        use_ema = ema is not None and ema_decay is not None
        hyper = multi_tensor_adam.AdamHyper(
            clip=self.clip_norm or 0.0,
            skip_nonfinite=int(self.skip_nonfinite),
            max_errors=_MAX_CONSECUTIVE_ERRORS,
            b1=_B1, b2=_B2, mu_decay=self._mu_decay, nu_decay=_B2,
            one_minus_b1=1 - _B1, one_minus_b2=1 - _B2, eps=_EPS,
            ema_decay=ema_decay if use_ema else 0.0,
            one_minus_ema=1.0 - ema_decay if use_ema else 0.0,
            **self.schedule.kernel_args)
        counters = ({k: state[k] for k in ('notfinite_count', 'last_finite',
                                           'total_notfinite')}
                    if self.skip_nonfinite else None)
        multi_tensor_adam.adam_update(
            [grads[n] for n in names], [params[n] for n in names],
            [state['mu'][n] for n in names], [state['nu'][n] for n in names],
            state['count'], hyper, self._kept_tables, counters=counters,
            ema=[ema[n] for n in names] if use_ema else None)
        self.times.count('train.fused_update')
        return state

    def apply_plain(self, grads, state, params, ema=None, ema_decay=None):
        """``apply``'s plain twin on any device: ``update``, then the
        parameter add and the EMA as ``torch._foreach_*`` ops."""
        names = list(params)
        updates, _ = self.update({n: grads[n] for n in names}, state)
        tensors = [params[n] for n in names]
        torch._foreach_add_(tensors, [updates[n] for n in names])
        if ema is not None and ema_decay is not None:
            averages = [ema[n] for n in names]
            torch._foreach_mul_(averages, ema_decay)
            torch._foreach_add_(averages, torch._foreach_mul(
                tensors, 1.0 - ema_decay))
        return state


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
