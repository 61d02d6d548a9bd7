"""Weight bridge between the JAX package's flax variables and the port.

The port's modules carry the same names as the flax modules, so a flax
path ``params/backbone/tower_crop/block1_unit1/conv1/kernel`` becomes the
state-dict key ``backbone.tower_crop.block1_unit1.conv1.weight``. The
leaves are converted as:

- conv kernels, HWIO -> OIHW;
- Dense kernels, (in, out) -> Linear weights (out, in);
- FrozenBatchNorm scale/bias (params) and mean/var (batch_stats) keep
  their names;
- the map decoder's flax BatchNorm scale/bias/mean/var become
  nn.BatchNorm2d's weight/bias/running_mean/running_var.

``to_flax_variables`` maps a state dict back, and
``train_state_from_flax`` carries a whole train state across (parameters,
batch stats, EMA, optimizer moments and counters), so that both packages
can start from the same point mid-training.

Input arrays are numpy (e.g. ``jax.device_get(variables)``); this module
imports neither jax, flax nor optax.
"""

import numpy as np
import torch

_DECODER = 'map_decoder'


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (key,)
        if isinstance(value, dict) or hasattr(value, 'items'):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def _is_decoder_bn(path):
    return _DECODER in path and path[-2].endswith('_bn')


def from_flax_variables(variables):
    """Maps ``{'params': ..., 'batch_stats': ...}`` (nested dicts of
    arrays) to a state dict for the matching monopsr_torch module."""
    state = {}
    for path, value in _flatten(variables.get('params', {})):
        *module, leaf = path
        if leaf == 'kernel':
            if value.ndim == 4:
                value = value.transpose(3, 2, 0, 1)      # HWIO -> OIHW
            elif value.ndim == 2:
                value = value.T                          # (in, out) -> (out, in)
            else:
                raise ValueError('Unexpected kernel rank at ' + '/'.join(path))
            leaf = 'weight'
        elif leaf == 'scale' and _is_decoder_bn(path):
            leaf = 'weight'
        state['.'.join(module + [leaf])] = torch.from_numpy(
            np.array(value, dtype=np.float32))
    decoder_bns = set()
    for path, value in _flatten(variables.get('batch_stats', {})):
        *module, leaf = path
        if _is_decoder_bn(path):
            leaf = {'mean': 'running_mean', 'var': 'running_var'}[leaf]
            decoder_bns.add('.'.join(module))
        state['.'.join(module + [leaf])] = torch.from_numpy(
            np.array(value, dtype=np.float32))
    for module in decoder_bns:
        state[module + '.num_batches_tracked'] = torch.tensor(0)
    return state


def _set(tree, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def to_flax_variables(state_dict):
    """The inverse of ``from_flax_variables``: a monopsr_torch state dict
    (tensors) -> ``{'params': ..., 'batch_stats': ...}`` nested dicts of
    float32 numpy arrays in flax's layout (kernels HWIO or (in, out)).
    ``num_batches_tracked`` has no flax counterpart and is dropped. A
    dict of parameters alone (an EMA, a moment) gives only 'params'."""
    params, stats = {}, {}
    for key, value in state_dict.items():
        *module, leaf = key.split('.')
        if leaf == 'num_batches_tracked':
            continue
        value = value.detach().float().cpu().numpy()
        path = tuple(module) + (leaf,)
        if leaf in ('running_mean', 'running_var'):
            _set(stats, module + [leaf[len('running_'):]], value)
            continue
        if leaf in ('mean', 'var'):
            _set(stats, module + [leaf], value)
            continue
        if leaf == 'weight':
            if value.ndim == 4:
                value, leaf = value.transpose(2, 3, 1, 0), 'kernel'
            elif value.ndim == 2:
                value, leaf = value.T, 'kernel'
            elif _is_decoder_bn(path):
                leaf = 'scale'
            else:
                raise ValueError('Unexpected weight at ' + key)
        _set(params, module + [leaf], np.ascontiguousarray(value))
    out = {'params': params}
    if stats:
        out['batch_stats'] = stats
    return out


def _flax_opt_leaves(node, found):
    """Walks an optax state (named tuples, numpy leaves) for the fields
    the port's optimizer keeps."""
    fields = getattr(node, '_fields', None)
    if fields is None:
        if isinstance(node, (tuple, list)):
            for item in node:
                _flax_opt_leaves(item, found)
        return
    for name in fields:
        value = getattr(node, name)
        if name in ('mu', 'nu', 'trace'):
            found[name] = value
        elif name == 'count':
            found.setdefault('counts', []).append(int(np.asarray(value)))
        elif name in ('notfinite_count', 'last_finite', 'total_notfinite'):
            found[name] = np.asarray(value)
        else:
            _flax_opt_leaves(value, found)


def train_state_from_flax(net, tx, step, params, batch_stats, opt_state,
                          ema_params=None):
    """A monopsr_torch TrainState over ``net`` that continues the JAX
    package's TrainState (its fields as numpy, e.g. from
    ``jax.device_get(state)``): the parameters and batch stats are loaded
    into ``net``; the EMA, the optimizer moments (Adam mu/nu, momentum
    and RMSProp traces), the update count and the apply-if-finite
    counters are carried across. ``tx`` is the port's optimizer built
    from the same train_config as the JAX one."""
    from monopsr_torch.train.train_state import TrainState

    net.load_state_dict(from_flax_variables(
        {'params': params, 'batch_stats': batch_stats}), strict=True)
    state = TrainState.create(net, tx, use_ema=ema_params is not None)
    state.step = int(np.asarray(step))
    found = {}
    _flax_opt_leaves(opt_state, found)
    counts = found.pop('counts', [])
    if len(set(counts)) > 1:
        raise ValueError('optax counts disagree: {}'.format(counts))

    def load(target, tree):
        for name, value in from_flax_variables({'params': tree}).items():
            target[name].copy_(value.to(target[name].dtype))

    with torch.no_grad():
        opt = state.opt_state
        if counts:
            opt['count'].fill_(counts[0])
        for key in ('mu', 'nu', 'trace'):
            if (key in found) != (key in opt):
                raise ValueError('optimizer state {} in one package '
                                 'only'.format(key))
            if key in found:
                load(opt[key], found[key])
        for key in ('notfinite_count', 'last_finite', 'total_notfinite'):
            if key in found:
                opt[key].fill_(found[key].item())
        if ema_params is not None:
            load(state.ema_params, ema_params)
    return state
