"""Pretrained backbone weights from an NPZ, into both towers.

Counterpart of ``monopsr_tpu/train/pretrained.py``: one pretrained
ResNet trunk initializes BOTH towers (``backbone.tower_crop`` and
``backbone.tower_full``). The NPZ is the JAX package's format, flat
'scope/leaf' arrays in flax's layout (e.g. 'block1_unit1/conv1/kernel',
HWIO), under data/pretrained/<name>.npz; ``weights.from_flax_variables``
maps each onto the port's state-dict names and layouts. A missing file
keeps the random init with a message, as in the JAX package: the file is
not in the repository and is never fetched.
"""

import os

import numpy as np
import torch

import monopsr_torch
from monopsr_torch import weights

# Leaves the JAX package keeps in batch_stats (FrozenBatchNorm's); the
# rest (kernel, scale, bias) are params
_STAT_LEAVES = ('mean', 'var')

# Tower module names under 'backbone'
_TOWERS = ('tower_crop', 'tower_full')


def load_npz_into_towers(tensors, npz_path):
    """Copies trunk weights from an NPZ into both towers.

    Args:
        tensors: {state-dict name: tensor} (a net's parameters and
            buffers), updated in place.
        npz_path: NPZ with keys like 'block1_unit1/conv1/kernel'.

    Returns:
        number of arrays loaded (keys the net lacks are skipped).
    """
    loaded = 0
    with np.load(npz_path) as data:
        for tower in _TOWERS:
            for key in data.files:
                parts = key.split('/')
                tree = {}
                node = tree.setdefault(
                    'batch_stats' if parts[-1] in _STAT_LEAVES else 'params',
                    {}).setdefault('backbone', {}).setdefault(tower, {})
                for part in parts[:-1]:
                    node = node.setdefault(part, {})
                node[parts[-1]] = data[key]
                (name, value), = weights.from_flax_variables(tree).items()
                if name not in tensors:
                    continue
                target = tensors[name]
                if tuple(target.shape) != tuple(value.shape):
                    raise ValueError('Shape mismatch for {}: {} vs {}'.format(
                        name, tuple(target.shape), tuple(value.shape)))
                with torch.no_grad():
                    target.copy_(value.to(target.dtype))
                loaded += 1
    return loaded


def maybe_load_pretrained(state, model_config):
    """Loads pretrained tower weights per the net_config, if available,
    into ``state`` (a TrainState) in place; the EMA starts from the
    loaded parameters. Returns ``state``."""
    net_config = getattr(model_config.net_config, model_config.net_type)
    weights_type = net_config.get('pretrained_weights_type')
    if not weights_type or weights_type in ('none', None):
        return state

    name = net_config.get('pretrained_weights_name')
    npz_path = os.path.join(monopsr_torch.data_dir(), 'pretrained',
                            '{}.npz'.format(name))
    if not os.path.exists(npz_path):
        print('[pretrained] {} not found; training from random init'
              .format(npz_path))
        return state

    n_params = load_npz_into_towers(state.params, npz_path)
    n_stats = load_npz_into_towers(state.batch_stats, npz_path)
    print('[pretrained] loaded {} param / {} stat arrays from {}'.format(
        n_params, n_stats, npz_path))
    if state.ema_params is not None:
        with torch.no_grad():
            for key, value in state.params.items():
                state.ema_params[key].copy_(value)
    return state
