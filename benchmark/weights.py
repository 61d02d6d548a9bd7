"""The weights both sides start from, made from the seed on the card.

One ``torch.randn`` over every weight matrix and kernel at once, by a
``torch.Generator`` on the device, scaled in one multiply by a vector of
per-leaf scales (fan-in scaled normal for convolutions, Glorot's scale
for dense layers and the map heads, as the port's own initialiser
chooses); biases and batch-norm offsets and means 0, batch-norm scales
and variances 1. The names and shapes come from the reference net, whose
state dict has the port's names: the same dict loads into both.
"""

import math

import torch

# The map heads, initialised as dense layers are
_GLOROT = ('inst_xyz_map_local', 'valid_mask_maps')
# Vectors that start at 1: batch-norm scales and variances
_ONES = ('.scale', '.var', '.running_var', '.weight')


def make_state(reference_net, seed, device):
    """{name: tensor on ``device``} for every parameter and buffer of
    ``reference_net`` (which may lie on the meta device; integer buffers,
    batch-norm counters, are 0)."""
    shapes = {k: v for k, v in reference_net.state_dict().items()}
    random, scales = [], []
    for name, value in shapes.items():
        if value.dtype.is_floating_point and value.dim() >= 2:
            fan_in = value[0].numel()
            fan_out = value.shape[0] * (value[0, 0].numel()
                                        if value.dim() > 2 else 1)
            glorot = value.dim() == 2 or name.startswith(_GLOROT)
            scales.append(math.sqrt(2.0 / (fan_in + fan_out)) if glorot
                          else 1.0 / math.sqrt(fan_in))
            random.append(name)
    numels = [shapes[n].numel() for n in random]
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    flat = torch.randn(sum(numels), generator=gen, device=device)
    flat *= torch.tensor(scales, device=device).repeat_interleave(
        torch.tensor(numels, device=device))
    state = {n: piece.view(shapes[n].shape) for n, piece in zip(
        random, flat.split(numels))}
    for name, value in shapes.items():
        if name in state:
            continue
        if not value.dtype.is_floating_point:
            state[name] = torch.zeros(value.shape, dtype=value.dtype,
                                      device=device)
        else:
            state[name] = torch.full(
                value.shape, 1.0 if name.endswith(_ONES) else 0.0,
                dtype=value.dtype, device=device)
    return state
