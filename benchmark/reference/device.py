"""Small constant tensors of host numbers, kept per device (the copied
modules build their channel means and normalisers through it)."""

import torch

_CONSTANTS = {}


def constant(values, dtype, device):
    """A 1-D tensor of ``values`` on ``device``, made once and kept."""
    key = (tuple(values), dtype, torch.device(device))
    tensor = _CONSTANTS.get(key)
    if tensor is None:
        tensor = _CONSTANTS[key] = torch.tensor(key[0], dtype=dtype,
                                                device=device)
    return tensor
