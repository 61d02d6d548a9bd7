"""Device selection for the port's entry points.

Counterpart of ``monopsr_tpu/utils/device_select.py``. The port's entry
points run on CUDA unless the caller asks for the CPU; a missing card is
an error, never a quiet fall back to the CPU.

The precision policy is set here too, since every entry point (the
three CLIs, ``trainer.train``, ``Evaluator``, and each data-parallel
rank's process) resolves its device here:
on CUDA, float32 matmuls and convolutions run in float32, not in TF32,
as the card-against-CPU checks run them. The bfloat16 compute of a
config's towers and decoder is not affected.

``constant`` keeps the small tensors of host numbers that the step's
code builds (channel means, normalisers), one per device, so that a step
run again copies nothing from host memory: a CUDA graph capture of the
train step refuses a copy from pageable host memory.
"""

import torch


_CONSTANTS = {}


def constant(values, dtype, device):
    """A 1-D tensor of the host numbers ``values`` on ``device``, made at
    the first call for these values, dtype and device and kept: later
    calls return the same tensor, so no copy from the host runs (and a
    CUDA graph can capture the caller). Read it; never write into it."""
    key = (tuple(values), dtype, torch.device(device))
    tensor = _CONSTANTS.get(key)
    if tensor is None:
        tensor = _CONSTANTS[key] = torch.tensor(key[0], dtype=dtype,
                                                device=device)
    return tensor


def set_float32_precision():
    """Turns TF32 off for cuBLAS matmuls and cuDNN convolutions (cuDNN
    allows it by default), for the whole process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rank_device(device, rank, num_ranks):
    """The device of rank ``rank`` of ``num_ranks`` data-parallel ranks
    started on ``device``: ``cuda:<rank>`` when each rank has a card of
    its own, else the card ``device`` names (``cuda:0`` for ``cuda``),
    shared by the ranks, or the CPU."""
    device = torch.device(device)
    if device.type != 'cuda':
        return device
    if torch.cuda.device_count() >= num_ranks:
        return torch.device('cuda', rank)
    return torch.device('cuda', device.index or 0)


def visible_device_count(device):
    """Devices a data-parallel axis could span: the visible CUDA cards on
    CUDA, 1 on the CPU (as the JAX package counts ``jax.devices()``)."""
    return torch.cuda.device_count() if device.type == 'cuda' else 1


def resolve_device(device=None):
    """Maps None / 'cuda' / 'cuda:N' / 'cpu' (or a torch.device) to a
    torch.device. None means CUDA. Raises RuntimeError when CUDA is asked
    for and no card is visible. On CUDA it sets the float32 precision
    policy (``set_float32_precision``)."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA device requested but torch.cuda.is_available() is '
            'False; pass device="cpu" to run on the CPU')
    if device.type not in ('cuda', 'cpu'):
        raise ValueError('Unsupported device: {}'.format(device))
    if device.type == 'cuda':
        set_float32_precision()
    return device
