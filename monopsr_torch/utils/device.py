"""Device selection for the port's entry points.

Counterpart of ``monopsr_tpu/utils/device_select.py``. The port's entry
points run on CUDA unless the caller asks for the CPU; a missing card is
an error, never a quiet fall back to the CPU.

The precision policy is set here too, since every entry point (the
three CLIs, ``trainer.train``, ``Evaluator``) resolves its device here:
on CUDA, float32 matmuls and convolutions run in float32, not in TF32,
as the card-against-CPU checks run them. The bfloat16 compute of a
config's towers and decoder is not affected.
"""

import torch


def set_float32_precision():
    """Turns TF32 off for cuBLAS matmuls and cuDNN convolutions (cuDNN
    allows it by default), for the whole process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
