"""PyTorch/CUDA port of MonoPSR for NVIDIA Hopper GPUs.

A second package beside ``monopsr_tpu`` (the JAX reference). Module paths
and names mirror the JAX package so each counterpart is easy to find:
``monopsr_torch.models.monopsr`` is the twin of
``monopsr_tpu.models.monopsr`` and so on. Public functions keep the JAX
package's NHWC layout; the conv stacks convert to NCHW inside.

The package imports torch only; it never imports jax or monopsr_tpu.
Entry points run on CUDA unless the caller passes ``device='cpu'``
(see ``monopsr_torch.utils.device``). The Pallas kernels of the JAX
package become hand-written CUDA kernels under ``csrc/``, built with
nvcc at first use (``monopsr_torch.ops.cuda_build``); the input
pipeline's PNG unfiltering and resize run in a host library beside them
(``csrc/image_host.cpp``), built with g++ at first use on every machine.

Path helpers as in the JAX package: every output location derives from
``<repo>/data/outputs/<config_name>/...``.
"""

import os


def root_dir():
    """Directory of the monopsr_torch package."""
    return os.path.dirname(os.path.abspath(__file__))


def top_dir():
    """Repository root (one level above the package)."""
    return os.path.dirname(root_dir())


def data_dir():
    """Data directory (detections, pretrained weights, outputs)."""
    return os.path.join(top_dir(), 'data')
