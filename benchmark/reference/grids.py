"""Sampling grids computed as the JAX package computes them.

``torch.linspace`` and ``jnp.linspace`` round differently in float32
(torch steps from both ends; jax blends ``start * (1 - t) + stop * t``).
A sampling coordinate off by one ulp moves a bilinear sample by up to
|pixel step| * ulp, so the ported crop/resize/projection grids use the
JAX formula.
"""

import torch


def linspace(start, stop, num, device=None):
    """float32 jnp.linspace(start, stop, num) with endpoint=True. Made on
    ``device`` without a copy from host memory (a fill for the end)."""
    if num == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    out = start * (1 - step) + stop * step
    end = torch.full((1,), stop, dtype=torch.float32, device=device)
    return torch.cat([out, end])
