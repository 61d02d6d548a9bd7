"""Share of the traced window in which no operation ran on the card:
one minus the union of the device intervals of torch.profiler's CUDA
timeline over the window's length."""

from benchmark.metrics import _shared


def read(ctx):
    if ctx.get('kind') != 'train':
        return None
    return _shared.idle_pct(ctx)
