"""Model FLOPs of one train step, counted by FlopCounterMode over the
benchmark's reference at the cell's shapes (forward and backward
convolutions and matmuls, no recomputation), times the window's steps/s,
over the H100 SXM's dense peak in the configuration's compute dtype."""

from benchmark.metrics import _shared


def read(ctx):
    if ctx.get('kind') != 'train' or not ctx.get('flops_per_step') or \
            not ctx.get('window_s'):
        return None
    steps_per_s = ctx['steps'] / ctx['window_s']
    return 100.0 * ctx['flops_per_step'] * steps_per_s / _shared.peak_flops(
        ctx['compute_dtype'])
