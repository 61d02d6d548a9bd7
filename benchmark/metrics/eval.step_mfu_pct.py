"""Model FLOPs of the forward at the configuration's boxes per image,
counted by FlopCounterMode over the benchmark's reference, times the
window's frames/s, over the H100 SXM's dense peak in the configuration's
compute dtype."""

from benchmark.metrics import _shared


def read(ctx):
    if ctx.get('kind') != 'eval' or not ctx.get('flops_per_frame') or \
            not ctx.get('window_s'):
        return None
    fps = ctx['units'] / ctx['window_s']
    return 100.0 * ctx['flops_per_frame'] * fps / _shared.peak_flops(
        ctx['compute_dtype'])
