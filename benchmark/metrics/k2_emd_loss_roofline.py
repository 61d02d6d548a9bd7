"""K2's share of its roofline in the traced stretch: the least time its
work needs on an H100 SXM over K2's device time by kernel name in the
trace (the harness's 'emd_loss' group: ``sweep_kernel<true>``, the
``emd_loss`` launch of the ``'emd'`` loss's forward).

The least time of one launch is the larger of three terms (a frozen copy
of the port's ``utils/profiling.emd_bound_ms`` at K2's figures): the
bytes it must move (both clouds in; the cost and the four gradient
accumulators out, 1 + 4 (n + m) floats a pair) over the memory rate; 21
special-function results per element (10 exps, 11 roots) at 16 per clock
per SM; 230 float32 operations per element at the float32 peak. Every
launch is counted at the train step's shape, ``PAIRS`` cloud pairs of
``POINTS`` points each (one image x 32 boxes, 48 x 48 maps) with all
their points: the loss matches the masked clouds' zero points too. The
chip's figures are the published ones (``peaks.json``), not the clock a
run reports.
"""

import json
import os

from benchmark import harness

PAIRS = 32
POINTS = 48 * 48
_SFU_PER_ELEMENT = 21
_FP32_PER_ELEMENT = 230


def bound_s(b, n, m, peaks):
    elems = float(b) * n * m
    bytes_s = (4.0 * b * (n + m) * 3 + 4.0 * b * (1 + 4 * (n + m))) / \
        peaks['hbm_bytes_per_s']
    sfu_s = elems * _SFU_PER_ELEMENT / (
        16.0 * peaks['sm_count'] * peaks['max_sm_clock_mhz'] * 1e6)
    fp32_s = elems * _FP32_PER_ELEMENT / peaks['flops_per_s']['float32']
    return max(bytes_s, sfu_s, fp32_s)


def read(ctx):
    trace = ctx.get('trace')
    if not trace or not trace.get('kernels'):
        return None
    launches = [seconds for name, seconds in trace['kernels']
                if harness.kernel_group(name) == 'emd_loss']
    if not launches:
        return None
    with open(os.path.join(os.path.dirname(__file__), 'peaks.json')) as f:
        peaks = json.load(f)
    bound = len(launches) * bound_s(PAIRS, POINTS, POINTS, peaks)
    return 100.0 * bound / sum(launches)
