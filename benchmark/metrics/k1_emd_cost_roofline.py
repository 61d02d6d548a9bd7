"""K1's share of its roofline in the traced pass: the least time its
work needs on an H100 SXM over K1's device time by kernel name in the
trace.

The least time of one launch is the larger of three terms (a frozen copy
of the port's ``utils/profiling.emd_bound_ms``): the bytes both clouds
and the costs move over the memory rate; 21 special-function results per
element (10 exps, 11 roots) at 16 per clock per SM; 129 float32
operations per element at the float32 peak. Only the cloud pairs whose
slot holds a box count, each at its valid points (n points in each
cloud: n * n elements), as the reference's GT masks give them, so a
kernel that skips empty points is not credited with work it never had.
The chip's figures are the published ones (``peaks.json``), not the
clock a run reports.
"""

import json
import os

import numpy as np

_SFU_PER_ELEMENT = 21
_FP32_PER_ELEMENT = 129


def bound_s(valid_points, peaks):
    n = np.asarray(valid_points, np.float64)
    elems = float((n * n).sum())
    bytes_s = (4.0 * 2 * n.sum() * 3 + 4.0 * len(n)) / peaks['hbm_bytes_per_s']
    sfu_s = elems * _SFU_PER_ELEMENT / (
        16.0 * peaks['sm_count'] * peaks['max_sm_clock_mhz'] * 1e6)
    fp32_s = elems * _FP32_PER_ELEMENT / peaks['flops_per_s']['float32']
    return max(bytes_s, sfu_s, fp32_s)


def read(ctx):
    k1 = ctx.get('k1')
    if not k1 or not k1.get('kernel_s'):
        return None
    with open(os.path.join(os.path.dirname(__file__), 'peaks.json')) as f:
        peaks = json.load(f)
    bound = sum(bound_s(points, peaks) for points in k1['valid_points'])
    return 100.0 * bound / k1['kernel_s']
