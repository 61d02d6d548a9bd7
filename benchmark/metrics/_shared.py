"""What the readers share: the table of peaks."""

import json
import os


def peak_flops(dtype):
    with open(os.path.join(os.path.dirname(__file__), 'peaks.json')) as f:
        return json.load(f)['flops_per_s'][dtype]


def idle_pct(ctx):
    trace = ctx.get('trace')
    if not trace or not trace.get('window_s'):
        return None
    return 100.0 * (1.0 - trace['busy_s'] / trace['window_s'])
