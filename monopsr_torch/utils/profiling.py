"""Tracing, step timing and the measurements of the card.

Counterpart of ``monopsr_tpu/utils/profiling.py``: the reference's
observability is wall-clock step timing and GPU memory summaries; here
the equivalents are ``torch.profiler`` traces (a Chrome trace, viewable
in Perfetto or chrome://tracing), a simple step timer and the caching
allocator's statistics per card.

The bench (``experiments/bench.py``) and ``chip_smoke.py`` measure with
the rest: ``time_cuda`` (CUDA events over a run of calls),
``profile_step`` (device time by kernel group and the device's busy
share of one step), ``nvidia_smi`` (the card's name, power limit and
clocks), ``emd_bound_ms`` (the EMD kernels' least time on a
card), ``count_flops`` (the convolutions' and matmuls' FLOPs of one
eager call) and ``spread`` (median and quartiles of repeated readings).
"""

import contextlib
import os
import subprocess
import time

import numpy as np
import torch

# Kernel-name substrings that group a profile (first match wins)
KERNEL_GROUPS = (
    ('emd_kernel', ('sweep_kernel<false>', 'emd_cost_fused')),
    ('emd_loss', ('sweep_kernel<true>', 'emd_loss')),
    ('convolution', ('fprop', 'dgrad', 'conv', 'cudnn', 'implicit_gemm')),
    ('matmul', ('gemm', 'cutlass', 'cublas')),
    ('gather/scatter', ('index', 'gather', 'scatter')),
    ('reduction', ('reduce',)),
    ('copy/cast', ('copy',)),
    ('elementwise', ('elementwise',)),
)


@contextlib.contextmanager
def trace(logdir, enabled=True, name='trace'):
    """Captures a ``torch.profiler`` trace of the enclosed block and
    writes it to ``<logdir>/<name>.json``. The host is traced always, the
    cards once CUDA is initialized (their work is waited for at the end
    of the block)."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, name + '.json'))


class StepTimer:
    """Rolling steps/sec + wall-time bookkeeping."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._start = time.time()
        self._count = 0

    def tick(self, n=1):
        self._count += n

    def rate(self):
        elapsed = time.time() - self._start
        return self._count / elapsed if elapsed > 0 else 0.0

    def lap(self):
        rate = self.rate()
        self.reset()
        return rate


def device_memory_stats():
    """{'cuda:<i>': torch.cuda.memory_stats(i)} for each visible card
    (empty until the card's allocator is used), or {'cpu': None} without
    one, as the JAX package gives None where its backend has no
    statistics."""
    if not torch.cuda.is_available():
        return {'cpu': None}
    return {'cuda:{}'.format(i): torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}


def nvidia_smi(query):
    """The first card's fields ``query`` as ``nvidia-smi --query-gpu=<query>
    --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=' + query, '--format=csv,noheader'],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_cuda(fn, reps, warmup=1):
    """Mean ms per call of ``fn`` by CUDA events over ``reps`` calls in a
    row, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def emd_bound_ms(b, n, m, sm_count, sm_clock_mhz, fp32_per_element,
                 out_floats):
    """Least time for an EMD kernel's work on this card: the larger of
    the bytes it must move (both clouds in, ``out_floats`` float32 out)
    over the memory rate and its operations over the peak rate of their
    unit. Per element (b*n*m of them): 10 exps (rounds with a nonzero
    level) and 11 square roots or rsqrts on the special-function units
    (16 results per clock per SM on Hopper), and ``fp32_per_element``
    float32 operations at 67 TFLOP/s: ~129 for the metric (distance
    once, ~11 per round), ~230 for the loss (~9 more per round for the
    gradient accumulators). Returns (ms, 'bytes' or 'operations')."""
    elems = float(b) * n * m
    bytes_ms = (4.0 * b * (n + m) * 3 + 4.0 * out_floats) / 3.35e12 * 1e3
    sfu_ms = elems * 21 / (16.0 * sm_count * sm_clock_mhz * 1e6) * 1e3
    fp32_ms = elems * fp32_per_element / 67e12 * 1e3
    return max(bytes_ms, sfu_ms, fp32_ms), (
        'bytes' if bytes_ms >= max(sfu_ms, fp32_ms) else 'operations')


def profile_step(step, batch, top=12):
    """Device time by kernel over one call ``step(batch)`` on the card,
    from torch.profiler's CUPTI trace, and the device's busy share of the
    call's wall time; prints both. Returns (wall ms, busy ms, groups):
    ``groups`` maps each of ``KERNEL_GROUPS`` seen (or 'other') to (device
    ms, launches), largest first; busy is None and groups empty when the
    trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for avg in prof.key_averages():
        if avg.device_type == DeviceType.CUDA:
            us = getattr(avg, 'self_device_time_total', None)
            if us is None:
                us = getattr(avg, 'self_cuda_time_total', 0.0)
            rows.append((us / 1e3, avg.count, avg.key))
    if not rows:
        print('  profile: the trace holds no device time (not measured)')
        return wall_ms, None, {}
    busy = sum(r[0] for r in rows)
    print('  profile (one step under the profiler): wall {:.3f} ms, device '
          'busy {:.3f} ms ({:.1%}), {} kernel names'.format(
              wall_ms, busy, busy / wall_ms, len(rows)))
    groups = {}
    for ms, count, name in rows:
        group = next((g for g, keys in KERNEL_GROUPS if any(
            k in name for k in keys)), 'other')
        total, launches = groups.get(group, (0.0, 0))
        groups[group] = (total + ms, launches + count)
    groups = dict(sorted(groups.items(), key=lambda kv: -kv[1][0]))
    print('  by group: ' + ', '.join(
        '{} {:.3f} ms ({}x)'.format(g, ms, c)
        for g, (ms, c) in groups.items()))
    for ms, count, name in sorted(rows, reverse=True)[:top]:
        print('    {:9.3f} ms {:5d}x  {}'.format(ms, count, name[:110]))
    return wall_ms, busy, groups


def count_flops(fn, *args):
    """FLOPs of one eager call ``fn(*args)``, counted by
    ``torch.utils.flop_counter.FlopCounterMode``: convolutions, matmuls
    and their backward passes (2 per multiply-add), from the shapes each
    op runs at; elementwise work is not counted."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def spread(samples):
    """{'median', 'q1', 'q3', 'n'} of repeated readings (quartiles by
    linear interpolation, numpy's default)."""
    values = np.asarray(samples, np.float64)
    if values.size == 0:
        raise ValueError('spread of no samples')
    q1, median, q3 = np.percentile(values, [25, 50, 75])
    return {'median': float(median), 'q1': float(q1), 'q3': float(q3),
            'n': int(values.size)}
