"""The program's spans and counters, its traces, and the measurements of
the card.

Counterpart of ``monopsr_tpu/utils/profiling.py``: the reference's
observability is wall-clock step timing and GPU memory summaries; here
the equivalents are the program's own spans (``StageTimes``),
``torch.profiler`` traces (a Chrome trace, viewable in Perfetto or
chrome://tracing, with the program's spans beside the kernels) and the
caching allocator's statistics per card.

Spans and counters (``StageTimes``):

- Totals are always kept: each span adds its seconds and a count to its
  owner's ``StageTimes`` (the evaluator keeps one per pass), each
  ``count`` adds to a counter, from any thread.
- Intervals are kept only while recording is on (``recording()``, which
  ``trace`` turns on): every span closed in any thread of the process
  then keeps its name, its thread, its parent (the innermost span open
  on that thread when it opened), its ``item`` (the shared id of one
  frame, group or dispatch) and its start and end in nanoseconds of the
  wall clock (``time.time_ns``), the clock ``torch.profiler`` stamps its
  events with (``profiler_start_ns`` gives its origin). They go into one
  list per thread and are read out when the recording ends.
- Off, a span costs two ``perf_counter`` reads, the lock of its totals
  and one check of the switch; it keeps nothing.

The bench (``experiments/bench.py``) and ``chip_smoke.py`` measure with
the rest: ``time_cuda`` (CUDA events over a run of calls),
``profile_step`` (device time by kernel group and the device's busy
share of one step), ``nvidia_smi`` (the card's name, power limit and
clocks), ``emd_bound_ms`` (the EMD kernels' least time on a
card), ``count_flops`` (the convolutions' and matmuls' FLOPs of one
eager call) and ``spread`` (median and quartiles of repeated readings).
"""

import collections
import contextlib
import itertools
import json
import os
import subprocess
import threading
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


Interval = collections.namedtuple(
    'Interval', 'name item thread thread_name span parent start_ns end_ns')
Interval.__doc__ = """One span closed while recording was on: its name and
item, the native id and name of its thread, its own id and its parent's
(None at the top of its thread), and its start and end
(``time.time_ns``)."""

# The recording that is on, or None (``recording``)
_ACTIVE = None


class Recording:
    """The intervals of the spans closed while it is on, one list per
    thread; ``intervals`` holds them all, by start, once it has ended."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._logs = []
        self._ids = itertools.count()
        self.intervals = None

    def _thread(self):
        """(this thread's stack of open span ids, its list of intervals)."""
        local = self._local
        try:
            return local.stack, local.log
        except AttributeError:
            local.stack, local.log = [], []
            with self._lock:
                self._logs.append((threading.get_native_id(),
                                   threading.current_thread().name,
                                   local.log))
            return local.stack, local.log

    def _end(self):
        with self._lock:
            logs = list(self._logs)
        self.intervals = sorted(
            (Interval(name, item, tid, tname, span, parent, t0, t1)
             for tid, tname, log in logs
             for span, parent, name, item, t0, t1 in list(log)),
            key=lambda iv: (iv.start_ns, iv.span))


@contextlib.contextmanager
def recording():
    """Turns recording on for the block, in every thread of the process;
    yields the ``Recording``, whose ``intervals`` are read out when the
    block ends. Recordings do not nest."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError('a recording of the spans is on already')
    rec = _ACTIVE = Recording()
    try:
        yield rec
    finally:
        _ACTIVE = None
        rec._end()


class _Span:
    """A span of ``StageTimes.span``; ``seconds`` holds its length once it
    has closed."""

    __slots__ = ('_times', '_name', '_item', '_n', '_t0', '_rec', '_id',
                 '_parent', '_w0', 'seconds')

    def __init__(self, times, name, item, n):
        self._times = times
        self._name = name
        self._item = item
        self._n = n
        self.seconds = None

    def __enter__(self):
        rec = self._rec = _ACTIVE
        if rec is not None:
            stack, _ = rec._thread()
            self._parent = stack[-1] if stack else None
            self._id = next(rec._ids)
            stack.append(self._id)
            self._w0 = time.time_ns()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        self._times.add(self._name, self.seconds, self._n)
        rec = self._rec
        if rec is not None:
            end = time.time_ns()
            stack, log = rec._thread()
            stack.pop()
            log.append((self._id, self._parent, self._name, self._item,
                        self._w0, end))
        return False


class StageTimes:
    """Thread-safe totals of named spans (seconds and counts) and of
    counters, the program's recorder.

    ``prefix`` is the owner's own: ``per_item_ms`` gives the spans whose
    names start with it without it (the evaluator's 'eval.assembly' as
    'assembly').
    """

    def __init__(self, prefix=''):
        self.prefix = prefix
        self._lock = threading.Lock()
        self._seconds = collections.defaultdict(float)
        self._counts = collections.defaultdict(int)
        self._counters = collections.defaultdict(int)

    def add(self, stage, seconds, n=1):
        with self._lock:
            self._seconds[stage] += seconds
            self._counts[stage] += n

    def count(self, name, n=1):
        """Adds ``n`` to counter ``name``."""
        with self._lock:
            self._counters[name] += n

    def span(self, name, item=None, n=1):
        """A context manager that adds its seconds and ``n`` to ``name``'s
        totals, and keeps its interval while recording is on; ``item`` is
        the shared id of what it works on (a dataset index, a group or
        dispatch number)."""
        return _Span(self, name, item, n)

    def totals(self):
        """({span: (seconds, count)}, {counter: value})."""
        with self._lock:
            return ({name: (self._seconds[name], self._counts[name])
                     for name in self._seconds}, dict(self._counters))

    def per_item_ms(self):
        """{stage: avg milliseconds per counted item}, the owner's prefix
        taken off its own spans' names."""
        cut = len(self.prefix)
        with self._lock:
            return {(stage[cut:] if stage.startswith(self.prefix)
                     else stage): 1000.0 * self._seconds[stage] /
                    max(self._counts[stage], 1)
                    for stage in self._seconds}


def profiler_start_ns(prof):
    """The ``time.time_ns`` instant at which the event times of
    ``torch.profiler`` run ``prof`` (``evt.time_range``, microseconds)
    start."""
    return prof.profiler.kineto_results.trace_start_ns()


def _chrome_events(intervals, base_ns):
    """Chrome trace events of ``intervals``: one complete event ('X') per
    span on its own thread, timestamps in microseconds from ``base_ns``,
    and the name of each thread."""
    pid = os.getpid()
    events, threads = [], {}
    for iv in intervals:
        threads[iv.thread] = iv.thread_name
        events.append({
            'ph': 'X', 'cat': 'program', 'name': iv.name, 'pid': pid,
            'tid': iv.thread, 'ts': (iv.start_ns - base_ns) / 1e3,
            'dur': (iv.end_ns - iv.start_ns) / 1e3,
            'args': {'item': iv.item, 'span': iv.span,
                     'parent': iv.parent}})
    events.extend({'ph': 'M', 'name': 'thread_name', 'pid': pid, 'tid': tid,
                   'args': {'name': name}} for tid, name in threads.items())
    return events


@contextlib.contextmanager
def trace(logdir, enabled=True, name='trace'):
    """Captures a ``torch.profiler`` trace of the enclosed block, with the
    program's spans from every thread recorded meanwhile, and writes both
    to ``<logdir>/<name>.json``. The host is traced always, the cards
    once CUDA is initialized (their work is waited for at the end of the
    block)."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with recording() as rec, profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, name + '.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        chrome = json.load(f)
    chrome['traceEvents'].extend(_chrome_events(
        rec.intervals, int(chrome.get('baseTimeNanoseconds', 0))))
    with open(path, 'w') as f:
        json.dump(chrome, f)


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
