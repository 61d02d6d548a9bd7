"""What every cell shares: the spec, the environment, the card, spans,
the traced window's reduction, the metric readers and the result line.

The harness is driven by data. ``BENCHMARK.json`` names the cell; the
cell names a configuration (``benchmark/configs/<config>.json``, found
through the spec's ``file``) and a traffic mix
(``benchmark/workloads/<traffic>.json``); the mix's ``kind`` names the
driver (``benchmark/drivers/<kind>.py``); every metric the spec lists
for the cell is read by ``benchmark/metrics/<metric name>.py``; the
limits of the cell's comparison are ``benchmark/limits/<cell>.json``.
A later cell, mix, configuration or metric is a file of its own and an
entry in the spec.
"""

import contextlib
import importlib
import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# Top-level module names the process may not hold once the window closed
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'monopsr_tpu')
CACHE_DIR = os.path.join(ROOT, 'build', 'benchmark_cache')

# Kernel-name substrings that group the device's time (first match wins);
# the port's ``utils/profiling.KERNEL_GROUPS``, with cuBLAS's nvjet
# kernels, the backward's wgrad, copies and the foreach updates added
KERNEL_GROUPS = (
    ('emd_kernel', ('sweep_kernel<false>', 'emd_cost_fused')),
    ('emd_loss', ('sweep_kernel<true>', 'emd_loss')),
    ('convolution', ('fprop', 'dgrad', 'wgrad', 'conv', 'cudnn',
                     'implicit_gemm')),
    ('matmul', ('gemm', 'cutlass', 'cublas', 'nvjet')),
    ('foreach (optimizer, EMA)', ('multi_tensor_apply',)),
    ('gather/scatter', ('index', 'gather', 'scatter')),
    ('reduction', ('reduce',)),
    ('copy/cast', ('copy', 'Memcpy', 'Memset')),
    ('elementwise', ('elementwise',)),
)


class Refused(Exception):
    """A run that may print no result: no card, too few cards, a missing
    program, or a forbidden module loaded."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of the spec, with its configuration, mix and limits."""

    def __init__(self, name, spec=None, config=None, traffic=None,
                 limits=None):
        self.spec = spec or load_json(os.path.join(ROOT, 'BENCHMARK.json'))
        cells = {w['name']: w for w in self.spec['workloads']}
        if name not in cells:
            raise Refused('no workload {!r} in BENCHMARK.json (has {})'.format(
                name, sorted(cells)))
        self.name = name
        self.entry = cells[name]
        configs = {c['name']: c for c in self.spec['configs']}
        self.config = config or load_json(os.path.join(
            ROOT, configs[self.entry['config']]['file']))
        self.traffic = traffic or load_json(os.path.join(
            BENCH_DIR, 'workloads', self.entry['traffic'] + '.json'))
        path = os.path.join(BENCH_DIR, 'limits', name + '.json')
        if limits is None:
            limits = load_json(path) if os.path.exists(path) else {}
        self.limits = limits
        self.chips = int(self.entry['chips'])

    @property
    def experiment(self):
        return self.config['experiment']

    def metrics(self, section):
        """The spec's ``section`` metrics this cell reports."""
        return [m for m in self.spec[section]
                if 'workloads' not in m or self.name in m['workloads']]


def set_environment():
    """Fixed cache directories inside the checkout, and no JAX behind a
    library's back."""
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'
    for key, sub in (('TRITON_CACHE_DIR', 'triton'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('CUDA_CACHE_PATH', 'nv')):
        os.environ[key] = os.path.join(CACHE_DIR, sub)


def require_cards(count):
    """torch, once the card count is checked."""
    import torch
    if not torch.cuda.is_available():
        raise Refused('torch.cuda.is_available() is false: no card')
    if torch.cuda.device_count() < count:
        raise Refused('the cell asks for {} cards, {} visible'.format(
            count, torch.cuda.device_count()))
    return torch


def forbidden_modules():
    return sorted(name for name in list(sys.modules)
                  if name.split('.')[0] in FORBIDDEN)


def load_reader(name):
    """``benchmark/metrics/<name>.py``'s ``read``."""
    path = os.path.join(BENCH_DIR, 'metrics', name + '.py')
    spec = importlib.util.spec_from_file_location(
        'benchmark_metric_' + name.replace('.', '_'), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(kind):
    return importlib.import_module('benchmark.drivers.' + kind)


# -- spans and the traced window -------------------------------------------

class Spans:
    """Named host spans around calls into the program's layers, as
    ``torch.profiler.record_function`` ranges, so that they share the
    trace's clock; free when not tracing."""

    PREFIX = 'bench/'

    def __init__(self, enabled):
        self.enabled = enabled

    def __call__(self, name):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(self.PREFIX + name)

    def wrap(self, fn, name):
        """``fn`` with each call inside span ``name``."""
        def wrapped(*args, **kwargs):
            with self(name):
                return fn(*args, **kwargs)
        return wrapped


def kernel_group(name):
    return next((group for group, keys in KERNEL_GROUPS
                 if any(k in name for k in keys)), 'other')


def _merge(intervals):
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def traced(fn, spans):
    """Runs ``fn()`` under ``torch.profiler`` (host and card) inside the
    span 'traced_window' and reduces the trace: {'window_s', 'busy_s'
    (the union of the device's operations), 'kernels' [(name, seconds)],
    'device_ops' [[group, seconds]] (largest ten), 'idle_gaps' [[host
    spans open, seconds]] (largest ten)}. Returns (fn's result, that)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with spans('traced_window'):
            result = fn()
            torch.cuda.synchronize()
    events = prof.events()
    window = None
    host, device = [], []
    for evt in events:
        start, end = evt.time_range.start, evt.time_range.end
        if evt.device_type == DeviceType.CUDA:
            # the card's copies of host annotations are not device work
            if not (getattr(evt, 'is_user_annotation', False) or
                    evt.name.startswith(Spans.PREFIX)):
                device.append((start, end, evt.name))
        elif evt.name == Spans.PREFIX + 'traced_window':
            window = (start, end)
        elif evt.name.startswith(Spans.PREFIX):
            host.append((start, end, evt.name[len(Spans.PREFIX):]))
    if window is None or not device:
        return result, None
    lo, hi = window
    device = [(max(s, lo), min(e, hi), n) for s, e, n in device
              if e > lo and s < hi]
    busy = _merge([(s, e) for s, e, _ in device])
    groups, gaps = {}, {}
    for s, e, n in device:
        groups[kernel_group(n)] = groups.get(kernel_group(n), 0.0) + (
            e - s) / 1e6
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for start, end in zip(edges[0::2], edges[1::2]):
        if end <= start:
            continue
        mid = (start + end) / 2
        open_ = sorted({n for s, e, n in host if s <= mid < e}) or ['none']
        key = '+'.join(open_)
        gaps[key] = gaps.get(key, 0.0) + (end - start) / 1e6

    def top(d, n=10):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:n]
    names = {}
    for s, e, n in device:
        names[n] = names.get(n, 0.0) + (e - s) / 1e6
    for name, seconds in top(names, 15):
        print('traced: {:.6f} s {} {}'.format(seconds, kernel_group(name),
                                              name[:150]), file=sys.stderr)
    return result, {
        'window_s': (hi - lo) / 1e6,
        'busy_s': sum(e - s for s, e in busy) / 1e6,
        'kernels': [(n, (e - s) / 1e6) for s, e, n in device],
        'device_ops': top(groups),
        'idle_gaps': top(gaps),
    }


# -- the result --------------------------------------------------------------

def result_line(correct, attempted, failed, metrics, device, checks,
                breakdown=None):
    """The result object, the numbers compared last."""
    out = {'correct': bool(correct), 'attempted': int(attempted),
           'failed': int(failed), 'metrics': metrics, 'device': device}
    if breakdown is not None:
        out['breakdown'] = breakdown
    out['compared'] = {name: {'value': value, 'limit': limit}
                       for name, value, limit in checks}
    return out
