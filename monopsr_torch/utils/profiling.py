"""Tracing and step-timing hooks.

Counterpart of ``monopsr_tpu/utils/profiling.py``: the reference's
observability is wall-clock step timing and GPU memory summaries; here
the equivalents are ``torch.profiler`` traces (a Chrome trace, viewable
in Perfetto or chrome://tracing), a simple step timer and the caching
allocator's statistics per card.
"""

import contextlib
import os
import time

import torch


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
