"""The program's recorder (``utils.profiling``): its totals, its intervals
from every thread, and their clock against ``torch.profiler``'s.

The last tests are marked ``cuda``: a span around a kernel, on a card,
holds that kernel's interval on the trace's timeline and in the Chrome
trace ``profiling.trace`` writes. This file imports neither jax nor the
JAX package, so they also run with only PyTorch on the machine:

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""

import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from monopsr_torch.utils import profiling
from monopsr_torch.utils.profiling import StageTimes

# A program span and its record_function twin agree within this on the
# host (us)
HOST_US = 1000.0
# A span holds its kernel's interval within this on the card (us)
CARD_US = 100.0


def _work(times):
    with times.span('eval.outer', item=3, n=2):
        with times.span('eval.outer.inner', item=3):
            pass
        times.count('eval.frames', 4)
    with times.span('graph.capture'):
        pass


def _counts(times):
    spans, counters = times.totals()
    return {name: n for name, (_, n) in spans.items()}, counters


def test_recording_off_keeps_no_intervals_and_the_same_totals():
    off = StageTimes('eval.')
    _work(off)
    with profiling.recording() as rec:
        on = StageTimes('eval.')
        _work(on)
    _work(StageTimes())       # after the recording: nothing more kept
    assert _counts(off) == _counts(on) == (
        {'eval.outer': 2, 'eval.outer.inner': 1, 'graph.capture': 1},
        {'eval.frames': 4})
    assert [iv.name for iv in rec.intervals] == [
        'eval.outer', 'eval.outer.inner', 'graph.capture']
    outer, inner, capture = rec.intervals
    assert inner.parent == outer.span and outer.parent is None
    assert capture.parent is None and inner.item == outer.item == 3
    # the owner's prefix comes off its own spans only
    assert sorted(on.per_item_ms()) == ['graph.capture', 'outer',
                                        'outer.inner']
    spans, _ = off.totals()
    assert spans['eval.outer'][0] >= spans['eval.outer.inner'][0]


def test_recordings_do_not_nest():
    with profiling.recording():
        with pytest.raises(RuntimeError, match='on already'):
            with profiling.recording():
                pass
    with profiling.recording() as rec:
        pass
    assert rec.intervals == []


def test_spans_from_a_pool_worker_and_a_thread():
    times = StageTimes()

    def pooled():
        with times.span('pool', item=1):
            with times.span('pool.child', item=1):
                return threading.get_native_id()

    def plain():
        with times.span('thread', item=2):
            pass

    with profiling.recording() as rec:
        with times.span('main', item=0):
            with ThreadPoolExecutor(max_workers=1) as pool:
                pool_id = pool.submit(pooled).result(timeout=60)
            worker = threading.Thread(target=plain, name='plain worker')
            worker.start()
            worker.join(timeout=60)
            assert not worker.is_alive()
    got = {iv.name: iv for iv in rec.intervals}
    assert sorted(got) == ['main', 'pool', 'pool.child', 'thread']
    main = threading.get_native_id()
    assert got['main'].thread == main
    assert got['pool'].thread == got['pool.child'].thread == pool_id != main
    assert got['thread'].thread not in (main, pool_id)
    assert got['thread'].thread_name == 'plain worker'
    # parents are of the span's own thread
    assert got['pool'].parent is None and got['thread'].parent is None
    assert got['pool.child'].parent == got['pool'].span
    assert [got[n].item for n in ('main', 'pool', 'thread')] == [0, 1, 2]
    assert got['main'].start_ns <= got['pool'].start_ns <= \
        got['pool'].end_ns <= got['main'].end_ns


def _sandwich(times, i):
    """A program span around a ``record_function`` range around another
    program span: if the two clocks disagreed by more than ``HOST_US``,
    the range would stick out of the outer span or the inner span out of
    the range, whatever the host's delays between the stamps."""
    with times.span('outer', item=i), record_function('twin{}'.format(i)), \
            times.span('inner', item=i):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
        time.sleep(0.002)


def _assert_between(outer, twin, inner):
    """(start, end) of three nested ranges, in us of one timeline."""
    assert outer[0] - HOST_US <= twin[0] <= inner[0] + HOST_US
    assert inner[1] - HOST_US <= twin[1] <= outer[1] + HOST_US


def test_span_and_its_record_function_twin_share_the_clock():
    times = StageTimes()
    with profiling.recording() as rec, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            _sandwich(times, i)
    base = profiling.profiler_start_ns(prof)
    spans = {(iv.name, iv.item): ((iv.start_ns - base) / 1e3,
                                  (iv.end_ns - base) / 1e3)
             for iv in rec.intervals}
    twins = [evt for evt in prof.events() if evt.name.startswith('twin')]
    assert len(twins) == 3
    for evt in twins:
        i = int(evt.name[4:])
        _assert_between(spans['outer', i],
                        (evt.time_range.start, evt.time_range.end),
                        spans['inner', i])


def _program_and_twin(path, twin):
    with open(path) as f:
        events = json.load(f)['traceEvents']
    program = [e for e in events if e.get('cat') == 'program']
    twins = [e for e in events if e.get('name') == twin and
             e.get('ph') == 'X' and e.get('cat') != 'program']
    names = {e['tid']: e['args']['name'] for e in events
             if e.get('ph') == 'M' and e.get('name') == 'thread_name'}
    return program, twins, names


def test_trace_writes_the_spans_beside_the_host_events(tmp_path):
    times = StageTimes()

    def worker():
        with times.span('worker', item=5):
            time.sleep(0.001)

    with profiling.trace(str(tmp_path), name='spans'):
        thread = threading.Thread(target=worker, name='spans worker')
        thread.start()
        _sandwich(times, 7)
        thread.join(timeout=60)
    assert not thread.is_alive()
    program, twins, names = _program_and_twin(tmp_path / 'spans.json',
                                              'twin7')
    got = {e['name']: e for e in program}
    assert sorted(got) == ['inner', 'outer', 'worker']
    assert got['outer']['tid'] == threading.get_native_id()
    assert names[got['worker']['tid']] == 'spans worker'
    assert got['outer']['args']['item'] == 7
    assert got['inner']['args']['parent'] == got['outer']['args']['span']
    assert got['worker']['args']['parent'] is None
    twin, = twins

    def ends(event):
        return float(event['ts']), float(event['ts']) + float(event['dur'])
    _assert_between(ends(got['outer']), ends(twin), ends(got['inner']))


def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


def _spin(times):
    """A span around a ~10 ms kernel and the wait for it."""
    torch.cuda.synchronize()
    with times.span('spin'):
        torch.cuda._sleep(int(2e7))
        torch.cuda.synchronize()


@pytest.mark.cuda
def test_span_holds_its_kernel_on_the_card():
    _card()
    torch.cuda._sleep(1000)            # the first launch, out of the trace
    times = StageTimes()
    with profiling.recording() as rec, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _spin(times)
    base = profiling.profiler_start_ns(prof)
    span, = rec.intervals
    start, end = (span.start_ns - base) / 1e3, (span.end_ns - base) / 1e3
    kernels = [evt for evt in prof.events()
               if evt.device_type == DeviceType.CUDA and
               evt.time_range.end - evt.time_range.start > 5000]
    assert len(kernels) == 1, [evt.name for evt in kernels]
    kernel = kernels[0].time_range
    print('span {:.1f}..{:.1f} us, kernel {:.1f}..{:.1f} us: margins '
          '{:.1f} and {:.1f} us'.format(start, end, kernel.start, kernel.end,
                                        kernel.start - start,
                                        end - kernel.end))
    assert start - CARD_US <= kernel.start < kernel.end <= end + CARD_US


@pytest.mark.cuda
def test_trace_writes_the_spans_beside_the_kernels(tmp_path):
    _card()
    torch.cuda._sleep(1000)
    times = StageTimes()
    with profiling.trace(str(tmp_path), name='card'):
        _spin(times)
    with open(tmp_path / 'card.json') as f:
        events = json.load(f)['traceEvents']
    span, = [e for e in events if e.get('cat') == 'program']
    kernels = [e for e in events if e.get('cat') == 'kernel' and
               float(e.get('dur', 0)) > 5000]
    assert len(kernels) == 1
    kernel = kernels[0]
    start, end = float(span['ts']), float(span['ts']) + float(span['dur'])
    k0 = float(kernel['ts'])
    k1 = k0 + float(kernel['dur'])
    print('chrome trace: margins {:.1f} and {:.1f} us'.format(
        k0 - start, end - k1))
    assert start - CARD_US <= k0 < k1 <= end + CARD_US
