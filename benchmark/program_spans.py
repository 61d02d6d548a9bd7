"""One cell run as ``benchmark.run`` runs it, with the program's own spans
and counters (``monopsr_torch.utils.profiling``) read beside it:

    python3 -m benchmark.program_spans --workload r101_bf16.eval_val \\
        --seed <n> --seconds 51 --trace 1
    python3 -m benchmark.program_spans --workload r101_bf16.eval_val \\
        --seed <n> --seconds 51 --trace 0 --record 1

With ``--trace 1`` the program's recording is on over the traced stretch,
whose reduction (``harness.traced``) runs unchanged, and each idle gap of
the card is named by the innermost program span open at its midpoint on
the thread that dispatches to the card; by the ``bench/`` spans open
there where no program span is, and 'none' where neither is. With
``--record 1`` (and ``--trace 0``) the recording is on from set-up to the
window's end: its cost, against a run without it.

After ``benchmark.run``'s result line it prints one more JSON object,
``{"program_spans": ...}``: the idle seconds and the gaps by name and by
name and item (the group or dispatch number, a span's nearest
ancestor's where it has none); for an eval cell, the program's span
totals and counters per frame over the window's passes with the three
host shares read from them: 'feed_wait' ('eval.feed_wait'), 'dispatch'
('eval.dispatch') and 'serial' ('eval.groups', 'eval.drain',
'eval.metrics_csv', 'eval.log' and 'eval.kitti_files': a pass's head and
tail, when nothing can be dispatched); for a train cell on the card, the
graphed step's span totals and counters per step over the whole run.
"""

import argparse
import contextlib
import json
import sys
import threading

from benchmark import harness, run

SERIAL = ('eval.groups', 'eval.drain', 'eval.metrics_csv', 'eval.log',
          'eval.kitti_files')


def name_gaps(window, device, host, mine):
    """Idle gaps of the card in ``window`` (lo, hi), named. ``device``:
    [(start, end)] of its operations; ``host``: [(start, end, name)] of
    the ``bench/`` spans; ``mine``: [(start, end, name, item)] of the
    program's spans on the dispatching thread, properly nested; all in
    microseconds of one timeline. Returns ({name: seconds}, {(name,
    item): seconds}, idle seconds)."""
    lo, hi = window
    busy = harness._merge([(max(s, lo), min(e, hi)) for s, e in device
                           if e > lo and s < hi])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    by_name, by_item, idle = {}, {}, 0.0
    for start, end in zip(edges[0::2], edges[1::2]):
        if end <= start:
            continue
        mid = (start + end) / 2
        seconds = (end - start) / 1e6
        idle += seconds
        open_ = [m for m in mine if m[0] <= mid < m[1]]
        if open_:
            _, _, name, item = max(open_, key=lambda m: (m[0], -m[1]))
        else:
            name = '+'.join(sorted({n for s, e, n in host
                                    if s <= mid < e})) or 'none'
            item = None
        by_name[name] = by_name.get(name, 0.0) + seconds
        by_item[name, item] = by_item.get((name, item), 0.0) + seconds
    return by_name, by_item, idle


def _top(d, n):
    return sorted(d.items(), key=lambda kv: -kv[1])[:n]


def gaps_of(prof, intervals, thread):
    """``name_gaps`` over a ``torch.profiler`` run of ``harness.traced``
    and the program's intervals recorded meanwhile."""
    from torch.autograd import DeviceType
    from monopsr_torch.utils import profiling
    base = profiling.profiler_start_ns(prof)
    window, device, host = None, [], []
    prefix = harness.Spans.PREFIX
    for evt in prof.events():
        start, end = evt.time_range.start, evt.time_range.end
        if evt.device_type == DeviceType.CUDA:
            if not (getattr(evt, 'is_user_annotation', False) or
                    evt.name.startswith(prefix)):
                device.append((start, end))
        elif evt.name == prefix + 'traced_window':
            window = (start, end)
        elif evt.name.startswith(prefix):
            host.append((start, end, evt.name[len(prefix):]))
    if window is None:
        return None
    spans = {iv.span: iv for iv in intervals}

    def item(iv):
        """The span's item, or its nearest ancestor's (the graphed eval
        step's spans take their group's)."""
        while iv.item is None and iv.parent in spans:
            iv = spans[iv.parent]
        return iv.item
    mine = [((iv.start_ns - base) / 1e3, (iv.end_ns - base) / 1e3, iv.name,
             item(iv)) for iv in intervals if iv.thread == thread]
    by_name, by_item, idle = name_gaps(window, device, host, mine)
    return {'idle_s': idle,
            'none_share': by_name.get('none', 0.0) / idle if idle else None,
            'idle_gaps': [[k, v] for k, v in _top(by_name, 12)],
            'idle_gaps_by_item': [[k[0], k[1], v]
                                  for k, v in _top(by_item, 16)]}


@contextlib.contextmanager
def traced_with_spans(out):
    """``harness.traced`` with the program's recording on over it; the
    named gaps go into ``out['gaps']``."""
    import torch.profiler
    from monopsr_torch.utils import profiling
    original, real_profile = harness.traced, torch.profiler.profile
    made = []

    class Kept(real_profile):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    def traced(fn, spans):
        thread = threading.get_native_id()
        torch.profiler.profile = Kept
        try:
            with profiling.recording() as rec:
                result = original(fn, spans)
        finally:
            torch.profiler.profile = real_profile
        out['gaps'] = gaps_of(made[-1], rec.intervals, thread)
        return result

    harness.traced = traced
    try:
        yield
    finally:
        harness.traced = original


@contextlib.contextmanager
def eval_passes(passes):
    """Appends each evaluator pass's (span totals, counters) to
    ``passes`` while the block runs."""
    from monopsr_torch.eval import evaluator
    real = evaluator.Evaluator.run_checkpoint_once

    def counted(self, state, global_step):
        result = real(self, state, global_step)
        passes.append(self.stage_times.totals())
        return result

    evaluator.Evaluator.run_checkpoint_once = counted
    try:
        yield
    finally:
        evaluator.Evaluator.run_checkpoint_once = real


@contextlib.contextmanager
def train_steps(steps):
    """Appends each graphed train step made while the block runs to
    ``steps``."""
    from monopsr_torch.train import step_graph
    real = step_graph.GraphedTrainStep.__init__

    def kept(self, *args, **kwargs):
        real(self, *args, **kwargs)
        steps.append(self)

    step_graph.GraphedTrainStep.__init__ = kept
    try:
        yield
    finally:
        step_graph.GraphedTrainStep.__init__ = real


def per_unit(totals, unit):
    """{'units', 'ms': {span: ms per unit}, 'counters': {counter: per
    unit}} of (span totals, counters) over the counter ``unit``."""
    spans, counters = totals
    units = counters.get(unit, 0)
    if not units:
        return None
    return {'units': units,
            'ms': {name: 1e3 * s / units
                   for name, (s, _) in sorted(spans.items())},
            'counters': {name: n / units
                         for name, n in sorted(counters.items())}}


def per_frame(passes):
    """``per_unit`` over ``passes`` by 'eval.frames', with the three host
    shares."""
    spans, counters = {}, {}
    for pass_spans, pass_counters in passes:
        for name, (s, n) in pass_spans.items():
            total = spans.get(name, (0.0, 0))
            spans[name] = (total[0] + s, total[1] + n)
        for name, n in pass_counters.items():
            counters[name] = counters.get(name, 0) + n
    out = per_unit((spans, counters), 'eval.frames')
    if out is not None:
        ms = out['ms']
        out.update(feed_wait=ms.get('eval.feed_wait', 0.0),
                   dispatch=ms.get('eval.dispatch', 0.0),
                   serial=sum(ms.get(name, 0.0) for name in SERIAL))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--record', type=int, choices=(0, 1), default=0)
    args, rest = parser.parse_known_args(argv)
    tracing = '--trace' in rest and rest[rest.index('--trace') + 1] == '1'
    if args.record and tracing:
        parser.error('--record 1 runs with --trace 0')
    from monopsr_torch.utils import profiling
    out, passes, steps = {}, [], []
    with contextlib.ExitStack() as stack:
        stack.enter_context(eval_passes(passes))
        stack.enter_context(train_steps(steps))
        stack.enter_context(traced_with_spans(out))
        rec = stack.enter_context(profiling.recording()) if args.record \
            else None
        rc = run.main(rest)
    if rec is not None:
        out['recorded_intervals'] = len(rec.intervals)
    # the passes: set-up's warm-up, the window's, the traced one
    window = passes[1:len(passes) - 1 if tracing else len(passes)]
    out['window'] = per_frame(window)
    # the graphed train step's whole run: set-up, window and traced stretch
    out['train_run'] = [per_unit(step.times.totals(), 'train.steps')
                        for step in steps]
    print(json.dumps({'program_spans': out}))
    return rc


if __name__ == '__main__':
    sys.exit(main())
