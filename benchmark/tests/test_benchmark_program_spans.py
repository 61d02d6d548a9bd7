"""The reader of the program's dispatch span and ``benchmark.program_spans``
(the idle gaps named by the program's spans, the window's totals per
frame): on synthetic contexts and timelines, and on the tiny cells on
the CPU."""

import time

import pytest

from benchmark import harness, program_spans
from benchmark.tests import tiny_cells

READER = 'eval.dispatch_ms_per_frame'


def test_dispatch_reader_on_synthetic_contexts():
    read = harness.load_reader(READER)
    assert read({}) is None
    assert read({'kind': 'train', 'steps': 8, 'trace': None}) is None
    stages = dict.fromkeys(('assembly', 'pull', 'format', 'write'), 1.0)
    assert read({'kind': 'eval', 'stage_ms': dict(stages, dispatch=7.25)}) \
        == 7.25


def test_gaps_take_the_innermost_program_span():
    # the card busy over [0, 10] and [40, 50] and [90, 100] of [0, 100]
    device = [(0, 10), (40, 50), (90, 100)]
    host = [(0, 100, 'groups'), (60, 90, 'kitti_files')]
    mine = [(5, 45, 'eval.dispatch', 2), (12, 30, 'eval.upload', 2),
            (50, 58, 'eval.drain', 7)]
    by_name, by_item, idle = program_spans.name_gaps(
        (0, 100), device, host, mine)
    # gaps [10, 40] (mid 25: upload), [50, 90] (mid 70: no program span,
    # the bench spans open there)
    assert by_name == pytest.approx({'eval.upload': 30e-6,
                                     'groups+kitti_files': 40e-6})
    assert by_item == pytest.approx({('eval.upload', 2): 30e-6,
                                     ('groups+kitti_files', None): 40e-6})
    assert idle == pytest.approx(70e-6)
    by_name, _, _ = program_spans.name_gaps((0, 100), [], [], [])
    assert by_name == pytest.approx({'none': 100e-6})


def _context(traffic, passes):
    cell = tiny_cells.tiny_cell(traffic)
    kind = harness.driver(cell.traffic['kind'])
    with program_spans.eval_passes(passes):
        out = kind.run(cell, tiny_cells.SEED, 0.5, False,
                         time.perf_counter(), device='cpu')
    assert out.correct, out.checks
    return out.context


def test_the_tiny_eval_cell_reads_its_host_shares():
    passes = []
    ctx = _context('eval_val', passes)
    value = harness.load_reader(READER)(ctx)
    assert value is not None and value > 0
    # set-up's warm-up pass, then the window's
    window = program_spans.per_frame(passes[1:])
    assert window['units'] == ctx['units']
    assert window['counters']['eval.frames'] == 1
    assert window['counters']['eval.bytes_up'] > 0
    for share in ('feed_wait', 'dispatch', 'serial'):
        assert window[share] > 0, share
    assert window['dispatch'] == pytest.approx(value)


def test_the_tiny_train_cell_has_no_eval_shares():
    passes = []
    ctx = _context('train_b1', passes)
    assert harness.load_reader(READER)(ctx) is None
    assert passes == [] and program_spans.per_frame(passes) is None
