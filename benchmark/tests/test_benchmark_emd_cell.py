"""The cells of the ``'emd'``-loss configuration and of test-mode
inference: the tiny ``'emd'`` train cell end to end on the CPU, K2's
roofline reader against the port's bound, and the new configuration and
mix against the files they copy (``test_benchmark_spec.py`` holds the
whole spec, these entries included, to the contract).

Run from the repository's root:

    python -m pytest -p no:cacheprovider benchmark/tests
"""

import json
import os
import types

import pytest
import torch

from benchmark import harness, run
from benchmark.tests import test_benchmark_spec as spec_tests
from benchmark.tests import tiny_cells

EMD_CONFIG = 'monopsr_r101_bf16_emd'
EMD_CELL = 'r101_bf16_emd.train_b1'
INFER_CELL = 'r101_bf16.infer_test'
K2 = harness.load_reader('k2_emd_loss_roofline')
# the reader's module: its frozen bound and launch shape
K2_MODULE = K2.__globals__


def _peaks():
    return harness.load_json(os.path.join(harness.BENCH_DIR, 'metrics',
                                          'peaks.json'))


def _run_tiny_emd(monkeypatch, capsys):
    """run.main on the tiny ``'emd'`` train cell on the CPU: (exit code,
    the last line as a dict)."""
    cell = tiny_cells.tiny_cell('train_b1')
    cell.config = tiny_cells.tiny_config(EMD_CONFIG)
    cell.spec['per_layer'].append({'name': 'k2_emd_loss_roofline',
                                   'unit': '%'})
    monkeypatch.setattr(harness, 'Cell', lambda name: cell)
    monkeypatch.setattr(harness, 'require_cards', lambda count: torch)
    monkeypatch.setattr(torch.cuda, 'get_device_name',
                        lambda index=0: 'cpu (a test)')
    real = harness.driver

    def on_cpu(kind):
        module = real(kind)
        return types.SimpleNamespace(
            run=lambda *args: module.run(*args, device='cpu'))
    monkeypatch.setattr(harness, 'driver', on_cpu)
    rc = run.main(['--workload', cell.name, '--seed', str(tiny_cells.SEED),
                   '--seconds', '0.5'])
    out, _ = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1])


def test_tiny_emd_cell_is_correct(monkeypatch, capsys):
    """The ``'emd'``-loss train step (K2's plain twin on the CPU) agrees
    with the reference's over the compared steps."""
    rc, line = _run_tiny_emd(monkeypatch, capsys)
    assert rc == 0
    assert line['correct'] is True, line['compared']
    assert line['failed'] == 0 and line['attempted'] > 0
    assert line['metrics']['train_samples_per_s']['value'] > 0


def test_tiny_emd_cell_catches_a_plan_fault(monkeypatch, capsys):
    """The port's plan without its last annealing round: the comparison
    says not correct."""
    from monopsr_torch.ops import emd as emd_ops
    real = emd_ops._levels
    monkeypatch.setattr(emd_ops, '_levels', lambda: real()[:-1])
    rc, line = _run_tiny_emd(monkeypatch, capsys)
    assert rc == 0
    assert line['correct'] is False, line['compared']


def test_tiny_emd_cell_catches_a_frozen_ema(monkeypatch, capsys):
    """The EMA left where it started (a decay of 1): its change reads
    about 1 against the reference's (the median leaf's gap; 1 for every
    leaf at or above the median), and the comparison says not correct."""
    from monopsr_torch.train import optimizer as opt_lib
    real = opt_lib.build_optimizer

    def frozen(*args, **kwargs):
        tx, schedule, use_ema, _ = real(*args, **kwargs)
        return tx, schedule, use_ema, 1.0
    monkeypatch.setattr(opt_lib, 'build_optimizer', frozen)
    rc, line = _run_tiny_emd(monkeypatch, capsys)
    assert rc == 0
    assert line['compared']['ema_gap']['value'] > 0.9
    assert line['correct'] is False, line['compared']


def test_k2_bound_is_the_ports():
    """The reader's frozen bound at (32, 2304, 2304) and the H100 SXM's
    published figures equals the port's ``utils/profiling.emd_bound_ms``
    for K2 (230 float32 operations an element; the cost and four
    accumulators out): 0.853 ms, bound by the special-function units."""
    from monopsr_torch.utils import profiling
    peaks = _peaks()
    b, n = 32, 48 * 48
    ms, by = profiling.emd_bound_ms(b, n, n, peaks['sm_count'],
                                    peaks['max_sm_clock_mhz'], 230,
                                    b * (1 + 4 * (n + n)))
    assert by == 'operations'
    assert K2_MODULE["bound_s"](b, n, n, peaks) * 1e3 == pytest.approx(
        ms, rel=1e-12)
    assert ms == pytest.approx(0.853, abs=5e-4)


def test_k2_launch_shape_is_the_configurations():
    """A launch of the cell's step covers every box of every image of the
    step (batch x num_boxes pairs) at every point of a local map."""
    cell = harness.Cell(EMD_CELL)
    experiment = cell.experiment
    batch = cell.traffic['train_config']['batch_size']
    pairs = batch * experiment['dataset_config']['num_boxes']
    rows, cols = experiment['model_config']['map_roi_size']
    assert (K2_MODULE['PAIRS'], K2_MODULE['POINTS']) == (
        pairs, rows * cols)


def test_k2_reader_reads_only_k2():
    """None without a trace or without a K2 launch in it (the other
    cells, K1 included); else the launches' bound over their time."""
    assert K2({}) is None
    assert K2({'trace': None}) is None
    assert K2({'trace': {'kernels': []}}) is None
    others = [('void sweep_kernel<false>(Args)', 0.010),
              ('ampere_bf16_s16816gemm', 0.002),
              ('multi_tensor_apply_kernel', 0.001)]
    assert K2({'trace': {'kernels': others}}) is None
    bound = K2_MODULE['bound_s'](32, 2304, 2304, _peaks())
    kernels = others + [('void sweep_kernel<true>(Args)', 4 * bound),
                        ('void sweep_kernel<true>(Args)', 6 * bound)]
    assert K2({'trace': {'kernels': kernels}}) == pytest.approx(20.0)


def test_emd_config_changes_one_key_of_the_production_config():
    """The configuration's experiment is ``monopsr_r101_bf16``'s with
    ``loss_config.inst_xyz_map_local`` alone changed, to the source's
    ``'emd'`` loss, and it states what it changed and assumed."""
    emd = harness.load_json(os.path.join(harness.BENCH_DIR, 'configs',
                                         EMD_CONFIG + '.json'))
    production = harness.load_json(os.path.join(
        harness.BENCH_DIR, 'configs', 'monopsr_r101_bf16.json'))
    assert emd['reduced'] == []
    loss = emd['experiment']['model_config']['loss_config']
    assert loss.pop('inst_xyz_map_local') == ['emd', 1.0]
    production['experiment']['model_config']['loss_config'].pop(
        'inst_xyz_map_local')
    assert emd['experiment'] == production['experiment']
    assert list(emd['changed']) == [
        'model_config.loss_config.inst_xyz_map_local']
    assert 'loss_config.inst_xyz_map_local weight' in emd['assumed']
    entry = {c['name']: c for c in spec_tests.SPEC['configs']}[EMD_CONFIG]
    assert entry['file'] == 'benchmark/configs/{}.json'.format(EMD_CONFIG)
    assert entry['reduced'] == emd['reduced']


def test_infer_test_mix_is_eval_val_in_test_mode():
    infer = harness.Cell(INFER_CELL).traffic
    val = harness.Cell('r101_bf16.eval_val').traffic
    assert infer.pop('mode') == 'test' and val.pop('mode') == 'val'
    infer.pop('describes')
    val.pop('describes')
    assert infer == val


@pytest.mark.parametrize('cell,metrics', [
    (EMD_CELL, {'train_samples_per_s', 'peak_device_gb', 'setup_s',
                'train.step_mfu_pct', 'train.device_idle_pct',
                'k2_emd_loss_roofline'}),
    (INFER_CELL, {'eval_fps', 'peak_device_gb', 'setup_s',
                  'eval.step_mfu_pct', 'eval.device_idle_pct',
                  'eval.assembly_ms_per_frame', 'eval.output_ms_per_frame',
                  'eval.dispatch_ms_per_frame'}),
])
def test_new_cells_report_their_metrics(cell, metrics):
    """Each new cell reports the metrics of its kind that read something
    there, on one card, with its limits; K1's roofline stays off the
    inference cell (test mode runs no K1)."""
    entry = harness.Cell(cell)
    assert entry.chips == 1 and entry.limits
    assert {m['name'] for section in ('end_to_end', 'per_layer')
            for m in entry.metrics(section)} == metrics
