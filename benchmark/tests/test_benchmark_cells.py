"""The tiny cells end to end on the CPU: the harness's run prints the
contract's last line with ``correct`` true (the reference agrees with the
port at that size), and with the timed path broken underneath it prints
``correct`` false, once for each fault a cell can have.

Run from the repository's root:

    python -m pytest -p no:cacheprovider benchmark/tests

The tests marked ``cuda`` skip without a card; on the card, run them
with ``-m cuda``.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from benchmark import harness, run
from benchmark.drivers import common
from benchmark.tests import tiny_cells


# (mix, mode): the eval driver's test mode, ``run_inference``'s path, on
# the val mix's split
CELLS = {'train_b1': ('train_b1', None), 'eval_val': ('eval_val', None),
         'infer_test': ('eval_val', 'test')}


def _run_tiny(monkeypatch, capsys, traffic, dtype='float32'):
    """run.main on the tiny cell of ``traffic`` (a key of CELLS) on the
    CPU; returns (exit code, the last line of standard output as a dict,
    standard error)."""
    mix, mode = CELLS[traffic]
    cell = tiny_cells.tiny_cell(mix, dtype, mode)
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
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize('traffic', sorted(CELLS))
def test_tiny_cell_is_correct(monkeypatch, capsys, traffic):
    rc, line, err = _run_tiny(monkeypatch, capsys, traffic)
    assert rc == 0
    assert line['correct'] is True, line
    assert line['failed'] == 0 and line['attempted'] > 0
    assert set(line) >= {'correct', 'attempted', 'failed', 'metrics',
                         'device'}
    assert list(line)[-1] == 'compared'
    assert line['device']['platform'] == 'gpu'
    rate = 'train_samples_per_s' if traffic == 'train_b1' else 'eval_fps'
    assert line['metrics'][rate]['value'] > 0
    assert line['metrics']['setup_s']['value'] > 0
    # memory is not measured on the CPU, so its metric is left out
    assert 'peak_device_gb' not in line['metrics']
    assert err.strip().splitlines()[-1].startswith('compared ')


def _stuck_state(monkeypatch):
    """Train: every optimizer update leaves the state as it was."""
    from monopsr_torch.train import train_state
    monkeypatch.setattr(train_state.TrainState, 'apply_gradients',
                        lambda self, grads, tx, ema_decay=None: self)


def _first_batch_replayed(monkeypatch):
    """Train: every dispatch takes all its steps on its first batch."""
    from benchmark.drivers import train
    real = train._Program.dispatch
    monkeypatch.setattr(train._Program, 'dispatch', lambda self, batches:
                        real(self, [batches[0]] * len(batches)))


def _half_batch(monkeypatch):
    """Eval: the step computes the first half of its rows and gives their
    results to the rest."""
    from monopsr_torch.eval import evaluator
    real = evaluator.make_eval_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def halved(batch, max_slots=None):
            half = {k: (np.concatenate([v[:len(v) // 2]] * 2)
                        if isinstance(v, np.ndarray) else v)
                    for k, v in batch.items()}
            return step(half, max_slots)
        return halved
    monkeypatch.setattr(evaluator, 'make_eval_step', make)


def _altered_answer(monkeypatch):
    """Eval: one box of each frame moves by 0.05 m where it is formatted."""
    from monopsr_torch.eval import predictions
    real = predictions.format_predictions

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        out['box_3d'][0, 2] += 0.05
        return out
    monkeypatch.setattr(predictions, 'format_predictions', altered)


@pytest.mark.parametrize('traffic,fault', [
    ('train_b1', _stuck_state),
    ('train_b1', _first_batch_replayed),
    ('eval_val', _half_batch),
    ('eval_val', _altered_answer),
    ('infer_test', _half_batch),
    ('infer_test', _altered_answer),
])
def test_fault_is_caught(monkeypatch, capsys, traffic, fault):
    fault(monkeypatch)
    rc, line, _ = _run_tiny(monkeypatch, capsys, traffic)
    assert rc == 0
    assert line['correct'] is False, line['compared']


@pytest.mark.parametrize('traffic', ['train_b1', 'eval_val'])
def test_control_fails(traffic):
    """The control, the reference one precision step below the
    configuration's (float8 convolutions for bfloat16), comes out not
    correct at the tiny size."""
    from benchmark import control
    cell = tiny_cells.tiny_cell(traffic, 'bfloat16')
    numbers = control.control_numbers(cell, tiny_cells.SEED,
                                      torch.device('cpu'), 'fp8')
    assert not common.passed(common.checks(cell, numbers)), numbers
    same = control.control_numbers(cell, tiny_cells.SEED,
                                   torch.device('cpu'), None)
    assert common.passed(common.checks(cell, same)), same


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: run on the card with -m cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('cell', [entry['name'] for entry in harness.load_json(
    os.path.join(harness.ROOT, 'BENCHMARK.json'))['workloads']])
def test_cell_on_the_card(card, cell):
    """Each cell of the spec, a short window, on the card: exit 0 and
    ``correct`` true against the cell's limits."""
    out = subprocess.run(
        [sys.executable, '-m', 'benchmark.run', '--workload', cell,
         '--seed', str(tiny_cells.SEED), '--seconds', '2'],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line['correct'] is True, line['compared']
