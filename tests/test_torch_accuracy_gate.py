"""monopsr_torch.experiments.accuracy_gate against scripts/accuracy_gate.py
(the JAX package's gate), and the YAML writer it uses
(``config.dump_yaml``) against PyYAML.

The JAX script is loaded from its file with importlib; of it, only the
functions that need PyYAML and the standard library are run here
(``build_gate_config``, ``make_rotated_fixture``, ``parse_results_text``,
the argument parser). The port's gate then runs once end to end on the
CPU at the tiny test widths (tests/test_torch_train_loop.py::tiny_yaml)
for 3 steps over one split: it must reach its verdict (a failure at 3
steps) with every key of the JAX report, the AP curves read from the
native evaluator's transcripts.
"""

import argparse
import importlib.util
import json
import math
import os

import pytest
import yaml

import monopsr_torch
from monopsr_torch import config
from monopsr_torch.experiments import accuracy_gate as gate

from tests.test_torch_train_loop import FIXTURE, REPO, tiny_yaml

PRODUCTION = os.path.join(REPO, 'configs', 'monopsr_model_000.yaml')

# The keys of one split's report and of the whole report, as
# scripts/accuracy_gate.py's run_split and main write them
SPLIT_KEYS = {'metric', 'split_index', 'split_rotation', 'val_frames',
              'steps', 'step_evaluated', 'train_seconds', 'train', 'gates',
              'val', 'split_checks'}
REPORT_KEYS = SPLIT_KEYS | {'splits', 'num_splits', 'checks', 'pass'}
PHASE_KEYS = {
    'train': {'split', 'ap_image', 'ap_bev', 'ap_3d', 'ap_image_low',
              'ap_bev_low', 'ap_3d_low', 'low_iou_regime', 'aos',
              'iou_regime', 'losses', 'metrics', 'metrics_abs'},
    'val': {'split', 'num_samples', 'ap_image', 'ap_bev', 'ap_3d',
            'iou_regime', 'ap_image_low', 'ap_bev_low', 'ap_3d_low',
            'low_iou_regime', 'losses', 'metrics', 'metrics_abs',
            'cen_z_bias_m', 'cen_z_abs_m'},
}
CHECKS = {'train_image_ap_floor', 'train_ap_floor_low',
          'train_ap_agreement_low', 'train_ap_3d_07_nonzero',
          'metric_cen_z_ceiling', 'metric_chamfer_ceiling',
          'val_image_ap_floor', 'val_metric_ap_nonzero',
          'val_cen_z_bias_ceiling', 'val_cen_z_abs_ceiling'}


@pytest.fixture(scope='module')
def jax_gate():
    spec = importlib.util.spec_from_file_location(
        'jax_accuracy_gate', os.path.join(REPO, 'scripts',
                                          'accuracy_gate.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Parsed(Exception):
    pass


def _parser_defaults(main, monkeypatch):
    """{dest: default} of the parser ``main`` builds, read when it parses
    (main is stopped there)."""
    seen = {}

    def parse_args(self, args=None, namespace=None):
        seen.update({a.dest: a.default for a in self._actions
                     if a.dest != 'help'})
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, 'parse_args', parse_args)
    with pytest.raises(_Parsed):
        main()
    monkeypatch.undo()
    return seen


def _args(**overrides):
    values = dict(steps=2500, seed=42, ema_decay=0.995, flip=True)
    values.update(overrides)
    return argparse.Namespace(**values)


# --------------------------------------------------------------------------
# The YAML writer
# --------------------------------------------------------------------------

def test_dump_yaml_round_trips_the_production_config(tmp_path):
    raw = config.load_yaml(PRODUCTION)
    path = tmp_path / 'dumped.yaml'
    config.dump_yaml(raw, str(path))
    with open(PRODUCTION) as f:
        want = yaml.safe_load(f)
    assert config.load_yaml(str(path)) == want
    with open(path) as f:          # PyYAML reads the writer's output too
        assert yaml.safe_load(f) == want


@pytest.mark.parametrize('value', [
    0.00008, 1e-05, 3.0, -0.25, 1e+16, 1.5e+300, 2, -7, 0, True, False,
    None, 'Car', "it's", '# not a comment', '', [0.2, 0.2],
    [None, 1, 'two', [3.0, [True]]], [],
])
def test_dump_yaml_values_read_back(tmp_path, value):
    doc = {'outer': {'inner': {'leaf': value}, 'next': 1}, 'top': value}
    path = str(tmp_path / 'v.yaml')
    config.dump_yaml(doc, path)
    assert config.load_yaml(path) == doc
    with open(path) as f:
        assert yaml.safe_load(f) == doc


@pytest.mark.parametrize('value', [
    float('inf'), float('nan'), [{'a': 1}], {}, 'two\nlines', object()])
def test_dump_yaml_refuses_what_the_reader_cannot_hold(tmp_path, value):
    with pytest.raises(config.YamlSubsetError):
        config.dump_yaml({'key': value}, str(tmp_path / 'x.yaml'))


# --------------------------------------------------------------------------
# The gate's functions against the JAX script's
# --------------------------------------------------------------------------

@pytest.mark.parametrize('overrides,data_split,suffix', [
    ({}, 'train', ''),
    (dict(steps=20, seed=3, ema_decay=0.9, flip=False), 'val', '_val'),
])
def test_build_gate_config_matches_jax(tmp_path, jax_gate, overrides,
                                       data_split, suffix):
    args = _args(**overrides)
    rot = gate.make_rotated_fixture(3, str(tmp_path / 'port'))
    paths = {}
    for name, module in (('port', gate), ('jax', jax_gate)):
        out_dir = tmp_path / name
        out_dir.mkdir(exist_ok=True)
        paths[name] = module.build_gate_config(
            args, str(out_dir), data_split, suffix=suffix, dataset_dir=rot,
            exp_name='accuracy_gate_s1')
        assert os.path.basename(paths[name]) == 'accuracy_gate_s1.yaml'
    with open(paths['jax']) as f:
        want = yaml.safe_load(f)
    got = config.load_yaml(paths['port'])
    assert got == want
    assert got['dataset_config']['data_split'] == data_split
    assert got['train_config']['max_iterations'] == args.steps
    # parsed into a config as the trainer sees it, identically named
    assert config.parse_yaml_config(paths['port']).config_name == \
        'accuracy_gate_s1'


def _tree(root):
    """{relative path: ('link', target) or ('file', text)} under root."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        for name in dirnames + filenames:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if os.path.islink(path):
                out[rel] = ('link', os.readlink(path))
            elif os.path.isfile(path):
                with open(path) as f:
                    out[rel] = ('file', f.read())
    return out


def test_make_rotated_fixture_matches_jax(tmp_path, jax_gate):
    got = _tree(gate.make_rotated_fixture(3, str(tmp_path / 'port')))
    want = _tree(jax_gate.make_rotated_fixture(3, str(tmp_path / 'jax')))
    assert got == want
    assert got['val.txt'][1].split() == sorted(got['val.txt'][1].split())
    assert len(got['train.txt'][1].split()) == 7
    # a second call rebuilds the view in place
    again = _tree(gate.make_rotated_fixture(3, str(tmp_path / 'port')))
    assert again == got


TRANSCRIPT = """step 3
car_detection AP: 9.090909 9.090909 9.090909
car_orientation AP: 1.5 2.25 3.0
car_detection_BEV AP: 0.000000 0.000000 0.000000
step 6
car_detection AP: 27.272728 27.272728 18.181818
car_orientation AP: 20.1 19.0 14.5
car_detection_BEV AP: 9.090909 9.090909 9.090909
car_detection_3D AP: 0.000000 9.090909 0.000000
"""


def test_parse_results_text_matches_jax(jax_gate):
    got = gate.parse_results_text(TRANSCRIPT)
    assert got == jax_gate.parse_results_text(TRANSCRIPT)
    assert got['car_detection'] == [27.272728, 27.272728, 18.181818]
    assert gate.parse_results_text('') == jax_gate.parse_results_text('')


def test_arguments_and_defaults_match_jax(jax_gate, monkeypatch):
    want = _parser_defaults(jax_gate.main, monkeypatch)
    got = _parser_defaults(gate.main, monkeypatch)
    # every JAX argument with its default; the port adds only --device
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) == {'device'}
    assert got['device'] is None                    # CUDA unless asked
    assert want['steps'] == 2500 and want['splits'] == 2


# --------------------------------------------------------------------------
# The gate end to end, tiny, on the CPU
# --------------------------------------------------------------------------

def test_gate_reaches_its_verdict_on_the_cpu(tmp_path, monkeypatch, capsys):
    with open(PRODUCTION) as f:
        (tmp_path / 'tiny.yaml').write_text(tiny_yaml(f.read(), FIXTURE, 3))
    monkeypatch.setattr(gate, 'CANONICAL', str(tmp_path / 'tiny.yaml'))
    monkeypatch.setattr(monopsr_torch, 'data_dir', lambda: str(tmp_path))
    out = tmp_path / 'gate.json'
    with pytest.raises(SystemExit) as exit_info:
        gate.main(['--steps', '3', '--splits', '1', '--device', 'cpu',
                   '--out', str(out)])
    message = str(exit_info.value.code)
    assert message.startswith('ACCURACY GATE FAILED: '), message

    with open(out) as f:
        report = json.load(f)
    assert set(report) == REPORT_KEYS | {'device'}
    assert report['device'] == {'torch': 'cpu'}
    assert report['num_splits'] == 1 and report['pass'] is False
    split, = report['splits']
    assert set(split) == SPLIT_KEYS
    assert split['steps'] == 3 and split['step_evaluated'] == 3
    assert set(report['checks']) == CHECKS
    failed = [k for k, v in report['checks'].items() if not v]
    assert message == 'ACCURACY GATE FAILED: ' + ', '.join(failed)
    for phase, keys in PHASE_KEYS.items():
        assert set(report[phase]) == keys, phase
        # every curve was read from a native AP transcript
        for key in ('ap_image', 'ap_bev', 'ap_3d', 'ap_image_low',
                    'ap_bev_low', 'ap_3d_low'):
            assert len(report[phase][key]) == 3, (phase, key)
        assert report[phase]['losses'] and all(
            math.isfinite(v) for v in report[phase]['losses'].values())
        assert all(math.isfinite(v)
                   for v in report[phase]['metrics_abs'].values())
    assert report['val']['num_samples'] == 4
    assert report['val_frames'] == sorted(report['val_frames'])

    pred_dir = tmp_path / 'outputs' / 'accuracy_gate' / 'predictions'
    for name in ('accuracy_gate_results_0.1.txt',
                 'accuracy_gate_results_low_iou_0.1.txt'):
        text = (pred_dir / name).read_text()
        assert text.count('step 3\n') == 2, name      # train, then val
        assert 'car_detection_3D AP: ' in text
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1])['checks'] == report['checks']
