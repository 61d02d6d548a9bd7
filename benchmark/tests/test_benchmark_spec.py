"""BENCHMARK.json against the benchmark's contract, and the harness
finding every configuration, workload, mix, limit and metric by name
from files alone."""

import json
import os
import re

import pytest

from benchmark import harness

SPEC = harness.load_json(os.path.join(harness.ROOT, 'BENCHMARK.json'))
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_.\-/]{1,200}$')
KEYS = {
    'configs': {'name', 'source', 'file', 'reduced', 'why'},
    'workloads': {'name', 'config', 'traffic', 'chips', 'why'},
    'end_to_end': {'name', 'unit', 'better', 'bound', 'source'},
    'per_layer': {'name', 'unit', 'better', 'source', 'layer', 'moves'},
}


def _line(text):
    return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_top_level():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert 1 <= len(SPEC['paths']) <= 16
    for path in SPEC['paths']:
        assert PATH.match(path) and not path.startswith('/') and \
            '..' not in path.split('/')
    assert 1 <= len(SPEC['command']) <= 32
    assert all(_line(word) for word in SPEC['command'])
    assert isinstance(SPEC['run_seconds'], int) and \
        1 <= SPEC['run_seconds'] <= 51
    cells = len(SPEC['workloads'])
    runs = 2 + 14 * 24
    assert runs * (SPEC['run_seconds'] + 60) + 24 * 180 + 1200 <= 43200
    assert cells <= 24


@pytest.mark.parametrize('section', sorted(KEYS))
def test_entries(section):
    names = [entry['name'] for entry in SPEC[section]]
    assert len(names) == len(set(names))
    for entry in SPEC[section]:
        extra = set(entry) - KEYS[section]
        assert set(entry) >= KEYS[section]
        assert extra <= ({'workloads'} if section in ('end_to_end',
                                                      'per_layer') else set())
        assert NAME.match(entry['name'])
        for key in ('why', 'layer', 'source'):
            if key in entry:
                assert _line(entry[key]), (entry['name'], key)
        if 'unit' in entry:
            assert UNIT.match(entry['unit'])
            assert entry['better'] in ('lower', 'higher')


def test_cells_and_configs():
    configs = {c['name']: c for c in SPEC['configs']}
    used = set()
    pairs = set()
    for cell in SPEC['workloads']:
        assert cell['config'] in configs
        assert NAME.match(cell['traffic'])
        assert cell['chips'] in (1, 4)
        pair = (cell['config'], cell['traffic'])
        assert pair not in pairs
        pairs.add(pair)
        used.add(cell['config'])
    assert used == set(configs)
    files = [c['file'] for c in SPEC['configs']]
    assert len(files) == len(set(files))
    for config in SPEC['configs']:
        assert config['file'].startswith(tuple(p + '/' for p in
                                               SPEC['paths']))
        assert len(config['reduced']) <= 16
        assert config['source'].startswith('https://')


def test_metrics():
    cells = {c['name'] for c in SPEC['workloads']}
    e2e = {m['name']: m for m in SPEC['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for metric in SPEC['end_to_end']:
        assert 0.01 <= metric['bound'] <= 0.25
        assert metric['source'] in ('host_clock', 'device_trace')
    layers = {}
    for metric in SPEC['per_layer']:
        assert metric['moves'] in e2e
        assert metric['source'] in ('device_trace', 'program_span',
                                    'program_counter', 'host_clock')
        layers.setdefault(metric['layer'], []).append(metric['name'])
        if metric['name'].endswith('_roofline'):
            assert metric['unit'] == '%'
        for cell in metric.get('workloads', cells):
            moved = e2e[metric['moves']]
            assert cell in moved.get('workloads', cells)
    for cell in cells:
        mine = [m for m in SPEC['end_to_end']
                if cell in m.get('workloads', cells)]
        assert 'setup_s' in [m['name'] for m in mine] and len(mine) >= 2
        assert any(cell in m.get('workloads', cells)
                   for m in SPEC['per_layer'])


def test_every_piece_is_found_by_name():
    """Each cell's configuration, mix, driver, limits and every metric's
    reader are files the harness finds from the names alone."""
    for entry in SPEC['workloads']:
        cell = harness.Cell(entry['name'], SPEC)
        assert cell.config['name'] == entry['config']
        assert harness.driver(cell.traffic['kind']).run
        assert cell.limits, entry['name']
        for section in ('end_to_end', 'per_layer'):
            for metric in cell.metrics(section):
                assert callable(harness.load_reader(metric['name']))


def test_readers_return_nothing_without_a_reading():
    for metric in SPEC['end_to_end'] + SPEC['per_layer']:
        assert harness.load_reader(metric['name'])({}) is None


def test_configs_keep_the_production_yaml():
    """Each configuration's file holds the production YAML it names, with
    only the compute dtype as its name states it."""
    from monopsr_torch import config as config_lib
    production = config_lib.load_yaml(os.path.join(
        harness.ROOT, 'configs', 'monopsr_model_000.yaml'))
    for entry in SPEC['configs']:
        experiment = harness.load_json(os.path.join(
            harness.ROOT, entry['file']))['experiment']
        dtype = experiment['model_config'].pop('compute_dtype')
        expected = json.loads(json.dumps(production))
        expected['model_config'].pop('compute_dtype')
        assert experiment == expected
        assert dtype == ('bfloat16' if entry['name'].endswith('bf16')
                         else 'float32')
