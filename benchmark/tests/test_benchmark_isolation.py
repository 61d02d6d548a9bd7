"""What the benchmark may import: nothing of JAX or the JAX package
anywhere outside its tests, and nothing of the program in its reference,
its traffic generators or its metric readers. Top-level module names are
compared whole (``monopsr_torch`` begins with ``monopsr_t``, not with
``monopsr_tpu``)."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'monopsr_tpu'}
# Parts that stand apart from the program (the yardstick)
INDEPENDENT = ('reference', 'traffic', 'metrics', 'weights.py')


def _sources():
    for dirpath, dirnames, filenames in os.walk(harness.BENCH_DIR):
        dirnames[:] = [d for d in dirnames
                       if d not in ('tests', '__pycache__')]
        for name in filenames:
            if name.endswith('.py'):
                yield os.path.join(dirpath, name)


def _imported(path):
    """Top-level names of every module ``path`` imports."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name.split('.')[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


def test_no_jax_in_the_benchmark():
    for path in _sources():
        assert not _imported(path) & FORBIDDEN, path


def test_the_yardstick_imports_nothing_of_the_program():
    for path in _sources():
        rel = os.path.relpath(path, harness.BENCH_DIR)
        if rel.startswith(INDEPENDENT):
            assert 'monopsr_torch' not in _imported(path), rel


@pytest.mark.parametrize('module', [
    'benchmark.reference.kitti', 'benchmark.reference.train',
    'benchmark.traffic.kitti_split', 'benchmark.traffic.train_samples',
    'benchmark.weights'])
def test_the_yardstick_loads_nothing_of_the_program(module):
    """In a fresh interpreter, importing a part of the yardstick loads no
    module of the program, of JAX or of the JAX package."""
    code = ('import sys, {0}; print(sorted({{m.split(".")[0] for m in '
            'sys.modules}} & {{"monopsr_torch", "monopsr_tpu", "jax", '
            '"jaxlib", "flax"}}))').format(module)
    out = subprocess.run([sys.executable, '-c', code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    assert out.strip() == '[]'


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'monopsr_tpux', object())
    assert 'monopsr_tpux' not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'jaxlib.xla', object())
    assert 'jaxlib.xla' in harness.forbidden_modules()
