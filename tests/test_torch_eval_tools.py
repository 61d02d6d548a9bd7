"""The port's evaluation tools against the JAX package's: the 2D-only
KITTI writer, ``monopsr_torch.tools.save_kitti_predictions`` against
``scripts/offline_eval/save_kitti_predictions.py`` (3D and ``--save_2d``),
and the PR-curve plots ``native_eval.run`` draws after each regime, as
``run_eval.sh`` does, best-effort.

The same prediction dumps go through both writers; the files must be
byte-equal and the CLIs must write the same tree.
"""

import importlib.util
import os
import shutil
import sys

import numpy as np

from monopsr_torch.eval import kitti_writers, native_eval
from monopsr_torch.tools import save_kitti_predictions
from monopsr_tpu.eval import kitti_writers as jax_writers

from tests.test_torch_eval_host import (_datasets,
                                        _kitti_predictions_from_labels,
                                        _same_tree, _write_raw_predictions)
from tests.test_torch_train_loop import FIXTURE, REPO, tiny_yaml


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            with open(path, 'rb') as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_kitti_2d_writer_matches_jax_byte_for_byte(tmp_path):
    dataset, jdataset = _datasets('val')
    names = [s.name for s in dataset.sample_list]
    raw = str(tmp_path / 'raw')
    _write_raw_predictions(np.random.RandomState(21), names,
                           os.path.join(raw, 'box_3d'),
                           os.path.join(raw, 'box_2d'))
    out = {}
    for key, module, ds in (('torch', kitti_writers, dataset),
                            ('jax', jax_writers, jdataset)):
        out[key] = module.save_predictions_box_2d_in_kitti_format(
            0.1, ds, str(tmp_path / key), os.path.join(raw, 'box_2d'), 3)
    assert out['torch'] == str(tmp_path / 'torch' / 'kitti_predictions_3d'
                               / 'val' / '0.1' / '3' / 'data')
    written = _same_tree(out['torch'], out['jax'])
    assert written == sorted(n + '.txt' for n in names)
    rows = [line for n in written for line in open(
        os.path.join(out['torch'], n), newline='').read().split('\r\n')
        if line]
    assert rows and all(len(r.split()) == 16 for r in rows)
    assert all(r.split()[3] == '-10.0' and r.split()[8] == '-1000.0'
               for r in rows)


def _jax_script():
    path = os.path.join(REPO, 'scripts', 'offline_eval',
                        'save_kitti_predictions.py')
    spec = importlib.util.spec_from_file_location('jax_save_kitti', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_save_kitti_predictions_cli_writes_the_jax_tree(tmp_path,
                                                        monkeypatch):
    with open(os.path.join(REPO, 'configs', 'monopsr_model_000.yaml')) as f:
        text = tiny_yaml(f.read(), FIXTURE, 2)
    config_path = tmp_path / 'tiny_kitti.yaml'
    config_path.write_text(text)
    dataset, _ = _datasets('val')
    names = [s.name for s in dataset.sample_list]
    steps = ('2', '4')
    bases = {key: tmp_path / key for key in ('jax', 'torch')}
    pred = bases['jax'] / 'tiny_kitti' / 'predictions'
    for i, step in enumerate(steps):
        _write_raw_predictions(np.random.RandomState(30 + i), names,
                               str(pred / 'box_3d' / 'val' / step),
                               str(pred / 'box_2d' / 'val' / step))
    shutil.copytree(bases['jax'], bases['torch'])

    script = _jax_script()
    for extra in ([], ['--save_2d']):
        for key in ('jax', 'torch'):
            args = ['--config_path', str(config_path), '--data_split', 'val',
                    '--steps'] + list(steps) + [
                    '--output_base_dir', str(bases[key])] + extra
            if key == 'jax':
                monkeypatch.setattr(sys, 'argv', ['save'] + args)
                script.main()
            else:
                save_kitti_predictions.main(args)
        got = _tree(bases['torch'] / 'tiny_kitti' / 'predictions')
        want = _tree(bases['jax'] / 'tiny_kitti' / 'predictions')
        assert sorted(got) == sorted(want)
        assert got == want
        kitti = [k for k in got if k.startswith('kitti_predictions_3d')]
        assert len(kitti) == len(steps) * len(names)
    # a step without dumps is reported and skipped, as by the script
    save_kitti_predictions.main(['--config_path', str(config_path),
                                 '--steps', '6', '--output_base_dir',
                                 str(bases['torch'])])
    assert not os.path.exists(bases['torch'] / 'tiny_kitti' / 'predictions'
                              / 'kitti_predictions_3d' / 'val' / '0.1' / '6')


def _native_run(tmp_path, name, capsys):
    dataset, _ = _datasets('val')
    names = [s.name for s in dataset.sample_list]
    label_dir = os.path.join(dataset.data_split_dir, 'label_2')
    result_dir = tmp_path / name / 'kitti_predictions_3d' / 'val' / '0.1' \
        / '4'
    _kitti_predictions_from_labels(label_dir, names,
                                   str(result_dir / 'data'), 16)
    files = native_eval.results_paths(str(tmp_path / name), 'run', 0.1)
    capsys.readouterr()
    native_eval.run(native_eval.build(), label_dir, str(result_dir), 4,
                    files)
    printed = capsys.readouterr().out
    return result_dir, [open(f).read() for f in files], printed


def test_native_eval_plots_pr_curves_best_effort(tmp_path, capsys,
                                                 monkeypatch):
    """After each regime native_eval.run draws the curve files to PNGs
    beside them with the script run_eval.sh runs, and says so in one
    line; with matplotlib missing it writes no PNG, says so, and the
    results files are the same."""
    result_dir, want, printed = _native_run(tmp_path, 'with_plots', capsys)
    files = os.listdir(result_dir / 'plot')
    curves = sorted(p for p in files if p.endswith('.txt'))
    pngs = sorted(p for p in files if p.endswith('.png'))
    assert curves and pngs == [c[:-4] + '.png' for c in curves]
    for regime in ('standard', 'low'):
        assert 'PR-curve plots ({}): {}: wrote {} figure(s)'.format(
            regime, result_dir, len(pngs)) in printed

    blocked = tmp_path / 'plot_without_matplotlib.py'
    blocked.write_text(
        'import runpy, sys\n'
        "sys.modules['matplotlib'] = None\n"
        'sys.argv = [{0!r}] + sys.argv[1:]\n'
        "runpy.run_path({0!r}, run_name='__main__')\n".format(
            native_eval.PLOT_SCRIPT))
    monkeypatch.setattr(native_eval, 'PLOT_SCRIPT', str(blocked))
    result_dir, got, printed = _native_run(tmp_path, 'without', capsys)
    assert got == want
    assert sorted(os.listdir(result_dir / 'plot')) == curves
    for regime in ('standard', 'low'):
        assert 'PR-curve plots ({}): none written (plotter exited 1: '\
            .format(regime) in printed
