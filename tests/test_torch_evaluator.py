"""monopsr_torch's Evaluator against the JAX package's on the KITTI
fixture, from the same weights, in val and in test mode; the port's
eval_batch invariance; its two CLIs.

The tiny configuration of tests/test_train_eval.py (resnet_tiny, float32,
2 boxes, 48x160 input, the production loss_config, Adam with an EMA),
dataset seed 0, on the CPU. One JAX state is built as the JAX loop
builds its initial state (PRNGKey(0) on the first valid sample), its EMA
set apart from its parameters (x 0.9, so that evaluating the parameters
instead of the EMA shows), and carried across with
``weights.train_state_from_flax``; the port evaluates it from a
checkpoint written by its own ``save_checkpoint``, the JAX evaluator from
the state in memory (``run_checkpoint_once``).

Tolerances (both sides float32 on the CPU; every image enters both
steps bitwise equal, tests/test_torch_dataset.py):
- box_3d and box_2d rows: rtol 1e-4, atol 1e-4, the bound of JAX's own
  eval_batch check (tests/test_train_eval.py);
- KITTI rows: the same files, rows, types and CRLF endings, numbers
  within 1e-3 + 1e-4 |v| (the writer rounds to 3 decimals, so a value
  at a rounding edge may move by one unit in the last place);
- local xyz maps (float16 on disk): rtol 2^-9, atol 1e-3, as
  tests/test_torch_eval_step.py;
- mask PNGs: equal, except where the JAX logit is within 1e-4 of the
  threshold 0;
- the eval_val.jsonl record (losses, metrics, metrics_abs) and the
  metrics CSVs: rtol 1e-4, atol 1e-4 max(1, |v|).
Test-mode scores (0.95 MSCNN + 0.05 box fit) are asserted to lie more
than 1e-4 from the KITTI writer's threshold 0.1, so that no row can
flip between the packages; if one does not, the test fails.
"""

import copy
import json
import os
import threading

import cv2
import jax
import numpy as np
import pytest
import torch

import monopsr_torch
from monopsr_tpu.config import ConfigObj as JaxConfigObj
from monopsr_tpu.datasets.kitti.kitti_dataset import \
    KittiDataset as JaxKittiDataset
from monopsr_tpu.eval.evaluator import Evaluator as JaxEvaluator
from monopsr_tpu.models import monopsr as jax_monopsr
from monopsr_torch import constants as C
from monopsr_torch.config import ConfigObj
from monopsr_torch.datasets.kitti.kitti_dataset import KittiDataset
from monopsr_torch.eval import evaluator
from monopsr_torch.experiments import (run_evaluation, run_inference,
                                       run_training)
from monopsr_torch.ops import emd as emd_ops
from monopsr_torch.train import trainer
from monopsr_torch.utils import profiling

from tests.test_torch_train_loop import (FIXTURE, REPO, _jax_initial_state,
                                         _port_state, _raw_config, tiny_yaml)

STEP = 3


def _split(raw, split):
    raw = copy.deepcopy(raw)
    raw['dataset_config']['data_split'] = split
    if split == 'test':
        raw['dataset_config']['data_split_dir'] = 'testing'
        raw['dataset_config']['has_kitti_labels'] = False
    return raw


def _mode(split):
    return 'val' if split == 'val' else 'test'


def _jax_mask_logits(jev, variables, samples):
    """The JAX net's mask logits per sample name (the eval step packs
    them as booleans)."""
    from monopsr_tpu.train import trainer as jax_trainer
    batch = jax_trainer.stack_samples([jax_trainer.prepare_sample(
        s, jev.cfg.image_input_shape) for s in samples])
    out = jax.jit(lambda v, b: jev.net.apply(
        v, **jax_monopsr.net_inputs_from_batch(b), train=False))(
            variables, batch)
    logits = np.asarray(out[C.KEY_VALID_MASK_MAPS])
    return {s[C.SAMPLE_NAME]: logits[i] for i, s in enumerate(samples)}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp('evaluator')
    raw_j = _raw_config(base / 'jax', STEP)
    raw_t = _raw_config(base / 'torch', STEP)
    host = _jax_initial_state(JaxConfigObj(copy.deepcopy(raw_j)))
    host = host.replace(step=STEP, ema_params=jax.tree.map(
        lambda p: np.asarray(p) * np.asarray(0.9, np.asarray(p).dtype),
        host.params))

    pconfig = ConfigObj(copy.deepcopy(raw_t))
    manager = trainer.CheckpointManager(pconfig.checkpoint_dir)
    trainer.save_checkpoint(manager, _port_state(pconfig, host), STEP)

    out = dict(base=base, raw_t=raw_t, host=host)
    for split in ('val', 'test'):
        mode = _mode(split)
        jconfig = JaxConfigObj(_split(raw_j, split))
        jdataset = JaxKittiDataset(jconfig.dataset_config, mode)
        jev = JaxEvaluator(jconfig, jdataset, eval_mode=mode,
                           do_kitti_native_eval=False)
        jres = jev.run_checkpoint_once(host, STEP)
        samples = [s for s in jdataset.get_sample_dict(
            np.arange(jdataset.num_samples)) if s is not None]
        logits = _jax_mask_logits(
            jev, host.eval_variables(use_ema=True), samples)

        pconfig = ConfigObj(_split(raw_t, split))
        pev = evaluator.Evaluator(
            pconfig, KittiDataset(pconfig.dataset_config, mode), mode,
            do_kitti_native_eval=False, device='cpu')
        launches = emd_ops.emd_cost_fused.launches
        pres, = pev.run_latest_checkpoints([STEP])
        out[split] = dict(jconfig=jconfig, pconfig=pconfig, jres=jres,
                          pres=pres, logits=logits, jev=jev, pev=pev,
                          launches=emd_ops.emd_cost_fused.launches -
                          launches)
    return out


def _pred_dirs(run, kind):
    split = run['pconfig'].dataset_config.data_split
    return [os.path.join(cfg.pred_dir, kind, split, str(STEP))
            for cfg in (run['jconfig'], run['pconfig'])]


def _kitti_dir(config):
    return os.path.join(config.pred_dir, 'kitti_predictions_3d',
                        config.dataset_config.data_split, '0.1', str(STEP),
                        'data')


def _check_box_txts(run):
    for kind, cols in (('box_3d', 9), ('box_2d', 7)):
        jdir, pdir = _pred_dirs(run, kind)
        names = sorted(os.listdir(jdir))
        assert names and sorted(os.listdir(pdir)) == names
        for name in names:
            want = np.loadtxt(os.path.join(jdir, name)).reshape(-1, cols)
            got = np.loadtxt(os.path.join(pdir, name)).reshape(-1, cols)
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                       err_msg='{} {}'.format(kind, name))
    return names


def _check_kitti_files(run):
    jdir, pdir = _kitti_dir(run['jconfig']), _kitti_dir(run['pconfig'])
    names = sorted(os.listdir(jdir))
    assert names and sorted(os.listdir(pdir)) == names
    rows_seen = 0
    for name in names:
        with open(os.path.join(jdir, name), 'rb') as f:
            want = f.read()
        with open(os.path.join(pdir, name), 'rb') as f:
            got = f.read()
        if not want:
            assert got == want, name
            continue
        assert got.endswith(b'\r\n') and want.endswith(b'\r\n')
        want_rows = want.decode().split('\r\n')[:-1]
        got_rows = got.decode().split('\r\n')[:-1]
        assert len(got_rows) == len(want_rows), name
        for g, w in zip(got_rows, want_rows):
            g, w = g.split(' '), w.split(' ')
            assert len(g) == len(w) == 16 and g[:3] == w[:3], (name, g, w)
            gv, wv = np.array(g[3:], float), np.array(w[3:], float)
            assert (np.abs(gv - wv) <= 1e-3 + 1e-4 * np.abs(wv)).all(), (
                name, g, w)
            rows_seen += 1
    assert rows_seen
    return names


def _check_maps_and_masks(run, names):
    jdir, pdir = _pred_dirs(run, 'xyz_map_local')
    flipped = near_zero = 0
    for name in names:
        stem = name[:-4]
        want = np.load(os.path.join(jdir, stem + '.npy'))
        got = np.load(os.path.join(pdir, stem + '.npy'))
        assert got.dtype == want.dtype == np.float16
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32),
                                   rtol=2.0 ** -9, atol=1e-3, err_msg=stem)
        logits = run['logits'][stem]
        for idx in range(len(want)):
            png = '{}_{}.png'.format(stem, idx)
            want_mask = cv2.imread(os.path.join(jdir, png),
                                   cv2.IMREAD_GRAYSCALE)
            got_mask = cv2.imread(os.path.join(pdir, png),
                                  cv2.IMREAD_GRAYSCALE)
            differ = got_mask != want_mask
            close = np.abs(logits[idx][..., 0]) < 1e-4
            assert not (differ & ~close).any(), png
            flipped += int(differ.sum())
            near_zero += int(close.sum())
    print('mask pixels flipped {} (JAX logits within 1e-4 of 0: {})'.format(
        flipped, near_zero))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * max(1.0, abs(want)), err_msg=what)


def test_val_mode_matches_jax_evaluator(runs):
    run = runs['val']
    names = _check_box_txts(run)
    _check_kitti_files(run)
    _check_maps_and_masks(run, names)

    # the eval_val.jsonl records
    records = []
    for config in (run['jconfig'], run['pconfig']):
        with open(os.path.join(config.logdir, 'eval_val.jsonl')) as f:
            records.append([json.loads(line) for line in f])
    want, got = records[0][-1], records[1][-1]
    assert got['step'] == want['step'] == STEP
    assert got['num_samples'] == want['num_samples'] == len(names)
    for part in ('losses', 'metrics', 'metrics_abs'):
        assert sorted(got[part]) == sorted(want[part]), part
        for key, value in want[part].items():
            assert np.isfinite(got[part][key]), (part, key)
            _close(got[part][key], value, '{} {}'.format(part, key))
    assert C.METRIC_EMD in got['metrics']

    # the metrics CSVs
    for stat in ('avg', 'std', 'avg_abs', 'std_abs'):
        tables = []
        for config in (run['jconfig'], run['pconfig']):
            path = os.path.join(config.exp_output_dir, 'metrics', str(STEP),
                                'val', 'metrics_{}.csv'.format(stat))
            with open(path) as f:
                tables.append(f.read().splitlines())
        want_csv, got_csv = tables
        assert got_csv[0] == want_csv[0]
        for g, w in zip(got_csv[1].split(','), want_csv[1].split(',')):
            _close(float(g), float(w), 'metrics_{}.csv'.format(stat))

    # per-box metrics over the valid slots, returned beside the record
    per_box = run['pres']['metrics_per_box']
    assert len(per_box[C.METRIC_EMD]) == sum(
        len(np.loadtxt(os.path.join(_pred_dirs(run, 'box_3d')[1], n),
                       ndmin=2)) for n in names)
    # one metric step per dispatch group of eval_batch 4
    assert run['launches'] == 0        # the CPU runs the plain EMD
    # run_latest_checkpoints writes no ledger, as JAX's evaluator, whose
    # run_checkpoint_once left none either
    assert not os.path.exists(run['jev'].ledger_path)
    assert not os.path.exists(run['pev'].ledger_path)


def test_test_mode_matches_jax_evaluator(runs):
    run = runs['test']
    names = _check_box_txts(run)
    assert len(names) == run['pres']['num_samples'] == run['jres'][
        'num_samples']
    # no score lies within 1e-4 of the KITTI threshold (see the docstring)
    scores = np.concatenate([np.loadtxt(os.path.join(
        _pred_dirs(run, 'box_3d')[0], n), ndmin=2)[:, 7] for n in names])
    assert len(scores) and (np.abs(scores - 0.1) > 1e-4).all(), scores
    kitti = _check_kitti_files(run)
    assert len(kitti) == KittiDataset(run['pconfig'].dataset_config,
                                      'test').num_samples
    _check_maps_and_masks(run, names)
    assert set(run['pres']) == {'step', 'num_samples'}
    assert not os.path.exists(run['pev'].ledger_path)


@pytest.mark.parametrize('eval_batch', [3, 1])
def test_eval_batch_gives_the_same_boxes(runs, eval_batch, tmp_path):
    """eval_batch 3 (one full group and a padded tail of 1) and 1 against
    the default 4 (one group), within the port."""
    raw = _split(runs['raw_t'], 'val')
    raw['train_config']['eval_batch'] = eval_batch
    config = ConfigObj(raw)
    config.pred_dir = str(tmp_path / 'pred')
    ev = evaluator.Evaluator(config, KittiDataset(config.dataset_config,
                                                  'val'), 'val',
                             do_kitti_native_eval=False, device='cpu')
    assert ev.eval_batch == eval_batch
    ev.run_checkpoint_once(ev.restore_checkpoint(
        trainer.CheckpointManager(config.checkpoint_dir), STEP), STEP)
    want_dir = _pred_dirs(runs['val'], 'box_3d')[1]
    got_dir = os.path.join(config.pred_dir, 'box_3d', 'val', str(STEP))
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    for name in names:
        np.testing.assert_allclose(
            np.loadtxt(os.path.join(got_dir, name)),
            np.loadtxt(os.path.join(want_dir, name)), rtol=1e-4, atol=1e-4,
            err_msg=name)


def test_eval_data_parallel_2_runs_as_jax_on_one_device(runs):
    """data_parallel and eval_data_parallel 2 on one device: the JAX
    evaluator clamps its mesh to the devices present; so does the port's,
    and writes the same files as the JAX evaluator under the same
    config."""
    raw_j = _split(_raw_config(runs['base'] / 'jax_dp2', STEP), 'val')
    raw_t = _split(runs['raw_t'], 'val')
    for raw in (raw_j, raw_t):
        raw['train_config']['data_parallel'] = 2
        raw['train_config']['eval_data_parallel'] = 2
    jconfig = JaxConfigObj(raw_j)
    jev = JaxEvaluator(jconfig, JaxKittiDataset(jconfig.dataset_config,
                                                'val'),
                       eval_mode='val', do_kitti_native_eval=False)
    jev.run_checkpoint_once(runs['host'], STEP)
    pconfig = ConfigObj(raw_t)          # restores the shared checkpoint,
    out_dir = runs['base'] / 'torch_dp2'  # writes apart
    pconfig.exp_output_dir = str(out_dir)
    pconfig.logdir = str(out_dir / 'logs')
    pconfig.pred_dir = str(out_dir / 'predictions')
    pev = evaluator.Evaluator(
        pconfig, KittiDataset(pconfig.dataset_config, 'val'), 'val',
        do_kitti_native_eval=False, device='cpu')
    assert pev.eval_batch == jev.eval_batch == 4
    pev.run_latest_checkpoints([STEP])
    run = dict(runs['val'], jconfig=jconfig, pconfig=pconfig)
    names = _check_box_txts(run)
    _check_kitti_files(run)
    _check_maps_and_masks(run, names)


def test_ledger_matches_jax_evaluator(runs, monkeypatch, tmp_path):
    """Which steps each polling call evaluates and what the ledger
    holds after each call, the JAX evaluator's and the port's, on the
    same checkpoint steps (the evaluation itself stubbed out):
    run_latest_checkpoints leaves the ledger alone, only
    repeated_checkpoint_run appends."""
    from monopsr_tpu.train import trainer as jax_trainer

    class Manager:
        def __init__(self, *args, **kwargs):
            pass

        def all_steps(self):
            return list(steps)

    steps = [2, 4]
    monkeypatch.setattr(jax_trainer, 'create_checkpoint_manager', Manager)
    monkeypatch.setattr(evaluator.trainer_lib, 'CheckpointManager', Manager)
    history = {}
    for name, ev in (('jax', runs['val']['jev']),
                     ('port', runs['val']['pev'])):
        done = []
        monkeypatch.setattr(ev, 'ledger_path',
                            str(tmp_path / (name + '_evaluated_val.txt')))
        monkeypatch.setattr(ev, 'eval_wait_interval', 0)
        monkeypatch.setattr(ev, 'restore_checkpoint', lambda *a: None)
        monkeypatch.setattr(ev, 'run_checkpoint_once',
                            lambda state, step: done.append(step))
        monkeypatch.setattr(ev, '_first_valid_sample', lambda: None,
                            raising=False)

        def ledger():
            if not os.path.exists(ev.ledger_path):
                return None
            with open(ev.ledger_path) as f:
                return f.read()

        calls = []
        steps[:] = [2, 4]
        for call in (lambda: ev.run_latest_checkpoints('all'),
                     lambda: ev.repeated_checkpoint_run(1),
                     lambda: steps.append(6),
                     lambda: ev.run_latest_checkpoints([6]),
                     lambda: ev.repeated_checkpoint_run(1),
                     lambda: ev.run_latest_checkpoints(None)):
            del done[:]
            call()
            calls.append((list(done), ledger()))
        history[name] = calls
    assert history['port'] == history['jax']
    assert history['jax'] == [([2, 4], None), ([2, 4], '2\n4\n'),
                              ([], '2\n4\n'), ([6], '2\n4\n'),
                              ([6], '2\n4\n6\n'),
                              ([2, 4, 6], '2\n4\n6\n')]


def test_restore_reads_the_eval_weights_only(runs):
    """The evaluator's state has no optimizer state; its restore copies
    the parameters, the EMA and the batch stats of the checkpoint."""
    pconfig = ConfigObj(_split(runs['raw_t'], 'val'))
    ev = evaluator.Evaluator(pconfig, KittiDataset(pconfig.dataset_config,
                                                   'val'), 'val',
                             do_kitti_native_eval=False, device='cpu')
    state = ev.restore_checkpoint(
        trainer.CheckpointManager(pconfig.checkpoint_dir), STEP)
    assert state.opt_state is None and state.step == STEP
    saved = torch.load(trainer.CheckpointManager(
        pconfig.checkpoint_dir).path(STEP), weights_only=True)
    for part in ('params', 'ema_params', 'batch_stats'):
        for key, value in getattr(state, part).items():
            assert torch.equal(value, saved[part][key]), (part, key)
    # the EMA goes into the net, not the parameters
    net_state = ev.net.state_dict()
    key = next(iter(saved['params']))
    assert not torch.equal(saved['params'][key], saved['ema_params'][key])
    ev.net.load_state_dict(state.eval_variables(use_ema=True))
    assert torch.equal(net_state[key], saved['ema_params'][key])


def _assert_same_record(got, want, where='record'):
    assert sorted(got) == sorted(want), where
    for key, value in want.items():
        if isinstance(value, dict):
            _assert_same_record(got[key], value, key)
        else:
            np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_recording_keeps_the_answers_and_names_every_group(
        runs, monkeypatch, tmp_path):
    """A val pass of the fixture's evaluator with the program's recording
    off and one with it on: both write the fixture's files and return its
    record, bit for bit, with the same span totals and counters. With it
    on, each group has one 'eval.dispatch' on the dispatching thread, and
    the producers' and the pipeline worker's spans come out with their
    threads, parents and items."""
    run = runs['val']
    ev = run['pev']
    kinds = ('box_3d', 'box_2d', 'xyz_map_local')
    want_dirs = {kind: _pred_dirs(run, kind)[1] for kind in kinds}
    state = ev.restore_checkpoint(
        trainer.CheckpointManager(run['pconfig'].checkpoint_dir), STEP)
    totals = []
    for on in (False, True):
        out = tmp_path / ('on' if on else 'off')
        for key in ('pred_dir', 'logdir', 'exp_output_dir'):
            monkeypatch.setattr(ev.config, key, str(out / key))
        if on:
            with profiling.recording() as rec:
                result = ev.run_checkpoint_once(state, STEP)
        else:
            result = ev.run_checkpoint_once(state, STEP)
        ev._close_tb()
        _assert_same_record(result, run['pres'])
        for kind, want_dir in want_dirs.items():
            got_dir = os.path.join(str(out / 'pred_dir'), kind, 'val',
                                   str(STEP))
            names = sorted(os.listdir(want_dir))
            assert names and sorted(os.listdir(got_dir)) == names, kind
            for name in names:
                with open(os.path.join(got_dir, name), 'rb') as g, \
                        open(os.path.join(want_dir, name), 'rb') as w:
                    assert g.read() == w.read(), (kind, name)
        spans, counters = ev.stage_times.totals()
        totals.append(({name: n for name, (_, n) in spans.items()},
                       counters))
    assert totals[0] == totals[1]
    counters = totals[1][1]
    groups = ev.kernel_launches['groups']
    assert counters['eval.groups'] == groups
    assert counters['eval.frames'] == result['num_samples']

    main = threading.get_native_id()
    by_name = {}
    for iv in rec.intervals:
        by_name.setdefault(iv.name, []).append(iv)
        assert iv.start_ns <= iv.end_ns
    dispatch = by_name['eval.dispatch']
    assert sorted(iv.item for iv in dispatch) == list(range(groups))
    assert {iv.thread for iv in dispatch} == {main}
    spans = {iv.span: iv for iv in rec.intervals}
    root, = by_name['eval.pass']
    assert {spans[iv.parent].name for iv in dispatch} == {'eval.pass'}
    for child, parent in (('eval.stack', 'eval.dispatch'),
                          ('eval.pull_start', 'eval.dispatch'),
                          ('eval.assembly.read', 'eval.assembly'),
                          ('eval.assembly.prepare', 'eval.assembly')):
        for iv in by_name[child]:
            assert spans[iv.parent].name == parent, child
            assert spans[iv.parent].item == iv.item, child
    assembly = by_name['eval.assembly']
    assert len(assembly) == result['num_samples']
    assert {iv.item for iv in assembly} <= set(range(ev.dataset.num_samples))
    assert {iv.thread for iv in assembly}.isdisjoint({main})
    assert {iv.parent for iv in assembly} == {None}
    worker = {iv.thread for iv in by_name['eval.format']}
    assert len(worker) == 1 and worker.isdisjoint({main})
    assert sorted(iv.item for iv in by_name['eval.format']) == sorted(
        iv.item for iv in assembly)
    assert len(by_name['eval.pull']) == groups
    for name in ('eval.groups', 'eval.feed_wait', 'eval.drain',
                 'eval.metrics_csv', 'eval.log', 'eval.kitti_files'):
        assert by_name[name] and all(
            spans[iv.parent] is root for iv in by_name[name]), name


# --------------------------------------------------------------------------
# The CLIs
# --------------------------------------------------------------------------

def _eval_records(out_dir, split):
    with open(out_dir / 'logs' / 'eval_{}.jsonl'.format(split)) as f:
        return [json.loads(line) for line in f]


def test_cli_main_runs_on_cpu(tmp_path, monkeypatch, capsys):
    with open(os.path.join(REPO, 'configs', 'monopsr_model_000.yaml')) as f:
        text = tiny_yaml(f.read(), FIXTURE, 2)
    path = tmp_path / 'tiny_eval.yaml'
    path.write_text(text)
    monkeypatch.setattr(monopsr_torch, 'data_dir', lambda: str(tmp_path))
    run_training.main(['--config_path', str(path), '--device', 'cpu'])
    out_dir = tmp_path / 'outputs' / 'tiny_eval'
    capsys.readouterr()

    results = run_evaluation.main(['--config_path', str(path),
                                   '--device', 'cpu'])
    assert [r['step'] for r in results] == [2]
    # without --repeated no ledger is written (JAX: only the polling loop
    # writes it; test_ledger_matches_jax_evaluator)
    assert not (out_dir / 'evaluated_val.txt').exists()
    record, = _eval_records(out_dir, 'val')
    assert all(np.isfinite(v) for v in record['losses'].values())
    pred = out_dir / 'predictions'
    names = sorted(os.listdir(pred / 'box_3d' / 'val' / '2'))
    assert names and len(names) == record['num_samples']
    for regime in ('', 'low_iou_'):
        text = (pred / 'tiny_eval_results_{}0.1.txt'.format(regime)
                ).read_text()
        assert text.startswith('step 2\n')
        assert 'car_detection_3D AP:' in text and 'Done.' in text
    out = capsys.readouterr().out
    assert 'restored checkpoint 2 in ' in out
    assert 'kernel launches: emd_cost_fused 0, emd_loss 0 in 1 groups' in out
    assert 'native eval of step 2: ' in out

    # inference on val, then on the test split (no labels)
    run_inference.main(['--config_path', str(path), '--device', 'cpu',
                        '--ckpt_num', '2'])
    record = _eval_records(out_dir, 'val')[-1]
    assert set(record) == {'step', 'num_samples'} and record['num_samples']
    results = run_inference.main(['--config_path', str(path), '--data_split',
                                  'test', '--device', 'cpu'])
    assert [r['step'] for r in results] == [2]
    test_txts = os.listdir(pred / 'box_3d' / 'test' / '2')
    kitti = os.listdir(pred / 'kitti_predictions_3d' / 'test' / '0.1' / '2' /
                       'data')
    assert len(test_txts) == len(kitti) == 10
    # the frozen config (copied there by the training CLI) by
    # --checkpoint_name, with the MSCNN thresholds given
    run_inference.main(['--checkpoint_name', 'tiny_eval', '--device', 'cpu',
                        '--ckpt_num', 'all', '--det_2d_score_thr', '0.2',
                        '0.2', '0.2'])
    assert not (out_dir / 'evaluated_val.txt').exists()
