"""monopsr_torch's training loop (``trainer.train``) against the JAX
package's ``trainer.train`` on the KITTI fixture, and the loop's parts:
checkpoints, resume, pruning, the pretrained NPZ loader, the CLI.

The tiny configuration of tests/test_train_eval.py (resnet_tiny, float32,
2 boxes, 48x160 input, the production loss_config, Adam 1e-4 with the
staircase decay, EMA 0.99), dataset seed 0, one prefetch thread, on the
CPU. The JAX loop initialises its net with PRNGKey(0) on the first valid
sample; that initial state is built the same way here, carried across
with ``weights.train_state_from_flax`` and saved as the port's step-0
checkpoint, so the port's loop resumes from it. Both loops then read the
same samples in the same order (the first valid sample consumed for the
init, then the prefetching loader's epochs) and take three steps.

Tolerances: per step, each logged loss within rtol 1e-4 plus atol 1e-4
of max(1, |loss|), as tests/test_torch_train_step.py holds three steps
from a shared state; the learning rate exactly. The image enters both
steps bitwise equal (tests/test_torch_dataset.py: the port's resize is
OpenCV's arithmetic, exact on this host), so the resize moves no loss
here; a 1 LSB difference would move the uint8 input by 1/255 before the
mean subtraction.
"""

import copy
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

import monopsr_torch
from monopsr_tpu.config import ConfigObj as JaxConfigObj
from monopsr_tpu.datasets.kitti.kitti_dataset import \
    KittiDataset as JaxKittiDataset
from monopsr_tpu.models import monopsr as jax_monopsr
from monopsr_tpu.train import optimizer as jax_opt
from monopsr_tpu.train import pretrained as jax_pretrained
from monopsr_tpu.train import trainer as jax_trainer
from monopsr_tpu.train.train_state import TrainState as JaxTrainState
from monopsr_torch import weights
from monopsr_torch.config import ConfigObj
from monopsr_torch.datasets.kitti.kitti_dataset import KittiDataset
from monopsr_torch.experiments import run_training
from monopsr_torch.models import monopsr_net as torch_net
from monopsr_torch.train import optimizer, pretrained, trainer
from monopsr_torch.train.train_state import TrainState

from tests.test_train_eval import make_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, 'tests', 'datasets', 'Kitti', 'object')


def _raw_config(out_dir, max_iterations):
    raw = make_config(out_dir, max_iterations=max_iterations).to_dict()
    raw['dataset_config']['seed'] = 0
    raw['train_config']['prefetch_threads'] = 1
    raw['train_config']['tensorboard'] = False
    return raw


def _log(config):
    with open(os.path.join(config.logdir, 'train_log.jsonl')) as f:
        return [json.loads(line) for line in f]


def _loss_records(log):
    return {r['step']: r for r in log if 'total_loss' in r}


def _jax_initial_state(jconfig):
    """The state JAX's train() starts from (trainer.py:217-236)."""
    dataset = JaxKittiDataset(jconfig.dataset_config, 'train')
    net, cfg = jax_monopsr.create_net(jconfig.model_config,
                                      jconfig.dataset_config)
    tx, _, use_ema, _ = jax_opt.build_optimizer(jconfig.train_config,
                                                clip_gradient_norm=1.0)
    sample = jax_trainer._first_valid_sample(dataset, cfg)
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(lambda s: net.init(
        rng, **jax_monopsr.net_inputs_from_batch(s), train=False))(sample)
    state = jax.jit(lambda v: JaxTrainState.create(
        v, tx, use_ema=use_ema))(variables)
    return jax.device_get(state)


def _port_state(pconfig, host):
    cfg = torch_net.NetConfig.from_model_config(pconfig.model_config,
                                                pconfig.dataset_config)
    tx, _, _, _ = optimizer.build_optimizer(pconfig.train_config.to_dict())
    return weights.train_state_from_flax(
        torch_net.MonoPSRNet(cfg), tx, host.step, host.params,
        host.batch_stats, host.opt_state, host.ema_params)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp('loop')
    raw_j = _raw_config(base / 'jax', 3)
    raw_t = _raw_config(base / 'torch', 3)
    jconfig = JaxConfigObj(copy.deepcopy(raw_j))
    pconfig = ConfigObj(copy.deepcopy(raw_t))

    host = _jax_initial_state(JaxConfigObj(copy.deepcopy(raw_j)))
    start = _port_state(pconfig, host)
    trainer.save_checkpoint(trainer.CheckpointManager(pconfig.checkpoint_dir),
                            start, 0)

    jax_trainer.train(jconfig, JaxKittiDataset(jconfig.dataset_config,
                                               'train'))
    state = trainer.train(pconfig, KittiDataset(pconfig.dataset_config,
                                                'train'), device='cpu')
    return dict(base=base, raw_j=raw_j, raw_t=raw_t, jconfig=jconfig,
                pconfig=pconfig, state=state, host=host,
                jax_log=_log(jconfig), port_log=_log(pconfig))


def _check_losses(got, want, steps):
    assert sorted(got) == sorted(want) == steps
    worst = 0.0
    for step in steps:
        g, w = got[step], want[step]
        assert set(g) == set(w)
        assert g['learning_rate'] == w['learning_rate'], step
        for key, value in w.items():
            if key in ('step', 'steps_per_sec', 'learning_rate'):
                continue
            np.testing.assert_allclose(
                g[key], value, rtol=1e-4, atol=1e-4 * max(1.0, abs(value)),
                err_msg='step {} {}'.format(step, key))
            assert np.isfinite(g[key])
            worst = max(worst, abs(g[key] - value) / max(1.0, abs(value)))
    print('steps {}: worst loss difference {:.2e} of max(1, |loss|)'.format(
        steps, worst))


def test_three_steps_track_jax_train(runs):
    got = _loss_records(runs['port_log'])
    want = _loss_records(runs['jax_log'])
    _check_losses(got, want, [1, 2, 3])
    # the losses move from step to step (different samples, updates)
    assert len({round(r['total_loss'], 6) for r in got.values()}) == 3
    state = runs['state']
    assert state.step == 3 and int(state.opt_state['count']) == 3
    manager = trainer.CheckpointManager(runs['pconfig'].checkpoint_dir)
    assert manager.all_steps() == [0, 2, 3]


def test_resume_continues_from_latest_checkpoint(runs):
    pconfig = ConfigObj(copy.deepcopy(runs['raw_t']))
    pconfig.train_config.max_iterations = 5
    first = runs['state']

    # what the second call restores: the step-3 state, moments and EMA
    fresh = _port_state(pconfig, _jax_initial_state(
        JaxConfigObj(copy.deepcopy(runs['raw_j']))))
    manager = trainer.CheckpointManager(pconfig.checkpoint_dir)
    fresh, step = trainer.restore_latest(manager, fresh)
    assert step == 3 and fresh.step == 3
    assert int(fresh.opt_state['count']) == 3
    for part in ('params', 'ema_params', 'batch_stats'):
        for key, value in getattr(first, part).items():
            assert torch.equal(getattr(fresh, part)[key], value), (part, key)
    for moment in ('mu', 'nu'):
        for key, value in first.opt_state[moment].items():
            assert torch.equal(fresh.opt_state[moment][key], value)

    state = trainer.train(pconfig, KittiDataset(pconfig.dataset_config,
                                                'train'), device='cpu')
    assert state.step == 5 and int(state.opt_state['count']) == 5
    log = _loss_records(_log(pconfig))
    assert sorted(log) == [1, 2, 3, 4, 5]       # continued, not restarted
    assert manager.all_steps() == [0, 2, 3, 4, 5]

    # The JAX loop resumed the same way takes the same two steps
    jconfig = JaxConfigObj(copy.deepcopy(runs['raw_j']))
    jconfig.train_config.max_iterations = 5
    jax_trainer.train(jconfig, JaxKittiDataset(jconfig.dataset_config,
                                               'train'))
    _check_losses({k: v for k, v in log.items() if k > 3},
                  {k: v for k, v in _loss_records(_log(jconfig)).items()
                   if k > 3}, [4, 5])


def test_data_parallel_2_runs_as_jax_on_one_device(runs):
    """data_parallel 2 on one device: the JAX loop clamps its mesh to the
    devices present and trains at batch 1 x batch_size; so does the
    port's, from the same initial state, giving the same JSONL."""
    raw_j = _raw_config(runs['base'] / 'jax_dp2', 2)
    raw_t = _raw_config(runs['base'] / 'torch_dp2', 2)
    for raw in (raw_j, raw_t):
        raw['train_config']['data_parallel'] = 2
    jconfig, pconfig = JaxConfigObj(raw_j), ConfigObj(raw_t)
    trainer.save_checkpoint(
        trainer.CheckpointManager(pconfig.checkpoint_dir),
        _port_state(pconfig, runs['host']), 0)
    jax_trainer.train(jconfig, JaxKittiDataset(jconfig.dataset_config,
                                               'train'))
    state = trainer.train(pconfig, KittiDataset(pconfig.dataset_config,
                                                'train'), device='cpu')
    assert state.step == 2
    _check_losses(_loss_records(_log(pconfig)), _loss_records(_log(jconfig)),
                  [1, 2])


def test_max_checkpoints_to_keep_prunes(tmp_path):
    net = torch.nn.Linear(3, 2)
    tx, _, _, _ = optimizer.build_optimizer({'optimizer': {
        'optimizer_type': 'adam_optimizer',
        'adam_optimizer': {'learning_rate_type': 'constant',
                           'learning_rate': 0.1}}})
    state = TrainState.create(net, tx, use_ema=True)
    manager = trainer.CheckpointManager(str(tmp_path / 'ckpt'),
                                        max_to_keep=2)
    for step in range(1, 5):
        state.apply_gradients({k: torch.ones_like(v) * step
                               for k, v in state.params.items()}, tx, 0.5)
        trainer.save_checkpoint(manager, state, step)
    assert manager.all_steps() == [3, 4]
    assert sorted(os.listdir(manager.directory)) == ['3', '4']
    # a checkpoint being written (its temporary file) is not listed
    os.makedirs(os.path.join(manager.directory, '7'))
    open(manager.path(7) + '.tmp', 'wb').close()
    assert manager.latest_step() == 4

    other = TrainState.create(torch.nn.Linear(3, 2), tx, use_ema=True)
    other, step = trainer.restore_latest(manager, other)
    assert step == 4 and other.step == 4
    for part in ('params', 'ema_params'):
        for key, value in getattr(state, part).items():
            assert torch.equal(getattr(other, part)[key], value)
    assert int(other.opt_state['count']) == 4
    with pytest.raises(ValueError, match='do not match'):
        trainer.restore_latest(manager, TrainState.create(
            torch.nn.Linear(3, 2), tx, use_ema=False))


def test_pretrained_npz_fills_both_towers_as_jax(tmp_path, monkeypatch):
    """An NPZ in the JAX package's format (flax layout, 'scope/leaf'
    keys) loads into both towers and the EMA, as the JAX loader loads it
    into the flax variables."""
    raw = _raw_config(tmp_path, 1)
    jconfig = JaxConfigObj(copy.deepcopy(raw))
    host = _jax_initial_state(jconfig)
    rng = np.random.RandomState(0)
    npz = {}
    for tree in ('params', 'batch_stats'):
        tower = getattr(host, tree)['backbone']['tower_crop']

        def walk(node, prefix):
            for key, value in node.items():
                if isinstance(value, dict) or hasattr(value, 'items'):
                    walk(value, prefix + (key,))
                else:
                    value = np.asarray(value)
                    npz['/'.join(prefix + (key,))] = (
                        value + rng.uniform(0.5, 1.0, value.shape)).astype(
                            value.dtype)
        walk(tower, ())
    npz_path = tmp_path / 'pretrained' / 'trunk.npz'
    npz_path.parent.mkdir()
    np.savez(npz_path, **npz)

    want = {'params': jax.tree.map(np.array, host.params),
            'batch_stats': jax.tree.map(np.array, host.batch_stats)}
    loaded = (jax_pretrained.load_npz_into_towers(want['params'], npz_path) +
              jax_pretrained.load_npz_into_towers(want['batch_stats'],
                                                  npz_path))
    assert loaded == 2 * len(npz)

    pconfig = ConfigObj(copy.deepcopy(raw))
    pconfig.model_config.net_config.resnet101_4x_squash.\
        pretrained_weights_type = 'npz'
    pconfig.model_config.net_config.resnet101_4x_squash.\
        pretrained_weights_name = 'trunk'
    monkeypatch.setattr(monopsr_torch, 'data_dir', lambda: str(tmp_path))
    state = _port_state(pconfig, host)
    pretrained.maybe_load_pretrained(state, pconfig.model_config)
    expected = weights.from_flax_variables(want)
    for part in ('params', 'batch_stats'):
        for key, value in getattr(state, part).items():
            if 'num_batches' in key:
                continue
            assert torch.equal(value.detach(), expected[key]), key
    for key, value in state.params.items():
        assert torch.equal(state.ema_params[key], value.detach()), key
    # and without the file, the random init stays
    monkeypatch.setattr(monopsr_torch, 'data_dir',
                        lambda: str(tmp_path / 'none'))
    before = {k: v.detach().clone() for k, v in state.params.items()}
    pretrained.maybe_load_pretrained(state, pconfig.model_config)
    assert all(torch.equal(state.params[k], v) for k, v in before.items())


def test_loader_hands_a_thread_failure_to_the_consumer():
    from monopsr_torch.train.input_pipeline import PrefetchingLoader

    class Broken:
        def next_batch(self, batch_size, shuffle):
            raise FileNotFoundError('Image not found: x.png')

    loader = PrefetchingLoader(Broken(), 1, (48, 160), num_threads=2)
    try:
        with pytest.raises(RuntimeError, match='input pipeline') as info:
            loader.get_batch(timeout=30)
        assert isinstance(info.value.__cause__, FileNotFoundError)
    finally:
        loader.stop()
    assert not any(t.is_alive() for t in loader._threads)


def test_loop_refuses_unported_options(tmp_path, monkeypatch):
    # data_parallel is clamped to the visible devices: it raises only
    # where more than one is left (two devices counted here)
    from monopsr_torch.utils import device as device_lib
    monkeypatch.setattr(device_lib, 'visible_device_count', lambda d: 2)
    for key, value, match in (('data_parallel', 2, 'M16'),
                              ('summary_images', True, 'M18')):
        pconfig = ConfigObj(_raw_config(tmp_path, 1))
        if key == 'summary_images':
            pconfig.summary_images = value
        else:
            setattr(pconfig.train_config, key, value)
        with pytest.raises(NotImplementedError, match=match):
            trainer.train(pconfig, None, device='cpu')


def tiny_yaml(text, fixture, max_iterations):
    """configs/monopsr_model_000.yaml cut to the tiny test widths by text
    substitution."""
    subs = {
        'dataset_dir': "'{}'".format(fixture),
        'seed': '0', 'num_boxes': '2', 'image_input_shape': '[48, 160]',
        'resized_full_img_shape': '[24, 80]', 'img_roi_size': '[16, 16]',
        'map_roi_size': '[16, 16]', 'layer_sizes': '[16, 16]',
        'compute_dtype': "'float32'\n    resnet: 'resnet_tiny'",
        'max_iterations': str(max_iterations), 'summary_interval': '1',
        'checkpoint_interval': '2',
    }
    for key, value in subs.items():
        text, n = re.subn(r'(?m)^(\s*{}:)[^#\n]*'.format(key),
                          lambda m: m.group(1) + ' ' + value, text)
        assert n >= 1, key
    return text.replace('    dataset_dir:', "    mscnn_dir: '{}/mscnn'\n"
                        "    dataset_dir:".format(fixture))


def test_cli_main_runs_on_cpu(tmp_path, monkeypatch, capsys):
    with open(os.path.join(REPO, 'configs', 'monopsr_model_000.yaml')) as f:
        text = tiny_yaml(f.read(), FIXTURE, 2)
    text = text.replace('    checkpoint_interval: 2\n',
                        '    checkpoint_interval: 2\n    profile_step: 2\n')
    path = tmp_path / 'tiny_cli.yaml'
    path.write_text(text)
    monkeypatch.setattr(monopsr_torch, 'data_dir', lambda: str(tmp_path))
    run_training.main(['--config_path', str(path), '--device', 'cpu'])
    out_dir = tmp_path / 'outputs' / 'tiny_cli'
    assert (out_dir / 'tiny_cli.yaml').read_text() == text
    assert sorted(os.listdir(out_dir / 'checkpoints')) == ['2']
    with open(out_dir / 'logs' / 'train_log.jsonl') as f:
        log = [json.loads(line) for line in f]
    assert [r['step'] for r in log] == [1, 2]
    assert all(np.isfinite(r['total_loss']) for r in log)
    with open(out_dir / 'logs' / 'profile' / 'train_step_2.json') as f:
        assert json.load(f)['traceEvents']     # the profiled step's trace
    out = capsys.readouterr().out
    assert 'not found; training from random init' in out   # no NPZ here
    assert 'checkpoint 2: ' in out
