"""monopsr_torch's ``steps_per_dispatch`` against the JAX trainer's.

The tiny configuration of tests/test_train_eval.py with the dataset seeded
at 7, as tests/test_steps_per_dispatch.py trains it (a seeded stream gives
both packages and every K the same batches), one prefetch thread, on the
CPU. K > 1 runs each dispatch's K steps eagerly here; on one CUDA card
they are replays of a CUDA graph (tests/test_torch_kernels_cuda.py).

- The logged steps and the checkpoint directories at K = 3 (summary and
  checkpoint interval 2, 7 steps: two dispatches, then a tail of one
  single step) are the JAX loop's: logs at the steps that crossed an
  interval, checkpoints there and at the last step.
- The final parameters at K = 2 and 3 equal K = 1's within
  tests/test_steps_per_dispatch.py's bounds, rtol 2e-5 and atol 1e-6.
- At K = 2 from the JAX loop's initial state, carried across as
  tests/test_torch_train_loop.py carries it, the logged losses of a
  dispatch and its tail (3 steps) agree with the JAX loop's at K = 2
  within that file's bounds, which are stated for three steps. (At a
  fourth step the port and JAX drift apart by 2.4e-4 of the local xyz
  loss at K = 1 as at K = 2, beyond them: the drift of the float32
  steps, not of the dispatch.)
- The summary images come from the dispatch's last batch; ``profile_step``
  forces K = 1.
"""

import copy
import os

import numpy as np
import pytest
import torch

from monopsr_tpu.config import ConfigObj as JaxConfigObj
from monopsr_tpu.datasets.kitti.kitti_dataset import \
    KittiDataset as JaxKittiDataset
from monopsr_tpu.train import trainer as jax_trainer
from monopsr_torch.config import ConfigObj
from monopsr_torch.datasets.kitti.kitti_dataset import KittiDataset
from monopsr_torch.train import trainer

from tests.test_torch_train_loop import (_check_losses, _jax_initial_state,
                                         _log, _loss_records, _port_state)
from tests.test_train_eval import make_config


def _raw(out_dir, max_iterations, k, **train):
    raw = make_config(out_dir, max_iterations=max_iterations).to_dict()
    raw['dataset_config']['seed'] = 7
    raw['train_config'].update(prefetch_threads=1, tensorboard=False,
                               steps_per_dispatch=k, **train)
    return raw


def _train_port(raw):
    config = ConfigObj(copy.deepcopy(raw))
    state = trainer.train(config, KittiDataset(config.dataset_config,
                                               'train'), device='cpu')
    return state, config


def _train_jax(raw):
    config = JaxConfigObj(copy.deepcopy(raw))
    jax_trainer.train(config, JaxKittiDataset(config.dataset_config,
                                              'train'))
    return config


def _checkpoint_steps(config):
    return sorted(int(name) for name in os.listdir(config.checkpoint_dir)
                  if name.isdigit())


def test_logs_and_checkpoints_at_the_jax_loops_steps(tmp_path):
    raw = _raw(tmp_path / 'k3', 7, 3, summary_interval=2,
               checkpoint_interval=2)
    jconfig = _train_jax(_raw(tmp_path / 'jax_k3', 7, 3, summary_interval=2,
                              checkpoint_interval=2))
    state, pconfig = _train_port(raw)
    want_logs = sorted(_loss_records(_log(jconfig)))
    assert want_logs == [3, 6]                 # crossed at 3 and 6
    assert sorted(_loss_records(_log(pconfig))) == want_logs
    assert _checkpoint_steps(jconfig) == [3, 6, 7]
    assert _checkpoint_steps(pconfig) == _checkpoint_steps(jconfig)
    assert state.step == 7 and int(state.opt_state['count']) == 7


@pytest.fixture(scope='module')
def one_step_dispatch(tmp_path_factory):
    state, _ = _train_port(_raw(tmp_path_factory.mktemp('k1'), 4, 1))
    return {k: v.detach().clone() for k, v in state.params.items()}


@pytest.mark.parametrize('k', [2, 3])
def test_k_steps_per_dispatch_match_one(tmp_path, one_step_dispatch, k):
    state, config = _train_port(_raw(tmp_path / 'k', 4, k))
    assert state.step == 4
    for name, want in one_step_dispatch.items():
        np.testing.assert_allclose(state.params[name].detach().numpy(),
                                   want.numpy(), rtol=2e-5, atol=1e-6,
                                   err_msg=name)
    # checkpoints at the crossings of interval 2 and at the last step
    assert _checkpoint_steps(config) == {2: [2, 4], 3: [3, 4]}[k]


def test_two_steps_per_dispatch_track_jax(tmp_path):
    # one dispatch of 2, then a tail of 1: the three steps from a shared
    # state over which tests/test_torch_train_loop.py's bounds are stated
    raw_j = _raw(tmp_path / 'jax_k2', 3, 2, summary_interval=1)
    raw_t = _raw(tmp_path / 'torch_k2', 3, 2, summary_interval=1)
    pconfig = ConfigObj(copy.deepcopy(raw_t))
    host = _jax_initial_state(JaxConfigObj(copy.deepcopy(raw_j)))
    trainer.save_checkpoint(trainer.CheckpointManager(pconfig.checkpoint_dir),
                            _port_state(pconfig, host), 0)
    jconfig = _train_jax(raw_j)
    state, pconfig = _train_port(raw_t)
    assert state.step == 3
    _check_losses(_loss_records(_log(pconfig)), _loss_records(_log(jconfig)),
                  [2, 3])


def test_summary_images_come_from_the_dispatchs_last_batch(tmp_path,
                                                           monkeypatch):
    from monopsr_torch.train import input_pipeline
    fetched, drawn = [], []
    get_batch = input_pipeline.PrefetchingLoader.get_batch
    save_grids = trainer._save_feature_grids

    def recording_get_batch(self, *args, **kwargs):
        fetched.append(get_batch(self, *args, **kwargs))
        return fetched[-1]

    def recording_save(net, batch, logdir, step, device):
        drawn.append((step, batch))
        save_grids(net, batch, logdir, step, device)

    monkeypatch.setattr(input_pipeline.PrefetchingLoader, 'get_batch',
                        recording_get_batch)
    monkeypatch.setattr(trainer, '_save_feature_grids', recording_save)
    raw = _raw(tmp_path / 'imgs', 4, 2, summary_interval=1)
    raw['summary_images'] = True
    _, config = _train_port(raw)
    assert len(fetched) == 4
    assert [step for step, _ in drawn] == [2, 4]
    assert drawn[0][1] is fetched[1] and drawn[1][1] is fetched[3]
    # the two batches of a dispatch differ, so the choice shows
    assert not np.array_equal(fetched[0]['image'], fetched[1]['image'])
    images = sorted(os.listdir(os.path.join(config.logdir, 'images')))
    assert images == ['{}_features_for_{}.png'.format(step, name)
                      for step in (2, 4) for name in ('box_3d', 'map')]


def test_profile_step_forces_one_step_per_dispatch(tmp_path):
    assert trainer.steps_per_dispatch({'steps_per_dispatch': 3}) == 3
    for k in (None, 0, 1):
        assert trainer.steps_per_dispatch({'steps_per_dispatch': k}) == 1
    assert trainer.steps_per_dispatch({}) == 1
    assert trainer.steps_per_dispatch(
        {'steps_per_dispatch': 3, 'profile_step': 2}) == 1

    raw = _raw(tmp_path / 'prof', 3, 3, summary_interval=1, profile_step=2)
    state, config = _train_port(raw)
    # at K = 3 the one dispatch would log step 3 only
    assert sorted(_loss_records(_log(config))) == [1, 2, 3]
    assert os.path.exists(os.path.join(config.logdir, 'profile',
                                       'train_step_2.json'))
    assert state.step == 3 and torch.is_tensor(state.opt_state['count'])


def test_data_parallel_ranks_keep_the_dispatch_rules_eagerly(tmp_path,
                                                             monkeypatch,
                                                             capfd):
    """``data_parallel: 2`` with K = 2 through the training CLI: two gloo
    ranks on the CPU (the parent counts two devices, as
    tests/test_torch_data_parallel.py's CLI tests do) log and checkpoint
    at the JAX loop's steps (a dispatch of 2, then a tail step) and rank
    0 says once that the dispatch runs eagerly."""
    import monopsr_torch
    from monopsr_torch import config as config_lib
    from monopsr_torch.experiments import run_training
    from monopsr_torch.utils import device as device_lib
    from tests.test_torch_train_loop import FIXTURE, REPO, tiny_yaml

    with open(os.path.join(REPO, 'configs', 'monopsr_model_000.yaml')) as f:
        raw = config_lib.parse_yaml(tiny_yaml(f.read(), FIXTURE, 3))
    raw['train_config'].update(tensorboard=False, data_parallel=2,
                               steps_per_dispatch=2, checkpoint_interval=2)
    path = str(tmp_path / 'dp_k2.yaml')
    config_lib.dump_yaml(raw, path)
    monkeypatch.setattr(monopsr_torch, 'data_dir', lambda: str(tmp_path))
    monkeypatch.setattr(device_lib, 'visible_device_count', lambda d: 2)
    run_training.main(['--config_path', path, '--device', 'cpu'])
    out = capfd.readouterr().out
    assert out.count('steps_per_dispatch 2: under 2 data-parallel ranks '
                     'the steps of a dispatch run eagerly') == 1
    config = ConfigObj(copy.deepcopy(raw))
    config.logdir = str(tmp_path / 'outputs' / 'dp_k2' / 'logs')
    assert sorted(_loss_records(_log(config))) == [2, 3]
    assert sorted(os.listdir(tmp_path / 'outputs' / 'dp_k2' /
                             'checkpoints')) == ['2', '3']
