"""monopsr_torch's data parallelism over ranks (``parallel.data_parallel``)
against one process and against the JAX package's one-device step.

Two gloo ranks on the CPU, started by ``data_parallel.launch`` (spawned
processes), take two train steps of the tiny configuration of
tests/torch_parity.py (24x24 ROIs) at a global batch of 2 images, one
image per rank, from a state carried across from the JAX package after
one JAX step (as tests/test_torch_train_step.py starts). They must
equal the port's one-process steps on both images and JAX's one-device
steps on both images (tests/dp_equivalence_main.py holds JAX's
two-device steps equal to its one-device ones). The same ranks with the
decoder's batch norm made per-rank again, and with the gradients left
per rank, must fail the same check. Then the CLIs: ``run_training``
with ``data_parallel: 2`` (two ranks, batch 1 each) against one process
at batch 2, and
``run_evaluation`` with ``eval_data_parallel: 2`` against one rank, on
the KITTI fixture; the parent counts two visible devices so that the
CLIs spawn two ranks. And the loader's rows, and eval_batch's rounding.

Tolerances. Two ranks sum in another order than one process: the
decoder statistics as sums over ranks, the gradients as a mean of two
halves. Adam divides each gradient by its own root-mean-square, so an
element whose gradient is rounding noise (the decoder conv biases ahead
of a train-mode batch norm have a true gradient of 0; any element's
gradient may cancel to near 0) steps by up to ~lr either way, in every
run: no elementwise bound below ~lr per step holds the parameters. So
the parameters and the EMA are held as a whole: the L2 norm of their
deviation over all leaves is at most 1e-2 of the L2 norm of what the
steps moved them (one Adam step moves every element by ~lr, so a share
of a few 1e-5 of the elements flipping stays far inside, and ranks that
skip the gradient mean move a large share the wrong way). The Adam
moments (the first linear in the gradients) to rtol 1e-5 plus 1e-2 of
the largest value over all leaves of the moment (a noise leaf's moments
are ~1e-7 of the largest); the decoder running statistics, which take
0.003 of each step's batch mean (conv bias included), to rtol 1e-4 plus
1e-3 of each leaf's largest value; logged losses to rtol 1e-5 plus 1e-5
of max(1, |loss|). Against JAX: the same. Two planted faults must fail
the same check: the decoder's batch norm per rank (the sum over ranks
planted out) and the gradients per rank (the mean over ranks planted
out). The ranks end with bitwise identical states (not so when the
gradients stay per rank). Evaluation: the files of two ranks equal one
rank's byte for byte, and with a tail group within the bounds of
chip_smoke.py's phase 10.
"""

import copy
import filecmp
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

import monopsr_torch
from monopsr_torch import config as config_lib
from monopsr_torch.datasets.kitti.kitti_dataset import KittiDataset
from monopsr_torch.eval import evaluator
from monopsr_torch.experiments import run_evaluation, run_training
from monopsr_torch.models import monopsr
from monopsr_torch.models import monopsr_net as torch_net
from monopsr_torch.parallel import data_parallel
from monopsr_torch.train import optimizer, trainer
from monopsr_torch.train.input_pipeline import PrefetchingLoader
from monopsr_torch.utils import device as device_lib
from monopsr_torch.utils import image_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, 'tests', 'datasets', 'Kitti', 'object')
STEPS = 2
UPDATE_RTOL = 1e-2     # parameters and EMA, over the steps' update


# --------------------------------------------------------------------------
# Train steps: two ranks, one process, JAX
# --------------------------------------------------------------------------

def _snapshot(state, losses):
    return {'params': {k: v.detach().clone()
                       for k, v in state.params.items()},
            'ema': {k: v.clone() for k, v in state.ema_params.items()},
            'batch_stats': {k: v.clone() for k, v in state.batch_stats.items()
                            if 'map_decoder' in k and 'running' in k},
            'mu': state.opt_state['mu'], 'nu': state.opt_state['nu'],
            'losses': losses}


def _steps(tcfg, train_config, loss_config, ckpt_dir, batch, device):
    """STEPS train steps from checkpoint 0 of ``ckpt_dir`` on this rank's
    rows of ``batch``; the snapshot after them, losses averaged over
    ranks."""
    net = torch_net.MonoPSRNet(tcfg)
    tx, _, use_ema, ema_decay = optimizer.build_optimizer(train_config)
    step = trainer.make_train_step(net, tcfg, loss_config, tx, use_ema,
                                   ema_decay, device=device)
    state = trainer.create_train_state(net, tx, use_ema)
    trainer.restore_checkpoint(trainer.CheckpointManager(ckpt_dir), 0, state)
    data_parallel.replicate(trainer.state_tensors(state))
    start = _snapshot(state, {})
    rows = data_parallel.shard_rows(batch)
    for _ in range(STEPS):
        state, losses = step(state, rows)
        data_parallel.mean_over_ranks(losses.values())
    snap = _snapshot(state, {k: float(v) for k, v in losses.items()})
    snap['start'] = {part: start[part] for part in ('params', 'ema')}
    return snap


def _rank_train_steps(device, tcfg, train_config, loss_config, ckpt_dir,
                      batch, out):
    """A rank's side: the steps, then the same steps with the decoder's
    batch statistics per rank (the sum over ranks planted out), then with
    the gradients per rank (the mean over ranks planted out); rank 0
    saves the three snapshots."""
    args = (tcfg, train_config, loss_config, ckpt_dir, batch, device)
    good = _steps(*args)
    sum_over_ranks = data_parallel.sum_over_ranks
    data_parallel.sum_over_ranks = lambda x: x
    planted_bn = _steps(*args)
    data_parallel.sum_over_ranks = sum_over_ranks
    data_parallel.mean_over_ranks = lambda tensors: None
    planted_grads = _steps(*args)
    if data_parallel.is_main():
        torch.save({'good': good, 'planted_bn': planted_bn,
                    'planted_grads': planted_grads}, out)
    else:
        torch.save({'good': good, 'planted_grads': planted_grads},
                   out + '.rank1')


def update_deviation(got, want, start):
    """The L2 norm over all leaves of ``got - want``, as a share of that
    of ``want - start``: how far two runs' updates part, against how far
    the update went."""
    off = sum(float(((got[k].float() - w.float()) ** 2).sum())
              for k, w in want.items())
    moved = sum(float(((w.float() - start[k].float()) ** 2).sum())
                for k, w in want.items())
    return (off / moved) ** 0.5


def _check(got, want):
    """Raises AssertionError naming every part outside its tolerance."""
    bad = []
    for part in ('params', 'ema'):
        share = update_deviation(got[part], want[part], want['start'][part])
        if share > UPDATE_RTOL:
            bad.append('{} update: {:.3g} of its norm'.format(part, share))
    for part in ('batch_stats', 'mu', 'nu'):
        scale = max(float(v.abs().max()) for v in want[part].values())
        for key, w in want[part].items():
            g = got[part][key]
            if part == 'batch_stats':
                atol, rtol = 1e-3 * float(w.abs().max()), 1e-4
            else:
                atol, rtol = 1e-2 * scale, 1e-5
            if not torch.allclose(g.float(), w.float(), rtol=rtol, atol=atol):
                bad.append('{} {}: {:.3g}'.format(
                    part, key, float((g.float() - w.float()).abs().max())))
    for key, w in want['losses'].items():
        if not np.isclose(got['losses'][key], w, rtol=1e-5,
                          atol=1e-5 * max(1.0, abs(w))):
            bad.append('loss {}: {} vs {}'.format(key, got['losses'][key], w))
    if bad:
        raise AssertionError('\n'.join(bad))


@pytest.fixture(scope='module')
def train_runs(tmp_path_factory):
    import jax

    from monopsr_tpu.config import ConfigObj as JaxConfigObj
    from monopsr_tpu.models import monopsr_net as jax_net
    from monopsr_tpu.train import optimizer as jax_opt
    from monopsr_tpu.train import trainer as jax_trainer
    from monopsr_tpu.train.train_state import TrainState as JaxTrainState
    from monopsr_torch import weights

    import torch_parity as tp

    base = tmp_path_factory.mktemp('dp_steps')
    # 24x24 ROIs (as tests/dp_equivalence_main.py) keep the box FC
    # layers, and so each state, small
    jcfg, tcfg = tp.configs(img_roi_size=(24, 24), map_roi_size=(24, 24))
    rng = np.random.RandomState(11)
    batch = evaluator.stack_samples([tp.make_sample(rng, jcfg)
                                     for _ in range(2)])
    jnet = jax_net.MonoPSRNet(cfg=jcfg)
    variables = tp.init_flax(jnet, {k: v[0] for k, v in batch.items()})
    train_config = tp.train_config(decay_steps=2)
    loss_config = tp.loss_config(['smooth_l1_nonzero', 100.0])

    jtx, _, use_ema, ema_decay = jax_opt.build_optimizer(
        JaxConfigObj(train_config))
    jstep = jax_trainer.make_train_step(jnet, jcfg, loss_config, jtx,
                                        use_ema, ema_decay)
    jstate = JaxTrainState.create(variables, jtx, use_ema=True)
    jstate, _ = jstep(jstate, batch)            # the carried-across start
    ttx, _, _, _ = optimizer.build_optimizer(train_config)

    def port_state(host):
        return weights.train_state_from_flax(
            torch_net.MonoPSRNet(tcfg), ttx, host.step, host.params,
            host.batch_stats, host.opt_state, host.ema_params)

    ckpt_dir = str(base / 'ckpt')
    trainer.save_checkpoint(trainer.CheckpointManager(ckpt_dir),
                            port_state(jax.device_get(jstate)), 0)
    for _ in range(STEPS):
        jstate, jlosses = jstep(jstate, batch)
    want = _snapshot(port_state(jax.device_get(jstate)),
                     {k: float(v) for k, v in jlosses.items()})

    one = _steps(tcfg, train_config, loss_config, ckpt_dir, batch, 'cpu')
    want['start'] = one['start']          # both from checkpoint 0
    out = str(base / 'ranks.pt')
    data_parallel.launch(_rank_train_steps, 2, 'cpu', tcfg, train_config,
                         loss_config, ckpt_dir, batch, out)
    ranks = torch.load(out)
    rank1 = torch.load(out + '.rank1')
    return dict(jax=want, one=one, two=ranks['good'],
                planted_bn=ranks['planted_bn'],
                planted_grads=ranks['planted_grads'], rank1=rank1)


def test_two_ranks_step_as_one_process_and_as_jax(train_runs):
    _check(train_runs['two'], train_runs['one'])
    _check(train_runs['two'], train_runs['jax'])
    _check(train_runs['one'], train_runs['jax'])
    # the steps moved the decoder statistics and the parameters
    start = train_runs['jax']['batch_stats']
    assert any(float(v.abs().max()) > 0 for v in start.values())


def _identical(a, b):
    return all(torch.equal(a[part][k], b[part][k])
               for part in ('params', 'ema', 'batch_stats', 'mu', 'nu')
               for k in a[part])


def test_ranks_end_with_identical_state(train_runs):
    # every rank steps on the one global-batch gradient, bit for bit;
    # ranks that skip the gradient mean part
    assert _identical(train_runs['two'], train_runs['rank1']['good'])
    assert not _identical(train_runs['planted_grads'],
                          train_runs['rank1']['planted_grads'])


def test_per_rank_batch_norm_fails_the_check(train_runs):
    with pytest.raises(AssertionError) as info:
        _check(train_runs['planted_bn'], train_runs['one'])
    assert 'batch_stats backbone.map_decoder' in str(info.value)


def test_per_rank_gradients_fail_the_check(train_runs):
    with pytest.raises(AssertionError) as info:
        _check(train_runs['planted_grads'], train_runs['one'])
    assert 'params update' in str(info.value)
    assert 'ema update' in str(info.value)
    assert 'mu ' in str(info.value)


# --------------------------------------------------------------------------
# The loader's rows
# --------------------------------------------------------------------------

def _tiny_raw(out_dir):
    from tests.test_torch_train_loop import _raw_config
    return _raw_config(out_dir, 2)


def test_loader_ranks_read_their_rows_of_the_global_batch(tmp_path):
    raw = _tiny_raw(tmp_path)
    cfg = config_lib.ConfigObj(raw)
    shape = tuple(cfg.model_config.image_input_shape)

    def batches(batch_size, rank, world_size, count):
        dataset = KittiDataset(cfg.dataset_config, 'train')
        reads = []
        sample_dict = dataset._sample_dict

        def counted(name, rng):
            reads.append(name)
            return sample_dict(name, rng)

        dataset._sample_dict = counted
        loader = PrefetchingLoader(dataset, batch_size, shape, num_threads=2,
                                   rank=rank, world_size=world_size)
        try:
            out = [loader.get_batch(timeout=120) for _ in range(count)]
        finally:
            loader.stop()
        return out, reads

    count = 5                  # 10 valid samples: the 7-frame split's
    whole, _ = batches(2, 0, 1, count)        # 5 valid ones, twice over
    for rank in (0, 1):
        rows, reads = batches(1, rank, 2, count)
        # only this rank's samples were read (the loader reads ahead:
        # at most queue_depth + threads batches more)
        assert count <= len(reads) <= count + 6, reads
        for got, want in zip(rows, whole):
            assert set(got) == set(want)
            for key, value in want.items():
                np.testing.assert_array_equal(got[key],
                                              value[rank:rank + 1], key)


# --------------------------------------------------------------------------
# The CLIs over two ranks
# --------------------------------------------------------------------------

def _write_config(path, raw):
    config_lib.dump_yaml(raw, str(path))
    return str(path)


@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory):
    from tests.test_torch_train_loop import tiny_yaml

    base = tmp_path_factory.mktemp('dp_cli')
    with open(os.path.join(REPO, 'configs', 'monopsr_model_000.yaml')) as f:
        raw = config_lib.parse_yaml(tiny_yaml(f.read(), FIXTURE, 2))
    raw['train_config']['tensorboard'] = False
    one = copy.deepcopy(raw)
    one['train_config']['batch_size'] = 2
    two = copy.deepcopy(raw)
    two['train_config']['data_parallel'] = 2
    two['train_config']['eval_data_parallel'] = 2
    two['train_config']['eval_batch'] = 3        # rounds up to 4
    names = ('dp_one', 'dp_two')
    paths = {}
    for name, doc in zip(names, (one, two)):
        paths[name] = str(base / (name + '.yaml'))
        config_lib.dump_yaml(doc, paths[name])
    out = {name: base / 'outputs' / name for name in names}

    def run(main, name, ranks):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(monopsr_torch, 'data_dir', lambda: str(base))
            # the parent counts two devices, so the CLI spawns two ranks
            mp.setattr(device_lib, 'visible_device_count',
                       lambda d: ranks)
            main(['--config_path', paths[name], '--device', 'cpu'])

    run(run_training.main, 'dp_one', 1)
    run(run_training.main, 'dp_two', 2)
    trained = {}
    for name in names:
        manager = trainer.CheckpointManager(str(out[name] / 'checkpoints'))
        trained[name] = (manager.all_steps(), torch.load(
            manager.path(2), weights_only=True))
        with open(out[name] / 'logs' / 'train_log.jsonl') as f:
            trained[name] += ([json.loads(line) for line in f],)
    # Both evaluations read the one-process run's weights
    shutil.copyfile(out['dp_one'] / 'checkpoints' / '2' / 'train_state.pt',
                    out['dp_two'] / 'checkpoints' / '2' / 'train_state.pt')
    run(run_evaluation.main, 'dp_one', 1)
    run(run_evaluation.main, 'dp_two', 2)
    # Both trainings start from the seeded init (no NPZ here)
    cfg = config_lib.ConfigObj(one)
    net, _ = monopsr.create_net_from_config(
        cfg.model_config, cfg.dataset_config, device='cpu', seed=0)
    tx, _, use_ema, _ = optimizer.build_optimizer(
        cfg.train_config.to_dict())
    init = trainer.create_train_state(net, tx, use_ema)
    start = {'params': {k: v.detach().clone()
                        for k, v in init.params.items()},
             'ema': {k: v.clone() for k, v in init.ema_params.items()}}
    return dict(out=out, trained=trained, start=start)


def test_training_cli_two_ranks_train_as_one_process(cli_runs):
    one_steps, one_state, one_log = cli_runs['trained']['dp_one']
    two_steps, two_state, two_log = cli_runs['trained']['dp_two']
    assert one_steps == two_steps == [2]
    # rank 0 alone logs, one line per step (no memory line on the CPU)
    assert [r['step'] for r in two_log] == [r['step'] for r in one_log] \
        == [1, 2]
    for got, want in zip(two_log, one_log):
        for key, value in want.items():
            if key in ('steps_per_sec', 'step'):
                continue
            np.testing.assert_allclose(got[key], value, rtol=1e-5,
                                       atol=1e-5 * max(1.0, abs(value)),
                                       err_msg=key)

    def snap(saved):
        return {'params': saved['params'], 'ema': saved['ema_params'],
                'batch_stats': {k: v for k, v in saved['batch_stats'].items()
                                if 'map_decoder' in k and 'running' in k},
                'mu': saved['opt_state']['mu'],
                'nu': saved['opt_state']['nu'], 'losses': {},
                'start': cli_runs['start']}

    _check(snap(two_state), snap(one_state))


def _tree_files(root):
    out = {}
    for dirpath, _, filenames in os.walk(root):
        for name in filenames:
            path = os.path.join(dirpath, name)
            out[os.path.relpath(path, root)] = path
    return out


def test_evaluation_cli_two_ranks_write_what_one_rank_writes(cli_runs):
    one, two = cli_runs['out']['dp_one'], cli_runs['out']['dp_two']
    got = _tree_files(two / 'predictions')
    want = _tree_files(one / 'predictions')
    renamed = {k.replace('dp_one', 'dp_two'): v for k, v in want.items()}
    assert set(got) == set(renamed)
    assert any(k.startswith('kitti_predictions_3d') for k in got)
    assert 'dp_two_results_low_iou_0.1.txt' in got
    for key, path in renamed.items():
        assert filecmp.cmp(got[key], path, shallow=False), key
    for sub in ('metrics', os.path.join('logs', 'eval_val.jsonl')):
        a, b = _tree_files(two / sub), _tree_files(one / sub)
        if not a:                                      # a file, not a dir
            a, b = {sub: str(two / sub)}, {sub: str(one / sub)}
        assert set(a) == set(b) and a, sub
        for key in a:
            assert filecmp.cmp(a[key], b[key], shallow=False), key


def _assert_file_close(got, want, key):
    """Two evaluations' files agree as phase 10 of chip_smoke.py holds the
    card to the CPU: the numbers of a text file within rtol 1e-4 + atol
    1e-4, a float16 map within one float16 step (2e-3 relative or
    absolute), a mask image in all but 1e-3 of its pixels (a logit that
    moves across 0). Ranks evaluate on their share of the host's threads
    and rows, whose CPU kernels sum in another order than one rank's."""
    if key.endswith('.npy'):
        np.testing.assert_allclose(np.load(got).astype(np.float32),
                                   np.load(want).astype(np.float32),
                                   rtol=2e-3, atol=2e-3, err_msg=key)
    elif key.endswith('.png'):
        a, b = image_io.read_png(got), image_io.read_png(want)
        assert a.shape == b.shape and (a != b).mean() <= 1e-3, key
    else:
        numbers = []
        for path in (got, want):
            with open(path) as f:
                numbers.append(np.array([float(x) for x in re.findall(
                    r'-?\d+\.?\d*(?:[eE][-+]?\d+)?|nan', f.read())]))
        assert numbers[0].shape == numbers[1].shape, key
        np.testing.assert_allclose(numbers[0], numbers[1], rtol=1e-4,
                                   atol=1e-4, err_msg=key)


def _evaluate_configs(device, configs):
    """A rank's side: each config's val evaluation, without native AP."""
    for config in configs:
        run_evaluation.evaluate(config, 'val', repeated=False,
                                kitti_native_eval=False, device=device)


def test_evaluator_ranks_over_a_tail_group_write_what_one_rank_writes(
        cli_runs, monkeypatch):
    # The fixture's 4 val samples in one group: eval_batch 5 (rounded to
    # 6) gives rank 1 one row and two pad rows; eval_batch 7 (rounded to
    # 8) gives rank 1 pad rows alone, on a stand-in it assembles. Rank 0
    # writes what one rank wrote, within _assert_file_close's bounds.
    one = cli_runs['out']['dp_one']
    base = one.parent.parent
    raw = config_lib.parse_yaml((base / 'dp_one.yaml').read_text())
    raw['train_config']['eval_data_parallel'] = 2
    monkeypatch.setattr(monopsr_torch, 'data_dir', lambda: str(base))
    configs = []
    for eval_batch in (5, 7):
        name = 'dp_tail{}'.format(eval_batch)
        raw['train_config']['eval_batch'] = eval_batch
        configs.append(config_lib.parse_yaml_config(
            _write_config(base / (name + '.yaml'), raw)))
        shutil.copytree(one / 'checkpoints', base / 'outputs' / name /
                        'checkpoints')
    data_parallel.launch(_evaluate_configs, 2, 'cpu', configs)
    for config in configs:
        got = _tree_files(config.exp_output_dir)
        want = {key.replace('dp_one', config.config_name): path
                for key, path in _tree_files(one).items()}
        # what the evaluation writes (the native AP run, not run here,
        # writes the rest of dp_one's predictions directory)
        written = tuple(os.path.join(*parts) for parts in (
            ('predictions', 'box_'), ('predictions', 'xyz_map_local'),
            ('predictions', 'kitti_predictions_3d', 'val', '0.1', '2',
             'data'), ('metrics',), ('logs', 'eval_val.jsonl')))
        files = sorted(key for key in got if key.startswith(written))
        assert files == sorted(key for key in want
                               if key.startswith(written))
        assert any(key.startswith(os.path.join('predictions', 'box_3d'))
                   for key in files)
        for key in files:
            _assert_file_close(got[key], want[key], key)


def test_eval_batch_rounds_up_to_the_ranks_as_jax(tmp_path, monkeypatch):
    raw = _tiny_raw(tmp_path)
    dataset = KittiDataset(config_lib.ConfigObj(raw).dataset_config, 'val')
    monkeypatch.setattr(data_parallel, 'world_size', lambda: 2)
    for eval_batch in (1, 3, 4, 5):
        raw['train_config']['eval_batch'] = eval_batch
        ev = evaluator.Evaluator(config_lib.ConfigObj(raw), dataset, 'val',
                                 device='cpu')
        # monopsr_tpu/eval/evaluator.py: -(-eval_batch // n_dev) * n_dev
        assert ev.eval_batch == -(-eval_batch // 2) * 2


def test_outside_the_ranks_more_than_one_device_raises(tmp_path,
                                                       monkeypatch):
    raw = _tiny_raw(tmp_path)
    raw['train_config']['data_parallel'] = 2
    monkeypatch.setattr(device_lib, 'visible_device_count', lambda d: 2)
    with pytest.raises(ValueError, match='data_parallel.launch'):
        trainer.train(config_lib.ConfigObj(raw), None, device='cpu')
    with pytest.raises(ValueError, match='data_parallel.launch'):
        evaluator.Evaluator(config_lib.ConfigObj(raw), None, 'val',
                            device='cpu')
    assert data_parallel.clamped_ranks(2, torch.device('cpu')) == 2
    monkeypatch.undo()
    assert data_parallel.clamped_ranks(2, torch.device('cpu')) == 1
