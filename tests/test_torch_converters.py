"""The port's pretrained-trunk tools against the JAX package's.

``monopsr_torch.tools.{convert_tf_resnet, convert_torch_resnet,
odapi_manifest}`` are held to ``monopsr_tpu.tools.*`` on the same inputs:
a seeded synthetic slim trunk in a TF checkpoint V2 bundle (written by
the JAX test's ``write_test_checkpoint``) and the same tensors under
torchvision names go through both packages' CLIs, and the NPZs must be
equal array for array, bit for bit. The port's ``ResNetV1`` loaded from
that NPZ by ``train.pretrained`` reproduces the checked-in golden
activation of tests/test_tf_converter_activations.py at that test's
tolerance, with the JAX loader's counts.
"""

import re
import sys

import jax
import numpy as np
import pytest
import torch

import monopsr_torch
import monopsr_tpu
from monopsr_torch import config as config_lib
from monopsr_torch import weights
from monopsr_torch.models import monopsr as torch_monopsr
from monopsr_torch.models.monopsr_net import NetConfig
from monopsr_torch.models.resnet import RESNET_SPECS, ResNetV1
from monopsr_torch.tools import convert_tf_resnet as torch_ctr
from monopsr_torch.tools import convert_torch_resnet as torch_cth
from monopsr_torch.tools import odapi_manifest as torch_manifest
from monopsr_torch.train import optimizer as opt_lib
from monopsr_torch.train import pretrained as torch_pretrained
from monopsr_torch.train.train_state import TrainState
from monopsr_tpu.models.resnet import ResNetV1 as JaxResNetV1
from monopsr_tpu.tools import convert_tf_resnet as jax_ctr
from monopsr_tpu.tools import convert_torch_resnet as jax_cth
from monopsr_tpu.tools import odapi_manifest as jax_manifest
from monopsr_tpu.train import pretrained as jax_pretrained
from tests.test_tf_converter import write_test_checkpoint
from tests.test_tf_converter_activations import (
    GOLDEN, SPEC, _oracle_block3, _slim_tensors)

FSE = 'FirstStageFeatureExtractor/resnet_v1_101/'


def _distractors(rng):
    """Non-trunk variables of the zoo checkpoint (the manifest's list),
    each a small array the converters must drop."""
    out = {}
    for name in jax_manifest.distractor_names(depth=101):
        out[name] = (np.asarray([142000], np.int64) if name == 'global_step'
                     else rng.normal(size=(2, 3)).astype(np.float32))
    return out


def _torchvision_state_dict(tensors):
    """The slim tensors under torchvision names and layouts (OIHW)."""
    bn = {'gamma': 'weight', 'beta': 'bias', 'moving_mean': 'running_mean',
          'moving_variance': 'running_var'}
    out = {}
    for name, value in tensors.items():
        if not name.startswith(FSE):
            continue
        rest = name[len(FSE):]
        if rest.endswith('/weights'):
            value = value.transpose(3, 2, 0, 1)
        m = re.match(r'block(\d)/unit_(\d+)/bottleneck_v1/(\w+)/(.+)$', rest)
        if m:
            block, unit, layer, leaf = m.groups()
            prefix = 'layer{}.{}.'.format(block, int(unit) - 1)
            if layer == 'shortcut':
                key = prefix + ('downsample.0.weight' if leaf == 'weights'
                                else 'downsample.1.' + bn[leaf.split('/')[1]])
            elif leaf == 'weights':
                key = prefix + layer + '.weight'
            else:
                key = prefix + 'bn' + layer[-1] + '.' + bn[leaf.split('/')[1]]
        elif rest == 'conv1/weights':
            key = 'conv1.weight'
        else:
            key = 'bn1.' + bn[rest.split('/')[-1]]
        out[key] = torch.from_numpy(np.ascontiguousarray(value))
    out['fc.weight'] = torch.zeros(3, 4)          # a head the trunk drops
    return out


def _run_both(monkeypatch, tmp_path, jax_main, torch_main, args):
    """Runs the JAX CLI and the port's with their data dirs under
    tmp_path; returns both NPZs as dicts."""
    jax_dir, torch_dir = tmp_path / 'jax_data', tmp_path / 'torch_data'
    monkeypatch.setattr(monopsr_tpu, 'data_dir', lambda: str(jax_dir))
    monkeypatch.setattr(monopsr_torch, 'data_dir', lambda: str(torch_dir))
    monkeypatch.setattr(sys, 'argv', ['convert'] + args)
    jax_main()
    torch_main(args)
    out = []
    for base in (jax_dir, torch_dir):
        with np.load(str(base / 'pretrained' / 'trunk.npz')) as data:
            out.append({k: data[k] for k in data.files})
    return out


def _assert_bitwise_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key


def test_tf_checkpoint_converts_bitwise_as_jax(monkeypatch, tmp_path):
    rng = np.random.default_rng(11)
    tensors = _slim_tensors(rng)
    tensors.update(_distractors(rng))
    prefix = str(tmp_path / 'model.ckpt')
    write_test_checkpoint(prefix, tensors)

    reader, jax_reader = torch_ctr.BundleReader(prefix), \
        jax_ctr.BundleReader(prefix)
    assert reader.variable_names() == jax_reader.variable_names()
    for name in reader.variable_names():
        assert (reader.get_tensor(name).tobytes() ==
                jax_reader.get_tensor(name).tobytes())

    jax_npz, torch_npz = _run_both(
        monkeypatch, tmp_path, jax_ctr.main, torch_ctr.main,
        ['--tf_checkpoint', prefix, '--out_name', 'trunk'])
    _assert_bitwise_equal(torch_npz, jax_npz)
    _assert_bitwise_equal(torch_ctr.convert_checkpoint(prefix), jax_npz)
    n_conv = sum(1 for k in tensors
                 if k.startswith(FSE) and k.endswith('/weights'))
    n_bn = sum(1 for k in tensors
               if k.startswith(FSE) and '/BatchNorm/' in k)
    assert len(torch_npz) == n_conv + n_bn
    assert not any(k.startswith('block4') for k in torch_npz)


def test_torchvision_state_dict_converts_bitwise_as_jax(monkeypatch,
                                                        tmp_path):
    rng = np.random.default_rng(12)
    state_dict = _torchvision_state_dict(_slim_tensors(rng))
    path = str(tmp_path / 'resnet.pth')
    torch.save(state_dict, path)

    jax_npz, torch_npz = _run_both(
        monkeypatch, tmp_path, jax_cth.main, torch_cth.main,
        ['--torch_weights', path, '--out_name', 'trunk'])
    _assert_bitwise_equal(torch_npz, jax_npz)
    _assert_bitwise_equal(torch_cth.convert_state_dict(state_dict), jax_npz)
    assert 'fc/kernel' not in torch_npz and len(torch_npz) == \
        len(state_dict) - 1


def test_both_converters_give_one_npz(tmp_path):
    """The same trunk as a TF bundle and as a torchvision state dict
    converts to the same arrays."""
    tensors = _slim_tensors(np.random.default_rng(13))
    prefix = str(tmp_path / 'model.ckpt')
    write_test_checkpoint(prefix, tensors)
    _assert_bitwise_equal(
        torch_cth.convert_state_dict(_torchvision_state_dict(tensors)),
        torch_ctr.convert_checkpoint(prefix))


def test_reader_rejects_bad_magic(tmp_path):
    path = str(tmp_path / 'junk.ckpt')
    with open(path + '.index', 'wb') as f:
        f.write(b'\x00' * 64)
    with pytest.raises(ValueError):
        torch_ctr.BundleReader(path)


def _tower_tensors(tower):
    """Both towers' state-dict names over one bare tower's tensors (the
    JAX test wraps one tower's trees as both towers the same way)."""
    params, stats = {}, {}
    for scope in ('backbone.tower_crop.', 'backbone.tower_full.'):
        params.update({scope + k: v for k, v in tower.named_parameters()})
        stats.update({scope + k: v for k, v in tower.named_buffers()})
    return params, stats


def _jax_counts(npz_path, image):
    """The JAX loader's (param, stat) counts on the JAX tower's trees."""
    tower = JaxResNetV1(spec=SPEC, output_stride=4, dtype=np.float32)
    shapes = jax.eval_shape(tower.init, jax.random.PRNGKey(0), image[None])
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params = jax_pretrained._to_mutable(zeros['params'])
    stats = jax_pretrained._to_mutable(zeros['batch_stats'])
    wrapped_p = {'backbone': {'tower_crop': params, 'tower_full': params}}
    wrapped_s = {'backbone': {'tower_crop': stats, 'tower_full': stats}}
    return (jax_pretrained.load_npz_into_towers(wrapped_p, npz_path),
            jax_pretrained.load_npz_into_towers(wrapped_s, npz_path))


def _converted_tower_output(tmp_path, tensors, image):
    """checkpoint bytes -> the port's converter -> the port's loader ->
    the port's ResNetV1 to block3, float32; checks the loader's counts
    against the JAX assertion and the JAX loader."""
    prefix = str(tmp_path / 'model.ckpt')
    write_test_checkpoint(prefix, tensors)
    npz_path = str(tmp_path / 'trunk.npz')
    np.savez(npz_path, **torch_ctr.convert_checkpoint(prefix))

    tower = ResNetV1(SPEC, output_stride=4, dtype=torch.float32)
    params, stats = _tower_tensors(tower)
    n_p = torch_pretrained.load_npz_into_towers(params, npz_path)
    n_s = torch_pretrained.load_npz_into_towers(stats, npz_path)
    n_conv = sum(1 for k in tensors if k.endswith('/weights'))
    n_bn = sum(1 for k in tensors if '/BatchNorm/' in k)
    assert n_p == 2 * (n_conv + n_bn // 2)   # kernels + gamma/beta
    assert n_s == 2 * (n_bn // 2)            # mean/var
    assert (n_p, n_s) == _jax_counts(npz_path, image)

    with torch.no_grad():
        out = tower(torch.from_numpy(image[None]))
    return out[0].double().numpy()


def test_converted_weights_reproduce_slim_activations(tmp_path):
    rng = np.random.default_rng(7)
    tensors = _slim_tensors(rng)
    image = rng.normal(0, 1, (21, 29, 3)).astype(np.float32)
    got = _converted_tower_output(tmp_path, tensors, image)
    want = _oracle_block3(tensors, image)
    assert got.shape == want.shape
    scale = np.maximum(np.abs(want), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-4)


def test_converted_activations_match_checked_in_golden(tmp_path):
    rng = np.random.default_rng(7)
    tensors = _slim_tensors(rng)
    image = rng.normal(0, 1, (21, 29, 3)).astype(np.float32)
    golden = np.load(GOLDEN)['block3']
    got = _converted_tower_output(tmp_path, tensors, image)
    scale = np.maximum(np.abs(golden), 1.0)
    np.testing.assert_allclose(got / scale, golden / scale, atol=2e-4)


def test_pretrained_trunk_loads_into_both_towers_of_a_net(monkeypatch,
                                                          tmp_path, capsys):
    """maybe_load_pretrained on a resnet_tiny net from a converted NPZ:
    both towers carry the NPZ's arrays, the EMA starts from them."""
    spec = RESNET_SPECS['resnet_tiny']
    rng = np.random.default_rng(3)
    # a trunk of resnet_tiny's shapes under the zoo's names
    manifest = {}
    depth_in = 64
    manifest[FSE + 'conv1/weights'] = (7, 7, 3, 64)
    for leaf in ('gamma', 'beta', 'moving_mean', 'moving_variance'):
        manifest[FSE + 'conv1/BatchNorm/' + leaf] = (64,)
    for b, (units, db) in enumerate(spec[:3]):
        for u in range(units):
            unit = FSE + 'block{}/unit_{}/bottleneck_v1/'.format(b + 1, u + 1)
            layers = [('conv1', (1, 1, depth_in, db)),
                      ('conv2', (3, 3, db, db)),
                      ('conv3', (1, 1, db, 4 * db))]
            if u == 0:
                layers.append(('shortcut', (1, 1, depth_in, 4 * db)))
            for layer, shape in layers:
                manifest[unit + layer + '/weights'] = shape
                for leaf in ('gamma', 'beta', 'moving_mean',
                             'moving_variance'):
                    manifest[unit + layer + '/BatchNorm/' + leaf] = (
                        shape[-1],)
            depth_in = 4 * db
    tensors = {k: rng.uniform(0.5, 1.5, s).astype(np.float32)
               for k, s in manifest.items()}
    prefix = str(tmp_path / 'model.ckpt')
    write_test_checkpoint(prefix, tensors)
    monkeypatch.setattr(monopsr_torch, 'data_dir',
                        lambda: str(tmp_path / 'data'))
    torch_ctr.main(['--tf_checkpoint', prefix, '--out_name', 'tiny_trunk'])
    npz_path = str(tmp_path / 'data' / 'pretrained' / 'tiny_trunk.npz')

    cfg = NetConfig(num_boxes=2, resnet='resnet_tiny',
                    proposal_fc_sizes=(8,), regression_fc_sizes=(8,),
                    compute_dtype='float32')
    net = torch_monopsr.create_net(cfg, device='cpu')
    tx, _, _, _ = opt_lib.build_optimizer({'optimizer': {
        'optimizer_type': 'gradient_descent_optimizer',
        'gradient_descent_optimizer': {'learning_rate_type': 'constant',
                                       'learning_rate': 0.1}}})
    state = TrainState.create(net, tx, use_ema=True)
    model_config = config_lib.ConfigObj({
        'net_type': 'monopsr', 'net_config': {'monopsr': {
            'pretrained_weights_type': 'npz',
            'pretrained_weights_name': 'tiny_trunk'}}})
    torch_pretrained.maybe_load_pretrained(state, model_config)
    line = capsys.readouterr().out
    n_conv, n_bn = len([k for k in manifest if k.endswith('/weights')]), \
        len([k for k in manifest if '/BatchNorm/' in k])
    assert '[pretrained] loaded {} param / {} stat arrays'.format(
        2 * (n_conv + n_bn // 2), 2 * (n_bn // 2)) in line

    with np.load(npz_path) as data:
        for key in data.files:
            tree = {'params': {}}
            node = tree['params']
            for part in key.split('/')[:-1]:
                node = node.setdefault(part, {})
            node[key.split('/')[-1]] = data[key]
            (name, want), = weights.from_flax_variables(tree).items()
            for tower in ('tower_crop', 'tower_full'):
                full = 'backbone.{}.{}'.format(tower, name)
                got = (state.params.get(full) if full in state.params
                       else state.batch_stats[full])
                np.testing.assert_array_equal(got.detach().numpy(),
                                              want.numpy())
                if full in state.params:
                    np.testing.assert_array_equal(
                        state.ema_params[full].numpy(), want.numpy())


# --------------------------------------------------------------------------
# The zoo-checkpoint manifest (mirrors tests/test_odapi_manifest.py)
# --------------------------------------------------------------------------

@pytest.fixture(scope='module')
def manifest():
    return torch_manifest.trunk_manifest(depth=101)


def test_manifest_equals_jax_manifest(manifest):
    num_units = sum(n for n, _ in RESNET_SPECS['resnet101'][:3])
    assert len(manifest) == 5 + num_units * 15 + 3 * 5
    assert list(manifest.items()) == list(
        jax_manifest.trunk_manifest(depth=101).items())
    for depth in (50, 152):
        assert list(torch_manifest.trunk_manifest(depth=depth).items()) == \
            list(jax_manifest.trunk_manifest(depth=depth).items())


def test_every_manifest_name_maps_injectively_as_jax(manifest):
    mapped = {}
    for name in manifest:
        key = torch_ctr.map_slim_name(name)
        assert key is not None and key == jax_ctr.map_slim_name(name), name
        assert key not in mapped, (mapped.get(key), name)
        mapped[key] = name
    assert len(mapped) == len(manifest)


def test_mapped_keys_cover_the_port_tower_exactly(manifest):
    """Converter keys, mapped to state-dict names, are exactly the port
    tower's parameters and buffers, with their shapes."""
    tower = ResNetV1(RESNET_SPECS['resnet101'], output_stride=4,
                     num_blocks=3, dtype=torch.float32)
    want = {k: tuple(v.shape) for k, v in tower.state_dict().items()}
    got = {}
    for name, shape in manifest.items():
        key = torch_ctr.map_slim_name(name)
        parts = key.split('/')
        tree = {}
        node = tree.setdefault('batch_stats' if parts[-1] in ('mean', 'var')
                               else 'params', {})
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.zeros(shape, np.float32)
        (sd_name, value), = weights.from_flax_variables(tree).items()
        got[sd_name] = tuple(value.shape)
    assert got == want


def test_dual_scope_rewrite_is_bijective_onto_manifest(manifest):
    for tower_scope in torch_manifest.MODEL_TOWER_SCOPES:
        graph_names = torch_manifest.trunk_manifest(depth=101,
                                                    scope=tower_scope)
        rewritten = [torch_manifest.rewrite_model_scope_to_checkpoint(n)
                     for n in graph_names]
        assert rewritten == [
            jax_manifest.rewrite_model_scope_to_checkpoint(n)
            for n in graph_names]
        assert sorted(rewritten) == sorted(manifest)
        for graph_name, ckpt_name in zip(graph_names, rewritten):
            assert (torch_ctr.map_slim_name(graph_name) ==
                    torch_ctr.map_slim_name(ckpt_name))


def test_distractors_rejected_as_jax():
    names = torch_manifest.distractor_names(depth=101)
    assert names == jax_manifest.distractor_names(depth=101)
    for name in names:
        key = torch_ctr.map_slim_name(name)
        assert key == jax_ctr.map_slim_name(name)
        if key is not None:
            m = re.match(r'^block(\d+)_', key)
            assert m and int(m.group(1)) > 3, (name, key)
