"""monopsr_torch's KittiDataset and prepare_sample against the JAX
package's, on the KITTI fixture.

Both datasets are seeded, so each sample's draws (oversampling, flip,
image noise, box jitter) come from the same per-sample RNG and the epoch
shuffles from the same stream. Every sample dict of every fixture sample,
then of two epochs of ``next_batch``, must agree key by key: exactly for
integer, uint8 and string arrays (the PNGs decode bitwise equal to
cv2's), within 1e-6 for floats. ``prepare_sample`` outputs agree exactly
but for the resized image, allowed 1 LSB (the port writes out OpenCV's
fixed-point resize; on this host it is exact).
"""

import copy

import numpy as np
import pytest

from monopsr_tpu.config import ConfigObj as JaxConfigObj
from monopsr_tpu.datasets.kitti.kitti_dataset import \
    KittiDataset as JaxKittiDataset
from monopsr_tpu.train import trainer as jax_trainer
from monopsr_torch.config import ConfigObj
from monopsr_torch.datasets.kitti.kitti_dataset import KittiDataset
from monopsr_torch.train import trainer

from tests.test_dataset import make_dataset_config

INPUT_SHAPE = (320, 1216)

CASES = {
    'train, flip + image noise, oversample jitter': dict(
        mode='train', seed=0, aug={'use_image_aug': True,
                                   'use_flip_aug': True,
                                   'box_jitter_type': 'oversample'}),
    'train, flip, oversample_gt jitter': dict(
        mode='train', seed=1, aug={'use_image_aug': False,
                                   'use_flip_aug': True,
                                   'box_jitter_type': 'oversample_gt'}),
    'train, image noise, all jitter': dict(
        mode='train', seed=2, aug={'use_image_aug': True,
                                   'box_jitter_type': 'all'}),
    'train, no augmentation': dict(
        mode='train', seed=3, aug={'use_image_aug': False,
                                   'box_jitter_type': None}),
    'val, MSCNN merge': dict(mode='val', seed=0, data_split='val'),
    'test': dict(mode='test', seed=0, data_split='test',
                 data_split_dir='testing', has_kitti_labels=False),
}


def _datasets(case):
    overrides = {'seed': case['seed']}
    for key in ('data_split', 'data_split_dir', 'has_kitti_labels'):
        if key in case:
            overrides[key] = case[key]
    raw = make_dataset_config(**overrides).to_dict()
    if 'aug' in case:
        raw['aug_config'] = dict(case['aug'])
    return (JaxKittiDataset(JaxConfigObj(copy.deepcopy(raw)), case['mode']),
            KittiDataset(ConfigObj(copy.deepcopy(raw)), case['mode']))


def _compare(got, want, what):
    if want is None:
        assert got is None, what
        return
    assert set(got) == set(want), what
    for key, w in want.items():
        g = got[key]
        where = '{} {}'.format(what, key)
        if not isinstance(w, np.ndarray):
            assert type(g) is type(w) and g == w, where
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, where
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                       err_msg=where)
        else:
            np.testing.assert_array_equal(g, w, err_msg=where)


def _compare_prepared(got, want, what):
    assert set(got) == set(want), what
    for key, w in want.items():
        if key == 'image':
            diff = np.abs(got[key].astype(np.int32) - w.astype(np.int32))
            assert got[key].dtype == w.dtype and diff.max() <= 1, what
        else:
            assert got[key].dtype == w.dtype, (what, key)
            np.testing.assert_array_equal(got[key], w,
                                          err_msg='{} {}'.format(what, key))


@pytest.mark.parametrize('name', list(CASES))
def test_sample_dicts_match_jax(name):
    case = CASES[name]
    jds, tds = _datasets(case)
    assert tds.num_samples == jds.num_samples
    assert tds.get_sample_names() == jds.get_sample_names()

    # every fixture sample, and its prepared device encoding
    valid = 0
    for i in range(jds.num_samples):
        want, = jds.get_sample_dict([i])
        got, = tds.get_sample_dict([i])
        what = '{} sample {}'.format(name, i)
        _compare(got, want, what)
        if want is not None:
            valid += 1
            _compare_prepared(trainer.prepare_sample(got, INPUT_SHAPE),
                              jax_trainer.prepare_sample(want, INPUT_SHAPE),
                              what)
    assert valid >= 3

    # two epochs of next_batch: shuffles, epoch accounting, epoch-seeded
    # per-sample draws
    for k in range(2 * jds.num_samples):
        want = jds.next_batch(1, shuffle=True)
        got = tds.next_batch(1, shuffle=True)
        assert len(got) == len(want) == 1
        _compare(got[0], want[0], '{} next_batch {}'.format(name, k))
        assert tds.epochs_completed == jds.epochs_completed
        assert tds.get_sample_names() == jds.get_sample_names()
    assert tds.epochs_completed == 2


def test_batches_of_three_cross_epochs_as_jax():
    case = dict(CASES['train, flip + image noise, oversample jitter'],
                seed=5)
    jds, tds = _datasets(case)
    for k in range(4):            # 7 samples: batches straddle the epochs
        want = jds.next_batch(3, shuffle=True)
        got = tds.next_batch(3, shuffle=True)
        assert len(got) == len(want) == 3
        for j, (g, w) in enumerate(zip(got, want)):
            _compare(g, w, 'batch {} item {}'.format(k, j))
        assert tds._index_in_epoch == jds._index_in_epoch
        assert tds.epochs_completed == jds.epochs_completed


def test_missing_files_raise_as_jax(tmp_path):
    import shutil
    from tests.test_dataset import FIXTURE
    root = tmp_path / 'object'
    shutil.copytree(FIXTURE, root)
    shutil.rmtree(root / 'training' / 'depth_2_multiscale')
    (root / 'training' / 'depth_2_multiscale').mkdir()
    raw = make_dataset_config(dataset_dir=str(root)).to_dict()
    jds = JaxKittiDataset(JaxConfigObj(copy.deepcopy(raw)), 'train')
    tds = KittiDataset(ConfigObj(copy.deepcopy(raw)), 'train')
    for ds in (jds, tds):
        with pytest.raises(FileNotFoundError, match='Depth map not found'):
            ds.get_sample_dict(range(ds.num_samples))
