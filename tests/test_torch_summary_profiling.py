"""The port's trainer observability hooks against the JAX package's:
``utils.summary_images`` (grids, 8-bit PNGs, the trainer's feature-map
summaries) and ``utils.profiling`` (trace, device memory).

The grid must equal JAX's on the same array, and the port's PNG (written
without cv2) must hold the pixels cv2 writes for JAX's grid. The tiny
trainer of tests/test_train_eval.py with ``summary_images`` on must write
its grids at the steps where JAX's trainer writes them (its rule, which
tests/test_summary_images.py holds JAX to).
"""

import copy
import glob
import json
import os

import cv2
import numpy as np
import pytest

from monopsr_torch.config import ConfigObj
from monopsr_torch.datasets.kitti.kitti_dataset import KittiDataset
from monopsr_torch.train import trainer
from monopsr_torch.utils import image_io
from monopsr_torch.utils import profiling
from monopsr_torch.utils import summary_images
from monopsr_tpu.utils import profiling as jax_profiling
from monopsr_tpu.utils import summary_images as jax_summary_images
from tests.test_train_eval import make_config


def _feature_maps():
    rng = np.random.RandomState(0)
    return [
        rng.randn(8, 8, 12).astype(np.float32),
        rng.randn(6, 6, 512).astype(np.float32),          # > 64 channels
        rng.randn(16, 16, 128).astype(np.float32) * 40.0,
        np.full((4, 5, 3), 2.5, np.float32),               # constant map
        np.arange(4 * 6 * 5, dtype=np.float32).reshape(4, 6, 5),
    ]


def test_feature_map_grid_equals_jax():
    for fmap in _feature_maps():
        want = jax_summary_images.feature_map_grid(fmap)
        got = summary_images.feature_map_grid(fmap)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    fmap = _feature_maps()[1]
    np.testing.assert_array_equal(
        summary_images.feature_map_grid(fmap, max_channels=7),
        jax_summary_images.feature_map_grid(fmap, max_channels=7))


def test_saved_png_holds_cv2_pixels_of_jax_grid(tmp_path):
    for i, fmap in enumerate(_feature_maps()):
        want_path = jax_summary_images.save_feature_maps(
            str(tmp_path / 'jax'), i, 'probe', fmap)
        got_path = summary_images.save_feature_maps(
            str(tmp_path / 'torch'), i, 'probe', fmap)
        assert got_path == str(tmp_path / 'torch' / 'images' /
                               '{}_probe.png'.format(i))
        want = cv2.imread(want_path, cv2.IMREAD_UNCHANGED)
        for got in (cv2.imread(got_path, cv2.IMREAD_UNCHANGED),
                    image_io.read_png(got_path)):
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, want)


def _train_configs(base, max_iterations, summary_interval):
    raw = make_config(base, max_iterations=max_iterations).to_dict()
    raw['dataset_config']['seed'] = 0
    raw['train_config']['prefetch_threads'] = 1
    raw['train_config']['tensorboard'] = False
    raw['train_config']['summary_interval'] = summary_interval
    raw['summary_images'] = True
    return raw


def _image_names(config):
    return sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(config.logdir, 'images', '*.png')))


def test_tiny_trainer_writes_grids_where_jax_does(tmp_path):
    """JAX's trainer writes both grids at each step with step %
    summary_interval == 0 (tests/test_summary_images.py runs it); the
    port's, 3 steps at interval 2, at step 2 only, each grid a full-range
    8-bit image of the backbone's map (16x16x128 -> 8x8 tiles) and box
    (2x2x512, first 64 channels -> 8x8 tiles) features."""
    raw = _train_configs(tmp_path / 'torch', 3, 2)
    pconfig = ConfigObj(copy.deepcopy(raw))
    trainer.train(pconfig, KittiDataset(pconfig.dataset_config, 'train'),
                  device='cpu')

    want = ['2_features_for_box_3d.png', '2_features_for_map.png']
    assert _image_names(pconfig) == want
    for name, shape in zip(want, ((16, 16), (128, 128))):
        got = image_io.read_png(os.path.join(pconfig.logdir, 'images', name))
        assert got.shape == shape and got.dtype == np.uint8
        assert got.max() == 255 and got.min() == 0   # normalized grid


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch
    with profiling.trace(str(tmp_path / 'profile'), name='block'):
        torch.ones(8, 8).matmul(torch.ones(8, 8))
    with open(tmp_path / 'profile' / 'block.json') as f:
        assert json.load(f)['traceEvents']
    with profiling.trace(str(tmp_path / 'off'), enabled=False):
        pass
    assert not os.path.exists(tmp_path / 'off')


def test_device_memory_stats_on_the_cpu_as_jax():
    got = profiling.device_memory_stats()
    want = jax_profiling.device_memory_stats()
    assert len(got) == len(want) == 1
    assert list(got.values()) == list(want.values()) == [None]
    assert list(got) == ['cpu']


@pytest.mark.cuda
def test_device_memory_stats_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    x = torch.ones(1024, device='cuda')
    stats = profiling.device_memory_stats()
    assert sorted(stats) == ['cuda:{}'.format(i) for i in
                             range(torch.cuda.device_count())]
    assert stats['cuda:0']['allocated_bytes.all.current'] >= x.numel() * 4
