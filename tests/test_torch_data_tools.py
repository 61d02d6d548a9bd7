"""monopsr_torch's data-preparation path against the JAX package and
cv2, on the CPU: the 16-bit gray PNG writer, ``save_depth_map``, the
depth-map point cloud, ``points_in_box_3d``, and the two tools on the fixture's
000002 against the maps and images shipped with the fixture (which the
JAX tools reproduce, tests/test_demos_and_analysis.py).

Bounds:
- PNGs: pixels equal (bytes differ: cv2's zlib level and filters);
- the depth map of ``gen_depth_maps --device cpu``: not bit-exact. Its
  float map is held to cv2's under ``_assert_pipeline_parity``
  (tests/test_torch_depth_fill.py), and the stored uint16 (metres * 256,
  truncated) to the shipped file: at most 1 LSB, on fewer than 0.5% of
  pixels, each where the port's own float lies within 0.26 LSB of an
  integer (cv2's float is within 1e-3 m = 0.256 LSB of it);
- the instance image of ``gen_instance_masks`` from the shipped depth
  map: pixel for pixel;
- geometry: equal to JAX's functions.
"""

import os
import shutil

import cv2
import numpy as np
import pytest
import torch

from monopsr_torch.datasets.kitti import calib_utils, depth_map_utils
from monopsr_torch.datasets.kitti import obj_utils
from monopsr_torch.geometry import boxes, projection
from monopsr_torch.ops import depth_fill
from monopsr_torch.tools import gen_depth_maps, gen_instance_masks
from monopsr_torch.utils import image_io
from monopsr_tpu.datasets.kitti import depth_map_utils as jax_depth_map_utils
from monopsr_tpu.datasets.kitti import obj_utils as jax_obj_utils
from monopsr_tpu.geometry import boxes as jax_boxes
from monopsr_tpu.geometry import projection as jax_projection
from monopsr_tpu.tools import gen_instance_masks as jax_gen_instance_masks

from tests.test_depth_fill import _assert_pipeline_parity, fixture_sparse_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = os.path.join(REPO, 'tests', 'datasets', 'Kitti', 'object',
                     'training')
SAMPLE = '000002'


def _cv2_read(path):
    image = cv2.imread(path, cv2.IMREAD_ANYDEPTH)
    assert image is not None, path
    return image


# --------------------------------------------------------------------------
# PNG and depth-map IO
# --------------------------------------------------------------------------

@pytest.mark.parametrize('shape', [(1, 1), (3, 7), (17, 33), (375, 1242)])
def test_write_png_16_bit_round_trip_and_cv2(tmp_path, shape):
    rng = np.random.RandomState(shape[0] * 1000 + shape[1])
    image = rng.randint(0, 65536, shape).astype(np.uint16)
    image.flat[0], image.flat[-1] = 0, 65535
    path = str(tmp_path / 'out.png')
    image_io.write_png(path, image)
    got = image_io.read_png(path)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, image)
    want = _cv2_read(path)
    assert want.dtype == np.uint16
    np.testing.assert_array_equal(want, image)
    assert image_io.png_shape(path) == shape


def test_write_png_of_a_fixture_depth_map(tmp_path):
    """A shipped 16-bit depth map read, written again and read by cv2."""
    src = os.path.join(SPLIT, 'depth_2_multiscale', SAMPLE + '.png')
    path = str(tmp_path / 'copy.png')
    image_io.write_png(path, image_io.read_png(src))
    np.testing.assert_array_equal(_cv2_read(path), _cv2_read(src))


def test_png_shape_reads_the_header(tmp_path):
    for name in ('image_2', 'depth_2_multiscale',
                 'instance_2_depth_2_multiscale'):
        path = os.path.join(SPLIT, name, SAMPLE + '.png')
        assert image_io.png_shape(path) == image_io.read_png(path).shape[:2]
    bad = tmp_path / 'bad.png'
    bad.write_bytes(b'not a png at all, not at all')
    with pytest.raises(ValueError, match='PNG'):
        image_io.png_shape(str(bad))


def test_save_depth_map_matches_jax(tmp_path):
    """metres * 256 truncated to uint16, as JAX's cv2 writer stores it,
    on values that sit on and just off the LSB boundaries."""
    rng = np.random.RandomState(0)
    depth = rng.uniform(0.0, 90.0, (37, 53)).astype(np.float32)
    depth[0, :6] = [0.0, 0.05, 1.0 / 256, 2.0 - 1e-6, 2.0, 255.99]
    ours, theirs = str(tmp_path / 'ours.png'), str(tmp_path / 'jax.png')
    depth_map_utils.save_depth_map(ours, depth)
    jax_depth_map_utils.save_depth_map(theirs, depth)
    np.testing.assert_array_equal(_cv2_read(ours), _cv2_read(theirs))
    np.testing.assert_array_equal(
        depth_map_utils.read_depth_map(ours),
        jax_depth_map_utils.read_depth_map(theirs))


# --------------------------------------------------------------------------
# Geometry
# --------------------------------------------------------------------------

def test_depth_point_cloud_matches_jax():
    calib = calib_utils.get_frame_calib(os.path.join(SPLIT, 'calib'), SAMPLE)
    depth = depth_map_utils.read_depth_map(
        os.path.join(SPLIT, 'depth_2_multiscale', SAMPLE + '.png'))
    got = projection.np_get_depth_point_cloud(depth, calib.p2)
    want = jax_projection.np_get_depth_point_cloud(depth, calib.p2)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_depth_map_point_cloud_of_a_sample_matches_jax():
    calib = calib_utils.get_frame_calib(os.path.join(SPLIT, 'calib'), SAMPLE)
    depth_dir = os.path.join(SPLIT, 'depth_2_multiscale')
    got = obj_utils.get_depth_map_point_cloud(SAMPLE, calib, depth_dir)
    want = jax_obj_utils.get_depth_map_point_cloud(SAMPLE, calib, depth_dir)
    assert got.shape == (3, 375 * 1242)
    np.testing.assert_array_equal(got, want)


def test_points_in_box_matches_jax():
    """tests/test_geometry.py's inside and outside points, and random
    points around rotated boxes, against JAX's function."""
    box_3d = np.array([0, 0, 10, 4, 2, 1.5, 0.0])
    inside = np.array([[0, -0.5, 10], [1.9, -0.1, 10.9]])
    outside = np.array([[0, -2.0, 10], [3.0, -0.5, 10], [0, -0.5, 20]])
    _, mask_in = boxes.points_in_box_3d(box_3d, inside)
    _, mask_out = boxes.points_in_box_3d(box_3d, outside)
    assert mask_in.all() and not mask_out.any()

    rng = np.random.RandomState(1)
    for ry in (0.0, 0.7, -2.1):
        box = np.array([1.0, 1.5, 12.0, 3.9, 1.6, 1.5, ry])
        points = rng.uniform([-3, -1, 9], [5, 3, 15], (4000, 3))
        got_points, got = boxes.points_in_box_3d(box, points)
        want_points, want = jax_boxes.points_in_box_3d(box, points)
        assert 0 < got.sum() < len(points)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_points, want_points)


# --------------------------------------------------------------------------
# The tools
# --------------------------------------------------------------------------

@pytest.fixture(scope='module')
def split_copy(tmp_path_factory):
    """The fixture's 000002: calib, image, velodyne scan and labels."""
    split = tmp_path_factory.mktemp('prep') / 'training'
    for name, ext in (('calib', '.txt'), ('image_2', '.png'),
                      ('velodyne', '.bin'), ('label_2', '.txt')):
        os.makedirs(split / name)
        shutil.copy(os.path.join(SPLIT, name, SAMPLE + ext), split / name)
    return split


def test_gen_depth_maps_cpu_reproduces_the_shipped_map(split_copy, capsys):
    out_dir = gen_depth_maps.main(['--data_split_dir', str(split_copy),
                                   '--device', 'cpu'])
    assert out_dir == str(split_copy / 'depth_2_multiscale')
    assert capsys.readouterr().out == '1 / 1 {}\n'.format(SAMPLE)
    got = _cv2_read(os.path.join(out_dir, SAMPLE + '.png')).astype(np.int64)
    want = _cv2_read(os.path.join(SPLIT, 'depth_2_multiscale',
                                  SAMPLE + '.png')).astype(np.int64)
    assert got.shape == want.shape == (375, 1242)

    # the float map behind the file, against cv2's pipeline
    sparse = fixture_sparse_map()
    ours = depth_fill.fill_in_multiscale(sparse, device='cpu').numpy()
    np.testing.assert_array_equal(got, (ours * 256.0).astype(np.uint16))
    from monopsr_tpu.tools import ip_basic
    _assert_pipeline_parity(ours, ip_basic.fill_in_multiscale(sparse)[0])

    flips = got != want
    lsb = ours[flips] * 256.0
    print('gen_depth_maps --device cpu: {} of {} pixels differ from the '
          'shipped map ({:.4%}), by at most {} LSB'.format(
              int(flips.sum()), flips.size, flips.mean(),
              int(np.abs(got - want).max())))
    assert np.abs(got - want).max() <= 1
    assert flips.mean() < 5e-3
    assert np.all(np.abs(lsb - np.round(lsb)) < 0.26)


def test_gen_depth_maps_needs_a_device(split_copy, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        gen_depth_maps.main(['--data_split_dir', str(split_copy)])


def test_gen_instance_masks_reproduces_the_shipped_image(split_copy,
                                                         capsys):
    shutil.copytree(os.path.join(SPLIT, 'depth_2_multiscale'),
                    split_copy / 'depth_shipped')
    out_dir = gen_instance_masks.main([
        '--data_split_dir', str(split_copy),
        '--point_cloud_source', 'depth_shipped'])
    assert out_dir == str(split_copy / 'instance_2_depth_shipped')
    assert capsys.readouterr().out == '1 / 1 {}\n'.format(SAMPLE)
    got = cv2.imread(os.path.join(out_dir, SAMPLE + '.png'),
                     cv2.IMREAD_UNCHANGED)
    want = cv2.imread(os.path.join(SPLIT, 'instance_2_depth_2_multiscale',
                                   SAMPLE + '.png'), cv2.IMREAD_UNCHANGED)
    assert got.dtype == want.dtype == np.uint8
    assert len(np.unique(want)) > 1                 # objects, not only 255
    np.testing.assert_array_equal(got, want)
    assert gen_instance_masks.INFLATIONS.keys() == \
        jax_gen_instance_masks.INFLATIONS.keys()
    for name, value in jax_gen_instance_masks.INFLATIONS.items():
        np.testing.assert_array_equal(gen_instance_masks.INFLATIONS[name],
                                      value)
    np.testing.assert_array_equal(gen_instance_masks.BOX_OFFSET,
                                  jax_gen_instance_masks.BOX_OFFSET)
