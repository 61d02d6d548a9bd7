"""The port's drawing helpers, demo helpers and demos against the JAX
package's (mirrors tests/test_vis.py, the demo tests of
tests/test_demos_and_analysis.py and TestDemoUtils of
tests/test_aux_utils.py).

Both packages draw with the same matplotlib (Agg) here, so each figure
and each demo's PNG must equal the JAX one pixel for pixel.
"""

import importlib.util
import os
import sys

import matplotlib

matplotlib.use('Agg')

import cv2  # noqa: E402
import numpy as np  # noqa: E402

from monopsr_torch.datasets.kitti import calib_utils, obj_utils  # noqa: E402
from monopsr_torch.demos import (show_jittered_boxes_2d,  # noqa: E402
                                 view_instance_masks, view_kitti_sample_2d)
from monopsr_torch.utils import demo_utils  # noqa: E402
from monopsr_torch.visualization import vis_utils  # noqa: E402
from monopsr_tpu.datasets.kitti import calib_utils as jax_calib  # noqa: E402
from monopsr_tpu.datasets.kitti import obj_utils as jax_obj  # noqa: E402
from monopsr_tpu.utils import demo_utils as jax_demo_utils  # noqa: E402
from monopsr_tpu.visualization import vis_utils as jax_vis  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = os.path.join(REPO, 'tests/datasets/Kitti/object/training')


def _pixels(path):
    image = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert image is not None and image.size > 0, path
    return image


def _sample(pkg_obj, pkg_calib, name='000002'):
    labels = pkg_obj.read_labels(os.path.join(SPLIT, 'label_2'), name)
    calib = pkg_calib.get_frame_calib(os.path.join(SPLIT, 'calib'), name)
    image = pkg_obj.get_image(name, os.path.join(SPLIT, 'image_2'))
    return labels, calib, image


def _draw_boxes(vis, labels, calib, image, path):
    fig, axes = vis.plots_from_image(image, 2, 1)
    drew = 0
    for obj in labels:
        if obj.type == 'DontCare':
            continue
        vis.draw_obj_as_box_3d(
            axes[0], obj, calib.p2, show_orientation=True,
            double_line=True, colour_table=['#00cc00', 'y', 'r', 'w'])
        vis.draw_box_2d(axes[1], obj)
        drew += 1
    vis.save_fig(fig, str(path))
    return drew


def test_draw_boxes_and_grid_equal_jax(tmp_path):
    labels, calib, image = _sample(obj_utils, calib_utils)
    jlabels, jcalib, jimage = _sample(jax_obj, jax_calib)
    np.testing.assert_array_equal(image, jimage)
    drew = _draw_boxes(vis_utils, labels, calib, image, tmp_path / 'p.png')
    jdrew = _draw_boxes(jax_vis, jlabels, jcalib, jimage, tmp_path / 'j.png')
    assert drew == jdrew > 0
    np.testing.assert_array_equal(_pixels(tmp_path / 'p.png'),
                                  _pixels(tmp_path / 'j.png'))


def test_point_colours_equal_jax():
    _, calib, image = _sample(obj_utils, calib_utils)
    pts = np.array([[0.0, 1.0, 10.0], [2.0, 1.2, 20.0], [-3.0, 1.5, 35.0]])
    got = vis_utils.get_point_colours(pts, calib.p2, image)
    assert got.shape == (3, 3)
    np.testing.assert_array_equal(
        got, jax_vis.get_point_colours(pts, calib.p2, image))


def test_instance_mask_overlay_equals_jax():
    _, _, image = _sample(obj_utils, calib_utils)
    inst = np.full(image.shape[:2], 255, np.int32)
    inst[100:200, 300:500] = 0
    inst[150:250, 600:700] = 3
    blend = vis_utils.draw_instance_masks(image, inst)
    assert blend.shape == image.shape
    assert not np.array_equal(blend[150, 400], image[150, 400])
    np.testing.assert_array_equal(blend[0, 0], image[0, 0])
    np.testing.assert_array_equal(blend,
                                  jax_vis.draw_instance_masks(image, inst))


def test_demo_utils_equal_jax(tmp_path):
    gt = np.array([[0, 1.5, 20, 4, 1.6, 1.5, 0.0],
                   [5, 1.5, 30, 4, 1.6, 1.5, 0.5]])
    pred = gt.copy()
    pred[0, 0] += 0.1
    rng = np.random.RandomState(4)
    preds = np.concatenate([pred, gt + rng.uniform(-0.5, 0.5, gt.shape)])
    idx, iou = demo_utils.match_predictions_to_gt(preds, gt)
    assert list(idx[:2]) == [0, 1] and iou[0] > 0.8 and iou[1] > 0.99
    jidx, jiou = jax_demo_utils.match_predictions_to_gt(preds, gt)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(iou, jiou, rtol=1e-12)
    empty = demo_utils.match_predictions_to_gt(preds, np.zeros((0, 7)))
    assert list(empty[0]) == [-1] * 4

    labels, _, _ = _sample(obj_utils, calib_utils, '000003')
    jlabels, _, _ = _sample(jax_obj, jax_calib, '000003')
    assert [demo_utils.difficulty_colour(o) for o in labels] == \
        [jax_demo_utils.difficulty_colour(o) for o in jlabels]

    exp = tmp_path / 'outputs' / 'probe'
    exp.mkdir(parents=True)
    with open(os.path.join(REPO, 'configs', 'monopsr_model_000.yaml')) as f:
        (exp / 'probe.yaml').write_text(f.read())
    config, exp_dir = demo_utils.get_experiment_info(
        'probe', output_base_dir=str(tmp_path / 'outputs'))
    jconfig, jexp_dir = jax_demo_utils.get_experiment_info(
        'probe', output_base_dir=str(tmp_path / 'outputs'))
    assert exp_dir == jexp_dir == str(exp)
    assert config.to_dict() == jconfig.to_dict()


def _jax_demo(name):
    path = os.path.join(REPO, 'demos', name + '.py')
    spec = importlib.util.spec_from_file_location('jax_demo_' + name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_demos_write_the_jax_pngs(tmp_path, monkeypatch, capsys):
    for demo, port in (('view_kitti_sample_2d', view_kitti_sample_2d),
                       ('show_jittered_boxes_2d', show_jittered_boxes_2d),
                       ('view_instance_masks', view_instance_masks)):
        args = ['--data_split_dir', SPLIT, '--sample_name', '000002']
        np.random.seed(5)               # the jitter demo draws from it
        port.main(args + ['--out', str(tmp_path / (demo + '_port.png'))])
        np.random.seed(5)
        monkeypatch.setattr(sys, 'argv', [demo] + args + [
            '--out', str(tmp_path / (demo + '_jax.png'))])
        _jax_demo(demo).main()
        got = _pixels(tmp_path / (demo + '_port.png'))
        assert os.path.getsize(tmp_path / (demo + '_port.png')) > 1000
        np.testing.assert_array_equal(got, _pixels(tmp_path /
                                                   (demo + '_jax.png')))
    assert capsys.readouterr().out.count('Saved ') == 6
