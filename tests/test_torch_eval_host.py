"""monopsr_torch's evaluation host side against the JAX package's: box
geometry, orientation decode, the cen_x post-process, re-scoring,
prediction formatting and saving, the KITTI and metrics writers, the
native AP evaluator; and the port's pipeline, prefetch pool, ledger and
polling loop, mirroring the JAX package's own tests of them
(tests/test_pipeline.py, tests/test_evaluator_polling.py,
tests/test_device_encoding.py).

Inputs are random from numpy seeds. Both packages compute the host math
in float64 numpy, so functions are held to rtol 1e-12; files the
writers produce are held byte for byte, except the mask PNGs, whose
pixels are held equal (the port's PNG writer compresses differently from
cv2's).
"""

import copy
import os
import shutil

import cv2
import numpy as np
import pytest
import torch

from monopsr_tpu.config import ConfigObj as JaxConfigObj
from monopsr_tpu.datasets.kitti import instance_utils as jax_instance
from monopsr_tpu.datasets.kitti.kitti_dataset import \
    KittiDataset as JaxKittiDataset
from monopsr_tpu.eval import kitti_writers as jax_writers
from monopsr_tpu.eval import pipeline as jax_pipeline
from monopsr_tpu.eval import predictions as jax_predictions
from monopsr_tpu.eval.evaluator import Evaluator as JaxEvaluator
from monopsr_tpu.geometry import boxes as jax_boxes
from monopsr_tpu.geometry import orientation as jax_orientation
from monopsr_tpu.models import monopsr as jax_monopsr
from monopsr_tpu.models.monopsr_net import NetConfig as JaxNetConfig
from monopsr_torch import constants as C
from monopsr_torch.config import ConfigObj
from monopsr_torch.datasets.kitti import instance_utils
from monopsr_torch.datasets.kitti.kitti_dataset import KittiDataset
from monopsr_torch.eval import evaluator, kitti_writers, native_eval
from monopsr_torch.eval import pipeline, predictions
from monopsr_torch.geometry import boxes, orientation
from monopsr_torch.models.monopsr_net import NetConfig
from monopsr_torch.utils import image_io
from monopsr_torch.utils.prefetch import ordered_prefetch

from tests.test_dataset import make_dataset_config
from tests.test_predictions_vectorized import (CAM_P, IMG_SHAPE,
                                               _random_boxes)
from tests.test_torch_train_loop import REPO, _raw_config

RTOL = 1e-12


class _Calib:
    p2 = CAM_P


class _FakeDataset:
    calib_dir = None


@pytest.fixture
def fixed_calib(monkeypatch):
    """Both packages' score_boxes read CAM_P as the sample's camera."""
    for module in (predictions, jax_predictions):
        monkeypatch.setattr(module.calib_utils, 'get_frame_calib',
                            lambda *a, **k: _Calib())


# --------------------------------------------------------------------------
# Host math against JAX
# --------------------------------------------------------------------------

def test_box_geometry_matches_jax():
    rng = np.random.RandomState(10)
    boxes_2d, boxes_3d = _random_boxes(rng, 50)
    corners = boxes.np_compute_box_3d_corners_batch(boxes_3d)
    np.testing.assert_allclose(
        corners, jax_boxes.np_compute_box_3d_corners_batch(boxes_3d),
        rtol=RTOL)
    for box in boxes_3d[:10]:
        np.testing.assert_allclose(
            boxes.np_compute_box_3d_corners(box),
            jax_boxes.np_compute_box_3d_corners(box), rtol=RTOL)
    np.testing.assert_allclose(
        boxes.np_project_corners_batch(corners, CAM_P),
        jax_boxes.np_project_corners_batch(corners, CAM_P), rtol=RTOL)
    np.testing.assert_array_equal(boxes.boxes_2d_to_iou_fmt(boxes_2d),
                                  jax_boxes.boxes_2d_to_iou_fmt(boxes_2d))
    size = (IMG_SHAPE[1], IMG_SHAPE[0])
    for box in boxes_3d:
        for kwargs in ({}, {'truncate': True, 'image_size': size},
                       {'truncate': True, 'image_size': size,
                        'discard_before_truncation': False}):
            got = boxes.project_to_image_space(box, CAM_P, **kwargs)
            want = jax_boxes.project_to_image_space(box, CAM_P, **kwargs)
            assert (got is None) == (want is None)
            if want is not None:
                np.testing.assert_allclose(got, want, rtol=RTOL)


def test_angle_decode_and_cen_x_match_jax():
    rng = np.random.RandomState(11)
    bins = rng.randint(0, 12, 200)
    residuals = rng.uniform(-0.6, 0.6, 200)
    np.testing.assert_allclose(
        orientation.np_angle_bin_to_orientation(bins, residuals, 12),
        jax_orientation.np_angle_bin_to_orientation(bins, residuals, 12),
        rtol=RTOL)
    assert orientation.np_angle_bin_to_orientation(6, 0.3, 12) == \
        jax_orientation.np_angle_bin_to_orientation(6, 0.3, 12)

    boxes_2d, boxes_3d = _random_boxes(rng, 64)
    got = instance_utils.postprocess_cen_x_batch(boxes_2d, boxes_3d, CAM_P)
    np.testing.assert_allclose(
        got, jax_instance.postprocess_cen_x_batch(boxes_2d, boxes_3d, CAM_P),
        rtol=RTOL)
    scalar = [np.squeeze(instance_utils.postprocess_cen_x(b2, b3, CAM_P))
              for b2, b3 in zip(boxes_2d, boxes_3d)]
    np.testing.assert_allclose(got, scalar, rtol=1e-9, atol=1e-9)
    assert instance_utils.postprocess_cen_x_batch(
        np.zeros((0, 4)), np.zeros((0, 7)), CAM_P).shape == (0,)


def test_score_boxes_matches_jax_and_the_scalar_rules(fixed_calib):
    rng = np.random.RandomState(12)
    boxes_2d, boxes_3d = _random_boxes(rng, 64)
    scores = rng.uniform(0, 1, (64, 1))
    got = predictions.score_boxes(_FakeDataset(), '000000', IMG_SHAPE,
                                  boxes_2d, boxes_3d, scores)
    np.testing.assert_allclose(
        got, jax_predictions.score_boxes(_FakeDataset(), '000000', IMG_SHAPE,
                                         boxes_2d, boxes_3d, scores),
        rtol=RTOL)

    # the scalar rules of project_to_image_space, box by box
    want = np.zeros_like(scores)
    for idx, (box_2d, box_3d) in enumerate(zip(boxes_2d, boxes_3d)):
        projected = boxes.project_to_image_space(
            box_3d, CAM_P, truncate=True,
            image_size=(IMG_SHAPE[1], IMG_SHAPE[0]))
        x1, y1, x2, y2 = np.squeeze(boxes.boxes_2d_to_iou_fmt([box_2d]))
        if projected is None:
            fit = 0.1
        else:
            fit = 1.0 - (abs((x1 - projected[0]) / (x2 - x1)) +
                         abs((x2 - projected[2]) / (x2 - x1)) +
                         abs((y1 - projected[1]) / (y2 - y1)) +
                         abs((y2 - projected[3]) / (y2 - y1)))
        depth = np.clip(1.0 - box_3d[2] / 45.0, 0.1, 1.0)
        want[idx] = 0.95 * scores[idx] + 0.05 * (depth + fit) / 2.0
    np.testing.assert_allclose(got, want, atol=1e-9)
    assert (np.abs(got - (0.95 * scores + 0.05 * 0.1)) > 1e-6).any()
    assert predictions.score_boxes(
        _FakeDataset(), '000000', IMG_SHAPE, np.zeros((0, 4)),
        np.zeros((0, 7)), np.zeros((0, 1))).shape == (0, 1)


def _sample_and_outputs(rng, cfg, num_boxes, num_objs):
    boxes_2d, boxes_3d = _random_boxes(rng, num_boxes)
    sample = {
        C.SAMPLE_NAME: '000000',
        C.SAMPLE_IMAGE_INPUT: np.zeros(IMG_SHAPE, np.uint8),
        C.SAMPLE_NUM_OBJS: num_objs,
        C.SAMPLE_CAM_P: CAM_P,
        C.SAMPLE_LABEL_SCORES: rng.uniform(0, 1, num_boxes),
        C.SAMPLE_LABEL_BOXES_2D: boxes_2d,
        C.SAMPLE_LABEL_BOXES_3D: boxes_3d,
        C.SAMPLE_LABEL_CLASS_INDICES: np.ones((num_boxes, 1), np.int32),
    }
    roi = cfg.map_roi_size
    outputs = {
        C.KEY_VALID_MASK_MAPS: rng.randn(num_boxes, roi[0], roi[1], 1) > 0,
        C.KEY_INST_XYZ_MAP_LOCAL: rng.randn(
            num_boxes, roi[0], roi[1], 3).astype(np.float16),
        C.KEY_LWH: rng.uniform(0.5, 4, (num_boxes, 3)).astype(np.float32),
        C.KEY_VIEW_ANG: rng.uniform(-1, 1, (num_boxes, 1)).astype(
            np.float32),
        C.KEY_ALPHA_BINS: rng.randn(num_boxes, cfg.num_alpha_bins).astype(
            np.float32),
        C.KEY_ALPHA_REGS: rng.uniform(
            -0.2, 0.2, (num_boxes, cfg.num_alpha_bins)).astype(np.float32),
        C.KEY_CENTROIDS: np.stack(
            [rng.uniform(-5, 5, num_boxes), rng.uniform(0.5, 2, num_boxes),
             rng.uniform(5, 40, num_boxes)], axis=1).astype(np.float32),
    }
    return sample, outputs


@pytest.mark.parametrize('mode', ['val', 'test'])
def test_format_and_save_predictions_match_jax(fixed_calib, tmp_path, mode):
    """The same host outputs (truncated to a slot bucket of 4 of 8 slots,
    as the device packs them) formatted and saved by both packages."""
    num_boxes, num_objs, bucket = 8, 3, 4
    rng = np.random.RandomState(13)
    cfg = NetConfig(num_boxes=num_boxes)
    jcfg = JaxNetConfig(num_boxes=num_boxes)
    sample, outputs = _sample_and_outputs(rng, cfg, num_boxes, num_objs)
    outputs = jax_monopsr.slice_box_slots(outputs, num_boxes, bucket)
    for post in (True, False):
        got = predictions.format_predictions(
            cfg, outputs, sample, _FakeDataset(), mode,
            post_process_cen_x=post)
        want = jax_predictions.format_predictions(
            jcfg, outputs, sample, _FakeDataset(), mode,
            post_process_cen_x=post)
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            assert got[key].dtype == value.dtype, key
            np.testing.assert_allclose(got[key], value, rtol=RTOL,
                                       err_msg=key)
        assert got[C.KEY_BOX_3D].shape == (num_objs, 9)

    dirs = {}
    for name, module in (('jax', jax_predictions), ('torch', predictions)):
        dirs[name] = {key: str(tmp_path / name / key) for key in (
            C.OUT_DIR_BOX_3D, C.OUT_DIR_BOX_2D, C.OUT_DIR_XYZ_MAP_LOCAL)}
        for path in dirs[name].values():
            os.makedirs(path)
        module.save_predictions(want, '000000', dirs[name])
    for key in dirs['jax']:
        names = sorted(os.listdir(dirs['jax'][key]))
        assert names and sorted(os.listdir(dirs['torch'][key])) == names
        for name in names:
            jpath = os.path.join(dirs['jax'][key], name)
            tpath = os.path.join(dirs['torch'][key], name)
            if name.endswith('.png'):
                mask = cv2.imread(jpath, cv2.IMREAD_GRAYSCALE)
                np.testing.assert_array_equal(
                    cv2.imread(tpath, cv2.IMREAD_GRAYSCALE), mask)
                np.testing.assert_array_equal(image_io.read_png(tpath), mask)
                assert set(np.unique(mask)) <= {0, 255}
            else:
                with open(jpath, 'rb') as fj, open(tpath, 'rb') as ft:
                    assert ft.read() == fj.read(), name


# --------------------------------------------------------------------------
# Writers against JAX, byte for byte
# --------------------------------------------------------------------------

def _datasets(split):
    raw = make_dataset_config(data_split=split).to_dict()
    return (KittiDataset(ConfigObj(copy.deepcopy(raw)), 'val'),
            JaxKittiDataset(JaxConfigObj(copy.deepcopy(raw)), 'val'))


def _write_raw_predictions(rng, names, box_3d_dir, box_2d_dir):
    """(N, 9) and (N, 7) prediction txts: random rows with scores on both
    sides of 0.1 (none within 1e-4 of it), a sample whose rows all fall
    below it, one with an empty file and one with none."""
    os.makedirs(box_3d_dir)
    os.makedirs(box_2d_dir)
    for i, name in enumerate(names):
        if i == 0:
            continue                                      # no file
        n = 0 if i == 1 else rng.randint(1, 5)
        rows_3d = np.column_stack([
            rng.uniform(-20, 20, n), rng.uniform(0.5, 2.5, n),
            rng.uniform(5, 60, n), rng.uniform(3, 5, n),
            rng.uniform(1.4, 2, n), rng.uniform(1.3, 1.8, n),
            rng.uniform(-np.pi, np.pi, n),
            rng.uniform(0.0, 0.05, n) if i == 2 else
            rng.uniform(0.0, 1.0, n), np.zeros(n)]).reshape(-1, 9)
        rows_3d[np.abs(rows_3d[:, 7] - 0.1) < 1e-3, 7] += 2e-3
        y1, x1 = rng.uniform(100, 300, n), rng.uniform(0, 1100, n)
        rows_2d = np.column_stack([
            y1, x1, y1 + rng.uniform(20, 80, n), x1 + rng.uniform(20, 140, n),
            rng.uniform(-np.pi, np.pi, n), rows_3d[:, 7],
            np.zeros(n)]).reshape(-1, 7)
        np.savetxt(os.path.join(box_3d_dir, name + '.txt'), rows_3d,
                   fmt='%0.5f')
        np.savetxt(os.path.join(box_2d_dir, name + '.txt'), rows_2d,
                   fmt='%0.5f')


def _same_tree(got_dir, want_dir):
    names = sorted(os.listdir(want_dir))
    assert names and sorted(os.listdir(got_dir)) == names
    for name in names:
        with open(os.path.join(got_dir, name), 'rb') as fg, \
                open(os.path.join(want_dir, name), 'rb') as fw:
            assert fg.read() == fw.read(), name
    return names


def test_kitti_writer_matches_jax_byte_for_byte(tmp_path):
    dataset, jdataset = _datasets('val')
    names = [s.name for s in dataset.sample_list]
    raw = str(tmp_path / 'raw')
    _write_raw_predictions(np.random.RandomState(14), names,
                           os.path.join(raw, 'box_3d'),
                           os.path.join(raw, 'box_2d'))
    out = {}
    for key, module, ds in (('torch', kitti_writers, dataset),
                            ('jax', jax_writers, jdataset)):
        out[key] = module.save_predictions_box_3d_in_kitti_format(
            0.1, ds, str(tmp_path / key), os.path.join(raw, 'box_3d'),
            os.path.join(raw, 'box_2d'), 7)
    assert out['torch'][1] == out['jax'][1] == len(names) - 3
    assert out['torch'][0] == str(tmp_path / 'torch' / 'kitti_predictions_3d'
                                  / 'val' / '0.1' / '7' / 'data')
    written = _same_tree(out['torch'][0], out['jax'][0])
    assert written == sorted(n + '.txt' for n in names)
    sizes = [os.path.getsize(os.path.join(out['torch'][0], n))
             for n in written]
    assert sizes.count(0) == 3


def test_metrics_csvs_and_timing_statistics_match_jax(tmp_path, capsys):
    rng = np.random.RandomState(15)
    metrics = {C.METRIC_EMD: rng.uniform(0, 2, 40),
               C.METRIC_CEN_X_ERR: np.append(rng.randn(30), np.nan),
               C.METRIC_DIM_ERR: rng.randn(20, 3).ravel(),
               C.METRIC_CHAMFER: np.full(4, np.nan)}
    got = kitti_writers.save_metrics(str(tmp_path / 'torch'), 5, 'val',
                                     metrics)
    want = jax_writers.save_metrics(str(tmp_path / 'jax'), 5, 'val', metrics)
    assert _same_tree(got, want) == ['metrics_avg.csv', 'metrics_avg_abs.csv',
                                     'metrics_std.csv', 'metrics_std_abs.csv']

    capsys.readouterr()
    feed, infer = rng.uniform(0, 1, 9), rng.uniform(0, 1, 8)
    kitti_writers.print_inference_time_statistics(feed, infer)
    kitti_writers.print_inference_time_statistics([], [])
    got = capsys.readouterr().out
    jax_writers.print_inference_time_statistics(feed, infer)
    jax_writers.print_inference_time_statistics([], [])
    assert got == capsys.readouterr().out and 'median' in got


# --------------------------------------------------------------------------
# The native AP evaluator against JAX's
# --------------------------------------------------------------------------

def _kitti_predictions_from_labels(label_dir, names, data_dir, seed):
    """KITTI rows from the ground truth with 0.4 m of jitter in x and z
    and random scores, so that the AP lies between 0 and 100."""
    rng = np.random.RandomState(seed)
    os.makedirs(data_dir)
    for name in names:
        rows = []
        with open(os.path.join(label_dir, name + '.txt')) as f:
            for line in f:
                parts = line.split()
                if parts[0] == 'DontCare':
                    continue
                vals = [float(x) for x in parts[1:]]
                vals[10] += rng.uniform(-0.4, 0.4)
                vals[12] += rng.uniform(-0.4, 0.4)
                rows.append(parts[0] + ' ' + ' '.join(
                    '%.2f' % v for v in vals) + ' %.2f' % rng.uniform(0.5, 1))
        with open(os.path.join(data_dir, name + '.txt'), 'w') as f:
            f.write('\r\n'.join(rows) + '\r\n' if rows else '')


def test_native_eval_matches_jax_run_kitti_native_eval(tmp_path):
    """The port's binary (built from the repo's source by g++ into build/)
    and native_eval.run against JAX's run_kitti_native_eval(background=
    False) (make and the two scripts, in a copy of their directory), on
    one KITTI prediction directory: the same results files."""
    dataset, _ = _datasets('val')
    names = [s.name for s in dataset.sample_list]
    label_dir = os.path.join(dataset.data_split_dir, 'label_2')
    step, thr = 4, 0.1
    result_dir = tmp_path / 'pred' / 'kitti_predictions_3d' / 'val' / '0.1' \
        / str(step)
    _kitti_predictions_from_labels(label_dir, names,
                                   str(result_dir / 'data'), 16)

    eval_dir = tmp_path / 'kitti_native_eval'
    eval_dir.mkdir()
    src = os.path.join(REPO, 'scripts', 'offline_eval', 'kitti_native_eval')
    for name in ('Makefile', 'evaluate_object_3d_offline.cpp', 'run_eval.sh',
                 'run_eval_low_iou.sh'):
        shutil.copy2(os.path.join(src, name), eval_dir / name)
    jev = JaxEvaluator.__new__(JaxEvaluator)
    jev.native_eval_dir = str(eval_dir)
    jev.score_threshold = thr
    jev.dataset = type('D', (), {'data_split': 'val',
                                 'data_split_dir': dataset.data_split_dir})()
    jev.config = type('Cfg', (), {'config_name': 'jax_run',
                                  'pred_dir': str(tmp_path / 'pred')})()
    jev.run_kitti_native_eval(step, background=False)

    binary = native_eval.build()
    assert binary.startswith(os.path.join(REPO, 'build', 'kitti_native_eval'))
    files = native_eval.results_paths(str(tmp_path / 'pred'), 'torch_run',
                                      thr)
    native_eval.run(binary, label_dir, str(result_dir), step, files)
    for got, regime in zip(files, ('', 'low_iou_')):
        want = tmp_path / 'pred' / 'jax_run_results_{}0.1.txt'.format(regime)
        assert got == str(tmp_path / 'pred' / 'torch_run_results_{}0.1.txt'
                          .format(regime))
        with open(got) as f:
            text = f.read()
        assert text == want.read_text()
        assert text.startswith('step 4\n') and 'car_detection_3D AP:' in text
    aps = [float(x) for line in text.splitlines() if ' AP: ' in line
           for x in line.split(' AP: ')[1].split()]
    assert 0 < max(aps) <= 100


def test_native_eval_raises_on_a_failed_run(tmp_path):
    files = native_eval.results_paths(str(tmp_path), 'x', 0.1)
    with pytest.raises(RuntimeError, match='exited'):
        native_eval.run(native_eval.build(), str(tmp_path / 'no_labels'),
                        str(tmp_path / 'no_results'), 1, files)
    assert open(files[0]).read().startswith('step 1\n')


# --------------------------------------------------------------------------
# Pipeline, prefetch (mirrors of the JAX package's tests)
# --------------------------------------------------------------------------

def test_slot_bucket_matches_jax():
    for needed in range(0, 40, 3):
        samples = [{C.SAMPLE_NUM_OBJS: max(needed - k, 0)} for k in range(3)]
        for buckets in ([8, 16, 32], [32], [4, 32]):
            assert pipeline.slot_bucket(samples, buckets, 32) == \
                jax_pipeline.slot_bucket(samples, buckets, 32)


def test_pipeline_order_and_flush():
    seen = []
    pipe = pipeline.BatchedPullPipeline(
        lambda sample, out: seen.append((sample, out)), pull_batch=3)
    for i in range(7):  # 2 full batches + remainder of 1
        pipe.add(i, torch.full((2,), i, dtype=torch.float32))
    pipe.close()
    assert [s for s, _ in seen] == list(range(7))
    for i, (_, out) in enumerate(seen):
        assert isinstance(out, np.ndarray)
        np.testing.assert_array_equal(out, np.full((2,), i, np.float32))


def test_pipeline_pull_time_callback():
    calls = []
    pipe = pipeline.BatchedPullPipeline(
        lambda s, o: None, pull_batch=2,
        on_pull_time=lambda dt, n: calls.append((dt, n)))
    for i in range(5):
        pipe.add(i, torch.zeros(()), start=pipeline.mark('cpu') - 0.25)
    pipe.close()
    assert [n for _, n in calls] == [2, 2, 1]
    assert all(0.25 <= dt < 60 for dt, _ in calls)


def test_pipeline_worker_error_propagates():
    def boom(sample, out):
        raise RuntimeError('processing failed')

    pipe = pipeline.BatchedPullPipeline(boom, pull_batch=1)
    pipe.add(0, torch.zeros(()))
    with pytest.raises(RuntimeError, match='processing failed'):
        # keep feeding after the failure; close() must not deadlock
        for i in range(1, 10):
            pipe.add(i, torch.zeros(()))
        pipe.close()
    assert not pipe._worker.is_alive()


def test_pipeline_tuple_outputs_roundtrip():
    """Outputs shaped like the evaluator's (outputs, losses, metrics)."""
    got = []
    pipe = pipeline.BatchedPullPipeline(lambda s, out: got.append(out),
                                        pull_batch=4)
    step_out = ({'xyz': torch.ones((2, 3), dtype=torch.float16),
                 'mask': torch.tensor([True, False]),
                 'ang': torch.full((2,), 0.5, dtype=torch.bfloat16)},
                {'loss': torch.tensor(1.5)},
                {'err': torch.arange(3.0)})
    pipe.add('s', step_out)
    pipe.close()
    outputs, losses, metrics = got[0]
    assert outputs['xyz'].dtype == np.float16
    assert outputs['mask'].dtype == np.bool_
    assert outputs['ang'].dtype == np.float32 and outputs['ang'][0] == 0.5
    assert float(losses['loss']) == 1.5
    np.testing.assert_array_equal(metrics['err'], np.arange(3.0))


def test_ordered_prefetch_preserves_order_and_raises():
    got = list(ordered_prefetch(lambda i: i * i, range(50),
                                num_threads=4, prefetch=6))
    assert got == [i * i for i in range(50)]

    def boom(i):
        if i == 7:
            raise ValueError('boom')
        return i

    seen = []
    with pytest.raises(ValueError, match='boom'):
        for item in ordered_prefetch(boom, range(20), num_threads=3):
            seen.append(item)
    assert seen == list(range(7))


# --------------------------------------------------------------------------
# Ledger and polling (mirror tests/test_evaluator_polling.py)
# --------------------------------------------------------------------------

class FakeManager:
    def __init__(self, steps):
        self._steps = steps

    def all_steps(self):
        return list(self._steps)


def make_polling_evaluator(tmp_path, monkeypatch, steps_feed,
                           eval_mode='val'):
    """An Evaluator shell with the heavy pieces stubbed."""
    ev = evaluator.Evaluator.__new__(evaluator.Evaluator)
    ev.eval_mode = eval_mode
    ev.skip_evaluated_checkpoints = True
    ev.eval_wait_interval = 0
    ev.ledger_path = str(tmp_path / 'evaluated_val.txt')
    ev._native_pool, ev._native_jobs = None, []

    evaluated = []
    manager = FakeManager(steps_feed)
    monkeypatch.setattr('monopsr_torch.train.trainer.CheckpointManager',
                        lambda *a, **k: manager)
    ev.config = type('C', (), {'checkpoint_dir': str(tmp_path)})()
    ev.restore_checkpoint = lambda mgr, step: ('state', step)
    ev.run_checkpoint_once = lambda state, step: evaluated.append(step)
    return ev, evaluated, manager


def test_polls_evaluate_in_order_and_ledger_skips(tmp_path, monkeypatch):
    ev, evaluated, manager = make_polling_evaluator(
        tmp_path, monkeypatch, [4, 2])

    last = ev.repeated_checkpoint_run(max_wait_iterations=2)
    assert evaluated == [2, 4]          # oldest first
    assert last == 4
    assert ev.get_evaluated_ckpts() == {2, 4}

    # New checkpoint appears; old ones are ledger-skipped
    manager._steps = [2, 4, 6]
    last = ev.repeated_checkpoint_run(max_wait_iterations=2)
    assert evaluated == [2, 4, 6]
    assert last == 6

    # Nothing new: loop waits out and returns None without evaluating
    last = ev.repeated_checkpoint_run(max_wait_iterations=1)
    assert evaluated == [2, 4, 6]
    assert last is None


def test_ledger_file_format(tmp_path, monkeypatch):
    ev, evaluated, _ = make_polling_evaluator(tmp_path, monkeypatch, [10])
    ev.repeated_checkpoint_run(max_wait_iterations=1)
    with open(ev.ledger_path) as f:
        assert f.read().split() == ['10']
    # Appends, one step per line
    ev._mark_evaluated(12)
    assert ev.get_evaluated_ckpts() == {10, 12}


def test_run_latest_checkpoints_ledgers_val_mode_only(tmp_path, monkeypatch):
    """run_latest_checkpoints writes no ledger in val mode either (as the
    JAX evaluator: only the polling loop writes it; the two held side by
    side in tests/test_torch_evaluator.py::test_ledger_matches_jax_evaluator),
    so a poller afterwards evaluates every step."""
    ev, evaluated, _ = make_polling_evaluator(tmp_path, monkeypatch,
                                              [6, 2, 4])
    ev.run_latest_checkpoints([4, 6, 8])
    assert evaluated == [4, 6] and not os.path.exists(ev.ledger_path)
    ev.repeated_checkpoint_run(max_wait_iterations=1)
    assert evaluated == [4, 6, 2, 4, 6]
    assert ev.get_evaluated_ckpts() == {2, 4, 6}

    ev, evaluated, _ = make_polling_evaluator(tmp_path / 'test', monkeypatch,
                                              [2], eval_mode='test')
    ev.run_latest_checkpoints('all')
    assert evaluated == [2] and not os.path.exists(ev.ledger_path)

    ev, _, _ = make_polling_evaluator(tmp_path, monkeypatch, [])
    with pytest.raises(RuntimeError, match='No checkpoints'):
        ev.run_latest_checkpoints('all')


def test_native_eval_failure_reaches_the_polling_loop(tmp_path,
                                                      monkeypatch):
    ev, evaluated, _ = make_polling_evaluator(tmp_path, monkeypatch, [2])
    from concurrent.futures import Future
    failed = Future()
    failed.set_exception(RuntimeError('native KITTI evaluator exited 1'))
    ev.run_checkpoint_once = lambda state, step: ev._native_jobs.append(
        failed)
    with pytest.raises(RuntimeError, match='exited 1'):
        ev.run_latest_checkpoints('all')
    assert ev._native_jobs == []


def test_evaluator_refuses_data_parallel(tmp_path, monkeypatch):
    # eval_data_parallel is clamped to the visible devices (1 on the CPU,
    # where 2 runs as 1: tests/test_torch_evaluator.py); where more than
    # one is left, the evaluator runs only inside the ranks that
    # parallel.data_parallel.launch starts (the CLIs start them;
    # tests/test_torch_data_parallel.py), and raises outside them (two
    # devices counted here)
    from monopsr_torch.utils import device as device_lib
    assert device_lib.visible_device_count(torch.device('cpu')) == 1
    monkeypatch.setattr(device_lib, 'visible_device_count', lambda d: 2)
    for key in ('eval_data_parallel', 'data_parallel'):
        raw = _raw_config(tmp_path, 1)
        raw['train_config'].pop('eval_data_parallel', None)
        raw['train_config'][key] = 2
        config = ConfigObj(raw)
        with pytest.raises(ValueError, match='data_parallel.launch'):
            evaluator.Evaluator(config, None, 'val', device='cpu')
    with pytest.raises(ValueError, match='eval_mode'):
        evaluator.Evaluator(ConfigObj(_raw_config(tmp_path, 1)), None,
                            'train', device='cpu')
