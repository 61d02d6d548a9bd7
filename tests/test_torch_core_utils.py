"""The port's tests-only helpers (the M15 tail) against the JAX package's:
``core_utils`` (format checker, chamfer, label clusters, instance
metrics), ``geometry/planes``, ``geometry/boxes.compute_box_3d_corners_batch``,
the numpy instance crops of ``datasets/kitti/instance_utils`` and
``ops/crop_resize.crop_and_resize_nearest`` (mirrors tests/test_aux_utils.py,
tests/test_geometry.py:161, :234 and tests/test_crop_resize.py:74-89).

The numpy functions are copies and must give the JAX package's numbers
(rtol 1e-12); the torch ones are held at the JAX tests' tolerances. The
convex-hull mask is drawn without cv2 and must equal cv2's pixel for
pixel, on the fixture's instances and on seeded random hulls.
"""

import copy
import os
import tempfile

import cv2
import numpy as np
import pytest
import torch

from monopsr_torch.config import ConfigObj
from monopsr_torch.core_utils import distance_metrics, format_checker
from monopsr_torch.core_utils import instance_metrics
from monopsr_torch.core_utils.label_cluster_utils import LabelClusterUtils
from monopsr_torch.datasets.kitti import instance_utils
from monopsr_torch.datasets.kitti.kitti_dataset import KittiDataset
from monopsr_torch.datasets.kitti.obj_utils import ObjectLabel
from monopsr_torch.geometry import boxes, instance, planes
from monopsr_torch.ops import crop_resize
from monopsr_tpu.config import ConfigObj as JaxConfigObj
from monopsr_tpu.core_utils import distance_metrics as jax_distance
from monopsr_tpu.core_utils import format_checker as jax_format
from monopsr_tpu.core_utils import instance_metrics as jax_metrics
from monopsr_tpu.core_utils.label_cluster_utils import \
    LabelClusterUtils as JaxLabelClusterUtils
from monopsr_tpu.datasets.kitti import instance_utils as jax_instance_utils
from monopsr_tpu.datasets.kitti.kitti_dataset import \
    KittiDataset as JaxKittiDataset
from monopsr_tpu.geometry import boxes as jax_boxes
from monopsr_tpu.geometry import planes as jax_planes
from monopsr_tpu.ops import crop_resize as jax_crop_resize

from tests.test_dataset import make_dataset_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_DIR = os.path.join(REPO, 'tests/datasets/Kitti/object/training')
CAM_P = np.array([[700.0, 0, 600.0, 0],
                  [0, 700.0, 180.0, 0],
                  [0, 0, 1.0, 0]])
RTOL = 1e-12


# --------------------------------------------------------------------------
# Format checker, planes, chamfer
# --------------------------------------------------------------------------

@pytest.mark.parametrize('check,value', [
    ('check_box_3d_format', np.zeros(7)),
    ('check_box_3d_format', np.zeros((5, 7))),
    ('check_box_3d_format', np.zeros(6)),
    ('check_box_3d_format', np.array(['a'] * 7)),
    ('check_box_2d_format', np.zeros(4)),
    ('check_box_2d_format', np.zeros((4, 7))),
    ('check_anchor_format', np.zeros((2, 6))),
    ('check_anchor_format', np.zeros((2, 2, 6))),
    ('check_box_8c_format', np.zeros((3, 8))),
    ('check_box_8c_format', np.zeros((4, 3, 8))),
    ('check_box_8c_format', np.zeros((8, 3))),
])
def test_format_checker_accepts_and_rejects_as_jax(check, value):
    def outcome(module):
        try:
            getattr(module, check)(value)
        except module.FormatError as e:
            return 'FormatError: ' + str(e)
        return 'ok'
    assert outcome(format_checker) == outcome(jax_format)


def test_obj_label_format_as_jax():
    obj = ObjectLabel()
    obj.t = (0.0, 0.0, 0.0)
    format_checker.check_obj_label_format(obj)
    for bad in (object(), type('L', (), {})()):
        with pytest.raises(format_checker.FormatError):
            format_checker.check_obj_label_format(bad)
    obj.t = (0.0, 0.0)
    with pytest.raises(format_checker.FormatError):
        format_checker.check_obj_label_format(obj)
    assert issubclass(format_checker.FormatError, TypeError)


def test_planes_equal_jax():
    rng = np.random.RandomState(0)
    plane = [0.02, -1.0, 0.01, 1.65]
    points = rng.uniform(-10, 10, (50, 3))
    np.testing.assert_allclose(planes.dist_to_plane(plane, points),
                               jax_planes.dist_to_plane(plane, points),
                               rtol=RTOL)
    proj = planes.project_points_to_plane(plane, points)
    np.testing.assert_allclose(
        proj, jax_planes.project_points_to_plane(plane, points), rtol=RTOL)
    np.testing.assert_allclose(planes.dist_to_plane(plane, proj), 0.0,
                               atol=1e-9)
    ground = [0.0, -1.0, 0.0, 1.65]
    np.testing.assert_allclose(
        planes.dist_to_plane(ground, np.array([[0, 1.65, 10],
                                               [0, 0.65, 10]])),
        [0.0, 1.0], atol=1e-9)


def test_chamfer_equals_jax_and_bruteforce():
    rng = np.random.RandomState(2)
    for n, m in ((30, 40), (1, 7), (200, 150)):
        a = rng.uniform(-1, 1, (n, 3))
        b = rng.uniform(-1, 1, (m, 3))
        got = distance_metrics.calc_chamfer_dist(a, b)
        d = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        np.testing.assert_allclose(got, d.min(1).sum() + d.min(0).sum(),
                                   rtol=1e-12)
        np.testing.assert_allclose(
            got, jax_distance.calc_chamfer_dist(a, b), rtol=1e-12)


# --------------------------------------------------------------------------
# Label clusters
# --------------------------------------------------------------------------

def _cluster_utils():
    raw = make_dataset_config().to_dict()
    port = LabelClusterUtils(KittiDataset(ConfigObj(copy.deepcopy(raw)),
                                          'train'))
    jax = JaxLabelClusterUtils(JaxKittiDataset(
        JaxConfigObj(copy.deepcopy(raw)), 'train'))
    port.cache_dir = tempfile.mkdtemp()
    jax.cache_dir = tempfile.mkdtemp()
    return port, jax


def test_one_cluster_equals_jax_with_its_cache():
    port, jax = _cluster_utils()
    np.testing.assert_array_equal(port.collect_dims('Car'),
                                  jax.collect_dims('Car'))
    got = port.get_clusters('Car', 1)
    want = jax.get_clusters('Car', 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL)
    assert 3.0 < got[0][0][0] < 5.0
    with open(port._cache_path('Car', 1)) as f, \
            open(jax._cache_path('Car', 1)) as g:
        assert f.read() == g.read()
    cached = port.get_clusters('Car', 1)        # read back from the text
    np.testing.assert_array_equal(cached[0], jax.get_clusters('Car', 1)[0])
    np.testing.assert_allclose(cached[0], got[0], atol=5e-7)
    with pytest.raises(ValueError):
        port.get_clusters('Tram', 1)


def test_several_clusters_agree_with_jax_kmeans(monkeypatch):
    """scipy k-means against scikit-learn's on separated (l, w, h)
    clusters: the same centers (JAX's in its order, the port's by
    length) and standard deviations."""
    rng = np.random.RandomState(0)
    dims = np.concatenate([
        rng.normal([3.9, 1.6, 1.5], 0.1, (40, 3)),
        rng.normal([10.0, 2.5, 3.2], 0.2, (25, 3)),
        rng.normal([0.8, 0.6, 1.7], 0.05, (30, 3))])
    port, jax = _cluster_utils()
    monkeypatch.setattr(port, 'collect_dims', lambda c: dims)
    monkeypatch.setattr(jax, 'collect_dims', lambda c: dims)
    centers, stds = port.get_clusters('Car', 3)
    want_c, want_s = jax.get_clusters('Car', 3)
    order = np.argsort(want_c[:, 0])
    assert list(np.argsort(centers[:, 0])) == [0, 1, 2]
    np.testing.assert_allclose(centers, want_c[order], rtol=1e-6)
    np.testing.assert_allclose(stds, want_s[order], rtol=1e-6)


# --------------------------------------------------------------------------
# Instance metrics
# --------------------------------------------------------------------------

def test_projection_objectives_equal_jax():
    rng = np.random.RandomState(0)
    local = rng.uniform(-1, 1, (50, 3))
    local[:, 2] *= 0.3
    local[:3] = 0.0                                   # invalid points
    view_ang, xz_dist, cen_y = 0.2, 20.0, 1.5
    uv, valid = instance_metrics.proj_points(xz_dist, cen_y, view_ang,
                                             local, CAM_P)
    juv, jvalid = jax_metrics.proj_points(xz_dist, cen_y, view_ang, local,
                                          CAM_P)
    np.testing.assert_allclose(uv, juv, rtol=RTOL)
    np.testing.assert_array_equal(valid, jvalid)
    for x in ((xz_dist, cen_y), (xz_dist + 2.0, cen_y),
              (xz_dist, cen_y, view_ang + 0.1)):
        for rotate in (True, False):
            got = instance_metrics.np_proj_error(x, view_ang, local, uv,
                                                 valid, CAM_P, rotate)
            np.testing.assert_allclose(
                got, jax_metrics.np_proj_error(x, view_ang, local, uv,
                                               valid, CAM_P, rotate),
                rtol=RTOL)
    assert instance_metrics.np_proj_error(
        (xz_dist, cen_y), view_ang, local, uv, valid, CAM_P) < 1e-6
    assert instance_metrics.np_proj_error(
        (xz_dist, cen_y), view_ang, local, uv, np.zeros(50), CAM_P) == 1e9

    h, w, roi = 375, 1242, 8
    image = np.zeros((h, w, 3), np.uint8)
    image[..., 0] = np.linspace(0, 255, w, dtype=np.uint8)[None, :]
    image[..., 1] = np.linspace(0, 255, h, dtype=np.uint8)[:, None]
    image[..., 2] = 128
    local = rng.uniform(-0.8, 0.8, (roi * roi, 3))
    uv, _ = instance_metrics.proj_points(18.0, 1.4, 0.1, local, CAM_P)
    rgb = image[np.round(uv[1]).astype(int),
                np.round(uv[0]).astype(int)].reshape(roi, roi, 3)
    valid_map = rng.uniform(0, 1, (roi, roi)) > 0.2
    for x in ((18.0, 1.4), (23.0, 1.9), (18.0, 1.4, 0.1), (300.0, -40.0)):
        got = instance_metrics.np_proj_err_rgb(x, 0.1, local, rgb, image,
                                               valid_map, CAM_P)
        np.testing.assert_allclose(
            got, jax_metrics.np_proj_err_rgb(x, 0.1, local, rgb, image,
                                             valid_map, CAM_P), rtol=RTOL)
    assert instance_metrics.np_proj_err_rgb(
        (18.0, 1.4), 0.1, local, rgb, image, valid_map, CAM_P) < 1e-9


def test_scipy_refinement_equals_jax():
    rng = np.random.RandomState(1)
    local = rng.uniform(-1, 1, (60, 3))
    exp_uv, valid = instance_metrics.proj_points(25.0, 1.2, -0.1, local,
                                                 CAM_P)
    for kwargs in ({}, {'rotate_view': False}):
        x, fun = instance_metrics.scipy_refine_pose(
            local, exp_uv, valid, CAM_P, x0=(20.0, 0.5), viewing_angle=-0.1,
            **kwargs)
        jx, jfun = jax_metrics.scipy_refine_pose(
            local, exp_uv, valid, CAM_P, x0=(20.0, 0.5), viewing_angle=-0.1,
            **kwargs)
        np.testing.assert_allclose(x, jx, rtol=RTOL)
        np.testing.assert_allclose(fun, jfun, rtol=RTOL, atol=1e-15)
    x, _ = instance_metrics.scipy_refine_pose(
        local, exp_uv, valid, CAM_P, x0=(20.0, 0.5), viewing_angle=-0.1)
    assert abs(x[0] - 25.0) < 0.5 and abs(x[1] - 1.2) < 0.2


def _cv2_hull_mask(points, shape):
    mask = np.zeros(shape, np.uint8)
    hull = cv2.convexHull(points.astype(np.int32).reshape(-1, 1, 2))
    cv2.fillConvexPoly(mask, hull, 1)
    return mask


def _port_hull_mask(points, shape):
    mask = np.zeros(shape, np.uint8)
    return instance_metrics.fill_convex_poly(
        mask, instance_metrics.convex_hull_points(points))


def test_hull_masks_equal_cv2_on_random_hulls():
    rng = np.random.RandomState(7)
    for _ in range(400):
        h, w = rng.randint(3, 60), rng.randint(3, 80)
        n = rng.randint(1, 15)
        spread = rng.choice([1, 3, 10, 100])
        cx, cy = rng.randint(0, w), rng.randint(0, h)
        pts = np.stack([
            np.clip(cx + rng.randint(-spread, spread + 1, n), 0, w - 1),
            np.clip(cy + rng.randint(-spread, spread + 1, n), 0, h - 1)], 1)
        np.testing.assert_array_equal(_port_hull_mask(pts, (h, w)),
                                      _cv2_hull_mask(pts, (h, w)),
                                      err_msg=str(pts.tolist()))


def test_hull_masks_and_iou_equal_cv2_on_fixture_instances():
    rng = np.random.RandomState(3)
    inst_dir = os.path.join(TRAIN_DIR, 'instance_2_depth_2_multiscale')
    checked = 0
    for name in sorted(os.listdir(inst_dir))[:6]:
        inst = instance_utils.read_instance_image(os.path.join(inst_dir,
                                                               name))
        for idx in np.unique(inst[inst != 255]):
            gt_mask = inst == idx
            rows, cols = np.nonzero(gt_mask)
            pts = np.stack([cols, rows], 1)
            np.testing.assert_array_equal(
                _port_hull_mask(pts, inst.shape),
                _cv2_hull_mask(pts, inst.shape))
            # a projection of the instance's pixels, moved and jittered
            take = rng.choice(len(pts), min(len(pts), 300), replace=False)
            uv = (pts[take].T + rng.normal([[4.0], [-2.0]], 3.0,
                                           (2, len(take))))
            valid = rng.uniform(0, 1, len(take)) > 0.1
            got = instance_metrics.convex_hull_mask_iou(uv, valid, gt_mask,
                                                        inst.shape)
            want = jax_metrics.convex_hull_mask_iou(uv, valid, gt_mask,
                                                    inst.shape)
            assert got == want and 0.0 < got < 1.0
            checked += 1
    assert checked >= 5
    assert instance_metrics.convex_hull_mask_iou(
        np.zeros((2, 2)), np.ones(2), np.zeros((4, 4), bool), (4, 4)) == 0.0


# --------------------------------------------------------------------------
# Geometry: batched corners, numpy crops (mirrors tests/test_geometry.py)
# --------------------------------------------------------------------------

def test_corners_batch_matches_np_and_jax():
    rng = np.random.RandomState(42)
    boxes_3d = np.hstack([
        rng.uniform(-10, 10, (6, 3)), rng.uniform(1, 4, (6, 3)),
        rng.uniform(-np.pi, np.pi, (6, 1))]).astype(np.float32)
    got = boxes.compute_box_3d_corners_batch(torch.from_numpy(boxes_3d))
    assert got.dtype == torch.float32 and got.shape == (6, 3, 8)
    for i in range(6):
        np.testing.assert_allclose(
            got[i].numpy(), boxes.np_compute_box_3d_corners(boxes_3d[i]),
            rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_boxes.compute_box_3d_corners_batch(
            boxes_3d)), rtol=1e-5, atol=1e-5)
    got64 = boxes.compute_box_3d_corners_batch(
        torch.from_numpy(boxes_3d.astype(np.float64)))
    np.testing.assert_allclose(
        got64.numpy(), boxes.np_compute_box_3d_corners_batch(boxes_3d),
        rtol=1e-12, atol=1e-12)


def _scene(rng, n_boxes=4, h=96, w=160):
    depth = np.zeros((h, w), np.float32)
    inst_img = np.full((h, w), 255, np.int32)
    boxes_2d, boxes_3d = [], []
    for i in range(n_boxes):
        y1, x1 = rng.randint(0, h - 30), rng.randint(0, w - 30)
        y2, x2 = y1 + rng.randint(12, 28), x1 + rng.randint(12, 28)
        depth[y1:y2, x1:x2] = rng.uniform(8, 35)
        inst_img[y1:y2, x1:x2] = i
        boxes_2d.append([y1 + 0.3, x1 + 0.2, y2 - 0.4, x2 - 0.1])
        boxes_3d.append([rng.uniform(-5, 5), rng.uniform(0, 2),
                         rng.uniform(10, 30), 4.0, 1.6, 1.5, 0.3])
    cam_p = np.array([[721.5377, 0.0, 609.5593, 44.85728],
                      [0.0, 721.5377, 172.854, 0.2163791],
                      [0.0, 0.0, 1.0, 0.002745884]], np.float32)
    return (depth, inst_img, np.asarray(boxes_2d, np.float32),
            np.asarray(boxes_3d, np.float32), cam_p)


@pytest.mark.parametrize('view_norm,rotate_view,centroid_type', [
    (True, True, 'middle'), (True, False, 'middle'), (False, False, 'middle'),
    (True, True, 'bottom')])
def test_np_instance_crop_equals_jax_and_the_device_crop(
        view_norm, rotate_view, centroid_type):
    rng = np.random.RandomState(42)
    depth, inst_img, boxes_2d, boxes_3d, cam_p = _scene(rng)
    n = len(boxes_2d)
    roi = (48, 48)
    view_angs = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    masks = np.asarray([inst_img == i for i in range(n)])
    args = (boxes_2d, boxes_3d, masks, depth, roi, cam_p, view_angs)
    kwargs = dict(view_norm=view_norm, centroid_type=centroid_type,
                  rotate_view=rotate_view)
    xyz, valid = instance_utils.np_instance_xyz_crop_from_depth_map(
        *args, **kwargs)
    jxyz, jvalid = jax_instance_utils.np_instance_xyz_crop_from_depth_map(
        *args, **kwargs)
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_allclose(xyz, jxyz, rtol=RTOL, atol=1e-12)

    t = torch.from_numpy
    dev_xyz, dev_valid = instance.instance_xyz_crop_from_depth_map(
        t(depth)[None], t(inst_img)[None], t(np.arange(n, dtype=np.int32))[
            None], t(boxes_2d)[None], t(boxes_3d)[None], t(view_angs)[None],
        t(cam_p)[None], roi, **kwargs)
    np.testing.assert_allclose(dev_valid[0].numpy(), valid, atol=1e-6)
    np.testing.assert_allclose(dev_xyz[0].numpy(), xyz, rtol=1e-3,
                               atol=1e-3)


def test_instance_frame_helpers_equal_jax():
    rng = np.random.RandomState(5)
    centroid = rng.uniform(-5, 5, 3)
    points = rng.uniform(-2, 2, (40, 3))
    for fn in ('inst_points_global_to_local', 'inst_points_local_to_global'):
        got = getattr(instance_utils, fn)(points, 0.3, centroid)
        np.testing.assert_allclose(
            got, getattr(jax_instance_utils, fn)(points, 0.3, centroid),
            rtol=RTOL)
    local = instance_utils.inst_points_global_to_local(points, 0.3, centroid)
    np.testing.assert_allclose(instance_utils.inst_points_local_to_global(
        local, 0.3, centroid), points, atol=1e-12)

    pc_map = rng.uniform(-5, 30, (3, 6, 5))
    valid = (rng.uniform(0, 1, (6, 5)) > 0.3).astype(np.float32)
    np.testing.assert_allclose(
        instance_utils.apply_view_norm_to_pc_map(pc_map, valid, 0.2,
                                                 centroid, (6, 5)),
        jax_instance_utils.apply_view_norm_to_pc_map(pc_map, valid, 0.2,
                                                     centroid, (6, 5)),
        rtol=RTOL)

    box_2d = np.array([150.0, 500.0, 210.0, 620.0])
    for kwargs in (dict(centroid_type='middle', class_str='Car'),
                   dict(centroid_type='bottom', class_str='Pedestrian'),
                   dict(centroid_type='bottom', class_str='Car', obj_h=1.4),
                   dict(centroid_type='middle', class_str='Cyclist',
                        trend_data='kitti')):
        np.testing.assert_allclose(
            instance_utils.est_y_from_box_2d_and_depth(CAM_P, box_2d, 22.0,
                                                       **kwargs),
            jax_instance_utils.est_y_from_box_2d_and_depth(
                CAM_P, box_2d, 22.0, **kwargs), rtol=RTOL)
    with pytest.raises(ValueError):
        instance_utils.est_y_from_box_2d_and_depth(CAM_P, box_2d, 22.0,
                                                   'top', class_str='Car')
    for cls in ('Car', 'Pedestrian', 'Cyclist'):
        assert instance_utils.get_prop_cen_z_offset(cls) == \
            jax_instance_utils.get_prop_cen_z_offset(cls)


# --------------------------------------------------------------------------
# crop_and_resize_nearest (mirrors tests/test_crop_resize.py:74-89)
# --------------------------------------------------------------------------

def test_crop_and_resize_nearest_matches_tf_formula_and_jax():
    rng = np.random.RandomState(42)
    image = rng.uniform(1, 9, (30, 50)).astype(np.float32)
    boxes_np = np.array([[3.2, 4.7, 19.8, 29.1],
                         [0.0, 0.0, 30.0, 50.0],
                         [-3.0, -2.0, 40.0, 60.0],
                         [2.5, 3.5, 10.5, 11.5]], np.float32)
    roi = (12, 12)
    got = crop_resize.crop_and_resize_nearest(
        torch.from_numpy(image), torch.from_numpy(boxes_np), roi).numpy()
    for b, box in enumerate(boxes_np[:2]):
        y1, x1, y2, x2 = np.round(box).astype(int)
        ch, cw = max(y2 - y1, 1), max(x2 - x1, 1)
        for i in range(roi[0]):
            for j in range(roi[1]):
                sy = y1 + int(round(i * (ch - 1) / (roi[0] - 1)))
                sx = x1 + int(round(j * (cw - 1) / (roi[1] - 1)))
                assert got[b, i, j] == image[min(sy, 29), min(sx, 49)]
    for img in (image, rng.uniform(0, 9, (30, 50, 3)).astype(np.float32)):
        for size in ((12, 12), (7, 5), (1, 1)):
            np.testing.assert_array_equal(
                crop_resize.crop_and_resize_nearest(
                    torch.from_numpy(img), torch.from_numpy(boxes_np),
                    size).numpy(),
                np.asarray(jax_crop_resize.crop_and_resize_nearest(
                    img, boxes_np, size)))


def test_crop_and_resize_nearest_degenerate_box_single_pixel():
    image = torch.arange(100, dtype=torch.float32).reshape(10, 10)
    boxes_t = torch.tensor([[4.0, 5.0, 4.0, 5.0]])
    got = crop_resize.crop_and_resize_nearest(image, boxes_t, (4, 4))
    assert torch.equal(got[0], torch.full((4, 4), float(image[4, 5])))
