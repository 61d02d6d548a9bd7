"""monopsr_torch.geometry against the JAX package's device geometry.

The port's instance and projection functions take a leading image axis
B; each is compared with the JAX function vmapped over images (or, where
the JAX function already broadcasts, called directly) on numpy-seeded
inputs of two images.

Tolerance: the same float32 formulas, with matmul/einsum and
trigonometric library calls that may round differently by an ulp:
rtol 1e-5 with atol 1e-5 * max|x| (1e-4 * max|x| after a projection's
divide). The GT instance crop gathers exactly and is compared exactly
where it selects (mask, valid pixels, depths).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monopsr_tpu.geometry import feature_normalization as jax_fn
from monopsr_tpu.geometry import instance as jax_instance
from monopsr_tpu.geometry import projection as jax_projection
from monopsr_tpu.geometry import transforms as jax_transforms
from monopsr_torch.eval import evaluator
from monopsr_torch.geometry import (feature_normalization, instance,
                                    projection, transforms)

import torch_parity as tp

B = 2


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, frac=1e-5, rtol=1e-5):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=frac * max(1.0, float(np.abs(want).max(initial=0.0))))


@pytest.fixture(scope='module')
def batch():
    jcfg, _ = tp.configs(num_boxes=6)
    rng = np.random.RandomState(11)
    samples = [tp.make_sample(rng, jcfg, depth_shape=(104, 330))
               for _ in range(B)]
    out = evaluator.stack_samples(samples)
    out['depth_f'] = out[tp.C.SAMPLE_DEPTH_MAP].astype(np.float32) / 256.0
    out['inst_i'] = out[tp.kd.SAMPLE_INSTANCE_IMAGE].astype(np.int32)
    return out


def _args(batch):
    C, kd = tp.C, tp.kd
    return (batch['depth_f'], batch['inst_i'],
            batch[kd.SAMPLE_INSTANCE_INDICES], batch[C.SAMPLE_LABEL_BOXES_2D],
            batch[C.SAMPLE_LABEL_BOXES_3D], batch[C.SAMPLE_VIEWING_ANGLES_2D],
            batch[C.SAMPLE_CAM_P])


@pytest.mark.parametrize('view_norm,centroid_type,rotate_view', [
    (True, 'middle', True), (True, 'bottom', False), (False, 'middle', True)])
def test_instance_xyz_crop_matches_jax(batch, view_norm, centroid_type,
                                       rotate_view):
    args = _args(batch)
    want_xyz, want_valid = jax.vmap(
        lambda *a: jax_instance.instance_xyz_crop_from_depth_map(
            *a, (48, 48), view_norm, centroid_type, rotate_view))(*args)
    got_xyz, got_valid = instance.instance_xyz_crop_from_depth_map(
        *[_t(a) for a in args], (48, 48), view_norm, centroid_type,
        rotate_view)
    # Selection is exact: same valid pixels, and enough of them to matter
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    assert float(got_valid.mean()) > 0.1
    _close(got_xyz, want_xyz)


def test_local_global_maps_and_proj_err_match_jax(batch):
    C = tp.C
    rng = np.random.RandomState(12)
    n = batch[C.SAMPLE_LABEL_BOXES_2D].shape[1]
    local = rng.normal(0, 1, (B, n, 48, 48, 3)).astype(np.float32)
    view = rng.uniform(-0.6, 0.6, (B, n, 1)).astype(np.float32)
    cen = np.stack([rng.uniform(-5, 5, (B, n)), rng.uniform(0, 2, (B, n)),
                    rng.uniform(10, 40, (B, n))], -1).astype(np.float32)
    boxes = batch[C.SAMPLE_LABEL_BOXES_2D]
    cam = batch[C.SAMPLE_CAM_P]
    valid = (rng.uniform(size=(B, n, 48, 48, 1)) < 0.7).astype(np.float32)

    want_global = jax.vmap(jax_instance.inst_xyz_map_local_to_global)(
        local, view, cen)
    got_global = instance.inst_xyz_map_local_to_global(
        _t(local), _t(view), _t(cen))
    _close(got_global, want_global)

    want_err = jax.vmap(lambda g, b, v, c: jax_instance.proj_err_maps_norm(
        g, b, v, c, (48, 48)))(want_global, boxes, valid, cam)
    got_err = instance.proj_err_maps_norm(
        _t(want_global), _t(boxes), _t(valid), _t(cam), (48, 48))
    _close(got_err, want_err, frac=1e-4)

    for rotate_view in (True, False):
        want_depth = jax.vmap(
            lambda d, z, b, v, c: jax_instance.inst_depth_map_local_to_global(
                d, z, b, v, (48, 48), c, rotate_view))(
                    local[..., 2:3], cen[..., 2:3], boxes, view, cam)
        got_depth = instance.inst_depth_map_local_to_global(
            _t(local[..., 2:3]), _t(cen[..., 2:3]), _t(boxes), _t(view),
            (48, 48), _t(cam), rotate_view)
        _close(got_depth, want_depth)


def test_centroid_estimates_match_jax(batch):
    C = tp.C
    rng = np.random.RandomState(13)
    boxes, cam = batch[C.SAMPLE_LABEL_BOXES_2D], batch[C.SAMPLE_CAM_P]
    n = boxes.shape[1]
    depth = rng.uniform(5, 40, (B, n, 1)).astype(np.float32)
    offs = rng.uniform(0, 0.1, (B, n)).astype(np.float32)
    heights = rng.uniform(1, 2, (B, n)).astype(np.float32)
    _close(instance.est_y_from_box_2d_and_depth(
        _t(cam), _t(boxes), _t(depth), _t(offs)),
        jax.vmap(jax_instance.est_y_from_box_2d_and_depth)(
            cam, boxes, depth, offs))
    _close(instance.prop_cen_z_from_box_height(
        _t(cam), _t(boxes), _t(heights), _t(offs)),
        jax.vmap(jax_instance.prop_cen_z_from_box_height)(
            cam, boxes, heights, offs))


def test_projection_matches_jax(batch):
    C = tp.C
    rng = np.random.RandomState(14)
    boxes, cam = batch[C.SAMPLE_LABEL_BOXES_2D], batch[C.SAMPLE_CAM_P]
    n = boxes.shape[1]
    # Points including z ~ 0 (sign-preserving clamp) and negative z
    pc = rng.normal(0, 3, (n, 3, 50)).astype(np.float32)
    pc[:, 2, :10] = rng.uniform(-1e-4, 1e-4, (n, 10))
    pc[:, 2, 10:20] *= -1
    _close(projection.project_pc_to_image_batch(_t(pc), _t(cam[0])),
           jax_projection.project_pc_to_image_batch(pc, cam[0]), frac=1e-4)

    patches = rng.uniform(0, 40, (B, n, 48, 48)).astype(np.float32)
    for centres in (True, False):
        want = jax.vmap(lambda p, b, c: jax_projection.depth_patch_to_pc_map_batch(
            p, b, c, (48, 48), centres))(patches, boxes, cam)
        got = projection.depth_patch_to_pc_map_batch(
            _t(patches), _t(boxes), _t(cam), (48, 48), centres)
        _close(got, want)
        for round_box in (True, False):
            _close(projection.get_exp_proj_uv_map_batch(
                _t(boxes), (48, 40), round_box, centres),
                jax_projection.get_exp_proj_uv_map_batch(
                    boxes.reshape(-1, 4), (48, 40),
                    round_box, centres).reshape(B, n, 48, 40, 2))


def test_transforms_match_jax():
    rng = np.random.RandomState(15)
    ry = rng.uniform(-3, 3, 5).astype(np.float32)
    t = rng.normal(0, 5, (5, 3)).astype(np.float32)
    for got, want in zip(transforms.get_tr_mat_batch(_t(ry), _t(t)),
                         jax_transforms.get_tr_mat_batch(ry, t)):
        _close(got, want)
    pc = rng.normal(0, 1, (5, 3, 7)).astype(np.float32)
    _close(transforms.pad_pc_batch(_t(pc)), jax_transforms.pad_pc_batch(pc))
    pts = rng.normal(0, 1, (5, 9, 3)).astype(np.float32)
    _close(transforms.rotate_y_batch(_t(pts), _t(ry)),
           jax_transforms.rotate_y_batch(pts, ry))


def test_feature_normalization_matches_jax():
    rng = np.random.RandomState(16)
    classes = ('Car', 'Pedestrian', 'Cyclist')
    idx = rng.randint(0, 4, (8, 1)).astype(np.int32)
    vals = rng.uniform(0.5, 40, (8, 1)).astype(np.float32)
    for name in ('normalize_cen_y_by_mean', 'normalize_cen_z_by_mean',
                 'normalize_box_height_by_mean'):
        _close(getattr(feature_normalization, name)(_t(vals), _t(idx), classes),
               getattr(jax_fn, name)(jnp.asarray(vals), jnp.asarray(idx),
                                     classes))


def test_orientation_tensor_functions_match_jax():
    """The torch decode of (bin, residual) and the angle-vector
    conversions against the JAX package's jnp functions, float32, on
    numpy-seeded inputs that cross both wrap-arounds of the decode: rtol
    1e-6 (atan2, sin and cos may differ by an ulp), atol 1e-6."""
    from monopsr_tpu.geometry import orientation as jax_orientation
    from monopsr_torch.geometry import orientation
    rng = np.random.RandomState(21)
    bins = rng.randint(0, 12, 64).astype(np.float32)
    residual = rng.uniform(-4.0, 4.0, 64).astype(np.float32)
    angles = rng.uniform(-np.pi, np.pi, 64).astype(np.float32)
    vectors = rng.randn(64, 2).astype(np.float32)
    pairs = [
        (orientation.angle_bin_to_orientation(
            torch.from_numpy(bins), torch.from_numpy(residual), 12),
         jax_orientation.angle_bin_to_orientation(bins, residual, 12)),
        (orientation.angle_vector_to_orientation(torch.from_numpy(vectors)),
         jax_orientation.angle_vector_to_orientation(vectors)),
        (orientation.orientation_to_angle_vector(torch.from_numpy(angles)),
         jax_orientation.orientation_to_angle_vector(angles)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    decoded = pairs[0][0].numpy()
    assert decoded.min() >= -np.pi and decoded.max() <= np.pi
    assert (bins * (2 * np.pi / 12) + residual > np.pi).any()
