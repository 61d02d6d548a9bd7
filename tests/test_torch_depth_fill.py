"""monopsr_torch.ops.depth_fill (ip_basic depth completion in torch)
against the JAX package's ``ops/depth_fill.py`` and against cv2's
``tools/ip_basic.py``, on the CPU, on synthetic sparse maps (96 x 256)
and on the fixture's 000002 (375 x 1242).

Bounds, those of tests/test_depth_fill.py, which holds the JAX twin to
cv2:
- morphology and the median: exact (max and min are exact; the median
  is element 12 of the sorted window in all three);
- bilateral: < 2e-4 on smooth values and < 5e-4 on the depth range
  against cv2; against JAX the same bounds (both read cv2's 4096-bin
  table; sums run in another order);
- the pipeline: ``_assert_pipeline_parity`` (|d| < 1e-3 m, at most one
  uint16 LSB, flips on fewer than 0.5% of pixels and only near a
  rounding boundary), against JAX and against cv2.
"""

import cv2
import numpy as np
import pytest
import torch

from monopsr_torch.ops import depth_fill
from monopsr_tpu.ops import depth_fill as jax_depth_fill
from monopsr_tpu.tools import ip_basic

from tests.test_depth_fill import _assert_pipeline_parity, fixture_sparse_map


def sparse_map(seed, h=96, w=256, density=0.06, lo=2.0, hi=60.0):
    """Synthetic sparse depths (all three range bins at the default
    range), drawn with numpy from ``seed``."""
    rng = np.random.RandomState(seed)
    depth = np.zeros((h, w), np.float32)
    num = int(h * w * density)
    ys, xs = rng.randint(0, h, num), rng.randint(0, w, num)
    depth[ys, xs] = rng.uniform(lo, hi, num).astype(np.float32)
    return depth


def run(fn, x, *args):
    return fn(torch.from_numpy(x), *args).numpy()


@pytest.mark.parametrize('k, kernel', [(3, ip_basic.CROSS_KERNEL_3),
                                       (5, ip_basic.CROSS_KERNEL_5),
                                       (7, ip_basic.CROSS_KERNEL_7)])
def test_dilate_cross_matches_jax_and_cv2(k, kernel):
    x = sparse_map(k)
    got = run(depth_fill.dilate_cross, x, k)
    np.testing.assert_array_equal(got, cv2.dilate(x, kernel))
    np.testing.assert_array_equal(
        got, np.asarray(jax_depth_fill.dilate_cross(x, k)))


@pytest.mark.parametrize('k', [5, 9])
def test_full_kernel_morphology_matches_jax_and_cv2(k):
    x = sparse_map(10 + k)
    kernel = np.ones((k, k), np.uint8)
    for name, want in (
            ('dilate_full', cv2.dilate(x, kernel)),
            ('erode_full', cv2.erode(x, kernel)),
            ('close_full', cv2.morphologyEx(x, cv2.MORPH_CLOSE, kernel))):
        got = run(getattr(depth_fill, name), x, k)
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(
            got, np.asarray(getattr(jax_depth_fill, name)(x, k)),
            err_msg=name)


def test_median_matches_jax_and_cv2():
    x = sparse_map(20)
    x[:, :3] = np.linspace(1.0, 50.0, 96)[:, None]       # borders not empty
    got = run(depth_fill.median_5, x)
    np.testing.assert_array_equal(got, cv2.medianBlur(x, 5))
    np.testing.assert_array_equal(got, np.asarray(jax_depth_fill.median_5(x)))


@pytest.mark.parametrize('scale, offset, bound', [(0.1, 1.0, 2e-4),
                                                  (1.0, 0.0, 5e-4)])
def test_bilateral_matches_jax_and_cv2(scale, offset, bound):
    """Smooth values (depths / 10 + 1) and the raw 0..60 m depth range."""
    x = sparse_map(30) * np.float32(scale) + np.float32(offset)
    got = run(depth_fill.bilateral_5, x)
    err_cv2 = np.max(np.abs(got - cv2.bilateralFilter(x, 5, 0.5, 2.0)))
    err_jax = np.max(np.abs(got - np.asarray(jax_depth_fill.bilateral_5(x))))
    print('bilateral: max |d| {:.2e} against cv2, {:.2e} against JAX'.format(
        err_cv2, err_jax))
    assert err_cv2 < bound and err_jax < bound


def test_bilateral_of_a_constant_map_is_a_copy():
    """The early-out for a (near-)constant map, as JAX's; cv2's output
    there is within an ulp of the map."""
    x = np.full((9, 11), 7.25, np.float32)
    got = run(depth_fill.bilateral_5, x)
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(got, np.asarray(
        jax_depth_fill.bilateral_5(x)))
    np.testing.assert_allclose(got, cv2.bilateralFilter(x, 5, 0.5, 2.0),
                               rtol=2.0 ** -23)


@pytest.mark.parametrize('blur_type', ['bilateral', 'gaussian'])
@pytest.mark.parametrize('extrapolate', [False, True])
def test_pipeline_matches_jax_and_host_synthetic(blur_type, extrapolate):
    sparse = sparse_map(40)
    got = depth_fill.fill_in_multiscale(
        sparse, extrapolate=extrapolate, blur_type=blur_type,
        device='cpu').numpy()
    want, _ = ip_basic.fill_in_multiscale(
        sparse, extrapolate=extrapolate, blur_type=blur_type)
    _assert_pipeline_parity(got, want)
    _assert_pipeline_parity(got, np.asarray(jax_depth_fill.fill_in_multiscale(
        sparse, extrapolate=extrapolate, blur_type=blur_type)))


def test_pipeline_matches_jax_and_host_fixture():
    """The fixture's 000002 (375 x 1242), as gen_depth_maps renders it."""
    sparse = fixture_sparse_map()
    got = depth_fill.fill_in_multiscale(sparse, device='cpu').numpy()
    want, _ = ip_basic.fill_in_multiscale(sparse)
    _assert_pipeline_parity(got, want)
    _assert_pipeline_parity(got, np.asarray(
        jax_depth_fill.fill_in_multiscale(sparse)))


def test_empty_columns_and_an_empty_map():
    """Columns with no valid pixel: the first-valid-row search gives row 0
    there (``jnp.argmax`` of an all-False column), as JAX and cv2 fill
    them; a map with no valid pixel at all stays zero."""
    sparse = sparse_map(50)
    sparse[:, 100:140] = 0.0
    sparse[:, :5] = 0.0
    for extrapolate in (False, True):
        got = depth_fill.fill_in_multiscale(
            sparse, extrapolate=extrapolate, device='cpu').numpy()
        want, _ = ip_basic.fill_in_multiscale(sparse, extrapolate=extrapolate)
        _assert_pipeline_parity(got, want)
        _assert_pipeline_parity(got, np.asarray(
            jax_depth_fill.fill_in_multiscale(sparse,
                                              extrapolate=extrapolate)))
    mask = torch.zeros(6, 4, dtype=torch.bool)
    mask[3:, 1] = True
    mask[1, 3] = True
    assert depth_fill._first_true_row(mask).tolist() == [0, 3, 0, 1]
    empty = np.zeros((20, 30), np.float32)
    np.testing.assert_array_equal(depth_fill.fill_in_multiscale(
        empty, device='cpu').numpy(), empty)


def test_batch_matches_single_maps():
    """fill_in_multiscale over a stack of maps of different depth ranges
    equals each map filled alone: each map's bilateral range and table is
    its own (one shared across the stack would move the maps of a smaller
    range)."""
    maps = np.stack([sparse_map(60), sparse_map(61, lo=2.0, hi=20.0),
                     sparse_map(62, lo=30.0, hi=60.0)])
    got = depth_fill.fill_in_multiscale(maps, device='cpu').numpy()
    for i in range(len(maps)):
        single = depth_fill.fill_in_multiscale(maps[i], device='cpu').numpy()
        np.testing.assert_allclose(got[i], single, atol=1e-6)
        _assert_pipeline_parity(got[i], np.asarray(
            jax_depth_fill.fill_in_multiscale(maps[i])))
    x = np.stack([maps[0], maps[1] * np.float32(3.0) + np.float32(1.0)])
    stacked = run(depth_fill.bilateral_5, x)
    for i in range(2):
        np.testing.assert_allclose(stacked[i], run(depth_fill.bilateral_5,
                                                   x[i]), atol=1e-6)


def test_runs_where_the_map_lies(monkeypatch):
    """A CPU tensor stays on the CPU; a numpy map goes to CUDA unless the
    CPU is asked for, and without a card that raises (no quiet fall
    back)."""
    sparse = sparse_map(70, h=24, w=40)
    out = depth_fill.fill_in_multiscale(torch.from_numpy(sparse))
    assert out.device.type == 'cpu' and out.dtype == torch.float32
    np.testing.assert_array_equal(
        out.numpy(), depth_fill.fill_in_multiscale(sparse,
                                                   device='cpu').numpy())
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        depth_fill.fill_in_multiscale(sparse)
    with pytest.raises(RuntimeError, match='CUDA'):
        depth_fill.fill_in_multiscale(torch.from_numpy(sparse),
                                      device='cuda')


@pytest.mark.parametrize('blur_type, extrapolate', [('bilateral', False),
                                                    ('gaussian', True)])
def test_fill_in_batch_matches_jax(blur_type, extrapolate):
    """``fill_in_batch`` against the JAX package's (its vmap of
    fill_in_multiscale) on a stack of three maps of different depth
    ranges, at ``_assert_pipeline_parity``'s bounds; a single map
    raises."""
    maps = np.stack([sparse_map(70), sparse_map(71, lo=2.0, hi=20.0),
                     sparse_map(72, lo=30.0, hi=60.0)])
    got = depth_fill.fill_in_batch(maps, extrapolate=extrapolate,
                                   blur_type=blur_type, device='cpu').numpy()
    want = np.asarray(jax_depth_fill.fill_in_batch(
        maps, extrapolate=extrapolate, blur_type=blur_type))
    assert got.shape == want.shape == maps.shape
    for i in range(len(maps)):
        _assert_pipeline_parity(got[i], want[i])
    with pytest.raises(ValueError, match=r'\(B, H, W\)'):
        depth_fill.fill_in_batch(maps[0], device='cpu')
