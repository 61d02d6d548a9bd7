"""monopsr_torch.utils.image_io against OpenCV, which the JAX package reads
and resizes with.

- ``read_png`` is bitwise equal to ``cv2.imread`` (with the flags the JAX
  package passes, and BGR -> RGB for colour) on every PNG of the KITTI
  fixture (8-bit RGB images, 16-bit depth maps, 8-bit instance images,
  which between them use all five row filters).
- Synthetic PNGs, one per filter type and pixel format, written with
  zlib here, decode to the pixels they were made from.
- ``resize_bilinear_uint8`` against ``cv2.resize(INTER_LINEAR)``: the
  bound is 1 LSB (the JAX package's own allowance between cv2's two
  INTER_LINEAR paths); each case states its share of differing pixels.
  It writes out OpenCV's fixed-point arithmetic, so the share is 0 here.
- ``write_png`` (8-bit gray, the evaluator's mask PNGs; its 16-bit gray
  form is held in tests/test_torch_data_tools.py): read back by
  ``cv2.imread(IMREAD_GRAYSCALE)`` and by ``read_png``, pixel-equal to
  what was written, at odd sizes and on a fixture instance image.
"""

import glob
import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from monopsr_torch.utils import image_io

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       'datasets/Kitti/object')
PNGS = sorted(glob.glob(os.path.join(FIXTURE, '**', '*.png'),
                        recursive=True))


def test_fixture_has_every_kind():
    kinds = {os.path.basename(os.path.dirname(p)) for p in PNGS}
    assert {'image_2', 'depth_2_multiscale',
            'instance_2_depth_2_multiscale'} <= kinds
    assert len(PNGS) == 49


@pytest.mark.parametrize('kind', ['image_2', 'depth_2_multiscale',
                                  'instance_2_depth_2_multiscale'])
def test_read_png_bitwise_equal_to_cv2(kind):
    paths = [p for p in PNGS if os.path.basename(os.path.dirname(p)) == kind]
    assert paths
    for path in paths:
        got = image_io.read_png(path)
        if kind == 'image_2':
            want = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        elif kind == 'depth_2_multiscale':
            want = cv2.imread(path, cv2.IMREAD_ANYDEPTH)
        else:
            want = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        assert got.dtype == want.dtype, path
        assert got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


def _chunk(kind, body):
    return (struct.pack('>I', len(body)) + kind + body +
            struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _encode(pixels, depth, colour, filters, interlace=0):
    """A PNG of ``pixels`` (rows of bytes per pixel) with the given filter
    type per row, filtered byte by byte as the PNG specification says."""
    h, w = pixels.shape[:2]
    raw = pixels.reshape(h, -1)
    if depth == 16:
        raw = pixels.astype('>u2').view(np.uint8).reshape(h, -1)
    bpp = raw.shape[1] // w
    rows = []
    for r in range(h):
        kind = filters[r % len(filters)]
        out = [kind]
        for i in range(raw.shape[1]):
            x = int(raw[r, i])
            a = int(raw[r, i - bpp]) if i >= bpp else 0
            b = int(raw[r - 1, i]) if r else 0
            c = int(raw[r - 1, i - bpp]) if r and i >= bpp else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][kind]
            out.append((x - pred) % 256)
        rows.append(bytes(out))
    header = struct.pack('>IIBBBBB', w, h, depth, colour, 0, 0, interlace)
    return (b'\x89PNG\r\n\x1a\n' + _chunk(b'IHDR', header) +
            _chunk(b'IDAT', zlib.compress(b''.join(rows))) +
            _chunk(b'IEND', b''))


@pytest.mark.parametrize('filters', [[0], [1], [2], [3], [4],
                                     [4, 0, 3, 1, 2]])
@pytest.mark.parametrize('fmt', ['rgb8', 'gray8', 'gray16'])
def test_synthetic_png_each_filter(tmp_path, filters, fmt):
    rng = np.random.RandomState(len(filters) * 7 + filters[0])
    h, w = 9, 13
    if fmt == 'rgb8':
        pixels, depth, colour = rng.randint(0, 256, (h, w, 3)), 8, 2
    elif fmt == 'gray8':
        pixels, depth, colour = rng.randint(0, 256, (h, w)), 8, 0
    else:
        pixels, depth, colour = rng.randint(0, 65536, (h, w)), 16, 0
    pixels = pixels.astype(np.uint16 if depth == 16 else np.uint8)
    path = str(tmp_path / 'x.png')
    with open(path, 'wb') as f:
        f.write(_encode(pixels, depth, colour, filters))
    got = image_io.read_png(path)
    assert got.dtype == pixels.dtype
    np.testing.assert_array_equal(got, pixels)
    # OpenCV reads the same file to the same pixels
    flag = cv2.IMREAD_COLOR if fmt == 'rgb8' else cv2.IMREAD_UNCHANGED
    want = cv2.imread(path, flag)
    if fmt == 'rgb8':
        want = want[..., ::-1]
    np.testing.assert_array_equal(got, want)


def test_read_png_refuses_what_it_does_not_read(tmp_path):
    with pytest.raises(FileNotFoundError):
        image_io.read_png(str(tmp_path / 'missing.png'))
    good = _encode(np.zeros((2, 3), np.uint8), 8, 0, [0])
    for name, depth, colour, interlace in (('interlaced', 8, 0, 1),
                                           ('palette', 8, 3, 0),
                                           ('gray4', 4, 0, 0),
                                           ('rgba', 8, 6, 0)):
        data = bytearray(good)          # IHDR fields at bytes 24, 25, 28
        data[24], data[25], data[28] = depth, colour, interlace
        path = str(tmp_path / (name + '.png'))
        with open(path, 'wb') as f:
            f.write(bytes(data))
        with pytest.raises(ValueError):
            image_io.read_png(path)
    path = str(tmp_path / 'text.png')
    with open(path, 'wb') as f:
        f.write(b'not a png')
    with pytest.raises(ValueError):
        image_io.read_png(path)


RESIZE_CASES = [
    # the fixture's image sizes to the production input shape
    ((375, 1242, 3), (320, 1216)),
    ((370, 1224, 3), (320, 1216)),
    ((374, 1238, 3), (320, 1216)),
    # odd sizes, up and down, gray and colour
    ((7, 9, 3), (13, 5)),
    ((31, 17), (8, 40)),
    ((100, 100, 3), (37, 251)),
    ((1, 7), (3, 2)),
    ((5, 5, 3), (5, 5)),
]


@pytest.mark.parametrize('src_shape,dst_shape', RESIZE_CASES)
def test_resize_matches_cv2_inter_linear(src_shape, dst_shape):
    rng = np.random.RandomState(sum(src_shape))
    image = rng.randint(0, 256, src_shape).astype(np.uint8)
    want = cv2.resize(image, (dst_shape[1], dst_shape[0]),
                      interpolation=cv2.INTER_LINEAR)
    got = image_io.resize_bilinear_uint8(image, dst_shape)
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    share = float((diff > 0).mean())
    print('resize {} -> {}: max |diff| {}, share of differing pixels '
          '{:.2e}'.format(src_shape, dst_shape, diff.max(), share))
    assert diff.max() <= 1
    assert share == 0.0      # OpenCV's fixed point, written out


def test_resize_of_fixture_images():
    """The fixture's real images, flipped too (a negative-stride view)."""
    for path in [p for p in PNGS if '/image_2/' in p][:4]:
        image = image_io.read_png(path)
        for img in (image, np.fliplr(image)):
            want = cv2.resize(np.ascontiguousarray(img), (1216, 320),
                              interpolation=cv2.INTER_LINEAR)
            np.testing.assert_array_equal(
                image_io.resize_bilinear_uint8(img, (320, 1216)), want)


def test_resize_rejects_other_dtypes():
    """prepare_sample hands every image to the uint8 resize, which
    raises on anything else rather than rounding it silently."""
    with pytest.raises(ValueError, match='uint8'):
        image_io.resize_bilinear_uint8(np.zeros((4, 4, 3), np.float32),
                                       (2, 2))


@pytest.mark.parametrize('shape', [(1, 1), (3, 7), (48, 48), (17, 33),
                                   (375, 1242)])
def test_write_png_reads_back_pixel_equal(tmp_path, shape):
    rng = np.random.RandomState(shape[0] * 1000 + shape[1])
    image = rng.randint(0, 256, shape).astype(np.uint8)
    if shape == (48, 48):
        image = (image > 127).astype(np.uint8) * 255      # a mask
    path = str(tmp_path / 'out.png')
    image_io.write_png(path, image)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_GRAYSCALE),
                                  image)
    np.testing.assert_array_equal(image_io.read_png(path), image)
    # (H, W, 1) as cv2.imwrite takes it
    image_io.write_png(path, image[..., None])
    np.testing.assert_array_equal(image_io.read_png(path), image)


def test_write_png_of_a_fixture_image_and_refusals(tmp_path):
    src = next(p for p in PNGS if 'instance_2' in p)
    image = image_io.read_png(src)
    path = str(tmp_path / 'copy.png')
    image_io.write_png(path, image)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_GRAYSCALE),
                                  cv2.imread(src, cv2.IMREAD_GRAYSCALE))
    # (uint16 is written as 16-bit gray: tests/test_torch_data_tools.py)
    for bad in (np.zeros((4, 4), np.int16), np.zeros((4, 4, 3), np.uint8),
                np.zeros((0, 4), np.uint8)):
        with pytest.raises(ValueError, match='write_png'):
            image_io.write_png(path, bad)
