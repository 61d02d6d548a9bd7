"""The host image library (csrc/image_host.cpp, built by g++) behind
monopsr_torch.utils.image_io, against the plain numpy versions and OpenCV,
which the JAX package decodes and resizes with.

- ``read_png`` (the library's ``png_unfilter``) is bitwise equal to
  ``read_png_plain`` and to ``cv2.imread(IMREAD_UNCHANGED)`` (RGB order)
  on every PNG of the KITTI fixture, and on seeded PNGs written here with
  a forced filter per row: each of the five filters and mixed rows, 8-bit
  gray, RGB and 16-bit gray, width 1, height 1 and odd widths.
- ``resize_bilinear_uint8`` (``resize_linear_u8``) is bitwise equal to
  ``resize_bilinear_uint8_plain`` and to ``cv2.resize(INTER_LINEAR)``,
  gray and RGB, at the production shape, upscaled and to 1-pixel targets.
- The library is loaded with ``ctypes.CDLL`` (which releases the
  interpreter lock for each call), the loader's main path never reaches
  the plain versions, a broken source raises with g++'s output instead
  of falling back, and two processes building at once both load it.
- The loader's seeded batches are the same at 1 and 4 threads, whose
  decodes and resizes now run in the library at the same time.
"""

import ctypes
import glob
import os
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest

from monopsr_torch.ops import cuda_build
from monopsr_torch.utils import image_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, 'tests', 'datasets', 'Kitti', 'object')
PNGS = sorted(glob.glob(os.path.join(FIXTURE, '**', '*.png'),
                        recursive=True))


def _cv2_read(path):
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return want[..., ::-1] if want.ndim == 3 else want


def test_fixture_holds_49_pngs():
    assert len(PNGS) == 49


@pytest.mark.parametrize('path', PNGS,
                         ids=[os.path.relpath(p, FIXTURE) for p in PNGS])
def test_fixture_png_bitwise_equal_to_plain_and_cv2(path):
    got = image_io.read_png(path)
    for want in (image_io.read_png_plain(path), _cv2_read(path)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _chunk(kind, body):
    return (struct.pack('>I', len(body)) + kind + body +
            struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _encode(pixels, depth, colour, row_filters):
    """A PNG of ``pixels``, row r filtered by row_filters[r], byte by byte
    as the PNG specification says."""
    h, w = pixels.shape[:2]
    raw = (pixels.astype('>u2').view(np.uint8) if depth == 16
           else pixels).reshape(h, -1)
    bpp = raw.shape[1] // w
    rows = []
    for r in range(h):
        kind = int(row_filters[r])
        out = [kind]
        for i in range(raw.shape[1]):
            a = int(raw[r, i - bpp]) if i >= bpp else 0
            b = int(raw[r - 1, i]) if r else 0
            c = int(raw[r - 1, i - bpp]) if r and i >= bpp else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][kind]
            out.append((int(raw[r, i]) - pred) % 256)
        rows.append(bytes(out))
    header = struct.pack('>IIBBBBB', w, h, depth, colour, 0, 0, 0)
    return (b'\x89PNG\r\n\x1a\n' + _chunk(b'IHDR', header) +
            _chunk(b'IDAT', zlib.compress(b''.join(rows))) +
            _chunk(b'IEND', b''))


FILTERS = ['none', 'sub', 'up', 'average', 'paeth', 'mixed']
FORMATS = {'gray8': (8, 0, 1), 'rgb8': (8, 2, 3), 'gray16': (16, 0, 1)}
SIZES = [(1, 1), (1, 9), (7, 1), (6, 13)]


@pytest.mark.parametrize('size', SIZES, ids=['{}x{}'.format(*s)
                                             for s in SIZES])
@pytest.mark.parametrize('fmt', list(FORMATS))
@pytest.mark.parametrize('filters', FILTERS)
def test_synthetic_png_bitwise_equal(tmp_path, filters, fmt, size):
    depth, colour, channels = FORMATS[fmt]
    h, w = size
    rng = np.random.RandomState(1000 * FILTERS.index(filters) +
                                10 * list(FORMATS).index(fmt) +
                                SIZES.index(size))
    shape = (h, w, channels) if channels > 1 else (h, w)
    pixels = rng.randint(0, 1 << depth, shape).astype(
        np.uint16 if depth == 16 else np.uint8)
    if filters == 'mixed':
        row_filters = rng.randint(0, 5, h)
    else:
        row_filters = [FILTERS.index(filters)] * h
    path = str(tmp_path / 'x.png')
    with open(path, 'wb') as f:
        f.write(_encode(pixels, depth, colour, row_filters))
    got = image_io.read_png(path)
    assert got.dtype == pixels.dtype and got.shape == pixels.shape
    np.testing.assert_array_equal(got, pixels)
    np.testing.assert_array_equal(got, image_io.read_png_plain(path))
    np.testing.assert_array_equal(got, _cv2_read(path))


RESIZE_CASES = [
    ((375, 1242), (320, 1216)),      # the production input shape
    ((370, 1224), (320, 1216)),
    ((37, 61), (96, 200)),           # upscaled
    ((29, 30), (1, 1)),              # 1-pixel targets
    ((29, 30), (1, 17)),
    ((1, 30), (13, 1)),
]


@pytest.mark.parametrize('src_shape,dst_shape', RESIZE_CASES)
@pytest.mark.parametrize('channels', [1, 3], ids=['gray', 'rgb'])
def test_resize_bitwise_equal_to_plain_and_cv2(src_shape, dst_shape,
                                               channels):
    rng = np.random.RandomState(sum(src_shape) + 7 * channels)
    shape = src_shape + ((channels,) if channels > 1 else ())
    image = rng.randint(0, 256, shape).astype(np.uint8)
    got = image_io.resize_bilinear_uint8(image, dst_shape)
    assert got.dtype == np.uint8 and got.shape == dst_shape + shape[2:]
    np.testing.assert_array_equal(
        got, image_io.resize_bilinear_uint8_plain(image, dst_shape))
    np.testing.assert_array_equal(
        got, cv2.resize(image, (dst_shape[1], dst_shape[0]),
                        interpolation=cv2.INTER_LINEAR))


def test_resize_of_a_strided_view():
    """A negative-stride view (a flipped image) is read as its values."""
    image = image_io.read_png(next(p for p in PNGS if '/image_2/' in p))
    flipped = np.fliplr(image)
    np.testing.assert_array_equal(
        image_io.resize_bilinear_uint8(flipped, (320, 1216)),
        image_io.resize_bilinear_uint8_plain(flipped, (320, 1216)))


def test_library_is_a_cdll_that_releases_the_lock():
    """ctypes.CDLL calls run with the interpreter lock released; a PyDLL
    (a CDLL subclass) would hold it."""
    lib = cuda_build.load('image_host')
    assert isinstance(lib, ctypes.CDLL) and not isinstance(lib, ctypes.PyDLL)
    assert not lib._func_flags_ & ctypes._FUNCFLAG_PYTHONAPI
    assert os.path.dirname(cuda_build.library_path('image_host')) == \
        cuda_build.HOST_BUILD_DIR
    assert '-ffast-math' not in cuda_build.HOST_FLAGS


def test_loader_main_path_takes_the_library(monkeypatch):
    """A sample's decode and prepare_sample reach neither plain version."""
    from monopsr_torch import config as config_lib
    from monopsr_torch.datasets.kitti.kitti_dataset import KittiDataset
    from monopsr_torch.train import trainer

    def refuse(*args, **kwargs):
        raise AssertionError('the main path reached a plain version')
    monkeypatch.setattr(image_io, '_unfilter_plain', refuse)
    monkeypatch.setattr(image_io, 'resize_bilinear_uint8_plain', refuse)
    dataset = KittiDataset(_dataset_config(config_lib), 'train')
    sample = next(s for s in dataset.get_sample_dict(range(3)) if s)
    out = trainer.prepare_sample(sample, (96, 320))
    assert out['image'].shape == (96, 320, 3)


def test_broken_source_raises_with_gxx_output(tmp_path, monkeypatch):
    broken = tmp_path / 'image_host.cpp'
    with open(cuda_build.source_path('image_host')) as f:
        broken.write_text(f.read() + '\nthis is not C++;\n')
    monkeypatch.setattr(cuda_build, 'HOST_SOURCES',
                        {'image_host': str(broken)})
    monkeypatch.setattr(cuda_build, 'HOST_BUILD_DIR', str(tmp_path / 'b'))
    monkeypatch.setattr(cuda_build, '_LOADED', {})
    path = next(p for p in PNGS if '/depth_2_multiscale/' in p)
    for call in (lambda: image_io.read_png(path),
                 lambda: image_io.resize_bilinear_uint8(
                     np.zeros((4, 4), np.uint8), (2, 2))):
        with pytest.raises(RuntimeError, match='g\\+\\+ exit') as info:
            call()
        assert 'this is not C++' in str(info.value)   # g++'s diagnostic
    assert not glob.glob(str(tmp_path / 'b' / '*.so'))


_BUILD_AND_DECODE = r"""
import os, sys, time
sys.path.insert(0, {repo!r})
from monopsr_torch.ops import cuda_build
from monopsr_torch.utils import image_io
cuda_build.HOST_BUILD_DIR = {build_dir!r}
ready = os.path.join({sync!r}, 'ready')
open(ready + sys.argv[1], 'w').close()
deadline = time.time() + 60
while not all(os.path.exists(ready + i) for i in '01'):
    assert time.time() < deadline
    time.sleep(0.01)
got = image_io.read_png({png!r})
print(got.shape, int(got.sum()))
"""


def test_two_processes_build_at_once(tmp_path):
    """Both build into one empty directory at the same time (each under
    its own temporary name, renamed into place) and both load."""
    build_dir, sync = tmp_path / 'build', tmp_path / 'sync'
    sync.mkdir()
    png = next(p for p in PNGS if '/depth_2_multiscale/' in p)
    script = _BUILD_AND_DECODE.format(repo=REPO, build_dir=str(build_dir),
                                      sync=str(sync), png=png)
    procs = [subprocess.Popen([sys.executable, '-c', script, str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for proc, (out, err) in zip(procs, outs):
        assert proc.returncode == 0, err
    want = image_io.read_png_plain(png)
    assert {o for o, _ in outs} == {'{} {}\n'.format(want.shape,
                                                     int(want.sum()))}
    assert [os.path.basename(p) for p in glob.glob(str(build_dir / '*'))
            if not p.endswith('.log')] == [
        os.path.basename(cuda_build.library_path('image_host'))]


def _dataset_config(config_lib):
    cfg = config_lib.parse_yaml_config(
        os.path.join(REPO, 'configs', 'monopsr_model_000.yaml'))
    dataset_config = cfg.dataset_config
    dataset_config.dataset_dir = FIXTURE
    dataset_config.mscnn_dir = os.path.join(FIXTURE, 'mscnn')
    dataset_config.seed = 3
    return dataset_config


def test_seeded_loader_batches_equal_at_1_and_4_threads():
    from monopsr_torch import config as config_lib
    from monopsr_torch.datasets.kitti.kitti_dataset import KittiDataset
    from monopsr_torch.train.input_pipeline import PrefetchingLoader

    def batches(threads):
        loader = PrefetchingLoader(
            KittiDataset(_dataset_config(config_lib), 'train'), 1, (48, 160),
            num_threads=threads)
        try:
            return [loader.get_batch() for _ in range(8)]
        finally:
            loader.stop()

    one, four = batches(1), batches(4)
    for a, b in zip(one, four):
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]), err_msg=key)
