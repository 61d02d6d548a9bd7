"""PNG decoding and encoding and bilinear resizing without cv2, PIL or
imageio.

Stands in for the JAX package's ``cv2.imread`` calls (the KITTI RGB
image, the 16-bit depth and disparity maps, the 8-bit instance image),
for the ``cv2.imwrite`` of the predicted mask PNGs, the instance images
and the depth maps (``write_png``, 8-bit and 16-bit gray; ``png_shape``
reads an image's size from its header) and for the
``cv2.resize(INTER_LINEAR)`` of ``trainer.prepare_sample``.

As cv2 does for the JAX package's loader threads, the per-byte work runs
in compiled code outside the interpreter lock: ``read_png`` inflates
with ``zlib`` and undoes the row filters in ``csrc/image_host.cpp``
(``png_unfilter``), and ``resize_bilinear_uint8`` runs its two integer
passes there (``resize_linear_u8``). The library is built by g++ at
first use (``ops/cuda_build``, ``HOST_SOURCES``) and loaded with
``ctypes.CDLL``, which releases the lock for each call; a failed build
raises. ``read_png_plain`` and ``resize_bilinear_uint8_plain`` are the
plain numpy versions of the same functions, which the tests hold the
library to bit for bit.

``_unfilter_plain`` undoes the five PNG row filters with a wavefront:
pixel x of row r is decoded at step r + x, so each step takes one pixel
of every row at once, the rows' own filter types picked per row. Its
left, upper and upper-left neighbours were decoded at earlier steps,
which is what the Sub, Average and Paeth filters need. That is w + h - 1
vectorised steps per image instead of a Python loop over every byte.

The resize writes out OpenCV's fixed-point INTER_LINEAR for 8-bit
images: half-pixel centres, edge taps clamped, 11-bit weights rounded
from float32 offsets, and the vertical pass's shifts
(``VResizeLinear<uchar, ...>`` in OpenCV's resize.cpp).
"""

import ctypes
import struct
import zlib

import numpy as np

from monopsr_torch.ops import cuda_build

_SIGNATURE = b'\x89PNG\r\n\x1a\n'

# PNG colour types this reader takes: gray (0) and RGB (2)
_CHANNELS = {0: 1, 2: 3}

_COEF_BITS = 11                    # OpenCV's INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS


def _chunks(data, path):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b'IEND':
            return
    raise ValueError('PNG without IEND chunk: ' + path)


def read_png(path):
    """Decodes a non-interlaced 8-bit gray, 8-bit RGB or 16-bit gray PNG,
    its row filters undone by the host library (``png_unfilter``).

    Returns:
        (H, W) uint8 or uint16 for gray files, (H, W, 3) uint8 in RGB
        order for colour files (what ``cv2.imread`` followed by
        ``COLOR_BGR2RGB`` gives; 16-bit samples are big-endian on disk).

    Raises:
        FileNotFoundError: no file at ``path``.
        ValueError: not a PNG, or a palette, alpha, interlaced or
            other-depth file.
        RuntimeError: the host library failed to build.
    """
    return _read_png(path, _unfilter)


def read_png_plain(path):
    """``read_png`` with the row filters undone in numpy
    (``_unfilter_plain``): the plain version the library is held to."""
    return _read_png(path, _unfilter_plain)


def _read_png(path, unfilter):
    with open(path, 'rb') as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError('Not a PNG file: ' + path)
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
    if header is None:
        raise ValueError('PNG without IHDR chunk: ' + path)
    width, height, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS or depth not in (8, 16) or (
            colour == 2 and depth != 8):
        raise ValueError('Unsupported PNG (colour type {}, bit depth {}): {}'
                         .format(colour, depth, path))
    if interlace:
        raise ValueError('Interlaced PNG not supported: ' + path)
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8                # bytes per pixel
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    if raw.size != height * (1 + width * bpp):
        raise ValueError('PNG data size does not match its header: ' + path)
    raw = raw.reshape(height, 1 + width * bpp)
    if raw[:, 0].max(initial=0) > 4:
        raise ValueError('Invalid PNG filter type: ' + path)
    pixels = unfilter(raw, width, bpp)
    if depth == 16:
        pixels = pixels.reshape(height, width * 2).view('>u2').astype(
            np.uint16)
    return pixels.reshape((height, width) if channels == 1
                          else (height, width, channels))


def png_shape(path):
    """(height, width) from a PNG's IHDR chunk, without decoding it."""
    with open(path, 'rb') as f:
        head = f.read(len(_SIGNATURE) + 16)
    if not head.startswith(_SIGNATURE) or head[12:16] != b'IHDR':
        raise ValueError('Not a PNG file with an IHDR chunk first: ' + path)
    width, height = struct.unpack('>II', head[16:24])
    return height, width


def _chunk(kind, body):
    return (struct.pack('>I', len(body)) + kind + body +
            struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path, image):
    """Writes an (H, W) or (H, W, 1) uint8 or uint16 array as an 8-bit or
    16-bit gray PNG (16-bit samples big-endian): one IDAT chunk of
    zlib-compressed rows, each with filter type 0 (None). The pixels are
    what ``cv2.imwrite`` stores; the bytes need not be, since the
    compression level and filters differ."""
    image = np.asarray(image)
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[..., 0]
    if image.ndim != 2 or image.dtype not in (np.uint8, np.uint16):
        raise ValueError('write_png takes an (H, W) uint8 or uint16 image, '
                         'got {} {}'.format(image.shape, image.dtype))
    height, width = image.shape
    if height < 1 or width < 1:
        raise ValueError('write_png takes a non-empty image, got {}'.format(
            image.shape))
    samples = image.astype(image.dtype.newbyteorder('>')).view(np.uint8)
    rows = np.zeros((height, samples.shape[1] + 1), np.uint8)
    rows[:, 1:] = samples
    header = struct.pack('>IIBBBBB', width, height, 8 * image.itemsize, 0,
                         0, 0, 0)
    data = (_SIGNATURE + _chunk(b'IHDR', header) +
            _chunk(b'IDAT', zlib.compress(rows.tobytes(), 6)) +
            _chunk(b'IEND', b''))
    with open(path, 'wb') as f:
        f.write(data)


def _host_function(name, argtypes):
    fn = getattr(cuda_build.load('image_host'), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
    return fn


_POINTER, _INT64 = ctypes.c_void_p, ctypes.c_int64


def _unfilter(raw, width, bpp):
    """(H, W, bpp) bytes from (H, 1 + W * bpp) inflated rows (each a
    filter type, then its filtered bytes), by the host library."""
    raw = np.ascontiguousarray(raw)
    height = raw.shape[0]
    out = np.empty((height, width, bpp), np.uint8)
    fn = _host_function('png_unfilter', (_POINTER, _POINTER, _INT64,
                                         _INT64, _INT64))
    if fn(raw.ctypes.data, out.ctypes.data, height, width * bpp, bpp):
        raise ValueError('Invalid PNG filter type')
    return out


def _unfilter_plain(raw, width, bpp):
    """``_unfilter`` in numpy: reconstructs (H, W, bpp) bytes from their
    filtered form.

    Rows filtered by None (0) or Sub (1) do not read the row above: when
    every row is one of those, each Sub row is a running sum mod 256 of
    its own bytes. Otherwise the rows go through one wavefront: step s
    decodes pixel s - r of every row r, in a skewed copy ``out`` where
    out[s + 1, r + 1] holds pixel (r, s - r), so that the left, upper and
    upper-left neighbours of step s are the contiguous slices
    out[s, r + 1], out[s, r] and out[s - 1, r]. Entries never written stay
    zero: the neighbours left of column 0 and above row 0, as the PNG
    filters define them."""
    filters = raw[:, 0]
    filtered = raw[:, 1:].reshape(raw.shape[0], width, bpp)
    h, w = filtered.shape[:2]
    if filters.max(initial=0) <= 1:
        sub = filters == 1
        out = filtered.copy()
        out[sub] = np.cumsum(filtered[sub], axis=1, dtype=np.uint8)
        return out
    rows, cols = np.indices((h, w))
    data = np.zeros((h + w - 1, h, bpp), np.int16)
    data[rows + cols, rows] = filtered
    out = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    kind = filters[:, None]
    # None, Sub, Up and Average predict (wa * a + wb * b) >> shift
    wa = ((kind == 1) | (kind == 3)).astype(np.int16)
    wb = ((kind == 2) | (kind == 3)).astype(np.int16)
    shift = (kind == 3).astype(np.int16)
    is_paeth = kind == 4
    for s in range(h + w - 1):
        lo, hi = max(0, s - w + 1), min(h, s + 1)     # rows with a pixel s - r
        a = out[s, lo + 1:hi + 1]                      # left
        b = out[s, lo:hi]                              # up
        c = out[s - 1, lo:hi]                          # upper left (s = 0:
        bc, ac = b - c, a - c                          # the zero last row)
        pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(is_paeth[lo:hi], paeth,
                        (wa[lo:hi] * a + wb[lo:hi] * b) >> shift[lo:hi])
        out[s + 1, lo + 1:hi + 1] = (data[s, lo:hi] + pred) & 0xFF
    return out[rows + cols + 1, rows + 1].astype(np.uint8)


def _linear_taps(src, dst):
    """Per output index along one axis: the two source indices and their
    float32 weights, as OpenCV computes them for INTER_LINEAR: centre
    (d + 0.5) * scale - 0.5 rounded to float32, floored to the first tap;
    left of the image both weight on index 0; at or past the last index
    the first weight is 1 on index src - 1."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    frac = (f - i0.astype(np.float32)).astype(np.float32)
    return i0, frac


def _clamped(idx, size):
    return np.clip(idx, 0, size - 1)


def _resize_taps(src_shape, dst_shape):
    """(x0, x1, ax0, ax1, y0, y1, by0, by1): per output column the two
    source columns and their 11-bit weights, per output row the two
    source rows and theirs (int64 indices clamped into the image, int32
    weights), as ``resize_bilinear_uint8`` states them."""
    sh, sw = src_shape
    dh, dw = dst_shape
    x0, fx = _linear_taps(sw, dw)
    left, right = x0 < 0, x0 >= sw - 1
    fx[left | right] = 0.0
    x0 = _clamped(x0, sw)
    x1 = _clamped(x0 + 1, sw)
    ax0 = np.rint((np.float32(1.0) - fx) * _COEF_SCALE).astype(np.int32)
    ax1 = np.rint(fx * _COEF_SCALE).astype(np.int32)

    y0, fy = _linear_taps(sh, dh)
    by0 = np.rint((np.float32(1.0) - fy) * _COEF_SCALE).astype(np.int32)
    by1 = np.rint(fy * _COEF_SCALE).astype(np.int32)
    y1 = _clamped(y0 + 1, sh)
    y0 = _clamped(y0, sh)
    return x0, x1, ax0, ax1, y0, y1, by0, by1


def _checked_uint8(image, shape):
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError('resize_bilinear_uint8 takes uint8, got {}'.format(
            image.dtype))
    return image, (int(shape[0]), int(shape[1]))


def resize_bilinear_uint8(image, shape):
    """Resizes an (H, W) or (H, W, C) uint8 image to ``shape`` = (h, w)
    with OpenCV's INTER_LINEAR fixed-point arithmetic, in the host
    library (``resize_linear_u8``).

    Horizontal pass: S[x0] * a0 + S[x1] * a1 in integers, with a = the
    float32 weights times 2048 rounded to nearest even (x clamped: left of
    the image and at its last column the weights become (2048, 0)).
    Vertical pass: ((b0 * (R0 >> 4)) >> 16) + ((b1 * (R1 >> 4)) >> 16),
    then (+ 2) >> 2, with rows clamped into the image and b rounded as a.
    """
    image, (dh, dw) = _checked_uint8(image, shape)
    src = np.ascontiguousarray(image)
    sh, sw = src.shape[:2]
    channels = src.shape[2] if src.ndim == 3 else 1
    taps = [np.ascontiguousarray(t) for t in
            _resize_taps((sh, sw), (dh, dw))]
    out = np.empty((dh, dw) + src.shape[2:], np.uint8)
    fn = _host_function('resize_linear_u8', (
        _POINTER, _INT64, _INT64, _INT64, _POINTER, _INT64, _INT64) +
        (_POINTER,) * 8)
    fn(src.ctypes.data, sh, sw, channels, out.ctypes.data, dh, dw,
       *[t.ctypes.data for t in taps])
    return out


def resize_bilinear_uint8_plain(image, shape):
    """``resize_bilinear_uint8`` in numpy: the plain version the library
    is held to."""
    image, (dh, dw) = _checked_uint8(image, shape)
    x0, x1, ax0, ax1, y0, y1, by0, by1 = _resize_taps(image.shape[:2],
                                                      (dh, dw))
    src = image.astype(np.int32)
    extra = (None,) * (image.ndim - 2)
    rows = (src[:, x0] * ax0[(slice(None),) + extra] +
            src[:, x1] * ax1[(slice(None),) + extra])      # (sh, dw, ...)
    by0 = by0[(slice(None), None) + extra]
    by1 = by1[(slice(None), None) + extra]
    out = (((by0 * (rows[y0] >> 4)) >> 16) +
           ((by1 * (rows[y1] >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)
