"""A PNG writer in numpy and zlib: per-row adaptive filters (None, Sub,
Up, Average, Paeth; the row whose filtered bytes have the least sum of
magnitudes wins, as libpng's default heuristic picks) and zlib at level
6, so that a reader unfilters and inflates as much as it would for a
camera's PNG. 8-bit gray or RGB, and 16-bit gray (big-endian)."""

import struct
import zlib

import numpy as np


def _chunk(kind, body):
    return (struct.pack('>I', len(body)) + kind + body +
            struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filtered_rows(raw, bpp):
    """(filter types (H,), filtered rows (H, stride) uint8) of the
    unfiltered rows ``raw``, each row filtered by the type that leaves
    the least sum of byte magnitudes."""
    x = raw.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    candidates = np.stack([x, x - left, x - up, x - (left + up) // 2,
                           x - paeth]).astype(np.uint8)     # (5, H, stride)
    cost = np.abs(candidates.view(np.int8).astype(np.int32)).sum(-1)
    kinds = cost.argmin(0)
    return kinds.astype(np.uint8), candidates[kinds, np.arange(len(x))]


def encode_png(image):
    """PNG bytes of an (H, W) uint8 or uint16 image or an (H, W, 3) uint8
    one."""
    image = np.ascontiguousarray(image)
    if image.dtype == np.uint16 and image.ndim == 2:
        depth, colour, bpp = 16, 0, 2
        rows = image.astype('>u2').view(np.uint8).reshape(image.shape[0], -1)
    elif image.dtype == np.uint8 and image.ndim in (2, 3):
        depth, bpp = 8, (1 if image.ndim == 2 else image.shape[2])
        colour = {1: 0, 3: 2}[bpp]
        rows = image.reshape(image.shape[0], -1)
    else:
        raise ValueError('cannot write a PNG of {} {}'.format(
            image.dtype, image.shape))
    kinds, filtered = _filtered_rows(rows, bpp)
    data = np.concatenate([kinds[:, None], filtered], axis=1).tobytes()
    header = struct.pack('>IIBBBBB', image.shape[1], image.shape[0], depth,
                         colour, 0, 0, 0)
    return (b'\x89PNG\r\n\x1a\n' + _chunk(b'IHDR', header) +
            _chunk(b'IDAT', zlib.compress(data, 6)) + _chunk(b'IEND', b''))


def write_png(path, image):
    with open(path, 'wb') as f:
        f.write(encode_png(image))
