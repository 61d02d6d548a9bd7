"""Runtime shape/type asserts for the data formats moving through the
framework.

Own copy of ``monopsr_tpu/core_utils/format_checker.py``. Formats:

- ObjectLabel: KITTI label object (see datasets.kitti.obj_utils)
- box_3d: (7,) or (N, 7) [x, y, z, l, w, h, ry]
- box_2d: (4,) or (N, 4) [y1, x1, y2, x2]
- box_8c: (3, 8) or (N, 3, 8) box corners
- anchor: (6,) or (N, 6) [x, y, z, dim_x, dim_y, dim_z]
"""

import numpy as np


class FormatError(TypeError):
    pass


def _check_last_dim(array, size, name):
    array = np.asarray(array)
    if array.ndim not in (1, 2) or array.shape[-1] != size:
        raise FormatError(
            '{} must be ({},) or (N, {}); got shape {}'.format(
                name, size, size, array.shape))
    if not np.issubdtype(array.dtype, np.floating) and \
            not np.issubdtype(array.dtype, np.integer):
        raise FormatError('{} must be numeric; got {}'.format(
            name, array.dtype))


def check_box_3d_format(box_3d):
    """Asserts box_3d format [x, y, z, l, w, h, ry]."""
    _check_last_dim(box_3d, 7, 'box_3d')


def check_box_2d_format(box_2d):
    """Asserts box_2d format [y1, x1, y2, x2]."""
    _check_last_dim(box_2d, 4, 'box_2d')


def check_anchor_format(anchor):
    """Asserts anchor format [x, y, z, dim_x, dim_y, dim_z]."""
    _check_last_dim(anchor, 6, 'anchor')


def check_box_8c_format(box_8c):
    """Asserts box_8c format: (3, 8) or (N, 3, 8) corners."""
    box_8c = np.asarray(box_8c)
    if box_8c.shape[-2:] != (3, 8):
        raise FormatError(
            'box_8c must end in (3, 8); got shape {}'.format(box_8c.shape))


def check_obj_label_format(obj_label):
    """Asserts the object looks like an ObjectLabel."""
    required = ('type', 'truncation', 'occlusion', 'alpha',
                'x1', 'y1', 'x2', 'y2', 'h', 'w', 'l', 't', 'ry')
    for field in required:
        if not hasattr(obj_label, field):
            raise FormatError(
                'ObjectLabel missing field: {}'.format(field))
    if np.ndim(obj_label.t) != 1 or len(obj_label.t) != 3:
        raise FormatError('ObjectLabel.t must be length-3')
