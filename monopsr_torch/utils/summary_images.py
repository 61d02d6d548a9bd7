"""Feature-map grid image summaries.

Counterpart of ``monopsr_tpu/utils/summary_images.py``: tiles the
channels of a feature map into one grid image, written as an 8-bit gray
PNG under the experiment logdir by ``utils.image_io.write_png`` (the
pixels cv2.imwrite stores; no cv2). Enabled by the ``summary_images``
config flag (``train.trainer.train``).
"""

import math
import os

import numpy as np

from monopsr_torch.utils import image_io


def feature_map_grid(feature_map, max_channels=64):
    """(H, W, C) feature map -> (gh*H, gw*W) tiled grayscale grid."""
    feature_map = np.asarray(feature_map, np.float32)
    h, w, c = feature_map.shape
    c = min(c, max_channels)

    grid_w = int(math.ceil(math.sqrt(c)))
    grid_h = int(math.ceil(c / grid_w))

    lo = feature_map[..., :c].min()
    hi = feature_map[..., :c].max()
    scale = (hi - lo) if hi > lo else 1.0

    grid = np.zeros((grid_h * h, grid_w * w), np.float32)
    for idx in range(c):
        gy, gx = divmod(idx, grid_w)
        grid[gy * h:(gy + 1) * h, gx * w:(gx + 1) * w] = (
            (feature_map[..., idx] - lo) / scale)
    return grid


def save_feature_maps(logdir, step, name, feature_map,
                      max_channels=64):
    """Saves a feature-map grid png: <logdir>/images/<step>_<name>.png"""
    out_dir = os.path.join(logdir, 'images')
    os.makedirs(out_dir, exist_ok=True)
    grid = feature_map_grid(feature_map, max_channels)
    path = os.path.join(out_dir, '{}_{}.png'.format(step, name))
    image_io.write_png(path, (grid * 255).astype(np.uint8))
    return path
