"""Instance-image IO (host side).

Counterpart of ``read_instance_image``, ``get_instance_image`` and
``get_instance_mask_list`` in ``monopsr_tpu/datasets/kitti/
instance_utils.py``, reading through ``utils.image_io`` instead of cv2.
The host crop and post-process functions of that module serve the
evaluator's host side and are not ported yet.
"""

import os

import numpy as np

from monopsr_torch.utils import image_io


def read_instance_image(instance_image_path):
    """The (H, W) uint8 instance image: pixels hold the index of the
    object label they belong to, 255 elsewhere."""
    try:
        instance_image = image_io.read_png(instance_image_path)
    except FileNotFoundError:
        raise FileNotFoundError('Instance image not found: ' +
                                instance_image_path) from None
    if instance_image.ndim != 2 or instance_image.dtype != np.uint8:
        raise ValueError('Instance image is not 8-bit gray: ' +
                         instance_image_path)
    return instance_image


def get_instance_image(sample_name, instance_dir):
    return read_instance_image(
        os.path.join(instance_dir, '{}.png'.format(sample_name)))


def get_instance_mask_list(instance_img, num_instances=None):
    """(H, W) instance image -> (k, H, W) boolean masks.

    Pixels hold the instance index; 255 = background.
    """
    if num_instances is None:
        valid = instance_img[instance_img != 255]
        if len(valid) == 0:
            return []
        num_instances = np.max(valid) + 1
    return np.asarray([(instance_img == idx)
                       for idx in range(num_instances)])
