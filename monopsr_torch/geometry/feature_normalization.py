"""Per-class mean normalizers for cen_y / cen_z / box height.

Counterpart of ``monopsr_tpu/geometry/feature_normalization.py``: the
class dispatch is a lookup by 1-based class index into a per-class mean
table (index 0, background, maps to 1.0).
"""

import torch

from monopsr_torch.geometry import class_stats
from monopsr_torch.utils.device import constant


def _mean_table(mean_dict, classes, device):
    """(num_classes + 1,) lookup table indexed by 1-based class index."""
    return constant([1.0] + [mean_dict[c] for c in classes], torch.float32,
                    device)


def _normalize(values, class_indices, classes, mean_dict):
    table = _mean_table(mean_dict, classes, values.device)
    idx = class_indices.reshape(-1).long().clamp(0, len(classes))
    return values / table[idx][:, None]


def normalize_cen_y_by_mean(cen_y, class_indices, classes):
    """Divides (M, 1) cen_y by the per-class mean cen_y."""
    return _normalize(cen_y, class_indices, classes, class_stats.MEAN_CEN_Y)


def normalize_cen_z_by_mean(cen_z, class_indices, classes):
    """Divides (M, 1) cen_z by the per-class mean cen_z."""
    return _normalize(cen_z, class_indices, classes, class_stats.MEAN_CEN_Z)


def normalize_box_height_by_mean(box_heights, class_indices, classes):
    """Divides (M, 1) 2D box heights by the per-class mean height."""
    return _normalize(box_heights, class_indices, classes,
                      class_stats.MEAN_BOX_2D_H)
