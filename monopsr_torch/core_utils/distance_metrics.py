"""Offline chamfer distance via KD-tree.

Counterpart of ``monopsr_tpu/core_utils/distance_metrics.py`` on scipy's
``cKDTree`` in place of scikit-learn's ``KDTree`` (both exact nearest
neighbours).
"""

import numpy as np


def calc_chamfer_dist(points_1, points_2):
    """Symmetric sum of squared NN distances between two (N, 3) clouds."""
    from scipy.spatial import cKDTree

    tree_1 = cKDTree(points_1)
    tree_2 = cKDTree(points_2)
    dists_12, _ = tree_2.query(points_1)
    dists_21, _ = tree_1.query(points_2)
    return float(np.sum(dists_12 ** 2) + np.sum(dists_21 ** 2))
