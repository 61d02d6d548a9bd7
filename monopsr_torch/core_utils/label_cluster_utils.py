"""Per-class (l, w, h) k-means clustering with a text cache.

Counterpart of ``monopsr_tpu/core_utils/label_cluster_utils.py``. Not on
the main path (the dataset hardcodes the Car cluster); used for offline
analysis and alternative mean-dimension tables. One cluster is the
mean and standard deviation, as in JAX. Several are k-means on scipy
(``kmeans2``, k-means++ seeding, the best of 10 seeded runs by
inertia) where JAX calls scikit-learn's ``KMeans(n_init=10,
random_state=0)``: the same objective, with centers that agree on
separated data but not bit for bit, in ascending order of length.
"""

import os

import numpy as np

from monopsr_torch.datasets.kitti import obj_utils


class LabelClusterUtils:

    def __init__(self, dataset, cache_dir=None):
        self.dataset = dataset
        self.cache_dir = cache_dir or os.path.join(
            dataset.dataset_dir, 'label_clusters')

    def _cache_path(self, class_str, num_clusters):
        return os.path.join(
            self.cache_dir, '{}_{}_{}.txt'.format(
                self.dataset.data_split, class_str, num_clusters))

    def collect_dims(self, class_str):
        """Gathers (l, w, h) rows for a class over the dataset split."""
        dims = []
        for sample_name in self.dataset.get_sample_names():
            labels = obj_utils.read_labels(
                self.dataset.kitti_label_dir, sample_name)
            for obj in labels:
                if obj.type == class_str:
                    dims.append([obj.l, obj.w, obj.h])
        return np.asarray(dims, np.float64)

    def get_clusters(self, class_str, num_clusters=1):
        """Returns (clusters (k, 3), std_devs (k, 3)); cached to txt."""
        cache = self._cache_path(class_str, num_clusters)
        if os.path.exists(cache):
            data = np.loadtxt(cache).reshape(2 * num_clusters, 3)
            return data[:num_clusters], data[num_clusters:]

        dims = self.collect_dims(class_str)
        if len(dims) == 0:
            raise ValueError('No labels of class ' + class_str)

        if num_clusters == 1:
            clusters = dims.mean(axis=0, keepdims=True)
            stds = dims.std(axis=0, keepdims=True)
        else:
            clusters, labels = _kmeans(dims, num_clusters)
            stds = np.stack([
                dims[labels == i].std(axis=0)
                for i in range(num_clusters)])

        os.makedirs(self.cache_dir, exist_ok=True)
        np.savetxt(cache, np.vstack([clusters, stds]), fmt='%.6f')
        return clusters, stds


def _kmeans(points, num_clusters):
    """(centers (k, 3) in ascending order of the first column, labels):
    the run of least inertia among 10 k-means++ runs seeded with 0."""
    from scipy.cluster.vq import kmeans2

    rng = np.random.default_rng(0)
    best = None
    for _ in range(10):
        centers, labels = kmeans2(points, num_clusters, minit='++',
                                  seed=rng)
        inertia = np.sum((points - centers[labels]) ** 2)
        if best is None or inertia < best[0]:
            best = (inertia, centers, labels)
    _, centers, labels = best
    order = np.argsort(centers[:, 0], kind='stable')
    return centers[order], np.argsort(order)[labels]
