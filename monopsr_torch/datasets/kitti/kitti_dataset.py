"""KITTI dataset: host pipeline emitting fixed-shape sample dicts.

Counterpart of ``monopsr_tpu/datasets/kitti/kitti_dataset.py``, with the
PNGs read by ``utils.image_io`` instead of cv2: the same sample dicts
(keys, dtypes, shapes), the same seeded per-sample RNG and the same
epoch accounting, so a seeded dataset of either package yields the same
samples in the same order. As in the JAX package:

1. Everything is padded/oversampled to static shapes (num_boxes slots,
   depth/instance maps padded to a resolution bucket).
2. Instead of (N, H, W) per-box instance masks, samples carry the single
   (H, W) instance image plus a per-slot original-label index; the GT
   crops rebuild the masks at the 48x48 gathered samples
   (``geometry.instance.instance_xyz_crop_from_depth_map``).
"""

import fnmatch
import os
import zlib

import numpy as np

import monopsr_torch
from monopsr_torch import constants
from monopsr_torch.constants import (DEPTH_PAD_SHAPE, SAMPLE_CEN_Y_OFFSETS,
                                     SAMPLE_INSTANCE_IMAGE,
                                     SAMPLE_INSTANCE_INDICES)
from monopsr_torch.datasets.kitti import (calib_utils, instance_utils,
                                          kitti_aug, obj_utils)
from monopsr_torch.datasets.kitti.obj_utils import Difficulty
from monopsr_torch.geometry import class_stats, orientation
from monopsr_torch.utils import image_io

SAMPLE_IMAGE_SHAPE = 'sample_image_shape'


class Sample:
    def __init__(self, name, augs):
        self.name = name
        self.augs = augs

    def __repr__(self):
        return '({}, augs: {})'.format(self.name, self.augs)


class KittiDataset:

    def __init__(self, dataset_config, train_val_test):
        self.dataset_config = dataset_config
        self.train_val_test = train_val_test

        self.name = dataset_config.name
        self.data_split = dataset_config.data_split
        self.dataset_dir = os.path.expanduser(dataset_config.dataset_dir)
        data_split_dir = dataset_config.data_split_dir

        self.num_boxes = dataset_config.num_boxes
        self.num_alpha_bins = dataset_config.num_alpha_bins
        self.alpha_bin_overlap = dataset_config.alpha_bin_overlap
        self.centroid_type = dataset_config.centroid_type

        self.cam_idx = 2

        self.classes = list(dataset_config.classes)
        self.num_classes = len(self.classes)

        if train_val_test in ('train', 'val'):
            obj_filter_config = dataset_config.obj_filter_config
            obj_filter_config.classes = self.classes
            self.obj_filter = obj_utils.ObjectFilter(obj_filter_config)
        else:
            self.obj_filter = obj_utils.ObjectFilter.create_obj_filter(
                classes=self.classes, difficulty=Difficulty.ALL,
                occlusion=None, truncation=None, box_2d_height=None,
                depth_range=None)

        self.has_kitti_labels = dataset_config.has_kitti_labels
        self.use_mscnn_detections = dataset_config.use_mscnn_detections
        self.mscnn_thr = dataset_config.mscnn_thr

        # Always use statistics computed from KITTI 2D boxes
        self.trend_data = 'kitti'

        self.classes_name = self._set_up_classes_name()
        self.mscnn_merge_min_iou = class_stats.MSCNN_MERGE_MIN_IOU[
            self.classes_name]

        self._check_dataset_dir()
        all_files = os.listdir(self.dataset_dir)
        self._check_data_split_valid(all_files)
        self.data_split_dir = self._check_data_split_dir_valid(
            all_files, data_split_dir)

        self.depth_version = dataset_config.depth_version
        self.instance_version = dataset_config.instance_version

        self._set_up_directories()

        self.oversample = dataset_config.oversample
        self.aug_config = dataset_config.aug_config

        loaded = self.load_sample_names(self.data_split)
        self.sample_list = np.asarray(
            [Sample(name, []) for name in loaded])
        self.num_samples = len(self.sample_list)

        self.clusters, self.std_devs = (
            class_stats.MEAN_LWH[self.classes_name],
            class_stats.STD_LWH[self.classes_name])

        # Static pad bucket (configurable via dataset_config.depth_pad_shape)
        self.depth_pad_shape = tuple(
            dataset_config.get('depth_pad_shape') or DEPTH_PAD_SHAPE)

        # Seeded reproducibility (the reference uses the global
        # unseeded np.random). With dataset_config.seed set, the
        # per-sample draws (oversample, augmentation) come from an RNG
        # derived from (seed, sample name, epoch) — independent of how
        # many loader/producer threads interleave get_sample_dict
        # calls — while the shared stream RNG below drives the
        # (single-threaded) epoch shuffle.
        seed = dataset_config.get('seed')
        self._seed = None if seed is None else int(seed)
        self._rng = np.random.RandomState(self._seed)

        # Batch pointers
        self._index_in_epoch = 0
        self.epochs_completed = 0

    # -- path / split validation ------------------------------------------

    def _check_dataset_dir(self):
        if not os.path.exists(self.dataset_dir):
            raise FileNotFoundError(
                'Dataset path does not exist: {}'.format(self.dataset_dir))

    def _check_data_split_valid(self, all_dataset_files):
        possible_splits = [
            os.path.splitext(f)[0] for f in all_dataset_files
            if fnmatch.fnmatch(f, '*.txt')]
        if 'readme' in possible_splits:
            possible_splits.remove('readme')
        if self.data_split not in possible_splits:
            raise ValueError(
                'Invalid data split: {}, possible_splits: {}'.format(
                    self.data_split, possible_splits))

    def _check_data_split_dir_valid(self, all_dataset_files, data_split_dir):
        possible_dirs = [
            f for f in all_dataset_files
            if os.path.isdir(os.path.join(self.dataset_dir, f))]
        if data_split_dir not in possible_dirs:
            raise ValueError(
                'Invalid data split dir: {}, possible dirs: {}'.format(
                    data_split_dir, possible_dirs))
        return os.path.join(self.dataset_dir, data_split_dir)

    def _set_up_directories(self):
        d = self.data_split_dir
        self.rgb_image_dir = os.path.join(d, 'image_' + str(self.cam_idx))
        self.image_2_dir = os.path.join(d, 'image_2')
        self.calib_dir = os.path.join(d, 'calib')
        self.disp_dir = os.path.join(d, 'disparity')
        self.planes_dir = os.path.join(d, 'planes')
        self.velo_dir = os.path.join(d, 'velodyne')
        self.depth_dir = os.path.join(
            d, 'depth_{}_{}'.format(self.cam_idx, self.depth_version))
        self.instance_dir = os.path.join(
            d, 'instance_{}_{}'.format(self.cam_idx, self.instance_version))

        mscnn_base = (self.dataset_config.get('mscnn_dir') or
                      os.path.join(monopsr_torch.data_dir(),
                                   'detections/mscnn/kitti_fmt'))
        self.mscnn_label_dir = os.path.join(
            os.path.expanduser(mscnn_base),
            '{}/merged_{}/data'.format(
                self.data_split, '_'.join(map(str, self.mscnn_thr))))

        if self.has_kitti_labels:
            self.kitti_label_dir = os.path.join(d, 'label_2')

    def _set_up_classes_name(self):
        if self.num_classes > 1:
            raise NotImplementedError('Number of classes must be 1 per run '
                                      '(reference contract)')
        return self.classes[0]

    # -- paths --------------------------------------------------------------

    def get_sample_names(self):
        return [sample.name for sample in self.sample_list]

    def get_rgb_image_path(self, sample_name):
        return os.path.join(self.rgb_image_dir, sample_name + '.png')

    def get_depth_map_path(self, sample_name):
        return os.path.join(self.depth_dir, sample_name + '.png')

    def get_velodyne_path(self, sample_name):
        return os.path.join(self.velo_dir, sample_name + '.bin')

    def get_cluster_info(self):
        return self.clusters, self.std_devs

    def load_sample_names(self, data_split):
        set_file = os.path.join(self.dataset_dir, data_split + '.txt')
        with open(set_file, 'r') as f:
            return np.asarray(f.read().splitlines())

    # -- sample assembly ------------------------------------------------------

    def _sample_rng(self, sample_name):
        """RNG for one sample's draws (oversample, augmentation).

        Seeded datasets derive the state from (seed, sample name,
        epoch), so the draws are identical regardless of thread
        interleaving across loader/producer pools; unseeded datasets
        share one stream (reference behavior: global np.random).
        """
        if self._seed is None:
            return self._rng
        mix = zlib.crc32(sample_name.encode('utf8'))
        return np.random.RandomState(
            (self._seed * 1000003 + mix
             + 16777619 * self.epochs_completed) % (2 ** 32))

    def _oversample_indices(self, num_objs, rng):
        if num_objs >= self.num_boxes:
            return np.arange(self.num_boxes)
        extra = rng.choice(
            num_objs, self.num_boxes - num_objs, replace=True)
        return np.hstack([np.arange(num_objs), extra])

    def _pad_map(self, arr, fill=0):
        """Pads an (H, W) map to the static bucket."""
        ph, pw = self.depth_pad_shape
        h, w = arr.shape[0:2]
        if h > ph or w > pw:
            raise ValueError(
                'Map shape {} exceeds pad bucket {}'.format(
                    arr.shape, self.depth_pad_shape))
        out = np.full((ph, pw), fill, dtype=arr.dtype)
        out[:h, :w] = arr
        return out

    def get_sample_dict(self, indices):
        """Loads fixed-shape sample dicts for the given sample indices.

        Samples with no valid objects yield None (reference contract).
        """
        sample_dicts = []
        for sample_idx in indices:
            sample_name = self.sample_list[sample_idx].name
            rng = self._sample_rng(sample_name)

            image_path = self.get_rgb_image_path(sample_name)
            try:
                rgb_image = image_io.read_png(image_path)
            except FileNotFoundError:
                raise FileNotFoundError(
                    'Image not found: ' + image_path) from None
            image_shape = rgb_image.shape[0:2]
            image_input = rgb_image

            frame_calib = calib_utils.get_frame_calib(
                self.calib_dir, sample_name)
            cam_p = frame_calib.p2

            instance_image = None
            depth_map = None

            # Horizontal-flip augmentation (train only, opt-in via
            # aug_config.use_flip_aug): flips the image, calibration,
            # labels (2D box + 3D pose + alpha), depth map, and instance
            # image as one consistent mirrored scene. Drawn before any
            # other per-sample randomness.
            flip = (self.train_val_test == 'train' and
                    bool(self.aug_config.get('use_flip_aug', False)) and
                    rng.rand() < 0.5)
            if flip:
                image_input = rgb_image = kitti_aug.flip_image(rgb_image)
                cam_p = kitti_aug.flip_stereo_calib_p2(cam_p, image_shape)

            if self.train_val_test in ('train', 'val'):
                kitti_obj_labels = obj_utils.read_labels(
                    self.kitti_label_dir, sample_name)
                if flip:
                    kitti_obj_labels = kitti_aug.flip_obj_labels(
                        kitti_obj_labels, image_shape)

                if self.use_mscnn_detections and self.train_val_test == 'val':
                    mscnn_obj_labels = obj_utils.read_labels(
                        self.mscnn_label_dir, sample_name)
                    obj_labels = obj_utils.merge_kitti_and_mscnn_obj_labels(
                        kitti_obj_labels, mscnn_obj_labels,
                        min_iou=self.mscnn_merge_min_iou,
                        default_score_type='distance')
                else:
                    obj_labels = kitti_obj_labels

                num_all_objs = len(obj_labels)
                obj_labels, obj_mask = obj_utils.apply_obj_filter(
                    obj_labels, self.obj_filter)
                num_objs = len(obj_labels)
                if num_objs < 1:
                    sample_dicts.append(None)
                    continue

                if self.use_mscnn_detections:
                    kitti_obj_labels, _ = obj_utils.apply_obj_filter(
                        kitti_obj_labels, self.obj_filter)
                    num_kitti_objs = len(kitti_obj_labels)
                    if num_kitti_objs < 1:
                        sample_dicts.append(None)
                        continue

                # Original label index per surviving box (the instance
                # image pixels hold these indices)
                orig_indices = np.nonzero(obj_mask)[0]

                instance_image = instance_utils.get_instance_image(
                    sample_name, self.instance_dir)
                if flip:
                    instance_image = np.fliplr(instance_image)

                if self.oversample:
                    osi = self._oversample_indices(num_objs, rng)
                    obj_labels = obj_labels[osi]
                    orig_indices = orig_indices[osi]
                    num_objs = min(num_objs, self.num_boxes)

                # Augmentation (train only)
                if self.train_val_test == 'train':
                    if self.aug_config.use_image_aug:
                        image_input = kitti_aug.apply_image_noise(
                            rgb_image, rng=rng)

                    box_jitter_type = self.aug_config.box_jitter_type
                    if box_jitter_type is None:
                        pass
                    elif box_jitter_type == 'oversample':
                        if not self.oversample:
                            raise ValueError(
                                'Must oversample to use jitter type '
                                + box_jitter_type)
                        obj_labels[num_objs:] = kitti_aug.jitter_obj_boxes_2d(
                            obj_labels[num_objs:], 0.7, image_shape,
                            rng=rng)
                    elif box_jitter_type == 'oversample_gt':
                        if not self.oversample:
                            raise ValueError(
                                'Must oversample to use jitter type '
                                + box_jitter_type)
                        n_extra = self.num_boxes - num_objs
                        gt_pick = rng.choice(
                            num_kitti_objs, n_extra, replace=True)
                        obj_labels[num_objs:] = kitti_aug.jitter_obj_boxes_2d(
                            kitti_obj_labels[gt_pick], 0.7, image_shape,
                            rng=rng)
                        # Jittered GT boxes keep their own instance channels
                        kitti_orig = np.nonzero(obj_mask)[0]
                        if len(kitti_orig) >= num_kitti_objs:
                            orig_indices[num_objs:] = kitti_orig[gt_pick]
                    elif box_jitter_type == 'all':
                        obj_labels = kitti_aug.jitter_obj_boxes_2d(
                            obj_labels, 0.7, image_shape, rng=rng)
                    else:
                        raise ValueError(
                            'Invalid box_jitter_type: ' + str(box_jitter_type))

                label_boxes_2d = obj_utils.boxes_2d_from_obj_labels(
                    obj_labels)
                label_boxes_3d = obj_utils.boxes_3d_from_obj_labels(
                    obj_labels)
                label_alphas = np.asarray(
                    [o.alpha for o in obj_labels], np.float32)

                alphas = np.asarray([o.alpha for o in obj_labels])
                bins, regs, valid_bins = (
                    orientation.np_orientation_to_angle_bin(
                        alphas, self.num_alpha_bins, self.alpha_bin_overlap))

                label_viewing_angles_2d = obj_utils.get_viewing_angles_box_2d(
                    label_boxes_2d, cam_p).astype(np.float32)
                label_viewing_angles_3d = obj_utils.get_viewing_angles_box_3d(
                    label_boxes_3d, cam_p).astype(np.float32)

                label_class_indices = np.asarray(
                    [obj_utils.class_str_to_index(o.type, self.classes)
                     for o in obj_labels], np.int32)[:, None]
                label_class_strs = [o.type for o in obj_labels]

                prop_cen_z_offsets = class_stats.prop_cen_z_offset_array(
                    label_class_strs)
                cen_y_offsets = np.asarray(
                    [class_stats.cen_y_trend_offset(
                        c, self.trend_data, self.centroid_type)
                     for c in label_class_strs], np.float32)

                depth_map = obj_utils.get_depth_map(
                    sample_name, self.depth_dir)
                if flip:
                    depth_map = np.fliplr(depth_map)

                label_scores = np.asarray(
                    [o.score for o in obj_labels], np.float32)
                lwh_means = class_stats.mean_lwh_array(label_class_strs)

            elif self.train_val_test == 'test':
                obj_labels = obj_utils.read_labels(
                    self.mscnn_label_dir, sample_name)
                if len(obj_labels) < 1:
                    sample_dicts.append(None)
                    continue

                obj_labels, _ = obj_utils.apply_obj_filter(
                    obj_labels, self.obj_filter)
                num_objs = len(obj_labels)
                if num_objs < 1:
                    sample_dicts.append(None)
                    continue

                osi = self._oversample_indices(num_objs, rng)
                obj_labels = obj_labels[osi]
                num_objs = min(num_objs, self.num_boxes)

                label_boxes_2d = obj_utils.boxes_2d_from_obj_labels(
                    obj_labels)
                label_scores = np.asarray(
                    [o.score for o in obj_labels], np.float32)
                label_viewing_angles_2d = obj_utils.get_viewing_angles_box_2d(
                    label_boxes_2d, cam_p).astype(np.float32)
                label_class_indices = np.asarray(
                    [obj_utils.class_str_to_index(o.type, self.classes)
                     for o in obj_labels], np.int32)[:, None]
                label_class_strs = [o.type for o in obj_labels]
                lwh_means = class_stats.mean_lwh_array(label_class_strs)
                prop_cen_z_offsets = class_stats.prop_cen_z_offset_array(
                    label_class_strs)
                cen_y_offsets = np.asarray(
                    [class_stats.cen_y_trend_offset(
                        c, self.trend_data, self.centroid_type)
                     for c in label_class_strs], np.float32)
            else:
                raise ValueError('Invalid run mode: ' + self.train_val_test)

            label_boxes_2d_norm = label_boxes_2d / np.tile(image_shape, 2)

            sample_dict = {
                constants.SAMPLE_NUM_OBJS: num_objs,
                constants.SAMPLE_IMAGE_INPUT: image_input,
                SAMPLE_IMAGE_SHAPE: np.asarray(image_shape, np.int32),
                constants.SAMPLE_CAM_P: np.asarray(cam_p, np.float32),
                constants.SAMPLE_NAME: sample_name,
                constants.SAMPLE_LABEL_BOXES_2D_NORM:
                    label_boxes_2d_norm.astype(np.float32),
                constants.SAMPLE_LABEL_BOXES_2D: label_boxes_2d,
                constants.SAMPLE_LABEL_SCORES: label_scores,
                constants.SAMPLE_LABEL_CLASS_STRS:
                    np.expand_dims(label_class_strs, 1),
                constants.SAMPLE_LABEL_CLASS_INDICES: label_class_indices,
                constants.SAMPLE_MEAN_LWH: lwh_means,
                constants.SAMPLE_PROP_CEN_Z_OFFSET: prop_cen_z_offsets,
                SAMPLE_CEN_Y_OFFSETS: cen_y_offsets,
                constants.SAMPLE_VIEWING_ANGLES_2D: label_viewing_angles_2d,
            }

            if self.train_val_test in ('train', 'val'):
                sample_dict.update({
                    constants.SAMPLE_LABEL_BOXES_3D: label_boxes_3d,
                    constants.SAMPLE_ALPHAS: label_alphas,
                    constants.SAMPLE_ALPHA_BINS:
                        np.asarray(bins, np.int32),
                    constants.SAMPLE_ALPHA_REGS:
                        np.asarray(regs, np.float32),
                    constants.SAMPLE_ALPHA_VALID_BINS:
                        np.asarray(valid_bins, np.float32),
                    constants.SAMPLE_VIEWING_ANGLES_3D:
                        label_viewing_angles_3d,
                    SAMPLE_INSTANCE_IMAGE: self._pad_map(
                        instance_image.astype(np.int32), fill=255),
                    SAMPLE_INSTANCE_INDICES:
                        orig_indices.astype(np.int32),
                    constants.SAMPLE_DEPTH_MAP: self._pad_map(
                        depth_map.astype(np.float32)),
                })

            sample_dicts.append(sample_dict)

        return sample_dicts

    # -- epoch iteration -------------------------------------------------------

    def _shuffle_samples(self):
        perm = np.arange(self.num_samples)
        self._rng.shuffle(perm)
        self.sample_list = self.sample_list[perm]

    def next_batch(self, batch_size, shuffle):
        """Returns the next batch of sample dicts (None for empty samples)."""
        samples_in_batch = []
        start = self._index_in_epoch

        if self.epochs_completed == 0 and start == 0 and shuffle:
            self._shuffle_samples()

        if start + batch_size >= self.num_samples:
            self.epochs_completed += 1
            rest = self.num_samples - start
            samples_in_batch.extend(
                self.get_sample_dict(np.arange(start, self.num_samples)))
            if shuffle:
                self._shuffle_samples()
            start = 0
            self._index_in_epoch = batch_size - rest
            samples_in_batch.extend(
                self.get_sample_dict(np.arange(0, self._index_in_epoch)))
        else:
            self._index_in_epoch += batch_size
            samples_in_batch.extend(
                self.get_sample_dict(
                    np.arange(start, self._index_in_epoch)))

        return samples_in_batch
