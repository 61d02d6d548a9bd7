"""KITTI object-label IO, filtering, and label-derived geometry (host side).

Own copy of ``monopsr_tpu/datasets/kitti/obj_utils.py`` (numpy; runs in
the host input pipeline and the data-preparation tools), with
``get_image`` reading through ``utils.image_io`` instead of cv2.
"""

import copy
import os

import numpy as np

from monopsr_torch.datasets.kitti import evaluation
from monopsr_torch.geometry import class_stats, projection
from monopsr_torch.utils import image_io

# KITTI difficulty thresholds (easy, moderate, hard)
HEIGHT = class_stats.DIFFICULTY_HEIGHT
OCCLUSION = class_stats.DIFFICULTY_OCCLUSION
TRUNCATION = class_stats.DIFFICULTY_TRUNCATION

MEAN_HEIGHTS = class_stats.MEAN_HEIGHTS


class Difficulty:
    EASY = 0
    MODERATE = 1
    HARD = 2
    ALL = 3

    _TO_STR = {EASY: 'easy', MODERATE: 'moderate', HARD: 'hard', ALL: 'all'}
    _FROM_STR = {v: k for k, v in _TO_STR.items()}

    @staticmethod
    def to_string(difficulty):
        return Difficulty._TO_STR[difficulty]

    @staticmethod
    def from_string(difficulty_str):
        return Difficulty._FROM_STR[difficulty_str]


class ObjectLabel:
    """A single KITTI object label row.

    Fields follow the KITTI devkit convention: type, truncation,
    occlusion, alpha, (x1, y1, x2, y2), (h, w, l), t=(x, y, z), ry, score.
    """

    __slots__ = ('type', 'truncation', 'occlusion', 'alpha',
                 'x1', 'y1', 'x2', 'y2', 'h', 'w', 'l', 't', 'ry', 'score')

    def __init__(self):
        self.type = None
        self.truncation = 0.0
        self.occlusion = 0
        self.alpha = 0.0
        self.x1 = 0.0
        self.y1 = 0.0
        self.x2 = 0.0
        self.y2 = 0.0
        self.h = 0.0
        self.w = 0.0
        self.l = 0.0
        self.t = (0.0, 0.0, 0.0)
        self.ry = 0.0
        self.score = 0.0

    def __eq__(self, other):
        if not isinstance(other, ObjectLabel):
            return False
        return all(
            np.all(getattr(self, k) == getattr(other, k))
            for k in self.__slots__)

    def __repr__(self):
        return ('({}, a:{}, t:{} lwh:({:.3f}, {:.3f}, {:.3f}), '
                'ry:{:.3f})').format(self.type, self.alpha, self.t,
                                     self.l, self.w, self.h, self.ry)


def read_labels(label_dir, sample_name):
    """Reads a KITTI label file into an array of ObjectLabels."""
    label_path = os.path.join(label_dir, '{}.txt'.format(sample_name))
    if not os.path.exists(label_path):
        raise FileNotFoundError('Label file could not be found: ' +
                                label_path)
    if os.stat(label_path).st_size == 0:
        return np.asarray([])

    # Direct line parser: np.loadtxt costs ~3 ms per tiny label file
    # (it dominates host assembly after imread); splitting lines by
    # whitespace matches its single-space KITTI rows, comment/blank
    # skipping included.
    obj_list = []
    with open(label_path, 'r') as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith('#'):
                continue
            row = line.split()
            num_cols = len(row)
            if num_cols not in (15, 16):
                raise ValueError(
                    'Invalid label format: {} columns'.format(num_cols))
            obj = ObjectLabel()
            obj.type = row[0]
            obj.truncation = float(row[1])
            obj.occlusion = float(row[2])
            obj.alpha = float(row[3])
            obj.x1, obj.y1, obj.x2, obj.y2 = (
                np.float32(row[4]), np.float32(row[5]),
                np.float32(row[6]), np.float32(row[7]))
            obj.h, obj.w, obj.l = (np.float32(row[8]), np.float32(row[9]),
                                   np.float32(row[10]))
            obj.t = np.asarray(row[11:14], np.float32)
            obj.ry = float(row[14])
            obj.score = float(row[15]) if num_cols == 16 else 0.0
            obj_list.append(obj)

    return np.asarray(obj_list)


# ---------------------------------------------------------------------------
# Filtering
# ---------------------------------------------------------------------------

class ObjectFilter:
    def __init__(self, config):
        self.classes = config.classes
        self.difficulty = Difficulty.from_string(config.difficulty_str)
        self.box_2d_height = config.box_2d_height
        self.truncation = config.truncation
        self.occlusion = config.occlusion
        self.depth_range = config.depth_range

    @staticmethod
    def create_obj_filter(classes, difficulty, occlusion, truncation,
                          box_2d_height, depth_range):
        from monopsr_torch.config import ConfigObj
        config = ConfigObj()
        config.classes = classes
        config.difficulty_str = Difficulty.to_string(difficulty)
        config.occlusion = occlusion
        config.truncation = truncation
        config.box_2d_height = box_2d_height
        config.depth_range = depth_range
        return ObjectFilter(config)


def _check_difficulty(obj, difficulty):
    if difficulty == Difficulty.ALL:
        return True
    return (obj.occlusion <= OCCLUSION[difficulty] and
            obj.truncation <= TRUNCATION[difficulty] and
            (obj.y2 - obj.y1) >= HEIGHT[difficulty])


def filter_labels(obj_labels, classes=None, difficulty=None,
                  box_2d_height=None, occlusion=None, truncation=None,
                  depth_range=None):
    """Filters labels by class, difficulty, box height, occ/trunc, depth.

    Comparison directions follow the reference exactly
    (ref: obj_utils.py:193-345): box height strictly greater, truncation
    and occlusion strictly less, depth strictly inside the open range.

    Returns:
        (filtered_labels, keep_mask)
    """
    obj_labels = np.asarray(obj_labels)
    mask = np.full(len(obj_labels), True)

    if classes is not None:
        mask &= np.asarray([obj.type in classes for obj in obj_labels],
                           bool)
    if difficulty is not None:
        mask &= np.asarray(
            [_check_difficulty(obj, difficulty) for obj in obj_labels], bool)
    if box_2d_height is not None:
        mask &= np.asarray(
            [(obj.y2 - obj.y1) > box_2d_height for obj in obj_labels], bool)
    if occlusion is not None:
        mask &= np.asarray(
            [obj.occlusion < occlusion for obj in obj_labels], bool)
    if truncation is not None:
        mask &= np.asarray(
            [obj.truncation < truncation for obj in obj_labels], bool)
    if depth_range is not None:
        mask &= np.asarray(
            [depth_range[0] < obj.t[2] < depth_range[1]
             for obj in obj_labels], bool)

    return obj_labels[mask], mask


def apply_obj_filter(obj_labels, obj_filter):
    return filter_labels(
        obj_labels,
        classes=obj_filter.classes,
        difficulty=obj_filter.difficulty,
        box_2d_height=obj_filter.box_2d_height,
        occlusion=obj_filter.occlusion,
        truncation=obj_filter.truncation,
        depth_range=obj_filter.depth_range)


# ---------------------------------------------------------------------------
# Label <-> array conversions
# ---------------------------------------------------------------------------

def object_label_to_box_2d(obj_label):
    """ObjectLabel -> box_2d [y1, x1, y2, x2]."""
    return np.asarray([obj_label.y1, obj_label.x1, obj_label.y2,
                       obj_label.x2], np.float32)


def object_label_to_box_3d(obj_label):
    """ObjectLabel -> box_3d [x, y, z, l, w, h, ry]."""
    box_3d = np.zeros(7, dtype=np.float32)
    box_3d[0:3] = obj_label.t
    box_3d[3:6] = obj_label.l, obj_label.w, obj_label.h
    box_3d[6] = obj_label.ry
    return box_3d


def box_3d_to_object_label(box_3d, obj_type='Car'):
    obj = ObjectLabel()
    obj.type = obj_type
    obj.t = np.asarray(box_3d[0:3])
    obj.l, obj.w, obj.h = box_3d[3], box_3d[4], box_3d[5]
    obj.ry = box_3d[6]
    return obj


def boxes_2d_from_obj_labels(obj_labels):
    return np.asarray([object_label_to_box_2d(o) for o in obj_labels],
                      np.float32)


def boxes_3d_from_obj_labels(obj_labels):
    return np.asarray([object_label_to_box_3d(o) for o in obj_labels],
                      np.float32)


def obj_label_to_kitti_fmt(obj_label):
    """ObjectLabel -> KITTI text row fields."""
    return [
        obj_label.type, -1, -1, obj_label.alpha,
        obj_label.x1, obj_label.y1, obj_label.x2, obj_label.y2,
        obj_label.h, obj_label.w, obj_label.l,
        obj_label.t[0], obj_label.t[1], obj_label.t[2], obj_label.ry,
        obj_label.score,
    ]


def class_str_to_index(class_str, classes):
    """Class string -> 1-based index (0 reserved for background)."""
    if class_str in classes:
        return classes.index(class_str) + 1
    raise ValueError('Invalid class string {}, not in {}'.format(
        class_str, classes))


# ---------------------------------------------------------------------------
# Viewing angles
# ---------------------------------------------------------------------------

def get_viewing_angle_box_2d(box_2d, cam_p):
    """Viewing angle towards the 2D box centre (depth-1 projection ray)."""
    centre_x = np.mean(np.asarray(box_2d)[[1, 3]])
    centre_u = cam_p[0, 2]
    focal_length = cam_p[0, 0]
    return np.arctan2((centre_x - centre_u) / focal_length, 1.0)


def get_viewing_angle_box_3d(box_3d, cam_p=None, version='x_offset'):
    """Viewing angle to a box_3d centroid.

    Versions: 'cam_0' (raw atan2), 'x_offset' (shift into camN frame),
    'projection' (project centroid then depth-1 ray).
    """
    if version == 'cam_0':
        return np.arctan2(box_3d[0], box_3d[2])
    if version == 'x_offset':
        x_offset = -cam_p[0, 3] / cam_p[0, 0]
        return np.arctan2(box_3d[0] - x_offset, box_3d[2])
    if version == 'projection':
        proj_uv = projection.np_project_pc_to_image(
            np.asarray(box_3d[0:3]).reshape(3, 1), cam_p)
        centre_u = cam_p[0, 2]
        focal_length = cam_p[0, 0]
        return np.arctan2((proj_uv[0][0] - centre_u) / focal_length, 1.0)
    raise ValueError('Invalid version: ' + str(version))


def get_viewing_angles_box_2d(boxes_2d, cam_p):
    """Vectorized get_viewing_angle_box_2d over an (N, 4) box array."""
    boxes = np.asarray(boxes_2d, np.float64)
    centre_x = (boxes[:, 1] + boxes[:, 3]) / 2.0
    return np.arctan2((centre_x - cam_p[0, 2]) / cam_p[0, 0], 1.0)


def get_viewing_angles_box_3d(boxes_3d, cam_p=None, version='x_offset'):
    """Vectorized get_viewing_angle_box_3d over an (N, 7) box_3d array."""
    boxes = np.asarray(boxes_3d, np.float64)
    if version == 'cam_0':
        return np.arctan2(boxes[:, 0], boxes[:, 2])
    if version == 'x_offset':
        x_offset = -cam_p[0, 3] / cam_p[0, 0]
        return np.arctan2(boxes[:, 0] - x_offset, boxes[:, 2])
    # 'projection' stays per-box (matrix projection + ray per label)
    return np.asarray([get_viewing_angle_box_3d(b, cam_p, version)
                       for b in boxes])


def get_mean_lwh_and_std_dev(class_str):
    return class_stats.MEAN_LWH[class_str], class_stats.STD_LWH[class_str]


# ---------------------------------------------------------------------------
# MSCNN detection merge
# ---------------------------------------------------------------------------

def merge_kitti_and_mscnn_obj_labels(kitti_obj_labels, mscnn_obj_labels,
                                     min_iou, default_score_type='distance'):
    """Replaces KITTI box coords/scores with best-IoU-matching MSCNN ones.

    Unmatched KITTI labels get a fallback score: 'distance' maps depth to
    clip(1 - z/45, 0.1, 1); 'max' -> 1.0; 'min' -> 0.0
    (ref: obj_utils.py:1037-1089).
    """
    new_labels = copy.deepcopy(np.asarray(kitti_obj_labels))
    if len(new_labels) and len(mscnn_obj_labels):
        kitti_boxes = boxes_2d_from_obj_labels(kitti_obj_labels)
        mscnn_boxes = boxes_2d_from_obj_labels(mscnn_obj_labels)

        for mscnn_idx, mscnn_box in enumerate(mscnn_boxes):
            ious = evaluation.two_d_iou(mscnn_box, kitti_boxes)
            best = int(np.argmax(ious))
            if ious[best] >= min_iou:
                new_labels[best].y1 = mscnn_box[0]
                new_labels[best].x1 = mscnn_box[1]
                new_labels[best].y2 = mscnn_box[2]
                new_labels[best].x2 = mscnn_box[3]
                new_labels[best].score = mscnn_obj_labels[mscnn_idx].score

    for obj in new_labels:
        if obj.score == 0:
            if default_score_type == 'distance':
                obj.score = float(np.clip(1.0 - (obj.t[2] / 45.0), 0.1, 1.0))
            elif default_score_type == 'max':
                obj.score = 1.0
            elif default_score_type == 'min':
                obj.score = 0.0
            else:
                raise ValueError('Invalid default score type: ' +
                                 str(default_score_type))
    return new_labels


# ---------------------------------------------------------------------------
# LiDAR / depth map IO
# ---------------------------------------------------------------------------

def read_lidar(velo_dir, sample_name):
    """Reads a velodyne .bin into (N, 4) xyzi."""
    velo_path = os.path.join(velo_dir, '{}.bin'.format(sample_name))
    if not os.path.exists(velo_path):
        raise FileNotFoundError('Velodyne file not found: ' + velo_path)
    return np.fromfile(velo_path, np.single).reshape(-1, 4)


def get_lidar_point_cloud(sample_name, frame_calib, velo_dir):
    """LiDAR points in the cam0 frame, (3, N)."""
    from monopsr_torch.datasets.kitti import calib_utils
    xyzi = read_lidar(velo_dir, sample_name)
    points = calib_utils.lidar_to_cam_frame(xyzi[:, 0:3], frame_calib)
    return points.T


def get_lidar_point_cloud_for_cam(sample_name, frame_calib, velo_dir,
                                  image_shape=None, cam_idx=2):
    """LiDAR points in cam0 frame, optionally filtered to the image."""
    point_cloud = get_lidar_point_cloud(sample_name, frame_calib, velo_dir)
    point_cloud = point_cloud[:, point_cloud[2] > 1.0]

    if image_shape is None:
        return point_cloud

    cam_p = frame_calib.p2 if cam_idx == 2 else frame_calib.p3
    points_in_img = projection.np_project_pc_to_image(point_cloud, cam_p)
    rounded = np.round(points_in_img)
    keep = ((rounded[0] >= 0) & (rounded[0] < image_shape[1]) &
            (rounded[1] >= 0) & (rounded[1] < image_shape[0]))
    return point_cloud[:, keep].astype(np.float32)


def get_depth_map(sample_name, depth_dir):
    from monopsr_torch.datasets.kitti import depth_map_utils
    path = os.path.join(depth_dir, '{}.png'.format(sample_name))
    return depth_map_utils.read_depth_map(path)


def get_depth_map_point_cloud(sample_name, frame_calib, depth_dir):
    depth_map = get_depth_map(sample_name, depth_dir)
    return projection.np_get_depth_point_cloud(depth_map, frame_calib.p2)


def get_image(sample_name, image_dir):
    """The sample's 8-bit colour image in BGR order, as cv2.imread
    returns it."""
    return image_io.read_png(
        os.path.join(image_dir, '{}.png'.format(sample_name)))[..., ::-1]


def get_road_plane(sample_name, planes_dir):
    """Reads normalized ground-plane coefficients [a, b, c, d]."""
    plane_file = os.path.join(planes_dir, '{}.txt'.format(sample_name))
    with open(plane_file, 'r') as f:
        lines = f.readlines()
    plane = np.asarray([float(v) for v in lines[3].split()])

    if plane[1] > 0:
        raise ValueError('Plane is facing downwards')
    return plane / np.linalg.norm(plane[0:3])
