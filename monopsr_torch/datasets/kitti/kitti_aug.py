"""Data augmentation: horizontal flips, image noise, 2D box jitter (host).

Own copy of ``monopsr_tpu/datasets/kitti/kitti_aug.py`` (the reference's
src/monopsr/datasets/kitti/kitti_aug.py:12-254), with the same RNG draws
in the same order. The flip helpers
(:12-122) are dormant on the reference's main training path but part of
its capability set; they are exposed here with the same semantics.
"""

import copy

import numpy as np

from monopsr_torch.datasets.kitti import evaluation
from monopsr_torch.geometry.orientation import np_wrap_to_pi


# ---------------------------------------------------------------------------
# Horizontal flips (ref: kitti_aug.py:12-122)
# ---------------------------------------------------------------------------

def flip_image(image):
    """Flips an (H, W, C) image horizontally."""
    return np.fliplr(image)


def flip_points(points):
    """Flips (N, 3) points about the x = 0 plane."""
    flipped = np.copy(points)
    flipped[:, 0] = -points[:, 0]
    return flipped


def flip_point_cloud(point_cloud):
    """Flips a (3, N) point cloud about the x = 0 plane."""
    flipped = np.copy(point_cloud)
    flipped[0] = -point_cloud[0]
    return flipped


def _flip_ry(ry):
    """Mirrors a y-rotation: ry >= 0 -> pi - ry, else -pi - ry."""
    return np.where(np.asarray(ry) >= 0, np.pi - np.asarray(ry),
                    -np.pi - np.asarray(ry))


def flip_label_in_3d_only(obj_label):
    """Flips an ObjectLabel's 3D pose; the 2D box is left untouched
    (the reference skips it as unused, ref: kitti_aug.py:34-57)."""
    flipped = copy.deepcopy(obj_label)
    flipped.ry = float(_flip_ry(obj_label.ry))
    flipped.t = (-obj_label.t[0], obj_label.t[1], obj_label.t[2])
    return flipped


def flip_boxes_3d(boxes_3d, flip_ry=True):
    """Flips (N, 7) [x y z l w h ry] boxes about x = 0."""
    boxes_3d = np.asarray(boxes_3d)
    flipped = np.copy(boxes_3d)
    if flip_ry:
        flipped[:, 6] = _flip_ry(boxes_3d[:, 6])
    flipped[:, 0] = -boxes_3d[:, 0]
    return flipped


def flip_obj_labels(obj_labels, image_shape):
    """Horizontally flips full ObjectLabels (2D box + 3D pose + alpha).

    Mirrors the 2D box about the image width (u' = W - u, matching
    flip_stereo_calib_p2's projection convention), negates t_x, mirrors
    ry, and recomputes alpha from the flipped pose per the KITTI
    definition alpha = ry - arctan2(x, z). A framework extension for
    flip-augmented training (the reference ships the 3D-only helper,
    ref: kitti_aug.py:34-57, but never trains with flips).
    """
    width = image_shape[1]
    flipped = []
    for obj in obj_labels:
        f = copy.deepcopy(obj)
        f.x1 = width - obj.x2
        f.x2 = width - obj.x1
        f.t = (-obj.t[0], obj.t[1], obj.t[2])
        f.ry = float(_flip_ry(obj.ry))
        f.alpha = float(np_wrap_to_pi(
            f.ry - np.arctan2(f.t[0], f.t[2])))
        flipped.append(f)
    return np.asarray(flipped, dtype=object)


def flip_ground_plane(ground_plane):
    """Flips ax + by + cz + d = 0 by negating the x coefficient."""
    flipped = np.copy(ground_plane)
    flipped[0] = -ground_plane[0]
    return flipped


def flip_stereo_calib_p2(calib_p2, image_shape):
    """Flips a 3x4 stereo P2 so projection matches the flipped image:
    the principal point mirrors about the image width and the baseline
    translation negates (ref: kitti_aug.py:103-122). Satisfies
    u_flipped = W - u for any point and its x-mirrored twin."""
    flipped = np.copy(calib_p2)
    flipped[0, 2] = image_shape[1] - calib_p2[0, 2]
    flipped[0, 3] = -calib_p2[0, 3]
    return flipped


def apply_image_noise(image_rgb, rng=None):
    """Applies the reference's random noise recipe to an RGB image.

    Channel swap (p=0.10), gaussian noise (p=0.40, sigma 10), per-channel
    shift (p=0.40, sigma 8), brightness (p=0.40, sigma 15), uniform noise
    (p=0.40, amplitude U[0, 10]).
    """
    if rng is None:
        rng = np.random
    image_rgb = np.asarray(image_rgb, dtype=np.uint8)
    image_out = image_rgb

    random_values = rng.rand(5)

    if random_values[0] < 0.10:
        image_out = np.copy(image_rgb)
        image_out[:, :, 1], image_out[:, :, 2] = (
            image_out[:, :, 2], image_out[:, :, 1])

    if random_values[1] < 0.40:
        noise = rng.randn(*image_rgb.shape) * 10.0
        image_out = np.uint8(np.clip(image_rgb + noise, 0.0, 255.0))

    if random_values[2] < 0.40:
        noise = rng.randn(3) * 8.0
        image_out = np.uint8(np.clip(image_rgb + noise, 0.0, 255.0))

    if random_values[3] < 0.40:
        brightness = rng.randn(1) * 15.0
        image_out = np.uint8(np.clip(image_rgb + brightness, 0.0, 255.0))

    if random_values[4] < 0.40:
        amount = rng.uniform(0, 10)
        noise = rng.uniform(-amount, amount, image_rgb.shape)
        image_out = np.uint8(np.clip(image_rgb + noise, 0.0, 255.0))

    return image_out


def jitter_obj_boxes_2d(obj_labels, iou_threshold_min, image_shape,
                        rng=None):
    """Rejection-samples gaussian-jittered 2D boxes with IoU >= threshold.

    Boxes under 10px in either dimension are returned unmodified; new boxes
    are clamped inside the image (ref: kitti_aug.py:173-254).
    """
    if rng is None:
        rng = np.random
    img_h, img_w = image_shape[0], image_shape[1]

    new_objs = []
    for obj_label in obj_labels:
        x1, y1, x2, y2 = obj_label.x1, obj_label.y1, obj_label.x2, obj_label.y2
        original_box = np.asarray([[x1, y1, x2, y2]])

        box_w, box_h = x2 - x1, y2 - y1
        half_w, half_h = box_w / 2, box_h / 2
        cx, cy = (x2 + x1) / 2, (y2 + y1) / 2

        new_obj = copy.deepcopy(obj_label)
        if box_w < 10 or box_h < 10:
            new_objs.append(new_obj)
            continue

        iou = 0.0
        while iou < iou_threshold_min:
            new_cx = rng.normal(cx, half_w / 3)
            new_cy = rng.normal(cy, half_h / 3)
            new_half_w = rng.normal(half_w, half_w / 6)
            new_half_h = rng.normal(half_h, half_h / 6)

            new_x1 = np.maximum(0, new_cx - new_half_w)
            new_x2 = np.minimum(img_w - 1, new_cx + new_half_w)
            new_y1 = np.maximum(0, new_cy - new_half_h)
            new_y2 = np.minimum(img_h - 1, new_cy + new_half_h)

            new_box = np.asarray([new_x1, new_y1, new_x2, new_y2])
            iou = evaluation.two_d_iou(new_box, original_box)

        new_obj.x1, new_obj.y1 = new_x1, new_y1
        new_obj.x2, new_obj.y2 = new_x2, new_y2
        new_objs.append(new_obj)

    return np.asarray(new_objs)
