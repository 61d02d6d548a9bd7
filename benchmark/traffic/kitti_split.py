"""A KITTI-format split made from a seed: the eval cells' traffic.

``make_split(params, seed, root)`` writes, under ``root``:

- ``object/<split>.txt`` and ``object/training/`` with ``image_2``
  (RGB PNGs at KITTI's 375x1242, per-row filters, zlib level 6),
  ``calib`` (KITTI's P2), ``label_2`` (Car labels), ``depth_2_multiscale``
  (dense uint16 depth maps, metres * 256) and
  ``instance_2_depth_2_multiscale`` (uint8 instance images, 255 where no
  object is), in the layout the port's data preparation writes;
- ``mscnn/<split>/merged_<thr>/data``: 2D detections, each object's box
  jittered with a score, plus a few false positives.

The split list (``object/<split>.txt``) runs through the generated frames
``frames_per_pass / frames`` times, in the same order each time, so that
one evaluation pass reads, decodes, evaluates and writes as many frames
as the mix states while only ``frames`` are generated and referenced: a
frame listed again is assembled again from its files, with the same
draws (the dataset seeds them by name and epoch).

Every frame's layout comes from the traffic file alone (``count_seed``):
how many objects it holds (Poisson with the stated mean, and a stated
share of crowded frames drawn from a range), each object's pose and
size, and how many false positives there are and where. The run's seed
permutes those layouts in whole dispatch groups (``block`` frames, the
evaluator's batch: the groups themselves are shuffled, and the frames
within each) and draws each frame's look: sky, road and car colours,
pixel and depth noise, detection jitter and scores. Every seed therefore
brings the same objects, boxes and groups, so the same work, in another
order and another look.

It returns a ``Split`` that keeps every array it wrote, so the reference
reads the same inputs without a PNG decoder.
"""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark.traffic import png

# KITTI's camera 2 (the fixture's calib/000001.txt)
P2 = np.array([[721.5377, 0.0, 609.5593, 44.85728],
               [0.0, 721.5377, 172.854, 0.2163791],
               [0.0, 0.0, 1.0, 0.002745884]])
_CALIB_OTHER = (
    ('P0', [721.5377, 0, 609.5593, 0, 0, 721.5377, 172.854, 0, 0, 0, 1, 0]),
    ('P1', [721.5377, 0, 609.5593, -387.5744, 0, 721.5377, 172.854, 0,
            0, 0, 1, 0]),
    ('P3', [721.5377, 0, 609.5593, -339.5242, 0, 721.5377, 172.854,
            2.199936, 0, 0, 1, 0.002729905]),
    ('R0_rect', [0.9999239, 0.00983776, -0.007445048, -0.009869795,
                 0.9999421, -0.004278459, 0.007402527, 0.004351614,
                 0.9999631]),
    ('Tr_velo_to_cam', [0.007533745, -0.9999714, -0.000616602, -0.004069766,
                        0.01480249, 0.0007280733, -0.9998902, -0.07631618,
                        0.9998621, 0.00752379, 0.01480755, -0.2717806]),
    ('Tr_imu_to_velo', [0.9999976, 0.0007553071, -0.002035826, -0.8086759,
                        -0.0007854027, 0.9998898, -0.01482298, 0.3195559,
                        0.002024406, 0.01482454, 0.9998881, -0.7997231]))
CAMERA_HEIGHT = 1.65
MEAN_LWH = (3.892, 1.619, 1.530)        # KITTI's Car means


@dataclasses.dataclass
class Frame:
    name: str
    image: np.ndarray        # (H, W, 3) uint8 RGB
    depth: np.ndarray        # (H, W) uint16, metres * 256
    instance: np.ndarray     # (H, W) uint8, label index or 255
    labels: list             # KITTI label rows (text)
    detections: list         # MSCNN rows (text)


@dataclasses.dataclass
class Split:
    root: str
    dataset_dir: str
    mscnn_dir: str
    split: str
    frames: list
    cycles: int = 1          # passes through ``frames`` in the split list

    @property
    def names(self):
        return [frame.name for frame in self.frames]


def frame_counts(params):
    """[(objects, false positives)] per frame, before the seed's
    permutation: drawn from the traffic's own ``count_seed``."""
    counts = params['objects_per_frame']
    n = int(params['frames'])
    rng = np.random.default_rng(int(counts['count_seed']))
    crowded = int(round(float(counts['crowded_share']) * n))
    lo, hi = counts['crowded_range']
    objects = np.concatenate([
        rng.integers(lo, hi + 1, crowded),
        rng.poisson(float(counts['poisson_mean']), n - crowded)])
    fps = rng.integers(0, int(params['false_positives_max']) + 1, n)
    # the crowded frames spread over the list, and so over the groups
    objects = objects[rng.permutation(n)]
    return [(int(o), int(f)) for o, f in zip(objects, fps)]


def _block_order(n, block, seed):
    """The frames' layout indices in the seed's order: whole blocks of
    ``block`` frames shuffled, and the frames within each; a last,
    shorter block keeps its place."""
    rng = np.random.default_rng([seed, n])
    block = max(1, int(block))
    full = n // block
    order = [b * block + i for b in rng.permutation(full)
             for i in rng.permutation(block)]
    return order + list(range(full * block, n))


def frame_layouts(params):
    """[(objects, false-positive boxes)] per frame, before the seed's
    permutation: the counts of ``frame_counts``, the objects' label
    fields (``_draw_object``) and the false positives' (x1, y1, x2, y2),
    drawn from the traffic's own ``count_seed``."""
    shape = tuple(params['image_shape'])
    seed = int(params['objects_per_frame']['count_seed'])
    layouts = []
    for index, (n_obj, n_fp) in enumerate(frame_counts(params)):
        rng = np.random.default_rng([seed, index])
        objects = [_draw_object(rng, shape) for _ in range(n_obj)]
        fps = []
        for _ in range(n_fp):
            bh, bw = rng.uniform(30, 120), rng.uniform(40, 200)
            y1, x1 = rng.uniform(150, shape[0] - bh - 1), rng.uniform(
                0, shape[1] - bw - 1)
            fps.append((x1, y1, x1 + bw, y1 + bh))
        layouts.append((objects, fps))
    return layouts


def _box_corners(l, w, h, x, y, z, ry):
    """(3, 8) corners of a KITTI box (x, y at the bottom face's centre)."""
    xs = np.array([l, l, -l, -l, l, l, -l, -l]) / 2
    ys = np.array([0, 0, 0, 0, -h, -h, -h, -h])
    zs = np.array([w, -w, -w, w, w, -w, -w, w]) / 2
    c, s = np.cos(ry), np.sin(ry)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return rot @ np.stack([xs, ys, zs]) + np.array([[x], [y], [z]])


def _project(points):
    uvw = P2 @ np.vstack([points, np.ones((1, points.shape[1]))])
    return uvw[:2] / uvw[2]


def _draw_object(rng, shape):
    """One Car label fully in the image, as rounded label fields:
    (h, w, l, x, y, z, ry, alpha, (x1, y1, x2, y2))."""
    height, width = shape
    for _ in range(1000):
        l, w, h = np.round(np.array(MEAN_LWH)[[0, 1, 2]] *
                           rng.uniform(0.9, 1.1, 3), 2)
        z = round(rng.uniform(7.0, 38.0), 2)
        u = rng.uniform(60, width - 60)
        x = round((u - P2[0, 2]) * z / P2[0, 0], 2)
        y = round(CAMERA_HEIGHT + rng.normal(0.0, 0.05), 2)
        ry = round(rng.uniform(-np.pi, np.pi), 2)
        uv = _project(_box_corners(l, w, h, x, y, z, ry))
        x1, y1 = uv.min(1)
        x2, y2 = uv.max(1)
        if x1 < 1 or y1 < 1 or x2 > width - 2 or y2 > height - 2:
            continue
        alpha = (ry - np.arctan2(x, z) + np.pi) % (2 * np.pi) - np.pi
        return (h, w, l, x, y, z, ry, round(alpha, 2),
                tuple(round(v, 2) for v in (x1, y1, x2, y2)))
    raise RuntimeError('no object pose fits the image')


def _paint(rng, shape, objects, noise_sigma, depth_sigma):
    """(image, depth uint16, instance image) of one frame."""
    height, width = shape
    v = np.arange(height, dtype=np.float64)[:, None]
    horizon = P2[1, 2]
    below = v > horizon + 1
    road_z = np.where(below, P2[1, 1] * CAMERA_HEIGHT /
                      np.maximum(v - horizon, 1e-3), 0.0)
    depth = np.broadcast_to(np.where(road_z < 80.0, road_z, 0.0),
                            shape).copy()
    instance = np.full(shape, 255, np.uint8)

    sky = np.array(rng.uniform([110, 140, 170], [150, 180, 230]))
    road = np.array(rng.uniform([70, 70, 70], [110, 110, 110]))
    t = np.clip(v / height, 0, 1)[..., None]
    image = np.where(below[..., None], road * (0.7 + 0.6 * t),
                     sky * (1.2 - 0.5 * t))
    image = np.broadcast_to(image, shape + (3,)).copy()

    uu = np.arange(width, dtype=np.float64)[None, :]
    # far objects first, so near ones cover them
    for index in sorted(range(len(objects)), key=lambda i: -objects[i][5]):
        z = objects[index][5]
        x1, y1, x2, y2 = objects[index][8]
        cy, cx = (y1 + y2) / 2, (x1 + x2) / 2
        ry_, rx_ = (y2 - y1) / 2 * 0.95, (x2 - x1) / 2 * 0.95
        r2 = ((v - cy) / ry_) ** 2 + ((uu - cx) / rx_) ** 2
        inside = r2 <= 1.0
        instance[inside] = index
        depth[inside] = (z + 0.6 * r2)[inside]
        colour = rng.uniform(20, 235, 3)
        shade = (1.0 - 0.35 * r2)[..., None] * colour
        wheels = (v > cy + 0.5 * ry_) & inside
        image[inside] = shade[inside]
        image[wheels] = image[wheels] * 0.35
    image = image + rng.normal(0.0, noise_sigma, image.shape)
    image = np.clip(np.rint(image), 0, 255).astype(np.uint8)
    depth = depth + rng.normal(0.0, depth_sigma, shape) * (depth > 0)
    depth = np.rint(np.where(depth >= 0.1, depth, 0.0) * 256.0)
    return image, depth.astype(np.uint16), instance


def _label_row(obj):
    h, w, l, x, y, z, ry, alpha, (x1, y1, x2, y2) = obj
    return ('Car 0.00 0 {:.2f} {:.2f} {:.2f} {:.2f} {:.2f} {:.2f} {:.2f} '
            '{:.2f} {:.2f} {:.2f} {:.2f} {:.2f}'.format(
                alpha, x1, y1, x2, y2, h, w, l, x, y, z, ry))


def _detection_row(box, score):
    return ('Car -1 -1 -10 {:.2f} {:.2f} {:.2f} {:.2f} -1 -1 -1 -1000 -1000 '
            '-1000 -10 {:.2f}'.format(*box, score))


def _make_frame(params, seed, index, layout):
    shape = tuple(params['image_shape'])
    rng = np.random.default_rng([seed, index])
    objects, fps = layout
    image, depth, instance = _paint(rng, shape, objects,
                                    float(params['noise_sigma']),
                                    float(params['depth_noise_m']))
    jitter = float(params['detection_jitter_px'])
    detections = []
    for obj in objects:
        box = np.array(obj[8]) + rng.normal(0.0, jitter, 4)
        box = np.clip(box, 0, [shape[1] - 1, shape[0] - 1] * 2)
        detections.append(_detection_row(box, rng.uniform(0.6, 0.99)))
    for box in fps:
        detections.append(_detection_row(box, rng.uniform(0.2, 0.5)))
    return Frame('{:06d}'.format(index), image, depth, instance,
                 [_label_row(obj) for obj in objects], detections)


def _write_frame(frame, dirs):
    png.write_png(os.path.join(dirs['image_2'], frame.name + '.png'),
                  frame.image)
    png.write_png(os.path.join(dirs['depth_2_multiscale'],
                               frame.name + '.png'), frame.depth)
    png.write_png(os.path.join(dirs['instance_2_depth_2_multiscale'],
                               frame.name + '.png'), frame.instance)
    with open(os.path.join(dirs['label_2'], frame.name + '.txt'), 'w') as f:
        f.write(''.join(row + '\n' for row in frame.labels))
    with open(os.path.join(dirs['mscnn'], frame.name + '.txt'), 'w') as f:
        f.write(''.join(row + '\n' for row in frame.detections))
    with open(os.path.join(dirs['calib'], frame.name + '.txt'), 'w') as f:
        rows = [('P2', P2.ravel())] + list(_CALIB_OTHER)
        order = ('P0', 'P1', 'P2', 'P3', 'R0_rect', 'Tr_velo_to_cam',
                 'Tr_imu_to_velo')
        rows = dict(rows)
        f.write(''.join('{}: {}\n'.format(key, ' '.join(
            '{:.12e}'.format(float(v)) for v in rows[key])) for key in order))


def make_split(params, seed, root, threads=4, block=1):
    """Generates and writes the split of ``params`` for ``seed`` under
    ``root``, its layouts permuted in blocks of ``block`` frames (the
    evaluator's batch); returns its ``Split``."""
    split = params.get('split', 'val')
    layouts = frame_layouts(params)
    layouts = [layouts[i] for i in _block_order(len(layouts), block, seed)]
    dataset_dir = os.path.join(root, 'object')
    mscnn_dir = os.path.join(root, 'mscnn')
    dirs = {name: os.path.join(dataset_dir, 'training', name) for name in (
        'image_2', 'calib', 'label_2', 'depth_2_multiscale',
        'instance_2_depth_2_multiscale')}
    dirs['mscnn'] = os.path.join(mscnn_dir, split, 'merged_{}'.format(
        '_'.join(str(t) for t in params['mscnn_thr'])), 'data')
    for path in dirs.values():
        os.makedirs(path, exist_ok=True)

    def one(index):
        frame = _make_frame(params, seed, index, layouts[index])
        _write_frame(frame, dirs)
        return frame

    with ThreadPoolExecutor(threads) as pool:
        frames = list(pool.map(one, range(len(layouts))))
    cycles = pass_cycles(params)
    with open(os.path.join(dataset_dir, split + '.txt'), 'w') as f:
        f.write(''.join(frame.name + '\n' for frame in frames) * cycles)
    return Split(root, dataset_dir, mscnn_dir, split, frames, cycles)


def pass_cycles(params):
    """How many times the split list runs through the generated frames:
    ``frames_per_pass`` over ``frames`` (a whole number)."""
    frames = int(params['frames'])
    per_pass = int(params.get('frames_per_pass') or frames)
    if per_pass % frames:
        raise ValueError('frames_per_pass {} is not a multiple of frames '
                         '{}'.format(per_pass, frames))
    return per_pass // frames
