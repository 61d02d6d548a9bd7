"""Synthetic training samples made from a seed: the train cells' traffic.

A copy of the port's ``experiments/flagship.synthetic_sample`` (the
samples ``chip_smoke.py`` and the port's bench train on): a KITTI-like
sample in the trainer's device encodings, with uint8 noise as the image,
boxes in KITTI's 375x1242 pixels, a uint16 depth map (metres * 256) and
a uint8 instance image at the padded depth shape, the objects painted
into both. ``samples(params, seed, cfg)`` draws the traffic file's
``distinct_samples`` of them from one stream seeded with the run's seed;
a run cycles through them.
"""

import numpy as np

from benchmark.reference import constants as C
from benchmark.reference.class_stats import (CEN_Y_TREND_OFFSET_MIDDLE,
                                             MEAN_LWH, PROP_CEN_Z_OFFSET)

ORIG_SHAPE = (375, 1242)
DEPTH_PAD_SHAPE = C.DEPTH_PAD_SHAPE


def synthetic_sample(rng, cfg, orig_shape=ORIG_SHAPE,
                     depth_shape=DEPTH_PAD_SHAPE):
    """One KITTI-like sample in the trainer's device encodings: uint8
    image at the input shape, boxes in original-image pixels, uint16
    depth (metres * 256) and uint8 instance image at the padded depth
    shape with the objects painted into both."""
    n, nb = cfg.num_boxes, cfg.num_alpha_bins
    oh, ow = orig_shape
    image = rng.randint(0, 256, cfg.image_input_shape + (3,)).astype(np.uint8)
    cam_p = np.array([[721.5377, 0.0, 609.5593, 44.85728],
                      [0.0, 721.5377, 172.854, 0.2163791],
                      [0.0, 0.0, 1.0, 0.002745884]], np.float32)
    depth = np.zeros(depth_shape, np.float32)
    inst = np.full(depth_shape, 255, np.uint8)
    boxes_2d = np.zeros((n, 4), np.float32)
    boxes_3d = np.zeros((n, 7), np.float32)
    for i in range(n):
        bh, bw = rng.randint(oh // 16, oh // 3), rng.randint(ow // 40, ow // 6)
        y1, x1 = rng.randint(oh // 4, oh - bh), rng.randint(0, ow - bw)
        z = rng.uniform(6.0, 44.0)
        yy, xx = np.mgrid[0:bh, 0:bw]
        depth[y1:y1 + bh, x1:x1 + bw] = z + 0.01 * yy - 0.005 * xx
        inst[y1:y1 + bh, x1:x1 + bw] = i
        boxes_2d[i] = [y1, x1, y1 + bh, x1 + bw] + rng.uniform(-0.4, 0.4, 4)
        # Box centre on the painted object (y is the bottom face)
        cx = ((x1 + bw / 2) - cam_p[0, 2]) / cam_p[0, 0] * z
        cy = ((y1 + bh / 2) - cam_p[1, 2]) / cam_p[1, 1] * z + 0.75
        boxes_3d[i] = [cx, cy, z, 3.9, 1.6, 1.5, rng.uniform(-3, 3)]
    alphas = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    width = 2 * np.pi / nb
    angle = np.mod(alphas, 2 * np.pi)
    bins = np.minimum((angle // width).astype(np.int32), nb - 1)
    regs = (angle[:, None] - (np.arange(nb) + 0.5) * width).astype(np.float32)
    view_2d = np.arctan2(((boxes_2d[:, 1] + boxes_2d[:, 3]) / 2 - cam_p[0, 2])
                         / cam_p[0, 0], 1.0).astype(np.float32)
    view_3d = np.arctan2(boxes_3d[:, 0] + cam_p[0, 3] / cam_p[0, 0],
                         boxes_3d[:, 2]).astype(np.float32)
    return {
        'image': image,
        C.SAMPLE_LABEL_BOXES_2D: boxes_2d,
        C.SAMPLE_LABEL_BOXES_2D_NORM:
            boxes_2d / np.array([oh, ow, oh, ow], np.float32),
        C.SAMPLE_LABEL_BOXES_3D: boxes_3d,
        C.SAMPLE_VIEWING_ANGLES_2D: view_2d,
        C.SAMPLE_VIEWING_ANGLES_3D: view_3d,
        C.SAMPLE_LABEL_CLASS_INDICES: np.ones((n, 1), np.int32),
        C.SAMPLE_MEAN_LWH: np.tile(MEAN_LWH['Car'], (n, 1)).astype(
            np.float32),
        C.SAMPLE_PROP_CEN_Z_OFFSET: np.full(
            n, PROP_CEN_Z_OFFSET['Car'], np.float32),
        C.SAMPLE_CEN_Y_OFFSETS: np.full(
            n, CEN_Y_TREND_OFFSET_MIDDLE[('Car', 'kitti')],
            np.float32),
        C.SAMPLE_CAM_P: cam_p,
        C.SAMPLE_DEPTH_MAP: np.rint(depth * 256.0).astype(np.uint16),
        C.SAMPLE_INSTANCE_IMAGE: inst,
        C.SAMPLE_INSTANCE_INDICES: np.arange(n, dtype=np.int32),
        C.SAMPLE_ALPHAS: alphas,
        C.SAMPLE_ALPHA_BINS: bins,
        C.SAMPLE_ALPHA_REGS: regs,
        C.SAMPLE_ALPHA_VALID_BINS: np.eye(nb, dtype=np.float32)[bins],
    }


def samples(params, seed, cfg):
    """The traffic's ``distinct_samples`` samples of ``cfg``'s shapes,
    from one stream seeded with ``seed`` (any non-negative integer)."""
    rng = np.random.RandomState(np.random.SeedSequence(seed).generate_state(
        4))
    return [synthetic_sample(rng, cfg)
            for _ in range(int(params['distinct_samples']))]
