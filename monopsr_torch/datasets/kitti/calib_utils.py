"""KITTI calibration file parsing and frame transforms (host side).

Own copy of ``monopsr_tpu/datasets/kitti/calib_utils.py``, with
``read_disparity`` reading through ``utils.image_io`` instead of cv2.
"""

import csv
import os

import numpy as np

from monopsr_torch.utils import image_io


class FrameCalib:
    """Per-frame calibration.

    Fields:
        p0-p3: (3, 4) camera projection matrices.
        r0_rect: (3, 3) rectification matrix.
        velo_to_cam: (3, 4) velodyne -> camera transform.
            Point_Camera = P_cam * R0_rect * Tr_velo_to_cam * Point_Velodyne
    """

    def __init__(self):
        self.p0 = []
        self.p1 = []
        self.p2 = []
        self.p3 = []
        self.r0_rect = []
        self.velo_to_cam = []


def read_frame_calib(calib_file_path):
    """Parses a KITTI calib txt into a FrameCalib."""
    with open(calib_file_path, 'r') as f:
        data = [row for row in csv.reader(f, delimiter=' ')]

    frame_calib = FrameCalib()
    p_all = []
    for i in range(4):
        vals = [float(v) for v in data[i][1:] if v != '']
        p_all.append(np.reshape(vals, (3, 4)))
    frame_calib.p0, frame_calib.p1, frame_calib.p2, frame_calib.p3 = p_all

    rect_vals = [float(v) for v in data[4][1:] if v != '']
    frame_calib.r0_rect = np.reshape(rect_vals, (3, 3))

    v2c_vals = [float(v) for v in data[5][1:] if v != '']
    frame_calib.velo_to_cam = np.reshape(v2c_vals, (3, 4))

    return frame_calib


def get_frame_calib(calib_dir, sample_name):
    return read_frame_calib(
        os.path.join(calib_dir, '{}.txt'.format(sample_name)))


class StereoCalib:
    """Stereo calibration: baseline, focal length, intrinsics, centre."""

    def __init__(self):
        self.baseline = 0.0
        self.f = 0.0
        self.k = []
        self.center_u = 0.0
        self.center_v = 0.0


def krt_from_p(p, fsign=1):
    """Factorizes P = K [R; t] with the requested focal-length sign.

    (ref: calib_utils.py:105-166) QR-based factorization with sign
    fixups so K has a positive diagonal and R is a proper rotation.
    """
    s = p[0:3, 3]
    q = np.linalg.inv(p[0:3, 0:3])
    u, b = np.linalg.qr(q)
    sgn = np.sign(b[2, 2])
    b = b * sgn
    s = s * sgn

    if fsign * b[0, 0] < 0:
        e = np.diag([-1.0, 1.0, 1.0])
        b = e @ b
        u = u @ e
    if fsign * b[2, 2] < 0:
        e = np.diag([1.0, -1.0, 1.0])
        b = e @ b
        u = u @ e
    if np.linalg.det(u) < 0:
        u = -u
        s = -s

    r = u.T
    t = b @ s
    k = np.linalg.inv(b)
    k = k / k[2, 2]
    return k, r, t


def get_stereo_calibration(left_cam_mat, right_cam_mat):
    """Extracts stereo parameters for disparity -> depth conversion."""
    stereo_calib = StereoCalib()
    k_left, _, t_left = krt_from_p(left_cam_mat)
    _, _, t_right = krt_from_p(right_cam_mat)

    stereo_calib.baseline = abs(t_left[0] - t_right[0])
    stereo_calib.f = k_left[0, 0]
    stereo_calib.k = k_left
    stereo_calib.center_u = k_left[0, 2]
    stereo_calib.center_v = k_left[1, 2]
    return stereo_calib


def read_disparity(disp_dir, img_idx):
    """Reads a KITTI disparity png (ref: calib_utils.py:283-308)."""
    disp_path = os.path.join(disp_dir,
                             '%06d_left_disparity.png' % img_idx)
    if not os.path.exists(disp_path):
        raise FileNotFoundError('Disparity map not found: ' + disp_path)
    return image_io.read_png(disp_path)


def depth_from_disparity(disp, stereo_calib):
    """Disparity map -> (x, y, z) point arrays
    (ref: calib_utils.py:202-242)."""
    disp = np.asarray(disp, np.float32).copy()
    disp[disp == 0] = 0.1

    depth = (stereo_calib.f * stereo_calib.baseline) / disp

    h, w = depth.shape
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    flat = depth.flatten()
    xx = xx.flatten() - stereo_calib.center_u
    yy = yy.flatten() - stereo_calib.center_v

    ratio = flat / stereo_calib.f
    return xx * ratio, yy * ratio, flat


def lidar_to_cam_frame(xyz_lidar, frame_calib):
    """(N, 3) lidar-frame points -> (N, 3) cam0-frame points."""
    r0_rect = np.eye(4)
    r0_rect[0:3, 0:3] = frame_calib.r0_rect

    tf_mat = np.eye(4)
    tf_mat[0:3, :] = frame_calib.velo_to_cam

    xyz_hom = np.hstack(
        [xyz_lidar, np.ones((xyz_lidar.shape[0], 1))])
    ret = (r0_rect @ tf_mat) @ xyz_hom.T
    return ret[0:3].T
