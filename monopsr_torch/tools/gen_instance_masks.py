"""Offline tool: GT instance masks from 3D-box point containment.

Counterpart of ``monopsr_tpu/tools/gen_instance_masks.py`` (host numpy,
as there): for each label, inflate the box_3d per class, collect the
depth-map point cloud inside the inflated box intersected with the 2D
box, and paint the label index into an 8-bit PNG (255 = background)
under ``<split_dir>/instance_2_<source>/``:

    python -m monopsr_torch.tools.gen_instance_masks \\
        --data_split_dir <Kitti/object/training> \\
        [--point_cloud_source depth_2_multiscale]

The depth maps are read and the masks written by ``utils/image_io``
(pixels equal to cv2's, bytes not); the image is read for its shape
only, from its PNG header. Prints one line per sample before working on
it.
"""

import argparse
import os
import sys

import numpy as np

from monopsr_torch.datasets.kitti import calib_utils, obj_utils
from monopsr_torch.geometry import boxes as box_geom
from monopsr_torch.geometry import projection
from monopsr_torch.utils import image_io

# Per-class (x, y, z, l, w, h, ry) multiplicative inflations
INFLATIONS = {
    'Car': np.array([1.0, 1.0, 1.0, 1.25, 1.25, 1.1, 1.0]),
    'Van': np.array([1.0, 1.0, 1.0, 1.1, 1.1, 1.05, 1.0]),
    'Truck': np.array([1.0, 1.0, 1.0, 1.1, 1.1, 1.05, 1.0]),
    'Pedestrian': np.array([1.0, 1.0, 1.0, 1.0, 1.0, 1.05, 1.0]),
    'Person_sitting': np.array([1.0, 1.0, 1.0, 1.0, 1.0, 1.05, 1.0]),
    'Cyclist': np.array([1.0, 1.0, 1.0, 1.1, 1.1, 1.05, 1.0]),
    'Tram': np.array([1.0, 1.0, 1.0, 1.0, 1.1, 1.05, 1.0]),
    'Misc': np.array([1.0, 1.0, 1.0, 1.05, 1.05, 1.05, 1.0]),
}

# Additive offset: lift the box slightly (y is down in KITTI)
BOX_OFFSET = np.array([0.0, -0.05, 0.0, 0.0, 0.0, 0.0, 0.0])

REQUIRED_CLASSES = list(INFLATIONS.keys())


def modify_box_3d(box_3d, obj_label):
    return box_3d * INFLATIONS[obj_label.type] + BOX_OFFSET


def generate_instance_masks(data_split_dir,
                            point_cloud_source='depth_2_multiscale'):
    """Paints the instance image of every label file of a split directory
    into ``instance_2_<point_cloud_source>/`` (the name the dataset
    reads); returns that directory."""
    calib_dir = os.path.join(data_split_dir, 'calib')
    image_dir = os.path.join(data_split_dir, 'image_2')
    label_dir = os.path.join(data_split_dir, 'label_2')
    depth_dir = os.path.join(data_split_dir, point_cloud_source)

    out_dir = os.path.join(data_split_dir, 'instance_2_' + point_cloud_source)
    os.makedirs(out_dir, exist_ok=True)

    sample_names = sorted(os.path.splitext(f)[0] for f in os.listdir(label_dir))
    for idx, sample_name in enumerate(sample_names):
        print('{} / {} {}'.format(idx + 1, len(sample_names), sample_name))
        sys.stdout.flush()

        image_shape = image_io.png_shape(
            os.path.join(image_dir, sample_name + '.png'))
        frame_calib = calib_utils.get_frame_calib(calib_dir, sample_name)
        point_cloud = obj_utils.get_depth_map_point_cloud(
            sample_name, frame_calib, depth_dir)

        obj_labels = obj_utils.read_labels(label_dir, sample_name)
        obj_labels, _ = obj_utils.filter_labels(
            obj_labels, classes=REQUIRED_CLASSES)

        instance_image = np.full(image_shape, 255, dtype=np.uint8)

        for inst_idx, obj_label in enumerate(obj_labels):
            box_2d = obj_utils.object_label_to_box_2d(obj_label)
            box_3d = obj_utils.object_label_to_box_3d(obj_label)
            inflated = modify_box_3d(box_3d, obj_label)

            box_points, mask = box_geom.points_in_box_3d(
                inflated, point_cloud.T)
            if len(box_points) == 0:
                continue

            points_in_im = projection.np_project_pc_to_image(
                box_points.T, frame_calib.p2)
            mask_2d = ((points_in_im[0] >= box_2d[1]) &
                       (points_in_im[0] <= box_2d[3]) &
                       (points_in_im[1] >= box_2d[0]) &
                       (points_in_im[1] <= box_2d[2]))

            # Depth-map points are pixel-aligned: recover pixel coords
            mask_rows, mask_cols = np.where(mask.reshape(image_shape))
            rows = np.clip(mask_rows[mask_2d], 0, image_shape[0] - 1)
            cols = np.clip(mask_cols[mask_2d], 0, image_shape[1] - 1)
            instance_image[rows, cols] = np.uint8(inst_idx)

        image_io.write_png(os.path.join(out_dir, sample_name + '.png'),
                           instance_image)
    return out_dir


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--data_split_dir', required=True)
    parser.add_argument('--point_cloud_source',
                        default='depth_2_multiscale')
    args = parser.parse_args(argv)
    return generate_instance_masks(
        args.data_split_dir, point_cloud_source=args.point_cloud_source)


if __name__ == '__main__':
    main()
