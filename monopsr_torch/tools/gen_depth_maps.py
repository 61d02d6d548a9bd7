"""Offline tool: render and complete LiDAR depth maps for a KITTI split.

Counterpart of ``monopsr_tpu/tools/gen_depth_maps.py``: lidar -> cam0
frame -> sparse projection -> ip_basic completion
(``ops/depth_fill.fill_in_multiscale``) -> uint16 PNG under
``<split_dir>/depth_2_multiscale/``:

    python -m monopsr_torch.tools.gen_depth_maps \\
        --data_split_dir <Kitti/object/training> [--device cpu]

The completion runs on CUDA unless ``--device cpu`` is given, and raises
when CUDA is asked for and absent. There is one implementation (the JAX
tool's ``--backend host|xla`` has no counterpart): on the CPU it is the
same torch code. The image is read for its shape only, from its PNG
header. Prints one line per sample before working on it.
"""

import argparse
import os
import sys

from monopsr_torch.datasets.kitti import calib_utils, depth_map_utils
from monopsr_torch.datasets.kitti import obj_utils
from monopsr_torch.ops import depth_fill
from monopsr_torch.utils import device as device_lib
from monopsr_torch.utils import image_io


def sparse_depth_map(data_split_dir, sample_name):
    """The sample's LiDAR scan in the cam0 frame projected into its image:
    the (H, W) float32 sparse map (0 where no point lands)."""
    image_shape = image_io.png_shape(os.path.join(
        data_split_dir, 'image_2', sample_name + '.png'))
    frame_calib = calib_utils.get_frame_calib(
        os.path.join(data_split_dir, 'calib'), sample_name)
    point_cloud = obj_utils.get_lidar_point_cloud_for_cam(
        sample_name, frame_calib, os.path.join(data_split_dir, 'velodyne'),
        image_shape)
    return depth_map_utils.project_depths(point_cloud, frame_calib.p2,
                                          image_shape)


def generate_depth_maps(data_split_dir, device=None):
    """Completes the depth map of every velodyne scan of a split
    directory into ``depth_2_multiscale/``; returns that directory."""
    device = device_lib.resolve_device(device)
    velo_dir = os.path.join(data_split_dir, 'velodyne')
    out_dir = os.path.join(data_split_dir, 'depth_2_multiscale')
    os.makedirs(out_dir, exist_ok=True)

    sample_names = sorted(os.path.splitext(f)[0] for f in os.listdir(velo_dir)
                          if f.endswith('.bin'))
    for idx, sample_name in enumerate(sample_names):
        print('{} / {} {}'.format(idx + 1, len(sample_names), sample_name))
        sys.stdout.flush()

        final_depths = depth_fill.fill_in_multiscale(
            sparse_depth_map(data_split_dir, sample_name),
            device=device).cpu().numpy()
        depth_map_utils.save_depth_map(
            os.path.join(out_dir, sample_name + '.png'), final_depths)
    return out_dir


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--data_split_dir', required=True)
    parser.add_argument('--device', type=str, default=None,
                        help="'cuda' (default), 'cuda:N' or 'cpu'")
    args = parser.parse_args(argv)
    return generate_depth_maps(args.data_split_dir, device=args.device)


if __name__ == '__main__':
    main()
