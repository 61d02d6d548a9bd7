"""Demo: render a KITTI sample with 2D boxes and projected 3D boxes.

Counterpart of ``demos/view_kitti_sample_2d.py``, with the same flags.

Usage:
    python -m monopsr_torch.demos.view_kitti_sample_2d \\
        --data_split_dir <dir> --sample_name 000003 [--out sample.png]
"""

import argparse
import os

from monopsr_torch.datasets.kitti import calib_utils, obj_utils
from monopsr_torch.visualization import vis_utils


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--data_split_dir', required=True)
    parser.add_argument('--sample_name', required=True)
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)

    import matplotlib
    matplotlib.use('Agg')

    d = args.data_split_dir
    image = obj_utils.get_image(args.sample_name,
                                os.path.join(d, 'image_2'))[..., ::-1]
    calib = calib_utils.get_frame_calib(os.path.join(d, 'calib'),
                                        args.sample_name)
    labels = obj_utils.read_labels(os.path.join(d, 'label_2'),
                                   args.sample_name)

    fig, ax = vis_utils.create_fig(image)
    for obj in labels:
        if obj.type == 'DontCare':
            continue
        vis_utils.draw_box_2d(ax, obj)
        vis_utils.draw_obj_as_box_3d(ax, obj, calib.p2)

    out = args.out or (args.sample_name + '_boxes.png')
    vis_utils.save_fig(fig, out)
    print('Saved', out)


if __name__ == '__main__':
    main()
