"""Demo: visualize the 2D box-jitter augmentation.

Counterpart of ``demos/show_jittered_boxes_2d.py``, with the same flags.

Usage:
    python -m monopsr_torch.demos.show_jittered_boxes_2d \\
        --data_split_dir <dir> --sample_name 000003 [--out jitter.png]
"""

import argparse
import os

from monopsr_torch.datasets.kitti import kitti_aug, obj_utils
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
    labels = obj_utils.read_labels(os.path.join(d, 'label_2'),
                                   args.sample_name)
    labels = [o for o in labels if o.type != 'DontCare']

    jittered = kitti_aug.jitter_obj_boxes_2d(labels, 0.7,
                                             image.shape[0:2])

    fig, ax = vis_utils.create_fig(image)
    for obj in labels:
        vis_utils.draw_box_2d(ax, obj, colour='lime')
    for obj in jittered:
        vis_utils.draw_box_2d(ax, obj, colour='red', linewidth=1)

    out = args.out or (args.sample_name + '_jitter.png')
    vis_utils.save_fig(fig, out)
    print('Saved', out)


if __name__ == '__main__':
    main()
