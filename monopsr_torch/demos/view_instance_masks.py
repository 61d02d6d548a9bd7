"""Demo: overlay generated instance masks on a KITTI image.

Counterpart of ``demos/view_instance_masks.py``, with the same flags.

Usage:
    python -m monopsr_torch.demos.view_instance_masks \\
        --data_split_dir <dir> --sample_name 000003 [--out masks.png]
"""

import argparse
import os

from monopsr_torch.datasets.kitti import instance_utils, obj_utils
from monopsr_torch.visualization import vis_utils


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--data_split_dir', required=True)
    parser.add_argument('--sample_name', required=True)
    parser.add_argument('--instance_version',
                        default='depth_2_multiscale')
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)

    import matplotlib
    matplotlib.use('Agg')

    d = args.data_split_dir
    image = obj_utils.get_image(args.sample_name,
                                os.path.join(d, 'image_2'))[..., ::-1]
    instance_img = instance_utils.get_instance_image(
        args.sample_name,
        os.path.join(d, 'instance_2_' + args.instance_version))

    blended = vis_utils.draw_instance_masks(image, instance_img)
    fig, ax = vis_utils.create_fig(blended)

    out = args.out or (args.sample_name + '_instances.png')
    vis_utils.save_fig(fig, out)
    print('Saved', out)


if __name__ == '__main__':
    main()
