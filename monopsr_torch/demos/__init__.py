"""Demos, each run as ``python -m monopsr_torch.demos.<demo>
--data_split_dir <Kitti/object/training> --sample_name <name>
[--out <png>]``: a KITTI sample with its 2D and projected 3D boxes
(``view_kitti_sample_2d``), the 2D box-jitter augmentation
(``show_jittered_boxes_2d``) and the instance masks
(``view_instance_masks``). They need matplotlib, imported when a demo
runs.
"""
