"""Data-preparation tools: depth maps from velodyne scans
(``gen_depth_maps``, completed on the card) and instance masks from the
depth maps and the labels (``gen_instance_masks``, on the host). Each
runs as ``python -m monopsr_torch.tools.<tool> --data_split_dir ...``.
"""
