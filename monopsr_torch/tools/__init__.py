"""Offline tools, each run as ``python -m monopsr_torch.tools.<tool>``:
data preparation (``gen_depth_maps``, completed on the card, and
``gen_instance_masks``, on the host), the pretrained-trunk converters
(``convert_tf_resnet``, ``convert_torch_resnet``, with the zoo layout in
``odapi_manifest``) and ``save_kitti_predictions``.
"""
