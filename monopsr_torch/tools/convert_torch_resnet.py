"""Converts a torchvision-style ResNet state_dict to the NPZ trunk format.

Counterpart of ``monopsr_tpu/tools/convert_torch_resnet.py``, with the
same flags and the same NPZ (bitwise, tests/test_torch_converters.py):
given a locally available ResNet-50/101/152 .pth (torchvision naming),
it writes data/pretrained/<name>.npz with flat 'scope/leaf' keys in the
JAX package's layout (HWIO kernels), which ``train.pretrained`` loads
into BOTH towers.

Key mapping (torchvision -> NPZ):
    conv1.weight                    -> conv1/kernel (HWIO)
    bn1.{weight,bias}               -> conv1_bn/{scale,bias}
    bn1.running_{mean,var}          -> conv1_bn/{mean,var}
    layerL.U.convK.weight           -> blockL_unit(U+1)/convK/kernel
    layerL.U.bnK.*                  -> blockL_unit(U+1)/bnK/*
    layerL.U.downsample.0.weight    -> blockL_unit(U+1)/shortcut/kernel
    layerL.U.downsample.1.*         -> blockL_unit(U+1)/shortcut_bn/*

torchvision puts the strided unit FIRST in each layer while slim puts
the stride LAST; at output_stride 4 every unit of blocks 2-3 runs at
stride 1 (dilation instead), so only the projection shortcut's position
(unit 1) matters, and both conventions agree on it.

Usage:
    python -m monopsr_torch.tools.convert_torch_resnet \\
        --torch_weights resnet101.pth --out_name resnet101_kitti
"""

import argparse
import os
import re

import numpy as np

import monopsr_torch


def convert_state_dict(state_dict):
    """torch state_dict (tensors or arrays) -> flat {key: np.ndarray}."""
    out = {}

    def to_np(v):
        if hasattr(v, 'detach'):
            v = v.detach().cpu().numpy()
        return np.asarray(v)

    bn_leaf = {'weight': 'scale', 'bias': 'bias',
               'running_mean': 'mean', 'running_var': 'var'}

    for key, value in state_dict.items():
        value = to_np(value)

        if key == 'conv1.weight':
            out['conv1/kernel'] = value.transpose(2, 3, 1, 0)
        elif key.startswith('bn1.'):
            leaf = key.split('.', 1)[1]
            if leaf in bn_leaf:
                out['conv1_bn/' + bn_leaf[leaf]] = value
        else:
            m = re.match(r'layer(\d+)\.(\d+)\.(.+)', key)
            if not m:
                continue
            block = int(m.group(1))
            unit = int(m.group(2)) + 1
            rest = m.group(3)
            prefix = 'block{}_unit{}/'.format(block, unit)

            conv_m = re.match(r'conv(\d)\.weight', rest)
            bn_m = re.match(r'bn(\d)\.(.+)', rest)
            ds_conv = re.match(r'downsample\.0\.weight', rest)
            ds_bn = re.match(r'downsample\.1\.(.+)', rest)

            if conv_m:
                out[prefix + 'conv{}/kernel'.format(conv_m.group(1))] = \
                    value.transpose(2, 3, 1, 0)
            elif bn_m and bn_m.group(2) in bn_leaf:
                out[prefix + 'bn{}/{}'.format(
                    bn_m.group(1), bn_leaf[bn_m.group(2)])] = value
            elif ds_conv:
                out[prefix + 'shortcut/kernel'] = \
                    value.transpose(2, 3, 1, 0)
            elif ds_bn and ds_bn.group(1) in bn_leaf:
                out[prefix + 'shortcut_bn/' +
                    bn_leaf[ds_bn.group(1)]] = value
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--torch_weights', required=True,
                        help='Path to a torchvision ResNet .pth')
    parser.add_argument('--out_name', default='resnet101_kitti')
    args = parser.parse_args(argv)

    import torch
    state_dict = torch.load(args.torch_weights, map_location='cpu',
                            weights_only=True)
    if hasattr(state_dict, 'state_dict'):
        state_dict = state_dict.state_dict()

    converted = convert_state_dict(state_dict)

    out_dir = os.path.join(monopsr_torch.data_dir(), 'pretrained')
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, args.out_name + '.npz')
    np.savez(out_path, **converted)
    print('Wrote {} arrays to {}'.format(len(converted), out_path))


if __name__ == '__main__':
    main()
