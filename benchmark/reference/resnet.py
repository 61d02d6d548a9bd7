"""ResNet v1 backbone with slim-style output_stride (atrous) semantics.

Frozen copy of the port's ``models/resnet.py`` without its remat
paths (the reference keeps every activation). Same module and parameter
names. Semantics reproduced:

- root: 7x7/2 conv (fixed symmetric pad) + 3x3/2 SAME max pool -> stride 4.
  TF SAME pads the end at least as much as the start, so the pool pads
  explicitly with -inf (``nn.MaxPool2d(padding=1)`` would pad both sides).
- bottleneck units with the stride on the middle 3x3 conv, the block's
  nominal stride on its LAST unit; a stride-s identity shortcut is a
  1x1 max pool, i.e. a subsample.
- atrous mode: once the accumulated stride reaches ``output_stride``,
  every later unit runs at stride 1 and its nominal stride multiplies
  the dilation rate instead.
- batch norm with frozen statistics (inference mode) and trainable
  scale/offset.

The JAX package runs atrous units in "phase space" (space-to-batch), a
TPU layout trick that is numerically identical to a dilated conv; this
port uses the plain dilated conv.

Public layout is NHWC (as in JAX); the stack runs NCHW inside. Convs run
in the compute dtype with float32 parameters: each conv casts its input
and kernel to the compute dtype, as flax does with ``dtype=bfloat16``.
"""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

# (num_units, bottleneck_depth) per block; output depth = 4x bottleneck
RESNET_SPECS = {
    'resnet50': ((3, 64), (4, 128), (6, 256), (3, 512)),
    'resnet101': ((3, 64), (4, 128), (23, 256), (3, 512)),
    'resnet152': ((3, 64), (8, 128), (36, 256), (3, 512)),
    # Tiny spec for CPU tests and fast iteration (same topology rules)
    'resnet_tiny': ((1, 4), (1, 8), (1, 16), (1, 32)),
}


def round_to_fp8(x):
    """``x`` rounded to float8 e4m3 under one per-tensor scale (its
    largest magnitude to e4m3's 448) and back to its dtype; the gradient
    passes through unchanged."""
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / 448.0
    q = ((x.detach().float() / scale).to(torch.float8_e4m3fn).float()
         * scale).to(x.dtype)
    return x + (q - x).detach()


class Conv2d(nn.Conv2d):
    """nn.Conv2d that computes in its input's dtype (float32 params).

    ``lower_precision = 'fp8'`` (set on a control's net, never on the
    reference's) rounds a bfloat16 convolution's input and kernel to
    float8 e4m3 first: the precision one step below bfloat16."""

    lower_precision = None

    def forward(self, x):
        weight = self.weight.to(x.dtype)
        if self.lower_precision == 'fp8' and x.dtype == torch.bfloat16:
            x, weight = round_to_fp8(x), round_to_fp8(weight)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, weight, bias)


class FrozenBatchNorm(nn.Module):
    """Batch norm with frozen statistics and trainable scale/offset.

    ``mean``/``var`` are buffers (loaded from pretrained weights, never
    updated); ``scale``/``bias`` are parameters. NCHW input.
    """

    def __init__(self, features, epsilon=1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('mean', torch.zeros(features))
        self.register_buffer('var', torch.ones(features))

    def forward(self, x):
        # Fold into one multiply-add, computed in float32 then cast
        root = torch.sqrt(self.var + self.epsilon)
        inv = (self.scale / root).to(x.dtype)
        b = (self.bias - self.mean * self.scale / root).to(x.dtype)
        return x * inv[:, None, None] + b[:, None, None]


def conv_same(in_ch, out_ch, kernel, stride, rate, bias=False):
    """slim conv2d_same: plain SAME for stride 1, a fixed symmetric pad
    then VALID for stride > 1. Both are symmetric for the odd kernels
    used here, so either is one nn.Conv2d padding."""
    if kernel % 2 != 1:
        raise ValueError('conv_same takes odd kernels, got {}'.format(kernel))
    k_eff = kernel + (kernel - 1) * (rate - 1)
    return Conv2d(in_ch, out_ch, kernel, stride=stride,
                  padding=(k_eff - 1) // 2, dilation=rate, bias=bias)


def max_pool_same(x, window, stride):
    """TF SAME max pool on NCHW: pad the end >= the start, with -inf."""
    pads = []
    for size in (x.shape[3], x.shape[2]):     # F.pad order: W then H
        out = -(-size // stride)
        total = max((out - 1) * stride + window - size, 0)
        pads += [total // 2, total - total // 2]
    x = F.pad(x, pads, value=float('-inf'))
    return F.max_pool2d(x, window, stride)


class Bottleneck(nn.Module):
    """ResNet v1 bottleneck: 1x1 -> 3x3(stride, rate) -> 1x1 + shortcut."""

    def __init__(self, depth_in, depth, depth_bottleneck, stride, rate):
        super().__init__()
        self.stride = stride
        self.has_shortcut_conv = depth_in != depth
        if self.has_shortcut_conv:
            self.shortcut = Conv2d(depth_in, depth, 1, stride=stride,
                                   bias=False)
            self.shortcut_bn = FrozenBatchNorm(depth)
        self.conv1 = Conv2d(depth_in, depth_bottleneck, 1, bias=False)
        self.bn1 = FrozenBatchNorm(depth_bottleneck)
        self.conv2 = conv_same(depth_bottleneck, depth_bottleneck, 3,
                               stride, rate)
        self.bn2 = FrozenBatchNorm(depth_bottleneck)
        self.conv3 = Conv2d(depth_bottleneck, depth, 1, bias=False)
        self.bn3 = FrozenBatchNorm(depth)

    def forward(self, x):
        if self.has_shortcut_conv:
            shortcut = self.shortcut_bn(self.shortcut(x))
        elif self.stride == 1:
            shortcut = x
        else:
            # 1x1 max pool with stride s == subsample
            shortcut = x[:, :, ::self.stride, ::self.stride]
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(shortcut + y)


class ResNetV1(nn.Module):
    """ResNet v1 trunk up to (and including) block ``num_blocks``.

    Args:
        spec: per-block (num_units, bottleneck_depth) tuples.
        output_stride: requested input/output resolution ratio.
        num_blocks: how many blocks to run (3 taps block3).
        dtype: compute dtype (params stay float32).
        in_channels: input channels (3 for RGB).
    """

    def __init__(self, spec: Sequence = RESNET_SPECS['resnet101'],
                 output_stride=4, num_blocks=3, dtype=torch.bfloat16,
                 in_channels=3):
        super().__init__()
        self.dtype = dtype
        self.conv1 = conv_same(in_channels, 64, 7, 2, 1)
        self.conv1_bn = FrozenBatchNorm(64)

        self.unit_names = []
        depth_in = 64
        current_stride = 4
        rate = 1
        for block_idx, (num_units, depth_bottleneck) in enumerate(
                spec[:num_blocks]):
            depth = depth_bottleneck * 4
            for unit_idx in range(num_units):
                nominal_stride = 2 if unit_idx == num_units - 1 else 1
                if (output_stride is not None and
                        current_stride == output_stride):
                    unit_stride, unit_rate = 1, rate
                    rate *= nominal_stride
                else:
                    unit_stride, unit_rate = nominal_stride, 1
                    current_stride *= nominal_stride
                name = 'block{}_unit{}'.format(block_idx + 1, unit_idx + 1)
                self.add_module(name, Bottleneck(
                    depth_in, depth, depth_bottleneck, unit_stride,
                    unit_rate))
                self.unit_names.append(name)
                depth_in = depth
        self.out_channels = depth_in

    def forward_nchw(self, x):
        """NCHW in, NCHW out (compute dtype)."""
        x = x.to(self.dtype)
        x = F.relu(self.conv1_bn(self.conv1(x)))
        x = max_pool_same(x, 3, 2)
        for name in self.unit_names:
            x = getattr(self, name)(x)
        return x

    def forward(self, x):
        """(N, H, W, C) -> (N, H/s, W/s, out_channels), compute dtype."""
        return self.forward_nchw(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
