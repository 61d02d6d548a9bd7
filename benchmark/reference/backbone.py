"""Dual-tower feature extraction: resnet101_4x_squash.

Frozen copy of the port's ``models/backbone.py`` for one process: two ResNet stride-4
encoders (48x48 RGB crops per box, resized full image), per-box crop of
the full-image features, concat, 1x1 squash conv + max pool for box
features, and a 2-stage resize+conv decoder for 48x48 map features.

Batch-native like the JAX module: the crop tower and everything per box
run on one flat (B*N) axis, the full-image tower on a true (B,) batch.
Public layout is NHWC; convs run NCHW inside.
"""

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.resnet import RESNET_SPECS, Conv2d, ResNetV1
from benchmark.reference import crop_resize


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class DecoderBatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.997, epsilon=1e-5)`` on NCHW input.

    Eval mode normalizes with the running statistics. Train mode follows
    flax 0.12 (``use_fast_variance=True``), not torch: the batch mean and
    the BIASED variance mean(x^2) - mean(x)^2 (clamped at 0), both in
    float32, normalize the batch, with the gradient flowing through
    them; the running statistics become 0.997 * old + 0.003 * batch.
    (``nn.BatchNorm2d`` itself would update ``running_var`` with the
    unbiased variance.) The output is float32; the caller casts.

    One process: the batch statistics are this process's batch.
    """

    def __init__(self, features):
        super().__init__(features, eps=1e-5, momentum=0.003)

    def forward(self, x):
        x = x.float()
        if not self.training:
            return super().forward(x)
        axes = (0, 2, 3)
        mean = x.mean(axes)
        var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.copy_(0.997 * self.running_mean +
                                    (1.0 - 0.997) * mean)
            self.running_var.copy_(0.997 * self.running_var +
                                   (1.0 - 0.997) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None] +
                self.bias[:, None, None])


class MapDecoder(nn.Module):
    """resize -> 2x conv3x3(256) BN -> resize -> 2x conv3x3(128) BN.

    The batch norms follow the module's train/eval mode like flax's
    ``use_running_average=not train`` (``DecoderBatchNorm``); they
    normalize in float32 and cast back to the compute dtype, as flax
    does.
    """

    def __init__(self, in_channels=512, map_roi_size=(48, 48),
                 dtype=torch.bfloat16):
        super().__init__()
        self.map_roi_size = tuple(map_roi_size)
        self.dtype = dtype
        channels = in_channels
        for stage, width in ((2, 256), (3, 128)):
            for i in range(2):
                name = 'conv{}_{}'.format(stage, i + 1)
                self.add_module(name, Conv2d(channels, width, 3, padding=1))
                self.add_module(name + '_bn', DecoderBatchNorm(width))
                channels = width

    def _stage(self, x, stage):
        x = _nchw(x).to(self.dtype)
        for i in range(2):
            name = 'conv{}_{}'.format(stage, i + 1)
            x = getattr(self, name)(x)
            x = getattr(self, name + '_bn')(x).to(self.dtype)
            x = F.relu(x)
        return _nhwc(x)

    def forward(self, x):
        """(N, h, w, C) NHWC -> (N, roi_h, roi_w, 128) compute dtype."""
        half = (self.map_roi_size[0] // 2, self.map_roi_size[1] // 2)
        x = self._stage(crop_resize.resize_bilinear_align_corners(x, half), 2)
        x = crop_resize.resize_bilinear_align_corners(x, self.map_roi_size)
        return self._stage(x, 3)


class Resnet101_4xSquash(nn.Module):
    """Two-tower encoder producing map features and box-3d features.

    Returns (from forward):
        features_for_map: (B*N, 48, 48, 128) float32
        features_for_box_3d: (B*N, 6, 6, 512) float32
    """

    def __init__(self, map_roi_size=(48, 48), output_stride=4,
                 resnet='resnet101', dtype=torch.bfloat16):
        super().__init__()
        spec = RESNET_SPECS[resnet]
        self.map_roi_size = tuple(map_roi_size)
        self.dtype = dtype
        self.tower_crop = ResNetV1(spec, output_stride, dtype=dtype)
        self.tower_full = ResNetV1(spec, output_stride, dtype=dtype)
        tower_ch = self.tower_crop.out_channels
        self.squash_1x1 = Conv2d(2 * tower_ch, 512, 1)
        self.map_decoder = MapDecoder(512, map_roi_size, dtype)

    def forward(self, rgb_crops, full_imgs, boxes_2d_norm):
        """
        Args:
            rgb_crops: (B*N, 48, 48, 3) preprocessed per-box crops.
            full_imgs: (B, H, W, 3) preprocessed resized full images.
            boxes_2d_norm: (B, N, 4) normalized boxes for feature crops.
        """
        b, n = boxes_2d_norm.shape[0], boxes_2d_norm.shape[1]
        crop_feats = self.tower_crop.forward_nchw(_nchw(rgb_crops))
        full_feats = self.tower_full(full_imgs)       # (B, H/4, W/4, C)

        # Per-box crop of the full-image features: crop_and_resize to
        # half the map ROI, then 2x2 max pool
        half = (self.map_roi_size[0] // 2, self.map_roi_size[1] // 2)
        full_crops = crop_resize.crop_and_resize_bilinear(
            full_feats, boxes_2d_norm.float(), half)
        full_crops = full_crops.reshape((b * n,) + full_crops.shape[2:])
        full_crops = F.max_pool2d(_nchw(full_crops), 2, 2)

        concat = torch.cat([crop_feats, full_crops.to(self.dtype)], dim=1)
        squashed = F.relu(self.squash_1x1(concat))
        pooled = F.max_pool2d(squashed, 2, 2)

        map_features = self.map_decoder(_nhwc(squashed))
        return map_features.float(), _nhwc(pooled).float()
