"""MonoPSR network: dual towers + map heads + proposal/regression FC heads.

Frozen copy of the port's ``models/monopsr_net.py``, with the same
submodule and parameter names (``backbone``, ``proposal_fc``,
``regression_fc``, ``lwh``, ``alpha``, ...), so one state dict loads
into both.

Output-type coverage (canonical config monopsr_model_000.yaml):
    inst_xyz_map_local: 'map'     valid_mask_maps: 'mask' (always on)
    lwh: 'offset' | 'est' | 'gt'  alpha: 'dc' | 'dc_rotation' | 'prob' | 'gt'
    view_ang: 'est' | 'offset' | 'gt'  cen_x: 'from_view_ang_and_z'
    cen_y: 'offset' | 'est' | 'gt'     cen_z: 'offset' | 'direct'

Towers and decoder run in the compute dtype (bfloat16 in production);
parameters, the map heads and the FC trunks run in float32.
"""

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import constants
from benchmark.reference import class_stats
from benchmark.reference import feature_normalization as fn
from benchmark.reference.backbone import Resnet101_4xSquash
from benchmark.reference.resnet import Conv2d
from benchmark.reference import crop_resize
from benchmark.reference import device as device_lib
from benchmark.reference.grids import linspace


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """Static model configuration (field names as in the JAX package)."""
    num_boxes: int = 32
    num_alpha_bins: int = 12
    num_classes: int = 1
    image_input_shape: Tuple[int, int] = (320, 1216)
    resized_full_img_shape: Tuple[int, int] = (160, 608)
    img_roi_size: Tuple[int, int] = (48, 48)
    map_roi_size: Tuple[int, int] = (48, 48)
    proposal_fc_sizes: Tuple[int, ...] = (1024, 1024)
    regression_fc_sizes: Tuple[int, ...] = (1024, 1024)
    dropout_keep_prob: float = 1.0
    max_depth: float = 45.0
    mean_sub_type: str = 'kitti'
    output_stride: int = 4
    resnet: str = 'resnet101'
    compute_dtype: str = 'bfloat16'
    # A TPU layout knob of the JAX package, accepted and ignored here:
    # phase-space atrous convs are numerically plain dilated convs
    use_phase_space: bool = True
    # Output types
    lwh_type: str = 'offset'
    alpha_type: str = 'dc'
    view_ang_type: str = 'est'
    cen_y_type: str = 'offset'
    cen_z_type: str = 'offset'
    rotate_view: bool = True
    centroid_type: str = 'middle'
    xyz_from_depth: bool = False
    # Normalization of the appended prop_cen_y/z estimates in the
    # regression trunk: 'constant', 'by_class_mean' or 'none'
    appended_est_norm: str = 'constant'
    class_names: Tuple[str, ...] = ('Car',)

    @property
    def torch_dtype(self):
        return (torch.bfloat16 if self.compute_dtype == 'bfloat16'
                else torch.float32)


def _box_feature_concat(boxes_2d, view_angs, class_indices, cam_p,
                        image_shape, num_classes):
    """Shared normalized box/camera feature block for the FC trunks.

    boxes_2d (B, N, 4), view_angs (B, N, 1), class_indices (B, N, 1),
    cam_p (B, 3, 4). Returns a list of flat (B*N, F) feature blocks.
    """
    b, n = boxes_2d.shape[0], boxes_2d.shape[1]
    cu = cam_p[:, 0, 2][:, None, None]
    cv = cam_p[:, 1, 2][:, None, None]
    box_ij = boxes_2d - torch.cat([cv, cu, cv, cu], dim=-1)
    half = device_lib.constant([image_shape[0] / 2.0, image_shape[1] / 2.0,
                                image_shape[0] / 2.0, image_shape[1] / 2.0],
                               boxes_2d.dtype, boxes_2d.device)
    box_ij_norm = (box_ij / half).reshape(b * n, 4)

    box_h_norm = ((boxes_2d[:, :, 2] - boxes_2d[:, :, 0]) /
                  image_shape[0]).reshape(b * n, 1)

    # Class indices are 1-based (0 = background); an index equal to
    # num_classes maps to all zeros, as jax.nn.one_hot does
    classes = torch.arange(num_classes, device=boxes_2d.device)
    class_one_hot = (class_indices.reshape(b * n, 1) == classes).float()

    cam_norm = cam_p.reshape(b, 12) / device_lib.constant(
        [1000.0, 1.0, 1000.0, 100.0, 1.0, 1000.0, 1000.0, 1.0,
         1.0, 1.0, 1.0, 1.0], cam_p.dtype, cam_p.device)
    cam_tiled = cam_norm.repeat_interleave(n, dim=0)      # (B*N, 12)

    return [box_ij_norm, box_h_norm, view_angs.reshape(b * n, 1),
            class_one_hot, cam_tiled]


def _extras_width(num_classes):
    return 4 + 1 + 1 + num_classes + 12


class FCTrunk(nn.Module):
    """img_fc(1024) on flattened box features, concat extras, FC stack."""

    def __init__(self, in_features, extras_width, layer_sizes,
                 dropout_keep_prob=1.0):
        super().__init__()
        self.img_fc = nn.Linear(in_features, 1024)
        self.fc_names = []
        width = 1024 + extras_width
        for i, size in enumerate(layer_sizes):
            self.add_module('fc{}'.format(i), nn.Linear(width, size))
            self.fc_names.append('fc{}'.format(i))
            width = size
        self.out_features = width
        self.dropout = (nn.Dropout(1.0 - dropout_keep_prob)
                        if dropout_keep_prob < 1.0 else None)

    def forward(self, box_features, extras):
        # NHWC features flatten in (h, w, c) order, as in flax
        flat = box_features.reshape(box_features.shape[0], -1)
        x = torch.cat([F.relu(self.img_fc(flat))] + list(extras), dim=1)
        for name in self.fc_names:
            x = F.relu(getattr(self, name)(x))
            if self.dropout is not None:
                x = self.dropout(x)
        return x


class MonoPSRNet(nn.Module):
    """Full MonoPSR forward network over each image's proposal slots."""

    def __init__(self, cfg: NetConfig):
        super().__init__()
        self.cfg = cfg
        nb = cfg.num_alpha_bins
        self.backbone = Resnet101_4xSquash(
            map_roi_size=cfg.map_roi_size, output_stride=cfg.output_stride,
            resnet=cfg.resnet, dtype=cfg.torch_dtype)

        # Map heads
        self.inst_xyz_map_local = Conv2d(128, 3, 3, padding=1)
        self.valid_mask_maps = Conv2d(128, 1, 3, padding=1)

        # Box features: (map_roi/2) full crops, 2x2 pooled twice
        feat_h = cfg.map_roi_size[0] // 2 // 2 // 2
        feat_w = cfg.map_roi_size[1] // 2 // 2 // 2
        box_feat_width = feat_h * feat_w * 512
        extras = _extras_width(cfg.num_classes)

        self.proposal_fc = FCTrunk(box_feat_width, extras,
                                   cfg.proposal_fc_sizes,
                                   cfg.dropout_keep_prob)
        prop_w = self.proposal_fc.out_features
        if cfg.lwh_type == 'offset':
            self.lwh = nn.Linear(prop_w, 3)
        alpha_out = {'dc': 2 * nb, 'dc_rotation': 3 * nb, 'prob': nb}
        if cfg.alpha_type in alpha_out:
            self.alpha = nn.Linear(prop_w, alpha_out[cfg.alpha_type])
        if cfg.view_ang_type == 'offset':
            self.view_ang = nn.Linear(prop_w, 1)

        # Regression extras: lwh offsets (3), alpha bins and regs (2 nb),
        # normalized prop_cen_y and prop_cen_z (2)
        self.regression_fc = FCTrunk(box_feat_width, extras + 3 + 2 * nb + 2,
                                     cfg.regression_fc_sizes,
                                     cfg.dropout_keep_prob)
        reg_w = self.regression_fc.out_features
        if cfg.cen_y_type == 'offset':
            self.cen_y = nn.Linear(reg_w, 1)
        if cfg.cen_z_type in ('offset', 'direct'):
            self.cen_z = nn.Linear(reg_w, 1)

    def forward(self, image, boxes_2d, boxes_2d_norm, view_angs,
                class_indices, mean_lwh, prop_cen_z_offsets,
                cen_y_offsets, cam_p, gt_inputs=None):
        """
        Args:
            image: (H_in, W_in, 3) RGB image already resized to
                image_input_shape (raw 0-255 values; mean sub here), or
                (B, H_in, W_in, 3) for the batch-native multi-image path
                (every other arg then carries a leading B axis and
                outputs are (B, N, ...)).
            boxes_2d: (N, 4) [y1, x1, y2, x2] original-pixel boxes.
            boxes_2d_norm: (N, 4) boxes normalized by the image shape.
            view_angs: (N,) 2D-box viewing-angle estimates.
            class_indices: (N, 1) 1-based class indices.
            mean_lwh: (N, 3) per-class mean dimensions.
            prop_cen_z_offsets: (N,) per-class proposal depth offsets.
            cen_y_offsets: (N,) per-class cen_y trend offsets.
            cam_p: (3, 4) camera projection matrix.
            gt_inputs: optional dict of GT tensors, required only when an
                output type is 'gt' (keys: 'lwh' (N, 3), 'alpha_bins'
                (N,), 'alpha_regs' (N, nb), 'view_angs' (N, 1),
                'cen_y' (N, 1)).

        Returns:
            dict of outputs keyed by ``constants`` KEY_*.

        Train/eval mode (dropout, decoder batch norm) follows the module's
        ``train()``/``eval()`` state.
        """
        cfg = self.cfg
        batched = image.dim() == 4
        if not batched:
            image = image[None]
            boxes_2d = boxes_2d[None]
            boxes_2d_norm = boxes_2d_norm[None]
            view_angs = view_angs[None]
            class_indices = class_indices[None]
            mean_lwh = mean_lwh[None]
            prop_cen_z_offsets = prop_cen_z_offsets[None]
            cen_y_offsets = cen_y_offsets[None]
            cam_p = cam_p[None]
            if gt_inputs is not None:
                gt_inputs = {k: v[None] for k, v in gt_inputs.items()}

        b, n = boxes_2d.shape[0], boxes_2d.shape[1]

        def flat(x):
            return x.reshape((b * n,) + x.shape[2:])

        # Per-row (B*N,) camera scalars for the per-box geometry
        f_row = cam_p[:, 0, 0].repeat_interleave(n)
        cv_row = cam_p[:, 1, 2].repeat_interleave(n)
        x_offset_row = (-cam_p[:, 0, 3] / cam_p[:, 0, 0]).repeat_interleave(n)

        # Preprocess: mean subtraction
        means = (class_stats.KITTI_CHANNEL_MEANS
                 if cfg.mean_sub_type == 'kitti'
                 else class_stats.IMAGENET_CHANNEL_MEANS)
        img = image.float() - device_lib.constant(means, torch.float32,
                                                  image.device)

        # Per-box RGB crops and the resized full images
        rgb_crops = flat(crop_resize.crop_and_resize_bilinear(
            img, boxes_2d_norm, cfg.img_roi_size))    # (B*N, 48, 48, 3)
        full_imgs = crop_resize.resize_bilinear_align_corners(
            img, cfg.resized_full_img_shape)

        features_for_map, features_for_box_3d = self.backbone(
            rgb_crops, full_imgs, boxes_2d_norm)

        extras = _box_feature_concat(
            boxes_2d, view_angs[..., None], class_indices, cam_p,
            cfg.image_input_shape, cfg.num_classes)

        boxes_2d = flat(boxes_2d)
        view_angs = flat(view_angs)
        mean_lwh = flat(mean_lwh)
        prop_cen_z_offsets = flat(prop_cen_z_offsets)
        cen_y_offsets = flat(cen_y_offsets)
        if gt_inputs is not None:
            gt_inputs = {k: flat(v) for k, v in gt_inputs.items()}

        outputs = {}

        # Map heads (NHWC in and out)
        map_nchw = features_for_map.permute(0, 3, 1, 2)
        outputs[constants.KEY_INST_XYZ_MAP_LOCAL] = self.inst_xyz_map_local(
            map_nchw).permute(0, 2, 3, 1)
        outputs[constants.KEY_VALID_MASK_MAPS] = self.valid_mask_maps(
            map_nchw).permute(0, 2, 3, 1)

        # Proposal FC trunk
        view_angs_col = view_angs[:, None]
        prop_fc = self.proposal_fc(features_for_box_3d, extras)

        # lwh head
        if cfg.lwh_type == 'offset':
            lwh_offs = self.lwh(prop_fc)
            pred_lwh = mean_lwh + lwh_offs
        elif cfg.lwh_type == 'est':
            lwh_offs = mean_lwh
            pred_lwh = mean_lwh
        elif cfg.lwh_type == 'gt':
            pred_lwh = gt_inputs['lwh']
            lwh_offs = pred_lwh - mean_lwh
        else:
            raise NotImplementedError('lwh type ' + cfg.lwh_type)
        outputs[constants.KEY_LWH + '_offs'] = lwh_offs
        outputs[constants.KEY_LWH] = pred_lwh

        # alpha head
        nb = cfg.num_alpha_bins
        if cfg.alpha_type == 'dc':
            ori = self.alpha(prop_fc)
            outputs[constants.KEY_ALPHA_BINS] = ori[:, 0:nb]
            outputs[constants.KEY_ALPHA_REGS] = ori[:, nb:nb * 2]
        elif cfg.alpha_type == 'dc_rotation':
            # Bins + per-bin (sin, cos) residuals, L2-normalized then
            # decoded with atan2
            ori = self.alpha(prop_fc)
            comps = ori[:, nb:nb * 3].reshape(-1, nb, 2)
            comps = comps / torch.clamp(
                torch.linalg.norm(comps, dim=2, keepdim=True), min=1e-12)
            outputs[constants.KEY_ALPHA_BINS] = ori[:, 0:nb]
            outputs[constants.KEY_ALPHA_REGS] = torch.atan2(
                comps[:, :, 1], comps[:, :, 0])
        elif cfg.alpha_type == 'prob':
            bins = self.alpha(prop_fc)
            softmax = torch.softmax(bins, dim=-1)
            half_bin = math.pi / nb
            centres = linspace(half_bin, 2 * math.pi - half_bin, nb,
                               bins.device)
            comp = softmax @ torch.stack(
                [torch.cos(centres), torch.sin(centres)], dim=1)
            outputs[constants.KEY_ALPHA_BINS] = bins
            outputs[constants.KEY_ALPHA] = torch.atan2(
                comp[:, 1], comp[:, 0])[:, None]
        elif cfg.alpha_type == 'gt':
            # Debug passthrough: bin logits that argmax to the GT bin
            outputs[constants.KEY_ALPHA_BINS] = F.one_hot(
                gt_inputs['alpha_bins'].long(), nb).float() * 10.0
            outputs[constants.KEY_ALPHA_REGS] = gt_inputs['alpha_regs']
        else:
            raise NotImplementedError('alpha type ' + cfg.alpha_type)

        # Viewing-angle head
        if cfg.view_ang_type == 'est':
            pred_view_angs = view_angs_col
            view_ang_offs = torch.zeros_like(view_angs_col)
        elif cfg.view_ang_type == 'offset':
            view_ang_offs = self.view_ang(prop_fc)
            pred_view_angs = view_angs_col + view_ang_offs
        elif cfg.view_ang_type == 'gt':
            pred_view_angs = gt_inputs['view_angs']
            view_ang_offs = pred_view_angs - view_angs_col
        else:
            raise NotImplementedError('view_ang ' + cfg.view_ang_type)
        outputs[constants.KEY_VIEW_ANG + '_offs'] = view_ang_offs
        outputs[constants.KEY_VIEW_ANG] = pred_view_angs

        # Centroid proposals (flat-batch form of
        # instance.prop_cen_z_from_box_height / est_y_from_box_2d_and_depth
        # with per-row camera scalars)
        boxes_h = boxes_2d[:, 2] - boxes_2d[:, 0]
        prop_cen_z = (f_row * pred_lwh[:, 2] / boxes_h
                      + prop_cen_z_offsets)[:, None]
        outputs[constants.KEY_PROP_CEN_Z] = prop_cen_z
        centre_v = ((boxes_2d[:, 2] + boxes_2d[:, 0]) / 2.0 - cv_row)[:, None]
        prop_cen_y = (centre_v * (prop_cen_z / f_row[:, None])
                      - cen_y_offsets.reshape(-1, 1))

        # Regression FC trunk with appended early estimates
        if cfg.appended_est_norm == 'constant':
            prop_cen_y_norm = prop_cen_y / class_stats.PROP_CEN_Y_NORM
            prop_cen_z_norm = prop_cen_z / cfg.max_depth
        elif cfg.appended_est_norm == 'by_class_mean':
            prop_cen_y_norm = fn.normalize_cen_y_by_mean(
                prop_cen_y, class_indices, cfg.class_names)
            prop_cen_z_norm = fn.normalize_cen_z_by_mean(
                prop_cen_z, class_indices, cfg.class_names)
        else:
            prop_cen_y_norm = prop_cen_y
            prop_cen_z_norm = prop_cen_z
        reg_extras = extras + [
            lwh_offs,
            outputs[constants.KEY_ALPHA_BINS],
            outputs.get(constants.KEY_ALPHA_REGS,
                        torch.zeros_like(outputs[constants.KEY_ALPHA_BINS])),
            prop_cen_y_norm,
            prop_cen_z_norm,
        ]
        reg_fc = self.regression_fc(features_for_box_3d, reg_extras)

        # cen_y head
        if cfg.cen_y_type == 'offset':
            cen_y_offs = self.cen_y(reg_fc)
            pred_cen_y = prop_cen_y + cen_y_offs
        elif cfg.cen_y_type == 'est':
            cen_y_offs = torch.zeros_like(prop_cen_y)
            pred_cen_y = prop_cen_y
        elif cfg.cen_y_type == 'gt':
            pred_cen_y = gt_inputs['cen_y']
            cen_y_offs = pred_cen_y - prop_cen_y
        else:
            raise NotImplementedError('cen_y ' + cfg.cen_y_type)
        outputs[constants.KEY_CEN_Y + '_offs'] = cen_y_offs
        outputs[constants.KEY_CEN_Y] = pred_cen_y
        outputs['prop_cen_y'] = prop_cen_y

        # cen_z head
        if cfg.cen_z_type == 'offset':
            cen_z_offs = self.cen_z(reg_fc)
            pred_cen_z = prop_cen_z + cen_z_offs
        elif cfg.cen_z_type == 'direct':
            pred_cen_z = self.cen_z(reg_fc)
            cen_z_offs = pred_cen_z - prop_cen_z
        else:
            raise NotImplementedError('cen_z ' + cfg.cen_z_type)
        outputs[constants.KEY_CEN_Z + '_offs'] = cen_z_offs
        outputs[constants.KEY_CEN_Z] = pred_cen_z

        # cen_x from viewing angle and depth
        pred_cen_x = (pred_cen_z * torch.tan(pred_view_angs)
                      + x_offset_row[:, None])
        outputs[constants.KEY_CEN_X] = pred_cen_x

        outputs[constants.KEY_CENTROIDS] = torch.cat(
            [pred_cen_x, pred_cen_y, pred_cen_z], dim=1)

        if batched:
            outputs = {k: v.reshape((b, n) + v.shape[1:])
                       for k, v in outputs.items()}
        return outputs
