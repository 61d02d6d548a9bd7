"""MonoPSR model orchestration: forward inputs, GT assembly, losses, metrics.

Frozen copy of the port's ``models/monopsr.py`` (the net is built and
its weights made by the benchmark, not here). Every batch, output and GT tensor carries a leading axis B
(boxes are (B, N, ...), cameras (B, 3, 4)), and losses and metrics come
back per sample, as the vmapped JAX step returns them.
"""

import torch

from benchmark.reference import constants
from benchmark.reference import instance, projection
from benchmark.reference import losses as loss_lib
from benchmark.reference.monopsr_net import NetConfig
from benchmark.reference import chamfer as chamfer_ops
from benchmark.reference import emd as emd_ops

C = constants


def decode_device_sample(batch):
    """Upcasts compactly-encoded device inputs to compute dtypes.

    uint8 image -> float32, uint16 depth (metres * 256) -> float32
    metres, uint8 instance image -> int32. torch's uint16 support is
    thin, so the depth map is widened to int32 before the float decode.
    No-op on already-decoded batches.
    """
    out = dict(batch)
    image = out.get('image')
    if image is not None and image.dtype == torch.uint8:
        out['image'] = image.float()
    depth = out.get(C.SAMPLE_DEPTH_MAP)
    if depth is not None and depth.dtype == torch.uint16:
        wide = depth.view(torch.int16).to(torch.int32) & 0xFFFF
        out[C.SAMPLE_DEPTH_MAP] = wide.float() / 256.0
    inst = out.get(C.SAMPLE_INSTANCE_IMAGE)
    if inst is not None and inst.dtype == torch.uint8:
        out[C.SAMPLE_INSTANCE_IMAGE] = inst.to(torch.int32)
    return out


# Sample keys the forward pass consumes (net_inputs_from_batch); GT-only
# keys are not in this set, so inference paths can skip shipping them.
NET_INPUT_SAMPLE_KEYS = (
    'image',
    C.SAMPLE_LABEL_BOXES_2D, C.SAMPLE_LABEL_BOXES_2D_NORM,
    C.SAMPLE_VIEWING_ANGLES_2D, C.SAMPLE_LABEL_CLASS_INDICES,
    C.SAMPLE_MEAN_LWH, C.SAMPLE_PROP_CEN_Z_OFFSET,
    C.SAMPLE_CEN_Y_OFFSETS, C.SAMPLE_CAM_P,
)


def net_inputs_from_batch(batch):
    """Extracts the MonoPSRNet call arguments from a sample batch dict."""
    batch = decode_device_sample(batch)
    return dict(
        image=batch['image'],
        boxes_2d=batch[C.SAMPLE_LABEL_BOXES_2D],
        boxes_2d_norm=batch[C.SAMPLE_LABEL_BOXES_2D_NORM],
        view_angs=batch[C.SAMPLE_VIEWING_ANGLES_2D],
        class_indices=batch[C.SAMPLE_LABEL_CLASS_INDICES],
        mean_lwh=batch[C.SAMPLE_MEAN_LWH],
        prop_cen_z_offsets=batch[C.SAMPLE_PROP_CEN_Z_OFFSET],
        cen_y_offsets=batch[C.SAMPLE_CEN_Y_OFFSETS],
        cam_p=batch[C.SAMPLE_CAM_P],
    )


def build_gt_dict(cfg: NetConfig, batch, outputs):
    """Assembles the ground-truth dict for a (B,) batch.

    Offset targets intentionally depend on live predictions (e.g. gt lwh
    offsets = gt_lwh - pred_lwh), as in the reference.
    """
    batch = decode_device_sample(batch)
    cam_p = batch[C.SAMPLE_CAM_P]
    boxes_2d = batch[C.SAMPLE_LABEL_BOXES_2D]
    boxes_3d = batch[C.SAMPLE_LABEL_BOXES_3D]
    view_angs_2d = batch[C.SAMPLE_VIEWING_ANGLES_2D]

    gt = {}

    # GT instance crops (local + global) from the depth map
    def crop(view_norm):
        return instance.instance_xyz_crop_from_depth_map(
            batch[C.SAMPLE_DEPTH_MAP], batch[C.SAMPLE_INSTANCE_IMAGE],
            batch[C.SAMPLE_INSTANCE_INDICES], boxes_2d, boxes_3d,
            view_angs_2d, cam_p, cfg.map_roi_size, view_norm=view_norm,
            centroid_type=cfg.centroid_type, rotate_view=cfg.rotate_view)

    gt_local, gt_valid = crop(True)
    gt_global, _ = crop(False)
    gt[C.KEY_INST_XYZ_MAP_LOCAL] = gt_local
    gt[C.KEY_INST_XYZ_MAP_GLOBAL] = gt_global
    gt[C.KEY_VALID_MASK_MAPS] = gt_valid

    # Box ground truth
    gt_cen_x = boxes_3d[..., 0:1]
    if cfg.centroid_type == 'middle':
        gt_cen_y = boxes_3d[..., 1:2] - boxes_3d[..., 5:6] / 2.0
    else:
        gt_cen_y = boxes_3d[..., 1:2]
    gt_cen_z = boxes_3d[..., 2:3]

    gt[C.KEY_CENTROIDS] = torch.cat([gt_cen_x, gt_cen_y, gt_cen_z], dim=-1)
    gt[C.KEY_LWH] = boxes_3d[..., 3:6]
    gt[C.KEY_ALPHA] = batch[C.SAMPLE_ALPHAS][..., None]
    gt[C.KEY_ALPHA_BINS] = batch[C.SAMPLE_ALPHA_BINS]
    gt[C.KEY_ALPHA_REGS] = batch[C.SAMPLE_ALPHA_REGS]
    gt['alpha_valid_bins'] = batch[C.SAMPLE_ALPHA_VALID_BINS]
    gt[C.KEY_VIEW_ANG] = batch[C.SAMPLE_VIEWING_ANGLES_3D][..., None]

    # Offset targets (live-prediction-coupled, see docstring)
    gt[C.KEY_LWH + '_offs'] = gt[C.KEY_LWH] - outputs[C.KEY_LWH]
    gt[C.KEY_VIEW_ANG + '_offs'] = (
        gt[C.KEY_VIEW_ANG] - view_angs_2d[..., None])
    gt[C.KEY_CEN_Y + '_offs'] = gt_cen_y - outputs['prop_cen_y']
    gt[C.KEY_CEN_Z + '_offs'] = gt_cen_z - outputs[C.KEY_PROP_CEN_Z]
    gt[C.KEY_CEN_Y] = gt_cen_y
    gt[C.KEY_CEN_Z] = gt_cen_z

    return gt


def add_global_outputs(cfg: NetConfig, batch, outputs, gt):
    """Global xyz/depth maps and the projection-alignment error.

    The predicted local xyz map is placed at
    [cen_z*tan(gt_view), pred_cen_y, pred_cen_z], rotated by the GT
    viewing angle, projected through cam_p, and compared against the
    expected ROI pixel grid. Returns new (outputs, gt) dicts.
    """
    outputs, gt = dict(outputs), dict(gt)
    cam_p = batch[C.SAMPLE_CAM_P]
    boxes_2d = batch[C.SAMPLE_LABEL_BOXES_2D]
    gt_view_angs = gt[C.KEY_VIEW_ANG]

    pred_local = outputs[C.KEY_INST_XYZ_MAP_LOCAL]
    pred_cen_y = outputs[C.KEY_CEN_Y]
    pred_cen_z = outputs[C.KEY_CEN_Z]

    x_offset = (-cam_p[:, 0, 3] / cam_p[:, 0, 0])[:, None, None]
    proj_cen_x = pred_cen_z * torch.tan(gt_view_angs) + x_offset
    proj_cen = torch.cat([proj_cen_x, pred_cen_y, pred_cen_z], dim=-1)

    pred_global = instance.inst_xyz_map_local_to_global(
        pred_local, gt_view_angs, proj_cen)
    outputs[C.KEY_INST_XYZ_MAP_GLOBAL] = pred_global

    outputs['proj_err_norm'] = instance.proj_err_maps_norm(
        pred_global, boxes_2d, gt[C.KEY_VALID_MASK_MAPS], cam_p,
        cfg.map_roi_size)

    # Global depth maps
    pred_local_depth = pred_local[..., 2:3]
    outputs[C.KEY_INST_DEPTH_MAP_GLOBAL] = (
        instance.inst_depth_map_local_to_global(
            pred_local_depth, pred_cen_z, boxes_2d,
            outputs[C.KEY_VIEW_ANG], cfg.map_roi_size, cam_p,
            rotate_view=cfg.rotate_view))
    gt[C.KEY_INST_DEPTH_MAP_GLOBAL] = gt[C.KEY_INST_XYZ_MAP_GLOBAL][..., 2:3]

    # xyz-from-depth variant: backproject the predicted global depth map
    # over the box ROI pixel grid; GT is the global instance xyz crop
    if cfg.xyz_from_depth:
        depth_global = outputs[C.KEY_INST_DEPTH_MAP_GLOBAL][..., 0]
        outputs[C.KEY_INST_XYZ_MAP_GLOBAL_FROM_DEPTH] = (
            projection.depth_patch_to_pc_map_batch(
                depth_global, boxes_2d, cam_p, cfg.map_roi_size))
        gt[C.KEY_INST_XYZ_MAP_GLOBAL_FROM_DEPTH] = (
            gt[C.KEY_INST_XYZ_MAP_GLOBAL])

    return outputs, gt


def _per_sample_sum(x):
    return x.reshape(x.shape[0], -1).sum(1)


def compute_losses(cfg: NetConfig, loss_config, outputs, gt):
    """Full loss stack, per sample.

    Args:
        loss_config: dict of {name: [loss_type, weight, ...]} from YAML.

    Returns:
        (losses_dict, total_loss), each entry of shape (B,).
    """
    num_boxes = cfg.num_boxes
    roi_pixels = cfg.map_roi_size[0] * cfg.map_roi_size[1]
    pred_local = outputs[C.KEY_INST_XYZ_MAP_LOCAL]
    b = pred_local.shape[0]
    ones_mask = pred_local.new_ones((b, num_boxes, 1))

    def box_loss(name, pred, target, mask=ones_mask):
        return _per_sample_sum(loss_lib.apply_loss(
            loss_config[name], pred, target, mask)) / num_boxes

    losses = {}
    total = 0.0

    # Local instance xyz maps
    xyz_loss = loss_lib.apply_loss(
        loss_config['inst_xyz_map_local'], pred_local,
        gt[C.KEY_INST_XYZ_MAP_LOCAL], gt[C.KEY_VALID_MASK_MAPS]) / num_boxes
    losses[C.KEY_INST_XYZ_MAP_LOCAL] = xyz_loss
    total += xyz_loss

    # Valid mask maps: label smoothing, per-pixel normalize, sum over N
    gt_masks_smoothed = gt[C.KEY_VALID_MASK_MAPS] * 0.998 + 0.001
    mask_map_loss = loss_lib.apply_loss(
        loss_config['valid_mask_maps'], outputs[C.KEY_VALID_MASK_MAPS],
        gt_masks_smoothed, torch.ones_like(gt_masks_smoothed))
    mask_loss = _per_sample_sum(mask_map_loss.sum(dim=(2, 3)) / roi_pixels)
    losses[C.KEY_VALID_MASK_MAPS] = mask_loss
    total += mask_loss

    # lwh offsets
    if cfg.lwh_type == 'offset':
        lwh_loss = box_loss('lwh', outputs[C.KEY_LWH + '_offs'],
                            gt[C.KEY_LWH + '_offs'])
        losses[C.KEY_LWH + '_offs'] = lwh_loss
        total += lwh_loss

    nb = cfg.num_alpha_bins
    eye = torch.eye(nb, device=pred_local.device)
    # alpha (discrete-continuous)
    if cfg.alpha_type in ('dc', 'dc_rotation'):
        eps = loss_config['alpha_cls'][2]
        one_hot = (eye[gt[C.KEY_ALPHA_BINS].long()] *
                   (1.0 - eps - eps / nb) + eps / nb)
        bins_loss = box_loss('alpha_cls', outputs[C.KEY_ALPHA_BINS], one_hot)
        regs_loss = box_loss('alpha_reg', outputs[C.KEY_ALPHA_REGS],
                             gt[C.KEY_ALPHA_REGS], gt['alpha_valid_bins'])
        losses[C.KEY_ALPHA_BINS] = bins_loss
        losses[C.KEY_ALPHA_REGS] = regs_loss
        total += bins_loss + regs_loss

    # alpha (prob variant): softmax-temperature CE on the bin logits vs
    # one-hot GT bins, plus regression on the decoded alpha vs GT alpha
    elif cfg.alpha_type == 'prob':
        one_hot = eye[gt[C.KEY_ALPHA_BINS].long()]
        bins_loss = box_loss('alpha_cls_temp', outputs[C.KEY_ALPHA_BINS],
                             one_hot)
        alpha_reg_loss = box_loss('alpha_reg', outputs[C.KEY_ALPHA],
                                  gt[C.KEY_ALPHA])
        losses[C.KEY_ALPHA_BINS] = bins_loss
        losses[C.KEY_ALPHA] = alpha_reg_loss
        total += bins_loss + alpha_reg_loss

    # cen_z offsets
    if cfg.cen_z_type == 'offset':
        cen_z_loss = box_loss('cen_z', outputs[C.KEY_CEN_Z + '_offs'],
                              gt[C.KEY_CEN_Z + '_offs'])
        losses[C.KEY_CEN_Z + '_offs'] = cen_z_loss
        total += cen_z_loss

    # view angle offsets
    if cfg.view_ang_type == 'offset':
        va_loss = box_loss('view_ang', outputs[C.KEY_VIEW_ANG + '_offs'],
                           gt[C.KEY_VIEW_ANG + '_offs'])
        losses[C.KEY_VIEW_ANG + '_offs'] = va_loss
        total += va_loss

    # cen_y offsets
    if cfg.cen_y_type == 'offset':
        cen_y_loss = box_loss('cen_y', outputs[C.KEY_CEN_Y + '_offs'],
                              gt[C.KEY_CEN_Y + '_offs'])
        losses[C.KEY_CEN_Y + '_offs'] = cen_y_loss
        total += cen_y_loss

    # Projection-alignment loss: a sum over boxes with no /num_boxes, as
    # the reference's implicit-sum gradient gives
    if 'proj_err_norm' in outputs:
        proj_err = outputs['proj_err_norm'].reshape(b, -1, 1)
        proj_loss = _per_sample_sum(loss_lib.apply_loss(
            loss_config['inst_xyz_map_global'], proj_err,
            torch.zeros_like(proj_err), ones_mask))
        losses['proj_err'] = proj_loss
        total += proj_loss

    # Global depth maps
    if C.KEY_INST_DEPTH_MAP_GLOBAL in outputs:
        depth_loss = loss_lib.apply_loss(
            loss_config['inst_depth_map_global'],
            outputs[C.KEY_INST_DEPTH_MAP_GLOBAL],
            gt[C.KEY_INST_DEPTH_MAP_GLOBAL],
            gt[C.KEY_VALID_MASK_MAPS]) / num_boxes
        losses[C.KEY_INST_DEPTH_MAP_GLOBAL] = depth_loss
        total += depth_loss

    # xyz-from-depth global maps, masked by the valid-mask maps
    if C.KEY_INST_XYZ_MAP_GLOBAL_FROM_DEPTH in outputs:
        from_depth_loss = loss_lib.apply_loss(
            loss_config[C.KEY_INST_XYZ_MAP_GLOBAL_FROM_DEPTH],
            outputs[C.KEY_INST_XYZ_MAP_GLOBAL_FROM_DEPTH],
            gt[C.KEY_INST_XYZ_MAP_GLOBAL_FROM_DEPTH],
            gt[C.KEY_VALID_MASK_MAPS]) / num_boxes
        losses[C.KEY_INST_XYZ_MAP_GLOBAL_FROM_DEPTH] = from_depth_loss
        total += from_depth_loss

    losses['total_loss'] = total
    return losses, total


def slice_box_slots(tree, num_boxes, max_slots):
    """Truncates every per-box leaf ((B, num_boxes, ...)) to max_slots
    slots. Downstream consumers only read [0:num_objs] rows, so any
    max_slots >= the batch's max num_objs is lossless."""
    if max_slots is None or max_slots >= num_boxes:
        return tree
    return {k: (v[:, :max_slots] if (torch.is_tensor(v) and v.dim() >= 2
                                     and v.shape[1] == num_boxes) else v)
            for k, v in tree.items()}


def pack_outputs_for_host(outputs, num_boxes=None, max_slots=None):
    """Shrinks the output dict for device->host transfer.

    The instance xyz maps are saved as float16 anyway and the mask logits
    are only ever thresholded at 0, so cast/threshold on device. With
    num_boxes + max_slots, also truncates the per-box axis to max_slots
    slots. Host consumers see identical results.
    """
    packed = dict(outputs)
    if C.KEY_INST_XYZ_MAP_LOCAL in packed:
        packed[C.KEY_INST_XYZ_MAP_LOCAL] = (
            packed[C.KEY_INST_XYZ_MAP_LOCAL].to(torch.float16))
    if C.KEY_VALID_MASK_MAPS in packed:
        packed[C.KEY_VALID_MASK_MAPS] = packed[C.KEY_VALID_MASK_MAPS] > 0.0
    # Train/val-only diagnostic maps are recomputable host-side
    packed.pop(C.KEY_INST_XYZ_MAP_GLOBAL, None)
    packed.pop(C.KEY_INST_DEPTH_MAP_GLOBAL, None)
    packed.pop(C.KEY_INST_XYZ_MAP_GLOBAL_FROM_DEPTH, None)
    if num_boxes is not None:
        packed = slice_box_slots(packed, num_boxes, max_slots)
    return packed


def compute_metrics(cfg: NetConfig, outputs, gt):
    """Eval metrics per box slot, (B, N[, 3]) each; the caller slices
    [0:num_objs] host-side like the reference.

    The EMD metric runs once over all B * N cloud pairs (one launch of
    the K1 kernel on CUDA).
    """
    metrics = {}
    num_boxes = cfg.num_boxes

    valid = gt[C.KEY_VALID_MASK_MAPS]
    b = valid.shape[0]
    pred_pts = (outputs[C.KEY_INST_XYZ_MAP_LOCAL] * valid).reshape(
        b * num_boxes, -1, 3)
    gt_pts = (gt[C.KEY_INST_XYZ_MAP_LOCAL] * valid).reshape(
        b * num_boxes, -1, 3)
    num_valid = torch.clamp(valid.sum(dim=(2, 3, 4)), min=1.0)

    emd_all = emd_ops.emd_cost_fused(pred_pts, gt_pts)
    metrics[C.METRIC_EMD] = emd_all.reshape(b, num_boxes) / num_valid

    dist1, _, dist2, _ = chamfer_ops.nn_distance(pred_pts, gt_pts)
    chamfer_all = (dist1.sum(1) + dist2.sum(1)).reshape(b, num_boxes)
    metrics[C.METRIC_CHAMFER] = chamfer_all / num_valid

    gt_cens = gt[C.KEY_CENTROIDS]
    pred_cens = outputs[C.KEY_CENTROIDS]
    cen_errs = gt_cens - pred_cens
    metrics[C.METRIC_PROP_CEN_Z_ERR] = (
        gt_cens[..., 2:3] - outputs[C.KEY_PROP_CEN_Z])[..., 0]
    metrics[C.METRIC_CEN_X_ERR] = cen_errs[..., 0]
    metrics[C.METRIC_CEN_Y_ERR] = cen_errs[..., 1]
    metrics[C.METRIC_CEN_Z_ERR] = cen_errs[..., 2]

    metrics[C.METRIC_DIM_ERR] = (
        gt[C.KEY_LWH + '_offs'] - outputs[C.KEY_LWH + '_offs'])
    metrics[C.METRIC_VIEW_ANG_ERR] = (
        gt[C.KEY_VIEW_ANG] - outputs[C.KEY_VIEW_ANG])[..., 0]

    return metrics
