"""Batched instance-crop geometry, torch.

Counterpart of ``monopsr_tpu/geometry/instance.py``. The JAX functions
take one sample (a box axis N and a (3, 4) camera) and the eval step
vmaps them over images; here each takes a leading image axis B written
out: boxes (B, N, ...), cameras (B, 3, 4), maps (B, H, W).

- GT instance xyz crops from a depth map + instance image (one gather)
- local <-> global instance map transforms
- expected-projection error maps (projection-alignment loss)
- proposal centroid estimates (cen_y from box projection)
"""

import torch

from benchmark.reference import projection, transforms
from benchmark.reference.grids import linspace


def instance_xyz_crop_from_depth_map(depth_map,
                                     instance_img,
                                     inst_indices,
                                     boxes_2d,
                                     boxes_3d,
                                     view_angs,
                                     cam_p,
                                     roi_size,
                                     view_norm,
                                     centroid_type='middle',
                                     rotate_view=True):
    """Builds GT instance xyz maps for all boxes in one batched gather.

    Per box: mask by instance index, crop, nearest resize with
    align_corners=True, backproject, view-normalize. The mask multiply
    happens at the gathered ROI samples instead of at full resolution.

    Args:
        depth_map: (B, H, W) float depth maps (zero padding is invalid).
        instance_img: (B, H, W) integer instance images; each pixel holds
            the original label index, 255 = background.
        inst_indices: (B, N) original label index per box slot.
        boxes_2d: (B, N, 4) [y1, x1, y2, x2] pixel boxes (unrounded).
        boxes_3d: (B, N, 7) GT boxes_3d.
        view_angs: (B, N) viewing angles used for view normalization.
        cam_p: (B, 3, 4) camera projection matrices.
        roi_size: (h, w) ROI size.
        view_norm: whether to shift (and optionally rotate) into the local
            instance frame.
        centroid_type: 'middle' or 'bottom'.
        rotate_view: rotate by -viewing angle during view normalization.

    Returns:
        xyz_out: (B, N, h, w, 3) instance xyz maps (no gradient).
        valid_mask: (B, N, h, w, 1) valid-pixel mask.
    """
    roi_h, roi_w = roi_size
    b, height, width = depth_map.shape

    boxes_r = torch.round(boxes_2d).to(torch.int32)
    y1, x1, y2, x2 = boxes_r.unbind(-1)
    ch = torch.clamp(y2 - y1, min=1)
    cw = torch.clamp(x2 - x1, min=1)

    # Nearest align_corners sampling grid into the full-res maps
    dev = depth_map.device
    iy = torch.arange(roi_h, dtype=torch.float32, device=dev)
    ix = torch.arange(roi_w, dtype=torch.float32, device=dev)
    scale_y = (ch - 1).float() / max(roi_h - 1, 1)
    scale_x = (cw - 1).float() / max(roi_w - 1, 1)
    src_y = y1[..., None] + torch.round(iy * scale_y[..., None]).int()
    src_x = x1[..., None] + torch.round(ix * scale_x[..., None]).int()
    src_y = src_y.clamp(0, height - 1).long()           # (B, N, h)
    src_x = src_x.clamp(0, width - 1).long()            # (B, N, w)

    # Exact index gather (the JAX package selects with one-hot matmuls
    # at Precision.HIGHEST, which is bit-exact too)
    bidx = torch.arange(b, device=dev)[:, None, None, None]
    gy = src_y[..., :, None]
    gx = src_x[..., None, :]
    depth_samples = depth_map.float()[bidx, gy, gx]      # (B, N, h, w)
    inst_samples = instance_img[bidx, gy, gx].to(torch.int32)

    mask = (inst_samples == inst_indices[..., None, None]).float()
    depth_resized = depth_samples * mask

    # Valid pixels: nonzero masked depth
    valid_mask = (depth_resized.abs() >= 0.1).float()

    # Backproject with pixel-centre sampling over the unrounded box
    pc_map = projection.depth_patch_to_pc_map_batch(
        depth_resized, boxes_2d, cam_p, roi_size, use_pixel_centres=True)

    if view_norm:
        x_offset = (-cam_p[:, 0, 3] / cam_p[:, 0, 0])[:, None]   # (B, 1)
        zeros = torch.zeros_like(boxes_3d[..., 0])
        cen = boxes_3d[..., 0:3] - torch.stack(
            [x_offset.expand_as(zeros), zeros, zeros], dim=-1)
        if centroid_type == 'middle':
            half_h = boxes_3d[..., 5] / 2.0
            cen = cen - torch.stack([zeros, half_h, zeros], dim=-1)

        points = pc_map.reshape(b, -1, roi_h * roi_w, 3)
        if rotate_view:
            # T(-c) then R(-view): rotate(points - c, -view)
            points_local = transforms.rotate_y_batch(
                points - cen[..., None, :], -view_angs)
        else:
            points_local = points - cen[..., None, :]
        xyz_out = points_local.reshape(pc_map.shape) * valid_mask[..., None]
    else:
        xyz_out = pc_map * valid_mask[..., None]

    return xyz_out.detach(), valid_mask[..., None]


def inst_xyz_map_local_to_global(inst_xyz_map_local, view_angs, centroids):
    """Local instance xyz maps -> global camera-frame maps.

    Rotate by +viewing angle, then translate to the centroid.

    Args:
        inst_xyz_map_local: (..., N, h, w, 3).
        view_angs: (..., N) or (..., N, 1) viewing angles.
        centroids: (..., N, 3) centroids.

    Returns:
        (..., N, h, w, 3) global instance xyz maps.
    """
    shape = inst_xyz_map_local.shape
    lead = shape[:-3]
    view_angs = view_angs.reshape(lead)
    points = inst_xyz_map_local.reshape(lead + (shape[-3] * shape[-2], 3))
    rotated = transforms.rotate_y_batch(points, view_angs)
    return (rotated + centroids[..., None, :]).reshape(shape)


def _safe_cos(a):
    c = torch.cos(a)
    return torch.where(c.abs() < 1e-3, torch.where(c < 0, -1e-3, 1e-3), c)


def inst_depth_map_local_to_global(inst_depth_map_local, global_depth,
                                   boxes_2d=None, inst_view_ang=None,
                                   map_roi_size=None, cam_p=None,
                                   rotate_view=False):
    """Local instance depth maps -> global depth maps.

    Adds the predicted centroid depth; with rotate_view, also undoes the
    view rotation's depth skew by linearly interpolating a per-column
    depth offset between the box's left and right viewing-angle edges
    (the offset varies along the map's width axis, as in the JAX
    package).

    Args:
        inst_depth_map_local: (B, N, h, w, 1).
        global_depth: (B, N, 1) predicted cen_z.
        boxes_2d: (B, N, 4) 2D boxes.
        inst_view_ang: (B, N, 1) viewing angles.
        map_roi_size: (h, w).
        cam_p: (B, 3, 4).
        rotate_view: undo view normalization rotation.

    Returns:
        (B, N, h, w, 1) global depth maps.
    """
    cen_z = global_depth[..., None, None]               # (B, N, 1, 1, 1)

    if not rotate_view:
        return inst_depth_map_local + cen_z

    _, roi_w = map_roi_size
    cu = cam_p[:, 0, 2][:, None]
    f = cam_p[:, 0, 0][:, None]

    box_x1 = boxes_2d[..., 1]
    box_x2 = boxes_2d[..., 3]

    # Account for pixel centres
    grid_spacing = (box_x2 - box_x1) / roi_w / 2.0
    box_x1 = box_x1 + grid_spacing
    box_x2 = box_x2 - grid_spacing

    view_ang = inst_view_ang.reshape(box_x1.shape)
    one = torch.ones_like(box_x1)
    view_l = torch.atan2((box_x1 - cu) / f, one)
    view_r = torch.atan2((box_x2 - cu) / f, one)

    inst_xz = global_depth.reshape(box_x1.shape) / _safe_cos(view_ang)
    l_o = inst_xz / _safe_cos(view_l - view_ang)
    r_o = inst_xz / _safe_cos(view_r - view_ang)
    x_l = l_o * torch.sin(view_l - view_ang)
    x_r = r_o * torch.sin(view_r - view_ang)
    offset_l = x_l * torch.sin(view_ang)
    offset_r = x_r * torch.sin(view_ang)

    t = linspace(0.0, 1.0, roi_w, offset_l.device)
    col_offset = (-offset_l)[..., None] + t * (offset_l - offset_r)[..., None]
    col_offset = col_offset[..., None, :, None]          # (B, N, 1, w, 1)

    return inst_depth_map_local + cen_z + col_offset


def proj_err_maps_norm(pred_inst_xyz_map_global, pred_boxes_2d,
                       valid_mask_maps, cam_p, map_roi_size):
    """Normalized projection-alignment error per box.

    Projects predicted global instance points through cam_p, subtracts the
    expected evenly-spaced ROI pixel grid, normalizes by box size, masks,
    clips to +-2, and averages over valid pixels.

    Args:
        pred_inst_xyz_map_global: (B, N, h, w, 3).
        pred_boxes_2d: (B, N, 4).
        valid_mask_maps: (B, N, h, w, 1).
        cam_p: (B, 3, 4).

    Returns:
        (B, N) mean normalized projection error per box.
    """
    b, n, h, w, _ = pred_inst_xyz_map_global.shape

    pc_global = pred_inst_xyz_map_global.permute(0, 1, 4, 2, 3).reshape(
        b, n, 3, h * w)

    exp_uv = projection.get_exp_proj_uv_map_batch(
        pred_boxes_2d, map_roi_size, use_pixel_centres=True)

    proj_uv = projection.project_pc_to_image_batch(pc_global,
                                                   cam_p[:, None])
    proj_uv_map = proj_uv.transpose(-1, -2).reshape(b, n, h, w, 2)

    err = exp_uv - proj_uv_map

    boxes_h = pred_boxes_2d[..., 2] - pred_boxes_2d[..., 0]
    boxes_w = pred_boxes_2d[..., 3] - pred_boxes_2d[..., 1]
    boxes_wh = torch.stack([boxes_w, boxes_h], dim=-1).reshape(b, n, 1, 1, 2)

    err_norm = err / boxes_wh
    # where (not multiply): invalid pixels may hold z=0 points whose
    # projection is not finite, and NaN * 0 would poison the reduction
    err_norm = torch.where(valid_mask_maps > 0, err_norm,
                           torch.zeros((), dtype=err_norm.dtype,
                                       device=err_norm.device))
    err_norm = err_norm.clamp(-2.0, 2.0)

    num_valid = valid_mask_maps.sum(dim=(2, 3, 4))
    num_valid = torch.where(num_valid < 1.0, torch.ones_like(num_valid),
                            num_valid)

    return err_norm.sum(dim=(2, 3, 4)) / num_valid


def est_y_from_box_2d_and_depth(cam_p, boxes_2d, depth, cen_y_offsets):
    """Estimates cen_y by projecting the 2D box centre at the given depth.

    Args:
        cam_p: (B, 3, 4).
        boxes_2d: (B, N, 4) [y1, x1, y2, x2].
        depth: (B, N, 1) depth estimates.
        cen_y_offsets: (B, N) per-box trend offsets (subtracted).

    Returns:
        (B, N, 1) cen_y estimates.
    """
    f = cam_p[:, 0, 0][:, None, None]
    cv = cam_p[:, 1, 2][:, None]
    centre_v = ((boxes_2d[..., 2] + boxes_2d[..., 0]) / 2.0 - cv)[..., None]
    return centre_v * (depth / f) - cen_y_offsets[..., None]


def prop_cen_z_from_box_height(cam_p, boxes_2d, est_obj_h, offsets):
    """Pinhole similar-triangles depth proposal: f * h3d / h2d + offset.

    Args:
        cam_p: (B, 3, 4).
        boxes_2d: (B, N, 4).
        est_obj_h: (B, N) estimated 3D object heights.
        offsets: (B, N) per-class proposal offsets.

    Returns:
        (B, N, 1) proposal cen_z.
    """
    f = cam_p[:, 0, 0][:, None]
    boxes_h = boxes_2d[..., 2] - boxes_2d[..., 0]
    return (f * est_obj_h / boxes_h + offsets)[..., None]
