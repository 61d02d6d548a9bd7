"""Projection-error objectives for offline pose refinement.

Counterpart of ``monopsr_tpu/core_utils/instance_metrics.py``: objective
functions over (xz_dist, cen_y[, view_ang]) that project a local
instance point cloud through the camera and compare against the
expected ROI pixel grid (plus RGB-similarity and mask-IoU variants),
suitable for scipy.optimize minimizers. The mask IoU rasterizes its
convex hull without cv2: ``scipy.spatial.ConvexHull`` for the hull and
``fill_convex_poly``, which follows ``cv2.fillConvexPoly`` (8-connected
edges, shift 0) pixel for pixel.
"""

import numpy as np

from monopsr_torch.geometry import projection, transforms


def np_proj_error(x, viewing_angle, inst_points_local, exp_proj_uv,
                  valid_mask, cam_p, rotate_view=True):
    """Mean |projected - expected| pixel error for pose parameters.

    Args:
        x: (xz_dist, cen_y) or (xz_dist, cen_y, view_ang) parameters.
        viewing_angle: fixed viewing angle (ignored if len(x) == 3).
        inst_points_local: (N, 3) local instance points.
        exp_proj_uv: (2, N) expected pixel positions.
        valid_mask: (N,) valid-point mask.
        cam_p: (3, 4) camera projection matrix.
        rotate_view: rotate points by the viewing angle.

    Returns:
        mean absolute uv error over valid points.
    """
    if len(x) == 3:
        xz_dist, cen_y, viewing_angle = x
    else:
        xz_dist, cen_y = x

    pred_uv, point_mask = proj_points(
        xz_dist, cen_y, viewing_angle, inst_points_local, cam_p,
        rotate_view)

    mask = valid_mask.astype(bool) & point_mask
    if not mask.any():
        return 1e9
    err = np.abs(pred_uv[:, mask] - exp_proj_uv[:, mask])
    return float(err.mean())


def proj_points(xz_dist, centroid_y, viewing_angle,
                inst_points_local, cam_p, rotate_view=True):
    """Projects local instance points at a hypothesized pose.

    (ref: instance_utils.py:791-838)

    Returns:
        points_uv: (2, N) projected pixel coordinates.
        valid_points_mask: (N,) mask of nonzero local points.
    """
    guess = np.asarray([xz_dist * np.sin(viewing_angle),
                        centroid_y,
                        xz_dist * np.cos(viewing_angle)])

    if rotate_view:
        rot = transforms.np_get_tr_mat(viewing_angle, (0.0, 0.0, 0.0))
        rotated = transforms.apply_tr_mat_to_points(
            rot, inst_points_local)
    else:
        rotated = np.asarray(inst_points_local)

    global_points = rotated + guess

    valid = np.sum(np.abs(rotated), axis=1) > 0.1

    # Shift into cam0 for projection
    x_offset = -cam_p[0, 3] / cam_p[0, 0]
    cam0_points = (global_points + [x_offset, 0, 0]) * valid[:, None]

    uv = projection.np_project_pc_to_image(cam0_points.T, cam_p) * valid
    return uv, valid


def np_proj_err_rgb(x, viewing_angle, inst_points_local, inst_rgb_map,
                    image, valid_mask_map, cam_p, rotate_view=True):
    """RGB-similarity projection error for pose parameters.

    Projects the local instance points at the hypothesized pose, samples
    the image's RGB values at the projected pixels, and compares them
    against the instance's own RGB map — a pose that projects onto the
    object yields low color difference
    (ref: src/monopsr/core/instances/instance_metrics.py:222-250
    `np_proj_err_rgb`, driven by `scipy_proj_err_rgb` :253-287).

    Args:
        x: (xz_dist, cen_y) or (xz_dist, cen_y, view_ang) parameters.
        viewing_angle: fixed viewing angle (ignored if len(x) == 3).
        inst_points_local: (N, 3) local instance points (N = roi_h*roi_w).
        inst_rgb_map: (roi_h, roi_w, 3) instance RGB crop.
        image: (H, W, 3) full image.
        valid_mask_map: (roi_h, roi_w) valid-pixel mask.
        cam_p: (3, 4) camera projection matrix.
        rotate_view: rotate points by the viewing angle.

    Returns:
        summed |RGB difference| / 255 per valid pixel. The reference
        indexes the image with raw rounded coordinates (wrapping /
        crashing off-image); here projections are clipped to the image
        bounds — a documented deviation that only affects poses
        projecting outside the frame, which score badly either way.
    """
    if len(x) == 3:
        xz_dist, cen_y, viewing_angle = x
    else:
        xz_dist, cen_y = x

    pred_uv, _ = proj_points(
        xz_dist, cen_y, viewing_angle, inst_points_local, cam_p,
        rotate_view)

    h, w = image.shape[:2]
    cols = np.clip(np.round(pred_uv[0]).astype(np.int64), 0, w - 1)
    rows = np.clip(np.round(pred_uv[1]).astype(np.int64), 0, h - 1)

    roi_shape = inst_rgb_map.shape[:2]
    guess_rgb_map = (image[rows, cols].reshape(*roi_shape, 3).astype(
        np.float64) * valid_mask_map[..., None])

    valid_count = np.count_nonzero(valid_mask_map)
    if valid_count == 0:
        return 1e9
    diff = np.abs(inst_rgb_map.astype(np.float64) *
                  valid_mask_map[..., None] - guess_rgb_map)
    return float(diff.sum(axis=2).sum() / 255.0 / valid_count)


def scipy_refine_pose(inst_points_local, exp_proj_uv, valid_mask, cam_p,
                      x0, viewing_angle=0.0, optimize_view_ang=False,
                      rotate_view=True):
    """Minimizes np_proj_error over the pose parameters (Nelder-Mead)."""
    from scipy import optimize

    x0 = np.asarray(x0, np.float64)
    result = optimize.minimize(
        np_proj_error, x0,
        args=(viewing_angle, inst_points_local, exp_proj_uv, valid_mask,
              cam_p, rotate_view),
        method='Nelder-Mead')
    return result.x, result.fun


_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _line_pixels(p0, p1):
    """The pixels of cv2's 8-connected line from p0 to p1 ((x, y) ints
    inside the image): Bresenham, drawn left to right."""
    (x0, y0), (x1, y1) = p0, p1
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = 1 if dy >= 0 else -1
    dy = abs(dy)
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x0, y0
    out = []
    for _ in range(dx + 1):
        out.append((x, y))
        step = err < 0
        err += -2 * dy + (2 * dx if step else 0)
        if steep:
            y += sy
            x += 1 if step else 0
        else:
            x += 1
            y += sy if step else 0
    return out


def _trunc_div(a, b):
    """C integer division (rounds toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def fill_convex_poly(mask, points):
    """``cv2.fillConvexPoly(mask, points, 1)`` for integer (x, y)
    vertices inside the image (line type 8, shift 0): every edge drawn as
    an 8-connected line, then OpenCV's scanline fill between the two
    edge chains walked from the topmost vertex in 16.16 fixed point."""
    v = [(int(x), int(y)) for x, y in np.asarray(points).reshape(-1, 2)]
    npts = len(v)
    height, width = mask.shape[:2]
    if npts == 0:
        return mask
    prev = v[-1]
    for p in v:
        for x, y in _line_pixels(prev, p):
            mask[y, x] = 1
        prev = p
    ys = [p[1] for p in v]
    xs = [p[0] for p in v]
    imin = int(np.argmin(ys))
    ymin, ymax = min(ys), max(ys)
    if (npts < 3 or max(xs) < 0 or ymax < 0 or min(xs) >= width or
            ymin >= height):
        return mask
    ymax = min(ymax, height - 1)
    half = _XY_ONE >> 1
    edges = npts
    edge = [dict(idx=imin, di=1, x=-_XY_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=npts - 1, x=-_XY_ONE, dx=0, ye=ymin)]
    y = ymin
    while True:
        for e in edge:
            if y < e['ye']:
                continue
            idx0 = e['idx']
            idx = (idx0 + e['di']) % npts
            while True:
                more = edges > 0
                edges -= 1
                if not more:
                    break
                ty = v[idx][1]
                if ty > y:
                    xs0 = v[idx0][0] << _XY_SHIFT
                    xe = v[idx][0] << _XY_SHIFT
                    e['ye'] = ty
                    e['dx'] = _trunc_div((xe - xs0) * 2 + (ty - y),
                                         2 * (ty - y))
                    e['x'] = xs0
                    e['idx'] = idx
                    break
                idx0 = idx
                idx = (idx + e['di']) % npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]['x'] > edge[1]['x'] else (0, 1)
            xx1 = (edge[left]['x'] + half) >> _XY_SHIFT
            xx2 = (edge[right]['x'] + half) >> _XY_SHIFT
            if xx2 >= 0 and xx1 < width:
                mask[y, max(xx1, 0):min(xx2, width - 1) + 1] = 1
        edge[0]['x'] += edge[0]['dx']
        edge[1]['x'] += edge[1]['dx']
        y += 1
        if y > ymax:
            break
    return mask


def convex_hull_points(points):
    """The convex hull's vertices of (N, 2) integer points, in order
    (collinear points and duplicates give the extreme points)."""
    from scipy.spatial import ConvexHull, QhullError

    points = np.unique(np.asarray(points).reshape(-1, 2), axis=0)
    if len(points) < 3:
        return points
    try:
        return points[ConvexHull(points).vertices]
    except QhullError:           # all on one line: its two ends
        return points[[0, -1]]


def convex_hull_mask_iou(pred_uv, valid_mask, gt_mask, image_shape):
    """IoU between the convex hull of projected points and a GT mask."""
    pts = pred_uv[:, valid_mask.astype(bool)]
    if pts.shape[1] < 3:
        return 0.0
    cols = np.clip(np.round(pts[0]).astype(np.int32), 0,
                   image_shape[1] - 1)
    rows = np.clip(np.round(pts[1]).astype(np.int32), 0,
                   image_shape[0] - 1)
    hull_pts = convex_hull_points(np.stack([cols, rows], axis=1))
    hull_img = np.zeros(image_shape, np.uint8)
    fill_convex_poly(hull_img, hull_pts)
    hull = hull_img.astype(bool)

    inter = np.logical_and(hull, gt_mask).sum()
    union = np.logical_or(hull, gt_mask).sum()
    return float(inter) / union if union else 0.0
