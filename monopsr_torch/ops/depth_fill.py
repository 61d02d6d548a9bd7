"""ip_basic depth completion in torch, on the card by default.

Counterpart of ``monopsr_tpu/ops/depth_fill.py`` (the same names, the
same stages), which is the array twin of the cv2 pipeline
``monopsr_tpu/tools/ip_basic.py``. The completion has no hand-written
kernel: its stages are plain torch ops, on whatever device the map lies.

- dilation / erosion  -> ``F.max_pool2d``, whose implicit padding is
  -inf, as cv2's morphology border; erosion is ``-max_pool(-x)``. Cross
  kernels are the elementwise max of a horizontal and a vertical line
  window; full square kernels are the composition (k, 1) then (1, k).
- 5x5 median blur     -> 25 shifted views of a replicate-padded map (cv2
  ``medianBlur`` on float32 uses BORDER_REPLICATE); ``torch.median`` of
  25 values is element 12 of the sorted window, exactly.
- bilateral filter    -> Gauss(space) * Gauss(value difference) over the
  same 25 views, the latter read from cv2's 4096-bin table, reflect-101
  border (torch's ``'reflect'``).

Every function takes an (H, W) map or a stack (..., H, W) of maps of one
shape; each map's bilateral range (its min, max and table) is its own.
"""

import numpy as np
import torch
import torch.nn.functional as F

from monopsr_torch.utils import device as device_lib


def _maps(x):
    """(..., H, W) -> (N, 1, H, W), the layout of the 2-D torch ops."""
    return x.reshape((-1, 1) + tuple(x.shape[-2:]))


def _dilate_line(x, k, axis):
    """1-D max filter along `axis` (0 rows, 1 columns) with SAME extent
    and a -inf border."""
    kernel = (k, 1) if axis == 0 else (1, k)
    pad = (k // 2, 0) if axis == 0 else (0, k // 2)
    return F.max_pool2d(_maps(x), kernel, stride=1,
                        padding=pad).reshape(x.shape)


def dilate_cross(x, k):
    """Dilation by a k x k cross kernel (center row + center column)."""
    return torch.maximum(_dilate_line(x, k, 0), _dilate_line(x, k, 1))


def dilate_full(x, k):
    """Dilation by a k x k all-ones kernel (separable max filter)."""
    return _dilate_line(_dilate_line(x, k, 0), k, 1)


def erode_full(x, k):
    """Erosion by a k x k all-ones kernel (cv2 +inf border)."""
    return -F.max_pool2d(-_maps(x), k, stride=1,
                         padding=k // 2).reshape(x.shape)


def close_full(x, k):
    """Morphological closure (dilate then erode), all-ones k x k."""
    return erode_full(dilate_full(x, k), k)


def _windows_5x5(x, pad_mode):
    """(..., 25, H, W) stack of the 5x5 neighbourhood of every pixel;
    ``pad_mode`` is a ``F.pad`` mode ('replicate' for numpy's 'edge',
    'reflect' for numpy's 'reflect', both reflect-101)."""
    h, w = x.shape[-2:]
    padded = F.pad(_maps(x), (2, 2, 2, 2), mode=pad_mode)
    views = torch.cat([padded[..., i:i + h, j:j + w]
                       for i in range(5) for j in range(5)], dim=1)
    return views.reshape(tuple(x.shape[:-2]) + (25, h, w))


def median_5(x):
    """5x5 median with replicate border (cv2.medianBlur float32)."""
    return torch.median(_windows_5x5(x, 'replicate'), dim=-3).values


def bilateral_5(x, sigma_color=0.5, sigma_space=2.0):
    """5x5 bilateral filter, bit-faithful to cv2.bilateralFilter 32F.

    cv2's float path does not evaluate exp per pixel pair: it builds a
    4096-bin lookup table of exp(-d^2 / (2 sigma_color^2)) over the
    map's dynamic range (min lowered by 5 sigma_color) and linearly
    interpolates it at |I - I_c| * scale_index. The spatial window is
    circular (corners of the 5x5 square excluded, r <= radius), border
    reflect-101. The table's arithmetic (scale_index, its argument, the
    floor and the clip to kbins) stays in float32, as the JAX twin's.
    Each map of a stack gets its own range and table.
    """
    radius = 2
    kbins = 1 << 12
    offsets = np.array([(i - radius, j - radius)
                        for i in range(5) for j in range(5)], np.float32)
    r2 = (offsets ** 2).sum(1)
    space_w = np.where(
        np.sqrt(r2) <= radius,
        np.exp(-r2 / (2.0 * sigma_space ** 2)),
        0.0).astype(np.float32)
    space_w = torch.as_tensor(space_w, device=x.device)[:, None, None]

    maps = x.reshape((-1,) + tuple(x.shape[-2:]))        # (N, H, W)
    minv = maps.amin(dim=(-2, -1))
    maxv = maps.amax(dim=(-2, -1))
    length = maxv - (minv - np.float32(5.0 * sigma_color))
    scale_index = np.float32(kbins) / length                      # (N,)
    lut_arg = (torch.arange(kbins + 2, dtype=torch.float32,
                            device=x.device)[None, :] /
               scale_index[:, None])
    exp_lut = torch.exp(lut_arg * lut_arg *
                        np.float32(-0.5 / (sigma_color * sigma_color)))

    wins = _windows_5x5(maps, 'reflect')                   # (N, 25, H, W)
    alpha = (wins - maps[:, None]).abs() * scale_index[:, None, None, None]
    idx = torch.clamp(torch.floor(alpha).to(torch.int64), 0, kbins)
    frac = alpha - idx.to(torch.float32)
    flat = idx.reshape(idx.shape[0], -1)
    lo = torch.gather(exp_lut, 1, flat).reshape(idx.shape)
    hi = torch.gather(exp_lut, 1, flat + 1).reshape(idx.shape)
    w = (lo + frac * (hi - lo)) * space_w
    out = (w * wins).sum(dim=1) / w.sum(dim=1)
    # cv2 early-outs to a copy when the map is (near-)constant
    flat_map = (maxv - minv < np.float32(1.19209290e-07))[:, None, None]
    return torch.where(flat_map, maps, out).reshape(x.shape)


def _first_true_row(mask):
    """Per column of (..., H, W), the first row where ``mask`` holds, 0
    where it never does (``jnp.argmax`` of a boolean). CUDA's argmax
    takes no bool tensor, so the mask goes in as float; argmax returns
    the first of equal maxima."""
    return mask.to(torch.float32).argmax(dim=-2)


def fill_in_multiscale(depth_map, max_depth=100.0, extrapolate=False,
                       blur_type='bilateral', device=None):
    """Densifies a sparse projected-LiDAR depth map (or a stack of maps of
    one shape); returns the dense float32 map(s) as a tensor.

    Stage-for-stage twin of the JAX ``depth_fill.fill_in_multiscale``.
    Runs where a tensor ``depth_map`` lies, or on ``device``: CUDA unless
    'cpu' is asked for (a numpy map with no device goes to the card).
    A device resolved here goes through ``utils.device.resolve_device``,
    which on CUDA also sets the port's precision policy (TF32 off) for the
    whole process; the completion itself runs no matmul or convolution.
    """
    if not isinstance(depth_map, torch.Tensor):
        depth_map = torch.as_tensor(np.asarray(depth_map, np.float32))
        device = device_lib.resolve_device(device)
    elif device is not None:
        device = device_lib.resolve_device(device)
    depths_in = depth_map.to(device=device, dtype=torch.float32)

    near_mask = (depths_in > 0.1) & (depths_in <= 15.0)
    med_mask = (depths_in > 15.0) & (depths_in <= 30.0)
    far_mask = depths_in > 30.0

    # Invert (valid pixels only)
    valid = depths_in > 0.1
    inverted = torch.where(valid, max_depth - depths_in, depths_in)

    # Per-bin dilation with cross kernels, merged far -> near
    dilated_far = dilate_cross(inverted * far_mask, 3)
    dilated_med = dilate_cross(inverted * med_mask, 5)
    dilated_near = dilate_cross(inverted * near_mask, 7)

    dilated = inverted
    for layer in (dilated_far, dilated_med, dilated_near):
        dilated = torch.where(layer > 0.1, layer, dilated)

    # Small hole closure
    closed = close_full(dilated, 5)

    # Median blur on valid pixels
    blurred = median_5(closed)
    median_stage = torch.where(closed > 0.1, blurred, closed)

    # Fill holes below each column's top-most valid pixel
    rows = torch.arange(median_stage.shape[-2],
                        device=median_stage.device)[:, None]
    top_rows = _first_true_row(median_stage > 0.1)[..., None, :]
    top_mask = rows >= top_rows

    empty = (median_stage <= 0.1) & top_mask
    hole_dilated = dilate_full(median_stage, 9)
    filled = torch.where(empty, hole_dilated, median_stage)

    # Optionally extend the top-most value to the image top
    top_rows = _first_true_row(filled > 0.1)[..., None, :]
    top_mask = rows >= top_rows
    extended = filled
    if extrapolate:
        top_vals = torch.gather(filled, -2, top_rows)
        extended = torch.where(rows < top_rows, top_vals, filled)
        top_mask = torch.ones_like(top_mask)

    # Large-hole fill: repeated masked dilation
    result = extended
    for _ in range(6):
        empty = (result < 0.1) & top_mask
        grown = dilate_full(result, 5)
        result = torch.where(empty, grown, result)

    # Median blur on valid pixels; the bilateral stage below reuses this
    # pre-blur valid mask (matching the host pipeline's ordering quirk)
    valid = (result > 0.1) & top_mask
    blurred = median_5(result)
    result = torch.where(valid, blurred, result)

    # Final smoothing
    if blur_type == 'gaussian':
        valid_g = (result > 0.1) & top_mask
        gauss = torch.as_tensor(
            np.float32(cv2_gaussian_kernel_5()).reshape(-1),
            device=result.device)[:, None, None]
        blurred = (gauss * _windows_5x5(result, 'reflect')).sum(dim=-3)
        result = torch.where(valid_g, blurred, result)
    elif blur_type == 'bilateral':
        blurred = bilateral_5(result)
        result = torch.where(valid, blurred, result)

    # Un-invert
    return torch.where(result > 0.1, max_depth - result, result)


def fill_in_batch(depth_maps, max_depth=100.0, extrapolate=False,
                  blur_type='bilateral', device=None):
    """Multi-image completion: (B, H, W) -> (B, H, W), each map completed
    as ``fill_in_multiscale`` completes it alone (JAX vmaps that function;
    here it takes the stack directly). Raises unless the maps are a
    (B, H, W) stack."""
    if len(np.shape(depth_maps)) != 3:
        raise ValueError('fill_in_batch takes (B, H, W) maps, got shape '
                         '{}'.format(tuple(np.shape(depth_maps))))
    return fill_in_multiscale(depth_maps, max_depth=max_depth,
                              extrapolate=extrapolate, blur_type=blur_type,
                              device=device)


def cv2_gaussian_kernel_5():
    """cv2.getGaussianKernel(5, 0) outer product (sigma auto rule)."""
    k1 = np.array([0.0625, 0.25, 0.375, 0.25, 0.0625], np.float64)
    return np.outer(k1, k1)

