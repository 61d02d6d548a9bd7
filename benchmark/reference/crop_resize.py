"""ROI crop-and-resize ops with TF semantics, as batched torch gathers.

Counterpart of ``monopsr_tpu/ops/crop_resize.py``. The JAX package
samples through dense selection-matrix matmuls, a layout trick for the
TPU's matrix unit. Here each output pixel gathers its 4 bilinear corners
directly and blends them in float32 (the same values, without the
zero-weight products).

Layout is NHWC, as in the JAX package.
"""

import torch

from benchmark.reference.grids import linspace


def _bilinear_sample(image, in_y, in_x):
    """Bilinear-samples a batch of images at per-box coordinate grids.

    Args:
        image: (B, H, W, C).
        in_y: (B, N, h) per-box row coordinates.
        in_x: (B, N, w) per-box column coordinates.

    Out-of-range samples return 0 (TF crop_and_resize extrapolation_value).

    Returns:
        (B, N, h, w, C) float32 samples.
    """
    b, height, width, channels = image.shape
    n, h, w = in_y.shape[1], in_y.shape[2], in_x.shape[2]

    y_valid = ((in_y >= 0) & (in_y <= height - 1)).float()
    x_valid = ((in_x >= 0) & (in_x <= width - 1)).float()

    y = in_y.clamp(0, height - 1)
    x = in_x.clamp(0, width - 1)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy = y - y0
    wx = x - x0
    y0i = y0.long()
    x0i = x0.long()
    y1i = (y0i + 1).clamp(max=height - 1)
    x1i = (x0i + 1).clamp(max=width - 1)

    # Per-axis corner weights; an invalid row/column weighs 0 everywhere
    wy0 = ((1.0 - wy) * y_valid)[..., :, None, None]     # (B, N, h, 1, 1)
    wy1 = (wy * y_valid)[..., :, None, None]
    wx0 = ((1.0 - wx) * x_valid)[..., None, :, None]     # (B, N, 1, w, 1)
    wx1 = (wx * x_valid)[..., None, :, None]

    flat = image.reshape(b, height * width, channels)
    bidx = torch.arange(b, device=image.device)[:, None]

    def corner(yi, xi):
        idx = (yi[..., :, None] * width + xi[..., None, :]).reshape(b, -1)
        return flat[bidx, idx].reshape(b, n, h, w, channels).float()

    top = corner(y0i, x0i) * wx0 + corner(y0i, x1i) * wx1
    bottom = corner(y1i, x0i) * wx0 + corner(y1i, x1i) * wx1
    return top * wy0 + bottom * wy1


def _sample_coords(c1, c2, size, extent, dtype):
    """TF crop_and_resize sampling coordinates along one axis:
    (..., N) box edges -> (..., N, size)."""
    if size > 1:
        t = linspace(0.0, 1.0, size, c1.device).to(dtype)
        return (c1[..., None] + t * (c2 - c1)[..., None]) * (extent - 1)
    return 0.5 * (c1 + c2)[..., None] * (extent - 1)


def crop_and_resize_bilinear(image, boxes_norm, crop_size):
    """TF `crop_and_resize` twin: bilinear, normalized [y1, x1, y2, x2] boxes.

    Args:
        image: (H, W, C) single image with boxes_norm (N, 4), or a
            (B, H, W, C) batch with boxes_norm (B, N, 4) (box row i of
            image b crops image b).
        crop_size: (crop_h, crop_w) output size.

    Returns:
        (N, crop_h, crop_w, C) float32 crops, or (B, N, crop_h, crop_w, C)
        for a batch.
    """
    single = image.dim() == 3
    if single:
        image, boxes_norm = image[None], boxes_norm[None]
    crop_h, crop_w = crop_size
    height, width = image.shape[1], image.shape[2]
    y1, x1, y2, x2 = boxes_norm.unbind(-1)
    in_y = _sample_coords(y1, y2, crop_h, height, boxes_norm.dtype)
    in_x = _sample_coords(x1, x2, crop_w, width, boxes_norm.dtype)
    out = _bilinear_sample(image, in_y, in_x)
    return out[0] if single else out


def _align_corners_grid(out_n, in_n, device):
    coords = linspace(0.0, in_n - 1, out_n, device)
    lo = torch.floor(coords)
    i0 = lo.long()
    i1 = (i0 + 1).clamp(max=in_n - 1)
    return i0, i1, coords - lo


def resize_bilinear_align_corners(images, out_size):
    """`tf.image.resize_images(..., align_corners=True)` twin for a batch.

    Args:
        images: (N, H, W, C) batch.
        out_size: (out_h, out_w).

    Returns:
        (N, out_h, out_w, C) bilinear-resized batch: bfloat16 for a
        bfloat16 input, float32 otherwise (blended in float32).
    """
    out_h, out_w = out_size
    _, height, width, _ = images.shape
    out_dtype = (torch.bfloat16 if images.dtype == torch.bfloat16
                 else torch.float32)
    x = images.float()

    x0, x1, fx = _align_corners_grid(out_w, width, images.device)
    fx = fx[None, None, :, None]
    x = x.index_select(2, x0) * (1.0 - fx) + x.index_select(2, x1) * fx

    y0, y1, fy = _align_corners_grid(out_h, height, images.device)
    fy = fy[None, :, None, None]
    x = x.index_select(1, y0) * (1.0 - fy) + x.index_select(1, y1) * fy
    return x.to(out_dtype)
