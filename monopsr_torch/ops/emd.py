"""Approximate Earth Mover's Distance (auction-style approxmatch).

Counterpart of ``monopsr_tpu/ops/emd.py``. The algorithm
computes an approximate transport plan between two point clouds by 11
rounds (j = 8..-2) of temperature-annealed row/column normalization with
saturation bookkeeping, then the cost sum(match * |p - q|).

- ``emd_cost_fused``: the metric-mode cost (no plan, no gradient). On a
  CUDA tensor it launches the hand-written kernel K1
  (``csrc/emd_cost_fused.cu``, the counterpart of the TPU kernel
  ``_emd_fused_kernel``); on a CPU tensor it runs the plain version.
- ``emd_cost_fused_plain``: plain PyTorch transcription of the JAX
  package's ``_emd_cost_fused_single``, chunked over the batch. It serves
  the CPU and the on-card comparison with the kernel.
- ``approx_match`` / ``match_cost``: plan and cost through a plan;
  ``match_cost`` carries the gradient to both clouds through the fixed
  plan (the JAX package's custom VJP, with its 1e-20 distance floor).
- ``emd_distance``: the differentiable EMD of the ``'emd'`` loss. On a
  CUDA tensor it launches the hand-written kernel K2
  (``csrc/emd_loss.cu``, the counterpart of the TPU kernel
  ``_emd_loss_kernel``), which computes the cost and the four plan
  contractions the backward needs in one sweep; on a CPU tensor it runs
  ``match_cost(approx_match(...))``.
- ``emd_loss_accumulators``: K2's outputs (the cost and the four
  contractions) without the autograd wrapper; ``emd_loss_plain_accumulators``
  is their plain PyTorch version, in the kernel's order of arithmetic,
  for the CPU and the on-card comparison.
- ``cluster_size``: the blocks per cloud pair K1 or K2 launches with.
  Both kernels run one sweep (``csrc/emd_sweep.cuh``).
- ``np_approx_match`` / ``np_match_cost``: float64 NumPy oracle.
"""

import ctypes

import torch

from monopsr_torch.ops import cuda_build

_LEVELS = tuple(range(8, -3, -1))    # j = 8 .. -2, level = -4^j (0 at j=-2)

# Hopper's opt-in shared memory per block, less the kernel's static use
_MAX_SMEM_BYTES = 232448 - 1024


def _levels():
    return [0.0 if j == -2 else -(4.0 ** j) for j in _LEVELS]


def _capacity_factors(n, m):
    # Integer-division capacity factors match the reference exactly
    # (C++ int division); divergent from float division only when
    # neither n nor m divides the other.
    return max(n, m) // n, max(n, m) // m


def _sq_dists(xyz1, xyz2):
    """(B, N, 3) x (B, M, 3) -> (B, N, M) squared distances, clamped at 0
    (the matmul form can dip a hair below zero)."""
    d = ((xyz1 * xyz1).sum(-1)[:, :, None] +
         (xyz2 * xyz2).sum(-1)[:, None, :] -
         2.0 * torch.bmm(xyz1, xyz2.transpose(1, 2)))
    return d.clamp(min=0.0)


def _annealing_rounds(d, round_fn):
    """Runs the 11 rounds over squared distances d (B, N, M), calling
    round_fn(weight) with each round's column-scaled weights."""
    b, n, m = d.shape
    factor_l, factor_r = _capacity_factors(n, m)
    sat_l = d.new_full((b, n), float(factor_l))
    sat_r = d.new_full((b, m), float(factor_r))
    for level in _levels():
        weight = torch.exp(level * d) * sat_r[:, None, :]
        row_sum = weight.sum(2, keepdim=True) + 1e-9
        weight = weight / row_sum * sat_l[:, :, None]
        col_sum = weight.sum(1) + 1e-9
        col_scale = torch.clamp(sat_r / col_sum, max=1.0)
        weight = weight * col_scale[:, None, :]
        sat_l = torch.clamp(sat_l - weight.sum(2), min=0.0)
        sat_r = torch.clamp(sat_r - weight.sum(1), min=0.0)
        round_fn(weight)


def _chunked(fn, xyz1, xyz2, batch_chunk):
    return torch.cat([fn(xyz1[i:i + batch_chunk], xyz2[i:i + batch_chunk])
                      for i in range(0, xyz1.shape[0], batch_chunk)])


def _approx_match_chunk(xyz1, xyz2):
    d = _sq_dists(xyz1, xyz2)
    match = torch.zeros_like(d)

    def add(weight):
        match.add_(weight)

    _annealing_rounds(d, add)
    return match


@torch.no_grad()
def approx_match(xyz1, xyz2, batch_chunk=4):
    """Batched approximate transport plans: (B, N, 3), (B, M, 3) ->
    (B, N, M). The plan carries no gradient."""
    return _chunked(_approx_match_chunk, xyz1.float(), xyz2.float(),
                    batch_chunk)


# Floor of the squared distance under the rsqrt of W = plan / |p - q|:
# a NORMAL float32, so coincident points (masked slots at the origin)
# give a large finite W and never 0 * inf
_DIST_FLOOR = 1e-20


def _match_cost_grads(xyz1, xyz2, match):
    """Gradient of sum(match * |p - q|) for one chunk, in matmul form:
    with W = match / sqrt(max(d, 1e-20)),
        grad1 = xyz1 * rowsum W - W @ xyz2
        grad2 = xyz2 * colsum W - W^T @ xyz1."""
    w = match / torch.sqrt(_sq_dists(xyz1, xyz2).clamp(min=_DIST_FLOOR))
    grad1 = xyz1 * w.sum(2, keepdim=True) - torch.bmm(w, xyz2)
    grad2 = xyz2 * w.sum(1)[..., None] - torch.bmm(w.transpose(1, 2), xyz1)
    return grad1, grad2


class _MatchCost(torch.autograd.Function):
    """sum(match * |p - q|) per pair; the plan carries no gradient."""

    @staticmethod
    def forward(ctx, xyz1, xyz2, match, batch_chunk):
        ctx.save_for_backward(xyz1, xyz2, match)
        ctx.batch_chunk = batch_chunk
        step = batch_chunk
        return torch.cat([
            (match[i:i + step] * torch.sqrt(_sq_dists(
                xyz1[i:i + step], xyz2[i:i + step]))).sum(dim=(1, 2))
            for i in range(0, xyz1.shape[0], step)])

    @staticmethod
    def backward(ctx, g):
        xyz1, xyz2, match = ctx.saved_tensors
        step = ctx.batch_chunk
        grads = [_match_cost_grads(xyz1[i:i + step], xyz2[i:i + step],
                                   match[i:i + step])
                 for i in range(0, xyz1.shape[0], step)]
        g = g[:, None, None]
        grad1 = torch.cat([a for a, _ in grads]) * g
        grad2 = torch.cat([b for _, b in grads]) * g
        return grad1, grad2, None, None


def match_cost(xyz1, xyz2, match, batch_chunk=4):
    """EMD cost through a fixed transport plan: (B,). The gradient flows
    to both clouds (``batch_chunk`` pairs' (N, M) matrices at a time in
    the backward) but not to the plan."""
    return _MatchCost.apply(xyz1.float(), xyz2.float(), match.detach(),
                            batch_chunk)


def _emd_cost_fused_chunk(xyz1, xyz2):
    d = _sq_dists(xyz1, xyz2)
    dist = torch.sqrt(d)
    cost = d.new_zeros(d.shape[0])

    def add(weight):
        cost.add_((weight * dist).sum(dim=(1, 2)))

    _annealing_rounds(d, add)
    return cost


@torch.no_grad()
def emd_cost_fused_plain(xyz1, xyz2, batch_chunk=4):
    """Metric-mode EMD in plain PyTorch: same value as
    match_cost(approx_match(...)) without keeping the plan. Only
    ``batch_chunk`` (N, M) matrices are live at once."""
    return _chunked(_emd_cost_fused_chunk, xyz1.float(), xyz2.float(),
                    batch_chunk)


def _check_clouds(name, xyz1, xyz2):
    """Raises unless xyz1, xyz2 are float32 (B, N, 3), (B, M, 3) clouds on
    one device."""
    if xyz1.dim() != 3 or xyz1.shape[2] != 3 or xyz2.dim() != 3 or \
            xyz2.shape[2] != 3 or xyz1.shape[0] != xyz2.shape[0]:
        raise ValueError('{} takes (B, N, 3) and (B, M, 3), got {} and '
                         '{}'.format(name, tuple(xyz1.shape),
                                     tuple(xyz2.shape)))
    if xyz1.dtype != torch.float32 or xyz2.dtype != torch.float32:
        raise TypeError('{} takes float32 clouds, got {} and {}'.format(
            name, xyz1.dtype, xyz2.dtype))
    if xyz1.device != xyz2.device:
        raise ValueError('clouds on different devices: {} and {}'.format(
            xyz1.device, xyz2.device))
    if xyz1.device.type not in ('cpu', 'cuda'):
        raise ValueError('{} runs on CPU or CUDA, got {}'.format(
            name, xyz1.device))


def _check_kernel_shape(name, xyz1, xyz2):
    """The kernels' common gate: contiguous clouds, n, m >= 1, and
    24 * (n + m) bytes of state within a block's shared memory."""
    n, m = xyz1.shape[1], xyz2.shape[1]
    if not (xyz1.is_contiguous() and xyz2.is_contiguous()):
        raise ValueError('{} kernel takes contiguous clouds'.format(name))
    if n < 1 or m < 1:
        raise ValueError('{} needs n, m >= 1, got {}, {}'.format(name, n, m))
    if 24 * (n + m) > _MAX_SMEM_BYTES:
        raise ValueError(
            '{} kernel keeps 24 * (n + m) bytes of state in shared memory; '
            'n + m = {} exceeds {}'.format(name, n + m,
                                           _MAX_SMEM_BYTES // 24))


def _kernel_lib(name, num_pointers):
    """The ctypes library of kernel ``name`` with its launch function's
    signature: ``num_pointers`` tensors, then b, n, m and the stream."""
    lib = cuda_build.load(name)
    launch = getattr(lib, name + '_launch')
    launch.argtypes = ([ctypes.c_void_p] * num_pointers +
                       [ctypes.c_int] * 3 + [ctypes.c_void_p])
    launch.restype = ctypes.c_int
    return lib, launch


def _error_string(lib, name, code):
    error_string = getattr(lib, name + '_error_string')
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    return error_string(code).decode()


def cluster_size(name, b, n, m, device=None):
    """Blocks per cloud pair (a thread-block cluster) that kernel ``name``
    ('emd_cost_fused' or 'emd_loss') launches at (b, n, m) on a CUDA
    device: the largest of 8, 4, 2 with b times it at most the SM count
    whose b clusters fit on the card at once, else 1. Builds the kernel
    if need be."""
    lib = cuda_build.load(name)
    query = getattr(lib, name + '_cluster_size')
    query.argtypes = [ctypes.c_int] * 3
    query.restype = ctypes.c_int
    with torch.cuda.device(device if device is not None else
                           torch.cuda.current_device()):
        size = query(b, n, m)
    if size <= 0:
        raise RuntimeError('{} cluster size query failed: {}'.format(
            name, _error_string(lib, name, -size)))
    return size


def _launch(name, tensors, b, n, m, device):
    lib, launch = _kernel_lib(name, len(tensors))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(*[t.data_ptr() for t in tensors], b, n, m, stream)
    if err != 0:
        raise RuntimeError('{} kernel launch failed: {}'.format(
            name, _error_string(lib, name, err)))


def _emd_cost_fused_cuda(xyz1, xyz2):
    """Launches K1 once over all B cloud pairs."""
    _check_kernel_shape('emd_cost_fused', xyz1, xyz2)
    b, n, m = xyz1.shape[0], xyz1.shape[1], xyz2.shape[1]
    cost = torch.empty(b, dtype=torch.float32, device=xyz1.device)
    _launch('emd_cost_fused', (xyz1, xyz2, cost), b, n, m, xyz1.device)
    emd_cost_fused.launches += 1
    return cost


def emd_cost_fused(xyz1, xyz2, batch_chunk=4):
    """Metric-mode EMD per cloud pair: (B, N, 3), (B, M, 3) -> (B,).

    Same value as match_cost(approx_match(...)), without the plan and
    without gradient. CUDA tensors go through the kernel K1 in one launch
    over all B pairs (``emd_cost_fused.launches`` counts the launches);
    CPU tensors go through ``emd_cost_fused_plain`` (``batch_chunk``
    pairs at a time). Any other device raises.
    """
    _check_clouds('emd_cost_fused', xyz1, xyz2)
    if xyz1.device.type == 'cpu':
        return emd_cost_fused_plain(xyz1, xyz2, batch_chunk)
    with torch.no_grad():
        return _emd_cost_fused_cuda(xyz1, xyz2)


emd_cost_fused.launches = 0


_LOG2E_F32 = 1.44269502162933349609375      # log2(e) rounded to float32


def _kernel_sq_dists(xyz1, xyz2):
    """Squared distances (B, N, M) as the kernels round them in float32:
    |p|^2 = (x*x + y*y) + z*z, p.q = fma(z, z', fma(y, y', x*x')) (each
    fma rounded once: the product of two float32 is exact in float64),
    then (|p|^2 + |q|^2) - 2 p.q clamped at 0. Other types: _sq_dists."""
    if xyz1.dtype != torch.float32:
        return _sq_dists(xyz1, xyz2)

    def sq_norm(x):
        return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + \
            x[..., 2] * x[..., 2]

    p, q = xyz1[:, :, None, :], xyz2[:, None, :, :]
    dot = p[..., 0] * q[..., 0]
    for k in (1, 2):
        dot = (p[..., k].double() * q[..., k].double() +
               dot.double()).float()
    return ((sq_norm(xyz1)[:, :, None] + sq_norm(xyz2)[:, None, :]) -
            2.0 * dot).clamp(min=0.0)


def _kernel_exp(d, level):
    """exp(level * d) as the kernels take it in float32: 2^(d * level *
    log2(e)), the product rounded once in float32 (level * log2(e) is
    exact: the levels are powers of two). Other types: exp(level * d)."""
    if d.dtype != torch.float32:
        return torch.exp(level * d)
    return torch.exp2(d * (level * _LOG2E_F32))


def _emd_loss_accumulators_chunk(xyz1, xyz2):
    """K2's arithmetic in its order: each round's weights are
    exp(level * d) times a row scale and a column scale, and the
    row-side sums of a round are taken with the next round's row pass,
    once its column scale is known (a last sweep takes the final
    round's). The row pass computes one exp per element: the previous
    round's weight exp(4 level d) is this round's squared twice (the
    levels are powers of four), except at level 0, where it takes its
    own exp(-d / 4). sqrt(d) is d * rsqrt(max(d, 1e-20)). In float32 the
    distances and exps round as the kernel's (_kernel_sq_dists,
    _kernel_exp): on clouds of realistic size the plan is ill-conditioned,
    and rounding d otherwise moves the accumulators by as much as a
    kernel fault would."""
    d = _kernel_sq_dists(xyz1, xyz2)
    inv = torch.rsqrt(d.clamp(min=_DIST_FLOOR))
    b, n, m = d.shape
    factor_l, factor_r = _capacity_factors(n, m)
    sat_l = d.new_full((b, n), float(factor_l))
    sat_r = d.new_full((b, m), float(factor_r))
    row_scale = d.new_zeros((b, n))
    col_weight = d.new_zeros((b, m))      # sat_r * col_scale of a round
    cost = d.new_zeros(b)
    grow, gx2t = d.new_zeros((b, n)), d.new_zeros((b, 3, n))
    gcol, gx1t = d.new_zeros((b, m)), d.new_zeros((b, 3, m))

    def row_side(e_prev):
        """The finished round's row-side sums from its exp(level * d);
        returns its row masses."""
        e = e_prev * col_weight[:, None, :]
        wq = e * inv
        grow.add_(row_scale * wq.sum(2))
        gx2t.add_(row_scale[:, None, :] *
                  torch.bmm(wq, xyz2).transpose(1, 2))
        return e.sum(2)

    prev_level = 0.0
    for r, level in enumerate(_levels()):
        e = _kernel_exp(d, level)
        row = (e * sat_r[:, None, :]).sum(2)
        if r > 0:
            if level != 0.0:
                e2 = e * e
                assigned = row_side(e2 * e2)
            else:
                assigned = row_side(_kernel_exp(d, prev_level))
            sat_l = torch.clamp(sat_l - row_scale * assigned, min=0.0)
        row_scale = sat_l / (row + 1e-9)
        w = e * row_scale[:, :, None]
        wq = w * inv
        col = w.sum(1) * sat_r
        cdist = (wq * d).sum(1) * sat_r            # sum w * sqrt(d)
        col_scale = torch.clamp(sat_r / (col + 1e-9), max=1.0)
        cost.add_((col_scale * cdist).sum(1))
        col_weight = sat_r * col_scale
        sat_r = torch.clamp(sat_r - col_scale * col, min=0.0)
        gcol.add_(col_weight * wq.sum(1))
        gx1t.add_(col_weight[:, None, :] *
                  torch.bmm(wq.transpose(1, 2), xyz1).transpose(1, 2))
        prev_level = level
    row_side(torch.ones_like(d))             # the level-0 round's weights
    return cost, grow, gcol, gx2t, gx1t


@torch.no_grad()
def emd_loss_plain_accumulators(xyz1, xyz2, batch_chunk=4):
    """Plain PyTorch version of K2's outputs: (cost (B,), grow (B, N),
    gcol (B, M), gx2t (B, 3, N), gx1t (B, 3, M)), with W = plan *
    rsqrt(max(d, 1e-20)): grow = rowsum W, gcol = colsum W,
    gx2t = (W @ xyz2)^T, gx1t = (W^T @ xyz1)^T. It repeats the kernel's
    arithmetic in the kernel's order (the same value as through the
    materialized plan, rounded otherwise), ``batch_chunk`` pairs' (N, M)
    matrices at a time."""
    xyz1, xyz2 = xyz1.float(), xyz2.float()
    parts = [_emd_loss_accumulators_chunk(xyz1[i:i + batch_chunk],
                                          xyz2[i:i + batch_chunk])
             for i in range(0, xyz1.shape[0], batch_chunk)]
    return tuple(torch.cat(pieces).contiguous() for pieces in zip(*parts))


def _emd_loss_cuda(xyz1, xyz2):
    """Launches K2 once over all B cloud pairs: the cost and the four
    gradient accumulators."""
    _check_kernel_shape('emd_loss', xyz1, xyz2)
    b, n, m = xyz1.shape[0], xyz1.shape[1], xyz2.shape[1]
    out = [torch.empty(shape, dtype=torch.float32, device=xyz1.device)
           for shape in ((b,), (b, n), (b, m), (b, 3, n), (b, 3, m))]
    _launch('emd_loss', (xyz1, xyz2, *out), b, n, m, xyz1.device)
    emd_distance.launches += 1
    return tuple(out)


def emd_loss_accumulators(xyz1, xyz2, batch_chunk=4):
    """(cost, grow, gcol, gx2t, gx1t) as ``emd_loss_plain_accumulators``
    defines them, without gradient. CUDA tensors go through K2 in one
    launch (counted in ``emd_distance.launches``); CPU tensors through
    the plain version. Any other device raises."""
    _check_clouds('emd_loss_accumulators', xyz1, xyz2)
    if xyz1.device.type == 'cpu':
        return emd_loss_plain_accumulators(xyz1, xyz2, batch_chunk)
    with torch.no_grad():
        return _emd_loss_cuda(xyz1, xyz2)


class _EmdLoss(torch.autograd.Function):
    """K2 forward; the backward assembles the gradients from its
    accumulators (elementwise, as the JAX package's _emd_loss_bwd)."""

    @staticmethod
    def forward(ctx, xyz1, xyz2):
        cost, grow, gcol, gx2t, gx1t = _emd_loss_cuda(xyz1, xyz2)
        ctx.save_for_backward(xyz1, xyz2, grow, gcol, gx2t, gx1t)
        return cost

    @staticmethod
    def backward(ctx, g):
        xyz1, xyz2, grow, gcol, gx2t, gx1t = ctx.saved_tensors
        g = g[:, None, None]
        grad1 = (xyz1 * grow[..., None] - gx2t.transpose(1, 2)) * g
        grad2 = (xyz2 * gcol[..., None] - gx1t.transpose(1, 2)) * g
        return grad1, grad2


def emd_distance(xyz1, xyz2, batch_chunk=4):
    """Approximate EMD per cloud pair, differentiable in both clouds
    through the (gradient-free) transport plan: (B, N, 3), (B, M, 3) ->
    (B,).

    CUDA tensors go through the kernel K2 in one launch over all B pairs
    (``emd_distance.launches`` counts the launches); the plan never
    reaches device memory. CPU tensors go through
    ``match_cost(approx_match(...))``, ``batch_chunk`` pairs' plans at a
    time. Any other device raises.
    """
    _check_clouds('emd_distance', xyz1, xyz2)
    if xyz1.device.type == 'cpu':
        return match_cost(xyz1, xyz2, approx_match(xyz1, xyz2, batch_chunk),
                          batch_chunk)
    return _EmdLoss.apply(xyz1.contiguous(), xyz2.contiguous())


emd_distance.launches = 0


def floored_points(xyz1, xyz2, batch_chunk=4):
    """(B, N) and (B, M) masks of the points whose squared distance to
    some point of the other cloud is at or under K2's floor of 1e-20
    (masked slots at the origin): W = plan * 1e10 on such pairs."""
    rows, cols = [], []
    for i in range(0, xyz1.shape[0], batch_chunk):
        pinned = _sq_dists(xyz1[i:i + batch_chunk],
                           xyz2[i:i + batch_chunk]) <= _DIST_FLOOR
        rows.append(pinned.any(2))
        cols.append(pinned.any(1))
    return torch.cat(rows), torch.cat(cols)


def accumulator_errors(got, want, rows, cols):
    """Per accumulator (grow, gcol, gx2t, gx1t) of two (cost, grow, gcol,
    gx2t, gx1t) tuples: max |got - want| / max |want| over the points
    with no floored partner (``floored_points``' ``rows`` and ``cols``),
    and for the floored points max |got - want| over max |want| of all
    points. The 1e10 terms make a floored point's grow and gcol the
    largest values; normalised by them, an error on every other point
    would pass."""
    errs = []
    for g, w, floored in zip(got[1:], want[1:], (rows, cols, rows, cols)):
        if g.dim() == 3:
            floored = floored[:, None, :].expand_as(g)
        diff, scale = (g - w).abs(), w.abs()
        err = 0.0
        if bool((~floored).any()):
            err = float(diff[~floored].max() /
                        scale[~floored].max().clamp(min=1e-30))
        if bool(floored.any()):
            err = max(err, float(diff[floored].max() /
                                 scale.max().clamp(min=1e-30)))
        errs.append(err)
    return errs


# ---------------------------------------------------------------------------
# NumPy float64 oracle (direct transcription of the algorithm spec)
# ---------------------------------------------------------------------------

def np_approx_match(xyz1, xyz2):
    """float64 oracle of the annealing loop for golden tests."""
    import numpy as np

    n, m = len(xyz1), len(xyz2)
    factor_l, factor_r = _capacity_factors(n, m)

    saturated_l = np.full(n, float(factor_l))
    saturated_r = np.full(m, float(factor_r))
    match = np.zeros((n, m))

    d = ((xyz1 ** 2).sum(1)[:, None] + (xyz2 ** 2).sum(1)[None, :] -
         2.0 * xyz1 @ xyz2.T)

    for level in _levels():
        weight = np.exp(level * d) * saturated_r[None, :]
        row_sum = weight.sum(1, keepdims=True) + 1e-9
        weight = weight / row_sum * saturated_l[:, None]
        col_sum = weight.sum(0) + 1e-9
        weight = weight * np.minimum(saturated_r / col_sum, 1.0)[None, :]
        saturated_l = np.maximum(saturated_l - weight.sum(1), 0.0)
        saturated_r = np.maximum(saturated_r - weight.sum(0), 0.0)
        match += weight

    return match


def np_match_cost(xyz1, xyz2, match):
    import numpy as np
    d = np.sqrt(((xyz1[:, None, :] - xyz2[None, :, :]) ** 2).sum(-1))
    return float((match * d).sum())
