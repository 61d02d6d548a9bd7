"""Approximate Earth Mover's Distance (auction-style approxmatch), plain.

Frozen copy of the port's ``ops/emd.py`` plain path: 11 rounds (j =
8..-2) of temperature-annealed row/column normalization with saturation
bookkeeping, then the cost sum(match * |p - q|). ``emd_cost_fused`` is
the metric (the work of the port's kernel K1), ``emd_distance`` the
differentiable cost of the ``'emd'`` loss (the work of K2); both are
plain PyTorch here, and no kernel is launched.
"""

import torch

_LEVELS = tuple(range(8, -3, -1))    # j = 8 .. -2, level = -4^j (0 at j=-2)


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


def emd_cost_fused(xyz1, xyz2, batch_chunk=4):
    """Metric-mode EMD per cloud pair, plain: (B, N, 3), (B, M, 3) ->
    (B,)."""
    return emd_cost_fused_plain(xyz1, xyz2, batch_chunk)


def emd_distance(xyz1, xyz2, batch_chunk=4):
    """The differentiable EMD of the ``'emd'`` loss, plain: the cost
    through the approximate plan."""
    return match_cost(xyz1, xyz2, approx_match(xyz1, xyz2, batch_chunk),
                      batch_chunk)
