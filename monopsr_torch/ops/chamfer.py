"""Chamfer distance (nn_distance): bidirectional NN squared distances.

Counterpart of ``monopsr_tpu/ops/chamfer.py``. The JAX package has no
Pallas kernel for this op; here it is plain torch, with the JAX
package's hand-written gradient as a custom autograd backward.
Returns, like the reference op:

    dist1: (B, N) squared distance from each point in xyz1 to its nearest
        neighbour in xyz2
    idx1:  (B, N) index of that neighbour
    dist2, idx2: the reverse direction

Rows of xyz1 are processed in chunks; each (chunk, M) block of
|x|^2 + |y|^2 - 2 x.y is computed once and reduced both ways (rows for
direction 1, a running column min for direction 2). Ties go to the
lowest index, as in the JAX version. The backward differentiates through
the argmin pairing only (a gather plus a negated scatter-add), so no
(chunk, M) block is kept for it; the indices carry no gradient.
"""

import torch


def _pairwise_sq_dists(x_tile, y):
    """(B, T, 3) x (B, M, 3) -> (B, T, M) squared distances."""
    x2 = (x_tile * x_tile).sum(-1, keepdim=True)
    y2 = (y * y).sum(-1)[:, None, :]
    return x2 + y2 - 2.0 * torch.bmm(x_tile, y.transpose(1, 2))


def _nn_bidirectional(xyz1, xyz2, chunk):
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    best_d2 = xyz2.new_full((b, m), float('inf'))
    best_i2 = torch.zeros((b, m), dtype=torch.int32, device=xyz2.device)
    dists, idxs = [], []
    for start in range(0, n, chunk):
        d = _pairwise_sq_dists(xyz1[:, start:start + chunk], xyz2)
        row_d, row_i = d.min(dim=2)
        dists.append(row_d)
        idxs.append(row_i.int())
        col_d, col_i = d.min(dim=1)
        take = col_d < best_d2
        best_d2 = torch.where(take, col_d, best_d2)
        best_i2 = torch.where(take, col_i.int() + start, best_i2)
    return torch.cat(dists, 1), torch.cat(idxs, 1), best_d2, best_i2


def _scatter_neg(target, idx, diff):
    """zeros_like(target) with -diff added at rows idx of each batch."""
    out = torch.zeros_like(target)
    return out.scatter_add_(1, idx.long()[..., None].expand_as(diff), -diff)


class _NnDistance(torch.autograd.Function):
    """Both NN directions; gradient through the argmin pairing:
    d|x - y*|^2/dx = 2 (x - y*), and the matched point y* receives the
    negated contribution."""

    @staticmethod
    def forward(ctx, xyz1, xyz2, chunk):
        dist1, idx1, dist2, idx2 = _nn_bidirectional(xyz1, xyz2, chunk)
        ctx.save_for_backward(xyz1, xyz2, idx1, idx2)
        ctx.mark_non_differentiable(idx1, idx2)
        return dist1, idx1, dist2, idx2

    @staticmethod
    def backward(ctx, g_dist1, _g_idx1, g_dist2, _g_idx2):
        xyz1, xyz2, idx1, idx2 = ctx.saved_tensors
        if g_dist1 is None:
            g_dist1 = xyz1.new_zeros(xyz1.shape[:2])
        if g_dist2 is None:
            g_dist2 = xyz2.new_zeros(xyz2.shape[:2])
        matched2 = torch.gather(xyz2, 1, idx1.long()[..., None].expand_as(xyz1))
        diff1 = 2.0 * (xyz1 - matched2) * g_dist1[..., None]
        matched1 = torch.gather(xyz1, 1, idx2.long()[..., None].expand_as(xyz2))
        diff2 = 2.0 * (xyz2 - matched1) * g_dist2[..., None]
        grad1 = diff1 + _scatter_neg(xyz1, idx2, diff2)
        grad2 = diff2 + _scatter_neg(xyz2, idx1, diff1)
        return grad1, grad2, None


def nn_distance(xyz1, xyz2, chunk=512):
    """Bidirectional nearest-neighbour squared distances.

    Args:
        xyz1: (B, N, 3) point clouds.
        xyz2: (B, M, 3) point clouds.

    Returns:
        (dist1, idx1, dist2, idx2); indices are int32. dist1 and dist2
        are differentiable in both clouds.
    """
    return _NnDistance.apply(xyz1.float(), xyz2.float(), chunk)


def chamfer_distance(xyz1, xyz2):
    """Summed bidirectional chamfer distance per batch element: (B,)."""
    dist1, _, dist2, _ = nn_distance(xyz1, xyz2)
    return dist1.sum(1) + dist2.sum(1)
