"""Loss primitives matching the reference's loss-builder vocabulary.

Counterpart of ``monopsr_tpu/models/losses.py``. The JAX eval and train
steps vmap the losses over samples; here the sample axis is written
out as the leading axis S of every argument, and the losses that reduce
to a scalar per sample (``smooth_l1_nonzero``, ``berHu``,
``chamfer_dist``, ``emd``) return one value per sample, shape (S,).
Elementwise and per-row losses keep their shapes.

Loss-type strings in the YAML loss_config resolve through
``apply_loss``. The ``'emd'`` loss makes one ``emd_distance`` call over
all S * N map pairs: one launch of the EMD loss kernel K2 on CUDA.
"""

import torch

from benchmark.reference import chamfer as chamfer_ops
from benchmark.reference import emd as emd_ops


def _sum_per_sample(x):
    return x.reshape(x.shape[0], -1).sum(1)


def huber(x, delta=1.0):
    """0.5 x^2 if |x| <= delta else 0.5 delta^2 + delta (|x| - delta)."""
    abs_x = x.abs()
    quad = 0.5 * x * x
    lin = 0.5 * delta * delta + delta * (abs_x - delta)
    return torch.where(abs_x <= delta, quad, lin)


def weighted_smooth_l1(pred, target, weights, delta=1.0):
    """Anchor-wise smooth L1: sum over the code dim of huber * weights.

    pred/target: (S, N, C); weights: (S, N, 1) or (S, N, C).
    Returns (S, N).
    """
    return (huber(pred - target, delta) * weights).sum(dim=2)


def weighted_smooth_l1_nonzero(pred, target, weights, delta=1.0):
    """Huber with SUM_BY_NONZERO_WEIGHTS reduction per sample: (S,).

    Weights broadcast against the loss shape; the denominator counts
    nonzero weights after broadcasting (TF huber_loss semantics).
    """
    per_elem = huber(pred - target, delta) * weights
    num_nonzero = _sum_per_sample(
        (weights > 0).float() * torch.ones_like(per_elem))
    return _sum_per_sample(per_elem) / torch.clamp(num_nonzero, min=1.0)


def weighted_softmax_ce(logits, targets, weights, logit_scale=1.0):
    """Softmax CE against (possibly smoothed) one-hot targets.

    logits/targets: (S, N, K); weights: (S, N, 1). Returns weights-shaped.
    """
    scaled = logits / logit_scale
    top = scaled.max(dim=-1, keepdim=True).values
    log_probs = scaled - torch.log(
        torch.exp(scaled - top).sum(dim=-1, keepdim=True)) - top
    ce = -(targets * log_probs).sum(dim=-1)
    return ce.reshape(weights.shape) * weights


def sigmoid_ce(logits, targets):
    """Elementwise sigmoid cross entropy (stable form)."""
    return (torch.clamp(logits, min=0.0) - logits * targets +
            torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal(logits, targets, weights, gamma=2.0, alpha=0.25):
    """Sigmoid focal loss."""
    per_entry = sigmoid_ce(logits, targets)
    prob = torch.where(logits >= 0, 1.0 / (1.0 + torch.exp(-logits)),
                       torch.exp(logits) / (1.0 + torch.exp(logits)))
    p_t = targets * prob + (1 - targets) * (1 - prob)
    modulating = torch.pow(1.0 - p_t, gamma)
    alpha_w = targets * alpha + (1 - targets) * (1 - alpha)
    return per_entry * modulating * alpha_w * weights


def weighted_ber_hu(pred, target, weights):
    """berHu per sample: L1 below max|err|/5, scaled L2 above; mean over
    nonzero weights. Returns (S,)."""
    err = pred - target
    abs_err = err.abs()
    thresh = abs_err.reshape(abs_err.shape[0], -1).max(dim=1).values / 5.0
    thresh = thresh.reshape((-1,) + (1,) * (err.dim() - 1))
    per = torch.where(abs_err <= thresh, abs_err,
                      (err * err + thresh * thresh) /
                      torch.clamp(2.0 * thresh, min=1e-12))
    loss = _sum_per_sample(per * weights)
    num_valid = _sum_per_sample((weights > 0).float() * torch.ones_like(per))
    return torch.where(num_valid > 0, loss / torch.clamp(num_valid, min=1.0),
                       torch.zeros_like(loss))


def chamfer_loss(pred_maps, target_maps, weights):
    """Chamfer distance over masked (S, N, H, W, 3) maps, averaged over
    the N maps of each sample: (S,)."""
    s, n = pred_maps.shape[0], pred_maps.shape[1]
    pred = (pred_maps * weights).reshape(s * n, -1, 3)
    target = (target_maps * weights).reshape(s * n, -1, 3)
    return chamfer_ops.chamfer_distance(pred, target).reshape(s, n).mean(1)


def emd_loss(pred_maps, target_maps, weights):
    """Approximate EMD over masked (S, N, H, W, 3) maps, averaged over
    the N maps of each sample: (S,)."""
    s, n = pred_maps.shape[0], pred_maps.shape[1]
    pred = (pred_maps * weights).reshape(s * n, -1, 3).float()
    target = (target_maps * weights).reshape(s * n, -1, 3).float()
    return emd_ops.emd_distance(pred, target).reshape(s, n).mean(1)


def apply_loss(loss_config_entry, pred, target, mask):
    """Dispatch on a YAML loss_config entry [loss_type, weight, ...]:
    returns the raw loss tensor multiplied by the weight."""
    loss_type = loss_config_entry[0]
    weight = loss_config_entry[1]

    if loss_type is None:
        return torch.zeros_like(pred)

    if loss_type == 'smooth_l1':
        out = weighted_smooth_l1(pred, target, mask)
    elif loss_type == 'smooth_l1_nonzero':
        out = weighted_smooth_l1_nonzero(pred, target, mask)
    elif loss_type == 'softmax':
        out = weighted_softmax_ce(pred, target, mask)
    elif loss_type == 'softmax_temp':
        out = weighted_softmax_ce(pred, target, mask, logit_scale=0.5)
    elif loss_type == 'sigmoid_ce':
        out = sigmoid_ce(pred, target)
    elif loss_type == 'focal':
        out = sigmoid_focal(pred, target, mask)
    elif loss_type == 'berHu':
        out = weighted_ber_hu(pred, target, mask)
    elif loss_type == 'chamfer_dist':
        out = chamfer_loss(pred, target, mask)
    elif loss_type == 'emd':
        out = emd_loss(pred, target, mask)
    else:
        raise ValueError('Invalid loss type: ' + str(loss_type))

    return out * weight
