"""Discrete-continuous orientation encoding (alpha bins + residuals).

Counterpart of ``monopsr_tpu/geometry/orientation.py``: the numpy
encoder and decoder run on the host (the dataset layer encodes each
sample's alphas, the evaluator's prediction formatting decodes the
predicted bin and residual); the torch decoder and the angle-vector
conversions take tensors on any device. Bin centres start
at 0.0 and step by 2*pi/num_bins; the residual for the best bin is the
shifted-angle remainder, and residuals for all bins are wrapped with
atan2.
"""

import math

import numpy as np
import torch


def np_wrap_to_pi(angles):
    """Wraps angles to [-pi, pi]. Angles right at the boundary may flip."""
    return (np.asarray(angles) + np.pi) % (2 * np.pi) - np.pi


def np_orientation_to_angle_bin(orientation, num_bins, overlap=0.0):
    """Encodes orientations into (best_bin, residuals, one_hot_valid_bins).

    Args:
        orientation: scalar or (N,) orientation angles in radians.
        num_bins: number of angle bins.
        overlap: bin overlap in radians; adjacent bins within `overlap` of
            the angle are also marked valid.

    Returns:
        best_bin: int or (N,) int best bin indices.
        residuals: (num_bins,) or (N, num_bins) residuals from every bin
            centre (wrapped to [-pi, pi]).
        one_hot_valid_bins: (num_bins,) or (N, num_bins) 0/1 valid-bin mask.
    """
    orientation = np.asarray(orientation, dtype=np.float64)
    scalar_input = orientation.ndim == 0
    orientation = np.atleast_1d(orientation)

    two_pi = 2.0 * np.pi
    angle_per_bin = two_pi / num_bins

    wrapped = orientation % two_pi
    shifted = (wrapped + angle_per_bin / 2.0) % two_pi
    best_bin = (shifted / angle_per_bin).astype(np.int64)
    best_residual = shifted - (best_bin * angle_per_bin + angle_per_bin / 2.0)

    bin_centres = angle_per_bin * np.arange(num_bins)
    diffs = wrapped[:, None] - bin_centres[None, :]
    residuals = np.arctan2(np.sin(diffs), np.cos(diffs))

    one_hot = np.zeros((len(orientation), num_bins))
    one_hot[np.arange(len(orientation)), best_bin] = 1.0

    if overlap != 0.0:
        bin_centre = best_bin * angle_per_bin
        upper = bin_centre + 0.5 * angle_per_bin
        lower = bin_centre - 0.5 * angle_per_bin
        actual = bin_centre + best_residual
        upper_dist = np.abs(upper - actual)
        lower_dist = np.abs(lower - actual)

        up_mask = upper_dist < overlap
        next_bin = (best_bin + 1) % num_bins
        one_hot[np.arange(len(orientation))[up_mask], next_bin[up_mask]] = 1.0

        # Lower overlap only applies when the upper bound doesn't, and only
        # marks the wrap-around bin when best_bin == 0
        low_mask = (~up_mask) & (lower_dist < overlap) & (best_bin == 0)
        one_hot[np.arange(len(orientation))[low_mask], num_bins - 1] = 1.0

    if scalar_input:
        return int(best_bin[0]), residuals[0], one_hot[0]
    return best_bin, residuals, one_hot


def np_angle_bin_to_orientation(angle_bin, residual, num_bins):
    """Decodes (bin, residual) back to an orientation in [-pi, pi]."""
    two_pi = 2.0 * np.pi
    angle_per_bin = two_pi / num_bins
    angle = np.asarray(angle_bin) * angle_per_bin + np.asarray(residual)
    angle = np.where(angle < -np.pi, angle + two_pi, angle)
    angle = np.where(angle > np.pi, angle - two_pi, angle)
    if np.ndim(angle) == 0:
        return float(angle)
    return angle


def angle_bin_to_orientation(angle_bin, residual, num_bins):
    """Tensor decode of (bin, residual) to orientations in [-pi, pi]."""
    two_pi = 2.0 * math.pi
    angle = angle_bin * (two_pi / num_bins) + residual
    angle = torch.where(angle < -math.pi, angle + two_pi, angle)
    return torch.where(angle > math.pi, angle - two_pi, angle)


def angle_vector_to_orientation(angle_vectors):
    """(N, 2) [cos, sin] unit vectors -> (N,) angles."""
    return torch.atan2(angle_vectors[:, 1], angle_vectors[:, 0])


def orientation_to_angle_vector(orientations):
    """(N,) angles -> (N, 2) [cos, sin] unit vectors."""
    return torch.stack([torch.cos(orientations), torch.sin(orientations)],
                       dim=1)
