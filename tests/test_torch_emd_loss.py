"""The loss half of monopsr_torch.ops.emd, and the gradients of
match_cost and nn_distance, against the JAX package.

``match_cost`` and ``nn_distance`` carry the JAX package's hand-written
gradients (custom VJPs) as autograd backwards; ``emd_distance`` on the
CPU is match_cost through approx_match's plan; and
``emd_loss_plain_accumulators`` is the plain version of the CUDA kernel
K2, held here to the TPU kernel it replaces (``_emd_loss_pallas_call`` in
interpret mode) and to the float64 oracle. Inputs are numpy-seeded and
shared.

Tolerances, stated per test: the port and the JAX package run the same
float32 arithmetic in another summation order (rtol 1e-5 where no plan
is computed twice). Where each side computes its own plan, the column
cap min(sat_r / col_sum, 1) switches branch on float32 rounding and
moves a few percent of an entry's mass (tests/test_torch_emd.py), so
gradients through two plans compare within the JAX package's own
envelope for two float32 paths (tests/test_ops.py:354-380: 2e-2 of the
largest component).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monopsr_tpu.models import losses as jax_losses
from monopsr_tpu.ops import chamfer as jax_chamfer
from monopsr_tpu.ops import emd as jax_emd
from monopsr_torch.models import losses
from monopsr_torch.ops import chamfer, emd


def _t(x, grad=False):
    return torch.from_numpy(np.array(x, np.float32)).requires_grad_(grad)


def _clouds(seed, b, n, m, keep=1.0):
    """Prediction-like and GT-like clouds; with keep < 1 (n == m) both
    are zeroed outside one random mask, as the losses mask them."""
    rng = np.random.RandomState(seed)
    xyz1 = rng.randn(b, n, 3).astype(np.float32)
    xyz2 = (rng.randn(b, m, 3) * 0.6 + 0.1).astype(np.float32)
    if keep < 1.0:
        mask = (rng.uniform(size=(b, n, 1)) < keep).astype(np.float32)
        xyz1, xyz2 = xyz1 * mask, xyz2 * mask
    return xyz1, xyz2, rng.uniform(0.5, 2.0, b).astype(np.float32)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() /
                 np.abs(np.asarray(want)).max())


def _oracle_grads(xyz1, xyz2):
    """Exact gradients of sum(emd) in float64: the oracle's plan and the
    matmul-form VJP."""
    grad1, grad2 = [], []
    for a, c in zip(xyz1.astype(np.float64), xyz2.astype(np.float64)):
        w = emd.np_approx_match(a, c) / np.sqrt(np.maximum(
            ((a[:, None, :] - c[None, :, :]) ** 2).sum(-1), 1e-20))
        grad1.append(a * w.sum(1)[:, None] - w @ c)
        grad2.append(c * w.sum(0)[:, None] - w.T @ a)
    return np.stack(grad1), np.stack(grad2)


def _pair_rel(got, want):
    """Per cloud pair: max |got - want| / max |want| over (n, 3)."""
    got, want = np.asarray(got), np.asarray(want)
    return (np.abs(got - want).max(axis=(1, 2)) /
            np.abs(want).max(axis=(1, 2)))


def _check_two_plan_grads(got, want, oracle):
    """Gradients (B, n, 3) of the port (got) and the JAX package (want),
    each through its own float32 plan, with the float64 oracle's. A
    branch flip of the column cap can put either path off on a pair:
    the JAX package's own XLA path reaches ~6e-2 of the largest
    component on some seeds (tests/test_ops.py:354-380). So, per pair,
    the port stays within 6e-2 of the oracle, its mean over pairs within
    1e-2 (the JAX package's mean bound), and on at least half of the
    pairs it agrees with the JAX path to 1e-3."""
    assert np.all(np.isfinite(got))
    to_oracle = _pair_rel(got, oracle)
    assert to_oracle.max() < 6e-2, to_oracle
    assert to_oracle.mean() < 1e-2, to_oracle
    assert (_pair_rel(got, want) < 1e-3).mean() >= 0.5


@pytest.mark.parametrize('keep', [1.0, 0.5])
def test_match_cost_gradient_matches_jax(keep):
    """The backward through a fixed plan (the JAX plan, so both sides use
    the same one) against jax.grad of the JAX match_cost, each pair's
    cost weighted by its own g. With keep=0.5 half the points of each
    pair sit at the origin in both clouds: W there is plan * 1e10
    (the 1e-20 floor), finite on both sides. Same float32 matmul-form
    arithmetic, summed in another order; xyz1 * rowsum W - W @ xyz2
    cancels about one digit: 1e-4 of the largest component."""
    xyz1, xyz2, g = _clouds(0, 2, 64, 64, keep)
    plan = np.asarray(jax_emd.approx_match(xyz1, xyz2))

    def jax_loss(a, b):
        return jnp.sum(jax_emd.match_cost(a, b, plan) * g)

    want1, want2 = jax.grad(jax_loss, argnums=(0, 1))(xyz1, xyz2)
    a, b = _t(xyz1, True), _t(xyz2, True)
    (emd.match_cost(a, b, _t(plan)) * _t(g)).sum().backward()
    for got, want in ((a.grad, want1), (b.grad, want2)):
        assert np.all(np.isfinite(got.numpy()))
        assert np.all(np.isfinite(np.asarray(want)))
        assert _rel(got.numpy(), want) < 1e-4


def test_match_cost_identical_clouds_finite():
    """Identical clouds: every matched pair is coincident, the cost is
    ~0 and the gradient stays finite (autograd through sqrt would give
    inf * 0 = NaN there)."""
    xyz, _, _ = _clouds(6, 1, 96, 96)
    a = _t(xyz, True)
    cost = emd.emd_distance(a, _t(xyz))
    cost.sum().backward()
    assert np.all(np.isfinite(a.grad.numpy()))
    want = np.asarray(jax.grad(lambda p: jnp.sum(jax_emd.emd_distance(
        p, xyz, use_pallas=False)))(xyz))
    assert np.all(np.isfinite(want))


@pytest.mark.parametrize('keep', [1.0, 0.5])
def test_nn_distance_gradient_matches_jax(keep):
    """The argmin-pairing backward against jax.grad of the JAX
    nn_distance, with separate weights on both directions. Masked clouds
    (keep=0.5) tie at the origin; both sides pick the lowest index, so
    the pairings and the gradients agree: rtol 1e-5."""
    xyz1, xyz2, _ = _clouds(1, 2, 150, 150, keep)
    rng = np.random.RandomState(2)
    w1 = rng.uniform(size=(2, 150)).astype(np.float32)
    w2 = rng.uniform(size=(2, 150)).astype(np.float32)

    def jax_loss(a, b):
        d1, _, d2, _ = jax_chamfer.nn_distance(a, b)
        return jnp.sum(d1 * w1) + jnp.sum(d2 * w2)

    want1, want2 = jax.grad(jax_loss, argnums=(0, 1))(xyz1, xyz2)
    a, b = _t(xyz1, True), _t(xyz2, True)
    d1, i1, d2, i2 = chamfer.nn_distance(a, b, chunk=64)
    assert not i1.requires_grad and not i2.requires_grad
    ((d1 * _t(w1)).sum() + (d2 * _t(w2)).sum()).backward()
    for got, want in ((a.grad, want1), (b.grad, want2)):
        assert _rel(got.numpy(), want) < 1e-5


def test_chamfer_distance_one_direction_gradient():
    """Only dist1 used: the backward gets no gradient for dist2."""
    xyz1, xyz2, _ = _clouds(3, 1, 40, 30)
    want = jax.grad(lambda a: jnp.sum(jax_chamfer.nn_distance(a, xyz2)[0]))(
        xyz1)
    a = _t(xyz1, True)
    chamfer.nn_distance(a, _t(xyz2))[0].sum().backward()
    assert _rel(a.grad.numpy(), want) < 1e-5


@pytest.mark.parametrize('b,n,m,keep,seed', [
    (2, 64, 64, 1.0, 0),
    (3, 60, 52, 1.0, 4),      # integer capacity factors differ from floats
    (2, 96, 96, 0.6, 5),      # masked: exact zeros in both clouds
])
def test_emd_distance_plain_matches_jax(b, n, m, keep, seed):
    """Value and gradient of the CPU path against
    emd_distance(use_pallas=False). Each side computes its own plan, and
    a branch flip of the column cap moves the cost of these clouds by up
    to 3e-4 relative (at seed 0 the port lands closer to the float64
    oracle than the JAX path): values rtol 1e-3, the JAX package's bound
    of a float32 path against that oracle. Gradients as
    _check_two_plan_grads holds them (at seed 0 the JAX gradient is 6e-2
    from the oracle, the port's 1e-3)."""
    xyz1, xyz2, g = _clouds(seed, b, n, m, keep)

    def jax_loss(a, c):
        return jnp.sum(jax_emd.emd_distance(a, c, use_pallas=False) * g)

    want = np.asarray(jax_emd.emd_distance(xyz1, xyz2, use_pallas=False))
    want1, want2 = jax.grad(jax_loss, argnums=(0, 1))(xyz1, xyz2)
    a, c = _t(xyz1, True), _t(xyz2, True)
    before = emd.emd_distance.launches
    cost = emd.emd_distance(a, c)
    assert emd.emd_distance.launches == before    # CPU: no kernel launch
    np.testing.assert_allclose(cost.detach().numpy(), want, rtol=1e-3)
    (cost * _t(g)).sum().backward()
    oracle1, oracle2 = _oracle_grads(xyz1, xyz2)
    g = g[:, None, None]
    _check_two_plan_grads(a.grad.numpy(), np.asarray(want1), oracle1 * g)
    _check_two_plan_grads(c.grad.numpy(), np.asarray(want2), oracle2 * g)


@pytest.mark.parametrize('b,n,m,seed', [(2, 128, 128, 3), (1, 256, 128, 4)])
def test_accumulators_match_tpu_kernel_interpret(b, n, m, seed):
    """K2's plain version against the TPU kernel itself, run in interpret
    mode on the CPU. The TPU kernel applies each round's column scale one
    round late and stores its plan as float32 at these sizes. Cost: rtol
    5e-5 (the JAX package's bound for its loss kernel against the plan
    path). Accumulators: max |diff| / max |TPU kernel| < 5e-3, its bound
    against the float64 oracle (tests/test_ops.py:352)."""
    xyz1, xyz2, _ = _clouds(seed, b, n, m)
    want = [np.asarray(x) for x in jax_emd._emd_loss_pallas_call(
        jnp.asarray(xyz1), jnp.asarray(xyz2), interpret=True)]
    got = emd.emd_loss_plain_accumulators(_t(xyz1), _t(xyz2))
    shapes = [(b,), (b, n), (b, m), (b, 3, n), (b, 3, m)]
    for g, w, shape in zip(got, want, shapes):
        assert tuple(g.shape) == shape == w.shape
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=5e-5)
    for g, w in zip(got[1:], want[1:]):
        assert _rel(g.numpy(), w) < 5e-3


def test_accumulators_match_float64_oracle():
    """As tests/test_ops.py:336-352 holds the TPU kernel: each of the
    four contractions within 5e-3 of the largest exact value."""
    xyz1, xyz2, _ = _clouds(4, 1, 256, 128)
    _, grow, gcol, gx2t, gx1t = emd.emd_loss_plain_accumulators(
        _t(xyz1), _t(xyz2))
    x1 = xyz1[0].astype(np.float64)
    x2 = xyz2[0].astype(np.float64)
    match = emd.np_approx_match(x1, x2)
    w = match / np.sqrt(np.maximum(
        ((x1[:, None, :] - x2[None, :, :]) ** 2).sum(-1), 1e-20))
    for got, want in ((grow[0], w.sum(1)), (gcol[0], w.sum(0)),
                      (gx2t[0], (w @ x2).T), (gx1t[0], (w.T @ x1).T)):
        assert _rel(got.numpy(), want) < 5e-3


def test_accumulators_assemble_the_gradient():
    """K2's order of arithmetic is the plan path's math: in float64, its
    cost and the gradient assembled from its accumulators (grad1 = xyz1 *
    grow - gx2t^T, grad2 = xyz2 * gcol - gx1t^T, as the backward of the
    kernel does it) equal the cost and the match_cost backward through
    the materialized plan, to float64 rounding (rtol 1e-9)."""
    xyz1, xyz2, _ = _clouds(7, 2, 80, 70)
    a = torch.from_numpy(xyz1.astype(np.float64))
    c = torch.from_numpy(xyz2.astype(np.float64))
    cost, grow, gcol, gx2t, gx1t = emd._emd_loss_accumulators_chunk(a, c)
    plan = emd._approx_match_chunk(a, c)
    want1, want2 = emd._match_cost_grads(a, c, plan)
    want_cost = (plan * torch.sqrt(emd._sq_dists(a, c))).sum(dim=(1, 2))
    np.testing.assert_allclose(cost.numpy(), want_cost.numpy(), rtol=1e-9)
    assert _rel(a * grow[..., None] - gx2t.transpose(1, 2), want1) < 1e-9
    assert _rel(c * gcol[..., None] - gx1t.transpose(1, 2), want2) < 1e-9


def test_emd_loss_matches_jax():
    """models.losses.emd_loss over (S, N, 48, 48, 3) maps against the JAX
    loss vmapped over samples, value and gradient in the predicted maps.
    Small maps (12 x 12) keep the plan path quick. Two plans, as in
    test_emd_distance_plain_matches_jax: value rtol 1e-3, gradients as
    _check_two_plan_grads holds them."""
    rng = np.random.RandomState(8)
    pred = rng.randn(2, 3, 12, 12, 3).astype(np.float32)
    target = (rng.randn(2, 3, 12, 12, 3) * 0.5).astype(np.float32)
    mask = (rng.uniform(size=(2, 3, 12, 12, 1)) < 0.7).astype(np.float32)
    want = np.asarray(jax.vmap(jax_losses.emd_loss)(pred, target, mask))
    want_grad = jax.grad(lambda p: jnp.sum(jax.vmap(jax_losses.emd_loss)(
        p, target, mask)))(pred)
    p = _t(pred, True)
    got = losses.emd_loss(p, _t(target), _t(mask))
    assert tuple(got.shape) == (2,)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-3)
    got.sum().backward()
    oracle, _ = _oracle_grads((pred * mask).reshape(6, -1, 3),
                              (target * mask).reshape(6, -1, 3))
    oracle = oracle * mask.reshape(6, -1, 1) / 3.0
    _check_two_plan_grads(p.grad.numpy().reshape(6, -1, 3),
                          np.asarray(want_grad).reshape(6, -1, 3), oracle)
    # Through apply_loss with its weight, as compute_losses calls it
    np.testing.assert_allclose(
        losses.apply_loss(['emd', 2.0], _t(pred), _t(target),
                          _t(mask)).numpy(), 2.0 * want, rtol=1e-3)


def test_emd_distance_checks_inputs():
    x = torch.zeros(2, 8, 3)
    with pytest.raises(ValueError):
        emd.emd_distance(x, torch.zeros(3, 8, 3))
    with pytest.raises(TypeError):
        emd.emd_distance(x.double(), x.double())
    meta = torch.zeros(1, 4, 3, device='meta')
    with pytest.raises(ValueError, match='CPU or CUDA'):
        emd.emd_distance(meta, meta)


def test_float32_gradient_envelope_on_masked_clouds():
    """The gradient is ill-conditioned on clouds of realistic size. It is
    assembled as xyz1 * rowsum W - W @ xyz2 with W = plan / |p - q|:
    where a point has a near neighbour in the other cloud both terms are
    tens of times the gradient, and the plan moves with float32 rounding
    (the column cap's branch flips). On (2, 800) clouds with 40% masked
    points the JAX package's own float32 plan path lies 1.9e-2 (seed 0)
    and 7.9e-2 (seed 2) of the largest component away from a float64
    run, beyond the 2e-2 its test holds at (1, 128) unmasked; the port's
    plain version of K2 (the kernel's order of arithmetic) lies 1.2e-3
    and 2.1e-2 away. Held: the JAX path leaves 2e-2 on some seed, and the
    port stays within twice the JAX path's distance (or 2e-2) on every
    seed."""
    jax_errs = []
    for seed in (0, 2):
        xyz1, xyz2, _ = _clouds(seed, 2, 800, 800, keep=0.6)
        a, c = torch.from_numpy(xyz1), torch.from_numpy(xyz2)
        exact = emd._emd_loss_accumulators_chunk(a.double(), c.double())
        want = (a.double() * exact[1][..., None] -
                exact[3].transpose(1, 2)).numpy()
        jax_grad = np.asarray(jax.grad(lambda p: jnp.sum(
            jax_emd.emd_distance(p, xyz2, use_pallas=False)))(xyz1))
        _, grow, _, gx2t, _ = emd.emd_loss_plain_accumulators(a, c)
        port_grad = (a * grow[..., None] - gx2t.transpose(1, 2)).numpy()
        jax_err, port_err = _rel(jax_grad, want), _rel(port_grad, want)
        assert port_err < 2 * max(jax_err, 2e-2), (seed, port_err, jax_err)
        jax_errs.append(jax_err)
    assert max(jax_errs) > 2e-2, jax_errs


def _float32_gradient_errors(gap, keep, seed):
    """One pair of 2304-point clouds: the assembled gradients of the
    plain version of K2 in float32 against the same arithmetic in
    float64, as (max |diff| / max |float64|, L2 relative)."""
    rng = np.random.RandomState(seed)
    if gap > 0:
        xyz1 = rng.randn(1, 2304, 3) * 0.25 + [gap, 0.0, 0.0]
        xyz2 = rng.randn(1, 2304, 3) * 0.25 - [gap, 0.0, 0.0]
    else:
        xyz1 = rng.randn(1, 2304, 3)
        xyz2 = rng.randn(1, 2304, 3) * 0.6 + 0.1
    mask = rng.uniform(size=(1, 2304, 1)) < keep
    a = torch.from_numpy((xyz1 * mask).astype(np.float32))
    c = torch.from_numpy((xyz2 * mask).astype(np.float32))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        x1, x2 = a.to(dtype), c.to(dtype)
        _, grow, gcol, gx2t, gx1t = emd._emd_loss_accumulators_chunk(x1, x2)
        grads[dtype] = [(x1 * grow[..., None] - gx2t.transpose(1, 2)).numpy(),
                        (x2 * gcol[..., None] - gx1t.transpose(1, 2)).numpy()]
    worst = max(_rel(g, w) for g, w in zip(grads[torch.float32],
                                           grads[torch.float64]))
    l2 = max(float(np.linalg.norm(g - w) / np.linalg.norm(w))
             for g, w in zip(grads[torch.float32], grads[torch.float64]))
    return worst, l2


@pytest.mark.parametrize('gap,keep', [(0.0, 0.6), (0.0, 1.0), (2.5, 0.6)])
def test_float32_gradient_conditioning_at_train_size(gap, keep):
    """Pairs of 2304-point clouds, the size of the train step's maps:
    the plain version of K2 in float32 (with the kernel's rounding of d
    and of exp) against the same arithmetic in float64, with the
    gradients assembled as K2's backward does. Random clouds (gap 0),
    masked or not, are ill-conditioned: over three pairs (seeds 0-2) the
    float32 gradient lies more than 2e-2 of its largest component away
    on some pair (masked: 2.8e-3, 2.6e-2, 7.4e-2; unmasked: 3.3e-2 and
    0.11 on seeds 0 and 1), while its L2 distance stays under 1e-2
    (at most 4.2e-3). Close pairs of points put weights exp(level * d)
    at levels down to -65536 on an ulp of d, masked points leave float32
    residues of their capacity that leak to real points near the origin,
    and near-saturated columns turn such small absolute changes into
    large relative ones. Clouds drawn apart around (+-2.5, 0, 0) with
    spread 0.25, 40% masked, have no point near the other cloud or the
    origin: there float32 stays within 2e-3 of the largest component
    (3.2e-7). These two regimes set how chip_smoke.py holds K2's
    gradients."""
    if gap > 0:
        worst, _ = _float32_gradient_errors(gap, keep, 0)
        assert worst < 2e-3, worst
    else:
        errors = [_float32_gradient_errors(gap, keep, seed)
                  for seed in (0, 1, 2)]
        assert max(w for w, _ in errors) > 2e-2, errors
        assert max(l2 for _, l2 in errors) < 1e-2, errors
