"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: each test skips without a CUDA device. This file imports
neither jax nor the JAX package, so it also runs on a machine that has
only PyTorch and the CUDA toolkit, without tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``python3 chip_smoke.py`` runs the same comparisons at the eval and
train steps' shapes.)
"""

import numpy as np
import pytest
import torch

from monopsr_torch.experiments import flagship
from monopsr_torch.ops import emd


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


@pytest.mark.cuda
@pytest.mark.parametrize('b,n,m', [(2, 256, 128), (1, 60, 52), (3, 144, 144),
                                   (1, 1, 7)])
def test_emd_kernel_matches_plain(b, n, m):
    """K1 vs emd_cost_fused_plain on the same card tensors. Tolerance:
    float32 sums in another order, amplified by exp(-65536 d) in the
    first rounds: rtol 1e-3."""
    _cuda()
    rng = np.random.RandomState(6)
    xyz1 = torch.from_numpy(rng.randn(b, n, 3).astype(np.float32)).cuda()
    xyz2 = torch.from_numpy(rng.randn(b, m, 3).astype(np.float32)).cuda()
    before = emd.emd_cost_fused.launches
    got = emd.emd_cost_fused(xyz1, xyz2)
    assert emd.emd_cost_fused.launches == before + 1
    want = emd.emd_cost_fused_plain(xyz1, xyz2)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-3)


@pytest.mark.cuda
def test_emd_kernel_masked_pairs():
    """Exact-zero points (masked slots) and a fully masked pair: the
    masked pair's cost is exactly 0, as in the plain version."""
    _cuda()
    gen = torch.Generator(device='cuda').manual_seed(1)
    xyz1 = torch.randn(4, 300, 3, generator=gen, device='cuda')
    xyz2 = torch.randn(4, 300, 3, generator=gen, device='cuda')
    mask = (torch.rand(4, 300, 1, generator=gen, device='cuda') < 0.5).float()
    mask[3] = 0.0
    xyz1, xyz2 = xyz1 * mask, xyz2 * mask
    got = emd.emd_cost_fused(xyz1, xyz2)
    want = emd.emd_cost_fused_plain(xyz1, xyz2)
    assert float(got[3]) == 0.0
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-3)


@pytest.mark.cuda
def test_emd_kernel_refuses_bad_inputs():
    _cuda()
    x = torch.zeros(2, 8, 3, device='cuda')
    with pytest.raises(ValueError, match='contiguous'):
        emd.emd_cost_fused(x.transpose(0, 1).contiguous().transpose(0, 1), x)
    with pytest.raises(TypeError):
        emd.emd_cost_fused(x.double(), x.double())
    with pytest.raises(ValueError, match='shared memory'):
        big = torch.zeros(1, 6000, 3, device='cuda')
        emd.emd_cost_fused(big, big)


def _loss_clouds(b, n, m, seed, keep=1.0, gap=0.0):
    """As the JAX package's loss-kernel tests draw them, optionally both
    zeroed outside one mask (exact zero points, as the 'emd' loss masks
    the maps); with gap > 0 drawn apart around (+-gap, 0, 0), spread
    0.25, so that no point lies near the other cloud or the origin."""
    rng = np.random.RandomState(seed)
    if gap > 0:
        shift = np.array([gap, 0.0, 0.0])
        xyz1 = (rng.randn(b, n, 3) * 0.25 + shift).astype(np.float32)
        xyz2 = (rng.randn(b, m, 3) * 0.25 - shift).astype(np.float32)
    else:
        xyz1 = rng.randn(b, n, 3).astype(np.float32)
        xyz2 = (rng.randn(b, m, 3) * 0.6 + 0.1).astype(np.float32)
    if keep < 1.0:
        mask = (rng.uniform(size=(b, n, 1)) < keep).astype(np.float32)
        xyz1, xyz2 = xyz1 * mask, xyz2 * mask
    return torch.from_numpy(xyz1).cuda(), torch.from_numpy(xyz2).cuda()


def _max_rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _accumulator_errors(xyz1, xyz2, got, want):
    """Per accumulator (grow, gcol, gx2t, gx1t): max |diff| / max |want|
    over the points with no partner within the 1e-20 floor in the other
    cloud, and for the floored points (masked slots at the origin, where
    W = plan * 1e10) the same over max |want| of all points."""
    pinned = emd._sq_dists(xyz1, xyz2) <= emd._DIST_FLOOR
    errs = []
    for g, w, floored in zip(got[1:], want[1:], (pinned.any(2), pinned.any(1),
                                                 pinned.any(2), pinned.any(1))):
        if g.dim() == 3:
            floored = floored[:, None, :].expand_as(g)
        diff, scale = (g - w).abs(), w.abs()
        err = 0.0
        if bool((~floored).any()):
            err = float(diff[~floored].max() / scale[~floored].max())
        if bool(floored.any()):
            err = max(err, float(diff[floored].max() / scale.max()))
        errs.append(err)
    return errs


@pytest.mark.cuda
@pytest.mark.parametrize('b,n,m,keep', [(2, 256, 128, 1.0), (1, 60, 52, 1.0),
                                        (3, 144, 144, 0.6), (1, 1, 7, 1.0)])
def test_emd_loss_kernel_matches_plain(b, n, m, keep):
    """K2 vs emd_loss_plain_accumulators (the same arithmetic in the same
    order) on the same card tensors. Tolerances as the JAX package holds
    its loss kernel: cost rtol 1e-3; each accumulator within 5e-3 of its
    largest plain value (tests/test_ops.py:352), taken apart from the
    floored points' 1e10 terms (_accumulator_errors)."""
    _cuda()
    xyz1, xyz2 = _loss_clouds(b, n, m, seed=7, keep=keep)
    before = emd.emd_distance.launches
    got = emd.emd_loss_accumulators(xyz1, xyz2)
    assert emd.emd_distance.launches == before + 1
    want = emd.emd_loss_plain_accumulators(xyz1, xyz2)
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=1e-3)
    assert max(_accumulator_errors(xyz1, xyz2, got, want)) < 5e-3


def _plain_gradients(xyz1, xyz2, g):
    """The gradients of sum(g * cost) assembled on the CPU from the plain
    accumulators."""
    x1, x2 = xyz1.cpu(), xyz2.cpu()
    _, grow, gcol, gx2t, gx1t = emd.emd_loss_plain_accumulators(x1, x2)
    g = g[:, None, None]
    return ((x1 * grow[..., None] - gx2t.transpose(1, 2)) * g,
            (x2 * gcol[..., None] - gx1t.transpose(1, 2)) * g)


@pytest.mark.cuda
def test_emd_loss_kernel_gradient():
    """The autograd gradient of emd_distance on the card (K2 forward,
    accumulator backward), each pair's cost weighted by its own g,
    against the same gradient assembled on the CPU from the plain
    accumulators: within 2e-2 of the largest component, the JAX
    package's bound for its loss kernel's gradients
    (tests/test_ops.py:379). Identical clouds give a finite gradient."""
    _cuda()
    xyz1, xyz2 = _loss_clouds(2, 128, 128, seed=0)
    g = torch.tensor([0.7, 1.3])
    a = xyz1.clone().requires_grad_()
    c = xyz2.clone().requires_grad_()
    (emd.emd_distance(a, c) * g.cuda()).sum().backward()
    want1, want2 = _plain_gradients(xyz1, xyz2, g)
    assert _max_rel(a.grad.cpu(), want1) < 2e-2
    assert _max_rel(c.grad.cpu(), want2) < 2e-2
    x = xyz1[:1].clone().requires_grad_()
    emd.emd_distance(x, xyz1[:1].clone()).sum().backward()
    assert bool(torch.isfinite(x.grad).all())


@pytest.mark.cuda
def test_emd_loss_kernel_gradient_at_train_shape():
    """At the train step's 2304 points per cloud (three columns per
    thread), 40% masked, on clouds drawn apart: the gradient is well
    conditioned there (the plain float32 version within ~1e-5 of a
    float64 run, tests/test_torch_emd_loss.py), so the autograd gradient on the card is held per pair
    to 2e-2 of its largest component against the plain version's, and
    the accumulators as test_emd_loss_kernel_matches_plain holds them."""
    _cuda()
    xyz1, xyz2 = _loss_clouds(2, 2304, 2304, seed=3, keep=0.6, gap=2.5)
    assert max(_accumulator_errors(
        xyz1, xyz2, emd.emd_loss_accumulators(xyz1, xyz2),
        emd.emd_loss_plain_accumulators(xyz1, xyz2))) < 5e-3
    g = torch.tensor([0.7, 1.3])
    a = xyz1.clone().requires_grad_()
    c = xyz2.clone().requires_grad_()
    (emd.emd_distance(a, c) * g.cuda()).sum().backward()
    for got, want in zip((a.grad.cpu(), c.grad.cpu()),
                         _plain_gradients(xyz1, xyz2, g)):
        for pair in range(2):
            assert _max_rel(got[pair], want[pair]) < 2e-2


@pytest.mark.cuda
def test_emd_loss_kernel_refuses_bad_inputs():
    _cuda()
    big = torch.zeros(1, 6000, 3, device='cuda')
    with pytest.raises(ValueError, match='shared memory'):
        emd.emd_distance(big, big)
    with pytest.raises(TypeError):
        emd.emd_distance(big.double(), big.double())


@pytest.mark.cuda
def test_kernels_at_train_width_masked():
    """K1 and K2 on one pair of 2304-point clouds, 40% masked, against
    their plain versions on the same card tensors: the cost within 1e-3
    relative for both, K2's accumulators as
    test_emd_loss_kernel_matches_plain holds them."""
    _cuda()
    xyz1, xyz2 = _loss_clouds(1, 2304, 2304, seed=11, keep=0.6)
    np.testing.assert_allclose(
        emd.emd_cost_fused(xyz1, xyz2).cpu().numpy(),
        emd.emd_cost_fused_plain(xyz1, xyz2).cpu().numpy(), rtol=1e-3)
    got = emd.emd_loss_accumulators(xyz1, xyz2)
    want = emd.emd_loss_plain_accumulators(xyz1, xyz2)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=1e-3)
    assert max(_accumulator_errors(xyz1, xyz2, got, want)) < 5e-3


@pytest.mark.cuda
def test_pair_alone_matches_pair_in_batch():
    """Both kernels run one sweep whose row and column sums do not depend
    on the blocks per pair (the cluster size c): a pair launched alone
    (c = 8) gives bitwise K2's accumulators of the same pair inside a
    batch launched with fewer blocks per pair, and costs within 1e-6
    relative (the cost alone is summed over the cluster's blocks); K1's
    cost equals K2's within 1e-6 on the same clouds."""
    _cuda()
    b, n = 40, 256
    xyz1, xyz2 = _loss_clouds(b, n, n, seed=12, keep=0.6)
    assert emd.cluster_size('emd_loss', 1, n, n) == 8
    assert emd.cluster_size('emd_loss', b, n, n) < 8
    batch = emd.emd_loss_accumulators(xyz1, xyz2)
    k1 = emd.emd_cost_fused(xyz1, xyz2)
    np.testing.assert_allclose(k1.cpu().numpy(), batch[0].cpu().numpy(),
                               rtol=1e-6)
    for i in (0, 17, b - 1):
        alone = emd.emd_loss_accumulators(xyz1[i:i + 1], xyz2[i:i + 1])
        for got, want in zip(alone[1:], batch[1:]):
            assert torch.equal(got[0], want[i])
        np.testing.assert_allclose(alone[0].cpu().numpy(),
                                   batch[0][i:i + 1].cpu().numpy(), rtol=1e-6)
        np.testing.assert_allclose(
            emd.emd_cost_fused(xyz1[i:i + 1], xyz2[i:i + 1]).cpu().numpy(),
            k1[i:i + 1].cpu().numpy(), rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize('loss', ['production', 'emd'])
def test_graphed_dispatch_matches_eager_steps(loss):
    """Two dispatches of 2 steps through the CUDA graph of the train step
    (``train.step_graph``) against 4 eager steps of a tiny float32 net
    from the same seed and batches, under deterministic algorithms
    (``chip_smoke.graph_against_eager``): every leaf of the state bit for
    bit or within rtol 2e-5 / atol 1e-6 (tests/test_steps_per_dispatch.py's
    bounds); with the 'emd' loss K2 is captured once and replayed. The
    count replaced instead of updated in place fails the same check.
    ``chip_smoke`` lies at the repository root, which ``python -m
    pytest`` from there puts on the path."""
    _cuda()
    import chip_smoke
    cfg = chip_smoke.tiny_train_config()
    batches = [flagship.synthetic_batch(40 + i, cfg, 2, (96, 320),
                                        (96, 320)) for i in range(4)]
    loss_config = {'production': chip_smoke.LOSS_CONFIG,
                   'emd': chip_smoke.EMD_LOSS_CONFIG}[loss]
    got = chip_smoke.graph_against_eager(cfg, loss_config, batches, 0, 2)
    assert got['bitwise_equal'] or got['within_bound'], got
    assert got['steps'] == [4, 4] and got['count'] == [4, 4]
    assert got['replays'] == 3
    assert got['k2_captured'] == (1 if loss == 'emd' else 0)
    planted = chip_smoke.graph_against_eager(cfg, loss_config, batches, 0, 2,
                                             planted=True)
    assert not (planted['bitwise_equal'] or planted['within_bound'])
    assert planted['count'] == [4, 2]


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['val', 'test'])
def test_graphed_eval_step_matches_eager(mode):
    """The eval step as one CUDA graph (``eval.step_graph``) against the
    eager step on a tiny float32 net, three groups at slot buckets 2, 4
    and 3, for the weights of two seeds restored into the net through one
    capture, under deterministic algorithms
    (``chip_smoke.eval_graph_against_eager``): bit for bit; in val mode K1
    captured once and run by every replay; a restore with ``assign=True``
    makes the next replay raise."""
    _cuda()
    import chip_smoke
    cfg = chip_smoke.tiny_train_config()
    groups = [flagship.synthetic_batch(60 + i, cfg, 2, (96, 320), (96, 320))
              for i in range(3)]
    got = chip_smoke.eval_graph_against_eager(cfg, mode, groups, [2, 4, 3],
                                              (0, 1), deterministic=True)
    assert got['bitwise_equal'] and got['finite'], got
    assert got['planted_error'] and 'load_state_dict' in got['planted_error']
    assert got['replays'] == 6 and got['k1_eager'] == 6
    k1 = 1 if mode == 'val' else 0
    assert got['k1_captured'] == k1
    assert got['k1_python'] == k1 * (got['k1_eager'] + 2)
    assert got['k1_counted'] == k1 * (got['k1_eager'] + 1 + 6)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['under the clip', 'clipped', 'NaN gradient',
                                  '51st non-finite in a row', 'mu bfloat16'])
def test_fused_update_matches_foreach_twin(case):
    """The train step's update through the kernels of
    ``ops/multi_tensor_adam`` (``Optimizer.apply``) against the foreach
    twin (``apply_plain``) on CUDA tensors of the production net's own
    parameter shapes, the production optimizer (Adam, clip 1.0,
    apply-if-finite, EMA 0.9999), from one seeded state
    (``chip_smoke.fused_against_plain``): bit for bit under the clip, on
    a skipped NaN step (parameters and moments kept, EMA moved) and with
    mu in bfloat16; where it clips within rtol 1e-5 (the global norm
    sums in another order: mu scales with 1 / norm, nu with 1 / norm^2);
    the 51st non-finite step in a row applied (every parameter NaN in
    both); the counters as the twin's; three launches and one
    ``train.fused_update`` a step."""
    _cuda()
    import chip_smoke
    got = chip_smoke.fused_against_plain(case, chip_smoke.parameter_shapes(),
                                         seed=5)
    assert chip_smoke.fused_case_failure(case, got) is None, got


@pytest.mark.cuda
def test_fused_update_captured_matches_eager():
    """A captured update replayed for two steps equals three eager updates
    bit for bit (the norm is summed in a fixed order, wherever the
    tensors lie); Python counts three launches at the warm-up and three
    at capture."""
    _cuda()
    import chip_smoke
    got = chip_smoke.fused_graph_against_eager(chip_smoke.parameter_shapes(),
                                               seed=6)
    assert got['bitwise_equal'], got
    assert got['launches_counted'] == 6 and got['replays'] == 2


@pytest.mark.cuda
def test_fused_update_refuses_bad_tensors():
    """A non-contiguous, float64 or CPU gradient raises before a launch."""
    _cuda()
    from monopsr_torch.ops import multi_tensor_adam
    from monopsr_torch.train import optimizer
    tx, _, _, decay = optimizer.build_optimizer(flagship.train_config())
    params = {'w': torch.zeros(4, 6, device='cuda'),
              'b': torch.zeros(6, device='cuda')}
    state = tx.init(params)
    ema = {k: v.clone() for k, v in params.items()}
    good = {k: torch.ones_like(v) for k, v in params.items()}
    before = multi_tensor_adam.adam_update.launches
    for grads, error, match in (
            (dict(good, w=torch.ones(6, 4, device='cuda').t()), ValueError,
             'contiguous'),
            (dict(good, b=good['b'].double()), TypeError, 'float32'),
            (dict(good, b=good['b'].cpu()), ValueError, 'lies on')):
        with pytest.raises(error, match=match):
            tx.apply(grads, state, params, ema, decay)
    assert multi_tensor_adam.adam_update.launches == before
    tx.apply(good, state, params, ema, decay)
    assert multi_tensor_adam.adam_update.launches == before + 3
    assert int(state['count']) == 1
