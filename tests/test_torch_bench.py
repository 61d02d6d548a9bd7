"""The port's bench (monopsr_torch/experiments/bench.py), its flagship
set-up (experiments/flagship.py) and the measuring helpers
(utils/profiling.py) on the CPU: the flagship config against the JAX
entry's, the bench's keys and null timings on a tiny config, its
refusal without a card, its failures on planted faults, the FLOP count
against an analytic one, and the spread of repeated readings."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch import nn

import __graft_entry__ as graft
from monopsr_torch.eval import evaluator
from monopsr_torch.experiments import bench, flagship
from monopsr_torch.models import monopsr
from monopsr_torch.models.monopsr_net import MonoPSRNet
from monopsr_torch.ops import emd as emd_ops
from monopsr_torch.utils import profiling
from test_torch_train_loop import tiny_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, 'tests', 'datasets', 'Kitti', 'object')


@pytest.fixture
def tiny_config(tmp_path):
    """configs/monopsr_model_000.yaml cut to resnet_tiny widths."""
    with open(flagship.CONFIG_PATH) as f:
        text = tiny_yaml(f.read(), FIXTURE, 2)
    path = tmp_path / 'tiny_bench.yaml'
    path.write_text(text)
    return str(path)


def test_flagship_config_matches_the_jax_entry():
    config, want = graft._flagship_config()
    got = flagship.flagship_config()
    fields = [f.name for f in dataclasses.fields(want)]
    assert fields == [f.name for f in dataclasses.fields(got)]
    for name in fields:
        assert getattr(got, name) == getattr(want, name), name
    assert flagship.loss_config() == config.model_config.loss_config.to_dict()
    assert flagship.train_config() == {
        'optimizer': config.train_config.optimizer.to_dict()}


# Every reading of the bench's result line, and the timings among them
READINGS = ('metric', 'value', 'unit', 'device', 'device_fps',
            'forward_fps', 'eager_forward_fps', 'batched8_fps',
            'eval_val_step_ms', 'eval_dispatch_overhead_ms',
            'tf32_val_step_device_ms', 'e2e_fps',
            'e2e_stages_ms_per_frame', 'train_batch_curve',
            'train_dispatch_overhead_ms', 'mfu', 'device_busy_pct',
            'kernels', 'chamfer_ms')
MFU_KEYS = ('peak_tflops_bf16', 'forward_gflops_per_frame', 'device_mfu_pct',
            'batched8_mfu_pct', 'train_gflops_per_step', 'train_mfu_pct',
            'train_mfu_batch', 'train_mfu_remat', 'train_mfu_batch1_pct')
STAGES = ('assembly', 'dispatch', 'pull', 'format', 'write', 'wall')


def _run(config, capsys):
    assert bench.main(['--device', 'cpu', '--config', config]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_on_the_cpu_counts_and_measures_nothing(tiny_config, capsys):
    result = _run(tiny_config, capsys)
    assert set(READINGS) <= set(result)
    assert set(MFU_KEYS) <= set(result['mfu'])
    assert result['metric'] == 'inference_fps_h100'
    assert result['device']['name'] is None
    assert result['device']['power_limit'] is None
    # Every time, rate, share and busy figure is null on the CPU
    for key in ('value', 'device_fps', 'forward_fps', 'eager_forward_fps',
                'batched8_fps', 'tf32_val_step_device_ms', 'e2e_fps',
                'train_dispatch_overhead_ms',
                'train_eager_ms_per_step_batch1', 'chamfer_ms',
                'eval_dispatch_overhead_ms'):
        assert result[key] is None, key
    # The val step, graphed and eager: not measured off the card
    assert result['eval_val_step_ms'] == {'graphed': None, 'eager': None}
    assert set(result['e2e_stages_ms_per_frame']) == set(STAGES)
    assert all(v is None for v in result['e2e_stages_ms_per_frame'].values())
    assert sorted(result['device_busy_pct']) == [
        'eager_forward_batch1', 'forward_batch1', 'graphed_dispatch_batch1']
    assert all(v is None for v in result['device_busy_pct'].values())
    for key in MFU_KEYS:
        if 'mfu' in key or key.endswith(('_batch', '_remat')):
            assert result['mfu'][key] is None, key
    curve = result['train_batch_curve']
    assert sorted(curve) == ['1', '2', '4', '8', '8c', '8r']
    assert curve['8r']['remat'] == 'unit' and curve['8']['remat'] is None
    assert curve['8c']['remat'] == 'conv_outs'
    for entry in curve.values():
        assert entry['ms_per_step'] is None and entry['peak_gb'] is None
        assert entry['train_mfu_pct'] is None
        assert entry['gflops_per_step'] > 0
    # Counts are filled: FLOPs, frames and files, launches
    mfu = result['mfu']
    assert mfu['peak_tflops_bf16'] == 989.0
    assert mfu['forward_gflops_per_frame'] > 0
    assert mfu['batched8_gflops_per_frame'] == pytest.approx(
        mfu['forward_gflops_per_frame'], rel=1e-6)
    # The train step's count holds its backward: about twice the
    # forward's again
    assert 2.5 < mfu['train_gflops_per_step'] / \
        mfu['forward_gflops_per_frame'] < 3.5
    assert curve['8']['gflops_per_step'] == pytest.approx(
        8 * curve['1']['gflops_per_step'], rel=1e-6)
    # A remat entry's share is of the model's FLOPs; 'unit''s count holds
    # the recomputed forward too
    for key in ('8r', '8c'):
        assert curve[key]['gflops_per_step'] == \
            curve['8']['gflops_per_step']
    assert curve['8r']['counted_gflops_per_step'] > \
        curve['8']['counted_gflops_per_step']
    # 'conv_outs' keeps the convolutions' outputs: it recomputes no
    # convolution or matmul, so its count is no remat's
    assert curve['8c']['counted_gflops_per_step'] == pytest.approx(
        curve['8']['counted_gflops_per_step'], rel=1e-9)
    # The fixture's val split (6 frames) E2E_EPOCHS times in one pass,
    # with one KITTI file per frame of the split
    assert result['e2e_epochs'] == bench.E2E_EPOCHS >= 3
    assert result['e2e_frames'] == 6 * result['e2e_epochs']
    assert result['e2e_kitti_files'] == 6
    assert 0 < result['e2e_samples'] <= result['e2e_frames']
    assert result['e2e_samples'] % result['e2e_epochs'] == 0
    names = [k['name'] for k in result['kernels']]
    assert names == ['emd_cost_fused', 'emd_loss']
    for k in result['kernels']:
        assert k['ms'] is None and k['pct_of_bound'] is None
        assert k['bound_ms'] is None and k['launches'] == 0
    # The tiny config's shapes: eval batch 4 x 2 boxes, 16x16 ROI points
    assert result['kernels'][0]['shape'] == [8, 256, 256]
    assert result['kernels'][1]['shape'] == [2, 256, 256]


def test_bench_without_a_card_raises(tiny_config, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        bench.main(['--config', tiny_config])


def _nan_in_the_forward(monkeypatch):
    forward = MonoPSRNet.forward

    def planted(self, *args, **kwargs):
        outputs = forward(self, *args, **kwargs)
        key = sorted(k for k, v in outputs.items()
                     if v.is_floating_point())[0]
        outputs[key] = outputs[key] * float('nan')
        return outputs
    monkeypatch.setattr(MonoPSRNet, 'forward', planted)


def _k1_off_its_plain_version(monkeypatch):
    fused = emd_ops.emd_cost_fused

    def planted(xyz1, xyz2, batch_chunk=4):
        return fused(xyz1, xyz2, batch_chunk) * 1.01
    planted.launches = 0
    monkeypatch.setattr(emd_ops, 'emd_cost_fused', planted)


@pytest.mark.parametrize('plant', [_nan_in_the_forward,
                                   _k1_off_its_plain_version])
def test_planted_faults_fail_the_bench(plant, tiny_config, monkeypatch,
                                       capsys):
    plant(monkeypatch)
    with pytest.raises(bench.BenchFailure):
        bench.main(['--device', 'cpu', '--config', tiny_config])
    lines = capsys.readouterr().out.strip().splitlines()
    assert not any(line.startswith('{"metric"') for line in lines)


def test_a_share_above_100_percent_fails():
    assert bench._share(99.5, 'x') == 99.5
    assert bench._share(None, 'x') is None
    with pytest.raises(bench.BenchFailure, match='above 100%'):
        bench._share(100.5, 'train_mfu_pct')


def test_count_flops_matches_an_analytic_count(tiny_config):
    """2 Cout Cin/groups kh kw Hout Wout per image and convolution, 2 in
    out per row and linear layer, from the shapes forward hooks see."""
    cfg = flagship.flagship_config(flagship.flagship_yaml(tiny_config))
    net = monopsr.create_net(cfg, device='cpu', seed=0)
    batch = evaluator.batch_to_device(monopsr.strip_to_net_inputs(
        flagship.synthetic_batch(3, cfg, 2)), 'cpu')
    counted = []

    def hook(module, inputs, output):
        if isinstance(module, nn.Conv2d):
            kh, kw = module.kernel_size
            counted.append(2 * output.shape[0] * module.out_channels *
                           module.in_channels // module.groups * kh * kw *
                           output.shape[2] * output.shape[3])
        else:
            rows = inputs[0].numel() // module.in_features
            counted.append(2 * rows * module.in_features *
                           module.out_features)

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, (nn.Conv2d, nn.Linear))]
    try:
        flops = profiling.count_flops(flagship.forward, net, batch)
    finally:
        for handle in handles:
            handle.remove()
    assert len(counted) > 10
    assert flops == sum(counted)


def test_spread_of_known_samples():
    assert profiling.spread([4.0, 1.0, 3.0, 2.0]) == {
        'median': 2.5, 'q1': 1.75, 'q3': 3.25, 'n': 4}
    assert profiling.spread([7.0]) == {'median': 7.0, 'q1': 7.0, 'q3': 7.0,
                                       'n': 1}
    assert profiling.spread(np.arange(1, 10)) == {
        'median': 5.0, 'q1': 3.0, 'q3': 7.0, 'n': 9}
    with pytest.raises(ValueError):
        profiling.spread([])
