#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (monopsr_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, any failure of which exits non-zero:

1. card: name and power limit (nvidia-smi); the TF32 switches as the
   port's precision policy sets them (``utils/device.resolve_device``,
   which every entry point passes through: TF32 off), printed.
2. build: every CUDA kernel of the port, one nvcc per source, started
   together, into build/monopsr_torch_kernels/.
3. kernels: each kernel against its plain PyTorch version on the card,
   at the shapes the eval step gives it, on masked clouds drawn apart
   (1e-4) and at small odd shapes; kernel and plain times, and the least
   time the card could take (bound).
4. slice reference: a tiny float32 configuration's val-mode eval step
   on the card against the same step on the CPU (same weights, inputs).
5. main path: the production configuration (configs/monopsr_model_000
   .yaml: ResNet-101 towers, 32 boxes, 320x1216 input, bfloat16) with
   seeded random weights, eval batch 4 of synthetic samples, through
   ``make_eval_step`` in val and then test mode. Launch counts are
   zeroed just before each mode's steps and read just after. Then one
   profiled step per mode, and K1 against its plain version on the val
   step's own clouds.
6. K2 kernel: the EMD loss kernel against its plain version and a
   float64 run on every pair: at the train step's (32, 2304, 2304) on
   random masked clouds and on masked clouds drawn apart (the
   well-conditioned case), and at small odd shapes (cost, the four
   gradient accumulators, the assembled gradients per pair); a finite
   gradient for identical clouds; its time beside its bound. Then what
   K1 and K2 share (one sweep, csrc/emd_sweep.cuh, a cluster of blocks
   per pair): their costs on the same clouds within 1e-6, and pairs
   launched alone (cluster 8) against the same pairs in their batch, K2's
   accumulators bitwise equal.
7. train reference: two train steps of a tiny float32 configuration with
   the 'emd' loss on the card against the same steps on the CPU: the
   first step's gradients, the losses, the decoder batch statistics.
8. main path train: the production configuration at train batch 1 with
   Adam (staircase exponential decay) and the EMA, through
   ``make_train_step``, with the production loss_config and with the
   'emd' loss on the local xyz maps: one warm-up step, launch counts
   zeroed, five timed steps, counts read; then one profiled step each,
   and K2 against its plain version and float64 on the clouds of a
   train-mode forward of the 'emd' run.
9. train loop: the training CLI (``python -m monopsr_torch.experiments
   .run_training``) on configs/monopsr_model_000.yaml, copied by text
   substitution to build/chip_smoke/chip_smoke_train.yaml with the KITTI
   fixture's paths, seed 0, 4 steps, a summary every step and a
   checkpoint every 2; production widths and depth. data/outputs/
   chip_smoke_train/ is removed first. Then the same with 6 steps, which
   must resume from the step-4 checkpoint. The losses of every step are
   finite, checkpoints land at 2, 4 and 6. Printed: the loop's ms/step,
   the host loader's ms per sample (PNG decode, sample assembly,
   prepare_sample) over every fixture train sample, checkpoint bytes and
   save/restore seconds, and the seconds from the CLI's start to its
   first step. The phase's checkpoints stay for phase 11.
10. eval reference: the port's ``Evaluator`` on a tiny float32 copy of
   the production config on the fixture's val split, at eval batch 3,
   from one seeded checkpoint written by ``save_checkpoint``, on the card
   and on the CPU: box_3d txts within 1e-4, each box's EMD metric (K1
   on the card, the plain version on the CPU) within 1e-4 relative, and
   K1 launched once per dispatch group.
11. eval CLIs: ``python -m monopsr_torch.experiments.run_evaluation``
   (val split, native AP on) over phase 9's production-width checkpoints
   2, 4 and 6, then ``run_inference`` at step 6 on the val and the test
   split, each in a subprocess. Every output is checked: no ledger
   (only ``--repeated`` writes it, as in JAX), a box_3d txt per valid
   sample, KITTI files of 16-field CRLF rows,
   metrics CSVs, finite losses, AP lines per step in both results
   files, a KITTI file per test sample, and K1 launched once per group
   (its count printed by the evaluator). Printed: ms per image, feed and
   inference medians, seconds to the first sample, restore and
   native-eval seconds, the AP lines of step 6. data/outputs/
   chip_smoke_train/ is removed at its end.

12. production reference: the production config (ResNet-101 towers, 32
   boxes, 320x1216) in val mode at eval batch 1, one synthetic sample,
   seeded random weights: the card in float32 against the CPU in float32
   and the card in bfloat16 against the card in float32, each output
   within the tolerance ``production_reference`` states.
13. data preparation: ``python -m monopsr_torch.tools.gen_depth_maps``
   on the card over the fixture's 13 training frames copied to
   build/chip_smoke/prep/, each map against the shipped one and the CPU
   fill, then ``gen_instance_masks`` from the shipped maps (pixel for
   pixel against the shipped instance images) and from the card's; the
   fill's device and CPU ms per map, each tool's s per sample and
   start-up.
14. data parallel: two ranks started by ``parallel.data_parallel.launch``
   (NCCL on cuda:0 and cuda:1 when two cards are visible, else both on
   cuda:0 over gloo) against one process on the card: two train steps of
   the production config at a global batch of 2 in float32 and in
   bfloat16, and in bfloat16 with the gradients left per rank, which
   must fail the bfloat16 gate; then the ``Evaluator`` on phase 10's
   tiny config over the fixture's val split (``data_parallel_phase``
   states the tolerances); ms/step of one rank and of two, and K1's
   launches per rank.
15. accuracy gate, short: ``python -m monopsr_torch.experiments
   .accuracy_gate --steps 20 --splits 1`` in a subprocess on the card
   must reach its verdict (exit 0, or exit 1 with its ``ACCURACY GATE
   FAILED: ...`` line) with every key of the JAX gate's report; printed:
   the verdict and the train, eval and native AP seconds.
16. pretrained trunk and remat: a seeded synthetic slim ResNet-101 trunk
   (conv1 and blocks 1-3, the zoo checkpoint's names, 27.6 M float32
   values) written as a TF checkpoint V2 bundle and as a torchvision
   .pth, both converted by the port's CLIs (``python -m monopsr_torch
   .tools.convert_tf_resnet`` / ``convert_torch_resnet``), whose NPZs
   must be equal bit for bit; the training CLI from that trunk on the
   production YAML (phase 9's substitutions, 2 steps, summary images,
   the step-2 profile, ``remat_towers: True``): the loader's counts,
   both towers holding the NPZ, the grids, the trace, finite losses;
   then ``make_train_step`` at production width for no remat, 'unit'
   and 'conv_outs' at train batches 1 and 8 (peak GB, ms/step; 'unit'
   must peak below no remat at batch 8), and one float32 step at batch
   2 per policy with cuDNN and PyTorch's deterministic algorithms, whose
   gradients must equal no remat's bit for bit or deviate no more than
   two no-remat runs do.
   data/pretrained/chip_smoke_trunk.npz and the run's outputs are removed.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Imports neither jax nor monopsr_tpu.
"""

import argparse
import ctypes
import dataclasses
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch

import monopsr_torch
from monopsr_torch import config as config_lib
from monopsr_torch import constants as C
from monopsr_torch import weights
from monopsr_torch.datasets.kitti.kitti_dataset import KittiDataset
from monopsr_torch.eval import evaluator, native_eval
from monopsr_torch.geometry import class_stats
from monopsr_torch.models import monopsr
from monopsr_torch.models.monopsr_net import NetConfig
from monopsr_torch.ops import cuda_build
from monopsr_torch.ops import emd as emd_ops
from monopsr_torch.parallel import data_parallel
from monopsr_torch.tools import convert_tf_resnet, odapi_manifest
from monopsr_torch.train import optimizer as opt_lib
from monopsr_torch.train import pretrained, trainer
from monopsr_torch.train.train_state import TrainState
from monopsr_torch.utils import device as device_lib
from monopsr_torch.utils import image_io

EVAL_BATCH = 4     # configs/monopsr_model_000.yaml train_config.eval_batch
TRAIN_BATCH = 1    # configs/monopsr_model_000.yaml train_config.batch_size
STEPS = 5          # timed steps per mode

TRAIN_CONFIG = {   # configs/monopsr_model_000.yaml train_config.optimizer
    'optimizer': {
        'optimizer_type': 'adam_optimizer',
        'adam_optimizer': {
            'learning_rate_type': 'exponential_decay',
            'initial_learning_rate': 0.00008,
            'decay_steps': 10000,
            'decay_factor': 0.8,
            'staircase': True,
            'use_moving_average': True,
            'moving_average_decay': 0.9999,
        }}}

LOSS_CONFIG = {   # configs/monopsr_model_000.yaml model_config.loss_config
    'inst_xyz_map_local': ['smooth_l1_nonzero', 100.0],
    'valid_mask_maps': ['sigmoid_ce', 0.1],
    'lwh': ['smooth_l1', 1.0],
    'alpha_cls': ['softmax', 0.3, 0.001],
    'alpha_reg': ['smooth_l1', 1.0],
    'alpha_cls_temp': ['softmax_temp', 0.3],
    'view_ang': ['smooth_l1', 0.1],
    'cen_y': ['smooth_l1', 0.1],
    'cen_z': ['smooth_l1', 0.1],
    'inst_xyz_map_global': ['smooth_l1_nonzero', 0.1],
    'inst_depth_map_global': ['smooth_l1_nonzero', 10.0],
}

# The same with the approximate-EMD loss on the local xyz maps (a loss
# type the reference's loss builder accepts; the weight only scales it)
EMD_LOSS_CONFIG = dict(LOSS_CONFIG, inst_xyz_map_local=['emd', 1.0])

# Kernel-name substrings that group the profile (first match wins)
KERNEL_GROUPS = (
    ('emd_kernel', ('sweep_kernel<false>', 'emd_cost_fused')),
    ('emd_loss', ('sweep_kernel<true>', 'emd_loss')),
    ('convolution', ('fprop', 'dgrad', 'conv', 'cudnn', 'implicit_gemm')),
    ('matmul', ('gemm', 'cutlass', 'cublas')),
    ('gather/scatter', ('index', 'gather', 'scatter')),
    ('reduction', ('reduce',)),
    ('copy/cast', ('copy',)),
    ('elementwise', ('elementwise',)),
)


def fail(msg):
    print('chip_smoke: FAILED: ' + msg, file=sys.stderr)
    sys.exit(1)


def nvidia_smi(query):
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=' + query, '--format=csv,noheader'],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def rel_err(got, want):
    """Max |got - want| / |want|, |want| floored at 1e-6 of its largest."""
    err = (got - want).abs()
    floor = max(1e-6 * float(want.abs().max()), 1e-30)
    return float(err.max()), float((err / want.abs().clamp(min=floor)).max())


# --------------------------------------------------------------------------
# Inputs
# --------------------------------------------------------------------------

def production_config():
    """configs/monopsr_model_000.yaml, written out (no YAML parser on the
    card's machine)."""
    return NetConfig(
        num_boxes=32, num_alpha_bins=12, num_classes=1,
        image_input_shape=(320, 1216), resized_full_img_shape=(160, 608),
        img_roi_size=(48, 48), map_roi_size=(48, 48),
        proposal_fc_sizes=(1024, 1024), regression_fc_sizes=(1024, 1024),
        dropout_keep_prob=1.0, max_depth=45.0, mean_sub_type='kitti',
        output_stride=4, resnet='resnet101', compute_dtype='bfloat16',
        lwh_type='offset', alpha_type='dc', view_ang_type='est',
        cen_y_type='offset', cen_z_type='offset', rotate_view=True,
        centroid_type='middle', appended_est_norm='constant',
        class_names=('Car',))


def synthetic_sample(rng, cfg, orig_shape, depth_shape):
    """One KITTI-like sample in the trainer's device encodings: uint8
    image at the input shape, boxes in original-image pixels, uint16
    depth (metres * 256) and uint8 instance image at the padded depth
    shape with the objects painted into both."""
    n, nb = cfg.num_boxes, cfg.num_alpha_bins
    oh, ow = orig_shape
    image = rng.randint(0, 256, cfg.image_input_shape + (3,)).astype(np.uint8)
    cam_p = np.array([[721.5377, 0.0, 609.5593, 44.85728],
                      [0.0, 721.5377, 172.854, 0.2163791],
                      [0.0, 0.0, 1.0, 0.002745884]], np.float32)
    depth = np.zeros(depth_shape, np.float32)
    inst = np.full(depth_shape, 255, np.uint8)
    boxes_2d = np.zeros((n, 4), np.float32)
    boxes_3d = np.zeros((n, 7), np.float32)
    for i in range(n):
        bh, bw = rng.randint(oh // 16, oh // 3), rng.randint(ow // 40, ow // 6)
        y1, x1 = rng.randint(oh // 4, oh - bh), rng.randint(0, ow - bw)
        z = rng.uniform(6.0, 44.0)
        yy, xx = np.mgrid[0:bh, 0:bw]
        depth[y1:y1 + bh, x1:x1 + bw] = z + 0.01 * yy - 0.005 * xx
        inst[y1:y1 + bh, x1:x1 + bw] = i
        boxes_2d[i] = [y1, x1, y1 + bh, x1 + bw] + rng.uniform(-0.4, 0.4, 4)
        # Box centre on the painted object (y is the bottom face)
        cx = ((x1 + bw / 2) - cam_p[0, 2]) / cam_p[0, 0] * z
        cy = ((y1 + bh / 2) - cam_p[1, 2]) / cam_p[1, 1] * z + 0.75
        boxes_3d[i] = [cx, cy, z, 3.9, 1.6, 1.5, rng.uniform(-3, 3)]
    alphas = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    width = 2 * np.pi / nb
    angle = np.mod(alphas, 2 * np.pi)
    bins = np.minimum((angle // width).astype(np.int32), nb - 1)
    regs = (angle[:, None] - (np.arange(nb) + 0.5) * width).astype(np.float32)
    view_2d = np.arctan2(((boxes_2d[:, 1] + boxes_2d[:, 3]) / 2 - cam_p[0, 2])
                         / cam_p[0, 0], 1.0).astype(np.float32)
    view_3d = np.arctan2(boxes_3d[:, 0] + cam_p[0, 3] / cam_p[0, 0],
                         boxes_3d[:, 2]).astype(np.float32)
    return {
        'image': image,
        C.SAMPLE_LABEL_BOXES_2D: boxes_2d,
        C.SAMPLE_LABEL_BOXES_2D_NORM:
            boxes_2d / np.array([oh, ow, oh, ow], np.float32),
        C.SAMPLE_LABEL_BOXES_3D: boxes_3d,
        C.SAMPLE_VIEWING_ANGLES_2D: view_2d,
        C.SAMPLE_VIEWING_ANGLES_3D: view_3d,
        C.SAMPLE_LABEL_CLASS_INDICES: np.ones((n, 1), np.int32),
        C.SAMPLE_MEAN_LWH: np.tile(class_stats.MEAN_LWH['Car'], (n, 1)).astype(
            np.float32),
        C.SAMPLE_PROP_CEN_Z_OFFSET: np.full(
            n, class_stats.PROP_CEN_Z_OFFSET['Car'], np.float32),
        C.SAMPLE_CEN_Y_OFFSETS: np.full(
            n, class_stats.CEN_Y_TREND_OFFSET_MIDDLE[('Car', 'kitti')],
            np.float32),
        C.SAMPLE_CAM_P: cam_p,
        C.SAMPLE_DEPTH_MAP: np.rint(depth * 256.0).astype(np.uint16),
        C.SAMPLE_INSTANCE_IMAGE: inst,
        C.SAMPLE_INSTANCE_INDICES: np.arange(n, dtype=np.int32),
        C.SAMPLE_ALPHAS: alphas,
        C.SAMPLE_ALPHA_BINS: bins,
        C.SAMPLE_ALPHA_REGS: regs,
        C.SAMPLE_ALPHA_VALID_BINS: np.eye(nb, dtype=np.float32)[bins],
    }


def synthetic_batch(seed, cfg, size, orig_shape, depth_shape):
    rng = np.random.RandomState(seed)
    samples = [synthetic_sample(rng, cfg, orig_shape, depth_shape)
               for _ in range(size)]
    return evaluator.stack_samples(samples)


def masked_clouds(gen, b, n, m, keep):
    """Prediction-like and GT-like clouds on the card, each pair zeroed
    outside one random mask as compute_metrics masks them (a share
    1 - keep of exact zero points)."""
    xyz1 = torch.randn(b, n, 3, generator=gen, device='cuda') * 0.3
    xyz2 = torch.randn(b, m, 3, generator=gen, device='cuda') * \
        torch.tensor([1.8, 0.7, 0.8], device='cuda')
    if keep < 1.0 and n == m:
        mask = (torch.rand(b, n, 1, generator=gen, device='cuda')
                < keep).float()
        xyz1, xyz2 = xyz1 * mask, xyz2 * mask
    return xyz1.contiguous(), xyz2.contiguous()


# --------------------------------------------------------------------------
# Timing
# --------------------------------------------------------------------------

def time_cuda(fn, reps, warmup=1):
    """Mean ms per call by CUDA events over `reps` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def emd_bound_ms(b, n, m, sm_count, sm_clock_mhz, fp32_per_element,
                 out_floats):
    """Least time for an EMD kernel's work on this card: the larger of
    the bytes it must move (both clouds in, ``out_floats`` float32 out)
    over the memory rate and its operations over the peak rate of their
    unit. Per element (b*n*m of them): 10 exps (rounds with a nonzero
    level) and 11 square roots or rsqrts on the special-function units
    (16 results per clock per SM on Hopper), and ``fp32_per_element``
    float32 operations at 67 TFLOP/s: ~129 for the metric (distance
    once, ~11 per round), ~230 for the loss (~9 more per round for the
    gradient accumulators)."""
    elems = float(b) * n * m
    bytes_ms = (4.0 * b * (n + m) * 3 + 4.0 * out_floats) / 3.35e12 * 1e3
    sfu_ms = elems * 21 / (16.0 * sm_count * sm_clock_mhz * 1e6) * 1e3
    fp32_ms = elems * fp32_per_element / 67e12 * 1e3
    return max(bytes_ms, sfu_ms, fp32_ms), (
        'bytes' if bytes_ms >= max(sfu_ms, fp32_ms) else 'operations')


def profile_step(step, batch, top=12):
    """Device time by kernel over one step, from torch.profiler's CUPTI
    trace, and the device's busy share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for avg in prof.key_averages():
        if avg.device_type == DeviceType.CUDA:
            us = getattr(avg, 'self_device_time_total', None)
            if us is None:
                us = getattr(avg, 'self_cuda_time_total', 0.0)
            rows.append((us / 1e3, avg.count, avg.key))
    if not rows:
        print('  profile: the trace holds no device time (not measured)')
        return
    busy = sum(r[0] for r in rows)
    print('  profile (one step under the profiler): wall {:.3f} ms, device '
          'busy {:.3f} ms ({:.1%}), {} kernel names'.format(
              wall_ms, busy, busy / wall_ms, len(rows)))
    groups = {}
    for ms, count, name in rows:
        group = next((g for g, keys in KERNEL_GROUPS if any(
            k in name for k in keys)), 'other')
        total, launches = groups.get(group, (0.0, 0))
        groups[group] = (total + ms, launches + count)
    print('  by group: ' + ', '.join(
        '{} {:.3f} ms ({}x)'.format(g, ms, c) for g, (ms, c) in sorted(
            groups.items(), key=lambda kv: -kv[1][0])))
    for ms, count, name in sorted(rows, reverse=True)[:top]:
        print('    {:9.3f} ms {:5d}x  {}'.format(ms, count, name[:110]))


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def kernel_phase(seed):
    """K1 against its plain version. Tolerance: both are float32 with the
    same distance formula; sums run in another order (warp-strided rows,
    per-column loops vs torch reductions) and the first rounds' exp at
    level -65536 amplifies an ulp of d, so costs agree to ~2e-4 relative;
    the bound is 1e-3 relative to each cost. On masked clouds drawn apart
    (as kernel_phase_k2 draws them) the plan is well conditioned, and the
    bound is 1e-4: a column summed plainly, whose masked points leave
    capacity residues of ~1e-5 that later rounds hand on, shows there."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    cases = [('production, masked', 128, 2304, 2304, 0.6, 0.0, 1e-3),
             ('rectangular', 2, 256, 128, 1.0, 0.0, 1e-3),
             ('odd, int factors differ', 1, 60, 52, 1.0, 0.0, 1e-3),
             ('masked, drawn apart', 32, 2304, 2304, 0.6, 2.5, 1e-4)]
    results = []
    for label, b, n, m, keep, gap, rtol in cases:
        if gap > 0:
            xyz1, xyz2 = loss_clouds(gen, b, n, m, keep, gap)
        else:
            xyz1, xyz2 = masked_clouds(gen, b, n, m, keep)
        got = emd_ops.emd_cost_fused(xyz1, xyz2)
        want = emd_ops.emd_cost_fused_plain(xyz1, xyz2)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            fail('K1 gave non-finite costs at {}'.format((b, n, m)))
        abs_err, rel = rel_err(got, want)
        zeros = float((xyz1 == 0).all(-1).float().mean())
        print('kernel emd_cost_fused {} {}: max_abs_err={:.3e} '
              'max_rel_err={:.3e} (bound {:.0e}) zero_points={:.2f} '
              'cluster {}'.format(
                  label, (b, n, m), abs_err, rel, rtol, zeros,
                  emd_ops.cluster_size('emd_cost_fused', b, n, m)))
        if rel > rtol:
            fail('K1 disagrees with its plain version at {} {}: rel {}'
                 .format(label, (b, n, m), rel))
        results.append(dict(shape=(b, n, m), xyz1=xyz1, xyz2=xyz2,
                            max_abs_err=abs_err, max_rel_err=rel))
    results[0]['apart_max_rel_err'] = results[3]['max_rel_err']

    prod = results[0]
    x1, x2 = prod['xyz1'], prod['xyz2']
    ms = time_cuda(lambda: emd_ops.emd_cost_fused(x1, x2), reps=5)
    plain_ms = time_cuda(
        lambda: emd_ops.emd_cost_fused_plain(x1, x2, batch_chunk=8), reps=2)
    return prod, ms, plain_ms, results[3]


def slice_reference(seed):
    """Tiny float32 val-mode eval step on the card vs the CPU. Tolerance:
    the same float32 math, cuDNN/cuBLAS (TF32 off) and K1 against CPU
    kernels and the plain EMD: rtol 1e-3, atol 1e-3 * max|x| per tensor."""
    cfg = NetConfig(num_boxes=4, image_input_shape=(96, 320),
                    resized_full_img_shape=(48, 160),
                    proposal_fc_sizes=(64, 64), regression_fc_sizes=(64, 64),
                    resnet='resnet_tiny', compute_dtype='float32')
    batch = synthetic_batch(seed + 1, cfg, 2, (96, 320), (96, 320))
    results = []
    for device in ('cpu', 'cuda'):
        net = monopsr.create_net(cfg, device='cpu', seed=seed)
        _, losses, metrics = evaluator.make_eval_step(
            net, cfg, LOSS_CONFIG, 'val', device=device)(batch)
        results.append({k: v.cpu() for k, v in {**losses, **metrics}.items()})
    want_all, got_all = results
    worst = 0.0
    for key, want in want_all.items():
        got = got_all[key]
        atol = 1e-3 * max(1.0, float(want.abs().max()))
        excess = float(((got - want).abs() - 1e-3 * want.abs()).max())
        worst = max(worst, excess / atol)
        if not bool(torch.isfinite(got).all()) or excess > atol:
            fail('slice reference mismatch in {}: {} vs {}'.format(
                key, got, want))
    print('slice reference (tiny config, card vs CPU): ok, worst error '
          '{:.3f} of tolerance; emd {}'.format(
              worst, got_all[C.METRIC_EMD].numpy().round(5)))


def main_path_clouds_check(net, cfg, batch):
    """K1 against its plain version on the very clouds the val step hands
    it (forward + GT rebuilt outside the step). Tolerance 5e-3 relative,
    the JAX package's own bound for its kernel at this shape
    (tests/test_ops.py:306-307): the random-init predictions reach
    |p| of hundreds of metres, where an ulp of |p|^2 + |q|^2 is ~1e-2 in
    d, and the two versions round p.q differently."""
    with torch.inference_mode():
        dev = evaluator.batch_to_device(batch, 'cuda')
        outputs = net(**monopsr.net_inputs_from_batch(dev))
        gt = monopsr.build_gt_dict(cfg, dev, outputs)
        valid = gt[C.KEY_VALID_MASK_MAPS]
        pts = [(maps * valid).reshape(-1, valid.shape[2] * valid.shape[3], 3)
               for maps in (outputs[C.KEY_INST_XYZ_MAP_LOCAL],
                            gt[C.KEY_INST_XYZ_MAP_LOCAL])]
        got = emd_ops.emd_cost_fused(*pts)
        want = emd_ops.emd_cost_fused_plain(*pts, batch_chunk=8)
    abs_err, rel = rel_err(got, want)
    print('kernel emd_cost_fused on the val step\'s own clouds {}: '
          'max_abs_err={:.3e} max_rel_err={:.3e} valid points {:.2f}, '
          'max |p| {:.1f}, max |q| {:.1f}'.format(
              tuple(pts[0].shape), abs_err, rel, float(valid.mean()),
              float(pts[0].norm(dim=-1).max()),
              float(pts[1].norm(dim=-1).max())))
    if not bool(torch.isfinite(got).all()) or rel > 5e-3:
        fail('K1 disagrees with its plain version on the val step clouds')
    return rel


def check_outputs(mode, packed, losses, metrics, b, n):
    xyz = packed[C.KEY_INST_XYZ_MAP_LOCAL]
    if tuple(xyz.shape) != (b, n, 48, 48, 3) or xyz.dtype != torch.float16:
        fail('{} packed xyz map {} {}'.format(mode, xyz.shape, xyz.dtype))
    if tuple(packed[C.KEY_VALID_MASK_MAPS].shape) != (b, n, 48, 48, 1):
        fail('{} packed mask shape'.format(mode))
    if tuple(packed[C.KEY_CENTROIDS].shape) != (b, n, 3):
        fail('{} centroids shape'.format(mode))
    for key, value in packed.items():
        if value.is_floating_point() and not bool(torch.isfinite(value).all()):
            fail('{} output {} not finite'.format(mode, key))
    if mode == 'val':
        for key, value in list(losses.items()) + list(metrics.items()):
            if not bool(torch.isfinite(value).all()):
                fail('val {} not finite'.format(key))
        if tuple(losses['total_loss'].shape) != (b,):
            fail('total_loss shape {}'.format(losses['total_loss'].shape))
        if tuple(metrics[C.METRIC_EMD].shape) != (b, n):
            fail('metric_emd shape {}'.format(metrics[C.METRIC_EMD].shape))
        print('main path val: total_loss {} mean metric_emd {:.5f} '
              'mean metric_chamfer {:.5f}'.format(
                  losses['total_loss'].cpu().numpy().round(4),
                  float(metrics[C.METRIC_EMD].mean()),
                  float(metrics[C.METRIC_CHAMFER].mean())))


def main_path(seed):
    cfg = production_config()
    batch = synthetic_batch(seed, cfg, EVAL_BATCH, (375, 1242),
                            C.DEPTH_PAD_SHAPE)
    t0 = time.time()
    net = monopsr.create_net(cfg, device='cuda', seed=seed)
    print('main path: production net built in {:.1f} s ({:.1f} M params)'
          .format(time.time() - t0,
                  sum(p.numel() for p in net.parameters()) / 1e6))
    report = {}
    for mode in ('val', 'test'):
        step = evaluator.make_eval_step(net, cfg, LOSS_CONFIG, mode,
                                        device='cuda')
        step(batch)                                  # warm-up (cuDNN plans)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        emd_ops.emd_cost_fused.launches = 0
        t0 = time.perf_counter()
        for _ in range(STEPS):
            packed, losses, metrics = step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / STEPS * 1e3
        launches = emd_ops.emd_cost_fused.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        check_outputs(mode, packed, losses, metrics, EVAL_BATCH,
                      cfg.num_boxes)
        if mode == 'val' and launches != STEPS:
            fail('K1 launched {} times in {} val steps'.format(
                launches, STEPS))
        print('main path {} mode: {:.3f} ms/step over {} steps (eval batch '
              '{}), peak {:.2f} GB, emd_cost_fused launches {}'.format(
                  mode, ms, STEPS, EVAL_BATCH, peak_gb, launches))
        profile_step(step, batch)
        report[mode] = dict(ms=ms, launches=launches)
    report['clouds_max_rel_err'] = main_path_clouds_check(net, cfg, batch)
    return report


def loss_clouds(gen, b, n, m, keep, gap=0.0):
    """Clouds on the card as the JAX package's loss-kernel tests draw
    them (tests/test_ops.py:313-317); with keep < 1 (n == m) both are
    zeroed outside one random mask, as the 'emd' loss masks the maps (a
    share 1 - keep of exact zero points). With gap > 0 the two clouds
    are drawn apart instead, around (+gap, 0, 0) and (-gap, 0, 0) with
    spread 0.25: no point has a near neighbour in the other cloud or
    near the masked points at the origin."""
    if gap > 0:
        shift = torch.tensor([gap, 0.0, 0.0], device='cuda')
        xyz1 = torch.randn(b, n, 3, generator=gen, device='cuda') * 0.25 + shift
        xyz2 = torch.randn(b, m, 3, generator=gen, device='cuda') * 0.25 - shift
    else:
        xyz1 = torch.randn(b, n, 3, generator=gen, device='cuda')
        xyz2 = torch.randn(b, m, 3, generator=gen, device='cuda') * 0.6 + 0.1
    if keep < 1.0 and n == m:
        mask = (torch.rand(b, n, 1, generator=gen, device='cuda')
                < keep).float()
        xyz1, xyz2 = xyz1 * mask, xyz2 * mask
    return xyz1.contiguous(), xyz2.contiguous()


def assemble(xyz1, xyz2, acc):
    """The gradients of sum(cost) from K2's accumulators, as its
    backward assembles them."""
    _, grow, gcol, gx2t, gx1t = acc
    return (xyz1 * grow[..., None] - gx2t.transpose(1, 2),
            xyz2 * gcol[..., None] - gx1t.transpose(1, 2))


def floored_points(xyz1, xyz2, batch_chunk=4):
    """(B, N) and (B, M) masks of the points whose squared distance to
    some point of the other cloud is at or under K2's floor of 1e-20
    (masked slots at the origin): W = plan * 1e10 on such pairs."""
    rows, cols = [], []
    for i in range(0, xyz1.shape[0], batch_chunk):
        pinned = emd_ops._sq_dists(xyz1[i:i + batch_chunk],
                                   xyz2[i:i + batch_chunk]) \
            <= emd_ops._DIST_FLOOR
        rows.append(pinned.any(2))
        cols.append(pinned.any(1))
    return torch.cat(rows), torch.cat(cols)


def accumulator_errors(got, want, rows, cols):
    """Per accumulator (grow, gcol, gx2t, gx1t): max |got - want| /
    max |want| over the points with no floored partner, and for the
    floored points max |got - want| over max |want| of all points. The
    1e10 terms make a floored point's grow and gcol the largest values;
    normalised by them, an error on every other point would pass."""
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


def pair_errors(got, want):
    """Per cloud pair, the worse of the two clouds' gradients: max |got -
    want| / max |want|, and ||got - want|| / ||want|| (L2)."""
    worst, l2 = [], []
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        worst.append((g - w).abs().amax(dim=(1, 2)) /
                     w.abs().amax(dim=(1, 2)).clamp(min=1e-30))
        l2.append((g - w).norm(dim=(1, 2)) /
                  w.norm(dim=(1, 2)).clamp(min=1e-30))
    return torch.stack(worst).amax(0), torch.stack(l2).amax(0)


def float64_gradients(xyz1, xyz2, batch_chunk=4):
    """The assembled gradients from a float64 run of K2's arithmetic
    (the plain version's, in float64) on every pair."""
    x1, x2 = xyz1.double(), xyz2.double()
    parts = [assemble(x1[i:i + batch_chunk], x2[i:i + batch_chunk],
                      emd_ops._emd_loss_accumulators_chunk(
                          x1[i:i + batch_chunk], x2[i:i + batch_chunk]))
             for i in range(0, x1.shape[0], batch_chunk)]
    return tuple(torch.cat(side) for side in zip(*parts))


def compare_k2(label, xyz1, xyz2, cost_rtol, conditioned):
    """K2 against its plain version (the same arithmetic in the same
    order, through (pairs, n, m) matrices), both against a float64 run
    on every pair. Fails unless: the cost is within ``cost_rtol``; each
    accumulator within 5e-3 (accumulator_errors; tests/test_ops.py:352);
    and the assembled gradients, per pair, within 2e-2 of their largest
    component of both the plain and the float64 version
    (tests/test_ops.py:379) when ``conditioned``, else within 2e-2 of the
    float64 version in L2 norm (see kernel_phase_k2)."""
    b, n, m = xyz1.shape[0], xyz1.shape[1], xyz2.shape[1]
    got = emd_ops.emd_loss_accumulators(xyz1, xyz2)
    want = emd_ops.emd_loss_plain_accumulators(xyz1, xyz2, batch_chunk=8)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(x).all()) for x in got):
        fail('K2 gave non-finite outputs for {} {}'.format(label, (b, n, m)))
    cost_abs, cost_rel = rel_err(got[0], want[0])
    rows, cols = floored_points(xyz1, xyz2)
    acc = accumulator_errors(got, want, rows, cols)
    grads, grads_plain = assemble(xyz1, xyz2, got), assemble(xyz1, xyz2,
                                                             want)
    grads_ref = float64_gradients(xyz1, xyz2)
    to_plain, _ = pair_errors(grads, grads_plain)
    to_ref, to_ref_l2 = pair_errors(grads, grads_ref)
    plain_to_ref, plain_to_ref_l2 = pair_errors(grads_plain, grads_ref)
    r = dict(shape=(b, n, m), xyz1=xyz1, xyz2=xyz2, max_abs_err=cost_abs,
             max_rel_err=cost_rel, acc_max_rel_err=max(acc),
             grad_max_rel_err=float(to_plain.max()),
             grad_vs_float64=float(to_ref.max()),
             grad_vs_float64_l2=float(to_ref_l2.max()),
             plain_grad_vs_float64=float(plain_to_ref.max()),
             plain_grad_vs_float64_l2=float(plain_to_ref_l2.max()))
    print('kernel emd_loss {} {}: cost max_rel_err={:.3e}; accumulators '
          '(grow, gcol, gx2t, gx1t) max_rel_err={}; floored points {:.2f}; '
          'gradients per pair, worst of {}: kernel vs plain {:.3e}, vs '
          'float64 {:.3e} (L2 {:.3e}); plain vs float64 {:.3e} (L2 {:.3e})'
          .format(label, (b, n, m), cost_rel,
                  ['{:.2e}'.format(x) for x in acc],
                  float(rows.float().mean()), b, r['grad_max_rel_err'],
                  r['grad_vs_float64'], r['grad_vs_float64_l2'],
                  r['plain_grad_vs_float64'], r['plain_grad_vs_float64_l2']))
    if cost_rel > cost_rtol or max(acc) >= 5e-3:
        fail('K2 disagrees with its plain version for {} {}'.format(
            label, (b, n, m)))
    if (max(r['grad_max_rel_err'], r['grad_vs_float64']) > 2e-2
            if conditioned else r['grad_vs_float64_l2'] > 2e-2):
        fail('K2 gradients out of bounds for {} {}'.format(label, (b, n, m)))
    return r


def kernel_phase_k2(seed):
    """K2 at the train step's (32, 2304, 2304) and at small odd shapes.
    Tolerances (compare_k2), as the JAX package holds its loss kernel:
    cost 1e-3 relative (K1's bound), each accumulator 5e-3, the assembled
    gradients 2e-2 of their largest component per pair.

    That bound presumes a well-conditioned plan, and at 2304 random
    points per cloud the plan is not: exp(level * d) at levels down to
    -65536 turns an ulp of d into a relative change of the weight, the
    masked points leave float32 residues of their capacity that leak to
    real points near the origin, and a column close to saturation turns
    such a small absolute change into a large relative one for every
    row it dominates. The gradient, xyz1 * rowsum W - W xyz2 with W =
    plan / |p - q|, then moves by a large share of its largest component
    on a few pairs, in any float32 version: on the random masked clouds
    the plain one lies 4e-2 from float64 on one CPU pair
    (tests/test_torch_emd_loss.py::
    test_float32_gradient_conditioning_at_train_size) and up to 0.19 on
    the card's 32 pairs. There each pair's gradients are held to
    float64 in L2 norm (2e-2) and their largest-component distances are
    printed. The well-conditioned cases hold the full bound: the small
    shapes, and the train step's shape with 40% masked points on clouds
    drawn apart, whose points all lie away from the other cloud and from
    the origin (float32 within ~1e-5 of float64 there). A kernel that
    drops the last round's row-side sums, or only their grow, is 0.1-0.2
    off there; one that skips a column fails the accumulators."""
    gen = torch.Generator(device='cuda').manual_seed(seed + 2)
    cases = [('train step, masked', 32, 2304, 2304, 0.6, 0.0, False),
             ('train step, masked, drawn apart', 32, 2304, 2304, 0.6, 2.5,
              True),
             ('rectangular', 2, 256, 128, 1.0, 0.0, True),
             ('odd, int factors differ', 1, 60, 52, 1.0, 0.0, True)]
    results = []
    for label, b, n, m, keep, gap, conditioned in cases:
        xyz1, xyz2 = loss_clouds(gen, b, n, m, keep, gap)
        results.append(compare_k2(label, xyz1, xyz2, 1e-3, conditioned))

    # Identical clouds: the matched pairs coincide; the gradient through
    # the autograd wrapper stays finite (the 1e-20 floor)
    x = torch.randn(1, 128, 3, generator=gen, device='cuda').requires_grad_()
    cost = emd_ops.emd_distance(x, x.detach().clone())
    cost.sum().backward()
    if not bool(torch.isfinite(x.grad).all()):
        fail('K2 gradient not finite for identical clouds')
    print('kernel emd_loss identical clouds (1, 128, 128): cost {:.3e}, '
          'gradient finite, max |grad| {:.3e}'.format(
              float(cost.detach()), float(x.grad.abs().max())))

    prod, apart = results[0], results[1]
    x1, x2 = prod['xyz1'], prod['xyz2']
    ms = time_cuda(lambda: emd_ops.emd_loss_accumulators(x1, x2), reps=5)
    plain_ms = time_cuda(lambda: emd_ops.emd_loss_plain_accumulators(
        x1, x2, batch_chunk=8), reps=2)
    prod['apart_grad_max_rel_err'] = max(apart['grad_max_rel_err'],
                                         apart['grad_vs_float64'])
    return prod, ms, plain_ms, apart


def active_clusters(name, b, n, m, c):
    """Clusters of c blocks of kernel ``name`` the card holds at once."""
    query = getattr(cuda_build.load(name), name + '_active_clusters')
    query.argtypes = [ctypes.c_int] * 4
    query.restype = ctypes.c_int
    return query(b, n, m, c)


def sweep_phase(cases):
    """What K1 and K2 share: one annealing sweep (csrc/emd_sweep.cuh),
    launched as a cluster of c blocks per cloud pair, whose row and
    column sums run in an order that does not depend on c. On each
    case's clouds: (b) K1's and K2's costs within 1e-6 relative (the
    same arithmetic on the saturations and the cost at the same c); (c)
    pairs launched alone (b = 1, c = 8) against the same pairs inside
    their batch: K2's four accumulators bitwise equal, K1's and K2's
    costs within 1e-6 relative (only the cost is summed over the
    cluster's blocks, in rank order)."""
    for name, b in (('emd_loss', 32), ('emd_cost_fused', 128)):
        print('occupancy {} at ({}, 2304, 2304): clusters the card holds '
              'at once for c = 1..8: {}'.format(name, b, [
                  active_clusters(name, b, 2304, 2304, c)
                  for c in range(1, 9)]))
    k1_k2, alone = 0.0, 0.0
    for label, case in cases:
        x1, x2 = case['xyz1'], case['xyz2']
        b, n, m = case['shape']
        k1 = emd_ops.emd_cost_fused(x1, x2)
        k2 = emd_ops.emd_loss_accumulators(x1, x2)
        _, rel = rel_err(k1, k2[0])
        k1_k2 = max(k1_k2, rel)
        worst, bitwise = 0.0, True
        pairs = sorted({0, 1, b - 1})
        for i in pairs:
            a1 = emd_ops.emd_cost_fused(x1[i:i + 1], x2[i:i + 1])
            a2 = emd_ops.emd_loss_accumulators(x1[i:i + 1], x2[i:i + 1])
            bitwise &= all(torch.equal(g[i], a[0])
                           for g, a in zip(k2[1:], a2[1:]))
            worst = max(worst, rel_err(a1, k1[i:i + 1])[1],
                        rel_err(a2[0], k2[0][i:i + 1])[1])
        alone = max(alone, worst)
        print('shared sweep {} {}: K1 vs K2 cost max_rel_err={:.3e} '
              '(bound 1e-6) at cluster {}; pairs {} alone (cluster {}) vs '
              'in the batch: K2 accumulators bitwise equal {}, costs '
              'max_rel_err={:.3e} (bound 1e-6)'.format(
                  label, (b, n, m), rel,
                  emd_ops.cluster_size('emd_loss', b, n, m), pairs,
                  emd_ops.cluster_size('emd_loss', 1, n, m), bitwise, worst))
        if rel > 1e-6:
            fail('K1 and K2 costs differ on {}: rel {}'.format(label, rel))
        if not bitwise or worst > 1e-6:
            fail('a pair alone differs from the same pair in its batch on '
                 '{}'.format(label))
    return dict(k1_k2_cost_max_rel_err=k1_k2,
                alone_vs_batch_cost_max_rel_err=alone)


def tiny_train_config():
    return NetConfig(num_boxes=4, image_input_shape=(96, 320),
                     resized_full_img_shape=(48, 160),
                     proposal_fc_sizes=(64, 64), regression_fc_sizes=(64, 64),
                     resnet='resnet_tiny', compute_dtype='float32')


class GradientRecorder:
    """An optimizer that keeps a CPU copy of the raw gradients of each
    update, then hands them to the wrapped one."""

    def __init__(self, tx):
        self.tx, self.grads = tx, []

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, state):
        self.grads.append({k: v.detach().cpu().clone()
                           for k, v in grads.items()})
        return self.tx.update(grads, state)


def gradient_errors(got, want):
    """(||got - want|| / ||want|| over all leaves, the worst leaf's max
    |got - want| over its allowance 2e-2 max|want leaf| + 1e-5 max|want|),
    the bounds of tests/test_torch_train_grads.py::check_gradients."""
    gmax = max(float(w.abs().max()) for w in want.values())
    num = sum(float(((got[k] - w) ** 2).sum()) for k, w in want.items())
    den = sum(float((w ** 2).sum()) for w in want.values())
    leaf = max(float((got[k] - w).abs().max()) /
               (2e-2 * float(w.abs().max()) + 1e-5 * gmax)
               for k, w in want.items())
    return (num / den) ** 0.5, leaf


def train_reference(seed):
    """Two train steps of a tiny float32 configuration with the 'emd' loss
    on the card against the same steps on the CPU, from the same weights
    and batch of 2 images. The first step's gradients, as the step hands
    them to the optimizer, are held as tests/test_torch_train_grads.py
    holds the port's against the JAX package's: within 5e-3 in L2 norm
    over all leaves, each leaf within 2e-2 of its largest component plus
    1e-5 of the largest of any leaf (the backbone's backward moves by a
    few 1e-3 on some leaves for an ulp of change at the ReLU kinks).
    Losses and decoder batch statistics: the same float32 math (TF32 off)
    summed in other orders, and K2 against the CPU's plan path: rtol
    1e-3, atol 1e-3 * max|x|. Parameters and the EMA are only a smoke
    check, atol 4 lr: an Adam step moves each parameter by about lr
    whatever its gradient."""
    cfg = tiny_train_config()
    batch = synthetic_batch(seed + 3, cfg, 2, (96, 320), (96, 320))
    lr = TRAIN_CONFIG['optimizer']['adam_optimizer']['initial_learning_rate']
    runs = []
    for device in ('cpu', 'cuda'):
        net = monopsr.create_net(cfg, device='cpu', seed=seed)
        tx, _, use_ema, decay = opt_lib.build_optimizer(TRAIN_CONFIG)
        tx = GradientRecorder(tx)
        step = trainer.make_train_step(net, cfg, EMD_LOSS_CONFIG, tx,
                                       use_ema, decay, device=device)
        state = trainer.create_train_state(net, tx, use_ema)
        losses = []
        for _ in range(2):
            state, step_losses = step(state, batch)
            losses.append({k: v.cpu() for k, v in step_losses.items()})
        runs.append(dict(
            losses=losses, grads=tx.grads[0],
            params={k: v.detach().cpu() for k, v in state.params.items()},
            ema={k: v.cpu() for k, v in state.ema_params.items()},
            stats={k: v.cpu() for k, v in state.batch_stats.items()
                   if 'map_decoder' in k and 'num_batches' not in k}))
    want, got = runs
    worst = 0.0

    def check(what, g, w, atol):
        nonlocal worst
        excess = float(((g - w).abs() - 1e-3 * w.abs()).max())
        worst = max(worst, excess / atol)
        if not bool(torch.isfinite(g).all()) or excess > atol:
            fail('train reference mismatch in {}: max |diff| {:.3e}'.format(
                what, float((g - w).abs().max())))

    grad_l2, grad_leaf = gradient_errors(got['grads'], want['grads'])
    if not all(bool(torch.isfinite(g).all()) for g in got['grads'].values()) \
            or grad_l2 >= 5e-3 or grad_leaf > 1.0:
        fail('train reference: first-step gradients differ, L2 {:.3e}, '
             'worst leaf {:.3f} of its allowance'.format(grad_l2, grad_leaf))
    for i, (g_losses, w_losses) in enumerate(zip(got['losses'],
                                                 want['losses'])):
        for key, w in w_losses.items():
            check('step {} {}'.format(i, key), g_losses[key], w,
                  1e-3 * max(1.0, float(w.abs().max())))
    for part in ('params', 'ema'):
        for key, w in want[part].items():
            check('{} {}'.format(part, key), got[part][key], w, 4 * lr)
    for key, w in want['stats'].items():
        check('batch stats ' + key, got['stats'][key], w,
              1e-3 * float(w.abs().max()))
    print('train reference (tiny config, emd loss, 2 steps, card vs CPU): '
          'ok; first-step gradients L2 {:.3e} (bound 5e-3), worst leaf '
          '{:.3f} of its allowance; losses, stats, params, EMA worst {:.3f} '
          'of tolerance; total_loss {}'.format(
              grad_l2, grad_leaf, worst,
              [round(float(x['total_loss']), 3) for x in got['losses']]))


def train_clouds_check(net, cfg, batch):
    """K2 against its plain version and a float64 run on the very clouds
    the next 'emd'-loss train step hands it: the masked predicted and GT
    local xyz maps from a train-mode forward of the batch (the decoder's
    batch statistics are put back after it). Both clouds lie within a
    few metres of the origin, with 40% masked points, the regime of the
    random masked clouds of kernel_phase_k2: the gradients are held to
    float64 in L2 norm per pair. The cost within 5e-3 relative, the JAX
    package's bound for its kernel at this shape (tests/test_ops.py:307),
    as K1 is held on its own clouds; the accumulators within 5e-3."""
    saved = {k: v.clone() for k, v in net.named_buffers()}
    with torch.no_grad():
        dev = evaluator.batch_to_device(batch, 'cuda')
        outputs = net(**monopsr.net_inputs_from_batch(dev))
        gt = monopsr.build_gt_dict(cfg, dev, outputs)
        valid = gt[C.KEY_VALID_MASK_MAPS]
        pts = [(maps * valid).reshape(-1, valid.shape[2] * valid.shape[3], 3)
               .float().contiguous()
               for maps in (outputs[C.KEY_INST_XYZ_MAP_LOCAL],
                            gt[C.KEY_INST_XYZ_MAP_LOCAL])]
        for k, v in net.named_buffers():
            v.copy_(saved[k])
    print('train step\'s own clouds {}: valid points {:.2f}, max |p| {:.1f}, '
          'max |q| {:.1f}'.format(tuple(pts[0].shape), float(valid.mean()),
                                  float(pts[0].norm(dim=-1).max()),
                                  float(pts[1].norm(dim=-1).max())))
    return compare_k2('on the train step\'s own clouds', *pts, 5e-3, False)


def main_path_train(seed):
    """The production net's train step at train batch 1 in both loss
    configurations; K2 must run once per EMD-loss step and never for the
    production loss, K1 never."""
    cfg = production_config()
    batch = synthetic_batch(seed, cfg, TRAIN_BATCH, (375, 1242),
                            C.DEPTH_PAD_SHAPE)
    report = {}
    for name, loss_config, want_k2 in (
            ('production loss', LOSS_CONFIG, 0),
            ('emd loss', EMD_LOSS_CONFIG, STEPS)):
        net = monopsr.create_net(cfg, device='cuda', seed=seed)
        tx, _, use_ema, decay = opt_lib.build_optimizer(TRAIN_CONFIG)
        step = trainer.make_train_step(net, cfg, loss_config, tx, use_ema,
                                       decay, device='cuda')
        state = trainer.create_train_state(net, tx, use_ema)
        start = {k: v.detach().clone() for k, v in state.params.items()}
        ema_start = {k: v.clone() for k, v in state.ema_params.items()}
        state, _ = step(state, batch)                # warm-up (cuDNN plans)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        emd_ops.emd_distance.launches = 0
        emd_ops.emd_cost_fused.launches = 0
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state, losses = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / STEPS * 1e3
        k2 = emd_ops.emd_distance.launches
        k1 = emd_ops.emd_cost_fused.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        for key, value in losses.items():
            if not bool(torch.isfinite(value).all()):
                fail('train {}: loss {} not finite'.format(name, key))
        moved = sum(int((state.params[k] != v).any()) for k, v in
                    start.items())
        ema_moved = sum(int((state.ema_params[k] != v).any()) for k, v in
                        ema_start.items())
        if k2 != want_k2 or k1 != 0:
            fail('train {}: emd_loss launched {} times (want {}), '
                 'emd_cost_fused {} times in {} steps'.format(
                     name, k2, want_k2, k1, STEPS))
        if not moved or not ema_moved:
            fail('train {}: parameters or EMA did not change'.format(name))
        print('main path train, {}: {:.3f} ms/step over {} steps (train '
              'batch {}), peak {:.2f} GB, emd_loss launches {}, '
              'emd_cost_fused launches {}; losses finite (total {:.3f}, '
              'inst_xyz_map_local {:.3f}); {} of {} parameter tensors and '
              '{} EMA tensors changed'.format(
                  name, ms, STEPS, TRAIN_BATCH, peak_gb, k2, k1,
                  float(losses['total_loss']),
                  float(losses['inst_xyz_map_local']), moved, len(start),
                  ema_moved))
        profile_step(lambda b: step(state, b), batch)
        report[name] = dict(ms=ms, launches=k2, peak_gb=peak_gb)
        if want_k2:
            report['clouds'] = train_clouds_check(net, cfg, batch)
        del net, state, step, start, ema_start
        torch.cuda.empty_cache()
    return report


# --------------------------------------------------------------------------
# Train loop: the training CLI on the KITTI fixture
# --------------------------------------------------------------------------

TRAIN_LOOP_NAME = 'chip_smoke_train'
CLI_TIMEOUT_S = 600


def production_yaml(name, subs):
    """configs/monopsr_model_000.yaml with the fixture's dataset and MSCNN
    paths and the (key, value, times) substitutions ``subs``, written by
    text substitution (the card's machine has no YAML library) to
    build/chip_smoke/<name>.yaml; returns the path."""
    top = monopsr_torch.top_dir()
    fixture = os.path.join(top, 'tests', 'datasets', 'Kitti', 'object')
    with open(os.path.join(top, 'configs', 'monopsr_model_000.yaml')) as f:
        text = f.read()
    for key, value, times in [('dataset_dir', "'{}'".format(fixture), 1)] + \
            list(subs):
        text, n = re.subn(r'(?m)^(\s*{}:)[^#\n]*'.format(key),
                          lambda m: m.group(1) + ' ' + value, text)
        if n != times:
            fail('config {}: key {} found {} times, want {}'.format(
                name, key, n, times))
    text = text.replace('    dataset_dir:', "    mscnn_dir: '{}'\n"
                        "    dataset_dir:".format(
                            os.path.join(fixture, 'mscnn')), 1)
    out_dir = os.path.join(top, 'build', 'chip_smoke')
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name + '.yaml')
    with open(path, 'w') as f:
        f.write(text)
    return path


def train_loop_config(max_iterations):
    """The production config at full width and depth with seed 0,
    ``max_iterations``, a summary every step and a checkpoint every 2, in
    build/chip_smoke/<TRAIN_LOOP_NAME>.yaml."""
    return production_yaml(TRAIN_LOOP_NAME, [
        ('seed', '0', 1), ('max_iterations', str(max_iterations), 1),
        ('summary_interval', '1', 1), ('checkpoint_interval', '2', 1)])


def run_cli(module, args, first_prefix, package='monopsr_torch.experiments',
            exit_codes=(0,)):
    """Runs ``python -m <package>.<module> <args>`` on the card in a
    subprocess; returns its printed lines, the seconds from its start to
    its first line starting with ``first_prefix`` (None if none) and its
    exit code. Killed after CLI_TIMEOUT_S; fails unless its exit code is
    one of ``exit_codes``."""
    cmd = [sys.executable, '-u', '-m', package + '.' + module] + list(args)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=monopsr_torch.top_dir(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    timer = threading.Timer(CLI_TIMEOUT_S, proc.kill)
    timer.start()
    lines, first_s = [], None
    try:
        for line in proc.stdout:
            lines.append(line.rstrip('\n'))
            if first_s is None and line.startswith(first_prefix):
                first_s = time.perf_counter() - t0
        rc = proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc not in exit_codes:
        print('\n'.join(lines[-40:]), file=sys.stderr)
        fail('{}: the CLI exited {} ({})'.format(module, rc, ' '.join(args)))
    return lines, first_s, rc


def run_training_cli(config_path):
    """The training CLI on the card (``run_cli``, timed to its first
    step line)."""
    return run_cli('run_training', ['--config_path', config_path], 'step ')


def loader_times(config_path):
    """The host loader's ms per sample over every fixture train sample,
    on this process's one thread: the PNG decodes inside get_sample_dict
    (timed by wrapping image_io.read_png, which the dataset layer calls),
    the rest of the sample's assembly (get_sample_dict less its decodes),
    and prepare_sample (resize and encodings) of the valid samples."""
    config = config_lib.parse_yaml_config(config_path)
    dataset = KittiDataset(config.dataset_config, 'train')
    shape = tuple(config.model_config.image_input_shape)
    read_png, decoding = image_io.read_png, []

    def timed_read_png(path):
        t0 = time.perf_counter()
        try:
            return read_png(path)
        finally:
            decoding.append(time.perf_counter() - t0)

    decode, assembly, prepare = [], [], []
    image_io.read_png = timed_read_png
    try:
        for i in range(dataset.num_samples):
            del decoding[:]
            t0 = time.perf_counter()
            sample, = dataset.get_sample_dict([i])
            t1 = time.perf_counter()
            decode.append(sum(decoding) * 1e3)
            assembly.append((t1 - t0) * 1e3 - decode[-1])
            if sample is not None:
                trainer.prepare_sample(sample, shape)
                prepare.append((time.perf_counter() - t1) * 1e3)
    finally:
        image_io.read_png = read_png
    # what one thread spends per sample it hands to the step (samples
    # without a valid object are read and dropped)
    delivered = (sum(decode) + sum(assembly) + sum(prepare)) / len(prepare)
    return dict(samples=len(decode), valid=len(prepare),
                decode_ms=float(np.mean(decode)),
                assembly_ms=float(np.mean(assembly)),
                prepare_ms=float(np.mean(prepare)),
                ms_per_delivered_sample=float(delivered))


def read_train_log(config):
    with open(os.path.join(config.logdir, 'train_log.jsonl')) as f:
        return [json.loads(line) for line in f]


def train_loop_phase(card):
    """The training CLI at production width on the fixture: 4 steps with
    checkpoints at 2 and 4, then a second call with 6 steps that resumes
    from 4. Fails unless both exit 0, every step's losses are finite,
    the second call restores step 4 and logs 5 and 6 only, and the
    checkpoints are at 2, 4 and 6. The outputs stay for the eval CLI
    phase (``main`` removes them after it)."""
    config_path = train_loop_config(4)
    config = config_lib.parse_yaml_config(config_path)
    torch.cuda.empty_cache()
    lines1, start1, _ = run_training_cli(config_path)
    log1 = read_train_log(config)
    manager = trainer.CheckpointManager(config.checkpoint_dir)
    if manager.all_steps() != [2, 4]:
        fail('train loop: checkpoints {} after 4 steps'.format(
            manager.all_steps()))
    lines2, start2, _ = run_training_cli(train_loop_config(6))
    log2 = read_train_log(config)[len(log1):]
    if manager.all_steps() != [2, 4, 6]:
        fail('train loop: checkpoints {} after the resumed run'.format(
            manager.all_steps()))
    if not any(line.startswith('restored checkpoint 4 ')
               for line in lines2):
        fail('train loop: the second call did not restore step 4')
    steps = {}
    for part, want in ((log1, [1, 2, 3, 4]), (log2, [5, 6])):
        records = [r for r in part if 'total_loss' in r]
        if [r['step'] for r in records] != want:
            fail('train loop: logged steps {}, want {}'.format(
                [r['step'] for r in records], want))
        for r in records:
            if not all(np.isfinite(v) for v in r.values()):
                fail('train loop: step {} logged {}'.format(r['step'], r))
            steps[r['step']] = r
    saves = [re.match(r'checkpoint (\d+): (\d+) bytes in ([0-9.]+) s',
                      line) for line in lines1 + lines2]
    saves = [(int(m.group(1)), int(m.group(2)), float(m.group(3)))
             for m in saves if m]
    restore_s = [float(re.match(r'restored checkpoint 4 in ([0-9.]+) s',
                                line).group(1))
                 for line in lines2 if line.startswith('restored')][0]
    memory = [r for r in log1 if any(k.startswith('bytes_in_use')
                                     for k in r)]
    ms = {k: 1e3 / r['steps_per_sec'] for k, r in steps.items()}
    loader = loader_times(config_path)
    report = dict(
        ms_per_step={k: round(v, 3) for k, v in ms.items()},
        steady_ms_per_step=float(np.median([ms[2], ms[4], ms[6]])),
        total_loss={k: round(r['total_loss'], 4)
                    for k, r in steps.items()},
        checkpoint_bytes=saves[0][1],
        save_s=[s[2] for s in saves], restore_s=restore_s,
        start_to_first_step_s=[start1, start2],
        bytes_in_use_at_start=memory[0] if memory else None,
        loader=loader)
    print('train loop (run_training CLI, production width, KITTI '
          'fixture, seed 0): steps 1-4, then resumed at 4 for 5-6; '
          'checkpoints {}; total_loss {}'.format(
              manager.all_steps(), report['total_loss']))
    print('train loop: wall ms/step from steps_per_sec {} (steps 1 and '
          '5 are each call\'s first, 3 and 5 include the previous '
          'checkpoint\'s save); steady (steps 2, 4, 6) {:.3f} ms; '
          '{}'.format(report['ms_per_step'],
                      report['steady_ms_per_step'], card))
    print('train loop: checkpoint {} bytes, saves {} s, restore {:.3f} '
          's; seconds from the CLI\'s start to its first step {}; {}'
          .format(report['checkpoint_bytes'], report['save_s'],
                  restore_s, ['{:.1f}'.format(x) for x in
                              report['start_to_first_step_s']], card))
    print('train loop: host loader, one thread, per sample over the {} '
          'fixture train samples: PNG decode {:.3f} ms, assembly {:.3f} '
          'ms; prepare_sample {:.3f} ms per valid sample ({}); {:.3f} ms '
          'per sample delivered to the step ({})'.format(
              loader['samples'], loader['decode_ms'],
              loader['assembly_ms'], loader['prepare_ms'],
              loader['valid'], loader['ms_per_delivered_sample'], card))
    print('train loop: emd kernels on this path: none (the production '
          'loss_config runs no EMD loss; K1 runs in val-mode eval only)')
    return report


# --------------------------------------------------------------------------
# Eval reference: the Evaluator on the card against the CPU (tiny)
# --------------------------------------------------------------------------

EVAL_TINY_NAME = 'chip_smoke_eval_tiny'
EVAL_TINY_BATCH = 3


def tiny_eval_checkpoint(seed, base):
    """The tiny float32 copy of the production config (resnet_tiny, 4
    boxes, 48x160 input, 16x16 ROIs, eval batch EVAL_TINY_BATCH) and its
    checkpoint 1 under ``base`` (emptied first): seeded random weights,
    the EMA set apart at 0.9 of them. Returns (config path, config)."""
    path = production_yaml(EVAL_TINY_NAME, [
        ('seed', '0', 1), ('num_boxes', '4', 1),
        ('image_input_shape', '[48, 160]', 1),
        ('resized_full_img_shape', '[24, 80]', 1),
        ('img_roi_size', '[16, 16]', 1), ('map_roi_size', '[16, 16]', 1),
        ('layer_sizes', '[16, 16]', 2),
        ('compute_dtype', "'float32'\n    resnet: 'resnet_tiny'", 1),
        ('eval_batch', str(EVAL_TINY_BATCH), 1)])
    shutil.rmtree(base, ignore_errors=True)
    config = config_lib.parse_yaml_config(path, output_base_dir=base)
    net, _ = monopsr.create_net_from_config(
        config.model_config, config.dataset_config, device='cpu', seed=seed)
    tx, _, use_ema, _ = opt_lib.build_optimizer(
        config.train_config.to_dict())
    state = TrainState.create(net, tx, use_ema=use_ema)
    with torch.no_grad():
        for value in state.ema_params.values():
            value.mul_(0.9)
    trainer.save_checkpoint(trainer.CheckpointManager(config.checkpoint_dir),
                            state, 1)
    return path, config


def tiny_evaluator(path, checkpoint_dir, out_base, device):
    """An Evaluator of the tiny config's val split on ``device`` reading
    ``checkpoint_dir`` and writing under ``out_base``, native AP off."""
    config = config_lib.parse_yaml_config(path, output_base_dir=out_base)
    config.checkpoint_dir = checkpoint_dir
    config.dataset_config.data_split = 'val'
    return config, evaluator.Evaluator(
        config, KittiDataset(config.dataset_config, 'val'), 'val',
        do_kitti_native_eval=False, device=device)


def compare_box_files(dirs, label):
    """The box_3d txts of two runs: the same files, rows within rtol 1e-4
    + atol 1e-4; returns the worst error as a share of that tolerance."""
    names = sorted(os.listdir(dirs[0]))
    if sorted(os.listdir(dirs[1])) != names:
        fail('{}: box_3d files {} vs {}'.format(
            label, names, sorted(os.listdir(dirs[1]))))
    excess = 0.0
    for name in names:
        want, got = (np.loadtxt(os.path.join(d, name), ndmin=2)
                     for d in dirs)
        if got.shape != want.shape:
            fail('{}: {} rows {} vs {}'.format(label, name, got.shape,
                                              want.shape))
        excess = max(excess, float(
            (np.abs(got - want) / (1e-4 + 1e-4 * np.abs(want))).max()))
    return names, excess


def eval_reference(seed):
    """The Evaluator on a tiny float32 copy of the production config
    (resnet_tiny, 4 boxes, 48x160 input, 16x16 ROIs) on the fixture's val
    split, at eval batch EVAL_TINY_BATCH (a padded tail group), from one
    checkpoint written by ``save_checkpoint`` (seeded random weights, the
    EMA set apart at 0.9 of them), on the card and on the CPU. Fails
    unless the box_3d txts agree within rtol 1e-4 + atol 1e-4 (the bound
    the CPU tests hold the port to JAX with), each box's METRIC_EMD (K1 on
    the card, the plain version on the CPU) within 1e-4 relative, and K1
    launched once per dispatch group on the card."""
    base = os.path.join(monopsr_torch.top_dir(), 'build', 'chip_smoke',
                        EVAL_TINY_NAME)
    path, config = tiny_eval_checkpoint(seed, base)
    runs = {}
    for device in ('cpu', 'cuda'):
        dev_config, ev = tiny_evaluator(path, config.checkpoint_dir,
                                        os.path.join(base, device), device)
        emd_ops.emd_cost_fused.launches = 0
        result, = ev.run_latest_checkpoints([1])
        runs[device] = dict(config=dev_config, result=result,
                            launches=emd_ops.emd_cost_fused.launches)
    cpu, card = runs['cpu'], runs['cuda']
    valid = card['result']['num_samples']
    groups = -(-valid // EVAL_TINY_BATCH)
    if card['launches'] != groups or cpu['result']['num_samples'] != valid:
        fail('eval reference: K1 launched {} times for {} valid samples in '
             'groups of {}'.format(card['launches'], valid,
                                   EVAL_TINY_BATCH))
    dirs = [os.path.join(r['config'].pred_dir, 'box_3d', 'val', '1')
            for r in (cpu, card)]
    names, box_excess = compare_box_files(dirs, 'eval reference')
    if len(names) != valid:
        fail('eval reference: {} box_3d files for {} valid samples'.format(
            len(names), valid))
    want = cpu['result']['metrics_per_box'][C.METRIC_EMD]
    got = card['result']['metrics_per_box'][C.METRIC_EMD]
    emd_rel = float((np.abs(got - want) /
                     np.maximum(np.abs(want), 1e-30)).max())
    print('eval reference (Evaluator, tiny config, fixture val split, eval '
          'batch {}): {} valid samples, {} boxes; box_3d worst error {:.3f} '
          'of its tolerance; METRIC_EMD max rel err {:.3e} (bound 1e-4), '
          'card {} vs CPU {}; emd_cost_fused launches {} in {} groups'
          .format(EVAL_TINY_BATCH, valid, len(want), box_excess, emd_rel,
                  got.round(5), want.round(5), card['launches'], groups))
    if box_excess > 1.0 or not np.isfinite(got).all() or emd_rel > 1e-4:
        fail('eval reference: the card disagrees with the CPU')
    shutil.rmtree(base, ignore_errors=True)
    return dict(valid=valid, launches=card['launches'], groups=groups,
                emd_max_rel_err=emd_rel, box_worst_of_tolerance=box_excess)


# --------------------------------------------------------------------------
# Eval CLIs: run_evaluation and run_inference at production width
# --------------------------------------------------------------------------

_STAT_RE = r'{}: min [0-9.]+, max [0-9.]+, mean [0-9.]+, median ([0-9.]+)'


def cli_numbers(lines):
    """What the eval CLIs print, per checkpoint evaluated."""
    def grab(pattern, cast=float):
        return [tuple(cast(g) for g in m.groups()) for m in
                (re.match(pattern, line) for line in lines) if m]
    return dict(
        restore_s=grab(r'restored checkpoint (\d+) in ([0-9.]+) s'),
        feed_s=[g[0] for g in grab(_STAT_RE.format('feed dict time'))],
        infer_s=[g[0] for g in grab(_STAT_RE.format('inference time'))],
        launches=grab(r'kernel launches: emd_cost_fused (\d+), emd_loss '
                      r'(\d+) in (\d+) groups', int),
        native_s=grab(r'native eval of step (\d+): ([0-9.]+) s'),
        evaluated=grab(r'Evaluated (\d+) samples at step (\d+) in '
                       r'([0-9.]+) s'))


def ap_blocks(path):
    """{step: [AP lines]} of a native-eval results file."""
    blocks, step = {}, None
    with open(path) as f:
        for line in f:
            if line.startswith('step '):
                step = int(line.split()[1])
                blocks.setdefault(step, [])
            elif ' AP: ' in line and step is not None:
                blocks[step].append(line.strip())
    return blocks


def check_kitti_dir(kitti_dir, names, label):
    """One KITTI file per sample name, rows of 16 fields ending CRLF."""
    files = sorted(os.listdir(kitti_dir))
    if files != sorted(n + '.txt' for n in names):
        fail('{}: KITTI files {} for samples {}'.format(label, files, names))
    rows = 0
    for name in files:
        with open(os.path.join(kitti_dir, name), 'rb') as f:
            data = f.read()
        if not data:
            continue
        if not data.endswith(b'\r\n') or any(
                len(row.split()) != 16
                for row in data.decode().split('\r\n')[:-1]):
            fail('{}: KITTI file {} is not 16-field CRLF rows'.format(
                label, name))
        rows += len(data.decode().split('\r\n')) - 1
    return rows


def eval_cli_phase(card):
    """The evaluation CLI (val split, native AP on) over the train loop's
    checkpoints 2, 4 and 6, then the inference CLI at step 6 on the val
    and on the test split, each in a subprocess on the card at production
    width. Fails unless each exits 0; no evaluated_val.txt is written;
    each step has a box_3d txt per valid val sample and a KITTI file per
    val sample (16-field CRLF rows); each step's metrics_avg.csv is there
    and its eval_val.jsonl losses are finite; K1 launched once per
    dispatch group of each step (K2 never); both native-eval results
    files hold AP lines for each step; and the test split has a KITTI
    file per sample."""
    config = config_lib.parse_yaml_config(train_loop_config(6))
    path = os.path.join(monopsr_torch.top_dir(), 'build', 'chip_smoke',
                        TRAIN_LOOP_NAME + '.yaml')
    steps = [2, 4, 6]
    torch.cuda.empty_cache()
    val_lines, val_first, _ = run_cli('run_evaluation', [
        '--config_path', path, '--data_split', 'val'], 'first sample saved')
    val = cli_numbers(val_lines)

    # without --repeated the CLI writes no ledger (as the JAX evaluator's
    # run_latest_checkpoints; only the polling loop writes it)
    ledger = os.path.join(config.exp_output_dir, 'evaluated_val.txt')
    if os.path.exists(ledger):
        fail('eval CLIs: run_evaluation without --repeated wrote {}'.format(
            ledger))
    dataset_config = config.dataset_config
    dataset_config.data_split = 'val'
    dataset = KittiDataset(dataset_config, 'val')
    val_names = [s.name for s in dataset.sample_list]
    valid = sorted(str(s[C.SAMPLE_NAME]) for s in dataset.get_sample_dict(
        np.arange(dataset.num_samples)) if s is not None)
    with open(os.path.join(config.logdir, 'eval_val.jsonl')) as f:
        records = {r['step']: r for r in map(json.loads, f)
                   if 'losses' in r}
    pred = config.pred_dir
    kitti_rows = {}
    for step in steps:
        box_dir = os.path.join(pred, 'box_3d', 'val', str(step))
        if sorted(n[:-4] for n in os.listdir(box_dir)) != valid:
            fail('eval CLIs: step {} box_3d txts {} for valid samples {}'
                 .format(step, sorted(os.listdir(box_dir)), valid))
        kitti_rows[step] = check_kitti_dir(os.path.join(
            pred, 'kitti_predictions_3d', 'val', '0.1', str(step), 'data'),
            val_names, 'eval CLIs step {}'.format(step))
        csv = os.path.join(config.exp_output_dir, 'metrics', str(step), 'val',
                           'metrics_avg.csv')
        record = records.get(step)
        if not os.path.exists(csv) or record is None or not all(
                np.isfinite(v) for v in record['losses'].values()):
            fail('eval CLIs: step {} metrics_avg.csv / losses {}'.format(
                step, record))
    if [int(n) for n, _, _ in val['evaluated']] != [len(valid)] * 3 or any(
            k1 != groups or k2 != 0 or groups < 1
            for k1, k2, groups in val['launches']):
        fail('eval CLIs: evaluated {}, kernel launches {}'.format(
            val['evaluated'], val['launches']))
    aps = {}
    for regime in ('', 'low_iou_'):
        blocks = ap_blocks(os.path.join(
            pred, '{}_results_{}0.1.txt'.format(TRAIN_LOOP_NAME, regime)))
        if sorted(blocks) != steps or not all(blocks.values()):
            fail('eval CLIs: results {}: {}'.format(regime, blocks))
        aps['low IoU' if regime else 'standard'] = blocks[6]

    # Inference at step 6 (its val outputs go to the same directories)
    inf_lines, inf_first, _ = run_cli('run_inference', [
        '--config_path', path, '--data_split', 'val', '--ckpt_num', '6'],
        'first sample saved')
    test_lines, test_first, _ = run_cli('run_inference', [
        '--config_path', path, '--data_split', 'test', '--ckpt_num', '6'],
        'first sample saved')
    inf, test = cli_numbers(inf_lines), cli_numbers(test_lines)
    test_config = config_lib.parse_yaml_config(path).dataset_config
    test_config.data_split = 'test'
    test_config.data_split_dir = 'testing'
    test_config.has_kitti_labels = False
    test_names = [s.name for s in KittiDataset(test_config,
                                               'test').sample_list]
    test_rows = check_kitti_dir(os.path.join(
        pred, 'kitti_predictions_3d', 'test', '0.1', '6', 'data'),
        test_names, 'eval CLIs test split')
    if not test['evaluated'] or not inf['evaluated'] or test_rows < 1:
        fail('eval CLIs: inference evaluated val {} test {}, {} test rows'
             .format(inf['evaluated'], test['evaluated'], test_rows))

    def ms_per_image(numbers):
        return [1e3 * secs / n for n, _, secs in numbers['evaluated']]

    report = dict(
        val_ms_per_image=ms_per_image(val),
        inference_val_ms_per_image=ms_per_image(inf)[0],
        test_ms_per_image=ms_per_image(test)[0],
        val_feed_ms=[1e3 * x for x in val['feed_s']],
        val_infer_ms=[1e3 * x for x in val['infer_s']],
        inference_val_feed_ms=1e3 * inf['feed_s'][0],
        inference_val_infer_ms=1e3 * inf['infer_s'][0],
        test_feed_ms=1e3 * test['feed_s'][0],
        test_infer_ms=1e3 * test['infer_s'][0],
        start_to_first_sample_s=[val_first, inf_first, test_first],
        restore_s={'val': val['restore_s'], 'inference val':
                   inf['restore_s'], 'inference test': test['restore_s']},
        native_eval_s=val['native_s'],
        k1_launches=[k1 for k1, _, _ in val['launches']],
        groups=[g for _, _, g in val['launches']],
        valid_val_samples=len(valid), kitti_rows=kitti_rows,
        test_rows=test_rows, ap_step_6=aps)
    print('eval CLIs (production width, KITTI fixture, checkpoints 2/4/6 '
          'of the train loop): run_evaluation val {} valid of {} samples '
          'per step, K1 launches {} in groups {}; run_inference val and '
          'test at step 6; every output checked; {}'.format(
              len(valid), len(val_names), report['k1_launches'],
              report['groups'], card))
    print('eval CLIs: wall ms per image over each checkpoint\'s epoch: '
          'val {}, inference val {:.3f}, inference test {:.3f}; {}'.format(
              ['{:.3f}'.format(x) for x in report['val_ms_per_image']],
              report['inference_val_ms_per_image'],
              report['test_ms_per_image'], card))
    print('eval CLIs: per image, median over each checkpoint: val feed ms '
          '{} inference ms {}; inference CLI val feed {:.3f} inference '
          '{:.3f} ms; test feed {:.3f} inference {:.3f} ms; {}'.format(
              ['{:.3f}'.format(x) for x in report['val_feed_ms']],
              ['{:.3f}'.format(x) for x in report['val_infer_ms']],
              report['inference_val_feed_ms'],
              report['inference_val_infer_ms'], report['test_feed_ms'],
              report['test_infer_ms'], card))
    print('eval CLIs: seconds from start to first sample saved {}; restore '
          's {}; native eval s {}; {}'.format(
              ['{:.1f}'.format(x) for x in
               report['start_to_first_sample_s']],
              report['restore_s'], report['native_eval_s'], card))
    for regime, lines in aps.items():
        print('eval CLIs: AP of step 6 ({} regime; 6 steps of training from '
              'random init on the fixture, not an accuracy result): {}'
              .format(regime, ' | '.join(lines)))
    return report


# --------------------------------------------------------------------------
# Production reference: the production config on the card, float32 against
# the CPU and bfloat16 against float32
# --------------------------------------------------------------------------

# The boxes (their centroids), cen_z, alpha (bin logits, regressions),
# lwh and the local xyz map
PROD_REF_KEYS = (C.KEY_CENTROIDS, C.KEY_CEN_Z, C.KEY_ALPHA_BINS,
                 C.KEY_ALPHA_REGS, C.KEY_LWH, C.KEY_INST_XYZ_MAP_LOCAL)
BF16_BOUND = 5e-2


def reference_step(net, cfg, batch, device, metrics):
    """The val step's forward, GT, global outputs and losses (the EMD and
    Chamfer metrics too where ``metrics``), returning the compared
    outputs in float32 (not packed: the packed xyz map is float16) and
    the losses, on the CPU."""
    with torch.inference_mode():
        dev = evaluator.batch_to_device(batch, device)
        outputs = net(**monopsr.net_inputs_from_batch(dev))
        gt = monopsr.build_gt_dict(cfg, dev, outputs)
        outputs, gt = monopsr.add_global_outputs(cfg, dev, outputs, gt)
        losses, _ = monopsr.compute_losses(cfg, LOSS_CONFIG, outputs, gt)
        if metrics:
            values = monopsr.compute_metrics(cfg, outputs, gt)
            if not all(bool(torch.isfinite(v).all()) for v in values.values()):
                fail('production reference: non-finite metrics on '
                     + str(device))
    out = {key: outputs[key].float().cpu() for key in PROD_REF_KEYS}
    out.update({k: v.float().cpu() for k, v in losses.items()})
    return out


def production_reference(seed):
    """The production configuration (ResNet-101 towers, 32 boxes,
    320x1216 input) in val mode at eval batch 1, seeded random weights
    (one set, loaded into each net) and one synthetic sample, three ways:
    the card in float32 (compute dtype overridden), the CPU in float32,
    the card in bfloat16 as the production config runs. The card's val
    step runs the EMD and Chamfer metrics too (K1 once per step); the
    CPU's leaves them out (the plain EMD over 32 pairs of 2304 points
    would take most of this phase).

    Tolerances, per tensor (the centroids, cen_z, the alpha bin logits
    and regressions, lwh, the local xyz map; and, card float32 against
    the CPU, every loss):
    - card float32 against CPU float32: |d| <= 1e-3 |x| + 1e-3 max(1,
      max|x|), the slice reference's bound;
    - card bfloat16 against card float32: max|d| <= BF16_BOUND = 5e-2 of
      max|x|. bfloat16 keeps 8 significant bits (a rounding of 2^-9 of
      each value); over ~100 layers of random weights those roundings
      add up like a random walk, to ~1-2% of a tensor's largest value
      (0.6-1.6% measured on the CPU with these widths at a 96x320 input
      and 8 boxes); the bound leaves 3x room over that, and is fixed
      here before any run of this phase on the card.
    Prints the largest deviation per output, both ways."""
    cfg32 = dataclasses.replace(production_config(), compute_dtype='float32')
    cfg16 = production_config()
    batch = synthetic_batch(seed + 3, cfg32, 1, (375, 1242),
                            C.DEPTH_PAD_SHAPE)
    net = monopsr.create_net(cfg32, device='cpu', seed=seed)
    weights = {k: v.clone() for k, v in net.state_dict().items()}
    t0 = time.perf_counter()
    cpu = reference_step(net, cfg32, batch, 'cpu', metrics=False)
    cpu_s = time.perf_counter() - t0
    del net
    runs = {}
    for name, cfg in (('float32', cfg32), ('bfloat16', cfg16)):
        net = monopsr.create_net(cfg, device='cpu', seed=seed + 1)
        net.load_state_dict(weights)
        step_net = net.to('cuda').eval()
        emd_ops.emd_cost_fused.launches = 0
        runs[name] = reference_step(step_net, cfg, batch, 'cuda',
                                    metrics=True)
        if emd_ops.emd_cost_fused.launches != 1:
            fail('production reference: K1 launched {} times'.format(
                emd_ops.emd_cost_fused.launches))
        del net, step_net
        torch.cuda.empty_cache()
    report = {'cpu_s': cpu_s}
    for label, want_all, got_all, keys, bound in (
            ('card float32 vs CPU float32', cpu, runs['float32'], list(cpu),
             None),
            ('card bfloat16 vs card float32', runs['float32'],
             runs['bfloat16'], PROD_REF_KEYS, BF16_BOUND)):
        rows, worst, bad = [], 0.0, []
        for key in keys:
            want, got = want_all[key], got_all[key]
            err = (got - want).abs()
            if bound is None:        # the share of each element's allowance
                excess = float((err / (1e-3 * want.abs() + 1e-3 * max(
                    1.0, float(want.abs().max())))).max())
            else:
                excess = float(err.max()) / (bound * float(
                    want.abs().max()) or 1.0)
            worst = max(worst, excess)
            rows.append('{} {:.3e} of max|x| {:.3e}'.format(
                key, float(err.max()), float(want.abs().max())))
            if not bool(torch.isfinite(got).all()) or excess > 1.0:
                bad.append(key)
        print('production reference, {}: worst {:.3f} of its tolerance; '
              'largest |d| per output: {}'.format(label, worst,
                                                  '; '.join(rows)))
        if bad:
            fail('production reference, {}: outside the tolerance in {}'
                 .format(label, bad))
        report[label] = worst
    print('production reference: CPU float32 val step (no metrics) {:.1f} s'
          .format(cpu_s))
    return report


# --------------------------------------------------------------------------
# Data preparation: gen_depth_maps on the card, gen_instance_masks
# --------------------------------------------------------------------------

PREP_INPUTS = ('calib', 'image_2', 'velodyne', 'label_2')


def depth_parity(got, want, label):
    """tests/test_depth_fill.py's bounds on two float maps: |d| < 1e-3 m,
    at most 1 LSB of the uint16 file (metres * 256) apart once rounded,
    rounding flips on fewer than 0.5% of pixels, each where ``want`` lies
    within 0.26 LSB of a rounding boundary. Returns (max |d|, flips)."""
    err = float(np.abs(got - want).max())
    u_got = np.round(got * 256.0).astype(np.int64)
    u_want = np.round(want * 256.0).astype(np.int64)
    flips = u_got != u_want
    near = np.abs(want[flips] * 256.0 - np.round(want[flips] * 256.0))
    if (err >= 1e-3 or np.abs(u_got - u_want).max() > 1 or
            flips.mean() >= 5e-3 or not np.all(near > 0.5 - 0.26)):
        fail('data preparation: {}: max |d| {:.3e}, {} flips'.format(
            label, err, int(flips.sum())))
    return err, int(flips.sum())


def stored_parity(got, want, ours, label):
    """The stored uint16 ``got`` (truncated metres * 256) against ``want``:
    at most 1 LSB apart, on fewer than 0.5% of pixels, each where the
    float ``ours`` behind ``got`` lies within 0.26 LSB of an integer (the
    float behind ``want`` is within 1e-3 m = 0.256 LSB of it). Returns
    the count of differing pixels."""
    diff = got.astype(np.int64) - want.astype(np.int64)
    flips = diff != 0
    lsb = ours[flips] * 256.0
    if (np.abs(diff).max() > 1 or flips.mean() >= 5e-3 or
            not np.all(np.abs(lsb - np.round(lsb)) < 0.26)):
        fail('data preparation: {}: {} pixels differ, by up to {}'.format(
            label, int(flips.sum()), int(np.abs(diff).max())))
    return int(flips.sum())


def data_prep_phase(card):
    """The data-preparation path at KITTI's own sizes: the fixture's 13
    training frames (calib, image, velodyne, labels) copied under
    build/chip_smoke/prep/training/; ``python -m monopsr_torch.tools.
    gen_depth_maps`` on the card in a subprocess; each map against the
    shipped depth_2_multiscale/ file and against the same fill on the CPU
    (``depth_parity`` and ``stored_parity``, tests/test_depth_fill.py's
    bounds); ``gen_instance_masks`` from the shipped maps, which must give
    the shipped instance images pixel for pixel, and from the card's own
    maps (the differing pixels printed). Printed with the card's name and
    power limit: the fill's device ms per map (one warm-up, synchronized,
    median and range over the 13 maps), its CPU ms (a reference only), and
    each tool's wall seconds per sample and start-up seconds."""
    from monopsr_torch.ops import depth_fill
    from monopsr_torch.tools import gen_depth_maps
    top = monopsr_torch.top_dir()
    src = os.path.join(top, 'tests', 'datasets', 'Kitti', 'object',
                       'training')
    base = os.path.join(top, 'build', 'chip_smoke', 'prep')
    split = os.path.join(base, 'training')
    shutil.rmtree(base, ignore_errors=True)
    for name in PREP_INPUTS:
        shutil.copytree(os.path.join(src, name), os.path.join(split, name))
    shutil.copytree(os.path.join(src, 'depth_2_multiscale'),
                    os.path.join(split, 'depth_shipped'))
    names = sorted(n[:-4] for n in os.listdir(os.path.join(split,
                                                           'velodyne')))

    def tool(module, args):
        t0 = time.perf_counter()
        lines, start_s, _ = run_cli(
            module, ['--data_split_dir', split] + args, '1 / ',
            package='monopsr_torch.tools')
        wall = time.perf_counter() - t0
        done = [line for line in lines if re.match(r'\d+ / \d+ ', line)]
        if len(done) != len(names) or start_s is None:
            fail('data preparation: {} printed {}'.format(module, lines))
        return dict(start_s=start_s,
                    s_per_sample=(wall - start_s) / len(names))

    times = {'gen_depth_maps': tool('gen_depth_maps', [])}

    sparse = [gen_depth_maps.sparse_depth_map(split, n) for n in names]
    shapes = sorted({m.shape for m in sparse})
    depth_fill.fill_in_multiscale(torch.from_numpy(sparse[0]).cuda())
    card_ms, cpu_ms, worst = [], [], [0.0, 0, 0, 0]
    for name, m in zip(names, sparse):
        dev = torch.from_numpy(m).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        filled = depth_fill.fill_in_multiscale(dev)
        torch.cuda.synchronize()
        card_ms.append((time.perf_counter() - t0) * 1e3)
        filled = filled.cpu().numpy()
        t0 = time.perf_counter()
        cpu = depth_fill.fill_in_multiscale(m, device='cpu').numpy()
        cpu_ms.append((time.perf_counter() - t0) * 1e3)
        err, flips = depth_parity(filled, cpu, name + ' card vs CPU')
        stored = image_io.read_png(os.path.join(
            split, 'depth_2_multiscale', name + '.png'))
        shipped = image_io.read_png(os.path.join(
            src, 'depth_2_multiscale', name + '.png'))
        if stored.shape != m.shape:
            fail('data preparation: {} stored {} for {}'.format(
                name, stored.shape, m.shape))
        vs_shipped = stored_parity(stored, shipped, filled,
                                   name + ' tool vs shipped')
        vs_cpu = stored_parity(stored, (cpu * 256.0).astype(np.uint16),
                               filled, name + ' tool vs CPU')
        worst = [max(worst[0], err), worst[1] + flips,
                 worst[2] + vs_shipped, worst[3] + vs_cpu]
    pixels = sum(m.size for m in sparse)

    times['gen_instance_masks (shipped maps)'] = tool(
        'gen_instance_masks', ['--point_cloud_source', 'depth_shipped'])
    times['gen_instance_masks (card maps)'] = tool('gen_instance_masks', [])
    inst_differ = {}
    for name in names:
        shipped = image_io.read_png(os.path.join(
            src, 'instance_2_depth_2_multiscale', name + '.png'))
        from_shipped = image_io.read_png(os.path.join(
            split, 'instance_2_depth_shipped', name + '.png'))
        if not np.array_equal(from_shipped, shipped):
            fail('data preparation: the instance image of {} from the '
                 'shipped map differs from the shipped image in {} '
                 'pixels'.format(name, int((from_shipped != shipped).sum())))
        from_card = image_io.read_png(os.path.join(
            split, 'instance_2_depth_2_multiscale', name + '.png'))
        inst_differ[name] = int((from_card != shipped).sum())

    report = dict(
        maps=len(names), shapes=[list(s) for s in shapes],
        fill_card_ms_median=float(np.median(card_ms)),
        fill_card_ms_range=[min(card_ms), max(card_ms)],
        fill_cpu_ms_median=float(np.median(cpu_ms)),
        fill_cpu_ms_range=[min(cpu_ms), max(cpu_ms)],
        card_vs_cpu_max_abs_m=worst[0], card_vs_cpu_round_flips=worst[1],
        tool_vs_shipped_pixels=worst[2], tool_vs_cpu_pixels=worst[3],
        pixels=pixels, instance_pixels_differ_from_card_maps=inst_differ,
        tools=times)
    print('data preparation ({} fixture frames, shapes {}): card vs CPU max '
          '|d| {:.3e} m, {} rounding flips; the tool\'s uint16 maps differ '
          'from the shipped ones in {} and from the CPU fill in {} of {} '
          'pixels (each by 1 LSB, at a boundary); instance images from the '
          'shipped maps equal the shipped ones; from the card\'s maps {} '
          'pixels differ ({})'.format(
              len(names), shapes, worst[0], worst[1], worst[2], worst[3],
              pixels, sum(inst_differ.values()), inst_differ))
    print('data preparation: fill_in_multiscale device ms per map (one '
          'warm-up, synchronized) median {:.3f}, range {:.3f}-{:.3f}; CPU ms '
          'median {:.3f}, range {:.3f}-{:.3f} (reference only); {}'.format(
              report['fill_card_ms_median'], *report['fill_card_ms_range'],
              report['fill_cpu_ms_median'], *report['fill_cpu_ms_range'],
              card))
    print('data preparation: tools, wall s per sample and start-up s: {}; '
          '{}'.format('; '.join('{} {:.3f} s/sample, start {:.1f} s'.format(
              k, v['s_per_sample'], v['start_s']) for k, v in times.items()),
              card))
    shutil.rmtree(base, ignore_errors=True)
    return report


# --------------------------------------------------------------------------
# Data parallel: two ranks against one process
# --------------------------------------------------------------------------

DP_RANKS = 2
DP_STEPS = 2
DP_PARTS = ('params', 'ema', 'batch_stats', 'mu', 'nu')
DP_UPDATE_PARTS = ('params', 'ema', 'mu', 'nu')
DP_UPDATE_RTOL = 1e-2          # float32 parameters and EMA
DP_BF16_YARDSTICK_FACTOR = 2   # bfloat16, over bfloat16 vs float32
GATE_KEYS = ('metric', 'split_index', 'split_rotation', 'val_frames',
             'steps', 'step_evaluated', 'train_seconds', 'train', 'gates',
             'val', 'split_checks', 'splits', 'num_splits', 'checks',
             'pass')    # scripts/accuracy_gate.py's report


def dp_train_steps(cfg, checkpoint_dir, batch, device):
    """DP_STEPS train steps of the production loss from checkpoint 0 on
    this rank's rows of ``batch`` (all of it without a process group):
    (snapshot on the host, losses averaged over ranks, ms per step, the
    state's ``dp_digest``)."""
    net = monopsr.create_net(cfg, device=device, seed=0)
    tx, _, use_ema, decay = opt_lib.build_optimizer(TRAIN_CONFIG)
    step = trainer.make_train_step(net, cfg, LOSS_CONFIG, tx, use_ema,
                                   decay, device=device)
    state = trainer.create_train_state(net, tx, use_ema)
    trainer.restore_checkpoint(trainer.CheckpointManager(checkpoint_dir), 0,
                               state)
    data_parallel.replicate(trainer.state_tensors(state))
    rows = data_parallel.shard_rows(batch)
    ms = []
    for _ in range(DP_STEPS):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, losses = step(state, rows)
        data_parallel.mean_over_ranks(losses.values())
        torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return (dp_snapshot(state), {k: float(v) for k, v in losses.items()}, ms,
            dp_digest(state))


def dp_parts(state):
    """The parts of a train state that phase 14 compares, on its device."""
    return {'params': state.params, 'ema': state.ema_params,
            'batch_stats': {k: v for k, v in state.batch_stats.items()
                            if 'map_decoder' in k and 'running' in k},
            'mu': state.opt_state['mu'], 'nu': state.opt_state['nu']}


def dp_snapshot(state):
    """``dp_parts`` on the host."""
    return {part: {k: v.detach().cpu() for k, v in leaves.items()}
            for part, leaves in dp_parts(state).items()}


def dp_digest(state):
    """Each leaf's float64 sum and sum of squares, per part of
    ``dp_parts``, on the host: equal for bitwise equal states (the sums
    run the same deterministic reduction on the same bits)."""
    return {part: torch.stack([torch.stack([v.double().sum(),
                                            v.double().square().sum()])
                               for v in leaves.values()]).cpu()
            for part, leaves in dp_parts(state).items()}


def dp_rank(device, cfgs, checkpoint_dir, batch, eval_path, eval_ckpt_dir,
            out_dir):
    """One rank of phase 14 (started by ``data_parallel.launch``): the
    train steps in each compute dtype, the bfloat16 steps again with the
    gradients left per rank (the mean over ranks planted out), then the
    tiny Evaluator; rank 0 saves what the phase compares, every rank its
    states' digests and its K1 launches."""
    rank = data_parallel.rank()
    mean_over_ranks = data_parallel.mean_over_ranks
    runs = list(cfgs.items()) + [('bfloat16_planted', cfgs['bfloat16'])]
    for name, cfg in runs:
        if name == 'bfloat16_planted':
            data_parallel.mean_over_ranks = lambda tensors: None
        snap, losses, ms, digest = dp_train_steps(cfg, checkpoint_dir, batch,
                                                  device)
        data_parallel.mean_over_ranks = mean_over_ranks
        if rank == 0:
            torch.save(dict(snap=snap, losses=losses, ms=ms, digest=digest),
                       os.path.join(out_dir, 'train_{}.pt'.format(name)))
        torch.save(digest, os.path.join(out_dir, 'digest_{}_rank{}.pt'
                                        .format(name, rank)))
        del snap
        torch.cuda.empty_cache()
    _, ev = tiny_evaluator(eval_path, eval_ckpt_dir,
                           os.path.join(out_dir, 'eval_ranks'), device)
    emd_ops.emd_cost_fused.launches = 0
    result = ev.run_latest_checkpoints([1])[0]
    with open(os.path.join(out_dir, 'eval_rank{}.json'.format(rank)),
              'w') as f:
        json.dump({'launches': emd_ops.emd_cost_fused.launches,
                   'eval_batch': ev.eval_batch}, f)
    if rank == 0:
        np.save(os.path.join(out_dir, 'eval_emd.npy'),
                result['metrics_per_box'][C.METRIC_EMD])


def dp_float32_shares(got, want):
    """The float32 elementwise deviations of two ranks from one process
    as a share of their tolerance (``data_parallel_phase``), for the
    decoder running statistics and the Adam moments."""
    shares = {}
    for part in ('batch_stats', 'mu', 'nu'):
        scale = max(float(v.abs().max()) for v in want[part].values())
        worst = 0.0
        for key, w in want[part].items():
            g, w = got[part][key].float(), w.float()
            if part == 'batch_stats':
                tol = 1e-3 * float(w.abs().max()) + 1e-4 * w.abs()
            else:
                tol = 1e-2 * scale + 1e-4 * w.abs()
            worst = max(worst, float(((g - w).abs() / tol).max()))
        shares[part] = worst
    return shares


def dp_ranks_differ(base, name):
    """The parts of ``dp_parts`` in which run ``name``'s ranks ended with
    other digests (none when every rank holds the same bits)."""
    digests = [torch.load(os.path.join(base, 'digest_{}_rank{}.pt'.format(
        name, rank)), weights_only=True) for rank in range(DP_RANKS)]
    return [part for part in digests[0]
            if not all(torch.equal(d[part], digests[0][part])
                       for d in digests[1:])]


def dp_update_deviation(got, want, start):
    """For each of DP_UPDATE_PARTS, the L2 norm over all leaves of
    ``got - want`` as a share of that of ``want - start``: how far two
    runs' updates part, against how far the update went."""
    out = {}
    for part in DP_UPDATE_PARTS:
        off = moved = 0.0
        for key, w in want[part].items():
            w = w.double()
            off += float(((got[part][key].double() - w) ** 2).sum())
            moved += float(((w - start[part][key].double()) ** 2).sum())
        out[part] = (off / moved) ** 0.5
    return out


def data_parallel_phase(seed, card):
    """Two data-parallel ranks against one process, on the card.

    The ranks are started by ``data_parallel.launch`` with two ranks: NCCL
    on cuda:0 and cuda:1 when two cards are visible, else both ranks on
    cuda:0 over gloo, which takes CUDA tensors. (A config's
    ``data_parallel: 2`` would be clamped to 1 on one card, as JAX clamps
    its mesh; the phase calls ``launch`` itself.) With both ranks on one
    card the ms/step of two ranks measure correctness, not scaling.

    Train: the production config (production loss, Adam + EMA from
    TRAIN_CONFIG) from one seeded checkpoint, DP_STEPS steps at a global
    batch of 2 synthetic samples, one per rank, against one process at
    batch 2 on the same card; in float32 and then in bfloat16 (the
    production dtype). Adam moves an element whose gradient is rounding
    noise (a decoder conv bias ahead of a train-mode batch norm; any
    element whose gradient cancels to near 0) by up to ~lr either way,
    so the parameters, the EMA and, in bfloat16, the moments are held as
    a whole (``dp_update_deviation``): the L2 norm of two ranks'
    deviation from one process over all leaves, as a share of the L2
    norm of what the steps moved them. Float32, as
    tests/test_torch_data_parallel.py holds the ranks on the CPU:
    parameters and EMA within DP_UPDATE_RTOL of their update, Adam
    moments elementwise within 1e-2 of the moment's largest value over
    all leaves + rtol 1e-4, decoder running statistics within 1e-3 of
    each leaf's largest value + rtol 1e-4, logged losses within rtol
    1e-4 + 1e-4 of max(1, |loss|). Bfloat16: everything finite; the
    parameters, EMA and Adam moments within DP_BF16_YARDSTICK_FACTOR
    times the same share measured between one process's bfloat16 steps
    and its float32 ones (a random-init net's bfloat16 update is as far
    from two ranks' as from float32's: 0.96 of it for the parameters, on
    the H100); phase 12's 5% bound on what the forward gives, the logged
    losses (5% of the largest loss, as phase 12 takes 5% of an output's
    largest value) and the decoder running statistics (5% of each leaf's
    largest value). In both dtypes the ranks must end with the same bits
    (``dp_digest`` of every part equal): each steps on the one averaged
    gradient. The ranks then take the bfloat16 steps again with the
    gradients left per rank (the mean over ranks planted out): that run
    must fail the bfloat16 gate.

    Eval: phase 10's tiny config and checkpoint on the fixture's val
    split, two ranks (eval_batch 3 rounded up to 4) against one rank:
    the box_3d txts within rtol 1e-4 + atol 1e-4 and each box's
    METRIC_EMD within 1e-4 relative, as phase 10 holds the card to the
    CPU; every rank launches K1 once per dispatch group on its rows."""
    base = os.path.join(monopsr_torch.top_dir(), 'build', 'chip_smoke',
                        'data_parallel')
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    cfgs = {'float32': dataclasses.replace(production_config(),
                                           compute_dtype='float32'),
            'bfloat16': production_config()}
    batch = synthetic_batch(seed, cfgs['bfloat16'], DP_RANKS, (375, 1242),
                            C.DEPTH_PAD_SHAPE)
    ckpt_dir = os.path.join(base, 'checkpoints')
    net = monopsr.create_net(cfgs['bfloat16'], device='cuda', seed=seed)
    tx, _, use_ema, _ = opt_lib.build_optimizer(TRAIN_CONFIG)
    state = trainer.create_train_state(net, tx, use_ema)
    trainer.save_checkpoint(trainer.CheckpointManager(ckpt_dir), state, 0)
    start = dp_snapshot(state)
    del net, state
    eval_path, eval_config = tiny_eval_checkpoint(
        seed, os.path.join(base, 'eval'))
    torch.cuda.empty_cache()

    backend = data_parallel.backend_for(torch.device('cuda'), DP_RANKS)
    t0 = time.time()
    data_parallel.launch(dp_rank, DP_RANKS, 'cuda', cfgs, ckpt_dir, batch,
                         eval_path, eval_config.checkpoint_dir, base)
    ranks_s = time.time() - t0

    report = dict(ranks=DP_RANKS, backend=backend, ranks_s=ranks_s)
    one = {}
    for dtype, cfg in cfgs.items():
        two = torch.load(os.path.join(base, 'train_{}.pt'.format(dtype)),
                         weights_only=True)
        one[dtype], losses, ms, _ = dp_train_steps(cfg, ckpt_dir, batch,
                                                   'cuda')
        for part in DP_PARTS:
            if not all(bool(torch.isfinite(v).all())
                       for v in two['snap'][part].values()):
                fail('data parallel {}: {} not finite'.format(dtype, part))
        if not all(np.isfinite(v) for v in two['losses'].values()):
            fail('data parallel {}: losses not finite'.format(dtype))
        deviation = dp_update_deviation(two['snap'], one[dtype], start)
        ranks_differ = dp_ranks_differ(base, dtype)
        if ranks_differ:
            fail('data parallel {}: the ranks end with other states in {}'
                 .format(dtype, ranks_differ))
        if dtype == 'float32':
            shares = dp_float32_shares(two['snap'], one[dtype])
            for part in ('params', 'ema'):
                shares[part] = deviation[part] / DP_UPDATE_RTOL
            shares['losses'] = max(
                abs(two['losses'][k] - v) / (1e-4 * max(1.0, abs(v)))
                for k, v in losses.items())
        else:
            yardstick = dp_update_deviation(one['bfloat16'], one['float32'],
                                             start)
            bound = {part: DP_BF16_YARDSTICK_FACTOR * yardstick[part]
                     for part in DP_UPDATE_PARTS}
            shares = {part: deviation[part] / bound[part]
                      for part in DP_UPDATE_PARTS}
            stats = one['bfloat16']['batch_stats']
            shares['batch_stats'] = max(
                float((two['snap']['batch_stats'][k] - w).abs().max()) /
                (5e-2 * float(w.abs().max())) for k, w in stats.items())
            largest = max(abs(v) for v in losses.values())
            shares['losses'] = max(abs(two['losses'][k] - v)
                                   for k, v in losses.items()) / (
                                       5e-2 * largest)
            planted = torch.load(
                os.path.join(base, 'train_bfloat16_planted.pt'),
                weights_only=True)
            planted_deviation = dp_update_deviation(
                planted['snap'], one['bfloat16'], start)
            del planted
            planted_shares = {part: planted_deviation[part] / bound[part]
                              for part in DP_UPDATE_PARTS}
            planted_differ = dp_ranks_differ(base, 'bfloat16_planted')
            print('data parallel, train, bfloat16: L2 deviation over the '
                  'update of two ranks from one process {}, of bfloat16 '
                  'from float32 (one process; the yardstick) {}; with the '
                  'gradients left per rank: the ranks\' states differ in {}, '
                  'deviation {} ({} of {} yardsticks)'.format(
                      json.dumps(deviation), json.dumps(yardstick),
                      planted_differ, json.dumps(planted_deviation),
                      json.dumps({k: round(v, 4)
                                  for k, v in planted_shares.items()}),
                      DP_BF16_YARDSTICK_FACTOR))
            report['bfloat16_gate'] = dict(
                deviation=deviation, yardstick=yardstick,
                planted_deviation=planted_deviation,
                planted_shares=planted_shares, planted_differ=planted_differ)
            if not planted_differ and max(planted_shares.values()) <= 1.0:
                fail('data parallel bfloat16: the gate does not see the '
                     'gradients left per rank')
        report.setdefault('update_deviation', {})[dtype] = deviation
        print('data parallel, train, {} ({} ranks over {}, {}): worst '
              'deviation of two ranks from one process, as a share of its '
              'tolerance: {}; ms/step one process {} , two ranks {} (both '
              'ranks on one card measure correctness, not scaling)'.format(
                  dtype, DP_RANKS, backend, card,
                  json.dumps({k: round(v, 4) for k, v in shares.items()}),
                  [round(x, 3) for x in ms], [round(x, 3)
                                              for x in two['ms']]))
        if max(shares.values()) > 1.0:
            fail('data parallel {}: two ranks disagree with one process'
                 .format(dtype))
        report[dtype] = dict(shares=shares, ms_one=ms, ms_two=two['ms'])
        del two
    del one
    torch.cuda.empty_cache()

    ranks = []
    for rank in range(DP_RANKS):
        with open(os.path.join(base, 'eval_rank{}.json'.format(rank))) as f:
            ranks.append(json.load(f))
    config, ev = tiny_evaluator(eval_path, eval_config.checkpoint_dir,
                                os.path.join(base, 'eval_one'), 'cuda')
    emd_ops.emd_cost_fused.launches = 0
    result = ev.run_latest_checkpoints([1])[0]
    one_launches = emd_ops.emd_cost_fused.launches
    valid = result['num_samples']
    eval_batch = -(-EVAL_TINY_BATCH // DP_RANKS) * DP_RANKS
    groups = -(-valid // eval_batch)
    dirs = [os.path.join(base, 'eval_ranks', EVAL_TINY_NAME, 'predictions',
                         'box_3d', 'val', '1'),
            os.path.join(config.pred_dir, 'box_3d', 'val', '1')]
    names, box_excess = compare_box_files(dirs, 'data parallel eval')
    want = result['metrics_per_box'][C.METRIC_EMD]
    got = np.load(os.path.join(base, 'eval_emd.npy'))
    if got.shape != want.shape:
        fail('data parallel eval: {} boxes vs {}'.format(got.shape,
                                                          want.shape))
    emd_rel = float((np.abs(got - want) /
                     np.maximum(np.abs(want), 1e-30)).max())
    launches = [r['launches'] for r in ranks]
    print('data parallel, eval (tiny config, fixture val split, {} valid '
          'samples): {} ranks at eval batch {} against one rank at {}: '
          'box_3d worst error {:.3f} of its tolerance over {} files, '
          'METRIC_EMD max rel err {:.3e} (bound 1e-4); emd_cost_fused '
          'launches per rank {} in {} groups (one rank: {})'.format(
              valid, DP_RANKS, ranks[0]['eval_batch'], EVAL_TINY_BATCH,
              box_excess, len(names), emd_rel, launches, groups,
              one_launches))
    if (box_excess > 1.0 or emd_rel > 1e-4 or not np.isfinite(got).all()
            or len(names) != valid
            or any(r['eval_batch'] != eval_batch for r in ranks)
            or launches != [groups] * DP_RANKS):
        fail('data parallel eval: two ranks disagree with one rank')
    report['eval'] = dict(valid=valid, launches_per_rank=launches,
                          groups=groups, box_worst_of_tolerance=box_excess,
                          emd_max_rel_err=emd_rel)
    shutil.rmtree(base, ignore_errors=True)
    return report


# --------------------------------------------------------------------------
# Accuracy gate, short
# --------------------------------------------------------------------------

def accuracy_gate_phase(card):
    """The accuracy gate at 20 steps over one split, as a subprocess on the
    card. It is not expected to pass at 20 steps; it must reach its
    verdict: exit 0, or exit 1 with ``ACCURACY GATE FAILED: `` and the
    report's failed checks; the report holds every key of the JAX gate's
    report plus ``device``; both phases' AP curves come from the native
    AP transcripts (three numbers per curve, a ``step 20`` block per phase
    in each results file); every loss and metric is finite."""
    top = monopsr_torch.top_dir()
    out = os.path.join(top, 'build', 'chip_smoke', 'accuracy_short.json')
    if os.path.exists(out):
        os.remove(out)
    t0 = time.time()
    lines, _, rc = run_cli('accuracy_gate', [
        '--steps', '20', '--splits', '1', '--out', out], 'step ',
        exit_codes=(0, 1))
    wall_s = time.time() - t0
    with open(out) as f:
        report = json.load(f)
    missing = set(GATE_KEYS) - set(report)
    if missing or 'device' not in report:
        fail('accuracy gate: report lacks {}'.format(sorted(missing)))
    failed = [k for k, v in report['checks'].items() if not v]
    verdict = 'ACCURACY GATE FAILED: ' + ', '.join(failed)
    if rc != (1 if failed else 0) or (failed and lines[-1] != verdict):
        fail('accuracy gate: exit {} with last line {!r}, want {!r}'.format(
            rc, lines[-1], verdict))
    for phase in ('train', 'val'):
        for key in ('ap_image', 'ap_bev', 'ap_3d', 'ap_image_low',
                    'ap_bev_low', 'ap_3d_low'):
            if len(report[phase][key]) != 3:
                fail('accuracy gate: {} {} not read'.format(phase, key))
        values = (list(report[phase]['losses'].values()) +
                  list(report[phase]['metrics'].values()) +
                  list(report[phase]['metrics_abs'].values()))
        if not values or not all(np.isfinite(v) for v in values):
            fail('accuracy gate: {} losses or metrics not finite'.format(
                phase))
    pred_dir = os.path.join(monopsr_torch.data_dir(), 'outputs',
                            'accuracy_gate', 'predictions')
    for path in native_eval.results_paths(pred_dir, 'accuracy_gate', 0.1):
        with open(path) as f:
            if f.read().count('step 20\n') != 2:
                fail('accuracy gate: {} lacks two step 20 blocks'.format(
                    path))
    numbers = cli_numbers(lines)
    eval_s = [n[2] for n in numbers['evaluated']]
    native_s = [n[1] for n in numbers['native_s']]
    k1 = sum(n[0] for n in numbers['launches'])
    print('accuracy gate, 20 steps, 1 split ({}): {} (exit {}); train {} '
          's, eval {} s, native AP {} s, wall {:.1f} s; train AP image/BEV/'
          '3D moderate {}/{}/{}, mean |cen_z err| {:.3f} m; emd_cost_fused '
          'launches {}'.format(
              card, 'PASSED' if not failed else verdict, rc,
              report['train_seconds'], eval_s, native_s, wall_s,
              report['train']['ap_image'][1], report['train']['ap_bev'][1],
              report['train']['ap_3d'][1],
              report['train']['metrics_abs']['metric_cen_z_err'], k1))
    return dict(exit=rc, failed=failed, train_s=report['train_seconds'],
                eval_s=eval_s, native_s=native_s, wall_s=wall_s,
                k1_launches=k1)


# --------------------------------------------------------------------------
# Phase 16: the pretrained trunk from the port's converters, tower remat
# --------------------------------------------------------------------------

TRUNK_NAME = 'chip_smoke_trunk'
PRETRAINED_LOOP_NAME = 'chip_smoke_pretrained'
REMAT_POLICIES = (None, 'unit', 'conv_outs')
REMAT_BATCHES = (1, 8)
REMAT_STEPS = 3
SLIM_SCOPE = 'FirstStageFeatureExtractor/resnet_v1_101/'


def _varint(value):
    out = bytearray()
    while True:
        byte = value & 0x7f
        value >>= 7
        if not value:
            out.append(byte)
            return bytes(out)
        out.append(byte | 0x80)


def _proto_field(number, wire, payload):
    tag = _varint((number << 3) | wire)
    if wire == 0:
        return tag + _varint(payload)
    if wire == 2:
        return tag + _varint(len(payload)) + payload
    return tag + struct.pack('<I', payload)          # wire 5


def _sstable_block(entries):
    """Sorted (key, value) byte pairs -> one uncompressed SSTable block
    (a restart point at every entry, no prefix sharing)."""
    body, restarts = bytearray(), []
    for key, value in entries:
        restarts.append(len(body))
        body += _varint(0) + _varint(len(key)) + _varint(len(value))
        body += key + value
    for r in restarts:
        body += struct.pack('<I', r)
    return bytes(body + struct.pack('<I', len(restarts)))


def write_tf_bundle(prefix, tensors):
    """Writes ``tensors`` ({name: array}) as a TF checkpoint V2 bundle:
    <prefix>.index (an SSTable of BundleEntryProto, zeroed CRCs, which
    the port's reader does not check) and one data shard. A writer for
    this smoke test only, so that the converter reads the format TF
    writes without TF on the machine."""
    dtypes = {np.dtype('float32'): 1, np.dtype('int64'): 9}
    data = bytearray()
    entries = [(b'', _proto_field(1, 0, 1))]         # header: one shard
    for name in sorted(tensors):
        array = np.ascontiguousarray(tensors[name])
        shape = b''.join(_proto_field(2, 2, _proto_field(1, 0, d))
                         for d in array.shape)
        entries.append((name.encode(), _proto_field(1, 0, dtypes[
            array.dtype]) + _proto_field(2, 2, shape) + _proto_field(
            4, 0, len(data)) + _proto_field(5, 0, array.nbytes) +
            _proto_field(6, 5, 0)))
        data += array.tobytes()
    data_block = _sstable_block(entries)
    index = bytearray(data_block + b'\x00' + struct.pack('<I', 0))
    meta_offset, meta_block = len(index), _sstable_block([])
    index += meta_block + b'\x00' + struct.pack('<I', 0)
    index_offset = len(index)
    index_block = _sstable_block([(entries[-1][0] + b'\xff', _varint(0) +
                                   _varint(len(data_block)))])
    index += index_block + b'\x00' + struct.pack('<I', 0)
    footer = (_varint(meta_offset) + _varint(len(meta_block)) +
              _varint(index_offset) + _varint(len(index_block)))
    index += footer + b'\x00' * (40 - len(footer)) + struct.pack(
        '<Q', convert_tf_resnet._SSTABLE_MAGIC)
    with open(prefix + '.index', 'wb') as f:
        f.write(index)
    with open(prefix + '.data-00000-of-00001', 'wb') as f:
        f.write(data)


def synthetic_slim_trunk(seed):
    """The zoo checkpoint's ResNet-101 trunk (conv1 and blocks 1-3, its
    names and shapes from ``odapi_manifest``), seeded: He-scaled conv
    kernels, batch norms near identity; plus the zoo's non-trunk
    variables, which the converters must drop."""
    rng = np.random.default_rng(seed)
    tensors = {}
    for name, shape in odapi_manifest.trunk_manifest(depth=101).items():
        leaf = name.rsplit('/', 1)[1]
        if leaf == 'weights':
            fan_in = shape[0] * shape[1] * shape[2]
            value = rng.standard_normal(shape, np.float32) / np.float32(
                np.sqrt(fan_in))
        elif leaf == 'gamma':
            value = rng.uniform(0.8, 1.2, shape)
        elif leaf == 'moving_variance':
            value = rng.uniform(0.5, 1.5, shape)
        else:
            value = rng.normal(0.0, 0.1, shape)
        tensors[name] = np.asarray(value, np.float32)
    for name in odapi_manifest.distractor_names(depth=101):
        tensors[name] = (np.asarray([142000], np.int64)
                         if name == 'global_step' else
                         rng.standard_normal((4, 4), np.float32))
    return tensors


def torchvision_state_dict(tensors):
    """The trunk's tensors (the manifest's names) under torchvision's
    ResNet names (OIHW)."""
    bn = {'gamma': 'weight', 'beta': 'bias', 'moving_mean': 'running_mean',
          'moving_variance': 'running_var'}
    out = {}
    for name in odapi_manifest.trunk_manifest(depth=101):
        value = tensors[name]
        rest = name[len(SLIM_SCOPE):]
        m = re.match(r'block(\d)/unit_(\d+)/bottleneck_v1/(\w+)/(.+)$', rest)
        layer, leaf = (m.group(3), m.group(4)) if m else rest.split('/', 1)
        prefix = ('layer{}.{}.'.format(m.group(1), int(m.group(2)) - 1)
                  if m else '')
        if leaf == 'weights':
            key = {'shortcut': 'downsample.0'}.get(layer, layer) + '.weight'
            value = value.transpose(3, 2, 0, 1)
        else:
            bn_name = ('downsample.1' if layer == 'shortcut' else
                       'bn' + layer[-1])
            key = bn_name + '.' + bn[leaf.split('/')[1]]
        out[prefix + key] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def converter_chain(card):
    """Both converter CLIs on a synthetic trunk at full ResNet-101 depth:
    their NPZs equal array for array; returns the NPZ path (the torch
    converter's, kept for the training run), the loader counts the JAX
    assertion gives and the report."""
    top = monopsr_torch.top_dir()
    work = os.path.join(top, 'build', 'chip_smoke', 'trunk')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.time()
    tensors = synthetic_slim_trunk(1)
    prefix = os.path.join(work, 'model.ckpt')
    write_tf_bundle(prefix, tensors)
    pth = os.path.join(work, 'resnet101.pth')
    torch.save(torchvision_state_dict(tensors), pth)
    write_s = time.time() - t0
    npz = os.path.join(monopsr_torch.data_dir(), 'pretrained',
                       TRUNK_NAME + '.npz')
    seconds, arrays = {}, {}
    for tool, flag, source in (('convert_tf_resnet', '--tf_checkpoint',
                                prefix),
                               ('convert_torch_resnet', '--torch_weights',
                                pth)):
        t0 = time.time()
        run_cli(tool, [flag, source, '--out_name', TRUNK_NAME], 'Wrote',
                package='monopsr_torch.tools')
        seconds[tool] = time.time() - t0
        with np.load(npz) as data:
            arrays[tool] = {k: data[k] for k in data.files}
    tf_npz, th_npz = arrays['convert_tf_resnet'], arrays[
        'convert_torch_resnet']
    if sorted(tf_npz) != sorted(th_npz) or any(
            tf_npz[k].dtype != th_npz[k].dtype or
            tf_npz[k].tobytes() != th_npz[k].tobytes() for k in tf_npz):
        fail('converters: the TF and the torchvision NPZs differ')
    trunk = list(odapi_manifest.trunk_manifest(depth=101))
    n_conv = sum(1 for k in trunk if k.endswith('/weights'))
    n_bn = sum(1 for k in trunk if '/BatchNorm/' in k)
    if len(tf_npz) != n_conv + n_bn:
        fail('converters: {} arrays from {} trunk variables'.format(
            len(tf_npz), n_conv + n_bn))
    counts = (2 * (n_conv + n_bn // 2), 2 * (n_bn // 2))
    n_floats = sum(v.size for v in tf_npz.values())
    print('pretrained trunk ({}): synthetic slim ResNet-101 trunk, {} '
          'variables ({} float32 values) + {} distractors, written as a TF '
          'checkpoint bundle and a torchvision .pth in {:.1f} s; '
          'convert_tf_resnet {:.1f} s, convert_torch_resnet {:.1f} s; the '
          'two NPZs equal, {} arrays, bit for bit'.format(
              card, len(trunk), n_floats, len(tensors) - len(trunk), write_s,
              seconds['convert_tf_resnet'], seconds['convert_torch_resnet'],
              len(tf_npz)))
    shutil.rmtree(work, ignore_errors=True)
    return npz, counts, dict(arrays=len(tf_npz), floats=int(n_floats),
                             write_s=write_s, convert_s=seconds)


def check_towers_hold_npz(config, npz):
    """The production net built from ``config`` on the card with the
    trainer's loader (``pretrained.maybe_load_pretrained``): both towers'
    parameters and statistics equal the NPZ's arrays."""
    net, _ = monopsr.create_net_from_config(
        config.model_config, config.dataset_config, device='cuda', seed=0)
    tx, _, use_ema, _ = opt_lib.build_optimizer(
        config.train_config.to_dict(), clip_gradient_norm=1.0)
    state = TrainState.create(net, tx, use_ema=use_ema)
    pretrained.maybe_load_pretrained(state, config.model_config)
    checked = 0
    with np.load(npz) as data:
        for key in data.files:
            parts = key.split('/')
            tree = {}
            node = tree.setdefault('params', {})
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key]
            (name, want), = weights.from_flax_variables(tree).items()
            for tower in ('tower_crop', 'tower_full'):
                full = 'backbone.{}.{}'.format(tower, name)
                got = state.params.get(full, state.batch_stats.get(full))
                if got is None or not torch.equal(got.detach().cpu(), want):
                    fail('pretrained: {} does not hold the NPZ\'s {}'.format(
                        full, key))
                checked += 1
    del net, state
    torch.cuda.empty_cache()
    return checked


def pretrained_training(card, npz, counts):
    """The training CLI on the production YAML (the fixture, phase 9's
    substitutions) from the converted trunk: 2 steps with summary images,
    the step-2 profile and tower remat. Checks the loader's counts, both
    towers against the NPZ, the grids, the trace, finite losses."""
    path = production_yaml(PRETRAINED_LOOP_NAME, [
        ('seed', '0', 1), ('max_iterations', '2', 1),
        ('summary_interval', '1', 1),
        ('checkpoint_interval', '2\n    profile_step: 2', 1),
        ('pretrained_weights_name', "'{}'".format(TRUNK_NAME), 1),
        ('summary_images', 'True', 1),
        ('compute_dtype', "'bfloat16'\n    remat_towers: True", 1)])
    config = config_lib.parse_yaml_config(path)
    if not (config.model_config.remat_towers and config.summary_images and
            config.train_config.profile_step == 2):
        fail('pretrained training: the config lost its edits')
    shutil.rmtree(config.exp_output_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    t0 = time.time()
    lines, first_s, _ = run_training_cli(path)
    wall_s = time.time() - t0
    loaded = [re.match(r'\[pretrained\] loaded (\d+) param / (\d+) stat '
                       r'arrays from (.+)$', line) for line in lines]
    loaded = [m for m in loaded if m]
    if len(loaded) != 1 or (int(loaded[0].group(1)),
                            int(loaded[0].group(2))) != counts or \
            os.path.abspath(loaded[0].group(3)) != os.path.abspath(npz):
        fail('pretrained training: loader printed {}, want {} param / {} '
             'stat arrays from {}'.format(
                 [m.group(0) for m in loaded], counts[0], counts[1], npz))
    records = [r for r in read_train_log(config) if 'total_loss' in r]
    if [r['step'] for r in records] != [1, 2] or not all(
            np.isfinite(v) for r in records for v in r.values()):
        fail('pretrained training: logged {}'.format(records))
    images = sorted(os.listdir(os.path.join(config.logdir, 'images')))
    want = sorted('{}_features_for_{}.png'.format(step, part)
                  for step in (1, 2) for part in ('map', 'box_3d'))
    if images != want:
        fail('pretrained training: images {}, want {}'.format(images, want))
    grids = {name: image_io.read_png(os.path.join(config.logdir, 'images',
                                                  name)).shape
             for name in want}
    trace_path = os.path.join(config.logdir, 'profile', 'train_step_2.json')
    with open(trace_path) as f:
        events = json.load(f)['traceEvents']
    kernels = sum(1 for e in events if e.get('cat') == 'kernel')
    if not kernels:
        fail('pretrained training: the step-2 trace holds no kernel')
    checked = check_towers_hold_npz(config, npz)
    ms = [1e3 / r['steps_per_sec'] for r in records]
    print('pretrained training ({}): run_training, production YAML, '
          'remat_towers True (unit), 2 steps from {}; loader: {} param / {} '
          'stat arrays (2 x (conv + BN pairs), 2 x BN pairs); {} tower '
          'tensors equal the NPZ after loading; losses finite (total {}); '
          'grids {}; step-2 trace {} events, {} kernels; ms/step {}, {:.1f} '
          's to the first step, {:.1f} s wall'.format(
              card, os.path.basename(npz), counts[0], counts[1], checked,
              [round(r['total_loss'], 4) for r in records], grids,
              len(events), kernels, [round(x, 3) for x in ms], first_s,
              wall_s))
    shutil.rmtree(config.exp_output_dir, ignore_errors=True)
    return dict(loaded=list(counts), towers_checked=checked,
                total_loss=[r['total_loss'] for r in records],
                ms_per_step=ms, trace_kernels=kernels, wall_s=wall_s,
                start_to_first_step_s=first_s)


def remat_steps(seed, card):
    """make_train_step at production width with the production loss,
    Adam and the EMA, for each remat policy at train batches 1 and 8:
    peak memory and ms/step over REMAT_STEPS timed steps after one
    warm-up; 'unit' must peak below no remat at the widest batch. K1 and
    K2 must not launch (no EMD loss, no val eval on this path)."""
    report = {}
    emd_ops.emd_distance.launches = 0
    emd_ops.emd_cost_fused.launches = 0
    for batch_size in REMAT_BATCHES:
        batch = synthetic_batch(seed, production_config(), batch_size,
                                (375, 1242), C.DEPTH_PAD_SHAPE)
        for policy in REMAT_POLICIES:
            cfg = dataclasses.replace(production_config(),
                                      remat_towers=policy is not None,
                                      remat_policy=policy or 'unit')
            net = monopsr.create_net(cfg, device='cuda', seed=seed)
            tx, _, use_ema, decay = opt_lib.build_optimizer(TRAIN_CONFIG)
            step = trainer.make_train_step(net, cfg, LOSS_CONFIG, tx,
                                           use_ema, decay, device='cuda')
            state = trainer.create_train_state(net, tx, use_ema)
            state, _ = step(state, batch)            # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(REMAT_STEPS):
                state, losses = step(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / REMAT_STEPS * 1e3
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            if not all(bool(torch.isfinite(v)) for v in losses.values()):
                fail('remat {} batch {}: losses not finite'.format(
                    policy, batch_size))
            name = '{} batch {}'.format(policy or 'none', batch_size)
            report[name] = dict(ms=ms, peak_gb=peak_gb,
                                total_loss=float(losses['total_loss']))
            print('remat {} ({}): {:.3f} ms/step over {} steps, peak {:.3f} '
                  'GB, total_loss {:.4f}'.format(
                      name, card, ms, REMAT_STEPS, peak_gb,
                      float(losses['total_loss'])))
            del net, state, step
            torch.cuda.empty_cache()
    k1, k2 = emd_ops.emd_cost_fused.launches, emd_ops.emd_distance.launches
    if k1 or k2:
        fail('remat steps: emd_cost_fused {} and emd_loss {} launches, '
             'want none'.format(k1, k2))
    widest = REMAT_BATCHES[-1]
    unit, none = (report['{} batch {}'.format(p, widest)]['peak_gb']
                  for p in ('unit', 'none'))
    if not unit < none:
        fail('remat: unit peaks at {:.3f} GB at batch {}, no remat at '
             '{:.3f} GB'.format(unit, widest, none))
    return report, (k1, k2)


def remat_gradients(seed, card):
    """One float32 production train step at batch 2 per remat policy,
    twice without remat, with cuDNN deterministic and PyTorch's
    deterministic algorithms (set here and reset after; an op without a
    deterministic version is named, not refused): the gradients the step
    hands the optimizer, remat against no remat, bitwise; where they are
    not equal, the remat runs' deviation (L2 over all leaves, and the
    worst leaf's largest |diff| over its largest gradient) must not
    exceed the two no-remat runs' own."""
    cfg32 = dataclasses.replace(production_config(), compute_dtype='float32')
    batch = synthetic_batch(seed + 5, cfg32, 2, (375, 1242),
                            C.DEPTH_PAD_SHAPE)
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark,
              torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    grads = {}
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            for run in ('none', 'none again', 'unit', 'conv_outs'):
                policy = run if run in ('unit', 'conv_outs') else None
                cfg = dataclasses.replace(
                    cfg32, remat_towers=policy is not None,
                    remat_policy=policy or 'unit')
                net = monopsr.create_net(cfg, device='cuda', seed=seed)
                tx, _, use_ema, decay = opt_lib.build_optimizer(TRAIN_CONFIG)
                tx = GradientRecorder(tx)
                step = trainer.make_train_step(net, cfg, LOSS_CONFIG, tx,
                                               use_ema, decay, device='cuda')
                state = trainer.create_train_state(net, tx, use_ema)
                step(state, batch)
                grads[run] = tx.grads[0]
                del net, state, step
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = before[0]
        torch.backends.cudnn.benchmark = before[1]
        torch.use_deterministic_algorithms(before[2], warn_only=before[3])
    nondeterministic = sorted({str(w.message).split(' does not have a '
                                                     'deterministic')[0]
                               for w in caught
                               if 'deterministic' in str(w.message)})

    def deviation(got, want):
        l2 = (sum(float(((got[k] - w) ** 2).sum()) for k, w in want.items()) /
              sum(float((w ** 2).sum()) for w in want.values())) ** 0.5
        leaf = max(float((got[k] - w).abs().max()) /
                   max(float(w.abs().max()), 1e-30) for k, w in want.items())
        return l2, leaf

    base = grads['none']
    yardstick = deviation(grads['none again'], base)
    report = {'none_vs_none': yardstick, 'nondeterministic_ops':
              nondeterministic}
    for run in ('unit', 'conv_outs'):
        equal = all(torch.equal(grads[run][k], w) for k, w in base.items())
        dev = (0.0, 0.0) if equal else deviation(grads[run], base)
        report[run] = dict(bitwise_equal=equal, l2=dev[0], worst_leaf=dev[1])
        if not equal and (dev[0] > yardstick[0] or dev[1] > yardstick[1]):
            fail('remat gradients: {} deviates (L2 {:.3e}, worst leaf '
                 '{:.3e}) from no remat; two no-remat runs (L2 {:.3e}, '
                 'worst leaf {:.3e})'.format(run, dev[0], dev[1],
                                             yardstick[0], yardstick[1]))

    def said(run):
        r = report[run]
        return ('bitwise equal' if r['bitwise_equal'] else
                'L2 {:.3e}, worst leaf {:.3e}'.format(r['l2'],
                                                      r['worst_leaf']))

    print('remat gradients ({}): float32, batch 2, deterministic cuDNN and '
          'algorithms, {} parameter tensors: unit {}, conv_outs {}; two '
          'no-remat runs: {}; ops without a deterministic version: {}'
          .format(card, len(base), said('unit'), said('conv_outs'),
                  'bitwise equal' if yardstick == (0.0, 0.0) else
                  'L2 {:.3e}, worst leaf {:.3e}'.format(*yardstick),
                  nondeterministic or 'none'))
    return report


def pretrained_remat_phase(seed, card):
    """Phase 16: the converter chain, training from its trunk with remat,
    then remat at production width; data/pretrained/<TRUNK_NAME>.npz and
    the run's outputs are removed at the end."""
    t0 = time.time()
    npz = os.path.join(monopsr_torch.data_dir(), 'pretrained',
                       TRUNK_NAME + '.npz')
    try:
        npz, counts, converters = converter_chain(card)
        training = pretrained_training(card, npz, counts)
    finally:
        if os.path.exists(npz):
            os.remove(npz)
        try:
            os.rmdir(os.path.dirname(npz))     # only if nothing else is there
        except OSError:
            pass
    steps, launches = remat_steps(seed, card)
    grads = remat_gradients(seed, card)
    seconds = time.time() - t0
    print('pretrained trunk and remat: {:.1f} s'.format(seconds))
    return dict(converters=converters, training=training, remat=steps,
                gradients=grads, launches=list(launches), seconds=seconds)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, default=0,
                        help='seed of the weights, samples and clouds')
    args = parser.parse_args()

    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False: this smoke test needs an '
             'NVIDIA GPU')

    t_start = time.time()
    card = nvidia_smi('name,power.limit')
    print(card)
    props = torch.cuda.get_device_properties(0)
    sm_clock = float(nvidia_smi('clocks.max.sm').split()[0])
    device_lib.resolve_device('cuda')     # the port's precision policy
    print('torch {} cuda {} | {} SMs, max SM clock {:.0f} MHz | '
          'cuda.matmul.allow_tf32={} cudnn.allow_tf32={}'.format(
              torch.__version__, torch.version.cuda,
              props.multi_processor_count, sm_clock,
              torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32))

    t0 = time.time()
    cuda_build.build()
    print('build: {} kernel(s) in {:.1f} s'.format(
        len(cuda_build.SOURCES), time.time() - t0))
    for name in cuda_build.SOURCES:
        for line in cuda_build.build_log(name).splitlines():
            if 'registers' in line or 'spill' in line:
                print('  ptxas {}: {}'.format(name, line.strip()))

    prod, ms, plain_ms, apart = kernel_phase(args.seed)
    slice_reference(args.seed)
    report = main_path(args.seed)
    prod2, ms2, plain_ms2, apart2 = kernel_phase_k2(args.seed)
    sweep = sweep_phase([('K1 production, masked', prod),
                         ('K1 masked, drawn apart', apart),
                         ('K2 train step, masked', prod2),
                         ('K2 train step, masked, drawn apart', apart2)])
    train_reference(args.seed)
    train_report = main_path_train(args.seed)
    loop_dir = config_lib.parse_yaml_config(
        train_loop_config(4)).exp_output_dir
    shutil.rmtree(loop_dir, ignore_errors=True)
    try:
        loop_report = train_loop_phase(card)
        eval_tiny = eval_reference(args.seed)
        eval_report = eval_cli_phase(card)
    finally:
        shutil.rmtree(loop_dir, ignore_errors=True)
    prod_ref = production_reference(args.seed)
    prep_report = data_prep_phase(card)
    dp_report = data_parallel_phase(args.seed, card)
    gate_dirs = [os.path.join(monopsr_torch.data_dir(), 'outputs', name)
                 for name in ('accuracy_gate', '_accuracy_gate_cfg')]
    for path in gate_dirs:
        shutil.rmtree(path, ignore_errors=True)
    try:
        gate_report = accuracy_gate_phase(card)
    finally:
        for path in gate_dirs:
            shutil.rmtree(path, ignore_errors=True)
    pretrained_report = pretrained_remat_phase(args.seed, card)

    b, n, m = prod['shape']
    bound_ms, bound_by = emd_bound_ms(b, n, m, props.multi_processor_count,
                                      sm_clock, 129, b)
    b2, n2, m2 = prod2['shape']
    bound2_ms, bound2_by = emd_bound_ms(
        b2, n2, m2, props.multi_processor_count, sm_clock, 230,
        b2 * (1 + 4 * (n2 + m2)))
    kernels = [{
        'name': 'emd_cost_fused',
        'route': 'cuda',
        'source': 'monopsr_torch/csrc/emd_cost_fused.cu',
        'replaces': 'monopsr_tpu/ops/emd.py:283',
        'launches': report['val']['launches'],
        'launches_eval_reference': eval_tiny['launches'],
        'launches_eval_cli': eval_report['k1_launches'],
        'launches_data_parallel_per_rank':
            dp_report['eval']['launches_per_rank'],
        'launches_accuracy_gate': gate_report['k1_launches'],
        'launches_pretrained_remat': pretrained_report['launches'][0],
        'max_abs_err': prod['max_abs_err'],
        'max_rel_err': prod['max_rel_err'],
        'main_path_clouds_max_rel_err': report['clouds_max_rel_err'],
        'apart_max_rel_err': prod['apart_max_rel_err'],
        'k1_k2_cost_max_rel_err': sweep['k1_k2_cost_max_rel_err'],
        'alone_vs_batch_cost_max_rel_err':
            sweep['alone_vs_batch_cost_max_rel_err'],
        'cluster': emd_ops.cluster_size('emd_cost_fused', b, n, m),
        'ms': ms,
        'plain_ms': plain_ms,
        'bound_ms': bound_ms,
        'bound_by': bound_by,
        'library_ms': None,
        'shape': [b, n, m],
    }, {
        'name': 'emd_loss',
        'route': 'cuda',
        'source': 'monopsr_torch/csrc/emd_loss.cu',
        'replaces': 'monopsr_tpu/ops/emd.py:425',
        'launches': train_report['emd loss']['launches'],
        'launches_eval_cli': 0,
        'launches_data_parallel_per_rank': [0] * DP_RANKS,
        'launches_accuracy_gate': 0,
        'launches_pretrained_remat': pretrained_report['launches'][1],
        'max_abs_err': prod2['max_abs_err'],
        'max_rel_err': prod2['max_rel_err'],
        'accumulators_max_rel_err': prod2['acc_max_rel_err'],
        'gradients_max_rel_err': prod2['grad_max_rel_err'],
        'gradients_vs_float64': prod2['grad_vs_float64'],
        'gradients_vs_float64_l2': prod2['grad_vs_float64_l2'],
        'plain_gradients_vs_float64': prod2['plain_grad_vs_float64'],
        'plain_gradients_vs_float64_l2': prod2['plain_grad_vs_float64_l2'],
        'apart_gradients_max_rel_err': prod2['apart_grad_max_rel_err'],
        'main_path_clouds_max_rel_err': train_report['clouds']['max_rel_err'],
        'main_path_clouds_gradients_vs_float64_l2':
            train_report['clouds']['grad_vs_float64_l2'],
        'cluster': emd_ops.cluster_size('emd_loss', b2, n2, m2),
        'ms': ms2,
        'plain_ms': plain_ms2,
        'bound_ms': bound2_ms,
        'bound_by': bound2_by,
        'library_ms': None,
        'shape': [b2, n2, m2],
    }]
    print('eval step ms/step: val {:.3f} test {:.3f} (eval batch {}, {})'
          .format(report['val']['ms'], report['test']['ms'], EVAL_BATCH,
                  card))
    print('train step ms/step: production loss {:.3f}, emd loss {:.3f} '
          '(train batch {}, {})'.format(
              train_report['production loss']['ms'],
              train_report['emd loss']['ms'], TRAIN_BATCH, card))
    print('train loop: ' + json.dumps(loop_report))
    print('eval reference: ' + json.dumps(eval_tiny))
    print('eval CLIs: ' + json.dumps(eval_report))
    print('production reference: ' + json.dumps(prod_ref))
    print('data preparation: ' + json.dumps(prep_report))
    print('data parallel: ' + json.dumps(dp_report))
    print('accuracy gate, short: ' + json.dumps(gate_report))
    print('pretrained trunk and remat: ' + json.dumps(pretrained_report))
    print('total {:.1f} s'.format(time.time() - t_start))
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
