#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (monopsr_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, any failure of which exits non-zero:

1. card: name and power limit (nvidia-smi); the TF32 switches as the
   port's precision policy sets them (``utils/device.resolve_device``,
   which every entry point passes through: TF32 off), printed.
2. build: every CUDA kernel of the port, one nvcc per source, and the
   host image library (csrc/image_host.cpp) with g++, all started
   together, into build/monopsr_torch_kernels/ and build/monopsr_torch_host/.
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
   (its eval step a CUDA graph, ``eval/step_graph.py``) and on the CPU
   (the eager step): box_3d txts within 1e-4, each box's EMD metric (K1
   on the card, the plain version on the CPU) within 1e-4 relative, and
   K1 launched once per dispatch group as the evaluator counts it (a
   launch captured in the graph runs once per replay).
11. eval CLIs: ``python -m monopsr_torch.experiments.run_evaluation``
   (val split, native AP on) over phase 9's production-width checkpoints
   2, 4 and 6, then ``run_inference`` at step 6 on the val and the test
   split, each in a subprocess. Every output is checked: no ledger
   (only ``--repeated`` writes it, as in JAX), a box_3d txt per valid
   sample, KITTI files of 16-field CRLF rows,
   metrics CSVs, finite losses, AP lines per step in both results
   files, a KITTI file per test sample, K1 launched once per group
   (its count printed by the evaluator), and the graphed eval step's
   warm-up and capture each printed once per process (no capture in a
   process of one group). Printed: ms per image at steps 2, 4 and 6
   beside the eager step's, the first checkpoints' seconds split into
   the graph's warm-up call, its capture and the rest, feed and
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
17. steps_per_dispatch: (a) the production train step at full width in
   float32 at batch 2 under deterministic algorithms, 4 eager steps
   against 2 dispatches of 2 through the CUDA graph of the step
   (``train.step_graph``) from the same seeded state and batches: every
   leaf of the state bit for bit or within rtol 2e-5 / atol 1e-6, with
   the production loss and with the 'emd' loss (K2 captured once and
   replayed); the count replaced instead of updated in place must fail
   it. (b), the graphed step per batch and remat policy, is the bench's
   ``train_batch_curve`` (phase 19). (c) the training CLI
   with ``steps_per_dispatch: 4`` on phase 9's config for 6 steps: logs
   at 4, 5, 6, checkpoints at 4 and 6; loop ms/step against phase 9's.
   (d) ``profile_step`` forces one step per dispatch (tiny config).
18. host feed: (a) the host library (PNG unfiltering and the 8-bit
   INTER_LINEAR resize in csrc/image_host.cpp, which ``utils/image_io``
   calls with the interpreter lock released) bit for bit against the
   plain numpy versions on the fixture's 49 PNGs, on seeded PNGs of each
   row filter and mixed rows x 8-bit gray, RGB and 16-bit gray at odd
   widths and 1-pixel sides, and on five resizes; (b) the loader's
   per-sample decode, assembly and prepare_sample ms with the library
   and with the plain versions swapped in here, in turns; (c)
   PrefetchingLoader's samples per second at 1, 2 and 4 threads, alone
   and while a thread replays the graphed production train step (K = 4);
   (d) the training CLI at ``steps_per_dispatch: 4`` for 32 steps (a log
   every dispatch, one checkpoint at the end): the steady ms/step against
   phase 9's K = 1.
19. bench: the port's bench (``python -m monopsr_torch.experiments.bench
   --repeats 3``, ``monopsr_torch/experiments/bench.py``) in a
   subprocess on the card: it must exit 0 with its result line (every
   reading finite, every share of the card at most 100%, K1 and K2
   against their plain versions), which is printed; its K1 and K2
   medians must lie within 25% of phases 3 and 6's times in this run.
   Its ``train_batch_curve`` captures and replays the train step under
   each tower remat policy (none at batches 1, 2, 4 and 8; 'unit' and
   'conv_outs' at 8) and checks its losses finite.
20. eval graph: the eval step as one CUDA graph
   (``eval.step_graph.GraphedEvalStep``, what the evaluator runs on the
   card) at production width in val mode against the eager
   ``make_eval_step``: three synthetic groups of eval batch 4 at the slot
   buckets 8, 16 and 32, for two seeded sets of weights restored into
   one net by ``load_state_dict`` through one capture; in float32 under
   deterministic algorithms every output, loss and metric bit for bit,
   in bfloat16 the largest difference within phase 12's bound; a restore
   with ``assign=True`` must make the next replay raise; K1 captured once,
   its launch x replays equal to the groups run. Printed: the warm-up
   and capture seconds, beside phase 19's reading of the val step's ms
   through the graph and eagerly (the bench's ``eval_val_step_ms``).

Each phase's seconds are printed as it ends and together at the end.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Imports neither jax nor monopsr_tpu.
"""

import argparse
import contextlib
import ctypes
import dataclasses
import glob
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
import zlib

import numpy as np
import torch

import monopsr_torch
from monopsr_torch import config as config_lib
from monopsr_torch import constants as C
from monopsr_torch import weights
from monopsr_torch.datasets.kitti.kitti_dataset import KittiDataset
from monopsr_torch.eval import evaluator, native_eval, pipeline
from monopsr_torch.eval import step_graph as eval_graph
from monopsr_torch.experiments import flagship
from monopsr_torch.models import monopsr
from monopsr_torch.models.monopsr_net import MonoPSRNet, NetConfig
from monopsr_torch.ops import cuda_build
from monopsr_torch.ops import emd as emd_ops
from monopsr_torch.ops import multi_tensor_adam
from monopsr_torch.parallel import data_parallel
from monopsr_torch.tools import convert_tf_resnet, odapi_manifest
from monopsr_torch.train import optimizer as opt_lib
from monopsr_torch.train import pretrained, step_graph, trainer
from monopsr_torch.train.input_pipeline import PrefetchingLoader
from monopsr_torch.train.train_state import TrainState
from monopsr_torch.utils import device as device_lib
from monopsr_torch.utils import image_io
from monopsr_torch.utils.profiling import (emd_bound_ms, nvidia_smi,
                                           profile_step, time_cuda)

EVAL_BATCH = 4     # configs/monopsr_model_000.yaml train_config.eval_batch
TRAIN_BATCH = 1    # configs/monopsr_model_000.yaml train_config.batch_size
STEPS = 5          # timed steps per mode

# configs/monopsr_model_000.yaml's optimizer section and loss config
_PRODUCTION_YAML = flagship.flagship_yaml()
TRAIN_CONFIG = flagship.train_config(_PRODUCTION_YAML)
LOSS_CONFIG = flagship.loss_config(_PRODUCTION_YAML)

# The same with the approximate-EMD loss on the local xyz maps (a loss
# type the reference's loss builder accepts; the weight only scales it)
EMD_LOSS_CONFIG = dict(LOSS_CONFIG, inst_xyz_map_local=['emd', 1.0])


def fail(msg):
    print('chip_smoke: FAILED: ' + msg, file=sys.stderr)
    sys.exit(1)


def rel_err(got, want):
    """Max |got - want| / |want|, |want| floored at 1e-6 of its largest."""
    err = (got - want).abs()
    floor = max(1e-6 * float(want.abs().max()), 1e-30)
    return float(err.max()), float((err / want.abs().clamp(min=floor)).max())


# --------------------------------------------------------------------------
# Inputs
# --------------------------------------------------------------------------

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
    batch = flagship.synthetic_batch(seed + 1, cfg, 2, (96, 320), (96, 320))
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
    cfg = flagship.flagship_config()
    batch = flagship.synthetic_batch(seed, cfg, EVAL_BATCH, (375, 1242),
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
    accumulator within 5e-3 (``emd_ops.accumulator_errors``;
    tests/test_ops.py:352);
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
    rows, cols = emd_ops.floored_points(xyz1, xyz2)
    acc = emd_ops.accumulator_errors(got, want, rows, cols)
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

    def apply(self, grads, state, params, ema=None, ema_decay=None):
        self.grads.append({k: v.detach().cpu().clone()
                           for k, v in grads.items()})
        return self.tx.apply(grads, state, params, ema, ema_decay)


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
    batch = flagship.synthetic_batch(seed + 3, cfg, 2, (96, 320), (96, 320))
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
    cfg = flagship.flagship_config()
    batch = flagship.synthetic_batch(seed, cfg, TRAIN_BATCH, (375, 1242),
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
        # K1's launches as the evaluator counts them: a launch captured in
        # its eval step's graph runs once per replay
        runs[device] = dict(config=dev_config, result=result,
                            launches=ev.kernel_launches['emd_cost_fused'])
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
                       r'([0-9.]+) s'),
        warm_up_s=[g[0] for g in grab(
            r'eval step graph: warm-up ([0-9.]+) s')],
        capture_s=[g[0] for g in grab(
            r'eval step graph: capture ([0-9.]+) s')])


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

    # Once per process: the graphed step's warm-up call (the first group)
    # and its capture (the second; a process that runs one group captures
    # nothing)
    for label, numbers in (('val', val), ('inference val', inf),
                           ('inference test', test)):
        captures = int(sum(g for _, _, g in numbers['launches']) > 1)
        if (len(numbers['warm_up_s']) != 1 or
                len(numbers['capture_s']) != captures):
            fail('eval CLIs: {} printed the eval step graph\'s warm-up {} '
                 'and capture {} times, want 1 and {}'.format(
                     label, len(numbers['warm_up_s']),
                     len(numbers['capture_s']), captures))

    def ms_per_image(numbers):
        return [1e3 * secs / n for n, _, secs in numbers['evaluated']]

    # The seconds of the first two checkpoints' passes: the warm-up call
    # runs in the first, the capture in the first with two groups or more,
    # else in the second
    (n2, _, s2), (n4, _, s4) = val['evaluated'][:2]
    warm_up_s, capture_s = val['warm_up_s'][0], val['capture_s'][0]
    capture_step = 2 if val['launches'][0][2] > 1 else 4

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
        graph_warm_up_s={'val': warm_up_s,
                         'inference val': inf['warm_up_s'][0],
                         'inference test': test['warm_up_s'][0]},
        graph_capture_s={'val': capture_s,
                         'inference val': inf['capture_s'],
                         'inference test': test['capture_s']},
        capture_step=capture_step,
        step2_s=dict(total=s2, warm_up=warm_up_s, rest=s2 - warm_up_s - (
            capture_s if capture_step == 2 else 0.0)),
        step4_s=dict(total=s4, rest=s4 - (
            capture_s if capture_step == 4 else 0.0)),
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
    print('eval CLIs: run_evaluation val, ms per image at steps 2, 4, 6: '
          '{} (the eager eval step read 573.0, 51.8, 53.8 on an H100 80GB '
          'HBM3 at 700 W); step 2: {:.3f} s over {} images, step 4: {:.3f} '
          's over {}; the graphed step\'s warm-up call {:.3f} s (step 2), '
          'capture {:.3f} s (step {}); the rest of step 2 {:.3f} s, of step '
          '4 {:.3f} s; inference: val warm-up {:.3f} s and capture {} s, '
          'test warm-up {:.3f} s and capture {} s; {}'.format(
              ['{:.1f}'.format(x) for x in report['val_ms_per_image']],
              s2, n2, s4, n4, warm_up_s, capture_s, capture_step,
              report['step2_s']['rest'], report['step4_s']['rest'],
              inf['warm_up_s'][0], inf['capture_s'], test['warm_up_s'][0],
              test['capture_s'], card))
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
    cfg32 = dataclasses.replace(flagship.flagship_config(),
                                compute_dtype='float32')
    cfg16 = flagship.flagship_config()
    batch = flagship.synthetic_batch(seed + 3, cfg32, 1, (375, 1242),
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
        json.dump({'launches': ev.kernel_launches['emd_cost_fused'],
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
    cfgs = {'float32': dataclasses.replace(flagship.flagship_config(),
                                           compute_dtype='float32'),
            'bfloat16': flagship.flagship_config()}
    batch = flagship.synthetic_batch(seed, cfgs['bfloat16'], DP_RANKS,
                                     (375, 1242), C.DEPTH_PAD_SHAPE)
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
    one_launches = ev.kernel_launches['emd_cost_fused']
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
        batch = flagship.synthetic_batch(seed, flagship.flagship_config(),
                                         batch_size, (375, 1242),
                                         C.DEPTH_PAD_SHAPE)
        for policy in REMAT_POLICIES:
            cfg = dataclasses.replace(flagship.flagship_config(),
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
    cfg32 = dataclasses.replace(flagship.flagship_config(),
                                compute_dtype='float32')
    batch = flagship.synthetic_batch(seed + 5, cfg32, 2, (375, 1242),
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


# --------------------------------------------------------------------------
# Phase 17: steps_per_dispatch, a CUDA graph of the train step
# --------------------------------------------------------------------------

GRAPH_K = 4             # steps per dispatch of the graphed CLI
GRAPH_RTOL, GRAPH_ATOL = 2e-5, 1e-6   # tests/test_steps_per_dispatch.py:44


class ReplacedCount:
    """Planted fault: the optimizer's ``count`` is replaced by a new tensor
    before each update (which then advances the new one), where the port
    updates the state's own tensors in place. Eager steps read the dict
    anew and stay right; a CUDA graph replays its captured clone of the
    count it started from, so the count never advances past capture."""

    def __init__(self, tx):
        self.tx = tx

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, state):
        state['count'] = state['count'].clone()
        return self.tx.update(grads, state)

    def apply(self, grads, state, params, ema=None, ema_decay=None):
        state['count'] = state['count'].clone()
        return self.tx.apply(grads, state, params, ema, ema_decay)


def state_leaves(state):
    """{name: tensor} of every tensor of a TrainState (parameters, EMA,
    optimizer moments and counters, batch statistics), cloned."""
    out = {}
    for part in ('params', 'ema_params', 'batch_stats'):
        for key, value in (getattr(state, part) or {}).items():
            out['{}/{}'.format(part, key)] = value.detach().clone()
    for key, value in state.opt_state.items():
        if isinstance(value, dict):
            for name, tensor in value.items():
                out['opt/{}/{}'.format(key, name)] = tensor.clone()
        else:
            out['opt/' + key] = value.clone()
    return out


def leaves_against(got, want):
    """(bitwise equal, the worst leaf and its max |diff| beyond
    GRAPH_ATOL + GRAPH_RTOL |want| as a share of GRAPH_ATOL (<= 0 within
    the bound), the number of leaves)."""
    equal = all(torch.equal(got[k], w) for k, w in want.items())
    worst, worst_key = float('-inf'), None
    for key, w in want.items():
        g, w = got[key].double(), w.double()
        excess = float(((g - w).abs() - GRAPH_RTOL * w.abs()).max()) \
            if w.numel() else 0.0
        if not bool(torch.isfinite(g).all()) and bool(torch.isfinite(w).all()):
            excess = float('inf')
        if excess > worst:
            worst, worst_key = excess, key
    return equal, worst_key, worst / GRAPH_ATOL, len(want)


def graph_against_eager(cfg, loss_config, batches, seed, k, planted=False):
    """``len(batches)`` eager train steps from a seeded net against
    dispatches of ``k`` batches through ``step_graph.GraphedTrainStep``
    from the same net and state, under cuDNN-deterministic and PyTorch's
    deterministic algorithms (set here and reset after). ``planted``
    runs the graphed steps with the optimizer's count replaced instead of
    updated (``ReplacedCount``). Returns a dict: bitwise equality, the
    worst leaf against the JAX test's rtol 2e-5 / atol 1e-6, the last
    step's losses against each other, K2's launches (eager, captured,
    replays) and the capture seconds."""
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark,
              torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    runs = {}
    try:
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            for mode in ('eager', 'graph'):
                net = monopsr.create_net(cfg, device='cuda', seed=seed)
                tx, _, use_ema, decay = opt_lib.build_optimizer(TRAIN_CONFIG)
                if planted and mode == 'graph':
                    tx = ReplacedCount(tx)
                step = trainer.make_train_step(net, cfg, loss_config, tx,
                                               use_ema, decay, device='cuda')
                state = trainer.create_train_state(net, tx, use_ema)
                emd_ops.emd_distance.launches = 0
                if mode == 'eager':
                    for batch in batches:
                        state, losses = step(state, batch)
                    graphed, captured = None, 0
                else:
                    graphed = step_graph.GraphedTrainStep(step, 'cuda')
                    captured = {}
                    capture = graphed.capture

                    def counted_capture(fn, capture=capture,
                                        captured=captured, **kwargs):
                        k2 = emd_ops.emd_distance.launches
                        out = capture(fn, **kwargs)
                        captured['k2'] = emd_ops.emd_distance.launches - k2
                        return out
                    graphed.capture = counted_capture
                    for i in range(0, len(batches), k):
                        state, losses = graphed(state, batches[i:i + k])
                torch.cuda.synchronize()
                runs[mode] = dict(
                    leaves=state_leaves(state), step=state.step,
                    losses={k: v.detach().clone() for k, v in losses.items()},
                    k2=emd_ops.emd_distance.launches,
                    captured=captured.get('k2', 0) if graphed else 0,
                    replays=graphed.replays if graphed else 0,
                    capture_s=graphed.capture_seconds if graphed else None)
                del net, state, step, graphed
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = before[0]
        torch.backends.cudnn.benchmark = before[1]
        torch.use_deterministic_algorithms(before[2], warn_only=before[3])
    eager, graph = runs['eager'], runs['graph']
    equal, worst_key, worst, n = leaves_against(graph['leaves'],
                                                eager['leaves'])
    losses_equal = all(torch.equal(graph['losses'][k], v)
                       for k, v in eager['losses'].items())
    out = dict(bitwise_equal=equal, worst_leaf=worst_key,
               worst_excess_of_atol=worst, leaves=n,
               within_bound=worst <= 0.0, losses_equal=losses_equal,
               steps=[eager['step'], graph['step']],
               count=[int(eager['leaves']['opt/count']),
                      int(graph['leaves']['opt/count'])],
               total_loss=[float(eager['losses']['total_loss']),
                           float(graph['losses']['total_loss'])],
               k2_eager=eager['k2'], k2_graph_python=graph['k2'],
               k2_captured=graph['captured'], replays=graph['replays'],
               capture_s=graph['capture_s'])
    del runs
    torch.cuda.empty_cache()
    return out


def graph_equality_phase(seed, card):
    """Phase 17(a): the production train step at full width in float32 at
    batch 2, 4 eager steps against 2 dispatches of 2 through the CUDA
    graph from the same seeded state and the same 4 synthetic batches:
    every leaf bit for bit, or within rtol 2e-5 and atol 1e-6; with the
    production loss and with the 'emd' loss, whose K2 launch must be
    captured (once) and so run in every replay; the planted out-of-place
    count must fail the same check."""
    cfg32 = dataclasses.replace(flagship.flagship_config(),
                                compute_dtype='float32')
    batches = [flagship.synthetic_batch(seed + 30 + i, cfg32, 2, (375, 1242),
                                        C.DEPTH_PAD_SHAPE) for i in range(4)]
    report = {}
    for name, loss_config, planted in (
            ('production loss', LOSS_CONFIG, False),
            ('emd loss', EMD_LOSS_CONFIG, False),
            ('production loss, planted replaced count', LOSS_CONFIG, True)):
        r = graph_against_eager(cfg32, loss_config, batches, seed, 2,
                                planted=planted)
        report[name] = r
        ok = r['bitwise_equal'] or r['within_bound']
        print('graph vs eager, {} ({}; float32, batch 2, 4 eager steps vs '
              '2 dispatches of 2, deterministic algorithms): {} over {} '
              'leaves{}; steps {}, count {}, total_loss eager {:.6f} graph '
              '{:.6f} (last step {}); K2 launches: eager {}, in the graph '
              'run {} by Python (the warm-up step and the capture), {} '
              'captured x {} replays; capture {:.3f} s'.format(
                  name, card,
                  'bit for bit' if r['bitwise_equal'] else
                  'worst leaf {} {:+.3e} of atol beyond the bound'.format(
                      r['worst_leaf'], r['worst_excess_of_atol']),
                  r['leaves'], '' if ok or planted else ' (FAILS)',
                  r['steps'], r['count'], r['total_loss'][0],
                  r['total_loss'][1],
                  'equal' if r['losses_equal'] else 'differs',
                  r['k2_eager'], r['k2_graph_python'], r['k2_captured'],
                  r['replays'], r['capture_s']))
        if r['steps'] != [4, 4]:
            fail('graph vs eager, {}: steps {}'.format(name, r['steps']))
        want_k2 = 1 if loss_config is EMD_LOSS_CONFIG else 0
        if (r['k2_eager'] != 4 * want_k2 or r['k2_captured'] != want_k2 or
                r['k2_graph_python'] != 2 * want_k2 or r['replays'] != 3):
            fail('graph vs eager, {}: K2 launches eager {}, graph {}, '
                 'captured {}, replays {}'.format(
                     name, r['k2_eager'], r['k2_graph_python'],
                     r['k2_captured'], r['replays']))
        if planted:
            if ok:
                fail('graph vs eager: the planted replaced count passed')
        elif not ok:
            fail('graph vs eager, {}: worst leaf {} beyond rtol {} atol {}'
                 .format(name, r['worst_leaf'], GRAPH_RTOL, GRAPH_ATOL))
        elif not r['losses_equal'] and abs(
                r['total_loss'][0] - r['total_loss'][1]) > \
                GRAPH_ATOL + GRAPH_RTOL * abs(r['total_loss'][0]):
            fail('graph vs eager, {}: last losses {}'.format(
                name, r['total_loss']))
    return report


GRAPH_LOOP_NAME = 'chip_smoke_train_k4'


def graph_loop_phase(card, loop_report):
    """Phase 17(c): the training CLI on phase 9's fixture config with
    ``steps_per_dispatch: GRAPH_K`` and 6 steps: one dispatch of 4, then a
    tail of 2 single steps; logs at 4, 5 and 6 and checkpoints at 4 and 6
    (the JAX loop's crossing rule, summary every step, checkpoint every
    2). Loop ms/step from the log against phase 9's at K = 1."""
    path = production_yaml(GRAPH_LOOP_NAME, [
        ('seed', '0', 1), ('max_iterations', '6', 1),
        ('summary_interval', '1', 1),
        ('checkpoint_interval',
         '2\n    steps_per_dispatch: {}'.format(GRAPH_K), 1)])
    config = config_lib.parse_yaml_config(path)
    shutil.rmtree(config.exp_output_dir, ignore_errors=True)
    try:
        torch.cuda.empty_cache()
        lines, start_s, _ = run_training_cli(path)
        records = [r for r in read_train_log(config) if 'total_loss' in r]
        steps = [r['step'] for r in records]
        checkpoints = trainer.CheckpointManager(
            config.checkpoint_dir).all_steps()
    finally:
        shutil.rmtree(config.exp_output_dir, ignore_errors=True)
    if steps != [4, 5, 6] or checkpoints != [4, 6]:
        fail('graph loop: logged steps {} and checkpoints {}, want [4, 5, '
             '6] and [4, 6]'.format(steps, checkpoints))
    if not all(np.isfinite(v) for r in records for v in r.values()):
        fail('graph loop: a logged value is not finite: {}'.format(records))
    ms = {r['step']: 1e3 / r['steps_per_sec'] for r in records}
    report = dict(ms_per_step={k: round(v, 3) for k, v in ms.items()},
                  k1_ms_per_step=loop_report['ms_per_step'],
                  start_to_first_step_s=start_s,
                  total_loss={r['step']: round(r['total_loss'], 4)
                              for r in records})
    print('graph loop (run_training CLI, steps_per_dispatch {}, 6 steps, '
          'production width, fixture): logged {}, checkpoints {}; wall '
          'ms/step from steps_per_sec {} (step 4: the dispatch of 4 with '
          'the warm-up step and the capture; 5: a replay after the '
          'checkpoint at 4; 6: a replay) against phase 9 at K = 1 {}; '
          '{:.1f} s to the first step line; {}'.format(
              GRAPH_K, steps, checkpoints, report['ms_per_step'],
              loop_report['ms_per_step'], start_s, card))
    return report


def profile_forces_one_step(seed, card):
    """Phase 17(d): with ``profile_step`` set, ``steps_per_dispatch: 4``
    runs one step per dispatch (the JAX rule): the training loop in this
    process on the card, on a tiny config over the fixture, 3 steps with
    the step-2 trace; every step logged, no graph made."""
    path = production_yaml('chip_smoke_profile_k', [
        ('seed', '0', 1), ('num_boxes', '4', 1),
        ('image_input_shape', '[48, 160]', 1),
        ('resized_full_img_shape', '[24, 80]', 1),
        ('img_roi_size', '[16, 16]', 1), ('map_roi_size', '[16, 16]', 1),
        ('layer_sizes', '[16, 16]', 2),
        ('compute_dtype', "'float32'\n    resnet: 'resnet_tiny'", 1),
        ('max_iterations', '3', 1), ('summary_interval', '1', 1),
        ('checkpoint_interval', '2\n    steps_per_dispatch: 4\n'
         '    profile_step: 2', 1)])
    config = config_lib.parse_yaml_config(path)
    shutil.rmtree(config.exp_output_dir, ignore_errors=True)
    made = []
    graphed_step = step_graph.GraphedTrainStep

    def counted(*args, **kwargs):
        made.append(1)
        return graphed_step(*args, **kwargs)
    step_graph.GraphedTrainStep = counted
    try:
        trainer.train(config, KittiDataset(config.dataset_config, 'train'),
                      device='cuda')
        steps = [r['step'] for r in read_train_log(config)
                 if 'total_loss' in r]
        traced = os.path.exists(os.path.join(config.logdir, 'profile',
                                             'train_step_2.json'))
    finally:
        step_graph.GraphedTrainStep = graphed_step
        shutil.rmtree(config.exp_output_dir, ignore_errors=True)
    if (trainer.steps_per_dispatch(config.train_config) != 1 or
            steps != [1, 2, 3] or made or not traced):
        fail('profile_step with steps_per_dispatch 4: K {}, logged {}, '
             'graphs made {}, trace {}'.format(
                 trainer.steps_per_dispatch(config.train_config), steps,
                 len(made), traced))
    print('profile_step 2 with steps_per_dispatch 4 ({}): one step per '
          'dispatch, logged {}, no graph, the step-2 trace written'.format(
              card, steps))
    return dict(logged=steps, graphs=len(made), traced=traced)


def steps_per_dispatch_phase(seed, card, loop_report):
    """Phase 17: (a) graph against eager, (c) the CLI at K = GRAPH_K,
    (d) profile_step forces K = 1. (The graphed step's ms/step and peak
    GB per batch and remat policy are the bench's ``train_batch_curve``,
    phase 19.)"""
    t0 = time.time()
    emd_ops.emd_cost_fused.launches = 0
    equality = graph_equality_phase(seed, card)
    loop = graph_loop_phase(card, loop_report)
    profile = profile_forces_one_step(seed, card)
    k1 = emd_ops.emd_cost_fused.launches
    if k1:
        fail('steps_per_dispatch: emd_cost_fused launched {} times, want '
             'none (no val eval on this path)'.format(k1))
    seconds = time.time() - t0
    print('steps_per_dispatch: {:.1f} s'.format(seconds))
    return dict(equality=equality, loop=loop, profile=profile,
                k1_launches=k1, seconds=seconds)


# --------------------------------------------------------------------------
# Phase 17(e): the train step's optimizer update, csrc/multi_tensor_adam.cu
# --------------------------------------------------------------------------

# Bytes per parameter the update must move: g read by the norm pass, then
# g, p, mu, nu and ema read and p, mu, nu and ema written (float32 mu)
FUSED_BYTES_PER_PARAMETER = 40
# Where the update clips, the kernels' norm (float64 partials in chunk
# order) and the twin's (torch's float32 sum) may differ by a few float32
# ulps; mu scales with 1 / norm and nu with 1 / norm^2
FUSED_RTOL, FUSED_ATOL = 1e-5, 1e-10
# Gradient scales: under the clip at the production list (norm ~0.2) and
# over it (norm ~10)
UNDER_CLIP, OVER_CLIP = 2e-5, 1e-3

# name -> (steps: (gradient scale, NaN planted), optimizer_mu_dtype,
# notfinite_count at the start, must be bit for bit)
FUSED_CASES = {
    'under the clip': (((UNDER_CLIP, False),) * 3, None, 0, True),
    'clipped': (((OVER_CLIP, False),) * 3, None, 0, False),
    'NaN gradient': (((UNDER_CLIP, False), (UNDER_CLIP, True)), None, 0,
                     True),
    '51st non-finite in a row': (((UNDER_CLIP, True),), None, 50, False),
    'mu bfloat16': (((UNDER_CLIP, False),) * 3, 'bfloat16', 0, True),
}


def parameter_shapes(cfg=None):
    """{name: shape} of the net's own parameters (the production config's
    by default), read from a net on the meta device."""
    with torch.device('meta'):
        net = MonoPSRNet(cfg or flagship.flagship_config())
    return {name: tuple(p.shape) for name, p in net.named_parameters()}


def fused_grads(shapes, seed, scale, nan=False):
    """Seeded gradients of ``shapes`` on the card, N(0, scale^2); with
    ``nan`` the first element of the first tensor is NaN."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    grads = {name: torch.randn(shape, generator=gen, device='cuda') * scale
             for name, shape in shapes.items()}
    if nan:
        next(iter(grads.values())).view(-1)[0] = float('nan')
    return grads


def fused_sides(shapes, seed, mu_dtype=None, notfinite_count=0):
    """Two equal sides [tx, optimizer state, params, ema, ema decay] of the
    production optimizer (Adam under the exponential decay, clip 1.0,
    apply-if-finite, EMA 0.9999) over seeded parameters of ``shapes`` on
    the card."""
    config = dict(TRAIN_CONFIG, optimizer_mu_dtype=mu_dtype)
    gen = torch.Generator(device='cuda').manual_seed(seed)
    params = {name: torch.randn(shape, generator=gen, device='cuda') * 0.05
              for name, shape in shapes.items()}
    sides = []
    for _ in range(2):
        tx, _, _, decay = opt_lib.build_optimizer(config)
        own = {name: t.clone() for name, t in params.items()}
        state = tx.init(own)
        if notfinite_count:
            state['notfinite_count'].fill_(notfinite_count)
        sides.append([tx, state, own,
                      {name: t.clone() for name, t in params.items()},
                      decay])
    return sides


def fused_leaves(side):
    """{name: tensor} of one side's parameters, EMA and optimizer state."""
    _, state, params, ema, _ = side
    out = {'params/' + n: t for n, t in params.items()}
    out.update(('ema/' + n, t) for n, t in ema.items())
    for key, value in state.items():
        if isinstance(value, dict):
            out.update(('opt/{}/{}'.format(key, n), t)
                       for n, t in value.items())
        else:
            out['opt/' + key] = value
    return out


def fused_gap(got, want):
    """(bit for bit equal, the worst leaf, its largest |got - want| beyond
    FUSED_ATOL + FUSED_RTOL |want| as a share of |want|'s largest (<= 0
    within the bound; a NaN where the other holds a number, or an integer
    or bool leaf that differs, counts as inf))."""
    equal, worst, worst_key = True, float('-inf'), None
    for key, w in want.items():
        g = got[key]
        equal = equal and torch.equal(_bits(g), _bits(w))
        if not w.is_floating_point():
            excess = 0.0 if torch.equal(g, w) else float('inf')
        else:
            g, w = g.double(), w.double()
            nan = torch.isnan(w)
            if not torch.equal(torch.isnan(g), nan):
                excess = float('inf')
            else:
                d = ((g - w).abs() - FUSED_ATOL - FUSED_RTOL * w.abs())
                d = torch.where(nan, torch.full_like(d, -1.0), d)
                scale = float(torch.nan_to_num(w.abs(), nan=0.0).max())
                excess = float(d.max()) / (scale or 1.0)
        if excess > worst:
            worst, worst_key = excess, key
    return equal, worst_key, worst


def fused_against_plain(name, shapes, seed):
    """Case ``name`` of FUSED_CASES on the card: each step's gradients
    through ``Optimizer.apply`` (the kernels) on one side and
    ``apply_plain`` (the foreach twin) on the other. Returns a dict: bit
    for bit, the worst leaf beyond the clipped case's bound, both sides'
    counters, the kernels' launches and ``train.fused_update`` counts,
    and whether a skipped step kept parameters and moments and moved the
    EMA."""
    steps, mu_dtype, notfinite, _ = FUSED_CASES[name]
    sides = fused_sides(shapes, seed, mu_dtype, notfinite)
    launches = multi_tensor_adam.adam_update.launches
    kept = moved = None
    for i, (scale, nan) in enumerate(steps):
        grads = fused_grads(shapes, seed + 1 + i, scale, nan)
        before = {k: v.clone() for k, v in fused_leaves(sides[0]).items()}
        for side, apply in zip(sides, ('apply', 'apply_plain')):
            tx, state, params, ema, decay = side
            getattr(tx, apply)(grads, state, params, ema, decay)
        if nan and not notfinite:
            after = fused_leaves(sides[0])
            kept = all(torch.equal(_bits(after[k]), _bits(v))
                       for k, v in before.items()
                       if k.startswith(('params/', 'opt/mu/', 'opt/nu/')))
            moved = any(not torch.equal(after[k], v)
                        for k, v in before.items() if k.startswith('ema/'))
        del grads, before
    torch.cuda.synchronize()
    got, want = fused_leaves(sides[0]), fused_leaves(sides[1])
    equal, worst_key, worst = fused_gap(got, want)
    counters = [{k: int(leaves['opt/' + k]) for k in (
        'count', 'notfinite_count', 'total_notfinite', 'last_finite')}
        for leaves in (got, want)]
    out = dict(bitwise_equal=equal, worst_leaf=worst_key,
               worst_excess=worst, within_bound=worst <= 0.0,
               counters=counters, kept=kept, moved=moved,
               all_nan=bool(all(torch.isnan(t).all() for k, t in got.items()
                                if k.startswith('params/'))),
               launches=multi_tensor_adam.adam_update.launches - launches,
               fused_updates=sides[0][0].times.totals()[1].get(
                   'train.fused_update', 0))
    del sides, got, want
    torch.cuda.empty_cache()
    return out


def fused_case_failure(name, r):
    """Why case ``name``'s result ``r`` fails, or None."""
    steps, _, notfinite, bitwise = FUSED_CASES[name]
    if bitwise and not r['bitwise_equal']:
        return 'not bit for bit: worst leaf {} {:+.3e}'.format(
            r['worst_leaf'], r['worst_excess'])
    if not r['within_bound']:
        return 'worst leaf {} {:+.3e} beyond rtol {} atol {}'.format(
            r['worst_leaf'], r['worst_excess'], FUSED_RTOL, FUSED_ATOL)
    if r['counters'][0] != r['counters'][1]:
        return 'counters {} against the twin\'s {}'.format(*r['counters'])
    if r['launches'] != 3 * len(steps) or r['fused_updates'] != len(steps):
        return '{} launches and {} fused updates in {} steps'.format(
            r['launches'], r['fused_updates'], len(steps))
    if name == 'NaN gradient' and not (r['kept'] and r['moved']):
        return 'the skipped step kept the state {}, moved the EMA {}'.format(
            r['kept'], r['moved'])
    if notfinite and not r['all_nan']:
        return 'the 51st non-finite step was not applied'
    return None


def fused_graph_against_eager(shapes, seed, scale=OVER_CLIP, steps=3):
    """``steps`` updates through ``Optimizer.apply`` eagerly on one side;
    on the other the first eagerly on a side stream, then one captured in
    a CUDA graph from static gradient buffers and replayed for each later
    step. Returns a dict: bit for bit, the worst leaf, the launches
    counted by Python at the warm-up and at capture, the replays."""
    sides = fused_sides(shapes, seed)
    grads = [fused_grads(shapes, seed + 1 + i, scale) for i in range(steps)]
    tx, state, params, ema, decay = sides[0]
    for g in grads:
        tx.apply(g, state, params, ema, decay)
    tx, state, params, ema, decay = sides[1]
    static = {k: v.clone() for k, v in grads[0].items()}
    launches = multi_tensor_adam.adam_update.launches
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        tx.apply(static, state, params, ema, decay)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tx.apply(static, state, params, ema, decay)
    counted = multi_tensor_adam.adam_update.launches - launches
    for g in grads[1:]:
        for k, v in g.items():
            static[k].copy_(v)
        graph.replay()
    torch.cuda.synchronize()
    equal, worst_key, worst = fused_gap(fused_leaves(sides[1]),
                                        fused_leaves(sides[0]))
    del sides, grads, static, graph
    torch.cuda.empty_cache()
    return dict(bitwise_equal=equal, worst_leaf=worst_key,
                worst_excess=worst, launches_counted=counted,
                replays=steps - 1)


def fused_timing(shapes, seed, reps=20, runs=5):
    """Device ms of one update at ``shapes`` (clipped gradients), the
    kernels' (``apply``) and the foreach twin's (``apply_plain``), each
    captured in a CUDA graph after an eager call on a side stream (as the
    graphed train step runs them) and timed by CUDA events over ``reps``
    replays, ``runs`` times in turns. Returns ({apply: median}, {apply:
    every run})."""
    sides = fused_sides(shapes, seed)
    grads = fused_grads(shapes, seed + 1, OVER_CLIP)
    graphs = {}
    for side, apply in zip(sides, ('apply', 'apply_plain')):
        tx, state, params, ema, decay = side
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            getattr(tx, apply)(grads, state, params, ema, decay)
        torch.cuda.current_stream().wait_stream(stream)
        graphs[apply] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[apply]):
            getattr(tx, apply)(grads, state, params, ema, decay)
    times = {apply: [] for apply in graphs}
    for _ in range(runs):
        for apply, graph in graphs.items():
            times[apply].append(time_cuda(graph.replay, reps, warmup=2))
    del sides, grads, graphs
    torch.cuda.empty_cache()
    return {apply: float(np.median(ms)) for apply, ms in times.items()}, \
        times


def fused_dispatch_launches(seed):
    """The production train step (bfloat16, batch TRAIN_BATCH, the
    production loss) through ``GraphedTrainStep``: a dispatch of one batch
    (the eager warm-up step), then one of GRAPH_K (the capture and
    GRAPH_K - 1 replays). Returns the kernels' launches counted by Python
    in the second dispatch (captured, counted once), its replays, the
    ``train.fused_update`` count of each dispatch, the update count and
    whether the last loss is finite."""
    cfg = flagship.flagship_config()
    batches = [flagship.synthetic_batch(seed + 70 + i, cfg, TRAIN_BATCH,
                                        (375, 1242), C.DEPTH_PAD_SHAPE)
               for i in range(1 + GRAPH_K)]
    net = monopsr.create_net(cfg, device='cuda', seed=seed)
    tx, _, use_ema, decay = opt_lib.build_optimizer(TRAIN_CONFIG)
    step = trainer.make_train_step(net, cfg, LOSS_CONFIG, tx, use_ema, decay,
                                   device='cuda')
    state = trainer.create_train_state(net, tx, use_ema)
    graphed = step_graph.GraphedTrainStep(step, 'cuda')
    state, _ = graphed(state, batches[:1])
    first = tx.times.totals()[1].get('train.fused_update', 0)
    launches = multi_tensor_adam.adam_update.launches
    state, losses = graphed(state, batches[1:])
    torch.cuda.synchronize()
    out = dict(captured=multi_tensor_adam.adam_update.launches - launches,
               replays=graphed.replays,
               fused_updates=[first, tx.times.totals()[1].get(
                   'train.fused_update', 0) - first],
               count=int(state.opt_state['count']),
               finite=bool(torch.isfinite(losses['total_loss'])))
    del net, state, step, graphed, tx
    torch.cuda.empty_cache()
    return out


def fused_update_phase(seed, card, equality):
    """Phase 17(e): the kernels of ``ops/multi_tensor_adam`` at the
    production parameter list against the foreach twin (every case of
    FUSED_CASES, and a captured update against eager ones), their time
    against the bound of FUSED_BYTES_PER_PARAMETER at 3.35 TB/s and the
    twin's time, the launches of one graphed dispatch of GRAPH_K
    production steps, and phase 17(a)'s graph against eager steps
    (``equality``), which run through the kernels."""
    t0 = time.time()
    shapes = parameter_shapes()
    numels = [int(np.prod(s)) for s in shapes.values()]
    n = sum(numels)
    report = dict(parameters=n, tensors=len(shapes),
                  chunks=len(multi_tensor_adam.chunk_table(numels)))
    for name in FUSED_CASES:
        r = fused_against_plain(name, shapes, seed)
        report[name] = r
        why = fused_case_failure(name, r)
        print('fused update against the foreach twin, {} ({} tensors, {} '
              'parameters, {}): {}; counters {}, {} launches{}'.format(
                  name, len(shapes), n, card,
                  'bit for bit' if r['bitwise_equal'] else
                  'worst leaf {} {:+.3e} of its largest beyond the bound'
                  .format(r['worst_leaf'], r['worst_excess']),
                  r['counters'][0], r['launches'],
                  '' if why is None else ' (FAILS: {})'.format(why)))
        if why is not None:
            fail('fused update, {}: {}'.format(name, why))
    graph = fused_graph_against_eager(shapes, seed)
    report['graph'] = graph
    print('fused update, a captured update replayed against eager updates '
          '({}): {}; {} launches counted at the warm-up and capture, {} '
          'replays'.format(card, 'bit for bit' if graph['bitwise_equal']
                           else 'worst leaf {} {:+.3e}'.format(
                               graph['worst_leaf'], graph['worst_excess']),
                           graph['launches_counted'], graph['replays']))
    if not graph['bitwise_equal'] or graph['launches_counted'] != 6:
        fail('fused update: graph against eager {}'.format(graph))
    ms, runs = fused_timing(shapes, seed)
    bound_ms = FUSED_BYTES_PER_PARAMETER * n / 3.35e12 * 1e3
    report.update(ms=ms['apply'], plain_ms=ms['apply_plain'],
                  ms_runs=runs, bound_ms=bound_ms,
                  x_bound=ms['apply'] / bound_ms)
    print('fused update device time, graphed ({}): {:.3f} ms (runs {}) '
          'against its bound '
          '{:.3f} ms ({} B x {} parameters at 3.35 TB/s: {:.2f}x), the '
          'foreach twin {:.3f} ms (runs {})'.format(
              card, ms['apply'], [round(x, 3) for x in runs['apply']],
              bound_ms, FUSED_BYTES_PER_PARAMETER, n,
              ms['apply'] / bound_ms, ms['apply_plain'],
              [round(x, 3) for x in runs['apply_plain']]))
    dispatch = fused_dispatch_launches(seed)
    report['dispatch'] = dispatch
    print('fused update in one graphed dispatch of {} production steps '
          '(bfloat16, batch {}, {}): {} launches captured x {} replays = {} '
          'launches; train.fused_update counted {} (warm-up dispatch) and {} '
          '(capture); count {}'.format(
              GRAPH_K, TRAIN_BATCH, card, dispatch['captured'],
              dispatch['replays'], dispatch['captured'] * dispatch['replays'],
              *dispatch['fused_updates'], dispatch['count']))
    if (dispatch['captured'] != 3 or dispatch['replays'] != GRAPH_K or
            dispatch['fused_updates'] != [1, 1] or
            dispatch['count'] != 1 + GRAPH_K or not dispatch['finite']):
        fail('fused update in a graphed dispatch: {}'.format(dispatch))
    if equality is not None:
        report['graph_equality'] = {
            name: r['bitwise_equal'] for name, r in equality.items()}
        print('phase 17(a), graph against eager train steps through the '
              'fused update, bit for bit: {}'.format(
                  report['graph_equality']))
    report['seconds'] = time.time() - t0
    print('fused update: {:.1f} s'.format(report['seconds']))
    return report


# --------------------------------------------------------------------------
# Phase 18: the host feed, PNG unfiltering and resizing in the host library
# --------------------------------------------------------------------------

FEED_THREADS = (1, 2, 4)     # PrefetchingLoader threads of 18(c)
FEED_BATCHES = 25            # batches of 1 per throughput reading
FEED_LOOP_STEPS = 32         # 18(d): 4 warm-up steps, then 7 dispatches of 4
FEED_LOOP_NAME = 'chip_smoke_train_k4_long'
FEED_SIZES = [(1, 1), (1, 9), (7, 1), (6, 13), (61, 127)]
FEED_RESIZES = [((370, 1224, 3), (320, 1216)), ((375, 1242), (320, 1216)),
                ((37, 61, 3), (96, 200)), ((29, 30), (1, 1)),
                ((1, 30, 3), (13, 1))]


def encode_png(pixels, depth, colour, row_filters):
    """A PNG of ``pixels`` (8-bit gray, RGB or 16-bit gray), row r
    filtered by row_filters[r] as the PNG specification defines the
    filters (neighbours left of column 0 and above row 0 are zero)."""
    h, w = pixels.shape[:2]
    raw = (pixels.astype('>u2').view(np.uint8) if depth == 16
           else pixels).reshape(h, -1).astype(np.int32)
    bpp = raw.shape[1] // w
    a, b, c = (np.zeros_like(raw) for _ in range(3))
    a[:, bpp:] = raw[:, :-bpp]
    b[1:] = raw[:-1]
    c[1:, bpp:] = raw[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(raw), a, b, (a + b) // 2, paeth])
    kinds = np.asarray(row_filters, np.int64)
    rows = np.concatenate([kinds[:, None].astype(np.uint8), (
        (raw - preds[kinds, np.arange(h)]) % 256).astype(np.uint8)], 1)
    header = struct.pack('>IIBBBBB', w, h, depth, colour, 0, 0, 0)
    return (image_io._SIGNATURE + image_io._chunk(b'IHDR', header) +
            image_io._chunk(b'IDAT', zlib.compress(rows.tobytes())) +
            image_io._chunk(b'IEND', b''))


def host_library_correctness(seed):
    """Phase 18(a): the host library against the plain numpy versions,
    bit for bit: every fixture PNG; seeded PNGs of each filter (and
    mixed rows) x 8-bit gray, RGB and 16-bit gray x FEED_SIZES (odd
    widths, 1-pixel sides); the resize at FEED_RESIZES."""
    library = cuda_build.build(['image_host'])['image_host']  # phase 2's
    fixture = os.path.join(monopsr_torch.top_dir(), 'tests', 'datasets',
                           'Kitti', 'object')
    pngs = sorted(glob.glob(os.path.join(fixture, '**', '*.png'),
                            recursive=True))
    if len(pngs) != 49:
        fail('host feed: {} fixture PNGs, want 49'.format(len(pngs)))
    bad = [p for p in pngs if not np.array_equal(
        image_io.read_png(p), image_io.read_png_plain(p))]
    rng = np.random.RandomState(seed + 18)
    out_dir = os.path.join(monopsr_torch.top_dir(), 'build', 'chip_smoke')
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, 'host_feed.png')
    synthetic = 0
    for filters in (0, 1, 2, 3, 4, 'mixed'):
        for depth, colour, channels in ((8, 0, 1), (8, 2, 3), (16, 0, 1)):
            for h, w in FEED_SIZES:
                shape = (h, w, channels) if channels > 1 else (h, w)
                pixels = rng.randint(0, 1 << depth, shape).astype(
                    np.uint16 if depth == 16 else np.uint8)
                kinds = (rng.randint(0, 5, h) if filters == 'mixed'
                         else [filters] * h)
                with open(path, 'wb') as f:
                    f.write(encode_png(pixels, depth, colour, kinds))
                got = image_io.read_png(path)
                synthetic += 1
                if not (got.dtype == pixels.dtype and
                        np.array_equal(got, pixels) and
                        np.array_equal(got, image_io.read_png_plain(path))):
                    bad.append('synthetic filter {} depth {} colour {} '
                               '{}x{}'.format(filters, depth, colour, h, w))
    os.remove(path)
    for src, dst in FEED_RESIZES:
        image = rng.randint(0, 256, src).astype(np.uint8)
        got = image_io.resize_bilinear_uint8(image, dst)
        if got.shape != dst + src[2:] or not np.array_equal(
                got, image_io.resize_bilinear_uint8_plain(image, dst)):
            bad.append('resize {} -> {}'.format(src, dst))
    if bad:
        fail('host feed: the host library differs from the plain version '
             'on {}'.format(bad))
    return dict(library=os.path.relpath(library, monopsr_torch.top_dir()),
                fixture_pngs=len(pngs),
                synthetic_pngs=synthetic, resizes=len(FEED_RESIZES),
                bitwise_equal=True)


@contextlib.contextmanager
def plain_image_functions():
    """image_io's decode and resize swapped for their plain numpy
    versions (the dataset layer and prepare_sample call them through the
    module), restored after."""
    read, resize = image_io.read_png, image_io.resize_bilinear_uint8
    image_io.read_png = image_io.read_png_plain
    image_io.resize_bilinear_uint8 = image_io.resize_bilinear_uint8_plain
    try:
        yield
    finally:
        image_io.read_png, image_io.resize_bilinear_uint8 = read, resize


def host_feed_costs(config_path):
    """Phase 18(b): ``loader_times`` with the host library and with the
    plain versions, in turns (plain, library, library, plain); the means
    of each's two passes."""
    runs = {'library': [], 'plain': []}
    for kind in ('plain', 'library', 'library', 'plain'):
        if kind == 'plain':
            with plain_image_functions():
                runs[kind].append(loader_times(config_path))
        else:
            runs[kind].append(loader_times(config_path))
    return {kind: {key: float(np.mean([r[key] for r in passes]))
                   for key in passes[0]}
            for kind, passes in runs.items()}


def loader_rate(dataset, shape, threads):
    """Samples per second of a PrefetchingLoader (batch 1) with
    ``threads`` threads: FEED_BATCHES batches taken as soon as each is
    ready, rated from the first to the last."""
    loader = PrefetchingLoader(dataset, 1, shape, num_threads=threads)
    try:
        stamps = []
        for _ in range(FEED_BATCHES):
            loader.get_batch()
            stamps.append(time.perf_counter())
    finally:
        loader.stop()
    return (FEED_BATCHES - 1) / (stamps[-1] - stamps[0])


def host_feed_throughput(seed, config_path):
    """Phase 18(c): PrefetchingLoader's samples per second over the
    fixture at FEED_THREADS threads, alone and then while a thread of
    this process replays the graphed production train step (bfloat16,
    batch 1, K = GRAPH_K, a synchronize after each dispatch); the step's
    ms/step alone and beside each loader."""
    config = config_lib.parse_yaml_config(config_path)
    shape = tuple(config.model_config.image_input_shape)

    def dataset():
        return KittiDataset(config.dataset_config, 'train')
    alone = {n: loader_rate(dataset(), shape, n) for n in FEED_THREADS}

    cfg = flagship.flagship_config()
    net = monopsr.create_net(cfg, device='cuda', seed=seed)
    tx, _, use_ema, decay = opt_lib.build_optimizer(TRAIN_CONFIG)
    step = trainer.make_train_step(net, cfg, LOSS_CONFIG, tx, use_ema,
                                   decay, device='cuda')
    state = trainer.create_train_state(net, tx, use_ema)
    graphed = step_graph.GraphedTrainStep(step, 'cuda')
    dispatch = [flagship.synthetic_batch(seed, cfg, 1, (375, 1242),
                                         C.DEPTH_PAD_SHAPE)] * GRAPH_K
    graphed(state, dispatch)                  # warm-up and capture
    torch.cuda.synchronize()

    def replay_ms(stop, out):
        """Replays dispatches until ``stop`` is set; ms/step into out."""
        steps, t0 = 0, time.perf_counter()
        while not stop.is_set() or steps == 0:
            graphed(state, dispatch)
            torch.cuda.synchronize()
            steps += GRAPH_K
        out.append((time.perf_counter() - t0) / steps * 1e3)

    step_alone = []
    stop = threading.Event()
    stop.set()
    for _ in range(3):
        replay_ms(stop, step_alone)
    beside, step_beside = {}, {}
    for n in FEED_THREADS:
        stop, out = threading.Event(), []
        replays = threading.Thread(target=replay_ms, args=(stop, out))
        replays.start()
        try:
            beside[n] = loader_rate(dataset(), shape, n)
        finally:
            stop.set()
            replays.join()
        step_beside[n] = out[0]
    if not all(bool(torch.isfinite(v)) for v in graphed.losses.values()):
        fail('host feed: the graphed step\'s losses are not finite')
    del net, state, step, graphed
    torch.cuda.empty_cache()
    return dict(samples_per_s_alone=alone, samples_per_s_beside_step=beside,
                step_ms_alone=float(np.median(step_alone)),
                step_ms_beside_loader=step_beside)


def host_feed_loop(card, loop_report):
    """Phase 18(d): the training CLI on phase 9's fixture config at
    ``steps_per_dispatch: GRAPH_K`` for FEED_LOOP_STEPS steps, a log every
    dispatch and the one checkpoint at the last step: ms/step of every
    logged dispatch, the steady ms/step (median of the dispatches after
    the first, which holds the warm-up step and the capture; the last
    dispatch's log comes before its checkpoint) against phase 9's K = 1."""
    path = production_yaml(FEED_LOOP_NAME, [
        ('seed', '0', 1), ('max_iterations', str(FEED_LOOP_STEPS), 1),
        ('summary_interval', '1', 1),
        ('checkpoint_interval', '{}\n    steps_per_dispatch: {}'.format(
            FEED_LOOP_STEPS, GRAPH_K), 1)])
    config = config_lib.parse_yaml_config(path)
    shutil.rmtree(config.exp_output_dir, ignore_errors=True)
    try:
        torch.cuda.empty_cache()
        lines, start_s, _ = run_training_cli(path)
        records = [r for r in read_train_log(config) if 'total_loss' in r]
        checkpoints = trainer.CheckpointManager(
            config.checkpoint_dir).all_steps()
    finally:
        shutil.rmtree(config.exp_output_dir, ignore_errors=True)
    want = list(range(GRAPH_K, FEED_LOOP_STEPS + 1, GRAPH_K))
    if [r['step'] for r in records] != want or checkpoints != [
            FEED_LOOP_STEPS]:
        fail('host feed loop: logged {} and checkpoints {}, want {} and '
             '[{}]'.format([r['step'] for r in records], checkpoints, want,
                           FEED_LOOP_STEPS))
    if not all(np.isfinite(v) for r in records for v in r.values()):
        fail('host feed loop: a logged value is not finite')
    ms = {r['step']: 1e3 / r['steps_per_sec'] for r in records}
    return dict(ms_per_step={k: round(v, 3) for k, v in ms.items()},
                steady_ms_per_step=float(np.median(
                    [ms[k] for k in want[1:]])),
                k1_steady_ms_per_step=loop_report['steady_ms_per_step'],
                start_to_first_step_s=start_s)


def host_feed_phase(seed, card, loop_report):
    """Phase 18: (a) the host library bit for bit against the plain
    versions, (b) the loader's per-sample costs with each, (c) the
    loader's throughput per thread count alone and beside the graphed
    step, (d) the training CLI's steady rate at K = GRAPH_K."""
    t0 = time.time()
    correct = host_library_correctness(seed)
    print('host feed (a) ({}): {} (built by g++ in phase 2) bit for bit '
          'equal to the plain versions on {} fixture PNGs, {} seeded PNGs (5 '
          'filters and mixed rows x gray8, RGB, gray16 x {}) and {} resizes'
          .format(card, correct['library'], correct['fixture_pngs'],
                  correct['synthetic_pngs'], FEED_SIZES, correct['resizes']))
    config_path = train_loop_config(4)
    costs = host_feed_costs(config_path)
    for kind in ('library', 'plain'):
        c = costs[kind]
        print('host feed (b), {} ({}): one thread, per sample over {} '
              'fixture train samples: PNG decode {:.3f} ms, assembly '
              '{:.3f} ms, prepare_sample {:.3f} ms per valid sample; '
              '{:.3f} ms per delivered sample'.format(
                  'host library' if kind == 'library' else
                  'plain numpy versions', card, int(c['samples']),
                  c['decode_ms'], c['assembly_ms'], c['prepare_ms'],
                  c['ms_per_delivered_sample']))
    rates = host_feed_throughput(seed, config_path)
    for n in FEED_THREADS:
        print('host feed (c) ({}): PrefetchingLoader, {} thread(s), batch '
              '1: {:.3f} samples/s alone, {:.3f} beside the graphed step '
              '(K = {}, which ran {:.3f} ms/step beside it, {:.3f} alone)'
              .format(card, n, rates['samples_per_s_alone'][n],
                      rates['samples_per_s_beside_step'][n], GRAPH_K,
                      rates['step_ms_beside_loader'][n],
                      rates['step_ms_alone']))
    loop = host_feed_loop(card, loop_report)
    print('host feed (d) ({}): run_training CLI, steps_per_dispatch {}, {} '
          'steps: wall ms/step per logged dispatch {}; steady {:.3f} '
          'ms/step against phase 9 at K = 1 {:.3f}; {:.1f} s to the first '
          'step line'.format(card, GRAPH_K, FEED_LOOP_STEPS,
                             loop['ms_per_step'], loop['steady_ms_per_step'],
                             loop['k1_steady_ms_per_step'],
                             loop['start_to_first_step_s']))
    seconds = time.time() - t0
    print('host feed: {:.1f} s'.format(seconds))
    return dict(correctness=correct, costs=costs, throughput=rates,
                loop=loop, seconds=seconds)


BENCH_REPEATS = 3
BENCH_AGREEMENT = 0.25    # the bench's K1/K2 ms against phases 3 and 6's


def bench_phase(seed, card, kernel_ms):
    """Phase 19: the port's bench in a subprocess on the card (``run_cli``
    fails the phase on a non-zero exit: a failed reading or check, a
    non-finite output, a share of the card above 100%). Its result line
    is printed; its K1 and K2 medians must lie within BENCH_AGREEMENT of
    ``kernel_ms`` ({name: ms}, phases 3 and 6's ``time_cuda`` in this
    run), so that two timers agree on one card."""
    torch.cuda.empty_cache()
    t0 = time.time()
    lines, _, _ = run_cli('bench', ['--repeats', str(BENCH_REPEATS),
                                    '--seed', str(seed)], '{"metric"')
    seconds = time.time() - t0
    results = [line for line in lines if line.startswith('{"metric"')]
    if not results:
        fail('bench: no result line')
    print('bench result: ' + results[-1])
    result = json.loads(results[-1])
    bench_ms = {k['name']: k['ms']['median'] for k in result['kernels']}
    for name, want in kernel_ms.items():
        if abs(bench_ms[name] - want) > BENCH_AGREEMENT * want:
            fail('bench: {} {:.3f} ms against {:.3f} ms in the kernel '
                 'phase, beyond {:.0%}'.format(name, bench_ms[name], want,
                                               BENCH_AGREEMENT))
    mfu = result['mfu']
    curve = result['train_batch_curve']
    print('bench ({}): graphed train step at batch 8, ms/step (peak GB): '
          '{}'.format(card, ', '.join(
              '{} {:.3f} ({:.2f})'.format(
                  curve[key]['remat'] or 'no remat',
                  curve[key]['ms_per_step']['median'],
                  curve[key]['peak_gb'])
              for key in ('8', '8r', '8c'))))
    val_step = result['eval_val_step_ms']
    print('bench ({}): val eval step {:.3f} ms graphed, {:.3f} ms eager '
          '(eval_dispatch_overhead_ms {:.3f})'.format(
              card, val_step['graphed']['median'],
              val_step['eager']['median'],
              result['eval_dispatch_overhead_ms']))
    print('bench ({}): device_fps {:.3f} (eager {:.3f}), e2e_fps {:.3f}, '
          'graphed train step {:.3f} ms at batch 1, train_mfu_batch1_pct '
          '{:.3f}, K1 {:.3f} ms (phase 3: {:.3f}), K2 {:.3f} ms (phase 6: '
          '{:.3f}); {:.1f} s'.format(
              card, result['device_fps']['median'],
              result['eager_forward_fps']['median'],
              result['e2e_fps']['median'],
              result['train_batch_curve']['1']['ms_per_step']['median'],
              mfu['train_mfu_batch1_pct'], bench_ms['emd_cost_fused'],
              kernel_ms['emd_cost_fused'], bench_ms['emd_loss'],
              kernel_ms['emd_loss'], seconds))
    return dict(seconds=seconds, kernel_ms=bench_ms,
                device_fps=result['device_fps']['median'],
                e2e_fps=result['e2e_fps']['median'],
                eval_val_step_ms={k: v['median']
                                  for k, v in val_step.items()},
                train_mfu_batch1_pct=mfu['train_mfu_batch1_pct'])


# --------------------------------------------------------------------------
# Phase 20: the eval step as one CUDA graph
# --------------------------------------------------------------------------

# Objects per sample of phase 20's three groups of EVAL_BATCH samples;
# under the Evaluator's default eval_slot_buckets (8, 16) and num_boxes
# (32) they need the slot buckets 8, 16 and 32
EVAL_GRAPH_NUM_OBJS = ((3, 8, 1, 5), (12, 2, 16, 4), (30, 7, 9, 20))
EVAL_GRAPH_SLOT_BUCKETS = (8, 16)


def _bits(tensor):
    """A tensor's bits, so that torch.equal compares them bit for bit (a
    NaN equal to the same NaN)."""
    if tensor.is_floating_point():
        return tensor.view({2: torch.int16, 4: torch.int32,
                            8: torch.int64}[tensor.element_size()])
    return tensor


def eval_results_against(got, want):
    """Two eval step results ((packed outputs, losses, metrics) on the
    CPU): (bit for bit equal, {part/key: largest |d| / max |x| of the
    wanted tensor}); a NaN in one of them where the other holds a
    number, or another key, shape or dtype, counts as inf."""
    equal, worst = True, {}
    for part, got_part, want_part in zip(('outputs', 'losses', 'metrics'),
                                         got, want):
        for key in set(got_part) | set(want_part):
            name = '{}/{}'.format(part, key)
            g, w = got_part.get(key), want_part.get(key)
            if (g is None or w is None or g.shape != w.shape or
                    g.dtype != w.dtype):
                equal, worst[name] = False, float('inf')
                continue
            equal = equal and torch.equal(_bits(g), _bits(w))
            g, w = g.double(), w.double()
            both_nan = torch.isnan(g) & torch.isnan(w)
            d = torch.where(both_nan, torch.zeros_like(g), (g - w).abs())
            d = torch.nan_to_num(d, nan=float('inf'))
            scale = float(torch.nan_to_num(w.abs(), nan=0.0).max()) \
                if w.numel() else 0.0
            worst[name] = (float(d.max()) if d.numel() else 0.0) / (
                scale or 1.0)
    return equal, worst


def _on_cpu(out):
    return tuple({k: v.detach().cpu() for k, v in part.items()}
                 for part in out)


def eval_graph_against_eager(cfg, mode, groups, buckets, seeds,
                             deterministic):
    """The eval step (``make_eval_step``) of a net with the seeded
    weights of ``seeds[0]`` against ``eval.step_graph.GraphedEvalStep``
    over the same step: a warm-up call on ``groups[0]``, then, for the
    weights of each seed of ``seeds`` in turn (restored into the net by
    ``load_state_dict``, as the evaluator restores a checkpoint), every
    group of ``groups`` (stacked host batches) at its slot bucket of
    ``buckets``, through the graph and eagerly. With ``deterministic``,
    under cuDNN-deterministic and PyTorch's deterministic algorithms (set
    here and reset after). Then a restore with ``assign=True`` (new
    storage) must make the next replay raise. Returns a dict: bit for bit equality, the largest |d| / max |x| and its key,
    K1's launches (eager calls; the graph's warm-up and capture by
    Python; captured; replays; as ``step_graph.kernel_launches`` counts
    them), the warm-up and capture seconds, the planted restore's error."""
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark,
              torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            states = []
            for seed in seeds[1:]:
                other = monopsr.create_net(cfg, device='cuda', seed=seed)
                states.append({k: v.detach().clone()
                               for k, v in other.state_dict().items()})
                del other
            net = monopsr.create_net(cfg, device='cuda', seed=seeds[0])
            step = evaluator.make_eval_step(net, cfg, LOSS_CONFIG, mode,
                                            device='cuda')
            graphed = eval_graph.GraphedEvalStep(step, 'cuda', net,
                                                 cfg.num_boxes)
            emd_ops.emd_cost_fused.launches = 0
            start = eval_graph.kernel_launches(graphed)['emd_cost_fused']
            results, eager_calls = [], 0
            graphed(groups[0], buckets[0])          # the warm-up call
            for weights_index in range(len(seeds)):
                if weights_index:
                    net.load_state_dict(states[weights_index - 1])
                for group, bucket in zip(groups, buckets):
                    got = _on_cpu(graphed(group, bucket))
                    want = _on_cpu(step(group, bucket))
                    eager_calls += 1
                    results.append((got, want))
            k1_python = emd_ops.emd_cost_fused.launches
            k1_counted = (eval_graph.kernel_launches(graphed)
                          ['emd_cost_fused'] - start)
            replays = graphed.replays
            planted = None
            net.load_state_dict({k: v.clone() for k, v in
                                 net.state_dict().items()}, assign=True)
            try:
                graphed(groups[0], buckets[0])
            except RuntimeError as exc:
                planted = str(exc)
            torch.cuda.synchronize()
            out = dict(
                k1_eager=eager_calls, k1_python=k1_python,
                k1_counted=k1_counted,
                k1_captured=graphed.captured_launches['emd_cost_fused'],
                replays=replays, warm_up_s=graphed.warm_up_seconds,
                capture_s=graphed.capture_seconds, planted_error=planted)
            del net, step, graphed, states
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = before[0]
        torch.backends.cudnn.benchmark = before[1]
        torch.use_deterministic_algorithms(before[2], warn_only=before[3])
    worst, equal, finite = {}, True, True
    for got, want in results:
        same, errors = eval_results_against(got, want)
        equal = equal and same
        for key, value in errors.items():
            worst[key] = max(worst.get(key, 0.0), value)
        finite = finite and all(
            bool(torch.isfinite(v).all()) for part in got
            for v in part.values() if v.is_floating_point())
    worst_key = max(worst, key=worst.get) if worst else None
    out.update(bitwise_equal=equal, worst_key=worst_key,
               worst=worst[worst_key] if worst_key else 0.0, finite=finite)
    return out


def eval_graph_phase(seed, card, val_step_ms):
    """Phase 20: the eval step as one CUDA graph
    (``eval.step_graph.GraphedEvalStep``) at production width in val mode
    against the eager step, on three synthetic groups of EVAL_BATCH
    samples at the slot buckets 8, 16 and 32 that their objects need,
    for two seeded sets of weights restored into one net through one
    capture: in float32 under deterministic algorithms every output, loss
    and metric bit for bit; in bfloat16 (the production config) the
    largest difference within phase 12's BF16_BOUND of each tensor's
    largest value; both finite. A restore with ``assign=True`` must make
    the next replay raise; K1 is captured once and its captured launch x
    replays equals the groups run through the graph. Printed: the warm-up
    and capture seconds, beside the val step's ms through the graph and
    eagerly that phase 19's bench measured (``val_step_ms``, {'graphed':
    ms, 'eager': ms})."""
    t0 = time.time()
    cfg16 = flagship.flagship_config()
    cfg32 = dataclasses.replace(cfg16, compute_dtype='float32')
    slot_buckets = sorted(set(EVAL_GRAPH_SLOT_BUCKETS) | {cfg16.num_boxes})
    buckets = [pipeline.slot_bucket([{C.SAMPLE_NUM_OBJS: n} for n in objs],
                                    slot_buckets, cfg16.num_boxes)
               for objs in EVAL_GRAPH_NUM_OBJS]
    if buckets != [8, 16, 32]:
        fail('eval graph: slot buckets {}'.format(buckets))
    groups = [flagship.synthetic_batch(seed + 50 + i, cfg16, EVAL_BATCH,
                                       (375, 1242), C.DEPTH_PAD_SHAPE)
              for i in range(len(buckets))]
    seeds = (seed, seed + 1)
    report = {}
    for name, cfg, deterministic in (('float32', cfg32, True),
                                     ('bfloat16', cfg16, False)):
        r = eval_graph_against_eager(cfg, 'val', groups, buckets, seeds,
                                     deterministic)
        report[name] = r
        runs = len(groups) * len(seeds)
        print('eval graph, {} ({}; val, eval batch {}, buckets {}, weights '
              'of seeds {} through one capture{}): {}, largest |d| {:.3e} '
              'of max|x| at {} (bound: {}); K1: {} eager calls, in the '
              'graph run {} by Python (the warm-up call and the capture), '
              '{} captured x {} replays, counted as {}; warm-up {:.3f} s, '
              'capture {:.3f} s; the assign=True restore: {}'.format(
                  name, card, EVAL_BATCH, buckets, list(seeds),
                  ', deterministic algorithms' if deterministic else '',
                  'bit for bit' if r['bitwise_equal'] else 'not bit for bit',
                  r['worst'], r['worst_key'],
                  'bit for bit' if deterministic else
                  '{} of max|x|'.format(BF16_BOUND),
                  r['k1_eager'], r['k1_python'] - r['k1_eager'],
                  r['k1_captured'], r['replays'], r['k1_counted'],
                  r['warm_up_s'], r['capture_s'],
                  'raised' if r['planted_error'] else 'did not raise'))
        if not r['finite']:
            fail('eval graph, {}: a graphed output is not finite'.format(
                name))
        if deterministic and not r['bitwise_equal']:
            fail('eval graph, {}: the graph differs from the eager step, '
                 'largest at {}'.format(name, r['worst_key']))
        if r['worst'] > BF16_BOUND:
            fail('eval graph, {}: {} differs by {:.3e} of max|x|, beyond '
                 '{}'.format(name, r['worst_key'], r['worst'], BF16_BOUND))
        if not r['planted_error']:
            fail('eval graph, {}: a replay after a load_state_dict with '
                 'assign=True did not raise'.format(name))
        if (r['k1_captured'] != 1 or r['replays'] != runs or
                r['k1_captured'] * r['replays'] != runs or
                r['k1_python'] != r['k1_eager'] + 2 or
                r['k1_counted'] != r['k1_eager'] + 1 + runs):
            fail('eval graph, {}: K1 {} eager, {} by Python, {} captured x '
                 '{} replays, counted {}; want {} replays'.format(
                     name, r['k1_eager'], r['k1_python'], r['k1_captured'],
                     r['replays'], r['k1_counted'], runs))
    seconds = time.time() - t0
    print('eval graph ({}, bfloat16): capture {:.3f} s; the val step at '
          'eval batch {} (phase 19\'s bench, each call with its upload): '
          'graph {:.3f} ms, eager {:.3f} ms; {:.1f} s'.format(
              card, report['bfloat16']['capture_s'], EVAL_BATCH,
              val_step_ms['graphed'], val_step_ms['eager'], seconds))
    report.update(buckets=buckets, seconds=seconds)
    return report


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
    cuda_build.build(list(cuda_build.SOURCES) + list(cuda_build.HOST_SOURCES))
    print('build: {} kernel(s) with nvcc and the host library with g++ in '
          '{:.1f} s'.format(len(cuda_build.SOURCES), time.time() - t0))
    for name in cuda_build.SOURCES:
        for line in cuda_build.build_log(name).splitlines():
            if 'registers' in line or 'spill' in line:
                print('  ptxas {}: {}'.format(name, line.strip()))

    seconds = {'1-2 card and build': time.time() - t_start}

    def phase(name, fn, *fn_args):
        """Runs one phase, printing and keeping its seconds."""
        t0 = time.time()
        out = fn(*fn_args)
        seconds[name] = time.time() - t0
        print('phase {}: {:.1f} s'.format(name, seconds[name]), flush=True)
        return out

    prod, ms, plain_ms, apart = phase('3 kernels', kernel_phase, args.seed)
    phase('4 slice reference', slice_reference, args.seed)
    report = phase('5 main path', main_path, args.seed)
    prod2, ms2, plain_ms2, apart2 = phase('6 K2 kernel', kernel_phase_k2,
                                          args.seed)
    sweep = phase('6 sweep', sweep_phase, [
        ('K1 production, masked', prod), ('K1 masked, drawn apart', apart),
        ('K2 train step, masked', prod2),
        ('K2 train step, masked, drawn apart', apart2)])
    phase('7 train reference', train_reference, args.seed)
    train_report = phase('8 main path train', main_path_train, args.seed)
    loop_dir = config_lib.parse_yaml_config(
        train_loop_config(4)).exp_output_dir
    shutil.rmtree(loop_dir, ignore_errors=True)
    try:
        loop_report = phase('9 train loop', train_loop_phase, card)
        eval_tiny = phase('10 eval reference', eval_reference, args.seed)
        eval_report = phase('11 eval CLIs', eval_cli_phase, card)
    finally:
        shutil.rmtree(loop_dir, ignore_errors=True)
    prod_ref = phase('12 production reference', production_reference,
                     args.seed)
    prep_report = phase('13 data preparation', data_prep_phase, card)
    dp_report = phase('14 data parallel', data_parallel_phase, args.seed,
                      card)
    gate_dirs = [os.path.join(monopsr_torch.data_dir(), 'outputs', name)
                 for name in ('accuracy_gate', '_accuracy_gate_cfg')]
    for path in gate_dirs:
        shutil.rmtree(path, ignore_errors=True)
    try:
        gate_report = phase('15 accuracy gate', accuracy_gate_phase, card)
    finally:
        for path in gate_dirs:
            shutil.rmtree(path, ignore_errors=True)
    pretrained_report = phase('16 pretrained trunk and remat',
                              pretrained_remat_phase, args.seed, card)
    graph_report = phase('17 steps_per_dispatch', steps_per_dispatch_phase,
                         args.seed, card, loop_report)
    fused_report = phase('17e fused update', fused_update_phase, args.seed,
                         card, graph_report['equality'])
    feed_report = phase('18 host feed', host_feed_phase, args.seed, card,
                        loop_report)
    bench_report = phase('19 bench', bench_phase, args.seed, card,
                         {'emd_cost_fused': ms, 'emd_loss': ms2})
    eval_graph_report = phase('20 eval graph', eval_graph_phase, args.seed,
                              card, bench_report['eval_val_step_ms'])
    emd_graph = graph_report['equality']['emd loss']

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
        'launches_steps_per_dispatch': graph_report['k1_launches'],
        'launches_eval_graph': [eval_graph_report[name]['k1_counted']
                                for name in ('float32', 'bfloat16')],
        'launches_eval_graph_counted_as': (
            'phase 20, float32 then bfloat16: per run {} eager calls, 1 '
            'eager warm-up call of the graphed step, and {} launch captured '
            'x {} replays (a captured launch runs in every replay; the '
            'Python counter counts it once, at capture)'.format(
                eval_graph_report['bfloat16']['k1_eager'],
                eval_graph_report['bfloat16']['k1_captured'],
                eval_graph_report['bfloat16']['replays'])),
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
        'bench_ms': bench_report['kernel_ms']['emd_cost_fused'],
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
        'launches_graph': emd_graph['k2_captured'] * emd_graph['replays'],
        'launches_graph_counted_as': (
            'phase 17(a), emd loss: {} launch captured x {} replays (a '
            'captured launch runs in every replay; the Python counter counts '
            'it once, at capture), besides {} eager launch of the warm-up '
            'step'.format(emd_graph['k2_captured'], emd_graph['replays'],
                          emd_graph['k2_graph_python'] -
                          emd_graph['k2_captured'])),
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
        'bench_ms': bench_report['kernel_ms']['emd_loss'],
        'bound_ms': bound2_ms,
        'bound_by': bound2_by,
        'library_ms': None,
        'shape': [b2, n2, m2],
    }, {
        'name': 'multi_tensor_adam',
        'route': 'cuda',
        'source': 'monopsr_torch/csrc/multi_tensor_adam.cu',
        'replaces': None,
        'launches_graph': (fused_report['dispatch']['captured'] *
                           fused_report['dispatch']['replays']),
        'launches_graph_counted_as': (
            'phase 17(e): {} launches captured x {} replays in one graphed '
            'dispatch of {} production steps (3 a step: the norm pass, the '
            'finalize, the update pass)'.format(
                fused_report['dispatch']['captured'],
                fused_report['dispatch']['replays'], GRAPH_K)),
        'cases': {name: fused_report[name]['bitwise_equal']
                  for name in FUSED_CASES},
        'clipped_worst_excess': fused_report['clipped']['worst_excess'],
        'ms': fused_report['ms'],
        'plain_ms': fused_report['plain_ms'],
        'bound_ms': fused_report['bound_ms'],
        'bound_by': 'bytes',
        'library_ms': None,
        'shape': [fused_report['tensors'], fused_report['parameters']],
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
    print('steps_per_dispatch: ' + json.dumps(graph_report))
    print('fused update: ' + json.dumps(fused_report))
    print('host feed: ' + json.dumps(feed_report))
    print('bench: ' + json.dumps(bench_report))
    print('eval graph: ' + json.dumps(eval_graph_report))
    print('phase seconds: ' + json.dumps(
        {name: round(value, 1) for name, value in seconds.items()}))
    print('total {:.1f} s'.format(time.time() - t_start))
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
