"""The flagship configuration, synthetic samples and seeded set-ups.

Counterpart of ``__graft_entry__.py``'s single-card entry: the
production configuration read from ``configs/monopsr_model_000.yaml``
(ResNet-101 towers, 32 boxes, 320x1216, bfloat16), synthetic KITTI-like
samples in the trainer's device encodings, the seeded net with one
test-mode forward (``entry``) and the production train step, state and
batch (``build_train_setup``). The bench (``experiments/bench.py``) and
``chip_smoke.py`` build their inputs here.

Where it differs from the JAX entry: the weights come from
``monopsr.create_net``'s seeded generator, not a flax init; the samples
are ``chip_smoke.py``'s (uint8 image, uint16 depth, uint8 instance image,
boxes centred on the painted objects); the loss config and the optimizer
are the YAML's own, where the JAX dry run keeps a copy of the loss
config and its own learning rate. Its multi-card dry run is
``parallel/data_parallel`` and ``chip_smoke.py`` phase 14.
"""

import dataclasses
import os

import numpy as np
import torch

import monopsr_torch
from monopsr_torch import config as config_lib
from monopsr_torch import constants as C
from monopsr_torch.eval import evaluator
from monopsr_torch.geometry import class_stats
from monopsr_torch.models import monopsr
from monopsr_torch.models.monopsr_net import NetConfig
from monopsr_torch.train import optimizer as opt_lib
from monopsr_torch.train import trainer

CONFIG_PATH = os.path.join(monopsr_torch.top_dir(), 'configs',
                           'monopsr_model_000.yaml')

# KITTI's image shape, which the synthetic boxes and depth maps assume
ORIG_SHAPE = (375, 1242)


def flagship_yaml(yaml_path=CONFIG_PATH):
    """The parsed experiment config (``config.parse_yaml_config``)."""
    return config_lib.parse_yaml_config(yaml_path)


def flagship_config(config=None):
    """The NetConfig of a parsed experiment config (default: the
    production one)."""
    config = config or flagship_yaml()
    return NetConfig.from_model_config(config.model_config,
                                       config.dataset_config)


def loss_config(config=None):
    """A parsed config's ``model_config.loss_config`` as a dict (default:
    the production one's)."""
    return (config or flagship_yaml()).model_config.loss_config.to_dict()


def train_config(config=None):
    """A parsed config's optimizer section, as ``build_optimizer`` takes
    it (default: the production one's)."""
    return {'optimizer':
            (config or flagship_yaml()).train_config.optimizer.to_dict()}


def synthetic_sample(rng, cfg, orig_shape=ORIG_SHAPE,
                     depth_shape=C.DEPTH_PAD_SHAPE):
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


def synthetic_batch(seed, cfg, size, orig_shape=ORIG_SHAPE,
                    depth_shape=C.DEPTH_PAD_SHAPE):
    """``size`` synthetic samples drawn from one seeded stream, stacked."""
    rng = np.random.RandomState(seed)
    samples = [synthetic_sample(rng, cfg, orig_shape, depth_shape)
               for _ in range(size)]
    return evaluator.stack_samples(samples)


def forward(net, batch):
    """The test-mode forward of ``net`` on a stacked batch (numpy arrays
    or tensors, moved to the net's device as ``batch_to_device`` moves
    them): the net's output dict."""
    device = next(net.parameters()).device
    with torch.inference_mode():
        batch = evaluator.batch_to_device(batch, device)
        return net(**monopsr.net_inputs_from_batch(batch))


def entry(device=None, seed=0, config=None):
    """The seeded flagship net and one test-mode forward on a synthetic
    sample, as ``__graft_entry__.entry`` gives them.

    Returns:
        (forward, (net, sample)): ``forward(net, sample)`` -> output
        dict; ``sample`` is a batch of one net-input sample (numpy).
    """
    cfg = flagship_config(config)
    net = monopsr.create_net(cfg, device=device, seed=seed)
    sample = monopsr.strip_to_net_inputs(synthetic_batch(seed, cfg, 1))
    return forward, (net, sample)


def build_train_setup(cfg, n_samples, device=None, seed=0, remat=None,
                      config=None):
    """The production train step on ``n_samples`` synthetic samples.

    Args:
        cfg: NetConfig (``flagship_config``).
        n_samples: images per step.
        device: CUDA unless 'cpu' is asked for.
        seed: seed of the weights and the samples.
        remat: None, or a tower remat policy ('unit' or 'conv_outs')
            that replaces the config's.
        config: the parsed config whose loss config and optimizer are
            used (default: the production one).

    Returns:
        (train_step, state, batch): ``make_train_step`` with the YAML's
        loss config, optimizer and EMA; its TrainState over the seeded
        net; the stacked host batch.
    """
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat_towers=True, remat_policy=remat)
    net = monopsr.create_net(cfg, device=device, seed=seed)
    config = config or flagship_yaml()
    tx, _, use_ema, decay = opt_lib.build_optimizer(train_config(config))
    step = trainer.make_train_step(net, cfg, loss_config(config), tx,
                                   use_ema, decay, device=device)
    state = trainer.create_train_state(net, tx, use_ema)
    batch = synthetic_batch(seed, cfg, n_samples)
    return step, state, batch
