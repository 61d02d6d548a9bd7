"""Shared helpers for the monopsr_torch parity tests (not a test module).

Builds matching tiny configurations of both packages, numpy-seeded
samples in the device encodings the trainer ships (uint8 image, uint16
depth, uint8 instance image), the JAX reference eval step, and a torch
net carrying the flax weights.
"""

import jax
import numpy as np

from monopsr_tpu import constants as C
from monopsr_tpu.datasets.kitti import kitti_dataset as kd
from monopsr_tpu.geometry import orientation
from monopsr_tpu.models import monopsr as jax_monopsr
from monopsr_tpu.models import monopsr_net as jax_net
from monopsr_torch import weights
from monopsr_torch.models import monopsr_net as torch_net

TINY = dict(
    num_boxes=4,
    num_alpha_bins=12,
    num_classes=1,
    image_input_shape=(96, 320),
    resized_full_img_shape=(48, 160),
    img_roi_size=(48, 48),
    map_roi_size=(48, 48),
    proposal_fc_sizes=(64, 64),
    regression_fc_sizes=(64, 64),
    max_depth=45.0,
    resnet='resnet_tiny',
    compute_dtype='float32',
)

LOSS_CONFIG = {
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


def configs(**overrides):
    """(JAX NetConfig, torch NetConfig) with the same fields."""
    fields = dict(TINY, **overrides)
    return jax_net.NetConfig(**fields), torch_net.NetConfig(**fields)


def make_sample(rng, cfg, depth_shape=None):
    """One sample dict in the device encodings, objects painted into the
    depth map and instance image."""
    n = cfg.num_boxes
    h, w = cfg.image_input_shape
    dh, dw = depth_shape or (h, w)
    image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    cam_p = np.array([[300.0, 0.0, w / 2, 20.0],
                      [0.0, 300.0, h / 2, 0.0],
                      [0.0, 0.0, 1.0, 0.001]], np.float32)

    depth = np.zeros((dh, dw), np.float32)
    inst_img = np.full((dh, dw), 255, np.uint8)
    boxes_2d = np.zeros((n, 4), np.float32)
    boxes_3d = np.zeros((n, 7), np.float32)
    for i in range(n):
        y1 = rng.randint(0, h - 40)
        x1 = rng.randint(0, w - 40)
        y2, x2 = y1 + rng.randint(15, 35), x1 + rng.randint(15, 35)
        z = rng.uniform(10, 35)
        # Depth varies across the object so the clouds are not flat
        yy, xx = np.mgrid[y1:y2, x1:x2]
        depth[y1:y2, x1:x2] = z + 0.05 * (yy - y1) - 0.03 * (xx - x1)
        inst_img[y1:y2, x1:x2] = i
        boxes_2d[i] = [y1 + rng.uniform(-0.4, 0.4), x1 + rng.uniform(-0.4, 0.4),
                       y2 + rng.uniform(-0.4, 0.4), x2 + rng.uniform(-0.4, 0.4)]
        boxes_3d[i] = [(x1 + x2) / 2 / w * 10 - 5, 1.5, z,
                       3.9, 1.6, 1.5, 0.2]

    alphas = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    bins, regs, valid_bins = orientation.np_orientation_to_angle_bin(
        alphas, cfg.num_alpha_bins, 0.0)
    view_2d = np.arctan2(
        ((boxes_2d[:, 1] + boxes_2d[:, 3]) / 2 - cam_p[0, 2]) / cam_p[0, 0],
        1.0).astype(np.float32)
    view_3d = np.arctan2(boxes_3d[:, 0] - (-cam_p[0, 3] / cam_p[0, 0]),
                         boxes_3d[:, 2]).astype(np.float32)

    return {
        'image': image,
        C.SAMPLE_LABEL_BOXES_2D: boxes_2d,
        C.SAMPLE_LABEL_BOXES_2D_NORM:
            boxes_2d / np.array([h, w, h, w], np.float32),
        C.SAMPLE_LABEL_BOXES_3D: boxes_3d,
        C.SAMPLE_VIEWING_ANGLES_2D: view_2d,
        C.SAMPLE_VIEWING_ANGLES_3D: view_3d,
        C.SAMPLE_LABEL_CLASS_INDICES: np.ones((n, 1), np.int32),
        C.SAMPLE_MEAN_LWH:
            np.tile([[3.892, 1.619, 1.530]], (n, 1)).astype(np.float32),
        C.SAMPLE_PROP_CEN_Z_OFFSET: np.full(n, 2.178, np.float32),
        kd.SAMPLE_CEN_Y_OFFSETS: np.full(n, 0.0648, np.float32),
        C.SAMPLE_CAM_P: cam_p,
        C.SAMPLE_DEPTH_MAP: np.rint(depth * 256.0).astype(np.uint16),
        kd.SAMPLE_INSTANCE_IMAGE: inst_img,
        kd.SAMPLE_INSTANCE_INDICES: np.arange(n, dtype=np.int32),
        C.SAMPLE_ALPHAS: alphas,
        C.SAMPLE_ALPHA_BINS: bins.astype(np.int32),
        C.SAMPLE_ALPHA_REGS: regs.astype(np.float32),
        C.SAMPLE_ALPHA_VALID_BINS: valid_bins.astype(np.float32),
    }


def init_flax(net, sample, seed=0):
    """Flax variables (numpy) for a single-sample call of net."""
    variables = jax.jit(lambda s: net.init(
        jax.random.PRNGKey(seed), **jax_monopsr.net_inputs_from_batch(s),
        train=False))(sample)
    return jax.device_get(variables)


def torch_net_from_flax(cfg, variables):
    net = torch_net.MonoPSRNet(cfg)
    net.load_state_dict(weights.from_flax_variables(variables), strict=True)
    return net.eval()


def jax_eval_step(net, cfg, loss_config, eval_mode):
    """The math of monopsr_tpu Evaluator._build_eval_step, without the
    Evaluator's config plumbing."""
    compute_losses = eval_mode == 'val'

    def eval_step(variables, batch, max_slots):
        outputs = net.apply(
            variables, **jax_monopsr.net_inputs_from_batch(batch),
            train=False)

        def per_sample(sample, sample_outputs):
            if not compute_losses:
                return (jax_monopsr.pack_outputs_for_host(
                    sample_outputs, cfg.num_boxes, max_slots), {}, {})
            gt = jax_monopsr.build_gt_dict(cfg, sample, sample_outputs)
            sample_outputs, gt = jax_monopsr.add_global_outputs(
                cfg, sample, sample_outputs, gt)
            losses, _ = jax_monopsr.compute_losses(
                cfg, loss_config, sample_outputs, gt)
            metrics = jax_monopsr.slice_box_slots(
                jax_monopsr.compute_metrics(cfg, sample_outputs, gt),
                cfg.num_boxes, max_slots)
            return (jax_monopsr.pack_outputs_for_host(
                sample_outputs, cfg.num_boxes, max_slots), losses, metrics)

        return jax.vmap(per_sample)(batch, outputs)

    return jax.jit(eval_step, static_argnums=2)


def jax_loss_fn(net, cfg, loss_config, batch_stats, batch):
    """The loss_fn of monopsr_tpu.train.trainer.make_train_step, for
    jax.value_and_grad over the params: (mean total, (mean losses, new
    batch stats))."""
    import jax.numpy as jnp

    def loss_fn(params):
        outputs, mutated = net.apply(
            {'params': params, 'batch_stats': batch_stats},
            **jax_monopsr.net_inputs_from_batch(batch), train=True,
            mutable=['batch_stats'])

        def per_sample(sample, sample_outputs):
            gt = jax_monopsr.build_gt_dict(cfg, sample, sample_outputs)
            sample_outputs, gt = jax_monopsr.add_global_outputs(
                cfg, sample, sample_outputs, gt)
            losses, total = jax_monopsr.compute_losses(
                cfg, loss_config, sample_outputs, gt)
            return total, losses

        totals, losses = jax.vmap(per_sample)(batch, outputs)
        return jnp.mean(totals), (jax.tree.map(jnp.mean, losses),
                                  mutated['batch_stats'])

    return loss_fn


def train_config(decay_steps=2, use_ema=True):
    """Adam with staircase exponential decay, as the production
    train_config, with a short decay period so a few steps cross a
    boundary."""
    return {'optimizer': {
        'optimizer_type': 'adam_optimizer',
        'adam_optimizer': {
            'learning_rate_type': 'exponential_decay',
            'initial_learning_rate': 8e-5,
            'decay_steps': decay_steps,
            'decay_factor': 0.8,
            'staircase': True,
            'use_moving_average': use_ema,
            'moving_average_decay': 0.9,
        }}}


def loss_config(xyz_loss):
    """LOSS_CONFIG with inst_xyz_map_local set to ``xyz_loss``."""
    return dict(LOSS_CONFIG, inst_xyz_map_local=list(xyz_loss))


def leaves(tree):
    """{path: numpy leaf} of a nested dict."""
    return dict(weights._flatten(tree))
