"""The train cells' reference: the train step in plain PyTorch.

The step the port's ``train/trainer.make_train_step`` takes, written out:
the train-mode forward (both towers, the feature crop, the decoder with
batch statistics, the heads), the GT instance crops from the depth map
and the instance image, every loss of the config, the backward pass of
the mean over images, the clip of the global gradient norm to 1.0, Adam
(optax's constants: b1 0.9, b2 0.999, eps 1e-8 outside the root, bias
corrections) under the staircase exponential decay, and the EMA of the
parameters. No kernel of the port runs: the net is ``monopsr_net``.
"""

import numpy as np
import torch

from benchmark.reference import monopsr


def net_config(experiment):
    """The NetConfig of an experiment config (the YAML as a dict)."""
    from benchmark.reference.monopsr_net import NetConfig
    dc, mc = experiment['dataset_config'], experiment['model_config']
    oc = mc['output_config']
    return NetConfig(
        num_boxes=dc['num_boxes'], num_alpha_bins=dc['num_alpha_bins'],
        num_classes=len(dc['classes']),
        image_input_shape=tuple(mc['image_input_shape']),
        resized_full_img_shape=tuple(mc['resized_full_img_shape']),
        img_roi_size=tuple(mc['img_roi_size']),
        map_roi_size=tuple(mc['map_roi_size']),
        proposal_fc_sizes=tuple(mc['proposal_fc_layers']['layer_sizes']),
        regression_fc_sizes=tuple(mc['regression_fc_layers']['layer_sizes']),
        dropout_keep_prob=float(mc['proposal_fc_layers']['dropout_keep_prob']),
        max_depth=float(dc['obj_filter_config']['depth_range'][1]),
        mean_sub_type=mc['mean_sub_type'],
        compute_dtype=mc.get('compute_dtype', 'bfloat16'),
        resnet=mc.get('resnet', 'resnet101'),
        output_stride=mc.get('output_stride', 4),
        lwh_type=oc['lwh'], alpha_type=oc['alpha'],
        view_ang_type=oc['view_ang'], cen_y_type=oc['cen_y'],
        cen_z_type=oc['cen_z'], rotate_view=mc['rotate_view'],
        centroid_type=mc['centroid_type'],
        xyz_from_depth=bool(oc.get('inst_xyz_map_global_from_depth')),
        appended_est_norm='constant' if mc.get(
            'normalize_appended_ests', True) is True else 'none',
        class_names=tuple(dc['classes']))


def to_device(batch, device):
    return {key: torch.from_numpy(np.ascontiguousarray(value)).to(device)
            for key, value in batch.items() if isinstance(value, np.ndarray)}


def loss_and_grads(net, cfg, loss_config, batch):
    """(total loss, {name: gradient}) of one train-mode step's loss."""
    outputs = net(**monopsr.net_inputs_from_batch(batch))
    gt = monopsr.build_gt_dict(cfg, batch, outputs)
    outputs, gt = monopsr.add_global_outputs(cfg, batch, outputs, gt)
    _, totals = monopsr.compute_losses(cfg, loss_config, outputs, gt)
    loss = totals.mean()
    loss.backward()
    grads = {name: (p.grad if p.grad is not None else torch.zeros_like(p))
             for name, p in net.named_parameters()}
    return loss.detach(), grads


class Adam:
    """clip_by_global_norm(clip) -> Adam under init * rate **
    floor(count / steps), as optax chains them, with an EMA."""

    def __init__(self, opt_config, ema_decay, clip=1.0):
        self.init = float(np.float32(opt_config['initial_learning_rate']))
        self.steps = float(opt_config['decay_steps'])
        self.rate = float(np.float32(opt_config['decay_factor']))
        self.ema_decay = ema_decay
        self.clip = clip
        self.count = 0
        self.mu, self.nu, self.ema = {}, {}, None

    def lr(self):
        if self.count <= 0:
            return self.init
        return self.init * self.rate ** np.floor(self.count / self.steps)

    @torch.no_grad()
    def step(self, params, grads):
        """Updates ``params`` in place; returns the clipped gradients."""
        if self.ema is None:
            self.ema = {n: p.detach().clone() for n, p in params.items()}
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = 1.0 if float(norm) < self.clip else self.clip / float(norm)
        clipped = {n: g * scale for n, g in grads.items()}
        lr = self.lr()
        self.count += 1
        c1 = 1.0 - 0.9 ** self.count
        c2 = 1.0 - 0.999 ** self.count
        for n, p in params.items():
            g = clipped[n]
            mu = self.mu.get(n, torch.zeros_like(g)) * 0.9 + 0.1 * g
            nu = self.nu.get(n, torch.zeros_like(g)) * 0.999 + 0.001 * g * g
            self.mu[n], self.nu[n] = mu, nu
            p.add_(-lr * (mu / c1) / (torch.sqrt(nu / c2) + 1e-8))
            self.ema[n].mul_(self.ema_decay).add_(p * (1.0 - self.ema_decay))
        return clipped


def run_steps(net, cfg, loss_config, optimizer, batches, device):
    """Takes one step per host batch of ``batches`` on ``net`` (train
    mode). Returns ([loss per step], clipped gradients of the first
    step, {name: parameter after the last step}, {name: EMA after it})."""
    net.train()
    params = dict(net.named_parameters())
    losses, first = [], None
    for batch in batches:
        loss, grads = loss_and_grads(net, cfg, loss_config,
                                     to_device(batch, device))
        clipped = optimizer.step(params, grads)
        for p in params.values():
            p.grad = None
        losses.append(float(loss))
        if first is None:
            first = clipped
    return (losses, first, {n: p.detach() for n, p in params.items()},
            optimizer.ema)
