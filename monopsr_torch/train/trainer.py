"""Train step: forward, GT, losses, backward, optimizer update.

Counterpart of ``make_train_step`` in ``monopsr_tpu/train/trainer.py``
(with ``create_train_state`` for ``TrainState.create``). The JAX step
vmaps GT assembly and the losses over the images; here they take the
image axis directly. The host side of training (``prepare_sample``, the
loop with its checkpoints and resume, the scalar log) is not ported yet.
"""

import torch

from monopsr_torch.eval import evaluator
from monopsr_torch.models import monopsr
from monopsr_torch.train.train_state import TrainState
from monopsr_torch.utils import device as device_lib


def create_train_state(net, tx, use_ema):
    """TrainState over ``net`` on its current device (make the train step
    first: it moves the net)."""
    return TrainState.create(net, tx, use_ema=use_ema)


def make_train_step(net, cfg, loss_config, tx, use_ema, ema_decay,
                    device=None):
    """Builds the train step over a stacked sample batch.

    Args:
        net: a MonoPSRNet; moved to ``device`` and put in train mode (the
            map decoder's batch norms use and update batch statistics).
        cfg: its NetConfig.
        loss_config: dict of {name: [loss_type, weight, ...]}.
        tx: optimizer from ``train.optimizer.build_optimizer``.
        use_ema, ema_decay: EMA of the parameters.
        device: CUDA unless 'cpu' is asked for; raises when CUDA is asked
            for and absent.

    Returns:
        train_step(state, batch) -> (state, losses): ``state`` is a
        TrainState over ``net`` (``create_train_state``), updated in
        place; ``losses`` maps each loss name to its mean over the images
        (detached scalars). The step minimizes the mean over images of
        the per-image total loss. GT offset targets stay coupled to the
        live predictions, as in the reference; GT crops carry no gradient.
    """
    device = device_lib.resolve_device(device)
    net = net.to(device).train()

    def train_step(state, batch):
        first = next(iter(state.params.values())).device
        if first.type != device.type or device.index not in (
                None, first.index):
            raise ValueError(
                'the train state lies on {}, the step runs on {}: create '
                'it after make_train_step has moved the net'.format(
                    first, device))
        batch = evaluator.batch_to_device(batch, device)
        outputs = net(**monopsr.net_inputs_from_batch(batch))
        gt = monopsr.build_gt_dict(cfg, batch, outputs)
        outputs, gt = monopsr.add_global_outputs(cfg, batch, outputs, gt)
        losses, totals = monopsr.compute_losses(cfg, loss_config, outputs, gt)
        totals.mean().backward()
        grads = {name: p.grad if p.grad is not None else torch.zeros_like(p)
                 for name, p in state.params.items()}
        state.apply_gradients(grads, tx,
                              ema_decay=ema_decay if use_ema else None)
        for p in state.params.values():
            p.grad = None
        return state, {k: v.detach().mean() for k, v in losses.items()}

    return train_step
