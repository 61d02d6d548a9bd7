"""Train state: step, parameters, batch stats, optimizer state, EMA.

Counterpart of ``monopsr_tpu/train/train_state.py``. ``params`` are the
net's own ``nn.Parameter``s and ``batch_stats`` its buffers, keyed by
state-dict name (one to one with flax's ``params`` and ``batch_stats``
through ``monopsr_torch.weights``). ``apply_gradients`` updates them, the EMA
and the optimizer state in place, where the JAX state returns new
arrays: the net always holds the current weights, no second copy of
them is made, and a CUDA graph of the train step advances the state it
captured. It hands the whole update to the optimizer's ``apply``: Adam
on a CUDA device runs as the hand-written kernels of
``ops/multi_tensor_adam`` (three launches over every tensor, the EMA
included), anything else as ``torch._foreach_*`` ops (``apply_plain``).
"""

import torch


class TrainState:

    def __init__(self, step, params, batch_stats, opt_state,
                 ema_params=None):
        self.step = step
        self.params = params
        self.batch_stats = batch_stats
        self.opt_state = opt_state
        self.ema_params = ema_params

    @classmethod
    def create(cls, net, tx, use_ema=False):
        """State over ``net``'s parameters and buffers, with a fresh
        optimizer state and, with ``use_ema``, an EMA starting at the
        current parameters."""
        params = dict(net.named_parameters())
        ema = ({name: p.detach().clone() for name, p in params.items()}
               if use_ema else None)
        return cls(step=0, params=params,
                   batch_stats=dict(net.named_buffers()),
                   opt_state=tx.init(params), ema_params=ema)

    @torch.no_grad()
    def apply_gradients(self, grads, tx, ema_decay=None):
        """One optimizer update from {name: gradient}, every tensor of the
        state written in place (the optimizer's too), with no number read
        on the host: a CUDA graph of the step replays on the tensors it
        captured (``train.step_graph``). The EMA follows the updated
        parameters as e * decay + p * (1 - decay), also after a step the
        optimizer skipped as non-finite (as in the JAX state). The batch
        stats were updated by the train-mode forward."""
        tx.apply(grads, self.opt_state, self.params, self.ema_params,
                 ema_decay)
        self.step += 1
        return self

    def _variables(self, params):
        out = {name: p.detach() for name, p in params.items()}
        out.update(self.batch_stats)
        return out

    def eval_variables(self, use_ema=True):
        """State dict for evaluation, EMA parameters preferred (as the
        reference's swapping saver); ``MonoPSRNet.load_state_dict``
        takes it."""
        use = use_ema and self.ema_params is not None
        return self._variables(self.ema_params if use else self.params)

    def train_variables(self):
        return self._variables(self.params)
