"""K train steps per host dispatch on a CUDA device, through a CUDA graph
of one train step.

Counterpart of the JAX trainer's ``steps_per_dispatch`` program, a
``lax.scan`` of K train steps over K stacked batches
(``monopsr_tpu/train/trainer.py``). Here ``GraphedTrainStep`` captures
one step of ``trainer.make_train_step`` in a CUDA graph and replays it
once per step: a dispatch of K steps uploads its K batches in one copy
per input and enqueues K replays with no host read between them, so the
step's Python and its ~7,900 launches are paid once, at capture.

- Warm-up without moving the trajectory. The run's first step runs
  eagerly, as a real step, on the capture's side stream: it builds the
  cuDNN plans, the cuBLAS workspaces and the allocator's blocks, and
  the step's kept constants (``utils.device.constant``). The next step
  is captured; capture does not execute it, so it is replayed at once.
  No step runs twice and no state is saved and restored.
- Inputs. Static device buffers with the shapes and dtypes of the first
  captured batch. A dispatch stacks its batches on the host, copies each
  input to the device once from pinned memory, then copies each step's
  rows into the buffers on the stream, ahead of that step's replay. A
  batch of other keys, shapes or dtypes raises.
- State. The graph reads and writes the train state's own tensors
  (``TrainState.apply_gradients`` and the optimizer update every tensor
  in place, with no host read); capture after a resume's restore, which
  copies into them. ``state.step`` is counted on the host. The losses
  are the graph's output tensors, overwritten by every replay: read them
  at a logging step; a checkpoint reads the state after the replays on
  its stream.
- A capture that fails raises; nothing falls back to eager steps.
- Spans (``utils.profiling``, into ``times``), each with the dispatch's
  number (from 1) as its item: 'train.dispatch', and within it
  'graph.warm_up', 'train.stack', 'train.pin' and 'train.h2d' per input
  (the upload), then per step 'train.row_copy', 'graph.capture' or 'train.replay'; the
  counters 'train.steps' and 'train.bytes_up'.

The side stream, the capture and the static input buffers are
``utils.cuda_graph.SideStreamGraph``'s, which the graphed eval step
shares.

Python counters of kernel launches (``emd_distance.launches``) count a
captured launch once, at capture: its launches on this path are the
captured ones times ``replays``.
"""

import numpy as np
import torch

from monopsr_torch.utils import cuda_graph


class GraphedTrainStep(cuda_graph.SideStreamGraph):
    """Runs train steps of ``train_step`` (from ``make_train_step``) on a
    CUDA device: the first eagerly, every later one as a replay of a
    CUDA graph captured at the second (``utils.cuda_graph``).

    Attributes (besides ``SideStreamGraph``'s):
        losses: the graph's loss tensors, None before the capture.
        dispatches: calls so far.
    """

    def __init__(self, train_step, device):
        super().__init__(device, 'train step')
        self.train_step = train_step
        self.losses = None
        self.dispatches = 0

    def __call__(self, state, batches):
        """Takes one train step per batch of ``batches`` (stacked sample
        batches, as the loader gives them), in order. Returns (state,
        losses of the last step)."""
        self.dispatches += 1
        number, times = self.dispatches, self.times
        with times.span('train.dispatch', number):
            times.count('train.steps', len(batches))
            losses = None
            if self.stream is None:
                # The run's first step, eagerly, on the side stream the
                # graph is captured on
                with times.span('graph.warm_up', number):
                    state, losses = self.warm_up(
                        lambda: self.train_step(state, batches[0]))
                batches = batches[1:]
            if not batches:
                return state, losses
            staged = self._upload(batches)
            for i in range(len(batches)):
                with times.span('train.row_copy', number), torch.no_grad():
                    for key, buffer in self.inputs.items():
                        buffer.copy_(staged[key][i], non_blocking=True)
                if self.graph is None:
                    # Captures one train step on the static inputs (the
                    # state's tensors and the buffers)
                    state, self.losses = self.capture(
                        lambda: self.train_step(state, self.inputs))
                else:
                    state.step += 1
                with times.span('train.replay', number):
                    self.replay()
        return state, self.losses

    def _upload(self, batches):
        """{key: (k, ...) device tensor} of the k batches, each input in
        one copy from pinned memory; allocates the static input buffers
        at the first call and checks every later batch against them."""
        number, times = self.dispatches, self.times
        keys = [key for key, value in batches[0].items()
                if isinstance(value, np.ndarray)]
        staged = {}
        for key in keys:
            with times.span('train.stack', number):
                host = torch.from_numpy(np.ascontiguousarray(
                    np.stack([batch[key] for batch in batches])))
            with times.span('train.pin', number):
                host = host.pin_memory()
            with times.span('train.h2d', number):
                staged[key] = host.to(self.device, non_blocking=True)
            times.count('train.bytes_up', host.nbytes)
        self.static_inputs({key: (tuple(value.shape[1:]), value.dtype)
                            for key, value in staged.items()})
        return staged
