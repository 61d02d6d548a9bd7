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

Python counters of kernel launches (``emd_distance.launches``) count a
captured launch once, at capture: its launches on this path are the
captured ones times ``replays``.
"""

import time

import numpy as np
import torch


class GraphedTrainStep:
    """Runs train steps of ``train_step`` (from ``make_train_step``) on a
    CUDA device: the first eagerly, every later one as a replay of a
    CUDA graph captured at the second.

    Attributes:
        capture_seconds: host seconds of the capture, None before it.
        replays: graph replays so far (the captured step's first run
            included).
    """

    def __init__(self, train_step, device):
        device = torch.device(device)
        if device.type != 'cuda':
            raise ValueError('a CUDA graph runs on a CUDA device, got '
                             '{}'.format(device))
        if device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
        self.train_step = train_step
        self.device = device
        self.stream = None
        self.graph = None
        self.inputs = None
        self.losses = None
        self.capture_seconds = None
        self.replays = 0

    def __call__(self, state, batches):
        """Takes one train step per batch of ``batches`` (stacked sample
        batches, as the loader gives them), in order. Returns (state,
        losses of the last step)."""
        losses = None
        if self.stream is None:
            state, losses = self._warm_up(state, batches[0])
            batches = batches[1:]
        if not batches:
            return state, losses
        staged = self._upload(batches)
        for i in range(len(batches)):
            with torch.no_grad():
                for key, buffer in self.inputs.items():
                    buffer.copy_(staged[key][i], non_blocking=True)
            if self.graph is None:
                self._capture(state)
            else:
                state.step += 1
            self.graph.replay()
            self.replays += 1
        return state, self.losses

    def _warm_up(self, state, batch):
        """The run's first step, eagerly, on the side stream the graph is
        captured on."""
        self.stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            state, losses = self.train_step(state, batch)
        current.wait_stream(self.stream)
        return state, losses

    def _upload(self, batches):
        """{key: (k, ...) device tensor} of the k batches, each input in
        one copy from pinned memory; allocates the static input buffers
        at the first call and checks every later batch against them."""
        keys = [key for key, value in batches[0].items()
                if isinstance(value, np.ndarray)]
        staged = {}
        for key in keys:
            host = torch.from_numpy(np.ascontiguousarray(
                np.stack([batch[key] for batch in batches])))
            staged[key] = host.pin_memory().to(self.device,
                                               non_blocking=True)
        if self.inputs is None:
            self.inputs = {key: torch.empty_like(value[0])
                           for key, value in staged.items()}
        want = {key: (tuple(v.shape), v.dtype)
                for key, v in self.inputs.items()}
        got = {key: (tuple(v.shape[1:]), v.dtype)
               for key, v in staged.items()}
        if got != want:
            raise ValueError(
                'a batch of the graphed train step differs from the one it '
                'was captured with: {} against {}'.format(got, want))
        return staged

    def _capture(self, state):
        """Captures one train step on the static inputs (the state's
        tensors and the buffers); capture runs nothing, so the caller
        replays it."""
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=self.stream):
            state, losses = self.train_step(state, self.inputs)
        self.capture_seconds = time.perf_counter() - t0
        self.graph, self.losses = graph, losses
