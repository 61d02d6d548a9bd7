"""What the graphed train step (``train/step_graph.py``), the graphed
eval step (``eval/step_graph.py``) and the bench's graphed forward
(``experiments/bench.py``) share: a step on a CUDA device whose first
call runs eagerly on a side stream, whose second is captured on that
stream as a CUDA graph, and which reads its batch from static input
buffers of fixed keys, shapes and dtypes (the bench's forward reads the
batch it was captured on).

- The device must be a CUDA device; an index left open is resolved to
  the current device, so the stream, the buffers and the graph share it.
- ``warm_up(fn)`` runs ``fn()`` on a new side stream, after the current
  stream's work, and makes the current stream wait for it: the eager
  call builds what a capture may not (the kernels, cuDNN plans, the
  stream's cuBLAS workspaces, the step's kept constants).
- ``capture(fn)`` captures ``fn()`` on that stream, after the current
  stream's work, inside the span 'graph.capture' of ``times`` (a
  ``utils.profiling.StageTimes``, which an owner may replace with its
  own). Capture runs nothing, so the caller replays at once. A capture
  that fails raises.
- ``static_inputs(spec)`` allocates the buffers at its first call, from
  ``{key: (shape, dtype)}``, outside inference mode (so that later
  in-place copies into them are allowed), and raises ValueError on a
  later spec that differs.
"""

import torch

from monopsr_torch.utils import profiling


def input_spec(tensors):
    """{key: (shape, dtype)} of {key: tensor}."""
    return {key: (tuple(value.shape), value.dtype)
            for key, value in tensors.items()}


def check_spec(got, spec, what):
    """Raises ValueError unless the input spec ``got`` equals ``spec``
    (the spec of the batch the graph of ``what`` was captured with)."""
    if got != spec:
        keys = sorted(key for key in set(got) | set(spec)
                      if got.get(key) != spec.get(key))
        raise ValueError(
            'a batch of the graphed {} differs from the one it was captured '
            'with in {}: {} against {}'.format(
                what, keys, {k: got.get(k) for k in keys},
                {k: spec.get(k) for k in keys}))


class SideStreamGraph:
    """One step's CUDA graph on ``device``, warmed up and captured on a
    side stream, with static input buffers.

    Attributes:
        stream: the side stream, None before the warm-up.
        graph: the captured graph, None before the capture.
        inputs: {key: static device buffer}, None before ``static_inputs``.
        spec: {key: (shape, dtype)} of ``inputs``.
        capture_seconds: host seconds of the capture (its span), None
            before it.
        replays: graph replays so far.
        times: the ``profiling.StageTimes`` the spans go to.
    """

    def __init__(self, device, what):
        device = torch.device(device)
        if device.type != 'cuda':
            raise ValueError('a CUDA graph runs on a CUDA device, got '
                             '{}'.format(device))
        if device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
        self.device = device
        self.what = what
        self.stream = None
        self.graph = None
        self.inputs = None
        self.spec = None
        self.capture_seconds = None
        self.replays = 0
        self.times = profiling.StageTimes()

    def static_inputs(self, spec):
        """The static input buffers, allocated from ``spec`` at the first
        call; a later ``spec`` must equal the first."""
        if self.inputs is None:
            self.spec = dict(spec)
            with torch.inference_mode(False):
                self.inputs = {
                    key: torch.empty(shape, dtype=dtype, device=self.device)
                    for key, (shape, dtype) in self.spec.items()}
        else:
            check_spec(dict(spec), self.spec, self.what)
        return self.inputs

    def warm_up(self, fn):
        """``fn()`` eagerly on a new side stream; returns its result."""
        self.stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn()
        current.wait_stream(self.stream)
        return out

    def capture(self, fn, **graph_kwargs):
        """Captures ``fn()`` on the side stream (``graph_kwargs`` go to
        ``torch.cuda.graph``); returns its outputs, the graph's tensors."""
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        graph = torch.cuda.CUDAGraph()
        with self.times.span('graph.capture') as span:
            with torch.cuda.graph(graph, stream=self.stream,
                                  **graph_kwargs):
                out = fn()
        self.capture_seconds = span.seconds
        self.graph = graph
        return out

    def replay(self):
        self.graph.replay()
        self.replays += 1
