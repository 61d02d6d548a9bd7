"""The eval step on a CUDA device as one CUDA graph, captured once per
``Evaluator`` and replayed for every dispatch group of every checkpoint.

Counterpart of the JAX evaluator's compiled eval step,
``jax.jit(eval_step, static_argnums=2)`` (``Evaluator._build_eval_step``
in ``monopsr_tpu/eval/evaluator.py``): the forward, then in val mode the
GT crops, the global outputs, the losses, the metrics (the EMD metric's
kernel K1 among them) and the packing for the host, as one program that
is built once and reused. ``GraphedEvalStep`` captures one call of
``evaluator.make_eval_step`` in a CUDA graph and replays it, so the
step's Python and its launches are paid once, at capture.

- One capture for every slot bucket. JAX compiles one program per bucket
  (``max_slots`` is static). Here a bucket only truncates the per-box
  axis of the packed outputs and of the metrics
  (``monopsr.slice_box_slots``, in ``pack_outputs_for_host`` and after
  ``compute_metrics``), which is a view of the full-slot result. So the
  graph is captured at the full ``num_boxes`` slots, and a call with
  bucket ``b`` returns views of its first ``b`` slots (``bucket_views``):
  what the eager step returns at ``b``, with the same bytes to cross to
  the host. One capture also keeps one private memory pool, where a
  graph per bucket would keep one each.
- Warm-up. The first call runs the eager step on the capture's side
  stream: it builds K1 (``ops/cuda_build``), the cuDNN plans, that
  stream's cuBLAS workspaces and the step's kept constants
  (``utils.device.constant``). The second call is captured on that
  stream; capture runs nothing, so it is replayed at once.
- Inputs. Static device buffers with the keys, shapes and dtypes of the
  first batch (val and test batches have fixed shapes after
  ``trainer.prepare_sample``). Each call pins the stacked host rows and
  copies them into the buffers on the current stream, then replays on
  that stream. A batch of other keys, shapes or dtypes raises.
- Outputs. The graph's own tensors, which every replay overwrites. The
  caller's copies to the host (``pipeline.BatchedPullPipeline.add``) and
  a data-parallel gather are enqueued on the current stream after the
  replay, so they run before the next call's upload and replay there.
- Weights. The graph reads the net's parameters and buffers in place.
  ``load_state_dict`` copies a checkpoint into them, so one capture
  serves every checkpoint. Each replay first checks that every parameter
  and buffer still has the storage it was captured with
  (``weight_pointers``): a restore with ``assign=True``, a ``.to()`` or a
  replaced tensor raises instead of replaying stale weights.
- A capture that fails raises; nothing falls back to the eager step.
- Spans (``utils.profiling``, into ``times``, which the evaluator sets to
  its pass's): 'graph.warm_up', 'graph.capture', and per call
  'eval.upload' (pinning and the copies to the device),
  'eval.weights_check' and 'eval.replay'.

The side stream, the capture and the static input buffers are
``utils.cuda_graph.SideStreamGraph``'s, which the graphed train step
shares.

Python counters of kernel launches (``emd_cost_fused.launches``) count a
captured launch once, at capture. ``captured_launches`` holds those;
``kernel_launches`` adds each of them once per later replay.
"""

import itertools

import numpy as np
import torch

from monopsr_torch.models import monopsr
from monopsr_torch.ops import emd as emd_ops
from monopsr_torch.utils import cuda_graph

# The kernels an eval step may launch, by name, and their counters
_COUNTERS = (('emd_cost_fused', emd_ops.emd_cost_fused),
             ('emd_loss', emd_ops.emd_distance))


def bucket_views(out, num_boxes, max_slots):
    """An eval step's full-slot (packed outputs, losses, metrics) cut to
    ``max_slots`` box slots, as the eager step returns them at that
    bucket: views of the per-box outputs and metrics."""
    packed, losses, metrics = out
    return (monopsr.slice_box_slots(packed, num_boxes, max_slots), losses,
            monopsr.slice_box_slots(metrics, num_boxes, max_slots))


def _host_tensors(batch):
    """{key: tensor} of a stacked batch's arrays (numpy arrays or
    tensors); other values are left out, as ``batch_to_device`` leaves
    them."""
    out = {}
    for key, value in batch.items():
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(np.ascontiguousarray(value))
        if torch.is_tensor(value):
            out[key] = value
    return out


def batch_spec(batch):
    """{key: (shape, dtype)} of a stacked batch's arrays."""
    return cuda_graph.input_spec(_host_tensors(batch))


def check_batch(batch, spec):
    """Raises ValueError unless ``batch`` has the keys, shapes and dtypes
    of ``spec`` (``batch_spec`` of the batch a graph was captured on)."""
    cuda_graph.check_spec(batch_spec(batch), spec, 'eval step')


def weight_pointers(net):
    """{name: data_ptr()} of every parameter and buffer of ``net``."""
    return {name: tensor.data_ptr() for name, tensor in itertools.chain(
        net.named_parameters(), net.named_buffers())}


def check_weights(net, pointers):
    """Raises RuntimeError unless every parameter and buffer of ``net``
    has the storage ``pointers`` (``weight_pointers`` at capture)
    recorded: a graph reads the storage it was captured with."""
    got = weight_pointers(net)
    moved = sorted(name for name in set(got) | set(pointers)
                   if got.get(name) != pointers.get(name))
    if moved:
        raise RuntimeError(
            'the graphed eval step reads the weights it was captured with, '
            'and {} of them ({}{}) now live elsewhere: restore weights with '
            'load_state_dict, which copies into them (not assign=True, '
            '.to() or new tensors)'.format(
                len(moved), ', '.join(moved[:3]),
                ', ...' if len(moved) > 3 else ''))


def kernel_launches(step=None):
    """{kernel name: launches so far in this process}: the Python
    counters, plus, where ``step`` is a ``GraphedEvalStep`` with a
    capture, each captured launch once per replay after the first (the
    counters count it once, at capture)."""
    counts = {name: counter.launches for name, counter in _COUNTERS}
    if isinstance(step, GraphedEvalStep) and step.captured_launches:
        for name, n in step.captured_launches.items():
            counts[name] += n * (step.replays - 1)
    return counts


class GraphedEvalStep(cuda_graph.SideStreamGraph):
    """Runs the eval step ``eval_step`` (``make_eval_step(net, ...)``) on
    a CUDA device: the first call eagerly, every later one as a replay of
    a CUDA graph captured at the second, at the full ``num_boxes`` slots
    (``utils.cuda_graph``).

    Called as the eager step is: ``step(batch, max_slots=None)`` ->
    (packed outputs, losses, metrics), with the per-box ones cut to
    ``max_slots`` slots.

    Attributes (besides ``SideStreamGraph``'s):
        warm_up_seconds: host seconds of the first, eager call up to the
            end of its device work (its span); None before it.
        captured_launches: {kernel name: launches captured}, None before
            the capture.
        outputs: the graph's (packed outputs, losses, metrics) at full
            slots, None before the capture.
    """

    def __init__(self, eval_step, device, net, num_boxes):
        super().__init__(device, 'eval step')
        self.eval_step = eval_step
        self.net = net
        self.num_boxes = num_boxes
        self.outputs = None
        self._pointers = None
        self.warm_up_seconds = None
        self.captured_launches = None

    def __call__(self, batch, max_slots=None):
        # The batch's tensors, pinned, into the static input buffers on the
        # current stream
        with self.times.span('eval.upload'):
            host = _host_tensors(batch)
            inputs = self.static_inputs(cuda_graph.input_spec(host))
            for key, value in host.items():
                if value.device.type == 'cpu':
                    value = value.pin_memory()
                inputs[key].copy_(value, non_blocking=True)
        if self.stream is None:
            return self._warm_up(max_slots)
        if self.graph is None:
            self._capture()
        else:
            with self.times.span('eval.weights_check'):
                check_weights(self.net, self._pointers)
        with self.times.span('eval.replay'):
            self.replay()
        return bucket_views(self.outputs, self.num_boxes, max_slots)

    def _warm_up(self, max_slots):
        """The first call, eagerly, on the side stream; its outputs are
        kept from reuse until the current stream's later work on them
        (the caller's copies) is done."""
        with self.times.span('graph.warm_up') as span:
            out = self.warm_up(
                lambda: self.eval_step(self.inputs, max_slots))
            current = torch.cuda.current_stream(self.device)
            for part in out:
                for value in part.values():
                    value.record_stream(current)
            self.stream.synchronize()
        self.warm_up_seconds = span.seconds
        return out

    def _capture(self):
        """Captures the step at full slots on the static inputs and the
        net's weights. Only this thread's calls are held to the capture's
        rules ('thread_local'): the pull pipeline's worker waits on its
        events meanwhile."""
        before = {name: counter.launches for name, counter in _COUNTERS}
        self.outputs = self.capture(
            lambda: self.eval_step(self.inputs, None),
            capture_error_mode='thread_local')
        self.captured_launches = {name: counter.launches - before[name]
                                  for name, counter in _COUNTERS}
        self._pointers = weight_pointers(self.net)
