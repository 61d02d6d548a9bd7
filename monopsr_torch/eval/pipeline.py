"""Device-to-host pipeline of the evaluation loop.

Counterpart of ``monopsr_tpu/eval/pipeline.py``. The dispatching thread
hands each dispatched group's outputs to ``BatchedPullPipeline.add``,
which starts their copies to the host at once: on CUDA, ``non_blocking``
copies into pinned buffers on the current stream, followed by a CUDA
event. A background worker waits for that event, turns the buffers into
numpy arrays and runs the formatting and saving, while the dispatching
thread assembles and launches the next group. The JAX package packs many
groups' outputs into one byte buffer per transfer, for the TPU link's
fixed cost per transfer (``utils/transfer.py``); copies here go tensor by
tensor, and ``pull_batch`` only sets how many groups the worker takes at
a time.
"""

import queue as queue_lib
import threading
import time

import torch

from monopsr_torch import constants as C
from monopsr_torch.utils import profiling


def slot_bucket(samples, slot_buckets, num_boxes):
    """Smallest configured slot bucket covering every sample's num_objs.

    Per-box outputs are truncated on the device to the group's bucket, so
    a sparse frame moves far fewer bytes to the host than the full
    num_boxes slots.
    """
    needed = max(int(s[C.SAMPLE_NUM_OBJS]) for s in samples)
    for bucket in slot_buckets:
        if bucket >= needed:
            return bucket
    return num_boxes


def mark(device):
    """A point in the device's work: a CUDA event recorded on the current
    stream, or the host clock for the CPU (whose ops are synchronous)."""
    device = torch.device(device)
    if device.type == 'cuda':
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(device))
        return event
    return time.perf_counter()


def _seconds_between(start, end):
    """Waits for ``end`` and returns the seconds from ``start`` to it."""
    if isinstance(end, torch.cuda.Event):
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    return end - start


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _start_copy(x):
    if torch.is_tensor(x) and x.device.type == 'cuda':
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x, non_blocking=True)
        return buf
    return x


def _to_numpy(x):
    if not torch.is_tensor(x):
        return x
    if x.dtype == torch.bfloat16:      # numpy has no bfloat16; exact in f32
        x = x.float()
    return x.numpy()


def _tensors(tree):
    found = []
    _map(lambda x: found.append(x) if torch.is_tensor(x) else None, tree)
    return found


class BatchedPullPipeline:
    """Dispatch-side accumulator + background pull/process worker.

    Args:
        process_fn: called as process_fn(sample, host_outputs) for every
            added item, in order, from the worker thread; host_outputs is
            the item's tree with every tensor turned into a numpy array.
        pull_batch: items the worker takes at a time.
        on_pull_time: optional callback(seconds_per_item, n), once per
            batch of n items: the mean over the batch of each item's span
            from ``start`` (see ``add``) to its outputs on the host.
        times: the ``profiling.StageTimes`` its spans and counter go to;
            its own by default.
    """

    def __init__(self, process_fn, pull_batch=8, on_pull_time=None,
                 times=None):
        self._process_fn = process_fn
        self._pull_batch = max(int(pull_batch), 1)
        self._on_pull_time = on_pull_time
        self.times = profiling.StageTimes() if times is None else times
        self._queue = queue_lib.Queue(maxsize=2)
        self._errors = []
        self._pending = []
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            batch = self._queue.get()
            if batch is None:
                return
            try:
                spans = []
                for _, _, start, end, item in batch:
                    with self.times.span('eval.pull', item):
                        spans.append(_seconds_between(start, end))
                if self._on_pull_time is not None:
                    self._on_pull_time(sum(spans) / len(batch), len(batch))
                for sample, host_out, _, _, _ in batch:
                    self._process_fn(sample, _map(_to_numpy, host_out))
            except BaseException as exc:  # surfaced by close()
                self._errors.append(exc)
                return

    def _safe_put(self, item):
        """Bounded put that can't deadlock if the worker died."""
        while not self._errors:
            try:
                self._queue.put(item, timeout=1.0)
                return True
            except queue_lib.Full:
                continue
        return False

    def start_pull(self, sample, step_out, start=None, item=None):
        """Starts the copies of one dispatched (host sample, device
        outputs) pair's outputs to the host and holds the pair for the
        worker. ``start`` is what ``mark`` returned just before the step
        was launched (default: now); ``item`` names the pair in the
        spans."""
        with self.times.span('eval.pull_start', item):
            tensors = _tensors(step_out)
            device = tensors[0].device if tensors else 'cpu'
            if start is None:
                start = mark(device)
            host_out = _map(_start_copy, step_out)
            self._pending.append((sample, host_out, start, mark(device),
                                  item))
        self.times.count('eval.bytes_down', sum(
            x.nbytes for x in tensors if x.device.type == 'cuda'))

    def hand_over(self):
        """Hands the held pairs to the worker once ``pull_batch`` of them
        are held, waiting while its queue is full."""
        if len(self._pending) >= self._pull_batch:
            with self.times.span('eval.pull_queue_wait',
                                 self._pending[-1][4]):
                self._safe_put(self._pending)
            self._pending = []

    def add(self, sample, step_out, start=None, item=None):
        """``start_pull``, then ``hand_over``."""
        self.start_pull(sample, step_out, start, item)
        self.hand_over()

    def close(self):
        """Flushes, joins the worker, and re-raises any worker error."""
        if self._pending:
            self._safe_put(self._pending)
            self._pending = []
        self._safe_put(None)
        self._worker.join()
        if self._errors:
            raise self._errors[0]
