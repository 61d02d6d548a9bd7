"""Prefetching host input pipeline.

Counterpart of ``monopsr_tpu/train/input_pipeline.py``: sample assembly
(PNG decode, label merge, jitter) and ``prepare_sample`` (resize,
encodings) run in background threads that stay ahead of the train step.
The dataset is read under one lock, and batches leave in the order they
were read. A thread that fails hands its exception to the consumer,
which raises it from ``get_batch``.

A batch is the first ``batch_size`` samples with a valid object of
consecutive reads of that size (the rest of the last read dropped), as
JAX's loader takes them. The loader advances the dataset over each read
(``next_batch_slots``), tells the samples without a valid object from
their label files (``has_objects``), and decodes only the samples it
keeps (``load_slots``). Under data-parallel ranks each rank's loader
reads only its own rows of each global batch of ``world_size *
batch_size`` samples, by the same rule. A seeded dataset draws each
sample's randomness from (seed, sample name, epoch), so the ranks
together read the global batch one process reads with ``batch_size *
world_size``, and one process reads what JAX's loader reads. With
``seed: !!null`` each process shuffles and draws from its own unseeded
stream, which only the samples it decodes advance, so neither holds.
"""

import threading

from monopsr_torch.eval import evaluator
from monopsr_torch.train import trainer as trainer_lib


class PrefetchingLoader:
    """Produces stacked sample batches ahead of consumption.

    Args:
        dataset: KittiDataset in 'train' mode.
        batch_size: samples per batch (per rank).
        image_input_shape: (h, w) host resize target.
        queue_depth: max prepared batches in flight.
        num_threads: producer threads (dataset access is locked; the
            parallelism is in prepare_sample).
        rank, world_size: this rank and the number of data-parallel
            ranks; the global batch is ``world_size * batch_size``.
    """

    def __init__(self, dataset, batch_size, image_input_shape,
                 queue_depth=4, num_threads=2, rank=0, world_size=1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.image_input_shape = image_input_shape
        self.rank = rank
        self.world_size = world_size

        self._ready = {}           # batch number -> batch
        self._error = None
        self._read = 0             # batches read so far
        self._next = 0             # next batch number to hand out
        self._cond = threading.Condition()
        self._in_flight = threading.Semaphore(queue_depth)
        self._stop = threading.Event()
        self._dataset_lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(num_threads)]
        for t in self._threads:
            t.start()

    def _own_samples(self):
        """This rank's raw sample dicts of the next global batch: the
        first ``world_size * batch_size`` samples with a valid object, of
        consecutive ``next_batch`` reads of that size (the rest of the
        last read dropped), as one process's loader takes them."""
        global_batch = self.world_size * self.batch_size
        lo, hi = self.rank * self.batch_size, (self.rank + 1) * self.batch_size
        own, taken = [], 0
        while taken < global_batch:
            for slot in self.dataset.next_batch_slots(global_batch, True):
                if taken == global_batch:
                    break
                if self.dataset.has_objects(slot[0]):
                    if lo <= taken < hi:
                        own.append(slot)
                    taken += 1
        samples = self.dataset.load_slots(own)
        if any(s is None for s in samples):
            raise RuntimeError('a sample with labels left no object: {}'
                               .format(own))
        return samples

    def _next_samples(self):
        """(batch number, raw sample dicts) under the dataset lock."""
        with self._dataset_lock:
            samples = self._own_samples()
            number = self._read
            self._read += 1
        return number, samples

    def _worker(self):
        while not self._stop.is_set():
            if not self._in_flight.acquire(timeout=0.5):
                continue
            try:
                number, raw = self._next_samples()
                batch = evaluator.stack_samples(
                    [trainer_lib.prepare_sample(s, self.image_input_shape)
                     for s in raw])
            except Exception as e:        # handed to get_batch's caller
                with self._cond:
                    if self._error is None:
                        self._error = e
                    self._cond.notify_all()
                return
            with self._cond:
                self._ready[number] = batch
                self._cond.notify_all()

    def get_batch(self, timeout=300):
        """The next batch in read order; raises RuntimeError if a thread
        failed first, TimeoutError after ``timeout`` seconds."""
        with self._cond:
            if not self._cond.wait_for(
                    lambda: self._next in self._ready or
                    self._error is not None, timeout):
                raise TimeoutError('no batch in {} s'.format(timeout))
            if self._next not in self._ready:
                raise RuntimeError(
                    'input pipeline thread failed') from self._error
            batch = self._ready.pop(self._next)
            self._next += 1
        self._in_flight.release()
        return batch

    def stop(self, timeout=10.0):
        self._stop.set()
        for t in self._threads:
            t.join(timeout)
