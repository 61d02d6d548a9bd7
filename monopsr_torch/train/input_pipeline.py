"""Prefetching host input pipeline.

Counterpart of ``monopsr_tpu/train/input_pipeline.py``: sample assembly
(PNG decode, label merge, jitter) and ``prepare_sample`` (resize,
encodings) run in background threads that stay ahead of the train step.
The dataset is read under one lock, so the order of samples is the
dataset's; with several threads, batches may leave in another order than
they were read. A thread that fails hands its exception to the consumer,
which raises it from ``get_batch``.
"""

import queue
import threading

from monopsr_torch.eval import evaluator
from monopsr_torch.train import trainer as trainer_lib


class PrefetchingLoader:
    """Produces stacked sample batches ahead of consumption.

    Args:
        dataset: KittiDataset in 'train' mode.
        batch_size: samples per batch.
        image_input_shape: (h, w) host resize target.
        queue_depth: max prepared batches in flight.
        num_threads: producer threads (dataset access is locked; the
            parallelism is in prepare_sample).
    """

    def __init__(self, dataset, batch_size, image_input_shape,
                 queue_depth=4, num_threads=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.image_input_shape = image_input_shape

        self._queue = queue.Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        self._dataset_lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(num_threads)]
        for t in self._threads:
            t.start()

    def _next_samples(self):
        """Pulls raw sample dicts under the dataset lock."""
        with self._dataset_lock:
            return self.dataset.next_batch(self.batch_size, True)

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def _worker(self):
        while not self._stop.is_set():
            try:
                samples = []
                while len(samples) < self.batch_size:
                    raw = self._next_samples()
                    for s in raw:
                        if s is not None and len(samples) < self.batch_size:
                            samples.append(trainer_lib.prepare_sample(
                                s, self.image_input_shape))
                batch = evaluator.stack_samples(samples)
            except Exception as e:        # handed to get_batch's caller
                self._put(e)
                return
            self._put(batch)

    def get_batch(self, timeout=300):
        item = self._queue.get(timeout=timeout)
        if isinstance(item, Exception):
            raise RuntimeError('input pipeline thread failed') from item
        return item

    def stop(self, timeout=10.0):
        self._stop.set()
        # Drain so workers blocked on put() can exit
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout)
