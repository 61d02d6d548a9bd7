"""Bounded, ordered, multi-threaded prefetching for host pipelines.

Counterpart of ``monopsr_tpu/utils/prefetch.py``. The evaluator's
sample assembly (KITTI IO, MSCNN merge, resize, encode) is host work that
can overlap the device's steps; ``ordered_prefetch`` runs N workers while
keeping input order and bounding the items in flight (a full KITTI epoch
must not buffer thousands of multi-MB samples).
"""

import collections
from concurrent.futures import ThreadPoolExecutor


def ordered_prefetch(fn, iterable, num_threads=2, prefetch=8):
    """Yields fn(item) for each item, in order, computed by a pool.

    Args:
        fn: callable applied to each item (runs on worker threads; must
            be thread-safe).
        iterable: input items.
        num_threads: pool size. 1 still overlaps with the consumer.
        prefetch: max completed-or-running items ahead of the consumer.

    Yields:
        fn(item) results in input order. Worker exceptions re-raise at
        the corresponding yield point.
    """
    num_threads = max(1, int(num_threads))
    prefetch = max(num_threads, int(prefetch))
    it = iter(iterable)

    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        pending = collections.deque()
        try:
            for item in it:
                pending.append(pool.submit(fn, item))
                if len(pending) >= prefetch:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            for fut in pending:
                fut.cancel()
