"""Minimal TensorBoard scalar-event sink.

Counterpart of ``monopsr_tpu/utils/tb_events.py``. The JSONL logs are
the primary machine-readable sink; this writer mirrors scalars into
``events.out.tfevents.*`` files so ``tensorboard --logdir`` shows the
loss and metric curves. Backed by tensorboardX where it is installed; a
silent no-op otherwise, so training never depends on it.
"""


class TBWriter:
    """Scalar-only TensorBoard event writer (no-op without tensorboardX).

    Args:
        logdir: event-file directory (usually <exp>/logs[/<split>]).
        enabled: config switch; False produces a no-op writer.
    """

    def __init__(self, logdir, enabled=True):
        self._writer = None
        if not enabled:
            return
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return
        self._writer = SummaryWriter(logdir)

    def scalars(self, step, scalars):
        """Writes a dict of scalar values at `step`."""
        if self._writer is None:
            return
        for tag, value in scalars.items():
            try:
                self._writer.add_scalar(tag, float(value), int(step))
            except (TypeError, ValueError):
                continue
        self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None
