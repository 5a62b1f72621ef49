"""TensorBoard logging callback (the counterpart of
`mxnet_tpu/contrib/tensorboard.py`; reference
`python/mxnet/contrib/tensorboard.py`).

The reference depends on the external `tensorboard` SummaryWriter; here the
writer is injectable — pass any object with `add_scalar(tag, value)` (e.g.
torch.utils.tensorboard.SummaryWriter, the default where the `tensorboard`
package is installed).  Without one, scalars append to a TSV events file,
one row per scalar.
"""
from __future__ import annotations

import os
import time

__all__ = ["LogMetricsCallback"]


class _TsvWriter:
    def __init__(self, logging_dir):
        os.makedirs(logging_dir, exist_ok=True)
        self._path = os.path.join(logging_dir, "events.tsv")

    def add_scalar(self, tag, value):
        with open(self._path, "a") as f:
            f.write(f"{time.time():.3f}\t{tag}\t{value}\n")


class LogMetricsCallback:
    """Batch-end callback: logs every metric of `eval_metric` (reference
    `tensorboard.py:LogMetricsCallback`)."""

    def __init__(self, logging_dir, prefix=None, summary_writer=None):
        self.prefix = prefix
        if summary_writer is not None:
            self.summary_writer = summary_writer
        else:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.summary_writer = SummaryWriter(logging_dir)
            except Exception:
                self.summary_writer = _TsvWriter(logging_dir)

    def __call__(self, param):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            if self.prefix is not None:
                name = f"{self.prefix}-{name}"
            self.summary_writer.add_scalar(name, value)
