"""Monitor: statistics of an executor's outputs during training (the
counterpart of `mxnet_tpu/monitor.py`; reference `python/mxnet/monitor.py`
over the executor's monitor callback).  `Executor.set_monitor_callback`
hands each output's name and value to `Monitor._stat_helper` after every
forward; `tic` opens a batch every ``interval`` batches and `toc` returns
``(step, name, statistic)`` for the outputs whose names match
``pattern``."""
from __future__ import annotations

import logging
import re
from typing import List, Tuple

__all__ = ["Monitor"]


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        self.interval = interval
        self.stat_func = stat_func or (
            lambda x: float(abs(x.asnumpy()).mean()))
        self.re_pattern = re.compile(pattern)
        self.sort = sort
        self.queue: List[Tuple[int, str, float]] = []
        self.step = 0
        self.activated = False
        self.exes = []

    def install(self, exe):
        exe.set_monitor_callback(self._stat_helper)
        self.exes.append(exe)

    def _stat_helper(self, name, arr):
        if not self.activated or not self.re_pattern.match(name):
            return
        self.queue.append((self.step, name, self.stat_func(arr)))

    def tic(self):
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        if not self.activated:
            return []
        self.activated = False
        res = list(self.queue)
        self.queue = []
        if self.sort:
            res.sort(key=lambda x: x[1])
        return res

    def toc_print(self):
        res = self.toc()
        for step, name, value in res:
            logging.info("Batch: %7d %30s %s", step, name, value)
        return res
