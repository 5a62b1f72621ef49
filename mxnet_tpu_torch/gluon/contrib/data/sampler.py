"""Contrib samplers (the counterpart of
`mxnet_tpu/gluon/contrib/data/sampler.py`; reference
`gluon/contrib/data/sampler.py`)."""
from ...data import sampler as _sampler

__all__ = ["IntervalSampler"]


class IntervalSampler(_sampler.Sampler):
    """Walk [0, length) in strides of ``interval``, one phase at a time:
    0, k, 2k, ..., then (with ``rollover``) 1, k+1, ..., covering every
    index exactly once — reference `IntervalSampler` (the deterministic
    de-correlating sampler for sequence datasets)."""

    def __init__(self, length, interval, rollover=True):
        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        if interval > length:
            raise ValueError(
                f"interval {interval} must not exceed length {length}")
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        phases = range(self._interval) if self._rollover else (0,)
        for start in phases:
            yield from range(start, self._length, self._interval)

    def __len__(self):
        if self._rollover:
            return self._length
        return len(range(0, self._length, self._interval))
