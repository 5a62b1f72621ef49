"""Learning-rate schedules for the optimizers (the counterpart of
`mxnet_tpu/lr_scheduler.py`, a copy of its pure-Python schedules; reference
``python/mxnet/lr_scheduler.py``).

A scheduler is a callable ``sched(num_update) -> lr`` that the optimizer
consults on every update with its growing update count (`Optimizer`'s
``learning_rate``): `LRScheduler` with its warm-up, `FactorScheduler`,
`MultiFactorScheduler`, `PolyScheduler` and `CosineScheduler`, with the
reference's update-for-update decay.  Schedulers are stateful: ``base_lr``
holds the most recently computed rate, and the step decays advance a
cursor.  A rate is a host float: the training step writes it into the
device before each run of a captured step.
"""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    """Base schedule: an optional warmup ramp in front of the subclass
    decay.  During the first ``warmup_steps`` updates the rate climbs
    from ``warmup_begin_lr`` to ``base_lr`` (``warmup_mode='linear'``)
    or sits at ``warmup_begin_lr`` (``'constant'``); afterwards the
    subclass ``_post_warmup_lr`` takes over."""

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        self.warmup_mode = warmup_mode
        self.warmup_steps = warmup_steps
        self.base_lr = self.warmup_final_lr = base_lr
        self.warmup_begin_lr = warmup_begin_lr

    def get_warmup_lr(self, num_update):
        assert self.warmup_steps > num_update
        start, end = self.warmup_begin_lr, self.warmup_final_lr
        if self.warmup_mode == "constant":
            return start
        if self.warmup_mode == "linear":
            return start + (end - start) * num_update / self.warmup_steps
        raise ValueError(
            f"unknown warmup_mode {self.warmup_mode!r}: "
            "expected 'linear' or 'constant'")

    def _post_warmup_lr(self, num_update):
        raise NotImplementedError

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        return self._post_warmup_lr(num_update)


class FactorScheduler(LRScheduler):
    """Multiply the rate by ``factor`` each time another ``step`` updates
    have elapsed, never dropping below ``stop_factor_lr``."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr=base_lr, warmup_steps=warmup_steps,
                         warmup_begin_lr=warmup_begin_lr,
                         warmup_mode=warmup_mode)
        if step < 1:
            raise ValueError(
                f"FactorScheduler: step must be a positive update count, "
                f"got {step}")
        if factor > 1.0:
            raise ValueError(
                f"FactorScheduler: factor {factor} > 1 would GROW the "
                "rate; use a factor <= 1")
        self.count = 0
        self.stop_factor_lr = stop_factor_lr
        self.factor = factor
        self.step = step

    def _post_warmup_lr(self, num_update):
        # advance the window cursor over every boundary the update count
        # has fully crossed since the last call; one decay per window,
        # floored at stop_factor_lr
        boundary = self.count + self.step
        while num_update > boundary:
            self.count = boundary
            decayed = self.base_lr * self.factor
            self.base_lr = (decayed if decayed > self.stop_factor_lr
                            else self.stop_factor_lr)
            boundary = self.count + self.step
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """Multiply the rate by ``factor`` once at each boundary in the
    (strictly increasing) list ``step``."""

    def __init__(self, step, factor=1, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr=base_lr, warmup_steps=warmup_steps,
                         warmup_begin_lr=warmup_begin_lr,
                         warmup_mode=warmup_mode)
        assert isinstance(step, list) and len(step) >= 1
        prev = 0
        for boundary in step:
            if boundary < 1:
                raise ValueError(
                    f"MultiFactorScheduler: boundaries must be positive "
                    f"update counts, got {boundary}")
            if prev and boundary <= prev:
                raise ValueError(
                    f"MultiFactorScheduler: boundaries must be strictly "
                    f"increasing, got {step}")
            prev = boundary
        self.count = 0
        self.cur_step_ind = 0
        self.factor = factor
        self.step = step

    def _post_warmup_lr(self, num_update):
        boundaries, i = self.step, self.cur_step_ind
        while i < len(boundaries) and num_update > boundaries[i]:
            self.base_lr *= self.factor
            self.count = boundaries[i]
            i += 1
        self.cur_step_ind = i
        return self.base_lr


class _AnnealingScheduler(LRScheduler):
    """Shared shape for schedules that anneal from the initial rate down
    to ``final_lr`` over ``max_update`` updates (warmup excluded from the
    annealing span), then hold.  Subclasses supply ``_curve(frac)``, the
    remaining fraction of the (base - final) gap at progress ``frac``."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr=base_lr, warmup_steps=warmup_steps,
                         warmup_begin_lr=warmup_begin_lr,
                         warmup_mode=warmup_mode)
        assert isinstance(max_update, int)
        if max_update < 1:
            raise ValueError(
                f"{type(self).__name__}: max_update must be at least 1, "
                f"got {max_update}")
        if warmup_steps >= max_update:
            # max_steps would be <= 0: division by zero at the first
            # post-warmup update, or a rate GROWING past base_lr
            raise ValueError(
                f"{type(self).__name__}: warmup_steps ({warmup_steps}) "
                f"must be smaller than max_update ({max_update})")
        self.final_lr = final_lr
        self.max_update = max_update
        self.max_steps = max_update - warmup_steps
        self.base_lr_orig = self.base_lr

    def _curve(self, frac):
        raise NotImplementedError

    def _post_warmup_lr(self, num_update):
        if num_update <= self.max_update:
            frac = (num_update - self.warmup_steps) / self.max_steps
            gap = self.base_lr_orig - self.final_lr
            self.base_lr = self.final_lr + gap * self._curve(frac)
        return self.base_lr


class PolyScheduler(_AnnealingScheduler):
    """Polynomial annealing: the gap above ``final_lr`` shrinks as
    ``(1 - progress)^pwr``."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(max_update, base_lr=base_lr, final_lr=final_lr,
                         warmup_steps=warmup_steps,
                         warmup_begin_lr=warmup_begin_lr,
                         warmup_mode=warmup_mode)
        self.power = pwr

    def _curve(self, frac):
        return (1.0 - frac) ** self.power


class CosineScheduler(_AnnealingScheduler):
    """Cosine annealing: the gap above ``final_lr`` follows half a
    cosine period from 1 down to 0."""

    def _curve(self, frac):
        return (1.0 + math.cos(math.pi * frac)) / 2.0
