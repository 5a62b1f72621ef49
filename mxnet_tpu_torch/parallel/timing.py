"""Step timing (the counterpart of `mxnet_tpu/parallel/timing.py`).

Kernel launches return before the card has run them, so every timing
here ends with the caller's hard sync (``torch.cuda.synchronize()`` on
the card, or a host read of the step's output).

The constant cost of the sync is
cancelled by a two-point slope fit over different dispatch counts; when
the slope is inside the noise floor the bulk measurement (which *includes*
one round-trip, i.e. a conservative lower bound on throughput) is used
instead and flagged.
"""
import threading
import time

__all__ = ["fit_steps_per_sec", "bounded_cost_flops"]


def bounded_cost_flops(trainer, timeout_s=180.0):
    """`trainer.compiled_cost_analysis()['flops']` with a hard deadline.

    The count runs one forward and backward, which may block; run it in
    a daemon worker thread and abandon the thread on timeout (the caller
    is a short-lived measurement process).  Returns the per-step FLOP
    count or None (timeout / failure / zero)."""
    box = {}

    def work():
        try:
            cost = trainer.compiled_cost_analysis()
            if cost and cost.get("flops"):
                box["flops"] = float(cost["flops"])
        except Exception:
            pass

    t = threading.Thread(target=work, daemon=True)
    t.start()
    t.join(timeout_s)
    return box.get("flops")


def fit_steps_per_sec(dispatch, hard_sync, steps_per_dispatch,
                      n_small, n_large, noise_floor=0.05):
    """Measure steady-state training-step rate.

    ``dispatch()`` enqueues one K-step dispatch and returns its output;
    ``hard_sync(out)`` must force real completion
    (``torch.cuda.synchronize()`` or a host read of ``out``).
    Assumes warmup (compile + one synced dispatch) already happened.

    Returns ``(steps_per_sec, details)`` where ``details`` records the
    raw walls and whether the slope fit or the conservative bulk
    fallback produced the number.
    """
    def timed(n):
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = dispatch()
        hard_sync(out)  # serial device queue -> all n dispatches complete
        return time.perf_counter() - t0

    if n_large > n_small >= 1:
        w1, w2 = timed(n_small), timed(n_large)
        dt = w2 - w1
        # a tiny-but-positive dt is the same failure mode as dt<=0 (both
        # syncs landing on one batched completion): fall back rather than
        # divide by jitter
        if dt > noise_floor * w2:
            rate = (n_large - n_small) * steps_per_dispatch / dt
            return rate, {"method": "slope", "w1_s": w1, "w2_s": w2,
                          "n_small": n_small, "n_large": n_large}
        rate = n_large * steps_per_dispatch / w2
        return rate, {"method": "bulk-fallback", "w1_s": w1, "w2_s": w2,
                      "n_small": n_small, "n_large": n_large}
    w = timed(max(n_large, 1))
    rate = max(n_large, 1) * steps_per_dispatch / w
    return rate, {"method": "bulk", "w1_s": None, "w2_s": w,
                  "n_small": None, "n_large": max(n_large, 1)}
