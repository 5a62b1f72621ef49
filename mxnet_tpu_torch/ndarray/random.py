"""`nd.random` (the counterpart of `mxnet_tpu/ndarray/random.py`): one
function per ``_random_*``/``_sample_*`` op under its short name, and the
hand-written ``exponential``, ``shuffle`` and ``randn``.  Without an
input array a sampler builds on ``ctx`` (the card when none is given)."""
from .._random_common import attach_random_wrappers
from ..ops.registry import attach_prefixed
from .register import invoke

__all__ = []

attach_random_wrappers(globals(), invoke, target_all=__all__)
attach_prefixed(globals(), ("_random_", "_sample_"), invoke,
                target_all=__all__)
