"""`sym.random` (the counterpart of `mxnet_tpu/symbol/random.py`): the
surface of `nd.random` over the graph-building invoker."""
from .._random_common import attach_random_wrappers
from ..ops.registry import attach_prefixed
from .register import invoke_sym

__all__ = []

attach_random_wrappers(globals(), invoke_sym, target_all=__all__)
attach_prefixed(globals(), ("_random_", "_sample_"), invoke_sym,
                target_all=__all__)
