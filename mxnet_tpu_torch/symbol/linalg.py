"""`sym.linalg` (the counterpart of `mxnet_tpu/symbol/linalg.py`): the
``linalg_*`` ops under their short names, composing graph nodes."""
from ..ops.registry import attach_prefixed
from .register import invoke_sym

__all__ = []

attach_prefixed(globals(), ("linalg_",), invoke_sym, target_all=__all__)
