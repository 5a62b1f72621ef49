"""`nd.linalg` (the counterpart of `mxnet_tpu/ndarray/linalg.py`): the
``linalg_*`` ops under their short names (``nd.linalg.gemm2``)."""
from ..ops.registry import attach_prefixed
from .register import invoke

__all__ = []

attach_prefixed(globals(), ("linalg_",), invoke, target_all=__all__)
