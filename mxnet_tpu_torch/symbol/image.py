"""`mx.sym.image` (the counterpart of `mxnet_tpu/symbol/image.py`;
reference `python/mxnet/symbol/image.py`): friendly names over the
``_image_*`` registry ops for graph construction."""
from ..ops.registry import attach_prefixed
from .register import invoke_sym

__all__ = []

attach_prefixed(globals(), ("_image_",), invoke_sym, target_all=__all__)
